"""Set-up shared by the port's CPU test modules that run its models, and
readers of the kernels' CUDA sources for the modules that emulate them."""

import functools
import importlib.util
import os
import re

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name: str):
    """The module ``tools/<name>.py`` (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def kernel_source(file: str) -> str:
    """The text of ``avjepa_tpu_torch/csrc/<file>``."""
    with open(os.path.join(REPO, "avjepa_tpu_torch", "csrc", file)) as f:
        return f.read()


def launch_width(file: str, d: int) -> tuple[int, str]:
    """(DP, launcher) that ``file``'s ``launch_16bit`` dispatches head_dim d
    to: the tile width d is zero-padded to, and the launch function."""
    body = re.search(r"cudaError_t launch_16bit\(.*?\n\}", kernel_source(file), re.S).group(0)
    for bound, launcher, dp in re.findall(
            r"(?:if \(p\.d <= (\d+)\) )?return (launch_\w+)<T, CLAMPED, (\d+)>", body):
        if not bound or d <= int(bound):
            return int(dp), launcher
    raise AssertionError(f"launch_16bit of {file} takes no head_dim {d}")


def kernel_constant(file: str, kernel: str, name: str, **env) -> int:
    """The value of ``constexpr int <name> = <C expression>;`` in the body of
    ``kernel`` in ``file``, its template parameters given by ``env``: an
    integer, or a chain of conditionals (``DP == 64 ? 32 : 64``)."""
    src = kernel_source(file)
    start = src.index(f"{kernel}(const Params prm) {{")
    expr = re.compile(rf"constexpr int {name} = ([^;]+);").search(src, start).group(1)
    expr = expr.replace("||", " or ").replace("&&", " and ")
    while "?" in expr:  # right-associative: the first "?" and ":" close the first test
        cond, rest = expr.split("?", 1)
        then, other = rest.split(":", 1)
        expr = then if eval(cond, {"__builtins__": {}}, env) else other
    return int(eval(expr, {"__builtins__": {}}, env))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the importing module's tests run (restored
    after). The models here are tiny; beside the other test workers torch's
    default threads oversubscribe the cores, and a tiny pretrain CLI run then
    took 152 s instead of 29 s. Runs that a test compares share the setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
