"""Set-up shared by the port's CPU test modules that run its models."""

import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name: str):
    """The module ``tools/<name>.py`` (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
