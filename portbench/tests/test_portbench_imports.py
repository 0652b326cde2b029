"""What the benchmark imports: no module of it imports JAX or the JAX package
(compared by whole top-level name: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "avjepa_tpu"}


def _imports(path: Path) -> set[str]:
    """The top-level names that ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not _imports(path) & FORBIDDEN, path
    # the whole-name comparison: the port's own name is not the JAX package's
    assert "avjepa_tpu_torch" not in FORBIDDEN and "avjepa_tpu" in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    files = sorted((spec.ROOT / "reference").glob("*.py"))
    assert files
    for path in files:
        assert "avjepa_tpu_torch" not in _imports(path), path
        assert not _imports(path) & FORBIDDEN, path


def test_runner_sees_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "avjepa_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "avjepa_tpu_torch_lookalike.ops", sys)
    assert "avjepa_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell run end to end in a fresh interpreter leaves no JAX module
    loaded, nor any of the JAX package."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from portbench import run\n"
        "from portbench.tests import conftest as c\n"
        f"root = c.make_root(Path({str(tmp_path)!r}), 'float32')\n"
        "bench = c.tiny_bench()\n"
        "for name in (c.TRAIN, c.EXTRACT):\n"
        "    w = [x for x in bench['workloads'] if x['name'] == name][0]\n"
        "    r = run.run_cell(bench, w, 7, 0.2, False, torch.device('cpu'), 0.0, root)\n"
        "    assert r['correct'], r\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
