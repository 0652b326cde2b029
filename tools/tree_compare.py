"""The runner that tools/attn_compare.py, tools/ln_bwd_compare.py and
tools/remat_compare.py share: one worker function run in several trees of
the repo, each in a process of its own, on one GPU, within one run.

The trees are this checkout, another one (``--compare-root``, e.g. a ``git
archive`` of the parent commit under ``_archive/``) and variants of this one
(``--variants``: JSON, or a file of it, mapping a name to a list of [file,
old, new] text edits of ``avjepa_tpu_torch/csrc/<file>``, each old text
occurring there; each variant is a copy of this package under
``_archive/variants/<name>/``). They run in the order other, this,
variants..., this, other (without ``--compare-root``: this, variants...,
this), so that drift in the card's clocks shows as a difference between
the two runs of one tree. All trees' kernels are built first, together.

A tool calls ``main(worker, report, name)``. ``worker(root)`` runs in the
tree's own process (its ``avjepa_tpu_torch`` first on ``sys.path``) and
returns a JSON-able dict; ``report(result, first)`` prints it in the
parent process, ``first`` being a dict that persists across the runs (each
tool keeps there the first run's output digests). The results, each with
its ``label`` and ``root``, go to ``chiprun_out/<name>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANT_DIR = os.path.join(ROOT, "_archive", "variants")


def load_chip_smoke(root: str = ROOT):
    """``root``'s chip_smoke.py, loaded by path (this checkout's by default:
    a worker's ``avjepa_tpu_torch`` may be another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_variant(name: str, edits: list) -> str:
    """A copy of this tree's package with ``edits`` applied; returns its root."""
    root = os.path.join(VARIANT_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "avjepa_tpu_torch"), os.path.join(root, "avjepa_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for file, old, new in edits:
        path = os.path.join(root, "avjepa_tpu_torch", "csrc", file)
        text = Path(path).read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in {file}")
        Path(path).write_text(text.replace(old, new))
    return root


def build_all(roots: list) -> None:
    """Build each tree's kernels, all at once (each build runs its own nvccs)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from avjepa_tpu_torch.ops._build import load_library; load_library()")
    procs = [(root, subprocess.Popen([sys.executable, "-c", code, root], cwd=root,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for root in dict.fromkeys(roots)]
    for root, proc in procs:
        out = proc.communicate(timeout=600)[0]
        if proc.returncode:
            print(f"build of {root} failed:\n{out[-4000:]}")


def main(worker, report, name: str, argv=None, timeout: int = 900) -> None:
    """Parse the command line of the tool whose module calls this, and run
    ``worker`` in each tree (see the module's docstring)."""
    script = os.path.abspath(sys.modules[worker.__module__].__file__)
    doc = sys.modules[worker.__module__].__doc__ or ""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--compare-root", default=None, help="another checkout to run beside this one")
    ap.add_argument("--variants", default=None,
                    help="JSON {name: [[file, old, new], ...]}, or a file holding it")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        sys.path.insert(0, args.worker)
        print("RESULT " + json.dumps(worker(args.worker)))
        return
    other = os.path.abspath(args.compare_root) if args.compare_root else None
    spec = args.variants or "{}"
    if os.path.isfile(spec):
        spec = Path(spec).read_text()
    variants = [(label, make_variant(label, edits)) for label, edits in json.loads(spec).items()]
    order = [("this", ROOT), *variants, ("this", ROOT)]
    if other:
        order = [("other", other), *order, ("other", other)]
    build_all([root for _, root in order])
    runs, first, failed = [], {}, []
    for label, root in order:
        # a failed tree (a bad descriptor can poison its CUDA context) stops only its own run
        res = subprocess.run([sys.executable, script, "--worker", root], cwd=root,
                             capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0 or "RESULT " not in res.stdout:
            print(f"{label} ({root}) exited {res.returncode}:\n{res.stdout[-3000:]}\n"
                  f"{res.stderr[-3000:]}")
            failed.append(label)
            continue
        out = json.loads(res.stdout.split("RESULT ", 1)[1].splitlines()[0])
        out.update(label=label, root=root)
        runs.append(out)
        print(f"{label}: {root}")
        report(out, first)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump(runs, f, indent=1)
    if failed:
        raise SystemExit(f"runs that failed: {', '.join(failed)}")
