"""The remat'd pretrain steps of this checkout beside another checkout's, on
one GPU.

    python tools/remat_compare.py [--compare-root DIR]

from the root of a checkout, on a machine with one GPU; DIR is another
checkout of the repo (a ``git archive`` of an earlier commit, say). The
trees and their order (other, this, this, other) are tools/tree_compare.py's.
Each tree runs its own ``chip_smoke.py`` functions in a process of its own:
the ViT-L AV step of ``av-vitl16.yaml`` on a resident batch of 24 with remat
(phase 7's ``time_train_step``: three rounds of 5 steps by CUDA events, peak
memory, a profiled window's device kernel ms) and without, then the ViT-H
step of ``vith16.yaml`` (phase 13 (a), ``run_vith``). The timing lines are
printed under their run; whole logs go to chiprun_out/remat_compare_<tree>.log.
"""

from __future__ import annotations

import contextlib
import io
import os
import tempfile

from tree_compare import ROOT, load_chip_smoke, main


def worker(root: str) -> dict:
    """Time ``root``'s remat'd and plain ViT-L AV steps and its ViT-H step."""
    c = load_chip_smoke(root)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), tempfile.TemporaryDirectory() as w:
        c.toolchain()
        c.build()
        c.time_train_step(w, remat=True, rounds=3)
        c.time_train_step(w, remat=False)
        c.run_vith(w)
    name = os.path.basename(os.path.normpath(root))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"remat_compare_{name}.log"), "a") as f:
        f.write(buf.getvalue())
    return {"lines": [line for line in buf.getvalue().splitlines()
                      if line.startswith(("train: ViT-L AV step", "vith16: ViT-H"))]}


def report(out: dict, first: dict) -> None:
    for line in out["lines"]:
        print(f"  {line}", flush=True)


if __name__ == "__main__":
    main(worker, report, "remat_compare")
