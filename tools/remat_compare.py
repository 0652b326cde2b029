"""The remat'd pretrain steps of this checkout beside another checkout's, on
one GPU.

    python tools/remat_compare.py --compare-root DIR

from the root of a checkout, on a machine with one GPU; DIR is another
checkout of the repo (a ``git archive`` of an earlier commit, say). Each tree
runs its own ``chip_smoke.py`` functions in a process started in that tree,
in the order other, this, this, other: the ViT-L AV step of
``av-vitl16.yaml`` on a resident batch of 24 with remat (phase 7's
``time_train_step``: three rounds of 5 steps by CUDA events, peak memory, a
profiled window's device kernel ms) and without, then the ViT-H step of
``vith16.yaml`` (phase 13 (a), ``run_vith``). Each tree builds its kernels as
its own ``chip_smoke.py`` does. The timing lines are printed with their run's
number; whole logs go to chiprun_out/remat_compare_<n>.log.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = """
import tempfile
import chip_smoke as c
c.toolchain()
c.build()
with tempfile.TemporaryDirectory() as w:
    c.time_train_step(w, remat=True, rounds=3)
    c.time_train_step(w, remat=False)
    c.run_vith(w)
"""


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-root", required=True,
                        help="another checkout whose runs are timed beside this one's")
    args = parser.parse_args(argv)
    other = os.path.abspath(args.compare_root)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    for i, (root, label) in enumerate(((other, "other"), (ROOT, "this"), (ROOT, "this"),
                                       (other, "other")), 1):
        res = subprocess.run([sys.executable, "-c", _RUN], cwd=root, capture_output=True,
                             text=True, timeout=900)
        with open(os.path.join(ROOT, "chiprun_out", f"remat_compare_{i}.log"), "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise SystemExit(f"run {i} ({label}) exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
        for line in res.stdout.splitlines():
            if line.startswith(("train: ViT-L AV step", "vith16: ViT-H")):
                print(f"[{i} {label}] {line}", flush=True)


if __name__ == "__main__":
    main()
