"""K6 (the LayerNorm backward kernel, avjepa_tpu_torch/csrc/layer_norm.cu) of
this checkout against K6 of another, on one GPU, within one run.

    python tools/ln_bwd_compare.py [--compare-root DIR]

from the root of a checkout, on a machine with a CUDA GPU. Each tree runs in
a process of its own, which builds that tree's kernels, prints the
registers, shared memory and spills of its LayerNorm backward kernels (ptxas,
from the build log), holds its K6 against its plain version at chip_smoke's
LN_TIMED shapes (bf16), and times it there: the wrapper by CUDA events
(median of chip_smoke.TIME_ROUNDS rounds) and the K6 kernels' device time by
torch.profiler. With ``--compare-root`` (another checkout, e.g. a ``git
archive`` of the parent commit under ``_archive/``) the trees run in the order
other, this, this, other; the table at the end gives each run's numbers
beside the bound. Writes chiprun_out/ln_bwd_compare.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (the worker's
    avjepa_tpu_torch is another tree's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(root: str) -> dict:
    """Build ``root``'s kernels, check and time its K6 at LN_TIMED."""
    sys.path.insert(0, root)
    import torch

    from avjepa_tpu_torch.ops import layer_norm as ln
    from avjepa_tpu_torch.ops._build import load_library

    assert Path(ln.__file__).resolve().is_relative_to(Path(root).resolve()), ln.__file__
    cs = _chip_smoke()
    log = Path(load_library()._name).with_suffix(".log")
    resources, name = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "ln_bwd" in name and ("spill" in line or "Used" in line):
            resources.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = []
    for r, c in cs.LN_TIMED:
        x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        got, want = ln.layer_norm_bwd(x, w, dy), ln.layer_norm_bwd_ref(x, w, dy)
        errs = [cs._rel_err(g, v) for g, v in zip(got, want)]
        if errs[0] > cs.LN_REL_TOL["bfloat16"] or max(errs[1:]) > cs.LN_PARAM_REL_TOL:
            raise AssertionError(f"{root}: K6 disagrees at [{r}, {c}]: {errs}")
        run = lambda: ln.layer_norm_bwd(x, w, dy)  # noqa: E731
        k_min, k_ms, k_max = cs._time_rounds(run, 20)
        dev = cs._device_ms(run)
        shapes.append({
            "shape": [r, c], "ms": k_ms, "ms_min": k_min, "ms_max": k_max,
            "device_ms": sum(ms for key, ms in dev.items() if "ln_bwd" in key),
            "kernels": dev, "bound_ms": cs._bound(16 * r * c, 3 * r * c * 2 + 3 * c * 4,
                                                  cs.PEAK_F32_FLOPS)[0],
            "rel_err": errs,
        })
        del x, dy, got, want
    return {"root": root, "card": cs.card_line(), "resources": resources, "shapes": shapes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare-root", default=None, help="another checkout to time beside this one")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(args.worker)))
        return
    other = os.path.abspath(args.compare_root) if args.compare_root else None
    order = ([("other", other), ("this", ROOT), ("this", ROOT), ("other", other)] if other
             else [("this", ROOT), ("this", ROOT)])
    runs = []
    for label, root in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             cwd=root, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{label} ({root}) exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        out = json.loads(res.stdout.split("RESULT ", 1)[1].splitlines()[0])
        out["label"] = label
        runs.append(out)
        print(f"{label}: {root}; {out['card']}")
        for line in out["resources"]:
            print(f"  ptxas {line}")
        for s in out["shapes"]:
            r, c = s["shape"]
            print(f"  K6 bf16 [{r}, {c}]: {s['ms']:.4f} ms by events ({s['ms_min']:.4f}-"
                  f"{s['ms_max']:.4f}), device {s['device_ms']:.4f} ms, bound "
                  f"{s['bound_ms']:.4f} ms: {100 * s['bound_ms'] / s['device_ms']:.1f}% of the "
                  f"bound by device time; max rel err dx {s['rel_err'][0]:.2e}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ln_bwd_compare.json"), "w") as f:
        json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
