"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--out <file.json>]

In one process, on the GPU: the program is built once; for each of
``--seeds`` it is set back to step 0 with that seed's weights and batches,
driven through the cell's own call as a run's set-up drives it, and compared
with the float32 reference: the lower readings. For each of
``--control-seeds`` (at least three), the control, the reference computed with
float8 e4m3 operands (the precision below the configuration's bf16), is
compared with the float32 reference in the program's place; a training cell
also reads the fault of half of each batch left out, planted in the
reference. A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition and needs no run. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import spec


def readings(cell, seeds, control_seeds) -> dict:
    out: dict = {"program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        for kind, numbers in cell.readings(seed, seed in seeds, seed in control_seeds).items():
            out.setdefault(kind, {})[seed] = numbers
            print(f"calibrate: seed {seed} {kind}: {numbers}", file=sys.stderr)
        print(f"calibrate: seed {seed} took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def summary(out: dict) -> dict:
    """The largest program reading and the smallest control and fault
    reading of each number."""
    names = [k for k in next(iter(out["program"].values())) if not k.startswith("_")]
    res = {}
    for name in names:
        res[name] = {"lower": max(r[name] for r in out["program"].values())}
        for kind in out:
            if kind != "program" and out[kind]:
                res[name][kind] = min(r[name] for r in out[kind].values())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_json(spec.ROOT.parent / "BENCHMARK.json")
    entry = spec.workload(bench, args.workload)
    traffic = spec.traffic(entry["traffic"])
    cell = spec.entry(traffic["entry"])(spec.config(entry["config"]), traffic, args.seeds[0],
                                        torch.device("cuda", 0))
    cell.setup()
    out = readings(cell, args.seeds, args.control_seeds)
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
              "readings": out, "summary": summary(out)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
