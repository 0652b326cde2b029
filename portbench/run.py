"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and limits
are found by the names in ``BENCHMARK.json`` (``spec.py``). The run:

1. builds the program and the cell's inputs from the seed and warms every
   shape through the window's own call: ``setup_s`` is process start to the
   first timed call;
2. calls the entry in a closed loop for ``--seconds`` (the window), each call
   timed by the host's clock to its own synchronisation;
3. with ``--trace 1``, profiles a few more calls (``trace.py``) and reads the
   per-layer metrics from both; without, reads the end-to-end ones;
4. reads the device's peak memory, releases the program, runs the reference
   and compares (``check.py``), printing each number beside its limit as the
   last lines of standard error and under ``checks``, the last key of the
   result.

It fails, printing no result, without a CUDA device, with fewer devices than
the cell asks for, or when JAX or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the program's and the toolchain's caches, at fixed paths inside the checkout
CACHE = CHECKOUT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "avjepa_tpu")


class Window:
    """What the metric readers read (``metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _traced(cell, start: int, traffic: dict, peaks: dict | None, root: Path):
    """The traced calls after the window (``trace.py``): the device summary
    that the per-layer metrics read, with the attention work's least time a
    call and whether the program's launches match the calls counted; and the
    result's ``breakdown``."""
    from avjepa_tpu_torch.ops import flash_attention as fa
    from portbench import spec
    from portbench import trace as tracing

    n = int(traffic["profile_calls"])
    fa.reset_launches()
    _, events, window_s = tracing.profile(lambda j: cell.call(start + j), n, host=False)
    summary = tracing.device_summary(events, n, window_s, spec.kernel_classes(root))
    fwd = fa.LAUNCHES["fwd_packed"] + fa.LAUNCHES["fwd"]
    bwd = fa.LAUNCHES["bwd_packed"] + fa.LAUNCHES["bwd"]
    summary["launches_ok"] = (fwd % n == 0 and bwd % n == 0
                              and cell.launches_match(start, fwd // n, bwd // n))
    if not summary["launches_ok"]:
        print(f"trace: attention launches {fa.LAUNCHES} over {n} calls differ from the "
              "calls the model makes; attention rooflines left out", file=sys.stderr)
    summary["attn_least_s"] = None if not peaks else sum(
        c.least_s(peaks["bf16_flops_per_s"], peaks["bytes_per_s"])
        for j in range(n) for c in cell.attention(start + j)) / n
    m = int(traffic["host_profile_calls"])
    prof, _, _ = tracing.profile(lambda j: cell.call(start + n + j), m, host=True)
    breakdown = {"device_ops": tracing.top_ops(summary["by_name"]),
                 "idle_gaps": tracing.idle_gaps(prof, m)}
    return summary, breakdown


def run_cell(bench: dict, cell_entry: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path | None = None) -> dict:
    """One run of ``cell_entry`` on ``device``: the result object."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa
    from portbench import check, spec

    root = root or spec.ROOT
    conf = spec.config(cell_entry["config"], root)
    traffic = spec.traffic(cell_entry["traffic"], root)
    limits = spec.limits(cell_entry["name"], root)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    cell = spec.entry(traffic["entry"], root)(conf, traffic, seed, device)

    cell.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.1f} s", file=sys.stderr)

    fa.reset_launches()
    calls, times, clips = 0, [], 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        clips += cell.call(calls)
        te = time.perf_counter()
        times.append(te - ts)
        calls += 1
        if te - t0 >= seconds:
            break
    w = Window(setup_s=setup_s, window_s=te - t0, call_s=times, calls=calls,
               clips=clips, flops=[cell.flops(i) for i in range(calls)],
               peaks=spec.peaks(kind, root), trace=None)

    breakdown = None
    if trace and cuda:
        w.trace, breakdown = _traced(cell, calls, traffic, w.peaks, root)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    t_ref = time.perf_counter()
    print(f"portbench: window and trace {t_ref - t0:.1f} s", file=sys.stderr)
    numbers = cell.numbers()
    print(f"portbench: reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct, checks = check.verdict(numbers, limits)

    metrics = {}
    for m in spec.reports(bench, cell_entry["name"], trace):
        value = spec.metric_reader(m["name"], root)(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell_entry["chips"]), "memory_peak_bytes": peak}
    if w.trace is not None:
        dev.update(busy_s=w.trace["busy_s"], window_s=w.trace["window_s"])
    result = {"correct": bool(correct), "attempted": calls, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    result["_where"] = numbers.get("_where")
    return result


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    from portbench import spec

    bench = spec.load_json(CHECKOUT / "BENCHMARK.json")
    cell_entry = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell_entry["chips"]):
        print(f"portbench: {args.workload} needs {cell_entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}", file=sys.stderr)
    result = run_cell(bench, cell_entry, args.seed, args.seconds, bool(args.trace), device,
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    where = result.pop("_where", None)
    if where:
        print(f"portbench: worst leaves {where}", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
