"""The third traced pass: the train step's device time and the device's idle
time put down to the program's spans, on the profiler's clock.

After the two passes of ``trace.py`` (the device alone; the host's
operators), ``pass3`` profiles ``profile_calls`` more calls with the device's
activity alone, as the first pass, while the program records its spans
(``avjepa_tpu_torch/utils/spans.py``). A profile's events lie at
``trace_start_ns()`` plus their offset on the unix clock, and the recorder
puts its spans there too, so the two share one timeline. A call's:

- device time by span: a kernel, copy or set belongs to the innermost span
  open when its launch was made, the runtime call with its correlation id
  (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...),
  whatever thread made it (the backward launches from autograd's thread
  while the step's thread waits in ``train.backward``); a launch under no
  span counts as ``outside``. Where more than 1% of the pass's device time
  finds no launch, the phases are not read;
- idle time by span: every gap between the merged device intervals from
  the pass's first span to its last, split exactly by the innermost span
  over each part of it (``outside`` under none). ``trace.idle_gaps`` names
  only gaps over 2 us; the shorter ones, between back-to-back kernels,
  are about a third of a device-bound step's idle time on an H100, so
  they count here too, and ``idle_short_ms`` says how much they hold. The split's sum is checked
  against the pass's idle time as ``device_idle_pct`` reads it
  (``idle_window_ms``: the host-timed window less the busy time);
- the host's copy rate: the counter ``h2d_bytes`` over the host seconds of
  the spans ``train.h2d``.

The families ``fwd_ms``, ``bwd_ms``, ``optimizer_ms``, ``launch_idle_ms``,
``h2d_idle_ms`` and ``h2d_host_gbps`` (``metrics/<family>.py``) read this
from the traced summary's ``spans``, which ``with_pass3`` adds to
``run.py``'s. Without a recorder in the program, or with no ``train.step``
recorded, there is nothing to read and they read nothing.

    python3 -m portbench.phases --workload <cell> --seed <n> --seconds <s>

runs one cell as ``python3 -m portbench.run ... --trace 1`` does, with the
third pass and the twelve entries of ``METRICS``, and prints its result line
with the pass's whole summary under ``spans``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from portbench import trace as tracing

OUTSIDE = "outside"
UNMATCHED_MAX = 0.01  # the share of device time without a launch that silences the phases
LAUNCH_PHASES = ("train.forward", "train.backward", "train.update")

# family: unit, better, layer, source
FAMILIES = {
    "fwd_ms": ("ms", "lower", "model step", "device_trace"),
    "bwd_ms": ("ms", "lower", "model step", "device_trace"),
    "optimizer_ms": ("ms", "lower", "model step", "device_trace"),
    "launch_idle_ms": ("ms", "lower", "model step", "device_trace"),
    "h2d_idle_ms": ("ms", "lower", "H2D copy", "device_trace"),
    "h2d_host_gbps": ("GB/s", "higher", "H2D copy", "host_clock"),
}
# suffix: the end-to-end metric it moves, its cells
SUFFIXES = {
    "train": ("train_clips_per_s", ["pretrain.vitl16_av.b24"]),
    "train.device_bound": ("train_clips_per_s.device_bound", ["pretrain.vith16_384.b24"]),
}
METRICS = [{"name": f"{family}.{suffix}", "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": moves, "workloads": cells}
           for family, (unit, better, layer, source) in FAMILIES.items()
           for suffix, (moves, cells) in SUFFIXES.items()]


def innermost(spans, t: np.ndarray) -> list:
    """The name of the innermost span of ``spans`` (name, start, end) over
    each time of ``t``, ``OUTSIDE`` under none: of the spans over it, the
    one that started last."""
    best = np.full(len(t), -np.inf)
    label = np.full(len(t), -1)
    for k, (_, s, e) in enumerate(spans):
        over = (s <= t) & (t < e) & (s >= best)
        best[over], label[over] = s, k
    return [spans[k][0] if k >= 0 else OUTSIDE for k in label]


def device_by_span(device: np.ndarray, launches: np.ndarray, spans) -> tuple[dict, float]:
    """({span name: device seconds}, unmatched seconds) of the device events
    ``device`` [n, 3] (start, end, correlation id) by their launches
    ``launches`` [m, 2] (start, correlation id); times in ns."""
    dur = (device[:, 1] - device[:, 0]) * 1e-9
    order = np.argsort(launches[:, 1], kind="stable")
    ids, at = launches[order, 1], launches[order, 0]
    pos = np.clip(np.searchsorted(ids, device[:, 2]), 0, max(len(ids) - 1, 0))
    found = (np.asarray(ids[pos] == device[:, 2]) if len(ids)
             else np.zeros(len(device), bool))
    out: dict[str, float] = {}
    for name, d in zip(innermost(spans, at[pos[found]]), dur[found]):
        out[name] = out.get(name, 0.0) + float(d)
    return out, float(dur[~found].sum())


def idle_by_span(device: np.ndarray, spans, lo: float, hi: float) -> tuple[dict, float]:
    """({span name: idle seconds}, the seconds of gaps of 2 us or less) of
    the device between ``lo`` and ``hi`` (ns): every gap between its merged
    intervals, split by the innermost span over each part."""
    busy = tracing._union(np.clip(device[:, :2], lo, hi))
    gaps = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    length = gaps[:, 1] - gaps[:, 0]
    short_s = float(length[length <= tracing.MIN_GAP_US * 1e3].sum()) * 1e-9
    cuts = np.unique(np.concatenate([[lo, hi], np.clip([t for _, s, e in spans for t in (s, e)],
                                                       lo, hi)]))
    out: dict[str, float] = {}
    for name, a, b in zip(innermost(spans, 0.5 * (cuts[:-1] + cuts[1:])), cuts[:-1], cuts[1:]):
        part = np.clip(np.minimum(gaps[:, 1], b) - np.maximum(gaps[:, 0], a), 0, None).sum()
        if part > 0:
            out[name] = out.get(name, 0.0) + float(part) * 1e-9
    return out, short_s


def attribute(device: np.ndarray, launches: np.ndarray, records, counters: dict,
              calls: int) -> dict | None:
    """A call's device ms and idle ms by span, the share of device time
    without a launch, the idle ms in gaps of 2 us or less and the host's
    copy rate, from the pass's device events and launches (ns from the
    trace's start) and the program's ``records`` (the same clock); None
    where no ``train.step`` was recorded."""
    spans = [(r.name, float(r.start_ns), float(r.end_ns)) for r in records]
    if not any(name == "train.step" for name, _, _ in spans):
        return None
    lo, hi = min(s for _, s, _ in spans), max(e for _, _, e in spans)
    dev_s, unmatched_s = device_by_span(device, launches, spans)
    idle_s, short_s = idle_by_span(device, spans, lo, hi)
    total_s = sum(dev_s.values()) + unmatched_s
    h2d_s = sum(e - s for name, s, e in spans if name == "train.h2d") * 1e-9
    h2d_bytes = counters.get("h2d_bytes")
    return {
        "calls": calls,
        "device_ms": {k: 1e3 * v / calls for k, v in sorted(dev_s.items())},
        "unmatched_pct": 100.0 * unmatched_s / total_s if total_s > 0 else 0.0,
        "idle_ms": {k: 1e3 * v / calls for k, v in sorted(idle_s.items())},
        "idle_short_ms": 1e3 * short_s / calls,
        "h2d_host_gbps": h2d_bytes / h2d_s * 1e-9 if h2d_bytes and h2d_s > 0 else None,
    }


def profile_events(prof) -> tuple[np.ndarray, np.ndarray, int]:
    """(device events [n, 3], launches [m, 2], the trace's start in unix ns)
    of a profile: the kernels, copies and sets ``trace.py`` counts, and the
    runtime and driver calls (``cu...``), ns from the trace's start."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = np.array([[e.time_range.start * 1e3, e.time_range.end * 1e3, e.id]
                       for e in events if tracing._on_device(e)], np.float64).reshape(-1, 3)
    launches = np.array([[e.time_range.start * 1e3, e.id] for e in events
                         if e.device_type == DeviceType.CPU and e.name.startswith("cu")],
                        np.float64).reshape(-1, 2)
    return device, launches, prof.profiler.kineto_results.trace_start_ns()


def pass3(cell, start: int, calls: int) -> dict | None:
    """Profiles ``calls`` calls from ``start`` (the device's activity alone)
    while the program records its spans: ``attribute``'s summary with the
    pass's host seconds, or None where the program has no span recorder."""
    try:
        from avjepa_tpu_torch.utils import spans
    except ImportError:
        return None
    with spans.recording() as rec:
        prof, events, window_s = tracing.profile(lambda j: cell.call(start + j), calls,
                                                 host=False)
    device, launches, t0 = profile_events(prof)
    # the spans of the profile that was kept (a retried profile drops its first)
    records = [r._replace(start_ns=r.start_ns - t0, end_ns=r.end_ns - t0)
               for r in rec.spans if r.start_ns >= t0]
    out = attribute(device, launches, records, rec.counters, calls)
    if out is not None:
        # the pass's idle time as device_idle_pct reads it, for the split's check
        busy_s = tracing.device_summary(events, calls, window_s, {})["busy_s"]
        out.update(window_s=window_s, idle_window_ms=1e3 * (window_s - busy_s) / calls)
    return out


def with_pass3(traced):
    """``traced`` (``run.py``'s ``_traced``: its two passes) followed by
    ``pass3``: its summary under ``spans`` in the traced summary, where the
    readers find it, and in the result's ``breakdown``, with the first
    pass's host seconds beside it."""
    def three(cell, start: int, traffic: dict, peaks, root):
        summary, breakdown = traced(cell, start, traffic, peaks, root)
        n, m = int(traffic["profile_calls"]), int(traffic["host_profile_calls"])
        summary["spans"] = pass3(cell, start + n + m, n)
        breakdown["spans"] = summary["spans"] and dict(summary["spans"],
                                                      pass1_window_s=summary["window_s"])
        return summary, breakdown
    return three


def _spans(w) -> dict | None:
    return None if w.trace is None else w.trace.get("spans")


def device_ms(w, name: str) -> float | None:
    """The device ms a call launched in the span ``name``; the readers'."""
    s = _spans(w)
    if s is None or s["unmatched_pct"] > 100.0 * UNMATCHED_MAX:
        return None
    return s["device_ms"].get(name, 0.0)


def idle_ms(w, *names: str) -> float | None:
    """The device's idle ms a call while the host was in the spans ``names``."""
    s = _spans(w)
    return None if s is None else sum(s["idle_ms"].get(n, 0.0) for n in names)


def h2d_host_gbps(w) -> float | None:
    s = _spans(w)
    return None if s is None else s["h2d_host_gbps"]


def main(argv=None) -> int:
    import torch

    from portbench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(run.CACHE / sub)
    if not torch.cuda.is_available():
        print("phases: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_json(run.CHECKOUT / "BENCHMARK.json")
    bench["per_layer"] += METRICS
    cell_entry = spec.workload(bench, args.workload)
    print(f"phases: {args.workload} seed {args.seed} on {run._power_limit()}", file=sys.stderr)
    parents = run._traced
    run._traced = with_pass3(parents)
    try:
        result = run.run_cell(bench, cell_entry, args.seed, args.seconds, True,
                              torch.device("cuda", 0), run.T_START)
    finally:
        run._traced = parents
    result.pop("_where", None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
