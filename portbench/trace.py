"""The traced window: torch.profiler over a few calls, reduced to numbers.

Two profiles follow the untraced window. The first records the device alone
(CUDA activity): its kernels, copies and sets give the busy seconds, the
device time by kernel name and the host-to-device copy time; the window is
timed by the host's clock from before the first call to after the device has
finished the last. The second records the host's operators too, and serves
only to name what the host was doing in each idle gap of the device: its
operators slow the host, so its idle share is not the first's.

CUPTI at times returns a profile with no device event; such a profile is
taken again, up to ``PROFILE_TRIES`` times in all, each retry printed on
standard error (the retry of ``chip_smoke.py::_cuda_events``).
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict

import numpy as np

PROFILE_TRIES = 3
NAMED_GAPS = 2000  # the longest gaps that are named by the host's operator
MIN_GAP_US = 2.0


def _on_device(e) -> bool:
    """A kernel, copy or set: a device event that is no range annotation
    (the host profile puts ``portbench.call`` on the device's timeline too)."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != "portbench.call")


def _device_events(prof):
    return [e for e in prof.events() if _on_device(e)]


def profile(run, calls: int, host: bool):
    """torch.profiler over ``calls`` calls of ``run(i)``: (the profiler, its
    device events, the window's host seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with torch_profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                with torch.profiler.record_function("portbench.call"):
                    run(i)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        events = _device_events(prof)
        if events:
            return prof, events, window
        print(f"profile: attempt {attempt} of {PROFILE_TRIES} recorded no device event"
              + ("; taking it again" if attempt < PROFILE_TRIES else "; giving up"),
              file=sys.stderr)
    return prof, [], window


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end] rows of ``intervals``."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def kernel_in(name: str, prefixes) -> bool:
    """Whether the kernel ``name`` (as the profiler gives it, with its return
    type, namespaces and template arguments) is one of ``prefixes``' function
    names."""
    return any(re.search(r"(^|[\s:])" + re.escape(p) + r"($|[<(])", name) for p in prefixes)


def device_summary(events, calls: int, window_s: float, kernel_classes: dict) -> dict:
    """busy_s, window_s, per call: the device seconds by name, of the
    host-to-device copies and of each class of ``kernels.json``."""
    iv = np.array([[e.time_range.start, e.time_range.end] for e in events], np.float64)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6 if len(iv) else 0.0
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    per_call = {k: v / calls for k, v in by_name.items()}
    classes = {cls: sum(v for k, v in per_call.items() if kernel_in(k, prefixes))
               for cls, prefixes in kernel_classes.items()}
    htod = sum(v for k, v in per_call.items() if k.startswith("Memcpy HtoD"))
    return {"busy_s": busy, "window_s": window_s, "calls": calls, "by_name": per_call,
            "classes": classes, "htod_s": htod}


def idle_gaps(prof, calls: int, top: int = 10) -> list:
    """The device's idle seconds a call inside the profiled calls, summed by
    the innermost host operator that ran at the middle of each gap ("python"
    where none did), the ``top`` largest."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = np.array([[e.time_range.start, e.time_range.end] for e in events if _on_device(e)],
                   np.float64)
    spans = [e for e in events if e.device_type == DeviceType.CPU and e.name == "portbench.call"]
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name != "portbench.call"]
    if not len(dev) or not spans:
        return []
    lo, hi = min(e.time_range.start for e in spans), max(e.time_range.end for e in spans)
    busy = _union(dev)
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = np.clip(edges, lo, hi)
    gaps = gaps[gaps[:, 1] - gaps[:, 0] > MIN_GAP_US]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:NAMED_GAPS]
    hs = np.array([e.time_range.start for e in host], np.float64)
    he = np.array([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    by: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = names[inside[np.argmin(he[inside] - hs[inside])]] if len(inside) else "python"
        by[name] += (e - s) * 1e-6 / calls
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_ops(by_name: dict, top: int = 10) -> list:
    return sorted(([k[:160], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]
