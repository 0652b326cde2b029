"""The program's spans and a device profile on one clock, on a CUDA device:
a kernel run inside a span lies inside it, its launch is found by its
correlation id, and the third traced pass reads every family on the tiny
train cell.

    python3 -m pytest portbench/tests -m cuda -q

Skips where there is no CUDA device (decided inside the tests)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import phases, run, spec
from portbench.tests.conftest import TRAIN, make_root, tiny_bench
from avjepa_tpu_torch.utils import spans


@pytest.mark.cuda
def test_a_kernel_inside_a_span_lies_inside_it_on_the_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)  # the first launch's set-up, before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a kernel launched first in a profile can go unrecorded
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with spans.recording() as rec:
            for _ in range(5):
                with spans.span("sleep"):
                    torch.cuda._sleep(2_000_000)  # ~1 ms
                    torch.cuda.synchronize()
    device, launches, t0 = phases.profile_events(prof)
    sleeps = device[device[:, 1] - device[:, 0] > 2e5]  # over 0.2 ms
    assert len(sleeps) == len(rec.spans) == 5, (device, rec.spans, t0)
    for (s, e, _), r in zip(sleeps[np.argsort(sleeps[:, 0])], rec.spans):
        assert r.start_ns - t0 <= s < e <= r.end_ns - t0, (r, s, e)
    dev, unmatched = phases.device_by_span(
        sleeps, launches, [(r.name, r.start_ns - t0, r.end_ns - t0) for r in rec.spans])
    assert unmatched == 0.0 and set(dev) == {"sleep"}


@pytest.mark.cuda
def test_the_third_pass_reads_every_family_on_the_tiny_cell(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    root = make_root(tmp_path / "root")
    bench = tiny_bench()
    bench["per_layer"] += [dict(m, workloads=[TRAIN]) for m in phases.METRICS
                           if m["name"].endswith(".train")]
    monkeypatch.setattr(run, "_traced", phases.with_pass3(run._traced))
    r = run.run_cell(bench, spec.workload(bench, TRAIN), 2**31 + 9, 1.0, True,
                     torch.device("cuda", 0), 0.0, root)
    assert r["correct"], r["checks"]
    got = r["breakdown"]["spans"]
    assert got["unmatched_pct"] < 1.0, got
    assert sum(got["idle_ms"].values()) == pytest.approx(got["idle_window_ms"], rel=0.01)
    for family in phases.FAMILIES:
        assert r["metrics"][family + ".train"]["value"] >= 0, family
