"""The port's span recorder (``avjepa_tpu_torch/utils/spans.py``): records
only while recording, parents within a thread, stamps on the profiler's
clock, and the train step's spans and counter."""

import threading

import numpy as np
import torch

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from torch_dp_worker import pretrain_cfg
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.masks.multiblock3d import stack_masksets
from avjepa_tpu_torch.train import pretrain
from avjepa_tpu_torch.utils import spans


def test_spans_nest_by_thread_and_inherit_the_step():
    def worker():
        with spans.span("worker.outer"):
            with spans.span("worker.inner"):
                pass

    with spans.recording() as rec:
        with spans.span("root", step=7):
            with spans.span("child"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
            spans.count("items", 3)
            spans.count("items", 4)
    assert not t.is_alive()
    by = {r.name: r for r in rec.spans}
    assert set(by) == {"root", "child", "worker.outer", "worker.inner"}
    assert by["root"].parent is None and by["child"].parent == by["root"].id
    assert by["root"].step == by["child"].step == 7
    # a span opened in another thread has no parent there, nor the step
    assert by["worker.outer"].parent is None and by["worker.outer"].step is None
    assert by["worker.inner"].parent == by["worker.outer"].id
    assert by["worker.outer"].thread != by["root"].thread
    assert by["root"].thread == threading.get_native_id()
    for r in rec.spans:
        assert r.start_ns <= r.end_ns
    assert by["root"].start_ns <= by["child"].start_ns <= by["child"].end_ns <= by["root"].end_ns
    assert [r.start_ns for r in rec.spans] == sorted(r.start_ns for r in rec.spans)
    assert rec.counters == {"items": 7}


def test_nothing_is_kept_while_not_recording():
    with spans.span("alone") as s:
        spans.count("items", 5)
    assert s.ms >= 0.0
    with spans.recording() as rec:
        pass
    with spans.span("after") as s2:
        pass
    assert s2.ms >= 0.0
    assert rec.spans == [] and rec.counters == {}


def test_spans_share_the_profilers_clock():
    """A ``record_function`` range inside a span falls inside the span once
    both are on the unix clock (``trace_start_ns()`` plus the event's
    offset)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            for _ in range(20):
                with spans.span("outer"):
                    with record_function("inner"):
                        x = x @ x.T / 64
    start = prof.profiler.kineto_results.trace_start_ns()
    inner = sorted((start + round(e.time_range.start * 1e3), start + round(e.time_range.end * 1e3))
                   for e in prof.events() if e.name == "inner")
    outer = [(r.start_ns, r.end_ns) for r in rec.spans]
    assert len(inner) == len(outer) == 20
    for (s, e), (a, b) in zip(outer, inner):
        assert s <= a <= b <= e, (s, a, b, e)


def test_train_step_records_its_five_phases(tmp_path):
    h = pretrain.setup(load_config(pretrain_cfg(str(tmp_path))), torch.device("cpu"))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    with spans.recording() as rec:
        metrics = h.step(video, audio, masks, full_metrics=False)
    assert np.isfinite(metrics["loss"])
    roots = [r for r in rec.spans if r.parent is None]
    assert [(r.name, r.step) for r in roots] == [("train.step", 0)]
    children = [r for r in rec.spans if r.parent == roots[0].id]
    assert [r.name for r in children] == ["train.h2d", "train.forward", "train.backward",
                                          "train.update", "train.sync"]
    assert len(rec.spans) == 6 and all(r.step == 0 for r in children)
    assert abs(h.step_ms - (roots[0].end_ns - roots[0].start_ns) * 1e-6) < 1e-6
    enc, pred, idx, union = stack_masksets(masks, with_idx=True)
    host = [video, audio, enc, pred, *(idx if h.cfg.tpu.compact_context else ()),
            *([union] if h.cfg.tpu.compact_predictor else [])]
    assert rec.counters == {"h2d_bytes": sum(np.asarray(a).nbytes for a in host)}
