"""The third traced pass (``phases.py``) on synthetic events: the idle split
sums to the idle time, a launch puts its work in its span, work without a launch
silences the phases, and the two passes before it read as without it."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from portbench import phases, run, spec
from portbench import trace as tracing
from avjepa_tpu_torch.utils import spans
from avjepa_tpu_torch.utils.spans import Record

US = 1e3  # ns


def _step(t0: float = 0.0):
    """One recorded step at ``t0`` (ns): h2d 0-200 us, forward 210-500,
    backward 500-800, update 800-900, sync 900-1000."""
    recs = [Record(0, "train.step", None, 1, t0, t0 + 1000 * US, 3)]
    for k, (name, a, b) in enumerate((("train.h2d", 0, 200), ("train.forward", 210, 500),
                                      ("train.backward", 500, 800), ("train.update", 800, 900),
                                      ("train.sync", 900, 1000)), 1):
        recs.append(Record(k, name, 0, 1, t0 + a * US, t0 + b * US, 3))
    return recs


def _window(summary):
    return run.Window(trace={"spans": summary})


def test_idle_split_sums_to_the_idle_time():
    # busy 0-150, 300-450, 600-1000 us: idle 150-200 in h2d, 200-210 in the
    # step between its children, 210-300 and 450-500 in the forward, 500-600
    # in the backward
    device = np.array([[0, 150, 1], [300, 450, 2], [600, 1000, 3]]) * [US, US, 1]
    recs = _step()
    out = phases.attribute(device, np.empty((0, 2)), recs, {}, 1)
    want = {"train.h2d": 50e-3, "train.step": 10e-3, "train.forward": 140e-3,
            "train.backward": 100e-3}
    assert out["idle_ms"] == pytest.approx(want)
    assert sum(out["idle_ms"].values()) == pytest.approx(1.0 - 0.7)  # 1000 us, 700 busy
    assert out["idle_short_ms"] == 0.0
    # a gap of 1.5 us counts in the split, and among the short ones
    device = np.array([[0, 150, 1], [300, 450, 2], [451.5, 1000, 3]]) * [US, US, 1]
    out = phases.attribute(device, np.empty((0, 2)), recs, {}, 1)
    assert out["idle_ms"] == pytest.approx({"train.h2d": 50e-3, "train.step": 10e-3,
                                            "train.forward": 91.5e-3})
    assert out["idle_short_ms"] == pytest.approx(1.5e-3)


def test_idle_outside_every_span_and_per_call():
    # two steps 1000 us apart with 500 us between them under no span
    recs = _step() + [r._replace(id=r.id + 10, start_ns=r.start_ns + 1500 * US,
                                 end_ns=r.end_ns + 1500 * US,
                                 parent=None if r.parent is None else 10) for r in _step()]
    device = np.array([[0, 1000, 1], [1500, 2500, 2]]) * [US, US, 1]
    out = phases.attribute(device, np.empty((0, 2)), recs, {}, 2)
    assert out["idle_ms"] == pytest.approx({phases.OUTSIDE: 0.25})
    assert out["idle_short_ms"] == 0.0


def test_a_launch_puts_its_work_in_its_span():
    recs = _step()
    # kernel 1 launched in the forward runs during the backward; 2 launched
    # in the backward (autograd's thread: no matter) runs during the update;
    # 3 launched between spans of the step; 4 has no launch
    launches = np.array([[250, 1], [600, 2], [205, 3], [50, 7]], np.float64) * [US, 1]
    device = np.array([[520, 560, 1], [810, 830, 2], [400, 401, 3], [900, 901, 4]],
                      np.float64) * [US, US, 1]
    dev, unmatched = phases.device_by_span(device, launches,
                                           [(r.name, r.start_ns, r.end_ns) for r in recs])
    assert dev == pytest.approx({"train.forward": 40e-6, "train.backward": 20e-6,
                                 "train.step": 1e-6})
    assert unmatched == pytest.approx(1e-6)
    # a launch before every span counts as outside
    dev, _ = phases.device_by_span(device[:1], np.array([[-5 * US, 1]]),
                                   [(r.name, r.start_ns, r.end_ns) for r in recs])
    assert dev == pytest.approx({phases.OUTSIDE: 40e-6})


@pytest.mark.parametrize("unmatched_us,silent", [(0.5, False), (2.0, True)])
def test_device_time_without_a_launch_silences_the_phases(unmatched_us, silent):
    recs = _step()
    launches = np.array([[250, 1], [600, 2], [850, 3]], np.float64) * [US, 1]
    device = np.array([[300, 340, 1], [600, 640, 2], [850, 870, 3],
                       [900, 900 + unmatched_us, 9]], np.float64) * [US, US, 1]
    out = phases.attribute(device, launches, recs, {"h2d_bytes": 4 * 10**5}, 1)
    assert out["unmatched_pct"] == pytest.approx(100 * unmatched_us / (100 + unmatched_us))
    w = _window(out)
    read = {f: spec.metric_reader(f + ".train")(w) for f in phases.FAMILIES}
    if silent:
        assert read["fwd_ms"] is read["bwd_ms"] is read["optimizer_ms"] is None
    else:
        assert read["fwd_ms"] == pytest.approx(0.04) and read["bwd_ms"] == pytest.approx(0.04)
        assert read["optimizer_ms"] == pytest.approx(0.02)
    # the idle time and the copy rate read all the same: 400 kB in 200 us
    assert read["h2d_idle_ms"] == pytest.approx(0.2)
    assert read["launch_idle_ms"] == pytest.approx(0.25 + 0.26 + 0.08)
    assert read["h2d_host_gbps"] == pytest.approx(2.0)


def test_readers_read_nothing_without_spans():
    for w in (run.Window(trace=None), run.Window(trace={"busy_s": 1.0}), _window(None)):
        for f in phases.FAMILIES:
            assert spec.metric_reader(f + ".train.device_bound")(w) is None
    recs = [r for r in _step() if r.name != "train.step"]
    assert phases.attribute(np.empty((0, 3)), np.empty((0, 2)), recs, {}, 1) is None


def test_the_metrics_are_those_of_the_readers():
    names = [m["name"] for m in phases.METRICS]
    assert len(names) == len(set(names)) == 12
    bench = spec.load_json(spec.ROOT.parent / "BENCHMARK.json")
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in phases.METRICS:
        assert set(m["workloads"]) <= cells and m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert spec.metric_reader(m["name"]).__module__.endswith(m["name"].split(".")[0])


# -- the pass on a fake profile ------------------------------------------------
class _Ev:
    def __init__(self, name, device_type, start_ns, end_ns, cid, t0):
        self.name, self.device_type, self.id = name, device_type, cid
        self.is_user_annotation = False
        self.time_range = SimpleNamespace(start=(start_ns - t0) / 1e3, end=(end_ns - t0) / 1e3)


class _Prof:
    def __init__(self, t0, events):
        self._events = events
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(trace_start_ns=lambda: t0))

    def events(self):
        return self._events


class _Cell:
    """Each call a step whose forward launches one 30 us kernel, run 300 us
    later, and marks the launch's unix ns."""

    def __init__(self):
        self.marks = []

    def call(self, i):
        with spans.span("train.step", step=i):
            with spans.span("train.forward"):
                time.sleep(2e-4)
                self.marks.append(time.time_ns())
                time.sleep(2e-4)
            with spans.span("train.backward"):
                time.sleep(5e-4)
        return 1

    def launches_match(self, i, fwd, bwd):
        return True


def _fake_profile(cell):
    def profile(run_call, calls, host):
        t0 = time.time_ns()
        first = len(cell.marks)
        start = time.perf_counter()
        for i in range(calls):
            run_call(i)
        window = time.perf_counter() - start
        events = []
        for k, m in enumerate(cell.marks[first:], 1):
            events.append(_Ev("cudaLaunchKernel", DeviceType.CPU, m, m + 3000, k, t0))
            events.append(_Ev("kernel", DeviceType.CUDA, m + 300_000, m + 330_000, k, t0))
        events.append(_Ev("portbench.call", DeviceType.CPU, t0, time.time_ns(), 0, t0))
        return _Prof(t0, events), [e for e in events if tracing._on_device(e)], window
    return profile


def test_passes_one_and_two_read_as_without_the_third(monkeypatch):
    traffic = {"profile_calls": 3, "host_profile_calls": 1}
    cell = _Cell()
    monkeypatch.setattr(tracing, "profile", _fake_profile(cell))
    two = run._traced(cell, 0, traffic, None, spec.ROOT)
    three = phases.with_pass3(run._traced)(cell, 0, traffic, None, spec.ROOT)
    got = three[0].pop("spans")
    assert three[1].pop("spans") == dict(got, pass1_window_s=three[0]["window_s"])
    for summary, _ in (two, three):
        del summary["window_s"]  # a host time
    assert two[0] == three[0]
    # the idle gaps of the second pass are host times, so only their form
    assert two[1]["device_ops"] == three[1]["device_ops"] and three[1]["idle_gaps"]
    assert set(three[1]) == set(two[1]) == {"device_ops", "idle_gaps"}
    assert got["calls"] == 3 and got["unmatched_pct"] == 0.0
    assert got["device_ms"] == pytest.approx({"train.forward": 0.03}, rel=1e-6)
    assert {"train.forward", "train.backward"} <= set(got["idle_ms"])
    # the host's loop between the spans is not in the split
    assert sum(got["idle_ms"].values()) == pytest.approx(got["idle_window_ms"], rel=0.05)
