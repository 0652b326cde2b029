"""Whole runs of tiny cells on the CPU, with the chip's look skipped:

- the reference agrees with the port in float32 (the port's plain attention
  path on the CPU): the train steps and the embeddings;
- the frozen mask sampler draws what the port's sampler draws;
- files added under new names (a configuration, a traffic mix, an entry with
  its own loop, limits, a metric) are found without an edit to the runner;
- the control (the reference in float8 in the program's place) and each
  fault a cell can have (a step that leaves its state unchanged, half of each
  batch left out, an answer altered where it is made) come out not correct.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from portbench import masks, run, spec
from portbench.tests.conftest import EXTRACT, TRAIN, tiny_bench

SEED = 2**31 + 17  # past 32 signed bits, as a run's seed may be
CPU = torch.device("cpu")


def _run(root, name, bench=None, trace=False, seed=SEED):
    bench = bench or tiny_bench()
    return run.run_cell(bench, spec.workload(bench, name), seed, 0.3, trace, CPU, 0.0, root)


def test_reference_agrees_with_the_port_in_float32(f32_root):
    r = _run(f32_root, TRAIN)
    assert r["correct"], r["checks"]
    assert all(c["value"] < 1e-4 for c in r["checks"].values()), r["checks"]
    assert {"train_clips_per_s", "train_step_ms_p90", "setup_s"} == set(r["metrics"])
    assert r["attempted"] >= 1 and r["failed"] == 0
    r = _run(f32_root, EXTRACT)
    assert r["correct"], r["checks"]
    assert r["checks"]["embed_gap"]["value"] < 1e-5
    assert {"extract_clips_per_s", "setup_s"} == set(r["metrics"])
    assert list(r)[-2:] == ["checks", "_where"]  # run.main prints checks last


def test_one_reference_step_and_one_encode_against_the_port(f32_root):
    conf = json.loads((f32_root / "configs" / "tiny_av.json").read_text())
    conf["check_steps"] = 1
    cell = spec.entry("train", f32_root)(conf, spec.traffic("pretrain_staged", f32_root), 5, CPU)
    cell.setup()
    cell.release()
    n = cell.numbers()
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-5, n
    ex = spec.entry("extract", f32_root)(conf, spec.traffic("extract_staged", f32_root), 5,
                                         CPU)
    ex.setup()
    ex.call(0)
    ex.release()
    assert ex.numbers()["embed_gap"] < 1e-5


def test_frozen_sampler_draws_the_ports_masks():
    """The frozen draws are the port's, and the index arrays that the train
    entry has the program's helper build from them are the port's too."""
    from avjepa_tpu_torch.layout import TokenLayout
    from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator

    conf = spec.config("vitl16_av")
    cfgs = conf["yaml"]["pretrain"]["mask"]
    ours = masks.MaskCollator(cfgs, masks.Grid(8, 14, 14, 8, 12, True), base_seed=SEED)
    theirs = make_mask_collator("multiblock3d", cfgs, TokenLayout(), base_seed=SEED)
    program_masks = spec.entry_module("train").program_masks
    for _ in range(2):
        for a, b in zip(program_masks(ours(3)), theirs(3)):
            for f in ("enc", "pred", "enc_idx", "union_idx"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_files_added_under_new_names_are_found(f32_root):
    shutil.copy(f32_root / "configs" / "tiny_av.json", f32_root / "configs" / "tiny_b.json")
    traffic = json.loads((f32_root / "traffic" / "pretrain_staged.json").read_text())
    traffic["max_batches"] = 3
    traffic["entry"] = "train_pairs"
    (f32_root / "traffic" / "pretrain_few.json").write_text(json.dumps(traffic))
    # an entry with a loop of its own: two train steps a call
    (f32_root / "entries" / "train_pairs.py").write_text(
        "from pathlib import Path\n"
        "from portbench import spec\n\n"
        "class Cell(spec.entry('train', Path(__file__).resolve().parent.parent)):\n"
        "    def call(self, i):\n"
        "        return super().call(2 * i) + super().call(2 * i + 1)\n")
    shutil.copy(f32_root / "limits" / f"{TRAIN}.json", f32_root / "limits" / "pretrain.new.json")
    (f32_root / "metrics" / "calls_per_s.py").write_text(
        "def read(w):\n    return w.calls / w.window_s\n")
    (f32_root / "metrics" / "clips_a_call.py").write_text(
        "def read(w):\n    return w.clips / w.calls\n")
    bench = tiny_bench()
    bench["workloads"].append({"name": "pretrain.new", "config": "tiny_b",
                               "traffic": "pretrain_few", "chips": 1})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock"})
    bench["end_to_end"].append({"name": "clips_a_call", "unit": "clips", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["pretrain.new"]})
    # a metric of a family reads its family's file: mfu.train.new reads mfu.py
    bench["per_layer"].append({"name": "mfu.train.new", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "calls_per_s", "workloads": ["pretrain.new"]})
    r = _run(f32_root, "pretrain.new", bench)
    assert r["correct"] and r["metrics"]["calls_per_s"]["value"] > 0
    assert r["metrics"]["clips_a_call"]["value"] == 2 * 4  # two steps of the tiny batch
    # a metric that lists its cells reports only there
    assert set(r["metrics"]) == {"calls_per_s", "clips_a_call", "setup_s"}
    assert spec.metric_reader("mfu.train.new", f32_root).__module__.endswith("mfu")


def test_the_bfloat16_program_passes_its_limits(bf16_root):
    for name in (TRAIN, EXTRACT):
        r = _run(bf16_root, name)
        assert r["correct"], r["checks"]


def test_the_float8_control_comes_out_not_correct(bf16_root):
    """The reference in float8 put in the program's place: its numbers,
    against the float32 reference, fail the limits. The same reference
    rounded to bfloat16 at the same points passes them, as the bf16 program
    does: the rounding points are the program's."""
    from portbench import check

    limits = spec.limits(TRAIN, bf16_root)
    conf = spec.config("tiny_av", bf16_root)
    cell = spec.entry("train", bf16_root)(conf, spec.traffic("pretrain_staged", bf16_root),
                                           SEED, CPU)
    cell.setup()
    ref = cell.reference()
    correct, checks = check.verdict(check.train_numbers(cell.reference("fp8"), ref), limits)
    assert not correct, checks
    correct, checks = check.verdict(check.train_numbers(cell.reference("bfloat16"), ref), limits)
    assert correct, checks
    ex = spec.entry("extract", bf16_root)(conf, spec.traffic("extract_staged", bf16_root),
                                         SEED, CPU)
    ex.setup()
    ex.call(0)
    refs = ex.reference()
    control = list(ex.reference("fp8").items())
    correct, checks = check.verdict(check.embed_numbers(control, refs, ex.batch),
                                    spec.limits(EXTRACT, bf16_root))
    assert not correct, checks


def _frozen_step(state, sched, cfg, **kw):
    """A train step that computes the loss and leaves the state as it was."""
    from avjepa_tpu_torch.train.step import loss_fn

    kw.pop("full_metrics", None)
    with torch.no_grad():
        loss = loss_fn(state, cfg, **kw)[0]
    return {"loss": float(loss)}


def _half_batch_step(real):
    def step(state, sched, cfg, video, audio, enc_masks, pred_masks, enc_idx=None,
             union_idx=None, **kw):
        h = video.shape[0] // 2
        return real(state, sched, cfg, video[:h], None if audio is None else audio[:h],
                    enc_masks[:, :h], pred_masks[:, :h],
                    None if enc_idx is None else tuple(i[:h] for i in enc_idx),
                    None if union_idx is None else union_idx[:, :h], **kw)
    return step


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_comes_out_not_correct(bf16_root, monkeypatch, fault):
    from avjepa_tpu_torch.train import pretrain

    broken = _frozen_step if fault == "unchanged_state" else _half_batch_step(pretrain.train_step)
    monkeypatch.setattr(pretrain, "train_step", broken)
    r = _run(bf16_root, TRAIN)
    assert not r["correct"], r["checks"]


def _altered(real):
    def encode(encoder, video, audio, ex):
        out = real(encoder, video, audio, ex).clone()
        out[0] = out[0] * 1.1
        return out
    return encode


def _half(real):
    def encode(encoder, video, audio, ex):
        h = video.shape[0] // 2
        return real(encoder, video[:h], None if audio is None else audio[:h], ex)
    return encode


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_a_broken_encode_comes_out_not_correct(bf16_root, monkeypatch, fault):
    from avjepa_tpu_torch.serve import extract

    monkeypatch.setattr(extract, "encode", (_altered if fault == "altered_answer" else _half)(
        extract.encode))
    r = _run(bf16_root, EXTRACT)
    assert not r["correct"], r["checks"]


def test_calibrate_reads_program_and_control(bf16_root):
    """The calibration tool's readings and summary, at the tiny size: the
    program's largest reading stays under the control's smallest."""
    from portbench import calibrate

    conf = spec.config("tiny_av", bf16_root)
    cell = spec.entry("extract", bf16_root)(conf, spec.traffic("extract_staged", bf16_root),
                                           SEED, CPU)
    cell.setup()
    out = calibrate.readings(cell, [SEED, SEED + 1], [SEED])
    assert set(out["program"]) == {SEED, SEED + 1} and set(out["control"]) == {SEED}
    s = calibrate.summary(out)["embed_gap"]
    assert s["lower"] < s["control"]
