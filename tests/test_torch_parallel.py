"""The port's data parallelism (``avjepa_tpu_torch/parallel/dist.py`` and the
rank-aware apps) with two gloo ranks on the CPU, held against one process and
against the JAX package's train step on the global batch.

The ranks are OS processes (tests/torch_dp_worker.py), the stand-in for one
process per GPU over NCCL, as tests/test_multihost.py's workers stand in for
TPU hosts; this file mirrors that file's six tests (run and resume, the
single-process golden, sampler and collator discipline, the video eval, the
SIGTERM agreement, extract's shards) and adds: a two-rank step equal to one
rank's and to ``make_train_step``'s on the concatenated batch, also when the
ranks' target-token counts differ; one gradient all-reduce a step; the same
weights on every rank; the image eval and the avprediction apps at two
ranks; the helpers without a process group; and the launcher
(``app/main_distributed.py``). The fsdp axis (``parallel/fsdp.py``) is held
the same way: the step under ``mesh_fsdp: 2`` and on a 2 x 2 (data, fsdp)
mesh of four ranks against one process, the data axis and JAX; the
avjepa, vjepa and avprediction apps under ``mesh_fsdp: 2``; checkpoints
crossing between fsdp 2, data 2 and one process. Small sizes, f32. Every process has
a 60 s rendezvous and collective limit and every spawn (a group of worker
modes) a 120 s join, after which it is killed and the test fails; each
spawn takes a fresh port.
"""

import csv
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import torch_dp_worker as worker
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu_torch.app import main_distributed
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler
from avjepa_tpu_torch.evals import image_classification as ic
from avjepa_tpu_torch.evals import video_classification as vc
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.masks.multiblock3d import MaskSet, make_mask_collator, stack_masksets
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.registry import app_main
from avjepa_tpu_torch.train import optim, pretrain
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils.checkpoint import encoder_from_jax_params, predictor_from_jax_params
from avjepa_tpu_torch.utils.logging import get_logger

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LAYOUT = JaxTokenLayout(**worker.LAYOUT)
MASKS = [
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 8, "spatial_scale": [0.15, 0.15],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.5, 0.5],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
]
JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    """One thread a rank: beside the other test workers' processes, a rank
    with two spinning threads ran a tiny step several times slower than
    with one."""
    return dict(os.environ, OMP_NUM_THREADS="1")


def _spawn(world: int, outdir: str, modes) -> None:
    """``world`` worker ranks over a fresh port, joined within JOIN_S
    seconds; a rank that fails or hangs fails the test."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), port, outdir, *modes],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                pytest.fail(f"worker timed out; tail:\n{out[-4000:]}")
            assert p.returncode == 0, f"worker failed:\n{out[-6000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _masks(seed: int, b: int):
    """(enc [M, b, N], pred, enc_idx list of [b, K], union [M, b, Ku])."""
    layout = TokenLayout(**worker.LAYOUT)
    return stack_masksets(make_mask_collator("multiblock3d", MASKS, layout, base_seed=seed)(b),
                          True)


def _step_inputs(case: str) -> list:
    """Three global batches of 4 with their masks. ``equal``: one collator
    draw for all 4 samples (the ranks' halves hold as many target tokens);
    ``unequal``: rank 0's half and rank 1's from two different draws."""
    steps = []
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        video = rng.normal(size=(4, 4, 64, 64, 3)).astype(np.float32)
        audio = rng.normal(size=(4, 128, 192, 1)).astype(np.float32)
        if case == "equal":
            enc, pred, idx, union = _masks(10 + i, 4)
        else:
            halves = [_masks(10 + i, 2), _masks(50 + i, 2)]
            assert all(a.shape == b.shape for a, b in zip(halves[0][2], halves[1][2]))
            enc, pred = (np.concatenate([h[j] for h in halves], 1) for j in (0, 1))
            idx = [np.concatenate([h[2][k] for h in halves], 0) for k in range(len(MASKS))]
            union = np.concatenate([h[3] for h in halves], 1)
        steps.append(dict(video=video, audio=audio, enc=enc, pred=pred, union=union,
                          **{f"idx{k}": a for k, a in enumerate(idx)}))
    return steps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process too, as each worker rank has: the
    test workers share the cores, and a thread per core in every process
    slows them all down many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the worker modes spawned together, each group well inside the join limit
# on a loaded CPU; avprediction and the fsdp apps read pretrain's
# checkpoints; hsdp_step runs on four ranks, the others on two
# (the tensor-axis modes ride in groups that were there: tp_pretrain after
# pretrain, whose checkpoint it resumes)
GROUPS = (("step", "info"), ("pretrain", "tp_pretrain"), ("preempt",), ("avprediction",),
          ("eval", "extract"), ("fsdp_step", "tp_step"), ("fsdp_pretrain", "fsdp_vjepa"),
          ("fsdp_avprediction", "tp_avprediction"), ("hsdp_step", "tp_fsdp_step"))
NEEDS = {"avprediction": "pretrain", "fsdp_pretrain": "pretrain", "fsdp_avprediction": "pretrain",
         "tp_avprediction": "pretrain"}
WORLD = {"hsdp_step": 4}


class _Results(dict):
    """(mode, rank) -> that rank's result; the first use of a mode spawns
    the two ranks of its group (a fresh port and a join limit each)."""

    def __init__(self, outdir: str):
        super().__init__()
        self.outdir = outdir

    def __missing__(self, key):
        modes = next(g for g in GROUPS if key[0] in g)
        for mode in modes:
            if mode in NEEDS and (NEEDS[mode], 0) not in self:
                self.__missing__((NEEDS[mode], 0))
        world = WORLD.get(modes[0], 2)
        _spawn(world, self.outdir, modes)
        for mode in modes:
            for r in range(world):
                with open(os.path.join(self.outdir, f"result_{mode}_{r}.json")) as f:
                    self[mode, r] = json.load(f)
        return self[key]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The step inputs, the JAX initial state, the directory, and the
    workers' results by (mode, rank)."""
    outdir = str(tmp_path_factory.mktemp("dp"))
    jenc, jpred = JaxEncoder(layout=JAX_LAYOUT, **worker.ENC), JaxPredictor(layout=JAX_LAYOUT,
                                                                             **worker.PRED)
    jstate = jax_init_state(jax_init_encoder_params(jenc, jax.random.key(7)),
                            jax_init_predictor_params(jpred, jax.random.key(8)))
    layout = TokenLayout(**worker.LAYOUT)
    weights = {
        "encoder": encoder_from_jax_params(Encoder(layout, **worker.ENC),
                                           jstate.enc_params).state_dict(),
        "predictor": predictor_from_jax_params(Predictor(layout, **worker.PRED),
                                               jstate.pred_params).state_dict(),
    }
    torch.save(weights, os.path.join(outdir, "weights.pt"))
    inputs = {case: _step_inputs(case) for case in worker.CASES}
    for case, steps in inputs.items():
        np.savez(os.path.join(outdir, f"step_{case}.npz"),
                 **{k: np.stack([s[k] for s in steps]) for k in steps[0]})
    return {"dir": outdir, "inputs": inputs, "jax": (jenc, jpred, jstate), "weights": weights,
            "results": _Results(outdir), "cache": {}}


def _cached(dp, key, make):
    if key not in dp["cache"]:
        dp["cache"][key] = make()
    return dp["cache"][key]


def _one_process(dp, case: str) -> dict:
    """The three steps of ``case`` in one process on the global batch: the
    losses, the first step's metrics and gradients."""
    def make():
        state = worker.build_state(dp["weights"])
        out = {"losses": []}
        for i, step in enumerate(dp["inputs"][case]):
            m = train_step(state, optim.ScheduleConfig(**worker.SCHED),
                           StepConfig(**worker.STEP), **worker.local_half(step, 0, 1))
            out["losses"].append(m["loss"])
            if i == 0:
                out["first"] = m
                out["grads"] = {f"{name}/{k}": p.grad.numpy().copy()
                                for name, mod in (("encoder", state.encoder),
                                                  ("predictor", state.predictor))
                                for k, p in mod.named_parameters()}
        return out

    return _cached(dp, ("one", case), make)


def _jax_run(dp, case: str) -> dict:
    """The JAX step on the global batch: the three steps' losses, the first
    step's metrics and its gradients as state dicts (read from its first
    AdamW moment, mu = (1 - b1) * g)."""
    def make():
        jenc, jpred, jstate = dp["jax"]
        jstep = jax.jit(make_train_step(jenc, jpred, jax_optim.ScheduleConfig(**worker.SCHED),
                                        JaxStepConfig(**worker.STEP)))
        out = {"losses": []}
        for i, s in enumerate(dp["inputs"][case]):
            jstate, jm = jstep(jstate, jnp.asarray(s["video"]), jnp.asarray(s["audio"]),
                               jnp.asarray(s["enc"]), jnp.asarray(s["pred"]),
                               tuple(jnp.asarray(s[f"idx{k}"]) for k in range(len(MASKS))),
                               jnp.asarray(s["union"]))
            out["losses"].append(float(jm["loss"]))
            if i == 0:
                out["first"] = {k: float(jm[k]) for k in ("loss", "enc_grad_avg",
                                                          "pred_grad_avg")}
                out["grads"] = {}
                for name, mu in (("encoder", jstate.enc_opt.mu),
                                 ("predictor", jstate.pred_opt.mu)):
                    to_sd = getattr(jax_torch_import, f"{name}_params_to_state_dict")
                    sd = to_sd(jax.tree_util.tree_map(lambda x: np.asarray(x) / 0.1, mu))
                    out["grads"].update({f"{name}/{k}": v for k, v in sd.items()})
        return out

    return _cached(dp, ("jax", case), make)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", worker.CASES)
def test_two_rank_step_matches_one_rank_and_jax(dp, case):
    """Two ranks of 2 samples against one process on the 4 (the same
    train_step without a process group) and against the JAX step on the 4:
    the first step's loss within 1e-5 relative and every parameter's
    gradient within 1e-4 relative L2 (the JAX gradients read from its first
    AdamW moment, mu = (1 - b1) * g), three steps' losses within 2e-3, as
    tests/test_torch_train.py::test_train_step_matches_jax holds them. In
    the ``unequal`` case the ranks' target-token counts differ, so a mean of
    per-rank means would be off: the loss divides by the global count."""
    r0, r1 = dp["results"]["step", 0][case], dp["results"]["step", 1][case]
    assert r0["losses"] == r1["losses"]
    if case == "unequal":
        assert all(a != b for a, b in zip(r0["pred_counts"], r1["pred_counts"]))
    else:
        assert r0["pred_counts"] == r1["pred_counts"]
    grads = np.load(os.path.join(dp["dir"], f"grads_{case}.npz"))
    first = dp["results"]["step", 0][f"{case}_first"]

    # one process, the global batch
    one = _one_process(dp, case)
    for k in ("loss", "enc_grad_avg", "pred_grad_avg"):
        assert abs(first[k] - one["first"][k]) <= 1e-5 * abs(one["first"][k]), k
    for k, g in one["grads"].items():
        assert _rel_l2(grads[k], g) <= 1e-4, k
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=2e-3)

    # the JAX step on the global batch
    jx = _jax_run(dp, case)
    for k in ("loss", "enc_grad_avg", "pred_grad_avg"):
        assert abs(first[k] - jx["first"][k]) <= 1e-5 * abs(jx["first"][k]), k
    assert sorted(grads.files) == sorted(jx["grads"])
    for k in grads.files:
        assert _rel_l2(grads[k], jx["grads"][k]) <= 1e-4, k
    np.testing.assert_allclose(r0["losses"], jx["losses"], rtol=2e-3)


def test_one_grad_reduction_per_step(dp):
    """The encoder's and predictor's gradients go through one all-reduce a
    step, whatever the encoder's passes (target, two context passes)."""
    for r in range(2):
        for case in worker.CASES:
            assert dp["results"]["step", r][case]["reductions"] == [1, 1, 1]


def test_weights_identical_across_ranks(dp):
    """After every step both ranks hold the same encoder, predictor and
    target encoder, to the bit, and the weights move each step."""
    for case in worker.CASES:
        d0 = dp["results"]["step", 0][case]["digests"]
        assert d0 == dp["results"]["step", 1][case]["digests"]
        assert len(set(d0)) == 3


# ---------------------------------------------------------------------------
# the fsdp axis
# ---------------------------------------------------------------------------


def _check_sharding(sharding: dict, shards: int, index: int) -> None:
    """Every parameter is a DTensor whose local shard is this rank's chunk
    (``index`` of ``shards``) of dimension 0, as ``torch.chunk`` cuts it."""
    for name, params in sharding.items():
        assert params, name
        for k, (full, shard, _) in params.items():
            per = -(-full[0] // shards)
            rows = max(0, min(per, full[0] - index * per))
            assert shard == [rows, *full[1:]], (name, k, full, shard)


# the port's models cut by the tensor axis: the worker's models have 3
# heads, which do not divide over 2 ranks, so their attention stays whole
# (as JAX's param_shardings replicates an axis that does not divide); their
# MLPs and the predictor's output projection are cut
TP_CUT = (r"(blocks|predictor_blocks)\.\d+\.mlp\.fc1\.(weight|bias)",
          r"(blocks|predictor_blocks)\.\d+\.mlp\.fc2\.weight", r"predictor_proj\.weight")


def _check_tensor_split(dp, sharding: dict) -> None:
    """The parameters the tensor axis cuts are TP_CUT's, each to half of its
    whole shape along the Megatron dimension (rows of fc1, columns of fc2
    and predictor_proj)."""
    import re

    for name, params in sharding.items():
        full = dp["weights"]["encoder" if name == "target_encoder" else name]
        for k, (_, _, piece) in params.items():
            if not any(re.fullmatch(pat, k) for pat in TP_CUT):
                assert piece is None, (name, k)
                continue
            dim = 0 if ".fc1." in k else 1
            want = list(full[k].shape)
            want[dim] //= 2
            assert piece == want, (name, k, piece, want)


def _check_step_run(dp, prefix: str, mode: str, case: str, world: int, shards: int,
                    weight_rel: float = 1e-5, grad_reductions: int = 0,
                    shard_reductions: int = 2, tensor: int = 1) -> None:
    """A sharded run of the step mode ``mode`` against one process, the data
    axis and JAX: first-step metrics within 1e-5 relative, gathered
    gradients within 1e-4 relative L2, the three losses within 2e-3 of JAX's,
    the weights after three steps within ``weight_rel`` relative L2 of the
    data axis's; ``grad_reductions`` gradient all-reduces a step (none when
    FSDP2's reduce-scatter averaged every gradient) and
    ``shard_reductions`` all-reduces over the shards (the norms, the
    moments' statistics) a step, and with ``tensor`` > 1 two over the
    tensor group, which cut TP_CUT's parameters; the same losses and
    whole weights on every rank. (Against one
    process the weights differ more: AdamW divides each gradient by the
    root of its second moment, which magnifies the sums' other order in the
    smallest gradients.)"""
    rs = [dp["results"][mode, r][case] for r in range(world)]
    for r in rs[1:]:
        assert r["losses"] == rs[0]["losses"] and r["digests"] == rs[0]["digests"]
    for rank, r in enumerate(rs):
        assert r["reductions"] == [grad_reductions] * 3, r["reductions"]
        assert r["shard_reductions"] == [shard_reductions] * 3, r["shard_reductions"]
        if shards > 1:
            _check_sharding(r["sharding"], shards, rank // tensor % shards)
        if tensor > 1:
            assert [t[1] for t in r["tensor_reductions"]] == [2, 2, 2]
            _check_tensor_split(dp, r["sharding"])
    first = dp["results"][mode, 0][f"{case}_first"]
    one, jx = _one_process(dp, case), _jax_run(dp, case)
    for k in ("loss", "enc_grad_norm", "pred_grad_norm", "enc_grad_avg", "pred_grad_avg",
              "opt_mu_abs"):
        assert abs(first[k] - one["first"][k]) <= 1e-5 * abs(one["first"][k]), k
    for k in ("loss", "enc_grad_avg", "pred_grad_avg"):
        assert abs(first[k] - jx["first"][k]) <= 1e-5 * abs(jx["first"][k]), k
    grads = np.load(os.path.join(dp["dir"], f"{prefix}grads_{case}.npz"))
    assert sorted(grads.files) == sorted(one["grads"]) == sorted(jx["grads"])
    for k in grads.files:
        assert _rel_l2(grads[k], one["grads"][k]) <= 1e-4, k
        assert _rel_l2(grads[k], jx["grads"][k]) <= 1e-4, k
    np.testing.assert_allclose(rs[0]["losses"], jx["losses"], rtol=2e-3)
    dp["results"]["step", 0]  # the data axis's run writes weights_<case>.npz
    got = np.load(os.path.join(dp["dir"], f"{prefix}weights_{case}.npz"))
    want = np.load(os.path.join(dp["dir"], f"weights_{case}.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in got.files:
        assert _rel_l2(got[k], want[k]) <= weight_rel, k


@pytest.mark.parametrize("case", worker.CASES)
def test_fsdp_step_matches_data_one_process_and_jax(dp, case):
    """``mesh_fsdp: 2``: the encoder, predictor and target encoder sharded
    over the two ranks, the step held against one process,
    the data axis and JAX (``_check_step_run``)."""
    _check_step_run(dp, "fsdp_", "fsdp_step", case, world=2, shards=2)


def test_hsdp_step_matches_data_one_process_and_jax(dp):
    """Four ranks on a 2 x 2 (data, fsdp) mesh, one sample each: FSDP2's
    HSDP shards over 'fsdp' and replicates over 'data'; the step as
    ``test_fsdp_step_matches_data_one_process_and_jax`` holds it, but the
    weights within the gradients' 1e-4 of the two-rank data axis's: four
    ranks of one sample sum the batch in another split than two of two."""
    _check_step_run(dp, "hsdp_", "hsdp_step", "unequal", world=4, shards=2, weight_rel=1e-4)


def test_tensor_step_matches_data_one_process_and_jax(dp):
    """``mesh_tensor: 2``: both ranks run the whole global batch of 4, the
    Megatron layers cut over them (TP_CUT); the step as
    ``test_fsdp_step_matches_data_one_process_and_jax`` holds it, with one
    gradient all-reduce a step (over the batch group, one rank) and the
    weights within the gradients' 1e-4 of the data axis's: the row-parallel
    products sum their halves in another order."""
    _check_step_run(dp, "tp_", "tp_step", "unequal", world=2, shards=1, weight_rel=1e-4,
                    grad_reductions=1, shard_reductions=0, tensor=2)


def test_tensor_fsdp_step_matches_data_one_process_and_jax(dp):
    """Four ranks, fsdp 2 x tensor 2: each tensor piece sharded by FSDP2
    over the two ranks of its batch group; the step as
    ``test_tensor_step_matches_data_one_process_and_jax`` holds it, with no
    gradient all-reduce (the reduce-scatter averaged every gradient)."""
    _check_step_run(dp, "tp_fsdp_", "tp_fsdp_step", "unequal", world=4, shards=2,
                    weight_rel=1e-4, tensor=2)


def test_tensor_mesh_lays_out_ranks_as_jax(dp):
    """``make_mesh`` lays the ranks out row-major over (data, fsdp, tensor),
    as ``avjepa_tpu/parallel/mesh.py:82-85`` lays out devices: rank r is
    index r % tensor of its tensor group and shard r // tensor of the
    sampler, index r // tensor of its batch group of data x fsdp ranks."""
    for mode, world in (("tp_step", 2), ("tp_fsdp_step", 4)):
        for r in range(world):
            mesh = dp["results"][mode, r]["mesh"]
            assert mesh == {"batch": world // 2, "batch_rank": r // 2, "tensor_index": r % 2,
                            "batch_index": r // 2}, (mode, r, mesh)


def test_tensor_axis_cuts_heads_within_q_k_v(dp):
    """A tiny encoder whose 4 heads of 32 pack, cut over two ranks with
    remat: each rank's qkv holds 2 heads of each of q, k and v ([3 x 64,
    128]) and runs the packed path on them, once a layer under remat; the
    output and every parameter's whole gradient equal the unsharded
    encoder's within f32 rounding (1e-5 of the largest)."""
    for r in range(2):
        b = dp["results"]["tp_step", r]["block"]
        assert b["local_qkv"] == [192, 128] and b["packed_calls"] == 2
        assert sorted(b["cut"]) == sorted(
            f"blocks.{i}.{k}" for i in range(2)
            for k in ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                      "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight"))
        assert b["out_err"] <= 1e-5 * b["out_max"]
        for k, err in b["grad_err"].items():
            assert err <= 1e-5 * b["grad_max"][k], (k, err, b["grad_max"][k])


def test_tensor_pretrain_and_checkpoints_cross(dp, tmp_path):
    """The avjepa app under ``mesh_tensor: 2`` (both ranks load the same
    batch of 2) logs the losses of one process on the same config, and
    writes, key by key, the checkpoint it writes (the tensor pieces joined:
    qkv's heads back in [3, H, d] order); the tensor checkpoint loads
    strictly in one process and writes back the same bits; the data axis's
    step-2 checkpoint resumed under ``mesh_tensor: 2`` gives one process's
    resumed loss from it."""
    from avjepa_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    r0, r1 = dp["results"]["tp_pretrain", 0], dp["results"]["tp_pretrain", 1]
    assert r0["losses"] == r1["losses"] and r0["resume_losses"] == r1["resume_losses"]
    assert len(r0["losses"]) == 2 and r0["summary"]["step"] == 3
    tag = worker.pretrain_cfg("x")["logging"]["write_tag"]
    one = str(tmp_path / "one")
    pretrain.run(load_config(worker.pretrain_cfg(one)), device="cpu")
    np.testing.assert_allclose(r0["losses"], worker.read_losses(
        os.path.join(one, f"{tag}_r0.csv")), rtol=1e-5)
    tp_file = os.path.join(dp["dir"], "pretrain-tp", f"{tag}-latest.pth.tar")
    got = _checkpoint(tp_file)
    want = _checkpoint(os.path.join(one, f"{tag}-latest.pth.tar"))
    _assert_same_checkpoint(got, want, 1e-4)
    assert got["world_size"] == 1 and got["step"] == 2

    # tensor 2 -> one process, and back to the same bits
    cfg = load_config(worker.pretrain_cfg(str(tmp_path / "one-from-tp")))
    handles = pretrain.setup(cfg, torch.device("cpu"))
    try:
        load_train_state(tp_file, handles.state)
        assert handles.state.step == 2
        again = str(tmp_path / "one-from-tp.pth.tar")
        save_train_state(again, handles.state, epoch=got["epoch"], loss=got["loss"],
                         batch_size=got["batch_size"], lr=got["lr"], world_size=1)
        _assert_same_checkpoint(_checkpoint(again), got, 0.0)
    finally:
        handles.loader.close()

    # data 2 -> tensor 2, against data 2 -> one process on the same batches
    resume = str(tmp_path / "one-resume")
    os.makedirs(resume)
    import shutil
    shutil.copy(os.path.join(dp["dir"], "pretrain", "step2.pth.tar"),
                os.path.join(resume, f"{tag}-latest.pth.tar"))
    d = worker.pretrain_cfg(resume, optimization={"epochs": 2}, meta={"load_checkpoint": True})
    pretrain.run(load_config(d), max_steps=1, device="cpu")
    np.testing.assert_allclose(r0["resume_losses"], worker.read_losses(
        os.path.join(resume, f"{tag}_r0.csv")), rtol=1e-5)


def test_tensor_avprediction_matches_single(dp, tmp_path):
    """avprediction under ``mesh_tensor: 2``: the frozen target encoder and
    predictor cut, the probe whole; both ranks log the probe losses one
    process logs on the same config."""
    from avjepa_tpu_torch.train import avprediction

    r0, r1 = dp["results"]["tp_avprediction", 0], dp["results"]["tp_avprediction", 1]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    d = worker.prediction_cfg(str(tmp_path), worker.pretrain_checkpoint(dp["dir"]))
    avprediction.run(load_config(d), device="cpu")
    tag = d["logging"]["write_tag"]
    np.testing.assert_allclose(r0["losses"], worker.read_losses(
        os.path.join(str(tmp_path), f"{tag}_probe_r0.csv")), rtol=1e-4, atol=1e-6)


def _checkpoint(path: str) -> dict:
    return torch.load(path, weights_only=True)


def _assert_same_checkpoint(got: dict, want: dict, rel: float) -> None:
    """The same keys, tensors of the same shapes and dtypes within ``rel``
    relative L2, the same optimizer groups and state layout."""
    assert sorted(got) == sorted(want)
    for key in ("encoder", "predictor", "target_encoder"):
        assert sorted(got[key]) == sorted(want[key]), key
        for k, v in want[key].items():
            assert got[key][k].shape == v.shape and got[key][k].dtype == v.dtype, (key, k)
            assert _rel_l2(got[key][k], v) <= rel, (key, k)
    assert got["opt"]["param_groups"] == want["opt"]["param_groups"]
    assert sorted(got["opt"]["state"]) == sorted(want["opt"]["state"])
    for i, s in want["opt"]["state"].items():
        assert sorted(got["opt"]["state"][i]) == sorted(s)
        for k, v in s.items():
            assert got["opt"]["state"][i][k].shape == v.shape, (i, k)
            assert _rel_l2(got["opt"]["state"][i][k], v) <= rel, (i, k)
    for k in ("epoch", "batch_size", "world_size", "step"):
        assert got[k] == want[k], k


def test_fsdp_pretrain_matches_data_and_checkpoints_cross(dp):
    """The avjepa app under ``mesh_fsdp: 2`` logs the losses of the
    ``mesh_data: 2`` run on the same batches and writes, key by key, the
    checkpoint it writes; the data run's checkpoint resumed under fsdp
    gives the data run's resumed loss; the fsdp checkpoint loads strictly
    in one process, weights and AdamW state equal to the file's, and takes
    a step there."""
    from avjepa_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    r0, r1 = dp["results"]["fsdp_pretrain", 0], dp["results"]["fsdp_pretrain", 1]
    data = dp["results"]["pretrain", 0]
    assert r0["losses"] == r1["losses"] and r0["resume_losses"] == r1["resume_losses"]
    np.testing.assert_allclose(r0["losses"], data["losses"], rtol=1e-5)
    assert len(r0["resume_losses"]) == 1 and r0["summary"]["step"] == 3
    np.testing.assert_allclose(r0["resume_losses"], data["resume_losses"][:1], rtol=1e-5)

    tag = worker.pretrain_cfg("x")["logging"]["write_tag"]
    fsdp_file = os.path.join(dp["dir"], "pretrain-fsdp", f"{tag}-latest.pth.tar")
    got = _checkpoint(fsdp_file)
    _assert_same_checkpoint(got, _checkpoint(os.path.join(dp["dir"], "pretrain",
                                                          "step2.pth.tar")), 1e-5)
    assert got["world_size"] == 2 and got["step"] == 2

    # fsdp 2 -> one process
    cfg = load_config(worker.pretrain_cfg(os.path.join(dp["dir"], "one-from-fsdp")))
    handles = pretrain.setup(cfg, torch.device("cpu"))
    try:
        load_train_state(fsdp_file, handles.state)
        assert handles.state.step == 2
        again = os.path.join(dp["dir"], "one-from-fsdp.pth.tar")
        save_train_state(again, handles.state, epoch=got["epoch"], loss=got["loss"],
                         batch_size=got["batch_size"], lr=got["lr"], world_size=2)
        _assert_same_checkpoint(_checkpoint(again), got, 0.0)
        video, audio, _, masks = next(iter(handles.loader))
        assert np.isfinite(handles.step(video, audio, masks)["loss"])
    finally:
        handles.loader.close()


def _golden_losses(cfg, steps: int = 2) -> list:
    """One process driving the two ranks' global batches (each rank's shard
    of the sampler and its own collator, concatenated): the losses."""
    handles = pretrain.setup(cfg, torch.device("cpu"))
    handles.loader.close()
    loaders, its = _shard_loaders(cfg, pretrain.build_dataset(cfg, cfg.layout()))
    losses = []
    try:
        for ld in loaders:
            ld.set_epoch(0)
        for _ in range(steps):
            losses.append(handles.step(*_global_batch(cfg, its))["loss"])
    finally:
        _close(loaders, its)
    return losses


def test_fsdp_vjepa_matches_single(dp):
    """The vjepa app (video only) under ``mesh_fsdp: 2``: both ranks log the
    global loss, which one process computes on the ranks' global batch."""
    r0, r1 = dp["results"]["fsdp_vjepa", 0], dp["results"]["fsdp_vjepa", 1]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert r0["summary"]["step"] == 2
    d = worker.fsdp_vjepa_cfg(os.path.join(dp["dir"], "golden-vjepa"))
    d["tpu"]["mesh_fsdp"] = 1
    np.testing.assert_allclose(r0["losses"], _golden_losses(load_config(d)), rtol=3e-4,
                               atol=3e-4)


def test_fsdp_avprediction_matches_data_and_single(dp):
    """avprediction under ``mesh_fsdp: 2``: the frozen target encoder and
    predictor sharded, the probe replicated; the probe's losses and
    the av_prediction eval equal the data axis's, whose losses one process
    reproduces (``test_two_rank_avprediction_matches_single``)."""
    r0, r1 = dp["results"]["fsdp_avprediction", 0], dp["results"]["fsdp_avprediction", 1]
    data = dp["results"]["avprediction", 0]
    assert r0["losses"] == r1["losses"] and r0["eval"] == r1["eval"]
    np.testing.assert_allclose(r0["losses"], data["losses"], rtol=1e-5, atol=1e-7)
    for k in ("mse_video", "mse_audio"):
        np.testing.assert_allclose(r0["eval"][k], data["eval"][k], rtol=1e-5)
    for rank, r in enumerate((r0, r1)):
        probe = r["sharding"].pop("probe")
        assert probe and all(shard is None for _, shard, _ in probe.values())
        _check_sharding(r["sharding"], 2, rank)


# ---------------------------------------------------------------------------
# the six tests of tests/test_multihost.py
# ---------------------------------------------------------------------------


def test_two_rank_run_and_resume(dp):
    r0, r1 = dp["results"]["pretrain", 0], dp["results"]["pretrain", 1]
    assert r0["world"] == r1["world"] == 2
    assert len(r0["losses"]) == 2 and len(r0["resume_losses"]) == 2
    assert np.isfinite(r0["losses"]).all() and np.isfinite(r0["resume_losses"]).all()
    # the logged loss is the global one: every rank logs the same value
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0["resume_losses"], r1["resume_losses"], rtol=1e-6)
    assert r0["saved_step"] == 2 and r0["saved_world_size"] == 2
    assert r0["summary"]["step"] == r1["summary"]["step"] == 4
    assert r0["resources"] and r1["resources"]  # <tag>_resources_r{rank}.csv


def _shard_loaders(cfg, dataset):
    """Each rank's loader as the apps build it (its shard of the sampler,
    its own collator from the same seed, counter at -1), and iterators."""
    loaders = []
    for r in range(2):
        collator = make_mask_collator(cfg.data.mask_type or cfg.tpu.mask_type, cfg.mask,
                                      cfg.layout(), base_seed=cfg.meta.seed)
        sampler = ShardedSampler(len(dataset), cfg.data.batch_size, seed=cfg.meta.seed,
                                 num_shards=2, shard_index=r)
        loaders.append(BatchLoader(dataset, sampler, num_workers=1, mask_collator=collator))
    return loaders, [iter(ld) for ld in loaders]


def _global_batch(cfg, its):
    """(video, audio, masks) of the global batch: the ranks' next local
    batches concatenated (audio None for a video-only layout)."""
    parts = [next(it) for it in its]
    cat = lambda xs: None if xs[0] is None else np.concatenate(xs, 0)  # noqa: E731
    masks = [MaskSet(*(cat([getattr(p[3][j], f.name) for p in parts])
                       for f in dataclasses.fields(MaskSet)))
             for j in range(len(cfg.mask))]
    return cat([p[0] for p in parts]), cat([p[1] for p in parts]), masks


def _close(loaders, its):
    for it in its:
        it.close()
    for ld in loaders:
        ld.close()


def test_two_rank_matches_single_rank_golden(dp):
    """One process driving the two ranks' global batch (each rank's shard
    of the sampler and its own collator, concatenated) computes the losses
    the two ranks logged."""
    cfg = load_config(worker.pretrain_cfg(os.path.join(dp["dir"], "golden")))
    np.testing.assert_allclose(dp["results"]["pretrain", 0]["losses"], _golden_losses(cfg),
                               rtol=3e-4, atol=3e-4)


def test_cross_rank_sampler_and_collator_discipline(dp):
    r0, r1 = dp["results"]["info", 0], dp["results"]["info", 1]
    # identically seeded collators at the local batch draw the same masks and
    # block sizes on every rank (so the K buckets agree)
    assert r0["collator_sha"] == r1["collator_sha"]
    assert r0["block_sizes"] == r1["block_sizes"]
    s0, s1 = set(r0["sampler_indices"]), set(r1["sampler_indices"])
    assert s0.isdisjoint(s1) and len(r0["sampler_indices"]) == len(r1["sampler_indices"])
    assert s0 | s1 == set(range(32))


@pytest.mark.parametrize("name", ["video", "image"])
def test_two_rank_classification_eval_matches_single(dp, tmp_path, name):
    """Validation's top-1 over the all-reduced counts equals one process's
    on the same 32 clips (or images); the probe's logged loss is the global
    one; rank 0 wrote the classifier."""
    rs = [dp["results"]["eval", r][name] for r in range(2)]
    module, make = (vc, worker.eval_cfg) if name == "video" else (ic, worker.image_eval_cfg)
    golden = module.run(make(str(tmp_path), "val", num_epochs=0), device="cpu")
    assert rs[0]["val_top1_untrained"] == rs[1]["val_top1_untrained"]
    assert rs[0]["val_top1_trained"] == rs[1]["val_top1_trained"]
    np.testing.assert_allclose(rs[0]["train_losses"], rs[1]["train_losses"], rtol=1e-6)
    assert len(rs[0]["train_losses"]) == 2 and np.isfinite(rs[0]["train_losses"]).all()
    assert rs[0]["val_top1_untrained"] == golden["val_top1"]
    assert os.path.isfile(os.path.join(dp["dir"], "eval", f"{name}-train-cls-latest.pth.tar"))


def test_two_rank_avprediction_matches_single(dp):
    """The probe's two steps on the ranks' global batch equal one process's
    on the concatenated batch (its loss is a mean over equal local
    batches); the example is written once; both ranks score the
    av_prediction eval alike."""
    from avjepa_tpu_torch.train import avprediction

    r0, r1 = dp["results"]["avprediction", 0], dp["results"]["avprediction", 1]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert r0["eval"] == r1["eval"] and np.isfinite(r0["eval"]["mse_video"])
    assert os.path.isfile(r0["example"])
    d = worker.prediction_cfg(os.path.join(dp["dir"], "golden-probe"),
                              worker.pretrain_checkpoint(dp["dir"]))
    cfg = load_config(d)
    handles, state, sched = avprediction.setup_probe(cfg, torch.device("cpu"))
    handles.loader.close()
    assert avprediction.restore_jepa_weights(handles, cfg, get_logger("avjepa_tpu_torch"))
    loaders, its = _shard_loaders(cfg, pretrain.build_dataset(cfg, cfg.layout()))
    losses = []
    try:
        for _ in range(2):
            video, audio, masks = _global_batch(cfg, its)
            losses.append(avprediction.probe_step(
                state, sched, handles.state.target_encoder, handles.state.predictor,
                *avprediction.batch_to_device(video, audio, masks, torch.device("cpu")))["loss"])
    finally:
        _close(loaders, its)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-4, atol=1e-6)


def test_two_rank_sigterm_agreement(dp):
    """SIGTERM to rank 1 only: both ranks stop at the same step (the
    agreement every 8 steps), checkpoint there, and report the preemption."""
    r0, r1 = dp["results"]["preempt", 0], dp["results"]["preempt", 1]
    assert r0["preempted"] and r1["preempted"]
    assert len(r0["losses"]) == len(r1["losses"]) == r0["step"] == r1["step"]
    assert r0["step"] % 8 == 0 and r0["step"] < 60
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    saved = torch.load(os.path.join(dp["dir"], "preempt", "avjepa-vit_tiny-latest.pth.tar"),
                       weights_only=True)
    assert saved["step"] == r0["step"] and saved["world_size"] == 2


def test_two_rank_extract_shards_and_matches_single(dp, tmp_path):
    """Each rank writes the rows it owns; the shards hold every row once
    (rank 1's padded copy of row 0 is not written) and equal one process's
    embeddings."""
    dp["results"]["extract", 0]  # the spawn that writes the shards
    rows = {}
    for r in range(2):
        z = np.load(os.path.join(dp["dir"], "features", f"features_r{r}.npz"))
        for i, e in zip(z["indices"], z["embeddings"]):
            assert int(i) not in rows, "row written by both ranks"
            rows[int(i)] = e
    assert sorted(rows) == list(range(11))
    single = app_main("extract", worker.extract_cfg(str(tmp_path)), device="cpu")
    zs = np.load(os.path.join(single["output"], "features_r0.npz"))
    assert zs["indices"].tolist() == list(range(11))
    for i, e in zip(zs["indices"], zs["embeddings"]):
        np.testing.assert_allclose(rows[int(i)], e, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# without a process group, and the launcher
# ---------------------------------------------------------------------------


def test_helpers_are_the_identity_without_a_process_group():
    assert not dist.active() and (dist.world(), dist.rank(), dist.is_main()) == (1, 0, True)
    assert dist.make_mesh(-1) == dist.Mesh(1, 1, 1)
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1"):
        dist.make_mesh(2)
    with pytest.raises(ValueError, match="mesh 0x2x1 != 1"):
        dist.make_mesh(-1, 2)  # the fsdp axis needs its ranks
    with pytest.raises(ValueError, match="mesh 0x1x2 != 1"):
        dist.make_mesh(-1, 1, 2)  # the tensor axis too
    before = dict(dist.REDUCTIONS)
    t = torch.tensor([1.0, 2.0])
    assert dist.reduce(t, "mean") is t
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(1, 3)).sum().backward()
    g = lin.weight.grad
    dist.all_reduce_grads([lin])
    assert lin.weight.grad is g
    dist.broadcast_module(lin)
    assert dist.agree(True) and not dist.agree(False)
    probs = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]])
    valid = torch.tensor([True, True, False])
    assert dist.count_correct(probs, torch.tensor([0, 0, 0]), valid) == 1
    assert dist.count_valid(valid) == 2
    assert dict(dist.REDUCTIONS) == before


def _tiny_configs(tmp_path, epochs: int):
    """A pretrain config (2 steps an epoch) logging into ``unused`` (the
    launcher's --folder moves it) and a video eval config reading that
    pretrain run's checkpoint from the same folder."""
    folder = str(tmp_path / "out")
    pre = worker.pretrain_cfg(str(tmp_path / "unused"), optimization={"epochs": epochs})
    tag = pre["logging"]["write_tag"]
    ev = {"eval_name": "video_classification_frozen", "tag": "cls",
          "data": {"source": "synthetic", "num_classes": 5, "num_workers": 2,
                   "frames_per_clip": 4, "num_segments": 2, "num_views_per_segment": 1,
                   "frame_step": 2},
          "optimization": {"batch_size": 4, "num_epochs": 1, "resolution": 32,
                           "use_bfloat16": False},
          "pretrain": {"model_name": "vit_tiny", "frames_per_clip": 4, "folder": folder,
                       "checkpoint": f"{tag}-latest.pth.tar"},
          "logging": {"folder": str(tmp_path / "unused")}}
    paths = []
    for name, d in (("pre", pre), ("eval", ev)):
        paths.append(str(tmp_path / f"{name}.yaml"))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(d, f)
    return folder, tag, paths


def _launch(*argv) -> str:
    res = subprocess.run(
        [sys.executable, "-m", "avjepa_tpu_torch.app.main_distributed", "--nproc-per-node",
         "2", "--device", "cpu", "--dist-timeout", "60", *argv],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=JOIN_S)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-6000:]
    return out


def test_launcher_batch_launch_folder_and_resume(tmp_path):
    """``--nproc-per-node 2 --batch-launch`` over a pretrain config and an
    eval config reading its checkpoint, under ``--folder``; then the
    pretrain config with one more epoch under ``--resume-preempt``."""
    folder, tag, (pre, ev) = _tiny_configs(tmp_path, epochs=1)
    out = _launch("--batch-launch", "--folder", folder, "--fname", pre, ev)
    assert not os.path.exists(tmp_path / "unused")
    for r in range(2):
        with open(os.path.join(folder, f"{tag}_r{r}.csv")) as f:
            assert len(list(csv.DictReader(f))) == 2
        with open(os.path.join(folder, f"cls_r{r}.csv")) as f:
            assert len(list(csv.DictReader(f))) == 8  # 64 clips / (4 x 2 ranks)
    assert "[eval] val top-1" in out and "0 missing, 0 shape-mismatched" in out
    saved = torch.load(os.path.join(folder, f"{tag}-latest.pth.tar"), weights_only=True)
    assert saved["step"] == 2 and saved["world_size"] == 2
    assert os.path.isfile(os.path.join(folder, "cls-cls-latest.pth.tar"))

    _, _, (pre, _) = _tiny_configs(tmp_path, epochs=2)
    out = _launch("--resume-preempt", "--folder", folder, "--fname", pre)
    assert "resumed from step 2 " in out
    saved = torch.load(os.path.join(folder, f"{tag}-latest.pth.tar"), weights_only=True)
    assert saved["step"] == 4


def test_launcher_refuses_fsdp_and_a_missing_gpu(tmp_path, monkeypatch):
    """A mesh that does not divide the ranks, ``mesh_tensor: 3`` (the three
    axes run: ``test_fsdp_*``, ``test_tensor_*``), raises in one process and
    in two ranks, whose launcher then exits non-zero; a CUDA run on a
    machine without one raises before any rank starts, in a torchrun rank,
    and in one process: no fall back to the CPU."""
    folder, _, (pre, _) = _tiny_configs(tmp_path, epochs=1)
    with open(pre) as f:
        d = yaml.safe_load(f)
    d["tpu"]["mesh_tensor"] = 3
    with open(pre, "w") as f:
        yaml.safe_dump(d, f)
    with pytest.raises(ValueError, match="mesh 0x1x3 != 1"):
        main_distributed.main(["--fname", pre, "--device", "cpu"])
    # the same through two ranks: the launcher exits with the failing rank's code
    res = subprocess.run(
        [sys.executable, "-m", "avjepa_tpu_torch.app.main_distributed", "--nproc-per-node",
         "2", "--device", "cpu", "--dist-timeout", "60", "--fname", pre],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=JOIN_S)
    assert res.returncode != 0 and "mesh 0x1x3 != 2" in res.stderr, res.stderr[-3000:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_distributed.main(["--fname", pre])
    with pytest.raises(RuntimeError, match="0 GPU"):
        main_distributed.main(["--fname", pre, "--nproc-per-node", "2"])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_distributed.main(["--fname", pre])
    assert not dist.active()
    assert not os.path.exists(folder)
