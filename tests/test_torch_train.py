"""The port's training slice (avjepa_tpu_torch's pretrain app) held against
the JAX package.

The collator copy, the masked reductions, the encoder with ``gather_idx``,
the predictor (dense and compacted), the schedules and one AdamW update, and
whole train steps against ``make_train_step`` on the same weights (flax
params bridged through the reference state-dict layout), inputs and masks;
then the pretrain CLI on the CPU (CSV, checkpoint, resume, extract reading
it), the device rule of the entry points, and the port's copies of the JAX
package's jax-free host modules against the originals. f32 throughout;
inputs made with numpy from a seed.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.data import mel as jax_mel
from avjepa_tpu.data import randaugment as jax_randaugment
from avjepa_tpu.data import transforms as jax_transforms
from avjepa_tpu.data import video_transforms as jax_video_transforms
from avjepa_tpu.data.av_dataset import sample_clip_indices as jax_sample_clip_indices
from avjepa_tpu.data.synthetic import SyntheticAVDataset as JaxSynthetic
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.masks.multiblock3d import make_mask_collator as jax_make_mask_collator
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.train.step import stack_masksets as jax_stack_masksets
from avjepa_tpu.utils import tensors as jax_tensors
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu.utils import monitoring as jax_monitoring
from avjepa_tpu_torch.app.main import launch
from avjepa_tpu_torch.data import mel, randaugment, transforms, video_transforms
from avjepa_tpu_torch.data.av_dataset import sample_clip_indices
from avjepa_tpu_torch.data.synthetic import SyntheticAVDataset
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator, stack_masksets
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.registry import app_main
from avjepa_tpu_torch.serve.extract import build_encoder
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.train import optim
from avjepa_tpu_torch.train.state import init_state
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils import tensors
from avjepa_tpu_torch.utils import monitoring, torch_import
from avjepa_tpu_torch.utils.checkpoint import encoder_from_jax_params, predictor_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# crop 64, 4 frames, with audio: 32 + 96 = 128 tokens. vit_tiny-like (width
# 192, 3 heads of 64: the classic kernel path) at depth 2; the predictor is
# 384 wide with 3 heads of 128 (the packed path), as vit_tiny's is
LAYOUT = TokenLayout(num_frames=4, crop_size=64, patch_size=16, tubelet_size=2)
JAX_LAYOUT = JaxTokenLayout(num_frames=4, crop_size=64, patch_size=16, tubelet_size=2)
ENC = dict(embed_dim=192, depth=2, num_heads=3, uniform_power=True, attn_impl="flash",
           gelu="tanh")
PRED = dict(embed_dim=192, predictor_embed_dim=384, depth=2, num_heads=3,
            uniform_power=True, num_mask_tokens=2, attn_impl="flash", gelu="tanh")
MASKS = [
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 8, "spatial_scale": [0.15, 0.15],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.5, 0.5],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


# ---------------------------------------------------------------------------
# collator, reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_type,audio", [("multiblock3d", True),
                                              ("multiblock3d", False), ("random", True)])
def test_collator_copy_equals_jax(mask_type, audio):
    """Same masks and compact indices over 3 draws, after a resume-style
    counter fast-forward."""
    cfgs = MASKS if mask_type == "multiblock3d" else [{"ratio": 0.75}, {"ratio": 0.5}]
    ours = make_mask_collator(mask_type, cfgs, dataclasses.replace(LAYOUT, audio_enabled=audio),
                              base_seed=5)
    ref = jax_make_mask_collator(mask_type, cfgs,
                                 dataclasses.replace(JAX_LAYOUT, audio_enabled=audio), base_seed=5)
    ours.set_counter(6)
    ref.set_counter(6)
    for _ in range(3):
        got, want = stack_masksets(ours(3), True), jax_stack_masksets(ref(3), True)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        if want[2] is None:
            assert got[2] is None
        else:
            assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))
        np.testing.assert_array_equal(got[3], want[3])


def test_masked_reductions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 5)).astype(np.float32)
    mask = rng.random((3, 17, 1)) < 0.4
    mask[2] = False  # an empty mask: mean 0, var 0
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    np.testing.assert_allclose(tensors.masked_mean(tx, tm).numpy(),
                               np.asarray(jax_tensors.masked_mean(x, mask)), rtol=1e-6)
    np.testing.assert_allclose(tensors.masked_var(tx, tm, 1).numpy(),
                               np.asarray(jax_tensors.masked_var(x, mask, 1)), rtol=1e-5,
                               atol=1e-7)
    assert tensors.masked_mean(tx[2:], tm[2:]).item() == 0.0


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(b, 4, 64, 64, 3)).astype(np.float32)
    audio = rng.normal(size=(b, 128, 192, 1)).astype(np.float32)
    masks = jax_make_mask_collator("multiblock3d", MASKS, JAX_LAYOUT, base_seed=seed)(b)
    return video, audio, masks


def test_encoder_gather_idx_matches_jax():
    """The compacted context encoder (K bucket with a sentinel tail).
    Tolerance 1e-4 max abs: two layers of f32 matmuls summed in other
    orders, then the final LayerNorm."""
    video, audio, masks = _batch(1)
    idx = masks[0].enc_idx
    cmask = idx < LAYOUT.num_tokens
    assert not cmask.all()  # the bucket has sentinel padding
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    params = jax_init_encoder_params(jenc, jax.random.key(2))
    want = jax.jit(jenc.apply)({"params": params}, video, audio, jnp.asarray(cmask),
                               jnp.asarray(idx))
    enc = encoder_from_jax_params(Encoder(LAYOUT, **ENC), params)
    with torch.no_grad():
        got = enc(torch.from_numpy(video), torch.from_numpy(audio), torch.from_numpy(cmask),
                  gather_idx=torch.from_numpy(idx))
    assert got.shape == (2, idx.shape[1], 192)
    np.testing.assert_allclose(got.numpy()[cmask], np.asarray(want)[cmask], rtol=0, atol=1e-4)


@pytest.mark.parametrize("compact", [False, True])
def test_predictor_matches_jax(compact):
    """Both mask configs merged batch-major with per-sample mask-token
    indices, dense and compacted (scatter back with dropped sentinels)."""
    _, _, masks = _batch(3)
    enc, pred, _, union = jax_stack_masksets(masks, True)
    b, n = enc.shape[1:]
    rng = np.random.default_rng(4)
    ctx = rng.normal(size=(2 * b, n, 192)).astype(np.float32)
    enc_all = np.swapaxes(enc, 0, 1).reshape(2 * b, n)
    pred_all = np.swapaxes(pred, 0, 1).reshape(2 * b, n)
    u_all = np.swapaxes(union, 0, 1).reshape(2 * b, -1) if compact else None
    midx = np.tile(np.arange(2, dtype=np.int32), b)
    jpred = JaxPredictor(layout=JAX_LAYOUT, zero_init_mask_tokens=False, **PRED)
    params = jax_init_predictor_params(jpred, jax.random.key(5))
    want = jax.jit(jpred.apply)({"params": params}, ctx, enc_all, pred_all, jnp.asarray(midx),
                                gather_idx=None if u_all is None else jnp.asarray(u_all))
    port = predictor_from_jax_params(Predictor(LAYOUT, **PRED), params)
    with torch.no_grad():
        got = port(torch.from_numpy(ctx), torch.from_numpy(enc_all),
                   torch.from_numpy(pred_all), torch.from_numpy(midx).long(),
                   gather_idx=None if u_all is None else torch.from_numpy(u_all))
    valid = pred_all if not compact else (enc_all | pred_all)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=0, atol=1e-4)
    if compact:
        assert not got.numpy()[~(enc_all | pred_all)].any()


def test_diffusion_predictor_is_refused():
    """The diffusion-fallback predictor has no mask tokens and, as the JAX
    one asserts, refuses a call without the target embeddings and draws."""
    port = Predictor(LAYOUT, use_mask_tokens=False, **PRED)
    assert not any("mask_tokens" in k for k in port.state_dict())
    n = LAYOUT.num_tokens
    ctx, mask = torch.zeros(2, n, 192), torch.ones(2, n, dtype=torch.bool)
    with pytest.raises(ValueError, match="target embeddings"):
        port(ctx, mask, mask)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref_wd,final_wd", [(0.04, 0.4), (0.4, 0.04)])
def test_schedules_match_jax(ref_wd, final_wd):
    kw = dict(ipe=10, num_epochs=8, warmup_epochs=2, ref_wd=ref_wd, final_wd=final_wd)
    ours, ref = optim.ScheduleConfig(**kw), jax_optim.ScheduleConfig(**kw)
    # warmup edges, mid-run, the last step
    for step in (0, 1, 18, 19, 20, 21, 50, ref.total_steps - 2, ref.total_steps - 1):
        s = jnp.asarray(step, jnp.int32)
        # JAX evaluates in f32, the port in f64: an absolute error of about
        # f32 eps x the amplitude (ref_lr - final_lr, ~6e-4 here) near the end
        for f, g in ((optim.lr_at_step, jax_optim.lr_at_step),
                     (optim.wd_at_step, jax_optim.wd_at_step),
                     (optim.ema_at_step, jax_optim.ema_at_step)):
            np.testing.assert_allclose(f(ours, step), float(g(ref, s)), rtol=2e-6, atol=1e-10)


def test_adamw_update_matches_jax():
    """Two AdamW steps (so the moments are not fresh) on one 2D weight (decayed)
    and one bias (not)."""
    rng = np.random.default_rng(6)
    w, bias = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    grads = [(rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32))
             for _ in range(2)]
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T))
        model.bias.copy_(torch.from_numpy(bias))
    opt = optim.make_optimizer([model])
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}
    state = jax_optim.adamw_init(params)
    for i, (gw, gb) in enumerate(grads):
        lr, wd = 1e-2 * (i + 1), 0.1
        model.weight.grad = torch.from_numpy(gw.T.copy())
        model.bias.grad = torch.from_numpy(gb)
        optim.set_lr_wd(opt, lr, wd)
        opt.step()
        params, state = jax_optim.adamw_update(
            {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)}, state, params, lr, wd,
            jax_optim.wd_mask(params))
    np.testing.assert_allclose(model.weight.detach().numpy().T, params["kernel"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(model.bias.detach().numpy(), params["bias"], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step against make_train_step
# ---------------------------------------------------------------------------


def test_train_step_matches_jax():
    """One step's loss, grad-avg and per-parameter grads (relative L2 <=
    1e-4), then
    three steps' losses within 0.2% (ROADMAP's tolerance), on the same
    weights, batches and masks, attn_impl flash on both sides (the Pallas
    kernels in interpret mode, the port's plain versions). The JAX grads are
    read from its first AdamW moment, mu = (1 - b1) * g."""
    kw = dict(ipe=10, num_epochs=4, warmup_epochs=1)
    step_kw = dict(loss_exp=1.0, reg_coeff=0.5, clip_grad=10.0, warmup_epochs=1, ipe=10)
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    jpred = JaxPredictor(layout=JAX_LAYOUT, **PRED)
    jstate = jax_init_state(jax_init_encoder_params(jenc, jax.random.key(7)),
                            jax_init_predictor_params(jpred, jax.random.key(8)))
    jstep = jax.jit(make_train_step(jenc, jpred, jax_optim.ScheduleConfig(**kw),
                                    JaxStepConfig(**step_kw)))
    state = init_state(encoder_from_jax_params(Encoder(LAYOUT, **ENC), jstate.enc_params),
                       predictor_from_jax_params(Predictor(LAYOUT, **PRED), jstate.pred_params))
    sched, cfg = optim.ScheduleConfig(**kw), StepConfig(**step_kw)

    jax_losses, losses = [], []
    for i in range(3):
        video, audio, masks = _batch(10 + i)
        enc, pred, idx, union = jax_stack_masksets(masks, True)
        jstate, jm = jstep(jstate, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(enc),
                           jnp.asarray(pred), tuple(jnp.asarray(x) for x in idx),
                           jnp.asarray(union))
        m = train_step(state, sched, cfg, torch.from_numpy(video), torch.from_numpy(audio),
                       torch.from_numpy(enc), torch.from_numpy(pred),
                       tuple(torch.from_numpy(x) for x in idx), torch.from_numpy(union))
        jax_losses.append(float(jm["loss"]))
        losses.append(m["loss"])
        if i == 0:
            assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
            # grad-avg counts leaves as the JAX package does: per block, and
            # the mask tokens of a stream as one [M, Dp] leaf
            for k in ("enc_grad_avg", "pred_grad_avg"):
                assert abs(m[k] - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
            for name, params, module in (
                ("encoder", jstate.enc_opt.mu, state.encoder),
                ("predictor", jstate.pred_opt.mu, state.predictor),
            ):
                to_sd = (torch_import.encoder_params_to_state_dict if name == "encoder"
                         else torch_import.predictor_params_to_state_dict)
                want = to_sd(jax.tree_util.tree_map(lambda x: np.asarray(x) / 0.1, params))
                got = {k: p.grad.numpy() for k, p in module.named_parameters()}
                assert sorted(got) == sorted(want)
                for k in got:
                    assert _rel_l2(got[k], want[k]) <= 1e-4, (name, k, _rel_l2(got[k], want[k]))
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3)


# ---------------------------------------------------------------------------
# the pretrain app
# ---------------------------------------------------------------------------


def _yaml(tmp_path, **over):
    with open(os.path.join(REPO, "configs/pretrain/av-vitt16.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], crop_size=32, num_frames=4, batch_size=2,
                     num_workers=2)
    d["model"]["pred_depth"] = 2
    d["optimization"].update(ipe=2, epochs=1)
    for m in d["mask"]:
        m["spatial_scale"] = [0.5, 0.5]  # blocks that do not round to 0 on a 2x2 grid
    d["logging"].update(folder=str(tmp_path), log_freq=1)
    for section, values in over.items():
        d[section].update(values)
    path = os.path.join(tmp_path, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path, d


def _jax_csv_header():
    """The column names the JAX app's CSVLogger gets (train/pretrain.py)."""
    src = open(os.path.join(REPO, "avjepa_tpu/train/pretrain.py")).read()
    block = src[src.index("csv_logger = CSVLogger("):src.index("ckpt = CheckpointManager(")]
    return ",".join(re.findall(r'\("%[^"]+", "([a-z-]+)"\)', block))


def test_pretrain_cli_on_cpu_checkpoint_resume_extract(tmp_path):
    path, d = _yaml(tmp_path)
    launch(path, device="cpu")
    tag = d["logging"]["write_tag"]
    csv = open(os.path.join(tmp_path, f"{tag}_r0.csv")).read().splitlines()
    assert csv[0] == _jax_csv_header() and len(csv) == 3
    ckpt = os.path.join(tmp_path, f"{tag}-latest.pth.tar")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert saved["step"] == 2 and saved["epoch"] == 1 and saved["world_size"] == 1
    assert {"encoder", "predictor", "target_encoder", "opt", "loss", "batch_size",
            "lr"} <= set(saved)
    for row in csv[1:]:
        assert np.isfinite(float(row.split(",")[2]))

    # resume: one more epoch continues the schedules from step 2
    path, _ = _yaml(tmp_path, optimization={"ipe": 2, "epochs": 2},
                    meta={"load_checkpoint": True})
    launch(path, device="cpu")
    csv = open(os.path.join(tmp_path, f"{tag}_r0.csv")).read().splitlines()
    assert [r.split(",")[:2] for r in csv[-2:]] == [["2", "0"], ["2", "1"]]
    resumed = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert resumed["step"] == 4 and resumed["opt"]["state"][0]["step"].item() == 4

    # the port's extract reads the checkpoint's target encoder
    xd = {"app": "extract", "meta": {"seed": 1, "dtype": "float32", "read_checkpoint": ckpt},
          "data": {**d["data"], "batch_size": 2},
          "model": {"model_name": "vit_tiny"}, "extract": {"limit": 3},
          "logging": {"folder": str(tmp_path / "x")}}
    enc = build_encoder(load_config(xd), torch.device("cpu"))
    for k, v in enc.state_dict().items():
        assert torch.equal(v, resumed["target_encoder"][k]), k
    out = app_main("extract", xd, device="cpu")
    assert out["rows_written"] == 3


def test_sigterm_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM during step 2 of 4: the run finishes that step, saves the
    checkpoint at step 2 and reports the preemption."""
    import signal

    from avjepa_tpu_torch.train import pretrain

    calls = []

    def step_then_signal(*args, **kwargs):
        out = train_step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(pretrain, "train_step", step_then_signal)
    _, d = _yaml(tmp_path, optimization={"ipe": 4, "epochs": 1})
    summary = pretrain.run(load_config(d), device="cpu")
    saved = torch.load(os.path.join(tmp_path, f"{d['logging']['write_tag']}-latest.pth.tar"),
                       map_location="cpu", weights_only=True)
    assert summary["preempted"] and len(calls) == 2 and saved["step"] == 2


def test_sigterm_then_resume_preempt_through_the_cli(tmp_path, monkeypatch):
    """SIGTERM during step 2 of 4 (2 epochs of 2), then the same YAML
    (meta.load_checkpoint: false) relaunched through the CLI entry with
    AVJEPA_RESUME_PREEMPT=1: the run logs ``resumed from step 2`` and runs
    the second epoch's 2 steps only, continuing the optimizer from step 2."""
    import logging
    import signal

    from avjepa_tpu_torch.train import pretrain

    calls = []

    def step_then_signal(*args, **kwargs):
        out = train_step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    path, d = _yaml(tmp_path, optimization={"ipe": 2, "epochs": 2},
                    meta={"load_checkpoint": False})
    monkeypatch.setattr(pretrain, "train_step", step_then_signal)
    assert launch(path, device="cpu")["preempted"] and len(calls) == 2
    monkeypatch.setattr(pretrain, "train_step", train_step)

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("avjepa_tpu_torch")
    logger.addHandler(handler)
    monkeypatch.setenv("AVJEPA_RESUME_PREEMPT", "1")
    try:
        summary = launch(path, device="cpu")
    finally:
        logger.removeHandler(handler)
    assert any(m.startswith("resumed from step 2 ") for m in records), records
    tag = d["logging"]["write_tag"]
    csv = open(os.path.join(tmp_path, f"{tag}_r0.csv")).read().splitlines()
    assert [r.split(",")[:2] for r in csv[1:] if not r.startswith("epoch")] == [
        ["1", "0"], ["1", "1"], ["2", "0"], ["2", "1"]]
    saved = torch.load(os.path.join(tmp_path, f"{tag}-latest.pth.tar"),
                       map_location="cpu", weights_only=True)
    assert summary["step"] == 4 and saved["step"] == 4
    assert saved["opt"]["state"][0]["step"].item() == 4


def test_vjepa_video_only_pretrain_on_cpu(tmp_path):
    """The video-only app: no audio tokens, the video-only collator."""
    path, d = _yaml(tmp_path, data={"dataset_type": "videodataset"})
    d["app"] = "vjepa"
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    out = launch(path, device="cpu")
    assert out["step"] == 2 and np.isfinite(out["avg_loss"])
    saved = torch.load(out["checkpoint"], map_location="cpu", weights_only=True)
    assert not any("audio" in k or k.endswith("_a.weight") for k in saved["encoder"])
    assert "predictor_embed_a.weight" not in saved["predictor"]


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, d = _yaml(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch(path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        app_main("avjepa", d)
    assert not os.path.exists(os.path.join(tmp_path, f"{d['logging']['write_tag']}_r0.csv"))


# ---------------------------------------------------------------------------
# the port's copies of jax-free host modules
# ---------------------------------------------------------------------------


def test_host_module_copies_match_originals():
    lo = TokenLayout(num_frames=4, crop_size=32)
    jlo = JaxTokenLayout(num_frames=4, crop_size=32)
    assert dataclasses.asdict(lo) == dataclasses.asdict(jlo)
    assert (lo.num_tokens, lo.video_grid, lo.audio_grid) == (jlo.num_tokens, jlo.video_grid,
                                                             jlo.audio_grid)
    for a, b in zip(SyntheticAVDataset(lo)[3], JaxSynthetic(jlo)[3]):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 255, size=(4, 40, 56, 3)).astype(np.float32)
    got = transforms.VideoTransform(crop_size=32, reprob=0.5)(clip.copy(),
                                                              np.random.default_rng(1))
    want = jax_transforms.VideoTransform(crop_size=32, reprob=0.5)(clip.copy(),
                                                                  np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.EvalVideoTransform(2, 32, 32)(clip)[1],
                                  jax_transforms.EvalVideoTransform(2, 32, 32)(clip)[1])
    pcm = np.sin(np.arange(16000) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(mel.mel_spectrogram(pcm, 16000),
                                  jax_mel.mel_spectrogram(pcm, 16000))
    for args in ((300, 16, 4, 1), (40, 16, 4, 2)):
        for a, b in zip(sample_clip_indices(*args, np.random.default_rng(2)),
                        jax_sample_clip_indices(*args, np.random.default_rng(2))):
            np.testing.assert_array_equal(a, b)
    # the weight bridge both ways: the port's modules -> flax trees
    for module, name in ((Encoder(LAYOUT, **ENC), "encoder"), (Predictor(LAYOUT, **PRED),
                                                               "predictor")):
        sd = {"module." + k: v.detach().numpy() for k, v in module.state_dict().items()}
        got = getattr(torch_import, f"{name}_params_from_state_dict")(sd)
        want = getattr(jax_torch_import, f"{name}_params_from_state_dict")(sd)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        assert all(np.array_equal(a, b, equal_nan=True)  # uninitialised weights
                   for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))
    # AutoAugment (randaugment.py, pinned with the image eval's in
    # tests/test_torch_evals.py) inside the train transform
    got = transforms.VideoTransform(crop_size=32, auto_augment=True)(clip.copy(),
                                                                     np.random.default_rng(3))
    want = jax_transforms.VideoTransform(crop_size=32, auto_augment=True)(
        clip.copy(), np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    for ours, theirs in ((randaugment, jax_randaugment), (monitoring, jax_monitoring),
                         (video_transforms, jax_video_transforms)):
        src = []
        for module in (ours, theirs):
            with open(module.__file__) as f:
                code = f.read().split('"""', 2)[2]  # the code after the docstring
            src.append(code.replace("avjepa_tpu_torch.", "avjepa_tpu."))
        assert src[0] == src[1], ours.__name__
