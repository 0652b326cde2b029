"""The port's avprediction slice held against the JAX package: the eight
reconstruction probes, the diffusion-fallback predictor, the train step's
weight-decay rule and grad-avg (with the diffusion predictor's sequential
mask configs), the probe step with its frozen tokens, and the avprediction,
avprediction_example and av_prediction apps on the CPU.

Small sizes (vit_tiny-like widths, crop 32, 4 frames, 2 predictor layers),
f32, inputs made with numpy from a seed, weights carried from flax through
the reference state-dict layout. The JAX side uses ``attn_impl: xla`` to
stay fast; the Pallas-against-plain equivalence of the attention is held by
tests/test_torch_attention*.py.
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
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.masks.multiblock3d import make_mask_collator as jax_make_mask_collator
from avjepa_tpu.models import prediction_probes as jax_probes
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.train import avprediction as jax_avprediction
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.train.step import stack_masksets as jax_stack_masksets
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.evals import av_prediction
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import prediction_probes as probes
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.registry import app_main
from avjepa_tpu_torch.train import avprediction, optim, pretrain
from avjepa_tpu_torch.train.state import init_state
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils import torch_import
from avjepa_tpu_torch.utils.checkpoint import (
    encoder_from_jax_params,
    predictor_from_jax_params,
    save_train_state,
)
from avjepa_tpu_torch.utils.logging import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# crop 32, 4 frames, with audio: 8 video + 96 audio = 104 tokens
LAYOUT = TokenLayout(num_frames=4, crop_size=32)
JAX_LAYOUT = JaxTokenLayout(num_frames=4, crop_size=32)
ENC = dict(embed_dim=192, depth=2, num_heads=3, uniform_power=True, attn_impl="xla",
           gelu="tanh")
PRED = dict(embed_dim=192, predictor_embed_dim=48, depth=2, num_heads=3, uniform_power=True,
            num_mask_tokens=2, attn_impl="xla", gelu="tanh")
MASKS = [
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 1, "spatial_scale": [0.5, 0.5],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
    {"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.5, 0.5],
     "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0},
]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _batch(seed, b=2, masks=MASKS):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(b, 4, 32, 32, 3)).astype(np.float32)
    audio = rng.normal(-40.0, 20.0, size=(b, 128, 192, 1)).astype(np.float32)
    return video, audio, jax_make_mask_collator("multiblock3d", masks, JAX_LAYOUT,
                                                base_seed=seed)(b)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

VIDEO_ONLY = dataclasses.replace(LAYOUT, audio_enabled=False)
# (probe key, port layout, kwargs, emb_dim); the flatten probes run on the
# video-only layout (8 tokens) to stay small
PROBE_CASES = [
    ("attention", LAYOUT, {}, 16),
    ("attention", VIDEO_ONLY, {}, 16),
    ("linear", VIDEO_ONLY, {"seq_len": 8}, 16),
    ("pooling", LAYOUT, {}, 16),
    ("factorized", LAYOUT, {"seq_len": 104}, 16),
    ("conv_temporal", LAYOUT, {}, 16),
    ("convolutional", VIDEO_ONLY, {"seq_len": 8, "plane": 8}, 16),
    ("progressive", VIDEO_ONLY, {"seq_len": 8}, 16),
    ("attentive", LAYOUT, {"depth": 2, "num_heads": 4}, 24),
]


@pytest.mark.parametrize("name,layout,kw,emb", PROBE_CASES,
                         ids=[f"{c[0]}-{'av' if c[1].audio_enabled else 'v'}" for c in PROBE_CASES])
def test_probe_matches_flax(name, layout, kw, emb):
    """Each probe against its flax twin with weights from
    probe_params_to_state_dict (strict load): outputs to 1e-5 (f32)."""
    jlayout = JaxTokenLayout(num_frames=4, crop_size=32, audio_enabled=layout.audio_enabled)
    n = layout.num_tokens
    x = np.random.default_rng(7).normal(size=(2, n, emb)).astype(np.float32)
    jkw = {k: v for k, v in kw.items() if k != "seq_len" or name != "factorized"}
    if name in ("linear", "factorized", "convolutional", "progressive"):
        jkw["seq_len"] = kw["seq_len"]
    if name in ("attention", "linear", "pooling", "attentive"):
        jkw["emb_dim"] = emb
    jprobe = jax_probes.PROBES[name](layout=jlayout, **jkw)
    params = jax.jit(jprobe.init)(jax.random.key(3), jnp.asarray(x))["params"]
    want = jax.jit(jprobe.apply)({"params": params}, jnp.asarray(x))

    port = probes.PROBES[name](layout, **{**kw, "emb_dim": emb})
    port.load_state_dict({k: _t(v) for k, v in torch_import.probe_params_to_state_dict(
        params).items()}, strict=True)
    with torch.no_grad():
        got = port(_t(x))
    got, want = (got, want) if name == "attention" else ((got,), (want,))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape, (tuple(g.shape), w.shape)
        assert _rel_max(g.numpy(), w) <= 1e-5


# ---------------------------------------------------------------------------
# the diffusion-fallback predictor and the train step
# ---------------------------------------------------------------------------


def _jax_draws(key, b, dp):
    """JAX Predictor's own draws from noise_rng ``key`` (predictor.py:98-110,
    129, 153), as the port's ``draws`` dict."""
    draws = {}
    for name, r, n in zip(("v", "a"), jax.random.split(key), (LAYOUT.num_video_tokens,
                                                             LAYOUT.num_audio_tokens)):
        rt, rn = jax.random.split(r)
        draws[f"t_{name}"] = _t(jax.random.randint(rt, (b,), 0, 1000))
        draws[f"noise_{name}"] = _t(jax.random.normal(rn, (b, n, dp), jnp.float32))
    return draws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diffusion_predictor_matches_jax(dtype):
    """use_mask_tokens=False: target positions seeded from the noised target
    embeddings, with JAX's draws handed to the port, dense and compacted, at
    the target positions. f32: 1e-5 of the largest value. bf16: 2e-2 relative
    L2. Both sides round every matmul input and LayerNorm output to bf16 at
    the same points and keep the residual stream in f32 (the noised targets
    are f32, as flax promotes them), but their f32 sums run in other orders,
    which moves single roundings by a bf16 ulp (2^-8 relative) through two
    blocks, the final norm and the projection: a few ulp, 2e-2 in all, the
    bound the repo holds other bf16 paths to (chip_smoke.POOLED_REL_TOL);
    measured 1.1e-3."""
    _, _, masks = _batch(2)
    enc, pred, _, union = jax_stack_masksets(masks, True)
    rng = np.random.default_rng(5)
    ctx = rng.normal(size=(2, LAYOUT.num_tokens, 192)).astype(np.float32)
    target = rng.normal(size=ctx.shape).astype(np.float32)
    jpred = JaxPredictor(layout=JAX_LAYOUT, use_mask_tokens=False, dtype=getattr(jnp, dtype),
                         **PRED)
    params = jax_init_predictor_params(jpred, jax.random.key(6))
    port = predictor_from_jax_params(
        Predictor(LAYOUT, use_mask_tokens=False, dtype=getattr(torch, dtype), **PRED), params)
    key = jax.random.key(9)
    for gather in (None, union[1]):
        want = jax.jit(jpred.apply)({"params": params}, ctx, enc[1], pred[1], 1,
                                    target=target, noise_rng=key, gather_idx=gather)
        with torch.no_grad():
            got = port(_t(ctx), _t(enc[1]), _t(pred[1]), 1,
                       gather_idx=None if gather is None else _t(gather),
                       target=_t(target), draws=_jax_draws(key, 2, 48))
        assert str(got.dtype) == f"torch.{dtype}" and want.dtype == getattr(jnp, dtype)
        m = pred[1]
        got, want = got.float().numpy()[m], np.asarray(want, np.float32)[m]
        if dtype == "float32":
            assert _rel_max(got, want) <= 1e-5
        else:
            assert _rel_l2(got, want) <= 2e-2
    draws = port.diffusion_draws(2, torch.Generator().manual_seed(0))
    assert draws["t_v"].shape == (2,) and draws["noise_a"].shape == (2, 96, 48)


def test_block_ln_decay_and_grad_avg_follow_jax():
    """R3: the JAX package decays the block LayerNorm weights (2-D stacked
    leaves) and counts them in grad-avg, one entry per block. Three steps at
    lr 1e-2 and weight decay 0.4, whose decay moves those weights by ~1%, on
    the same weights, batches and masks; the diffusion predictor, so the
    configs run one predictor call each (JAX step.py:200-209), with JAX's
    draws of each step (fold_in(key(0), step)) handed to the port. Block LN
    weights after 3 steps within 1e-5 relative (measured: 3e-7); grad-avg
    (encoder and predictor) within 1e-5 relative on the first step (5e-7),
    and within the gradients' own 1e-4 after it (an lr-1e-2 step leaves
    the whole gradient 1.5e-5 apart in f32, grad-avg with it)."""
    kw = dict(ipe=10, num_epochs=4, warmup_epochs=0, start_lr=1e-2, ref_lr=1e-2,
              final_lr=1e-2, ref_wd=0.4, final_wd=0.4)
    step_kw = dict(loss_exp=1.0, reg_coeff=0.5, clip_grad=10.0, warmup_epochs=1, ipe=10)
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    jpred = JaxPredictor(layout=JAX_LAYOUT, use_mask_tokens=False, **PRED)
    jstate = jax_init_state(jax_init_encoder_params(jenc, jax.random.key(7)),
                            jax_init_predictor_params(jpred, jax.random.key(8)))
    jstep = jax.jit(make_train_step(jenc, jpred, jax_optim.ScheduleConfig(**kw),
                                    JaxStepConfig(**step_kw)))
    state = init_state(encoder_from_jax_params(Encoder(LAYOUT, **ENC), jstate.enc_params),
                       predictor_from_jax_params(Predictor(LAYOUT, use_mask_tokens=False,
                                                           **PRED), jstate.pred_params))
    init = {k: v.clone() for k, v in state.encoder.state_dict().items() if "norm" in k}
    sched, cfg = optim.ScheduleConfig(**kw), StepConfig(**step_kw)
    for i in range(3):
        video, audio, masks = _batch(20 + i)
        enc, pred, idx, union = jax_stack_masksets(masks, True)
        jstate, jm = jstep(jstate, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(enc),
                           jnp.asarray(pred), tuple(jnp.asarray(x) for x in idx),
                           jnp.asarray(union))
        key = jax.random.fold_in(jax.random.key(0), i)
        m = train_step(state, sched, cfg, _t(video), _t(audio), _t(enc), _t(pred),
                       tuple(_t(x) for x in idx), _t(union), draws=_jax_draws(key, 2, 48))
        assert abs(m["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        for k in ("enc_grad_avg", "pred_grad_avg"):
            tol = 1e-5 if i == 0 else 1e-4
            assert abs(m[k] - float(jm[k])) <= tol * abs(float(jm[k])), (i, k, m[k], jm[k])
    for prefix, sd, params in (("blocks", state.encoder.state_dict(), jstate.enc_params),
                               ("predictor_blocks", state.predictor.state_dict(),
                                jstate.pred_params)):
        layers = params["blocks"]["layers"]
        for i in range(2):
            for norm in ("norm1", "norm2"):
                got = sd[f"{prefix}.{i}.{norm}.weight"].numpy()
                assert _rel_l2(got, layers[norm]["scale"][i]) <= 1e-5, (prefix, i, norm)
    moved = _rel_l2(state.encoder.state_dict()["blocks.0.norm1.weight"],
                    init["blocks.0.norm1.weight"])
    assert moved > 1e-3  # decay and the updates move the weights far past the tolerance


# ---------------------------------------------------------------------------
# the probe step
# ---------------------------------------------------------------------------


def test_probe_step_matches_jax():
    """Three probe steps against make_probe_step on the same frozen weights,
    probe weights, batches and masks: the frozen tokens (dense key-masked
    encoder + predictor with mask config 0) within 1e-5, the losses within
    1e-4 relative, the probe params after 3 steps within 1e-4 relative L2
    (all of them together; each tensor within 1e-3, see below)."""
    kw = dict(ipe=10, num_epochs=4, warmup_epochs=1)
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    jpred = JaxPredictor(layout=JAX_LAYOUT, zero_init_mask_tokens=False, **PRED)
    enc_params = jax_init_encoder_params(jenc, jax.random.key(1))
    pred_params = jax_init_predictor_params(jpred, jax.random.key(2))
    jprobe = jax_probes.AttentionProbe(layout=JAX_LAYOUT, emb_dim=192)
    probe_params = jax.jit(jprobe.init)(
        jax.random.key(4), jnp.zeros((1, LAYOUT.num_tokens, 192)))["params"]
    jstate = jax_avprediction.ProbeState(step=jnp.zeros((), jnp.int32),
                                         probe_params=probe_params,
                                         opt=jax_optim.adamw_init(probe_params))
    jstep = jax.jit(jax_avprediction.make_probe_step(jenc, jpred, jprobe,
                                                     jax_optim.ScheduleConfig(**kw)))

    encoder = encoder_from_jax_params(Encoder(LAYOUT, **ENC), enc_params)
    predictor = predictor_from_jax_params(Predictor(LAYOUT, **PRED), pred_params)
    probe = probes.AttentionProbe(LAYOUT, emb_dim=192)
    probe.load_state_dict({k: _t(v) for k, v in torch_import.probe_params_to_state_dict(
        probe_params).items()}, strict=True)
    state = avprediction.ProbeState(probe, optim.make_optimizer([probe]))
    sched = optim.ScheduleConfig(**kw)

    for i in range(3):
        video, audio, masks = _batch(30 + i)
        enc, pred = jax_stack_masksets(masks)
        if i == 0:
            ctx = jenc.apply({"params": enc_params}, video, audio, key_mask=enc[0])
            z = jpred.apply({"params": pred_params}, ctx, enc[0], pred[0], 0)
            want = jnp.where(enc[0][..., None], ctx, jnp.where(pred[0][..., None], z, 0.0))
            got = avprediction.frozen_tokens(encoder, predictor, _t(video), _t(audio),
                                             _t(enc[0]), _t(pred[0]), 0)
            assert _rel_max(got.numpy(), want) <= 1e-5
        jstate, jm = jstep(jstate, enc_params, pred_params, jnp.asarray(video),
                           jnp.asarray(audio), jnp.asarray(enc), jnp.asarray(pred))
        m = avprediction.probe_step(state, sched, encoder, predictor, _t(video), _t(audio),
                                    _t(enc), _t(pred))
        for k in ("loss", "loss_video", "loss_audio"):
            assert abs(m[k] - float(jm[k])) <= 1e-4 * abs(float(jm[k])), (i, k)
    want = torch_import.probe_params_to_state_dict(jax.device_get(jstate.probe_params))
    got = {k: v.numpy() for k, v in state.probe.state_dict().items()}
    assert sorted(got) == sorted(want) and state.step == 3
    names = sorted(got)
    assert _rel_l2(np.concatenate([got[k].ravel() for k in names]),
                   np.concatenate([want[k].ravel() for k in names])) <= 1e-4
    # per tensor, 1e-3: an element whose gradient is near 0 takes an AdamW
    # update of its rounding noise, and the biases start at 0, so a bias
    # holds only such updates (measured: v_attn_out.bias 2.9e-4, the rest
    # <= 8e-6). The key third of an in-projection bias has a zero gradient
    # in exact arithmetic (the softmax is shift-invariant along keys): it
    # is left out.
    for k in names:
        if k.endswith("attn_in.bias"):
            keep = np.r_[0:256, 512:768]
            got[k], want[k] = got[k][keep], want[k][keep]
        assert _rel_l2(got[k], want[k]) <= 1e-3, k


# ---------------------------------------------------------------------------
# the apps on the CPU
# ---------------------------------------------------------------------------


def _cfg(tmp_path, **over) -> dict:
    with open(os.path.join(REPO, "configs/pretrain/av-vitt16_prediction.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], crop_size=32, num_frames=4, batch_size=2,
                     num_workers=2)
    d["meta"].update(dtype="float32", read_checkpoint=None)
    d["model"]["pred_depth"] = 2
    d["optimization"].update(ipe=2, epochs=1)
    for m in d["mask"]:
        m["spatial_scale"] = [0.5, 0.5]
    d["logging"].update(folder=str(tmp_path), log_freq=1)
    for section, values in over.items():
        d[section].update(values)
    return d


def _jax_probe_csv_header():
    """The column names the JAX app's probe CSVLogger gets."""
    src = open(os.path.join(REPO, "avjepa_tpu/train/avprediction.py")).read()
    block = src[src.index("csv_logger = CSVLogger("):src.index("ckpt = CheckpointManager(")]
    return ",".join(re.findall(r'\("%[^"]+", "([a-z-]+)"\)', block))


def test_avprediction_apps_on_cpu(tmp_path):
    """avprediction for 2 steps on a pretrain-style .pth.tar, resume, the
    example app, and the av_prediction eval through its CLI entry and run():
    the CSV columns, the probe checkpoint, the JAX eval's summary keys and
    strictness, determinism; the same JEPA checkpoint as a JAX pretrain
    Orbax directory gives the same frozen models, and a directory without a
    committed step raises."""
    from avjepa_tpu_torch.app.eval_main import launch as eval_launch

    # a JEPA checkpoint as the pretrain app writes it, from another seed
    ckpt = str(tmp_path / "jepa-latest.pth.tar")
    h = pretrain.setup(load_config(_cfg(tmp_path, meta={"seed": 5})), torch.device("cpu"))
    h.loader.close()
    save_train_state(ckpt, h.state, epoch=1, loss=0.0, batch_size=2, lr=0.0)
    d = _cfg(tmp_path / "probe", meta={"read_checkpoint": ckpt})

    summary = app_main("avprediction", d, device="cpu")
    assert summary["epoch"] == 1 and np.isfinite(summary["avg_loss"])
    tag = d["logging"]["write_tag"]
    rows = open(tmp_path / "probe" / f"{tag}_probe_r0.csv").read().splitlines()
    assert rows[0] == _jax_probe_csv_header() == "epoch,itr,loss,loss-video,loss-audio"
    assert len(rows) == 3 and all(np.isfinite(float(r.split(",")[2])) for r in rows[1:])
    probe_file = tmp_path / "probe" / f"{tag}-probe-latest.pth.tar"
    assert torch.load(probe_file, weights_only=True)["step"] == 2

    # the frozen models are the checkpoint's target encoder and predictor
    cfg = load_config(d)
    h2, _, _ = avprediction.setup_probe(cfg, torch.device("cpu"))
    h2.loader.close()
    assert avprediction.restore_jepa_weights(h2, cfg, get_logger())
    saved = torch.load(ckpt, weights_only=True)
    key = "blocks.11.attn.qkv.weight"
    assert torch.equal(h2.state.target_encoder.state_dict()[key], saved["target_encoder"][key])
    assert not torch.equal(h2.state.encoder.state_dict()[key], saved["encoder"][key])

    # resume: a second epoch restores the probe at step 2 and runs steps 3-4
    d2 = _cfg(tmp_path / "probe", meta={"read_checkpoint": ckpt},
              optimization={"ipe": 2, "epochs": 2})
    assert app_main("avprediction", d2, resume_preempt=True, device="cpu")["epoch"] == 2
    assert torch.load(probe_file, weights_only=True)["step"] == 4
    rows = open(tmp_path / "probe" / f"{tag}_probe_r0.csv").read().splitlines()
    assert [r.split(",")[:2] for r in rows[-2:]] == [["2", "0"], ["2", "1"]]

    out = app_main("avprediction_example", d, device="cpu")
    z = np.load(out)
    assert sorted(z.files) == ["audio", "audio_recon", "video", "video_recon"]
    assert z["video_recon"].shape == (4, 32, 32, 3) and z["audio_recon"].shape == (128, 192, 1)

    # the eval: strict about the probe and the JEPA weights, deterministic
    path = tmp_path / "eval.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({**_cfg(tmp_path / "none", meta={"read_checkpoint": ckpt}),
                        "eval_name": "av_prediction"}, f)
    with pytest.raises(FileNotFoundError, match="probe"):
        eval_launch(str(path), device="cpu")
    with pytest.raises(FileNotFoundError, match="RANDOMLY"):
        av_prediction.run(load_config(_cfg(tmp_path / "probe")), max_batches=1, device="cpu")
    ecfg = load_config(d)
    first = av_prediction.run(ecfg, max_batches=2, device="cpu")
    assert set(first) == {"mse_video", "psnr_video_db", "mse_video_per_mask", "num_batches",
                          "mse_audio", "psnr_audio_db", "mse_audio_per_mask"}
    assert first["num_batches"] == 2 and len(first["mse_audio_per_mask"]) == len(ecfg.mask)
    assert all(np.isfinite(v) for v in first["mse_video_per_mask"] + first["mse_audio_per_mask"])
    assert av_prediction.run(ecfg, max_batches=2, device="cpu") == first

    # the JEPA checkpoint as the JAX pretrain app's Orbax directory, written
    # by the JAX manager: the same frozen models; no committed step raises
    from avjepa_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from avjepa_tpu_torch.utils.checkpoint import jax_tree

    orbax_dir = str(tmp_path / "jepa-ckpt")
    JaxManager(orbax_dir).save(0, jax_tree(saved))
    h3, _, _ = avprediction.setup_probe(cfg, torch.device("cpu"))
    h3.loader.close()
    assert avprediction.restore_jepa_weights(h3, load_config(_cfg(tmp_path, meta={
        "read_checkpoint": orbax_dir})), get_logger())
    for module in ("target_encoder", "predictor"):
        got = getattr(h3.state, module).state_dict()
        want = getattr(h2.state, module).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), module
    with pytest.raises(FileNotFoundError, match="committed"):
        avprediction.restore_jepa_weights(h2, load_config(_cfg(tmp_path, meta={
            "read_checkpoint": str(tmp_path)})), get_logger())
