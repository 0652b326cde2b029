"""The port's frozen classification evals held against the JAX package.

The attentive classifier (both pooler kinds, depth 1 and 2, with and without
a key mask, f32 and bf16), one probe step (loss, clipped gradients, AdamW
with the classifier's decay rule, lr from the schedule), the image-mode
encoder, the across-segments aggregation with its 1-D pos-embed, and the
synthetic video eval as a whole (encode, aggregate, two probe steps and a
validation batch, across segments and with frame aggregation) on the same
weights (flax params bridged through the reference state-dict layout) and
the same numpy inputs; then the target-encoder merge, the exact-validation
loader, the AutoAugment copies, and both evals end to end through the eval
CLI on the CPU. Small sizes (2-layer or vit_tiny encoders, crop 32, 4
frames); f32 unless stated.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.data import loader as jax_loader
from avjepa_tpu.data import randaugment as jax_randaugment
from avjepa_tpu.evals import video_classification as jax_vc
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.models import pos_embed as jax_pe
from avjepa_tpu.models.attentive_pooler import AttentiveClassifier as JaxClassifier
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu_torch.app.eval_main import launch
from avjepa_tpu_torch.data import loader, randaugment
from avjepa_tpu_torch.evals import video_classification as vc
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models.attentive_pooler import AttentiveClassifier
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.train import optim
from avjepa_tpu_torch.utils.checkpoint import (
    classifier_from_jax_params,
    encoder_from_jax_params,
    merge_target_encoder,
)
from avjepa_tpu_torch.utils.torch_import import classifier_params_to_state_dict

D, HEADS, CLASSES = 64, 4, 10
ENC = dict(embed_dim=192, depth=2, num_heads=3, uniform_power=True, gelu="tanh")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _classifiers(depth, complete_block, dtype="float32", seed=0):
    """A flax classifier, its params, and the port's twin loaded from them."""
    jcls = JaxClassifier(embed_dim=D, num_heads=HEADS, depth=depth, num_classes=CLASSES,
                         complete_block=complete_block, dtype=getattr(jnp, dtype))
    params = jax.jit(jcls.init)(jax.random.key(seed), jnp.zeros((1, 24, D)))["params"]
    port = classifier_from_jax_params(
        AttentiveClassifier(D, HEADS, depth=depth, num_classes=CLASSES,
                            complete_block=complete_block, dtype=getattr(torch, dtype)), params)
    return jcls, params, port


# ---------------------------------------------------------------------------
# the classifier and the probe step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complete_block", [True, False])
@pytest.mark.parametrize("depth", [1, 2])
def test_attentive_classifier_matches_jax(depth, complete_block):
    """Logits with and without a key mask: f32 within 1e-5 max abs; bf16
    within 2e-2 relative L2 (both round every matmul input and LayerNorm
    output to bf16 at the same points, and sum in f32 in other orders)."""
    rng = np.random.default_rng(depth + 2 * complete_block)
    x = rng.normal(size=(3, 24, D)).astype(np.float32)
    mask = rng.random((3, 24)) < 0.6
    mask[:, 0] = True
    for dtype in ("float32", "bfloat16"):
        jcls, params, port = _classifiers(depth, complete_block, dtype)
        apply = jax.jit(jcls.apply)
        for key_mask in (None, mask):
            want = np.asarray(apply({"params": params}, x, key_mask=key_mask), np.float32)
            with torch.no_grad():
                got = port(_t(x), None if key_mask is None else _t(key_mask))
            assert got.dtype == getattr(torch, dtype) and got.shape == (3, CLASSES)
            if dtype == "float32":
                assert np.abs(got.numpy() - want).max() <= 1e-5
            else:
                assert _rel_l2(got.float().numpy(), want) <= 2e-2


def _jax_step(jcls, sched, wd):
    """JAX's probe step (evals/video_classification.py train_step)."""

    def loss_fn(params, feats, labels):
        logits = jcls.apply({"params": params}, feats)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1)), logits

    @jax.jit
    def step(params, opt, step_, feats, labels):
        lr = jax_optim.lr_at_step(sched, step_)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, feats, labels)
        grads, gnorm = jax_optim.clip_by_global_norm(grads, 1.0)
        params, opt = jax_optim.adamw_update(grads, opt, params, lr, jnp.asarray(wd),
                                             jax_optim.wd_mask(params))
        return params, opt, loss, gnorm, grads

    @jax.jit
    def predict(params, feats):
        return jax.nn.softmax(jcls.apply({"params": params}, feats).astype(jnp.float32), -1)

    return step, predict


SCHED = dict(ipe=4, num_epochs=2, ipe_scale=1.0, warmup_epochs=0.5, start_lr=2e-5,
             ref_lr=1e-4, final_lr=1e-6)


def test_probe_step_matches_jax():
    """Two probe steps at depth 2 (lr 1e-4 after a warmup step at 2e-5,
    weight decay 0.5, the head's weights scaled by 3 so that the gradients'
    norm is above 1 and the clip acts): loss within 1e-5, the clipped
    gradients within 1e-5 of their largest, every parameter within 1e-6
    after each step. The pooler block's 1-D LayerNorm scales are not decayed
    (JAX wd_mask), which the train step's rule for depth-stacked blocks
    would do, moving them by lr * wd = 5e-5; the 3-D query tokens are.
    (AdamW's first steps move every weight by about lr whatever its
    gradient's size, so a gradient that sums to about eps = 1e-8 moves its
    weight by a part of lr that rounding decides: at lr 1e-3 that is 2e-6.)"""
    wd = 0.5
    jcls, params, port = _classifiers(2, True, seed=3)
    params = {**params, "linear": {**params["linear"],
                                   "kernel": 3.0 * params["linear"]["kernel"]}}
    classifier_from_jax_params(port, params)
    state = vc.ClassifierState(port, optim.make_optimizer([port], rule=optim.plain_decays))
    decayed = {n for n, p in port.named_parameters() if optim.plain_decays(n, p)}
    assert "pooler.query_tokens" in decayed
    assert not any("norm" in n or "bias" in n for n in decayed)
    assert optim.decays("pooler.blocks.0.norm1.weight", port.pooler.blocks[0].norm1.weight)
    jstep, _ = _jax_step(jcls, jax_optim.ScheduleConfig(**SCHED, ref_wd=wd, final_wd=wd), wd)
    sched = optim.ScheduleConfig(**SCHED, ref_wd=wd, final_wd=wd)
    opt = jax_optim.adamw_init(params)
    rng = np.random.default_rng(11)
    for i in range(2):
        feats = (3.0 * rng.normal(size=(4, 24, D))).astype(np.float32)
        labels = rng.integers(0, CLASSES, 4)
        params, opt, loss, gnorm, grads = jstep(params, opt, jnp.asarray(i, jnp.int32), feats,
                                                labels)
        m = vc.probe_step(state, sched, wd, _t(feats), _t(labels))
        assert float(gnorm) > 1.0
        assert abs(m["loss"] - float(loss)) <= 1e-5
        want_g = classifier_params_to_state_dict(jax.device_get(grads))
        got_g = {n: p.grad.numpy() for n, p in port.named_parameters()}
        scale = max(np.abs(g).max() for g in want_g.values())
        assert max(np.abs(got_g[k] - want_g[k]).max() for k in got_g) <= 1e-5 * scale
        want = classifier_params_to_state_dict(jax.device_get(params))
        got = port.state_dict()
        assert set(got) == set(want)
        for k in got:
            assert np.abs(got[k].numpy() - want[k]).max() <= 1e-6, k


# ---------------------------------------------------------------------------
# image mode and aggregation
# ---------------------------------------------------------------------------


def test_image_mode_encoder_matches_jax():
    """num_frames=1: the 2-D patch embed ([D, C, kh, kw] under
    patch_embed.proj.weight) and the 2-D sincos table, 1e-5 max abs."""
    jenc = JaxEncoder(layout=JaxTokenLayout(num_frames=1, crop_size=32, audio_enabled=False),
                      **ENC)
    params = jax_init_encoder_params(jenc, jax.random.key(4))
    port = encoder_from_jax_params(
        Encoder(TokenLayout(num_frames=1, crop_size=32, audio_enabled=False), **ENC), params)
    assert port.patch_embed.proj.weight.shape == (192, 3, 16, 16)
    img = np.random.default_rng(4).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jenc.apply)({"params": params}, img)
    with torch.no_grad():
        got = port(_t(img))
    assert got.shape == (3, 4, 192)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def _jax_aggregate(cfg, outs, clip_indices, n_spatial):
    """JAX run()'s aggregate closure (video_classification.py:441-460)."""
    if not cfg.attend_across_segments:
        return outs
    out = jnp.concatenate(outs, axis=1)
    if cfg.use_pos_embed and clip_indices is not None:
        d = out.shape[-1]
        pos = jnp.asarray(jax_pe.sincos_1d(d, 10000 // cfg.tubelet_size), out.dtype)
        idx = clip_indices[:, :, :: cfg.tubelet_size]
        chunks = []
        for s in range(idx.shape[0]):
            p = pos[idx[s]]
            p = jnp.repeat(p[:, :, None, :], n_spatial, axis=2).reshape(p.shape[0], -1, d)
            chunks.append(p)
        out = out + jnp.concatenate(chunks, axis=1)
    return [out]


def test_aggregate_with_pos_embed_matches_jax():
    """Across segments with the 1-D pos-embed at clip_indices[:, :, ::2]
    (3 segments of 2 x 4 tokens), within 1e-6; per segment, the segments as
    they are."""
    rng = np.random.default_rng(8)
    outs = [rng.normal(size=(2, 8, 16)).astype(np.float32) for _ in range(3)]
    clip_indices = np.stack([np.stack([np.arange(4) * 8 + 3 * s + b for b in range(2)])
                             for s in range(3)])
    for across in (True, False):
        cfg = vc.VideoEvalConfig(attend_across_segments=across, use_pos_embed=True)
        jcfg = jax_vc.VideoEvalConfig(attend_across_segments=across, use_pos_embed=True)
        got = vc.aggregate(cfg, [_t(o) for o in outs], clip_indices, 4)
        want = _jax_aggregate(jcfg, [jnp.asarray(o) for o in outs], clip_indices, 4)
        assert len(got) == len(want) == (1 if across else 3)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

EVAL_CFG = dict(num_classes=5, frames_per_clip=4, num_segments=2, num_views_per_segment=2,
                frame_step=2, resolution=32, batch_size=4, use_bfloat16=False,
                use_pos_embed=True, source="synthetic")


@pytest.mark.parametrize("frame_aggregation", [False, True])
def test_video_eval_slice_matches_jax(frame_aggregation):
    """The synthetic video eval, as run() composes it, on JAX-initialised
    encoder and classifier weights and SyntheticVideoClsDataset batches (the
    port's copy gives the same arrays as JAX's): encode, aggregate and two
    probe steps (losses within 1e-5), then one validation batch of 2
    segments x 2 views (softmax averaged over segments, summed over views)
    within 1e-5, across segments with the pos-embed, or with frame
    aggregation through an image-mode encoder."""
    kw = dict(EVAL_CFG, frame_aggregation=frame_aggregation,
              use_pos_embed=not frame_aggregation)
    cfg, jcfg = vc.VideoEvalConfig(**kw), jax_vc.VideoEvalConfig(**kw)
    frames = 1 if frame_aggregation else 4
    jlayout = JaxTokenLayout(num_frames=frames, crop_size=32, audio_enabled=False)
    jenc = JaxEncoder(layout=jlayout, **ENC)
    enc_params = jax_init_encoder_params(jenc, jax.random.key(0))
    encoder = encoder_from_jax_params(
        Encoder(TokenLayout(num_frames=frames, crop_size=32, audio_enabled=False), **ENC),
        enc_params)
    jcls = JaxClassifier(embed_dim=192, num_heads=3, depth=1, num_classes=5)
    cls_params = jax.jit(jcls.init)(jax.random.key(1), jnp.zeros((1, 16, 192)))["params"]
    port = classifier_from_jax_params(AttentiveClassifier(192, 3, num_classes=5), cls_params)
    state = vc.ClassifierState(port, optim.make_optimizer([port], rule=optim.plain_decays))
    sched_kw = dict(ipe=16, num_epochs=20, ipe_scale=1.0, warmup_epochs=0, start_lr=1e-3,
                    ref_lr=1e-3, final_lr=0.0, ref_wd=0.01, final_wd=0.01)
    jstep, jpredict = _jax_step(jcls, jax_optim.ScheduleConfig(**sched_kw), 0.01)
    sched = optim.ScheduleConfig(**sched_kw)
    opt = jax_optim.adamw_init(cls_params)
    n_spatial = jlayout.h_grid * jlayout.w_grid
    apply = jax.jit(jenc.apply)

    def jax_features(batched, seg_idx, v):
        outs = []
        for s in range(len(batched)):
            clips = jnp.asarray(batched[s][v])
            if frame_aggregation:
                b, t = clips.shape[:2]
                out = apply({"params": enc_params}, clips.reshape(b * t, *clips.shape[2:]))
                outs.append(out.reshape(b, t * out.shape[1], out.shape[2]))
            else:
                outs.append(apply({"params": enc_params}, clips))
        return _jax_aggregate(jcfg, outs, seg_idx, n_spatial)

    def port_features(batched, seg_idx, v):
        outs = [vc.encode(encoder, _t(batched[s][v]), frame_aggregation)
                for s in range(len(batched))]
        return vc.aggregate(cfg, outs, seg_idx, n_spatial)

    def batch(ds, jds, rows):
        samples = [ds[i] for i in rows]
        jsamples = [jds[i] for i in rows]
        for a, b in zip(jax.tree_util.tree_leaves(samples), jax.tree_util.tree_leaves(jsamples)):
            np.testing.assert_array_equal(a, b)
        return vc.collate(samples)

    train = (vc.SyntheticVideoClsDataset(cfg, True), jax_vc.SyntheticVideoClsDataset(jcfg, True))
    for i in range(2):
        batched, seg_idx, labels = batch(*train, range(4 * i, 4 * i + 4))
        cls_params, opt, loss, _, _ = jstep(cls_params, opt, jnp.asarray(i, jnp.int32),
                                         jax_features(batched, seg_idx, 0)[0], labels)
        m = vc.probe_step(state, sched, 0.01, port_features(batched, seg_idx, 0)[0],
                          _t(labels))
        assert abs(m["loss"] - float(loss)) <= 1e-5

    batched, seg_idx, labels = batch(vc.SyntheticVideoClsDataset(cfg, False, length=32),
                                     jax_vc.SyntheticVideoClsDataset(jcfg, False, length=32),
                                     range(4))
    want = got = 0.0
    for v in range(2):
        feats = jax_features(batched, seg_idx, v)
        want = want + sum(jpredict(cls_params, f) for f in feats) / len(feats)
        feats = port_features(batched, seg_idx, v)
        got = got + sum(vc.predict(port, f) for f in feats) / len(feats)
    assert got.shape == (4, 5)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


# ---------------------------------------------------------------------------
# checkpoints, loader, augmentation
# ---------------------------------------------------------------------------

AV = TokenLayout(num_frames=4, crop_size=32)
VIDEO = TokenLayout(num_frames=4, crop_size=32, audio_enabled=False)


def _av_checkpoint(tmp_path):
    """A pretrain-style .pth.tar whose target_encoder is a 2-layer AV encoder."""
    sd = {k: v.normal_() for k, v in Encoder(AV, **ENC).state_dict().items()}
    path = os.path.join(tmp_path, "jepa-latest.pth.tar")
    torch.save({"encoder": sd, "target_encoder": sd, "epoch": 1}, path)
    return path, sd


def test_target_encoder_merge(tmp_path):
    """An AV checkpoint into a video-only encoder: every leaf taken, the two
    audio patch-embed leaves dropped. A deeper encoder: strict raises, and
    allow_missing keeps its init for the missing block. A missing file
    raises or (allow_missing) returns None; so does a directory without a
    committed step. The same checkpoint as a JAX pretrain Orbax directory
    (the JAX manager's JepaState fields) merges to the same encoder."""
    path, sd = _av_checkpoint(tmp_path)
    enc = Encoder(VIDEO, **ENC)
    out = merge_target_encoder(path, enc)
    assert (len(out["missing"]), len(out["mismatched"])) == (0, 0)
    assert out["dropped"] == ["patch_embed.audio_proj.bias", "patch_embed.audio_proj.weight"]
    assert len(out["taken"]) == len(enc.state_dict())
    assert all(torch.equal(v, sd[k]) for k, v in enc.state_dict().items())

    deep = Encoder(VIDEO, **{**ENC, "depth": 3})
    init = {k: v.clone() for k, v in deep.state_dict().items()}
    with pytest.raises(ValueError, match="allow_missing_checkpoint"):
        merge_target_encoder(path, deep)
    out = merge_target_encoder(path, deep, strict=False)
    assert len(out["missing"]) == 12 and all(k.startswith("blocks.2.") for k in out["missing"])
    now = deep.state_dict()
    assert torch.equal(now["blocks.2.attn.qkv.weight"], init["blocks.2.attn.qkv.weight"])
    assert torch.equal(now["blocks.1.attn.qkv.weight"], sd["blocks.1.attn.qkv.weight"])

    image = Encoder(TokenLayout(num_frames=1, crop_size=32, audio_enabled=False), **ENC)
    out = merge_target_encoder(path, image, strict=False)
    assert out["mismatched"] == ["patch_embed.proj.weight"]

    gone = os.path.join(tmp_path, "nope.pth.tar")
    with pytest.raises(FileNotFoundError, match="allow_missing_checkpoint"):
        merge_target_encoder(gone, enc)
    assert merge_target_encoder(gone, enc, strict=False) is None
    with pytest.raises(FileNotFoundError, match="allow_missing_checkpoint"):
        merge_target_encoder(str(tmp_path), enc)
    assert merge_target_encoder(str(tmp_path), enc, strict=False) is None

    from avjepa_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from avjepa_tpu.utils.torch_import import encoder_params_from_state_dict

    params = encoder_params_from_state_dict({k: v.numpy() for k, v in sd.items()})
    ckpt = str(tmp_path / "jepa-ckpt")
    JaxManager(ckpt).save(2, {"enc_params": params, "target_params": params,
                              "step": np.asarray(2, np.int32)})
    enc = Encoder(VIDEO, **ENC)
    out = merge_target_encoder(ckpt, enc)
    assert (len(out["missing"]), len(out["mismatched"])) == (0, 0)
    assert out["dropped"] == ["patch_embed.audio_proj.bias", "patch_embed.audio_proj.weight"]
    assert all(torch.equal(v, sd[k]) for k, v in enc.state_dict().items())
    with pytest.raises(ValueError, match="allow_missing_checkpoint"):
        merge_target_encoder(ckpt, Encoder(VIDEO, **{**ENC, "depth": 3}))


@pytest.mark.parametrize("n,batch,shards,index,drop_last",
                         [(10, 4, 1, 0, False), (3, 8, 1, 0, False), (23, 4, 3, 2, False),
                          (23, 4, 3, 1, True)])
def test_batch_valid_masks_match_jax(n, batch, shards, index, drop_last):
    kw = dict(shuffle=True, seed=5, num_shards=shards, shard_index=index, drop_last=drop_last)
    got = list(loader.ShardedSampler(n, batch, **kw).batch_valid_masks())
    want = list(jax_loader.ShardedSampler(n, batch, **kw).batch_valid_masks())
    assert len(got) == len(want) == len(list(loader.ShardedSampler(n, batch, **kw)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Flaky:
    """Samples (an image, a label); index 2 always fails to decode, 5 fails
    twice and then decodes."""

    def __init__(self):
        self.tries = {}

    def __len__(self):
        return 7

    def __getitem__(self, idx):
        self.tries[idx] = self.tries.get(idx, 0) + 1
        if idx == 2 or (idx == 5 and self.tries[idx] <= 2):
            raise OSError(f"cannot decode {idx}")
        return np.full((2, 2), idx, np.float32), idx


def test_exact_val_loader_matches_jax():
    """retry_resample=False: a failed sample is retried on its own index,
    then replaced by a good one of its batch and marked not ok; with the
    wrap-pad mask, top-1 counts rows 0-6 once each, without row 2. The
    port's batches equal the JAX loader's."""
    collate = lambda s: (np.stack([x[0] for x in s]), np.asarray([x[1] for x in s]))  # noqa: E731
    kw = dict(shuffle=False, seed=0, num_shards=1, shard_index=0, drop_last=False)
    port_sampler, jax_sampler = loader.ShardedSampler(7, 4, **kw), jax_loader.ShardedSampler(
        7, 4, **kw)
    got = loader.BatchLoader(_Flaky(), port_sampler, num_workers=2, retry_resample=False,
                             collate=loader.exact_val_collate(collate))
    want = jax_loader.JepaLoader(_Flaky(), jax_sampler, num_workers=2, retry_resample=False,
                                 collate=jax_loader.exact_val_collate(collate))
    try:
        counted = []
        for (g, gv), (w, _) in zip(zip(got, port_sampler.batch_valid_masks()),
                                   zip(want, jax_sampler.batch_valid_masks())):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
            counted += list(g[1][gv & g[2]])
    finally:
        got.close()
        want.close()
    assert counted == [0, 1, 3, 4, 5, 6]
    assert isinstance(loader.fetch_with_retry(_Flaky(), 2, resample=False), loader.FetchFailure)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_augment_copies_match_jax(seed):
    """auto_augment_original (the image eval) and rand_augment_video (the
    pretrain AutoAugment) bit-equal to JAX's on the same generator."""
    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 255, size=(24, 32, 3)).astype(np.float32)
    clip = rng.integers(0, 255, size=(3, 24, 32, 3)).astype(np.float32)
    for name, x in (("auto_augment_original", img), ("rand_augment_video", clip)):
        got = getattr(randaugment, name)(x.copy(), np.random.default_rng(seed))
        want = getattr(jax_randaugment, name)(x.copy(), np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def media_csv(tmp_path_factory):
    """Six short clips written by the native encoder, labels 0-2."""
    from avjepa_tpu.data.video_decoder import write_test_video

    d = tmp_path_factory.mktemp("media")
    paths = []
    for i in range(6):
        paths.append(str(d / f"clip{i}.avi"))
        write_test_video(paths[-1], n_frames=40 + 4 * i, w=96, h=80, fps=25.0,
                         with_audio=False)
    csv_path = d / "index.csv"
    csv_path.write_text("".join(f"{p} {i % 3}\n" for i, p in enumerate(paths)))
    return str(csv_path)


def test_file_datasets_match_jax(media_csv):
    """On decoded media: the video eval's dataset (a train clip with its
    augmentation, the eval views of 2 segments x 2 views, and the cached
    probe's eval views of train clips) and the image eval's (train: crop,
    flip, AutoAugment, erasing; val: resize and center crop) give JAX's
    arrays bit for bit."""
    from avjepa_tpu.evals import image_classification as jax_ic

    from avjepa_tpu_torch.evals import image_classification as ic

    kw = dict(dataset_train=media_csv, dataset_val=media_csv, frames_per_clip=4,
              num_segments=2, num_views_per_segment=2, frame_step=2, resolution=32)
    cfg, jcfg = vc.VideoEvalConfig(**kw), jax_vc.VideoEvalConfig(**kw)
    for train, eval_views in ((True, False), (False, False), (True, True)):
        got = vc.VideoClassificationDataset(cfg, train, eval_views)
        want = jax_vc.VideoClassificationDataset(jcfg, train, eval_views)
        got.set_epoch(1)
        want.set_epoch(1)
        for i in (0, 5):
            for a, b in zip(jax.tree_util.tree_leaves(got[i]),
                            jax.tree_util.tree_leaves(want[i])):
                np.testing.assert_array_equal(a, b)
    kw = dict(dataset_train=media_csv, dataset_val=media_csv, resolution=32)
    for train in (True, False):
        got = ic.ImageDataset(ic.ImageEvalConfig(**kw), train)
        want = jax_ic.ImageDataset(jax_ic.ImageEvalConfig(**kw), train)
        for i in range(6):
            for a, b in zip(got[i], want[i]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the evals through the CLI
# ---------------------------------------------------------------------------


def _eval_yaml(tmp_path, name, ckpt=None, **opt):
    """A synthetic vit_tiny eval config at crop 32 and 4 frames."""
    d = {
        "eval_name": name,
        "folder": os.path.join(tmp_path, "out"),
        "tag": "tiny",
        "data": {"source": "synthetic", "num_classes": 5, "num_workers": 2,
                 "frames_per_clip": 4, "num_segments": 2, "num_views_per_segment": 2,
                 "frame_step": 2},
        "optimization": {"batch_size": 8, "num_epochs": 1, "resolution": 32,
                         "use_bfloat16": False, **opt},
        "pretrain": {"model_name": "vit_tiny", "frames_per_clip": 4, "folder": "",
                     "checkpoint": ckpt or "", "allow_missing_checkpoint": ckpt is not None},
    }
    path = os.path.join(tmp_path, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path, d


def _rows(d):
    with open(os.path.join(d["folder"], f"{d['tag']}_r0.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("opt", [
    {"use_pos_embed": True},
    {"attend_across_segments": False},
    {"cache_features": True},
    {"frame_aggregation": True},
], ids=["across-pos-embed", "per-segment", "cached", "frame-aggregation"])
def test_video_eval_through_the_cli(tmp_path, opt):
    """One epoch of 8 probe steps (64 synthetic clips, batch 8) from a
    checkpoint's target encoder (a 2-layer AV one: vit_tiny's first two
    blocks taken, the audio leaves dropped), then validation over 32 clips
    of 2 segments x 2 views: CSV rows with finite losses, 0 <= top-1 <= 100,
    the classifier saved."""
    ckpt, _ = _av_checkpoint(tmp_path)
    path, d = _eval_yaml(tmp_path, "video_classification_frozen", ckpt, **opt)
    out = launch(path, device="cpu")
    assert set(out) == {"train_acc", "val_top1"} and 0.0 <= out["val_top1"] <= 100.0
    rows = _rows(d)
    assert list(rows[0]) == ["epoch", "itr", "loss", "acc", "lr"] and len(rows) == 8
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert torch.load(os.path.join(d["folder"], "tiny-cls-latest.pth.tar"),
                      weights_only=True)["step"] == 8


def test_video_eval_resumes_the_classifier(tmp_path, monkeypatch):
    """A 1-epoch run, then a 2-epoch run under AVJEPA_RESUME_PREEMPT=1: it
    restores the classifier at epoch 1 and runs epoch 2 only (8 steps), and
    saves at step 16; a config with another num_classes starts fresh."""
    path, d = _eval_yaml(tmp_path, "video_classification_frozen")
    launch(path, device="cpu")
    saved = os.path.join(d["folder"], "tiny-cls-latest.pth.tar")
    first = torch.load(saved, weights_only=True)
    assert (first["step"], first["epoch"]) == (8, 1)
    d["optimization"]["num_epochs"] = 2
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    monkeypatch.setenv("AVJEPA_RESUME_PREEMPT", "1")
    launch(path, device="cpu")
    rows = [r for r in _rows(d) if r["epoch"] != "epoch"]
    assert [r["epoch"] for r in rows] == ["1"] * 8 + ["2"] * 8
    second = torch.load(saved, weights_only=True)
    assert (second["step"], second["epoch"]) == (16, 2)
    d["data"]["num_classes"] = 7
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    launch(path, device="cpu")
    assert torch.load(saved, weights_only=True)["classifier"]["linear.weight"].shape[0] == 7


@pytest.mark.parametrize("frames", [4, 1])
def test_image_eval_through_the_cli(tmp_path, frames):
    """The image eval: each image repeated over 4 frames into the video
    encoder, or (1 frame) into the image-mode encoder; 8 steps of batch 8,
    validation over 32 images."""
    path, d = _eval_yaml(tmp_path, "image_classification_frozen")
    d["pretrain"]["frames_per_clip"] = frames
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    out = launch(path, device="cpu")
    assert set(out) == {"train_acc", "val_top1"} and 0.0 <= out["val_top1"] <= 100.0
    rows = _rows(d)
    assert list(rows[0]) == ["epoch", "itr", "loss", "acc"] and len(rows) == 8
    assert all(np.isfinite(float(r["loss"])) for r in rows)


@pytest.mark.parametrize("name", ["video_classification_frozen",
                                  "image_classification_frozen"])
def test_evals_on_media_files_through_the_cli(tmp_path, media_csv, name):
    """Both evals on decoded media (train and val from the CSV): 3 steps of
    batch 2, then top-1 over the 6 val clips."""
    path, d = _eval_yaml(tmp_path, name)
    d["data"].update(source="files", dataset_train=media_csv, dataset_val=media_csv)
    d["optimization"]["batch_size"] = 2
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    out = launch(path, device="cpu")
    assert 0.0 <= out["val_top1"] <= 100.0
    assert len(_rows(d)) == 3


def test_evals_need_cuda_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("video_classification_frozen", "image_classification_frozen"):
        path, _ = _eval_yaml(tmp_path, name)
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch(path)


def test_configs_parse_as_in_jax():
    """Every eval config of the repo parses to the JAX package's values."""
    from avjepa_tpu.evals import image_classification as jax_ic

    from avjepa_tpu_torch.evals import image_classification as ic

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "evals")
    for fname in sorted(os.listdir(root)):
        with open(os.path.join(root, fname)) as f:
            d = yaml.safe_load(f)
        port, jax_mod = ((vc, jax_vc) if d["eval_name"] == "video_classification_frozen"
                         else (ic, jax_ic))
        assert dataclasses.asdict(port.config_from_yaml(d)) == dataclasses.asdict(
            jax_mod.config_from_yaml(d)), fname
