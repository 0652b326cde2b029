"""Frozen-backbone video classification eval (attentive probe).

    python -m avjepa_tpu_torch.app.eval_main --fname configs/evals/vitl16_k400_16x8x3.yaml

Counterpart of ``avjepa_tpu/evals/video_classification.py`` (reference:
evals/video_classification_frozen/eval.py + utils.py): merge the pretrain
checkpoint's target encoder into a video-only ViT (a ``.pth.tar`` or a
JAX pretrain Orbax directory, leaf by leaf), wrap it in clip aggregation (multi-segment, multi-view; optional
attend-across-segments concat with a 1-D temporal pos-embed; optional frame
aggregation through an image-mode encoder), train an ``AttentiveClassifier``
with cross-entropy, and report top-1 of the softmax averaged over segments
and summed over views, counting each val sample once and leaving decode
failures out.

The config, the datasets (with their numpy seeds) and the CSV are the JAX
module's. The frozen encoder and the classifier use the plain attention, as
the JAX evals do (``attn_impl="xla"``): no attention kernel runs here.
``batch_size`` is per GPU: with a process group (``parallel/dist.py``) each
rank trains and validates on its shard, the global batch is ``batch_size``
times the world, the classifier's gradients are averaged over the ranks in
one all-reduce before the clip, the logged loss and accuracy are global
means, top-1 comes from the all-reduced correct and valid counts, and rank
0 alone writes the classifier file; the cached-feature probe takes one
process, as in the JAX eval. The probe step is the JAX one: lr
from the schedule each step, constant weight decay, the global-norm clip at
1.0, AdamW with ``wd_mask``'s rule (``optim.plain_decays``). The classifier
state is saved to ``<folder>/<tag>-cls-latest.pth.tar`` and restored under
``optimization.resume_checkpoint`` or a preemption resume, from that file or
from the JAX eval's ``<tag>-cls-ckpt`` beside it when that holds a later
step; a stale or mismatched checkpoint starts fresh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from avjepa_tpu_torch.data.av_dataset import load_index, sample_clip_indices
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler, exact_val_collate
from avjepa_tpu_torch.data.transforms import EvalVideoTransform, VideoTransform
from avjepa_tpu_torch.data.video_decoder import VideoFile
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.attentive_pooler import AttentiveClassifier
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import VIT_SPECS, init_classifier_params, make_encoder
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train.optim import (
    ScheduleConfig,
    clip_,
    global_norm,
    lr_at_step,
    make_optimizer,
    plain_decays,
    set_lr_wd,
)
from avjepa_tpu_torch.utils.checkpoint import (
    load_classifier_state,
    merge_target_encoder,
    save_classifier_state,
)
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger


@dataclasses.dataclass
class VideoEvalConfig:
    dataset_train: str = ""
    dataset_val: str = ""
    num_classes: int = 400
    frames_per_clip: int = 16
    num_segments: int = 1
    num_views_per_segment: int = 1
    frame_step: int = 4
    attend_across_segments: bool = True
    use_pos_embed: bool = False
    # frame aggregation: encode every frame independently with an image-mode
    # encoder and concatenate all frame tokens (reference FrameAggregation,
    # evals/video_classification_frozen/utils.py:23-83 — for image-pretrained
    # backbones evaluated on video)
    frame_aggregation: bool = False
    num_epochs: int = 20
    resolution: int = 224
    batch_size: int = 4
    num_workers: int = 8
    weight_decay: float = 0.01
    lr: float = 1e-3
    start_lr: float = 1e-3
    final_lr: float = 0.0
    warmup: float = 0.0
    use_bfloat16: bool = True
    # pretrain section
    model_name: str = "vit_large"
    patch_size: int = 16
    tubelet_size: int = 2
    uniform_power: bool = True
    checkpoint: str = ""  # the pretrain app's .pth.tar
    # a configured-but-absent/mismatched checkpoint is an ERROR unless
    # this is set: silently probing a random encoder wastes the run
    allow_missing_checkpoint: bool = False
    # resume the probe classifier from its own checkpoint — opt-in like the
    # reference (eval.py:116), or forced by preemption resume
    resume_checkpoint: bool = False
    # cached-feature probe mode: the encoder is FROZEN, so encode every train
    # clip ONCE (deterministic eval views) and keep the features resident on
    # device, then run ipe*num_epochs probe updates at device speed with no
    # per-epoch host decode. This is the standard fixed-feature linear-probe
    # protocol; the reference instead re-decodes + re-augments every epoch
    # (evals/video_classification_frozen/eval.py:303-385). Off by default.
    cache_features: bool = False
    checkpoint_key: str = "target_encoder"
    folder: str = "./eval_logs"
    tag: str = "video-eval"
    seed: int = 0
    source: str = "files"  # 'synthetic' for tests
    # must match the GELU the checkpoint was PRETRAINED with (tpu.gelu in the
    # pretrain config; 'tanh' is the pretrain default)
    gelu: str = "tanh"


def config_from_yaml(d: dict) -> VideoEvalConfig:
    # a bare section key ("logging:" with no body) parses to None, not {}
    sec = lambda k: d.get(k) or {}  # noqa: E731
    data = sec("data")
    opt = sec("optimization")
    pre = sec("pretrain")
    return VideoEvalConfig(
        dataset_train=data.get("dataset_train", ""),
        dataset_val=data.get("dataset_val", ""),
        num_classes=data.get("num_classes", 400),
        frames_per_clip=data.get("frames_per_clip", 16),
        num_segments=data.get("num_segments", 1),
        num_views_per_segment=data.get("num_views_per_segment", 1),
        frame_step=data.get("frame_step", 4),
        num_workers=data.get("num_workers", 8),
        attend_across_segments=opt.get("attend_across_segments", True),
        use_pos_embed=opt.get("use_pos_embed", False),
        frame_aggregation=opt.get("frame_aggregation", False),
        num_epochs=opt.get("num_epochs", 20),
        resolution=opt.get("resolution", 224),
        batch_size=opt.get("batch_size", 4),
        weight_decay=opt.get("weight_decay", 0.01),
        lr=opt.get("lr", 1e-3),
        start_lr=opt.get("start_lr", 1e-3),
        final_lr=opt.get("final_lr", 0.0),
        warmup=opt.get("warmup", 0.0),
        use_bfloat16=opt.get("use_bfloat16", True),
        cache_features=opt.get("cache_features", False),
        model_name=pre.get("model_name", "vit_large"),
        patch_size=pre.get("patch_size", 16),
        tubelet_size=pre.get("tubelet_size", 2),
        uniform_power=pre.get("uniform_power", True),
        checkpoint=os.path.join(pre.get("folder", ""), pre.get("checkpoint", "")),
        checkpoint_key=pre.get("checkpoint_key", "target_encoder"),
        allow_missing_checkpoint=pre.get("allow_missing_checkpoint", False),
        resume_checkpoint=opt.get("resume_checkpoint", False),
        folder=d.get("folder", (d.get("logging") or {}).get("folder", "./eval_logs")),
        tag=d.get("tag", "video-eval"),
        source=data.get("source", "files"),
        gelu=(d.get("tpu") or {}).get("gelu", pre.get("gelu", "tanh")),
    )


class VideoClassificationDataset:
    """Multi-segment / multi-view eval dataset (video-only)."""

    def __init__(self, cfg: VideoEvalConfig, train: bool, eval_views: bool = False):
        self.cfg = cfg
        self.train = train
        # eval_views forces the deterministic eval transform on the TRAIN file
        # list (the cached-feature probe encodes each train clip once)
        self.eval_views = eval_views
        csv = cfg.dataset_train if train else cfg.dataset_val
        self.paths, self.labels, _ = load_index([csv])
        self.train_tf = VideoTransform(
            crop_size=cfg.resolution,
            random_resize_scale=(0.08, 1.0),
            random_resize_aspect_ratio=(0.75, 4 / 3),
        )
        self.eval_tf = EvalVideoTransform(
            num_views=cfg.num_views_per_segment,
            short_side=cfg.resolution,
            crop_size=cfg.resolution,
        )

    def __len__(self):
        return len(self.paths)

    def set_epoch(self, epoch: int) -> None:
        # fresh train-time crops/clip positions every epoch
        self._epoch_salt = int(epoch)

    def __getitem__(self, idx: int):
        cfg = self.cfg
        vf = VideoFile(self.paths[idx])
        rng = np.random.default_rng(
            [cfg.seed, int(self.train), getattr(self, "_epoch_salt", 0), idx]
        )
        as_train = self.train and not self.eval_views
        segs = sample_clip_indices(
            vf.num_frames, cfg.frames_per_clip, cfg.frame_step,
            1 if as_train else cfg.num_segments,
            rng, random_clip_sampling=as_train,
        )
        all_idx = np.concatenate(segs)
        frames = vf.decode_frames(np.sort(all_idx))
        order = np.argsort(np.argsort(all_idx, kind="stable"), kind="stable")
        frames = frames[order]
        fpc = cfg.frames_per_clip
        clips = [frames[i * fpc : (i + 1) * fpc] for i in range(len(segs))]
        if as_train:
            views = [[self.train_tf(clips[0], rng)]]
        else:
            views = [self.eval_tf(c) for c in clips]  # [seg][view]
        return views, segs, int(self.labels[idx])


class SyntheticVideoClsDataset:
    def __init__(self, cfg: VideoEvalConfig, train: bool, length: int = 64):
        self.cfg = cfg
        self.train = train
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        cfg = self.cfg
        rng = np.random.default_rng([7, int(self.train), idx])
        label = idx % cfg.num_classes
        n_seg = 1 if self.train else cfg.num_segments
        n_view = 1 if self.train else cfg.num_views_per_segment
        base = rng.normal(label / cfg.num_classes, 0.5)
        views = [
            [
                (base + rng.normal(0, 0.1, (cfg.frames_per_clip, cfg.resolution,
                                            cfg.resolution, 3))).astype(np.float32)
                for _ in range(n_view)
            ]
            for _ in range(n_seg)
        ]
        segs = [
            np.arange(cfg.frames_per_clip) * cfg.frame_step + s
            for s in range(n_seg)
        ]
        return views, segs, label


def collate(samples):
    """[seg][view] sample lists -> ([seg][view] arrays [B, T, H, W, 3],
    clip indices [S, B, T], labels [B])."""
    views = [s[0] for s in samples]
    segs = [s[1] for s in samples]
    n_seg, n_view = len(views[0]), len(views[0][0])
    batched = [[np.stack([v[s][w] for v in views]) for w in range(n_view)]
               for s in range(n_seg)]
    seg_idx = np.stack([np.stack([g[s] for g in segs]) for s in range(n_seg)])
    return batched, seg_idx, np.asarray([s[2] for s in samples])


# ---------------------------------------------------------------------------
# the frozen encoder, the classifier and the probe step (shared with the
# image eval)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClassifierState:
    classifier: AttentiveClassifier
    optimizer: torch.optim.AdamW
    step: int = 0


def frozen_encoder(model_name: str, layout: TokenLayout, uniform_power: bool,
                   dtype: torch.dtype, gelu: str, seed: int, checkpoint: str,
                   allow_missing: bool, device: torch.device,
                   checkpoint_key: str = "target_encoder") -> Encoder:
    """A video-only (or image-mode) encoder of ``model_name``, initialised
    from ``seed``, then merged with entry ``checkpoint_key`` of the
    ``.pth.tar`` at ``checkpoint`` (``merge_target_encoder``; strict unless
    ``allow_missing``); frozen, on ``device``."""
    logger = get_logger("avjepa_tpu_torch")
    encoder = make_encoder(model_name, layout, uniform_power=uniform_power, dtype=dtype,
                           gelu=gelu, seed=seed)
    if checkpoint and merge_target_encoder(checkpoint, encoder, strict=not allow_missing,
                                           prefer=checkpoint_key) is not None:
        logger.info(f"loaded pretrained encoder from {checkpoint}")
    return encoder.requires_grad_(False).eval().to(device)


def make_classifier(model_name: str, num_classes: int, dtype: torch.dtype, seed: int,
                    device: torch.device) -> ClassifierState:
    """The evals' ``AttentiveClassifier`` (depth 1, the encoder's width and
    heads), initialised from ``seed``, and its AdamW."""
    spec = VIT_SPECS[model_name]
    classifier = AttentiveClassifier(embed_dim=spec.embed_dim, num_heads=spec.num_heads,
                                     depth=1, num_classes=num_classes, dtype=dtype)
    init_classifier_params(classifier, seed)
    dist.broadcast_module(classifier.to(device))
    return ClassifierState(classifier, make_optimizer([classifier], rule=plain_decays))


@torch.no_grad()
def encode(encoder: Encoder, clips: torch.Tensor, frame_aggregation: bool = False):
    """clips [B, T, H, W, 3] -> tokens [B, N, D]; with frame aggregation the
    image-mode encoder takes the B*T frames and each clip's frame tokens are
    concatenated ([B, T*H'*W', D])."""
    if frame_aggregation:
        b, t = clips.shape[:2]
        out = encoder(clips.reshape(b * t, *clips.shape[2:]))
        return out.reshape(b, t * out.shape[1], out.shape[2])
    return encoder(clips)


def aggregate(cfg: VideoEvalConfig, outs: list, clip_indices: Optional[np.ndarray],
              n_spatial: int) -> list:
    """Attend across segments: the segments' tokens concatenated into one
    [B, S*N, D], plus, with ``use_pos_embed``, a 1-D sincos embedding of
    each token's frame index (``clip_indices`` [S, B, T] taken every
    ``tubelet_size`` frames, repeated over the ``n_spatial`` patches);
    otherwise the segments as they are (reference ClipAggregation,
    utils.py:138-159)."""
    if not cfg.attend_across_segments:
        return outs
    out = torch.cat(outs, dim=1)
    if cfg.use_pos_embed and clip_indices is not None:
        b, d = out.shape[0], out.shape[-1]
        pos = torch.from_numpy(pe.sincos_1d(d, 10000 // cfg.tubelet_size)).to(out.device,
                                                                              out.dtype)
        idx = torch.from_numpy(np.ascontiguousarray(
            np.asarray(clip_indices)[:, :, :: cfg.tubelet_size])).to(out.device)
        p = pos[idx.long()]  # [S, B, T', D]
        p = p[:, :, :, None, :].expand(-1, -1, -1, n_spatial, -1)
        out = out + p.permute(1, 0, 2, 3, 4).reshape(b, -1, d)
    return [out]


def cls_loss(classifier: AttentiveClassifier, feats: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy with log_softmax in f32, logits)."""
    logits = classifier(feats)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean(), logits


def probe_step(state: ClassifierState, sched: ScheduleConfig, weight_decay: float,
               feats: torch.Tensor, labels: torch.Tensor) -> dict:
    """One classifier update in place (JAX ``train_step``): lr from the
    schedule at ``state.step``, gradients averaged over the ranks and
    clipped to global norm 1.0, AdamW with constant ``weight_decay``.
    Returns the global batch's loss and acc, and lr, as numbers."""
    lr = lr_at_step(sched, state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, logits = cls_loss(state.classifier, feats, labels)
    loss.backward()
    dist.all_reduce_grads([state.classifier])
    grads = [p.grad for p in state.classifier.parameters() if p.grad is not None]
    clip_(grads, global_norm(grads), 1.0)
    set_lr_wd(state.optimizer, lr, weight_decay)
    state.optimizer.step()
    state.step += 1
    acc = (logits.argmax(-1) == labels).float().mean()
    loss, acc = dist.reduce(torch.stack([loss.detach(), acc]), "mean").tolist()  # one sync
    return {"loss": loss, "acc": acc, "lr": lr}


@torch.no_grad()
def predict(classifier: AttentiveClassifier, feats: torch.Tensor) -> torch.Tensor:
    return torch.softmax(classifier(feats).float(), dim=-1)


def to_device(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


def classifier_path(folder: str, tag: str) -> str:
    return os.path.join(folder, f"{tag}-cls-latest.pth.tar")


def restore_classifier(path: str, state: ClassifierState, resume: bool) -> tuple[int, int]:
    """(first epoch, step last saved): the saved classifier (``path``, or
    the JAX ``-cls-ckpt`` beside it when later) when ``resume`` and it
    fits, else a fresh start at (0, -1)."""
    epoch = load_classifier_state(path, state) if resume else None
    if epoch is None:
        return 0, -1
    get_logger("avjepa_tpu_torch").info(f"resumed classifier at epoch {epoch}")
    return epoch, state.step


def run(cfg: VideoEvalConfig, max_steps: Optional[int] = None,
        device: str | torch.device = "cuda") -> dict:
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
    layout = TokenLayout(
        num_frames=1 if cfg.frame_aggregation else cfg.frames_per_clip,
        crop_size=cfg.resolution,
        patch_size=cfg.patch_size,
        tubelet_size=cfg.tubelet_size,
        audio_enabled=False,
    )
    encoder = frozen_encoder(cfg.model_name, layout, cfg.uniform_power, dtype, cfg.gelu,
                             cfg.seed, cfg.checkpoint, cfg.allow_missing_checkpoint, device,
                             cfg.checkpoint_key)
    state = make_classifier(cfg.model_name, cfg.num_classes, dtype, cfg.seed + 1, device)

    if cfg.source == "synthetic" or not cfg.dataset_train:
        train_ds = SyntheticVideoClsDataset(cfg, train=True)
        val_ds = SyntheticVideoClsDataset(cfg, train=False, length=32)
    else:
        train_ds = VideoClassificationDataset(cfg, train=True)
        val_ds = VideoClassificationDataset(cfg, train=False)
    batch = cfg.batch_size  # per GPU
    ipe = max(1, len(train_ds) // (batch * dist.world()))
    sched = ScheduleConfig(
        ipe=ipe, num_epochs=cfg.num_epochs, ipe_scale=1.0, warmup_epochs=cfg.warmup,
        start_lr=cfg.start_lr, ref_lr=cfg.lr, final_lr=cfg.final_lr,
        ref_wd=cfg.weight_decay, final_wd=cfg.weight_decay,
    )
    n_spatial = layout.h_grid * layout.w_grid

    def features(batched, seg_idx, view: int) -> list:
        outs = [encode(encoder, to_device(batched[s][view], device), cfg.frame_aggregation)
                for s in range(len(batched))]
        return aggregate(cfg, outs, seg_idx, n_spatial)

    os.makedirs(cfg.folder, exist_ok=True)
    path = classifier_path(cfg.folder, cfg.tag)
    start_epoch, last_saved = restore_classifier(path, state, cfg.resume_checkpoint)
    csv_logger = CSVLogger(
        os.path.join(cfg.folder, f"{cfg.tag}_r{dist.rank()}.csv"),
        ("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"), ("%.3f", "acc"), ("%.2e", "lr"),
    )
    summary = {}
    total = 0

    def log_step(epoch: int, m: dict, meter: AverageMeter) -> None:
        nonlocal total
        meter.update(m["acc"] * 100)
        csv_logger.log(epoch + 1, total, m["loss"], m["acc"] * 100, m["lr"])
        if not np.isfinite(m["loss"]):
            raise FloatingPointError(f"classifier loss is not finite at step {state.step}")
        total += 1

    def save(epoch: int) -> None:
        nonlocal last_saved
        if state.step != last_saved:  # skip epochs that took no step
            if dist.is_main():
                save_classifier_state(path, state, epoch + 1)
            dist.barrier()
            last_saved = state.step

    done = lambda: max_steps is not None and total >= max_steps  # noqa: E731
    if cfg.cache_features:
        # encode each train clip once with eval views; the features stay on
        # the device and every step gathers a batch of them
        if dist.world() > 1:
            raise NotImplementedError("optimization.cache_features runs in one process "
                                      "(as the JAX eval does)")
        if cfg.source == "synthetic":
            cache_ds = SyntheticVideoClsDataset(cfg, train=True)
        else:
            cache_ds = VideoClassificationDataset(cfg, train=True, eval_views=True)
        seq = ShardedSampler(len(cache_ds), batch, shuffle=False, seed=0, drop_last=False)
        loader = BatchLoader(cache_ds, seq, num_workers=cfg.num_workers,
                             collate=exact_val_collate(collate), retry_resample=False)
        chunks, lab_chunks, ok_chunks = [], [], []
        try:
            for (batched, seg_idx, labels, ok), valid in zip(loader, seq.batch_valid_masks()):
                chunks.append(features(batched, seg_idx, 0)[0])
                lab_chunks.append(labels)
                ok_chunks.append(valid & ok)
        finally:
            loader.close()
        keep = torch.from_numpy(np.flatnonzero(np.concatenate(ok_chunks))).to(device)
        cache = torch.cat(chunks, dim=0)[keep]
        cache_labels = to_device(np.concatenate(lab_chunks), device)[keep]
        n_cache = cache.shape[0]
        logger.info(f"[eval] feature cache: {n_cache} clips x {cache.shape[1]} tokens x "
                    f"{cache.shape[2]} dims ({cache.nbytes / 2**20:.0f} MiB)")
        draw = np.random.default_rng([cfg.seed, 17])
        bsz = min(batch, n_cache)
        for epoch in range(start_epoch, cfg.num_epochs):
            meter = AverageMeter()
            for _ in range(ipe):
                idx = to_device(draw.choice(n_cache, size=bsz, replace=False), device)
                log_step(epoch, probe_step(state, sched, cfg.weight_decay, cache[idx],
                                           cache_labels[idx]), meter)
            if (epoch + 1) % max(1, cfg.num_epochs // 10) == 0:
                logger.info(f"[eval-train {epoch + 1}] top1(train) {meter.avg:.2f}%")
            summary["train_acc"] = meter.avg
            if (epoch + 1) % 10 == 0 or epoch + 1 == cfg.num_epochs:
                save(epoch)
            if done():
                break
        del cache, cache_labels
    else:
        sampler = ShardedSampler(len(train_ds), batch, seed=cfg.seed, num_shards=dist.world(),
                                 shard_index=dist.rank())
        loader = BatchLoader(train_ds, sampler, num_workers=cfg.num_workers, collate=collate)
        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                loader.set_epoch(epoch)
                meter = AverageMeter()
                batches = iter(loader)
                try:
                    for batched, seg_idx, labels in batches:
                        feats = features(batched, seg_idx, 0)[0]
                        log_step(epoch, probe_step(state, sched, cfg.weight_decay, feats,
                                                   to_device(labels, device)), meter)
                        if done():
                            break
                finally:
                    batches.close()
                logger.info(f"[eval-train {epoch + 1}] top1(train) {meter.avg:.2f}%")
                summary["train_acc"] = meter.avg
                save(epoch)
                if done():
                    break
        finally:
            loader.close()

    # validation: softmax averaged over segments, summed over views; exact
    # counts over the global batch (wrap-padded rows and decode failures
    # left out)
    val_sampler = ShardedSampler(len(val_ds), batch, shuffle=False, seed=0, drop_last=False,
                                 num_shards=dist.world(), shard_index=dist.rank())
    loader = BatchLoader(val_ds, val_sampler, num_workers=cfg.num_workers,
                         collate=exact_val_collate(collate), retry_resample=False)
    correct = count = 0
    try:
        for (batched, seg_idx, labels, ok), valid in zip(loader, val_sampler.batch_valid_masks()):
            probs = 0.0
            for v in range(len(batched[0])):
                feats_list = features(batched, seg_idx, v)
                probs = probs + sum(predict(state.classifier, f)
                                    for f in feats_list) / len(feats_list)
            counted = to_device(valid & ok, device)
            correct += dist.count_correct(probs, to_device(labels, device), counted)
            count += dist.count_valid(counted)
    finally:
        loader.close()
    top1 = 100.0 * correct / max(count, 1)
    logger.info(f"[eval] val top-1: {top1:.2f}%")
    summary["val_top1"] = top1
    return summary


def main(args: dict, resume_preempt: bool = False, device: str | torch.device = "cuda"):
    cfg = config_from_yaml(args)
    if resume_preempt:
        cfg = dataclasses.replace(cfg, resume_checkpoint=True)
    return run(cfg, device=device)
