"""Frozen-backbone image classification eval.

    python -m avjepa_tpu_torch.app.eval_main --fname configs/evals/vitl16_in1k.yaml

Counterpart of ``avjepa_tpu/evals/image_classification.py`` (reference:
evals/image_classification_frozen/eval.py): the video eval's attentive probe
on single images. A video-pretrained encoder sees each image repeated over
``frames_per_clip`` frames (the reference does this with a forward_pre_hook,
eval.py:451-457); with ``frames_per_clip: 1`` the encoder is in image mode and
takes the image itself (the JAX module hands it a one-frame clip there, which
its 2-D patch embed does not take).

Datasets: class-per-subdirectory image folders (``data.image_folder``, with
``train`` and ``val``) or a ``path label`` CSV, decoded by the native libav
decoder; the train transform is RandomResizedCrop, flip, AutoAugment
('original'), normalize, random erasing (0.25); the val transform resizes
the short side to ``resolution * 256 / 224`` and takes the center crop. The
config, datasets, seeds, CSV and summary are the JAX module's; the encoder,
classifier, probe step, checkpoints and exact validation are the video
eval's (``evals/video_classification.py``), and so is its data parallelism
(``batch_size`` per GPU, each rank on its shard).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from avjepa_tpu_torch.data.av_dataset import load_index
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler, exact_val_collate
from avjepa_tpu_torch.data.randaugment import auto_augment_original
from avjepa_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _bilinear_resize,
    random_erasing,
    sample_crop_box,
)
from avjepa_tpu_torch.data.video_decoder import VideoFile
from avjepa_tpu_torch.evals.video_classification import (
    classifier_path,
    frozen_encoder,
    make_classifier,
    predict,
    probe_step,
    restore_classifier,
    to_device,
)
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train.optim import ScheduleConfig
from avjepa_tpu_torch.utils.checkpoint import save_classifier_state
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger


@dataclasses.dataclass
class ImageEvalConfig:
    image_folder: str = ""
    dataset_train: str = ""  # CSV alternative
    dataset_val: str = ""
    num_classes: int = 1000
    resolution: int = 224
    batch_size: int = 16
    num_workers: int = 8
    num_epochs: int = 20
    lr: float = 1e-3
    start_lr: float = 1e-3
    final_lr: float = 0.0
    warmup: float = 0.0
    weight_decay: float = 0.01
    use_bfloat16: bool = True
    model_name: str = "vit_large"
    patch_size: int = 16
    frames_per_clip: int = 16  # video encoder: image replicated to this many
    tubelet_size: int = 2
    uniform_power: bool = True
    checkpoint: str = ""
    allow_missing_checkpoint: bool = False
    # resume the probe classifier from its own checkpoint — opt-in like the
    # reference (eval.py:106), or forced by preemption resume
    resume_checkpoint: bool = False
    folder: str = "./eval_logs"
    tag: str = "image-eval"
    seed: int = 0
    source: str = "files"
    # must match the GELU the checkpoint was pretrained with (tpu.gelu)
    gelu: str = "tanh"


def config_from_yaml(d: dict) -> ImageEvalConfig:
    # a bare section key ("logging:" with no body) parses to None, not {}
    sec = lambda k: d.get(k) or {}  # noqa: E731
    data = sec("data")
    opt = sec("optimization")
    pre = sec("pretrain")
    return ImageEvalConfig(
        image_folder=data.get("image_folder", ""),
        dataset_train=data.get("dataset_train", ""),
        dataset_val=data.get("dataset_val", ""),
        num_classes=data.get("num_classes", 1000),
        resolution=opt.get("resolution", 224),
        batch_size=opt.get("batch_size", 16),
        num_workers=data.get("num_workers", 8),
        num_epochs=opt.get("num_epochs", 20),
        lr=opt.get("lr", 1e-3),
        start_lr=opt.get("start_lr", 1e-3),
        final_lr=opt.get("final_lr", 0.0),
        warmup=opt.get("warmup", 0.0),
        weight_decay=opt.get("weight_decay", 0.01),
        use_bfloat16=opt.get("use_bfloat16", True),
        model_name=pre.get("model_name", "vit_large"),
        patch_size=pre.get("patch_size", 16),
        frames_per_clip=pre.get("frames_per_clip", 16),
        tubelet_size=pre.get("tubelet_size", 2),
        uniform_power=pre.get("uniform_power", True),
        checkpoint=os.path.join(pre.get("folder", ""), pre.get("checkpoint", "")),
        allow_missing_checkpoint=pre.get("allow_missing_checkpoint", False),
        resume_checkpoint=opt.get("resume_checkpoint", False),
        folder=d.get("folder", (d.get("logging") or {}).get("folder", "./eval_logs")),
        tag=d.get("tag", "image-eval"),
        source=data.get("source", "files"),
        gelu=(d.get("tpu") or {}).get("gelu", pre.get("gelu", "tanh")),
    )


def _folder_index(root: str):
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    paths, labels = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, f))
            labels.append(ci)
    return paths, np.asarray(labels)


class ImageDataset:
    def __init__(self, cfg: ImageEvalConfig, train: bool):
        self.cfg = cfg
        self.train = train
        if cfg.image_folder:
            sub = "train" if train else "val"
            self.paths, self.labels = _folder_index(os.path.join(cfg.image_folder, sub))
        else:
            csv = cfg.dataset_train if train else cfg.dataset_val
            self.paths, self.labels, _ = load_index([csv])

    def __len__(self):
        return len(self.paths)

    def set_epoch(self, epoch: int) -> None:
        # fresh train-time crops/flips every epoch
        self._epoch_salt = int(epoch)

    def __getitem__(self, idx: int):
        cfg = self.cfg
        vf = VideoFile(self.paths[idx])
        img = vf.decode_frames(np.array([0]))[0].astype(np.float32)  # [H, W, 3]
        rng = np.random.default_rng(
            [3, int(self.train), getattr(self, "_epoch_salt", 0), idx]
        )
        r = cfg.resolution
        if self.train:
            # timm make_transforms pipeline the reference trains with
            # (eval.py:393-403): RandomResizedCrop -> hflip ->
            # auto_augment='original' -> Normalize -> RandomErasing
            # (re_prob=0.25, pixel mode, after normalization)
            top, left, ch, cw = sample_crop_box(
                img.shape[0], img.shape[1], (0.08, 1.0), (0.75, 4 / 3), rng
            )
            img = _bilinear_resize(img[top : top + ch, left : left + cw], r, r)
            if rng.random() < 0.5:
                img = img[:, ::-1]
            img = auto_augment_original(img, rng)
            img = (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            img = random_erasing(
                np.ascontiguousarray(img, np.float32)[None], rng, prob=0.25
            )[0]
        else:
            # short side scales WITH the eval resolution — resolution*256/224,
            # not a fixed 256 (reference eval.py:406)
            h, w = img.shape[:2]
            s = r * 256 / 224 / min(h, w)
            img = _bilinear_resize(img, int(round(h * s)), int(round(w * s)))
            h, w = img.shape[:2]
            top, left = (h - r) // 2, (w - r) // 2
            img = img[top : top + r, left : left + r]
            img = (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return np.ascontiguousarray(img, np.float32), int(self.labels[idx])


class SyntheticImageDataset:
    def __init__(self, cfg: ImageEvalConfig, train: bool, length: int = 64):
        self.cfg = cfg
        self.train = train
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        cfg = self.cfg
        rng = np.random.default_rng([5, int(self.train), idx])
        label = idx % cfg.num_classes
        img = (label / cfg.num_classes + rng.normal(
            0, 0.1, (cfg.resolution, cfg.resolution, 3)
        )).astype(np.float32)
        return img, label


def collate(samples):
    """(images [B, H, W, 3], labels [B])."""
    return np.stack([s[0] for s in samples]), np.asarray([s[1] for s in samples])


@torch.no_grad()
def encode(encoder, images: torch.Tensor, frames_per_clip: int) -> torch.Tensor:
    """images [B, H, W, 3] -> tokens: each image repeated over the video
    encoder's frames, or, at one frame, the image-mode encoder's tokens."""
    if frames_per_clip == 1:
        return encoder(images)
    return encoder(images[:, None].expand(-1, frames_per_clip, -1, -1, -1))


def run(cfg: ImageEvalConfig, max_steps: Optional[int] = None,
        device: str | torch.device = "cuda") -> dict:
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
    layout = TokenLayout(
        num_frames=cfg.frames_per_clip,
        crop_size=cfg.resolution,
        patch_size=cfg.patch_size,
        tubelet_size=cfg.tubelet_size,
        audio_enabled=False,
    )
    encoder = frozen_encoder(cfg.model_name, layout, cfg.uniform_power, dtype, cfg.gelu,
                             cfg.seed, cfg.checkpoint, cfg.allow_missing_checkpoint, device)
    state = make_classifier(cfg.model_name, cfg.num_classes, dtype, cfg.seed + 1, device)

    if cfg.source == "synthetic" or (not cfg.image_folder and not cfg.dataset_train):
        train_ds = SyntheticImageDataset(cfg, True)
        val_ds = SyntheticImageDataset(cfg, False, length=32)
    else:
        train_ds = ImageDataset(cfg, True)
        val_ds = ImageDataset(cfg, False)
    batch = cfg.batch_size  # per GPU
    ipe = max(1, len(train_ds) // (batch * dist.world()))
    sched = ScheduleConfig(
        ipe=ipe, num_epochs=cfg.num_epochs, ipe_scale=1.0, warmup_epochs=cfg.warmup,
        start_lr=cfg.start_lr, ref_lr=cfg.lr, final_lr=cfg.final_lr,
        ref_wd=cfg.weight_decay, final_wd=cfg.weight_decay,
    )

    def features(images) -> torch.Tensor:
        return encode(encoder, to_device(images, device), cfg.frames_per_clip)

    os.makedirs(cfg.folder, exist_ok=True)
    path = classifier_path(cfg.folder, cfg.tag)
    start_epoch, last_saved = restore_classifier(path, state, cfg.resume_checkpoint)
    csv_logger = CSVLogger(
        os.path.join(cfg.folder, f"{cfg.tag}_r{dist.rank()}.csv"),
        ("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"), ("%.3f", "acc"),
    )
    sampler = ShardedSampler(len(train_ds), batch, seed=cfg.seed, num_shards=dist.world(),
                             shard_index=dist.rank())
    loader = BatchLoader(train_ds, sampler, num_workers=cfg.num_workers, collate=collate)
    summary = {}
    total = 0
    done = lambda: max_steps is not None and total >= max_steps  # noqa: E731
    try:
        for epoch in range(start_epoch, cfg.num_epochs):
            loader.set_epoch(epoch)
            meter = AverageMeter()
            batches = iter(loader)
            try:
                for imgs, labels in batches:
                    m = probe_step(state, sched, cfg.weight_decay, features(imgs),
                                   to_device(labels, device))
                    meter.update(m["acc"] * 100)
                    csv_logger.log(epoch + 1, total, m["loss"], m["acc"] * 100)
                    if not np.isfinite(m["loss"]):
                        raise FloatingPointError(
                            f"classifier loss is not finite at step {state.step}")
                    total += 1
                    if done():
                        break
            finally:
                batches.close()
            logger.info(f"[image-eval {epoch + 1}] top1(train) {meter.avg:.2f}%")
            summary["train_acc"] = meter.avg
            if state.step != last_saved:  # skip epochs that took no step
                if dist.is_main():
                    save_classifier_state(path, state, epoch + 1)
                dist.barrier()
                last_saved = state.step
            if done():
                break
    finally:
        loader.close()

    val_sampler = ShardedSampler(len(val_ds), batch, shuffle=False, drop_last=False,
                                 num_shards=dist.world(), shard_index=dist.rank())
    loader = BatchLoader(val_ds, val_sampler, num_workers=cfg.num_workers,
                         collate=exact_val_collate(collate), retry_resample=False)
    correct = count = 0
    try:
        for (imgs, labels, ok), valid in zip(loader, val_sampler.batch_valid_masks()):
            probs = predict(state.classifier, features(imgs))
            counted = to_device(valid & ok, device)
            correct += dist.count_correct(probs, to_device(labels, device), counted)
            count += dist.count_valid(counted)
    finally:
        loader.close()
    top1 = 100.0 * correct / max(count, 1)
    logger.info(f"[image-eval] val top-1: {top1:.2f}%")
    summary["val_top1"] = top1
    return summary


def main(args: dict, resume_preempt: bool = False, device: str | torch.device = "cuda"):
    cfg = config_from_yaml(args)
    if resume_preempt:
        cfg = dataclasses.replace(cfg, resume_checkpoint=True)
    return run(cfg, device=device)
