"""JEPA pretraining runner: the ``avjepa`` and ``vjepa`` apps, data parallel.

    python -m avjepa_tpu_torch.app.main --fname configs/pretrain/av-vitl16.yaml
    python -m avjepa_tpu_torch.app.main_distributed --nproc-per-node 8 \
        --fname configs/pretrain/av-vitl16.yaml

Counterpart of ``avjepa_tpu/train/pretrain.py`` with the same loop shape:
epochs x iterations-per-epoch over a loader that restarts when exhausted,
masks sampled per batch by the collator, the same CSV columns and console
line, checkpoints at the end of every ``checkpoint_freq``-th epoch, at the
last epoch, at ``max_steps`` and on SIGTERM, and resume with
``meta.load_checkpoint``. Checkpoints are reference-layout ``.pth.tar``
files: ``<folder>/<tag>-latest.pth.tar``, and ``<tag>-ep<N>.pth.tar`` every
``save_every_freq`` epochs (reference: app/avjepa/train.py:332-350,639-644).
A resume also reads the JAX app's Orbax ``<folder>/<tag>-ckpt``: of the two,
the one with the later step (the ``.pth.tar`` on a tie); without either,
``meta.read_checkpoint``, a ``.pth.tar`` or an Orbax directory.
The models keep f32 parameters and compute in ``meta.dtype``.

With a process group (``parallel/dist.py``, one process per GPU) each rank
loads ``data.batch_size`` samples from its shard of the sampler, so the
global batch is ``batch_size`` times the world, as in the JAX package
(``avjepa_tpu/train/pretrain.py:300-306``); every rank's collator draws the
same masks for its local batch from the same seed. Rank 0's initial weights
are broadcast. Each rank writes ``<tag>_r{rank}.csv`` with the global loss;
rank 0 alone writes the checkpoints (``world_size`` set), and every rank
reads them on resume. A SIGTERM on any rank is agreed on every 8 steps, at
the same step on every rank, so all ranks checkpoint and stop together.
With ``tpu.mesh_fsdp > 1`` the three models are sharded
(``parallel/fsdp.py``): every rank takes part in gathering the state that
rank 0 writes, and a resume re-shards the whole state every rank reads, so
a checkpoint crosses between fsdp, data and one process. With
``tpu.mesh_tensor > 1`` the ranks of a tensor group (``parallel/tensor.py``)
load one batch and hold pieces of each block's Megatron layers: the global
batch is ``batch_size x mesh_data x mesh_fsdp``, and the checkpoint holds
whole tensors as before.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from avjepa_tpu_torch.config import ExperimentConfig, load_config
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler
from avjepa_tpu_torch.data.synthetic import SyntheticAVDataset
from avjepa_tpu_torch.masks.multiblock3d import MaskSet, make_mask_collator, stack_masksets
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import DTYPES, make_encoder, make_predictor
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train.optim import ScheduleConfig
from avjepa_tpu_torch.train.state import TrainState, init_state
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils.checkpoint import (
    checkpoint_step,
    load_train_state,
    resume_source,
    save_train_state,
)
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, StepTimer, get_logger
from avjepa_tpu_torch.utils.monitoring import ResourceMonitor

CSV_COLUMNS = (
    ("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"), ("%.5f", "loss-jepa"),
    ("%.5f", "reg-loss"), ("%.2e", "enc-grad-norm"), ("%.2e", "pred-grad-norm"),
    ("%.2e", "grad-avg"), ("%.2e", "grad-first-qkv"), ("%.2e", "grad-last-qkv"),
    ("%.2e", "opt-mu-abs"), ("%.2e", "opt-nu-abs"), ("%.1f", "step-time-ms"),
    ("%.1f", "iter-time-ms"),
    # 1 when the diagnostic columns were computed this step; 0 when
    # tpu.light_metrics carried them forward from the last full step
    ("%d", "full-metrics"),
)


def build_models(cfg: ExperimentConfig, layout) -> tuple[Encoder, Predictor]:
    """Encoder and predictor on the CPU, seeded from ``meta.seed``."""
    if cfg.meta.dtype == "float16":
        get_logger("avjepa_tpu_torch").warning(
            "meta.dtype float16 runs as bfloat16 (bf16's range needs no loss scaling)")
    common = dict(uniform_power=cfg.model.uniform_power, dtype=DTYPES[cfg.meta.dtype],
                  attn_impl=cfg.tpu.attn_impl, gelu=cfg.tpu.gelu, remat=cfg.tpu.remat)
    encoder = make_encoder(cfg.model.model_name, layout, seed=cfg.meta.seed, **common)
    predictor = make_predictor(
        cfg.model.model_name, layout, pred_depth=cfg.model.pred_depth,
        pred_embed_dim=cfg.model.pred_embed_dim,
        use_mask_tokens=cfg.model.use_mask_tokens, num_mask_tokens=max(2, len(cfg.mask)),
        zero_init_mask_tokens=cfg.model.zero_init_mask_tokens, seed=cfg.meta.seed + 1,
        **common,
    )
    return encoder, predictor


def build_dataset(cfg: ExperimentConfig, layout):
    if cfg.data.source == "synthetic" or not cfg.data.datasets:
        return SyntheticAVDataset(layout, length=max(10_000, cfg.data.batch_size * 4))
    from avjepa_tpu_torch.data.av_dataset import AVFileDataset

    return AVFileDataset(
        csv_paths=list(cfg.data.datasets),
        layout=layout,
        frames_per_clip=cfg.data.num_frames,
        frame_step=cfg.data.sampling_rate,
        num_clips=cfg.data.num_clips,
        random_clip_sampling=True,
        filter_short_videos=cfg.data.filter_short_videos,
        filter_long_videos=cfg.data.filter_long_videos,
        duration=cfg.data.clip_duration,
        crop_size=cfg.data.crop_size,
        random_resize_scale=tuple(cfg.data_aug.random_resize_scale),
        random_resize_aspect_ratio=tuple(cfg.data_aug.random_resize_aspect_ratio),
        motion_shift=cfg.data_aug.motion_shift,
        horizontal_flip=cfg.data_aug.horizontal_flip,
        reprob=cfg.data_aug.reprob,
        auto_augment=cfg.data_aug.auto_augment,
    )


@dataclasses.dataclass
class TrainHandles:
    """Everything a driver needs to run or inspect training."""

    cfg: ExperimentConfig
    device: torch.device
    state: TrainState
    sched: ScheduleConfig
    step_cfg: StepConfig
    loader: BatchLoader
    mask_collator: object

    def to_device(self, video, audio, masks: list[MaskSet]):
        """Host batch -> device tensors: pixels cast to the compute dtype on
        the device; dense masks and the compact index arrays. Pixels may
        also come as tensors already on the device. With
        num_clips > 1 the clips stack along batch and each sample's masks
        are reused for its clips (reference: app/avjepa/train.py:397-423)."""
        c = self.cfg.data.num_clips
        if c > 1:
            video = np.concatenate(np.split(np.asarray(video), c, axis=1), axis=0)
            if audio is not None:
                audio = np.concatenate([np.asarray(audio)] * c, axis=0)

            def rep(a):
                return None if a is None else np.concatenate([a] * c, axis=0)

            masks = [MaskSet(rep(m.enc), rep(m.pred), rep(m.enc_idx), rep(m.union_idx))
                     for m in masks]
        enc, pred, idx, union = stack_masksets(masks, with_idx=True)
        dev, dt = self.device, DTYPES[self.cfg.meta.dtype]

        def put(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(dev, non_blocking=True)

        return dict(
            video=put(video).to(dt),
            audio=None if audio is None else put(audio).to(dt),
            enc_masks=put(enc),
            pred_masks=put(pred),
            enc_idx=tuple(put(i) for i in idx) if idx is not None and self.cfg.tpu.compact_context
            else None,
            union_idx=put(union) if union is not None and self.cfg.tpu.compact_predictor
            else None,
        )

    def step(self, video, audio, masks: list[MaskSet], full_metrics: bool = True) -> dict:
        """One train step from a host batch; returns its metrics."""
        return train_step(self.state, self.sched, self.step_cfg,
                          **self.to_device(video, audio, masks), full_metrics=full_metrics)


def setup(cfg: ExperimentConfig, device: torch.device) -> TrainHandles:
    mesh = dist.make_mesh(cfg.tpu.mesh_data, cfg.tpu.mesh_fsdp, cfg.tpu.mesh_tensor, device)
    layout = cfg.layout()
    encoder, predictor = build_models(cfg, layout)
    for module in (encoder, predictor):
        dist.broadcast_module(module.to(device))
    state = init_state(encoder.to(device), predictor.to(device),
                       betas=tuple(cfg.optimization.betas), eps=cfg.optimization.eps,
                       mesh=mesh)
    opt = cfg.optimization
    sched = ScheduleConfig(
        ipe=opt.ipe, num_epochs=opt.epochs, ipe_scale=opt.ipe_scale, warmup_epochs=opt.warmup,
        start_lr=opt.start_lr, ref_lr=opt.lr, final_lr=opt.final_lr, ref_wd=opt.weight_decay,
        final_wd=opt.final_weight_decay, ema_start=opt.ema[0], ema_end=opt.ema[1],
    )
    step_cfg = StepConfig(loss_exp=cfg.loss.loss_exp, reg_coeff=cfg.loss.reg_coeff,
                          clip_grad=opt.clip_grad, warmup_epochs=int(opt.warmup), ipe=opt.ipe)
    dataset = build_dataset(cfg, layout)
    collator = make_mask_collator(cfg.data.mask_type or cfg.tpu.mask_type, cfg.mask, layout,
                                  base_seed=cfg.meta.seed,
                                  sticky_buckets=cfg.tpu.sticky_mask_buckets)
    weights = None
    if cfg.data.datasets_weights is not None and hasattr(dataset, "sample_weights"):
        weights = dataset.sample_weights(cfg.data.datasets_weights)
    # data.batch_size is per rank of a batch group: each loads its shard's
    # local batch, and a tensor group's ranks the same one
    sampler = ShardedSampler(len(dataset), cfg.data.batch_size, shuffle=True,
                             seed=cfg.meta.seed, num_shards=mesh.batch,
                             shard_index=mesh.batch_rank, weights=weights)
    # media files decode in worker processes, synthetic clips in threads (the
    # JAX app's rule)
    loader = BatchLoader(dataset, sampler, num_workers=cfg.data.num_workers,
                         mask_collator=collator,
                         use_processes=cfg.data.source != "synthetic" and cfg.data.num_workers > 1)
    return TrainHandles(cfg, device, state, sched, step_cfg, loader, collator)


def resume(cfg: ExperimentConfig, state: TrainState) -> Optional[str]:
    """``meta.load_checkpoint``'s restore of ``state``: from the run's own
    ``<tag>-latest.pth.tar`` or the JAX app's ``<tag>-ckpt`` beside it,
    whichever holds the later step (the ``.pth.tar`` on a tie), else from
    ``meta.read_checkpoint`` (a ``.pth.tar`` or an Orbax directory); a
    missing one leaves the fresh init. Returns the checkpoint read."""
    logger = get_logger("avjepa_tpu_torch")
    folder, tag = cfg.logging.folder, cfg.logging.write_tag
    src = resume_source(os.path.join(folder, f"{tag}-latest.pth.tar")) or cfg.meta.read_checkpoint
    if src and checkpoint_step(src) is not None:
        load_train_state(src, state)
        logger.info(f"resumed from step {state.step} ({src})")
        return src
    if src:
        logger.warning(f"read_checkpoint {src} not found; fresh init")
    return None


def run(cfg: ExperimentConfig, max_steps: Optional[int] = None,
        device: str | torch.device = "cuda") -> dict:
    """The pretraining loop; returns summary metrics."""
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    rank = dist.rank()
    # the raw SIGTERM flag of this rank; the loop acts on the value agreed
    # over the ranks, polled at the same step on each (every 8 steps when
    # there are several: the agreement is a blocking collective), so that no
    # rank stops alone while the others wait in the next step's collectives
    preempted = {"flag": False}
    poll_steps = 8 if dist.world() > 1 else 1

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
        logger.warning("SIGTERM received: checkpointing at next step boundary")

    def _preempt_agreed() -> bool:
        return dist.agree(preempted["flag"]) if dist.world() > 1 else preempted["flag"]

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread
        prev_handler = None

    handles = data_iter = monitor = None
    try:
        folder, tag = cfg.logging.folder, cfg.logging.write_tag
        os.makedirs(folder, exist_ok=True)
        if cfg.data.log_resource_utilization:
            monitor = ResourceMonitor(
                log_path=os.path.join(folder, f"{tag}_resources_r{rank}.csv")).start()
        handles = setup(cfg, device)
        state = handles.state
        csv_logger = CSVLogger(os.path.join(folder, f"{tag}_r{rank}.csv"), *CSV_COLUMNS)
        latest = os.path.join(folder, f"{tag}-latest.pth.tar")
        if cfg.meta.load_checkpoint:
            resume(cfg, state)

        ipe = cfg.optimization.ipe
        start_epoch = state.step // ipe
        # fast-forward the mask collator counter (reference: train.py:326-330)
        handles.mask_collator.set_counter(state.step - 1)
        logger.info(
            f"encoder params: {sum(p.numel() for p in state.encoder.parameters()):,} | "
            f"predictor params: {sum(p.numel() for p in state.predictor.parameters()):,}"
        )

        total = 0
        summary: dict = {}
        last_full: dict = {}
        loss_meter = AverageMeter()
        data_iter = iter(handles.loader)
        for _ in range(cfg.data.skip_batches):
            try:
                next(data_iter)
            except StopIteration:
                data_iter = iter(handles.loader)
        for epoch in range(start_epoch, cfg.optimization.epochs):
            handles.loader.set_epoch(epoch)
            loss_meter.reset()
            time_meter = AverageMeter()
            for itr in range(ipe):
                t_iter = time.perf_counter()
                try:
                    video, audio, _, masks = next(data_iter)
                except StopIteration:
                    data_iter = iter(handles.loader)
                    video, audio, _, masks = next(data_iter)
                full = (not cfg.tpu.light_metrics) or itr % cfg.logging.log_freq == 0
                with StepTimer() as t:
                    metrics = handles.step(video, audio, masks, full_metrics=full)
                if full:
                    last_full = metrics
                iter_ms = (time.perf_counter() - t_iter) * 1000
                loss = metrics["loss"]
                loss_meter.update(loss)
                time_meter.update(t.elapsed_ms)

                def _stat(key):
                    return float(metrics.get(key, last_full.get(key, np.nan)))

                csv_logger.log(
                    epoch + 1, itr, loss, metrics["loss_jepa"], metrics["loss_reg"],
                    metrics["enc_grad_norm"], metrics["pred_grad_norm"], _stat("enc_grad_avg"),
                    _stat("enc_grad_first_qkv"), _stat("enc_grad_last_qkv"),
                    _stat("opt_mu_abs"), _stat("opt_nu_abs"), t.elapsed_ms, iter_ms, int(full),
                )
                if itr % cfg.logging.log_freq == 0:
                    logger.info(
                        f"[{epoch + 1}, {itr:5d}] loss: {loss_meter.avg:.3f} "
                        f"| p{metrics['loss_jepa']:.3f} r{metrics['loss_reg']:.3f} "
                        f"| input_var: {metrics['input_var']:.3f} "
                        f"| masks: {np.array2string(np.asarray(metrics['mask_sizes']), precision=0)} "
                        f"[wd: {metrics['wd']:.2e}] [lr: {metrics['lr']:.2e}] "
                        f"[g: {metrics['enc_grad_avg']:.2e} "
                        f"f{metrics['enc_grad_first_qkv']:.2e} "
                        f"l{metrics['enc_grad_last_qkv']:.2e}] "
                        f"[step: {time_meter.avg:.1f} ms]"
                    )
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss is not finite at step {state.step}")
                total += 1
                if max_steps is not None and total >= max_steps:
                    break
                if total % poll_steps == 0 and _preempt_agreed():
                    break
            stop = max_steps is not None and total >= max_steps
            # one agreed reading for the whole epilogue: the raw flag can flip
            # on one rank while the others are past their poll
            preempt_now = _preempt_agreed()
            if (epoch % cfg.logging.checkpoint_freq == 0 or epoch == cfg.optimization.epochs - 1
                    or stop or preempt_now):
                meta = dict(epoch=epoch + 1, loss=loss_meter.avg, batch_size=cfg.data.batch_size,
                            lr=float(metrics["lr"]), world_size=state.mesh.batch)
                # every rank gathers the sharded state; rank 0 writes
                save_train_state(latest, state, **meta)
                if cfg.logging.save_every_freq > 0 and epoch % cfg.logging.save_every_freq == 0:
                    save_train_state(os.path.join(folder, f"{tag}-ep{epoch + 1}.pth.tar"),
                                     state, **meta)
                dist.barrier()
            summary = {"epoch": epoch + 1, "avg_loss": loss_meter.avg,
                       "avg_step_ms": time_meter.avg, "step": state.step, "checkpoint": latest}
            if stop:
                break
            if preempt_now:
                logger.warning(
                    f"preempted: checkpoint saved at step {state.step}; restart with "
                    "meta.load_checkpoint: true to resume"
                )
                summary["preempted"] = True
                break
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if monitor is not None:
            monitor.stop()
        if data_iter is not None:
            data_iter.close()  # stops the loader's producer thread
        if handles is not None:
            handles.loader.close()
    return summary


def main(args, resume_preempt: bool = False, device: str | torch.device = "cuda"):
    """App entry (reference: app/avjepa/train.py main): a config dict or
    path; runs on ``device`` (the GPU unless the CPU is asked for)."""
    cfg = args if isinstance(args, ExperimentConfig) else load_config(args)
    if resume_preempt:
        cfg.meta.load_checkpoint = True
    return run(cfg, device=device)
