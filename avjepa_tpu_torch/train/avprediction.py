"""The avprediction app: frozen-JEPA pixel/spectrogram reconstruction.

    python -m avjepa_tpu_torch.app.main --fname configs/pretrain/av-vitl16_prediction.yaml

Counterpart of ``avjepa_tpu/train/avprediction.py:54-377`` (reference:
app/avprediction/train.py + utils.py): load a pretrained JEPA checkpoint,
freeze the target encoder and the predictor, rebuild the full token
sequence from context embeddings and predicted embeddings, and train an
``AttentionProbe`` to reconstruct the raw video pixels and the mel
spectrogram with MSE. The rebuild is one ``where`` over the dense masks:
the encoder runs dense over all N tokens with the context key mask, the
predictor with mask config 0 and no ``gather_idx``; both under
``torch.no_grad()``, so no backward kernel runs. The probe is f32 (its
default, as in the JAX package) and takes the frozen tokens in f32; its
AdamW has no gradient clipping and uses the step-derived lr/wd schedules.

``meta.read_checkpoint`` names a ``.pth.tar`` (the pretrain app's output)
or a JAX pretrain Orbax directory (``<tag>-ckpt``). The probe is saved at
the end of every epoch to ``<folder>/<tag>-probe-latest.pth.tar``; with
``resume_preempt`` a run restores it, or the JAX app's
``<tag>-probe-ckpt`` when that holds a later step, and resumes at
``step // ipe``.

``example_main`` is the avprediction_example app (inference and
visualization twin).

Data parallel (``parallel/dist.py``): each rank trains on its shard of the
pretrain app's sampler, the probe's gradients are averaged over the ranks
in one all-reduce (the frozen models have none), the logged losses are the
global means, each rank writes ``<tag>_probe_r{rank}.csv``, and rank 0 alone
writes the probe checkpoint and the example's files. Under ``tpu.mesh_fsdp``
the frozen target encoder and predictor are sharded
(``parallel/fsdp.py``, as ``avjepa_tpu/train/avprediction.py:123-140``
shards them) and the JEPA checkpoint is loaded into the shards; under
``tpu.mesh_tensor`` they hold their ranks' pieces of the Megatron layers
(``parallel/tensor.py``), a tensor group's ranks load one batch, and the
reductions run over the batch group. The probe stays replicated. The global
batch is ``batch_size x mesh_data x mesh_fsdp``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from avjepa_tpu_torch.config import ExperimentConfig, load_config
from avjepa_tpu_torch.masks.multiblock3d import stack_masksets
from avjepa_tpu_torch.models.prediction_probes import AttentionProbe, init_probe_
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train import pretrain
from avjepa_tpu_torch.train.optim import ScheduleConfig, lr_at_step, make_optimizer, set_lr_wd, wd_at_step
from avjepa_tpu_torch.utils.checkpoint import (
    load_jepa_weights,
    load_probe_state,
    resume_source,
    save_probe_state,
)
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger

CSV_COLUMNS = (("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"), ("%.5f", "loss-video"),
               ("%.5f", "loss-audio"))


@dataclasses.dataclass
class ProbeState:
    probe: AttentionProbe
    optimizer: torch.optim.AdamW
    step: int = 0
    # the ranks over which a step's batch is spread (None: the world)
    batch_group: Optional[dist.Group] = None


def probe_path(cfg: ExperimentConfig) -> str:
    return os.path.join(cfg.logging.folder, f"{cfg.logging.write_tag}-probe-latest.pth.tar")


def setup_probe(cfg: ExperimentConfig, device: torch.device):
    """(pretrain handles, probe state, probe schedule): the pretrain app's
    set-up (models, loader, collator), plus an ``AttentionProbe`` over the
    encoder width, seeded from ``meta.seed + 1``, and its AdamW (default
    betas and eps, as JAX ``adamw_update``)."""
    handles = pretrain.setup(cfg, device)
    layout = cfg.layout()
    emb_dim = handles.state.encoder.norm.normalized_shape[0]
    probe = init_probe_(AttentionProbe(layout, emb_dim=emb_dim), cfg.meta.seed + 1).to(device)
    dist.broadcast_module(probe)
    opt = cfg.optimization
    sched = ScheduleConfig(
        ipe=opt.ipe, num_epochs=opt.epochs, ipe_scale=opt.ipe_scale, warmup_epochs=opt.warmup,
        start_lr=opt.start_lr, ref_lr=opt.lr, final_lr=opt.final_lr, ref_wd=opt.weight_decay,
        final_wd=opt.final_weight_decay,
    )
    return handles, ProbeState(probe, make_optimizer([probe]),
                               batch_group=handles.state.batch_group), sched


def restore_jepa_weights(handles, cfg: ExperimentConfig, logger, require: bool = False) -> bool:
    """Load the frozen target encoder and predictor from
    ``meta.read_checkpoint`` (a ``.pth.tar`` or a JAX ``<tag>-ckpt``
    directory, which raises without a committed step) into
    ``handles.state``; True when loaded. A missing file warns loudly (the
    frozen models would be the random init) or, with ``require`` (the
    eval), raises FileNotFoundError."""
    path = cfg.meta.read_checkpoint
    if path and (os.path.isfile(path) or os.path.isdir(path)):
        load_jepa_weights(path, handles.state.target_encoder, handles.state.predictor)
        logger.info(f"restored frozen JEPA weights from {path}")
        return True
    msg = (f"no pretrained JEPA checkpoint at meta.read_checkpoint={path!r}; the frozen "
           "encoder/predictor are RANDOMLY INITIALIZED")
    if require:
        raise FileNotFoundError(msg)
    logger.warning(msg)
    return False


@torch.no_grad()
def frozen_tokens(encoder, predictor, video, audio, enc_m, pred_m, mask_index: int = 0):
    """The rebuilt sequence [B, N, D]: encoder embeddings at context
    positions, predictions at target positions, 0 elsewhere (JAX
    ``frozen_tokens``). Dense over N: the encoder takes the context key mask,
    the predictor mask config ``mask_index``, neither a ``gather_idx``."""
    ctx = encoder(video, audio, key_mask=enc_m)
    z = predictor(ctx, enc_m, pred_m, mask_index)
    return torch.where(enc_m[..., None], ctx, torch.where(pred_m[..., None], z, 0.0))


def reconstruction_mse(probe, full, video, audio) -> tuple[torch.Tensor, torch.Tensor]:
    """(video MSE, audio MSE) of the probe's reconstructions, f32 means over
    [B, T, H, W, 3] and [B, Hs, Ws, 1]; audio 0 for video-only layouts."""
    video_recon, audio_recon = probe(full.float())
    loss_v = ((video_recon.float() - video.float()) ** 2).mean()
    if audio is None or audio_recon is None:
        return loss_v, torch.zeros((), device=loss_v.device)
    return loss_v, ((audio_recon.float() - audio.float()) ** 2).mean()


def probe_step(state: ProbeState, sched: ScheduleConfig, encoder, predictor, video, audio,
               enc_masks, pred_masks) -> dict:
    """One probe step in place on ``state`` (JAX ``make_probe_step``) on mask
    config 0; returns its metrics as Python numbers, means over the global
    batch."""
    lr, wd = lr_at_step(sched, state.step), wd_at_step(sched, state.step)
    full = frozen_tokens(encoder, predictor, video, audio, enc_masks[0], pred_masks[0], 0)
    state.optimizer.zero_grad(set_to_none=True)
    loss_v, loss_a = reconstruction_mse(state.probe, full, video, audio)
    loss = loss_v + loss_a
    loss.backward()
    dist.all_reduce_grads([state.probe], state.batch_group)
    set_lr_wd(state.optimizer, lr, wd)
    state.optimizer.step()
    state.step += 1
    values = dist.reduce(torch.stack([loss, loss_v, loss_a]).detach(), "mean",
                         state.batch_group).tolist()
    return {"loss": values[0], "loss_video": values[1], "loss_audio": values[2], "lr": lr}


def batch_to_device(video, audio, masks, device: torch.device):
    """Host batch -> (video f32, audio f32 or None, enc [M, B, N], pred
    [M, B, N]) on ``device``; the encoder casts the pixels to its dtype, the
    losses read them in f32."""
    enc, pred = stack_masksets(masks)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)

    return put(video), None if audio is None else put(audio), put(enc), put(pred)


def run(cfg: ExperimentConfig, max_steps: Optional[int] = None, resume_preempt: bool = False,
        device: str | torch.device = "cuda") -> dict:
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    handles, state, sched = setup_probe(cfg, device)
    data_iter = None
    try:
        folder, tag = cfg.logging.folder, cfg.logging.write_tag
        os.makedirs(folder, exist_ok=True)
        restore_jepa_weights(handles, cfg, logger)
        encoder, predictor = handles.state.target_encoder, handles.state.predictor
        csv_logger = CSVLogger(os.path.join(folder, f"{tag}_probe_r{dist.rank()}.csv"),
                               *CSV_COLUMNS)
        path = probe_path(cfg)
        last_saved, start_epoch = -1, 0
        ipe, epochs = cfg.optimization.ipe, cfg.optimization.epochs
        src = resume_source(path) if resume_preempt else None
        if src is not None:
            load_probe_state(src, state)
            last_saved = state.step
            start_epoch = min(state.step // max(ipe, 1), epochs)
            logger.info(f"resumed probe from step {state.step} (epoch {start_epoch})")

        total = 0
        summary: dict = {}
        data_iter = iter(handles.loader)
        for epoch in range(start_epoch, epochs):
            handles.loader.set_epoch(epoch)
            meter = AverageMeter()
            for itr in range(ipe):
                try:
                    video, audio, _, masks = next(data_iter)
                except StopIteration:
                    data_iter = iter(handles.loader)
                    video, audio, _, masks = next(data_iter)
                metrics = probe_step(state, sched, encoder, predictor,
                                     *batch_to_device(video, audio, masks, device))
                meter.update(metrics["loss"])
                csv_logger.log(epoch + 1, itr, metrics["loss"], metrics["loss_video"],
                               metrics["loss_audio"])
                if itr % cfg.logging.log_freq == 0:
                    logger.info(f"[probe {epoch + 1}, {itr:5d}] loss {meter.avg:.4f} "
                                f"(v {metrics['loss_video']:.4f} a {metrics['loss_audio']:.4f})")
                if not np.isfinite(metrics["loss"]):
                    raise FloatingPointError(f"probe loss is not finite at step {state.step}")
                total += 1
                if max_steps is not None and total >= max_steps:
                    break
            if state.step != last_saved:
                if dist.is_main():
                    save_probe_state(path, state)
                dist.barrier()
                last_saved = state.step
            summary = {"epoch": epoch + 1, "avg_loss": meter.avg}
            if max_steps is not None and total >= max_steps:
                break
    finally:
        if data_iter is not None:
            data_iter.close()
        handles.loader.close()
    return summary


def main(args, resume_preempt: bool = False, device: str | torch.device = "cuda"):
    cfg = args if isinstance(args, ExperimentConfig) else load_config(args)
    return run(cfg, resume_preempt=resume_preempt, device=device)


def example_main(args, resume_preempt: bool = False, device: str | torch.device = "cuda") -> str:
    """The avprediction_example app (JAX ``example_main``, reference:
    app/avprediction_example/): load the trained probe, reconstruct one
    batch, write ``avprediction_example.npz`` (``video``, ``video_recon``,
    ``audio``, ``audio_recon`` of the first clip), and a PNG of frame 0 and
    the spectrogram when matplotlib is installed. Unlike the JAX app, which
    reconstructs through its randomly initialised models, it first loads the
    frozen JEPA weights the probe was trained on (ROADMAP.md §3). Under a
    process group every rank sets up; rank 0 alone reconstructs and writes."""
    cfg = args if isinstance(args, ExperimentConfig) else load_config(args)
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    handles, state, _ = setup_probe(cfg, device)
    folder = cfg.logging.folder
    out_path = os.path.join(folder, "avprediction_example.npz")
    if not dist.is_main():
        handles.loader.close()
        dist.barrier()
        return out_path
    try:
        return _example(cfg, device, logger, handles, state, out_path)
    finally:
        dist.barrier()


def _example(cfg: ExperimentConfig, device: torch.device, logger, handles, state,
             out_path: str) -> str:
    folder = cfg.logging.folder
    try:
        os.makedirs(folder, exist_ok=True)
        restore_jepa_weights(handles, cfg, logger)
        src = resume_source(probe_path(cfg))
        if src is not None:
            load_probe_state(src, state)
            logger.info(f"loaded trained probe from {src}")
        else:
            logger.warning(f"no trained probe at {probe_path(cfg)}; reconstructing with the "
                           "initial probe")
        data_iter = iter(handles.loader)
        try:
            video, audio, _, masks = next(data_iter)
        finally:
            data_iter.close()
    finally:
        handles.loader.close()
    v, a, enc, pred = batch_to_device(video, audio, masks, device)
    full = frozen_tokens(handles.state.target_encoder, handles.state.predictor, v, a, enc[0],
                         pred[0], 0)
    with torch.no_grad():
        video_recon, audio_recon = state.probe(full.float())
    video_recon = video_recon[0].cpu().numpy()
    audio_recon = None if audio_recon is None else audio_recon[0].cpu().numpy()

    np.savez(out_path, video=np.asarray(video[0]), video_recon=video_recon,
             audio=np.asarray(audio[0]) if audio is not None else np.zeros(1),
             audio_recon=audio_recon if audio_recon is not None else np.zeros(1))
    logger.info(f"wrote {out_path}")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.info("matplotlib unavailable; skipped PNG")
        return out_path
    with_audio = audio is not None and audio_recon is not None
    fig, axes = plt.subplots(2 if with_audio else 1, 2, figsize=(10, 8), squeeze=False)
    axes[0, 0].imshow(np.clip(np.asarray(video[0, 0]), 0, 1))
    axes[0, 0].set_title("original frame")
    axes[0, 1].imshow(np.clip(video_recon[0], 0, 1))
    axes[0, 1].set_title("reconstructed frame")
    if with_audio:
        axes[1, 0].imshow(np.asarray(audio[0, :, :, 0]), aspect="auto")
        axes[1, 0].set_title("original spectrogram")
        axes[1, 1].imshow(audio_recon[:, :, 0], aspect="auto")
        axes[1, 1].set_title("reconstructed spectrogram")
    png = os.path.join(folder, "avprediction_example.png")
    fig.savefig(png, dpi=100, bbox_inches="tight")
    plt.close(fig)
    logger.info(f"wrote {png}")
    return out_path
