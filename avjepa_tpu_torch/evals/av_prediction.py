"""AV-prediction reconstruction eval: held out and deterministic.

    python -m avjepa_tpu_torch.app.eval_main --fname <cfg with eval_name: av_prediction>

Counterpart of ``avjepa_tpu/evals/av_prediction.py:52-261`` (the reference's
eval.py is a stub). The data contract the training pipeline does not have:
- uniform clip windows and a deterministic center crop (file data), or a
  synthetic stream disjoint from training's (seed ``meta.seed + 101``,
  length ``max(256, 8 * batch)``);
- an unshuffled sampler;
- a fresh mask collator with ``base_seed = meta.seed + 101`` and its counter
  at -1, so the masks are the same run to run;
- a strict probe restore: every probe parameter must be in
  ``<folder>/<tag>-probe-latest.pth.tar`` (or the JAX app's
  ``<tag>-probe-ckpt`` beside it, when that holds a later step) with its
  shape, so a random probe never passes for a trained one; a missing
  checkpoint raises, and so does a
  missing JEPA checkpoint (``require_jepa``, by default ``require_probe``).

Metrics per modality over EVERY mask config of ``cfg.mask`` (mask index
``mi`` for config ``mi``), averaged, with the per-config values beside:
full-frame video MSE and PSNR (fixed range 4.0: normalized pixels span about
[-2.1, 2.6]), full-spectrogram audio MSE and PSNR (fixed range 80 dB, mel
``top_db=80``). The summary keys are the JAX package's.

Data parallel (``parallel/dist.py``): each rank scores its shard of the
sampler, and the MSEs are averaged over every rank's batches; under
``tpu.mesh_fsdp`` and ``tpu.mesh_tensor`` the frozen models are sharded as
the app shards them, and a tensor group's ranks score one shard, of
``batch_size x mesh_data x mesh_fsdp`` clips a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from avjepa_tpu_torch.config import ExperimentConfig, load_config
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler
from avjepa_tpu_torch.data.synthetic import SyntheticAVDataset
from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train import avprediction
from avjepa_tpu_torch.utils.checkpoint import load_probe_state, resume_source
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import AverageMeter, get_logger

# fixed PSNR dynamic ranges (module docstring)
_VIDEO_RANGE = 4.0
_AUDIO_RANGE_DB = 80.0


def build_eval_loader(cfg: ExperimentConfig, layout, seed_salt: int = 101,
                      mesh: Optional[dist.Mesh] = None) -> BatchLoader:
    """Deterministic eval loader: uniform clip windows and a center crop (or
    a held-out synthetic stream), no shuffle, a seeded mask collator. The
    file branch reads ``data.val_datasets``, else the training split
    ``data.datasets`` with a warning (metrics are then not held out). Each
    rank of ``mesh``'s batch group (of the world without one) takes its
    shard."""
    seed = cfg.meta.seed + seed_salt
    if cfg.data.source == "synthetic" or not (cfg.data.val_datasets or cfg.data.datasets):
        dataset = SyntheticAVDataset(layout, length=max(256, cfg.data.batch_size * 8), seed=seed)
    else:
        from avjepa_tpu_torch.data.av_dataset import AVFileDataset
        from avjepa_tpu_torch.serve.extract import DeterministicClipTransform

        csvs = cfg.data.val_datasets
        if not csvs:
            get_logger("avjepa_tpu_torch").warning(
                "data.val_datasets is unset; evaluating on the TRAINING split "
                "(data.datasets): metrics are not held out")
            csvs = cfg.data.datasets
        dataset = AVFileDataset(
            csv_paths=list(csvs), layout=layout, frames_per_clip=cfg.data.num_frames,
            frame_step=cfg.data.sampling_rate, num_clips=1, random_clip_sampling=False,
            filter_short_videos=cfg.data.filter_short_videos,
            filter_long_videos=cfg.data.filter_long_videos, duration=cfg.data.clip_duration,
            crop_size=cfg.data.crop_size, transform=DeterministicClipTransform(cfg.data.crop_size),
            seed=seed,
        )
    collator = make_mask_collator(cfg.data.mask_type or cfg.tpu.mask_type, cfg.mask, layout,
                                  base_seed=seed)
    collator.set_counter(-1)  # a fixed start: the same masks run to run
    shards, index = (dist.world(), dist.rank()) if mesh is None else (mesh.batch,
                                                                       mesh.batch_rank)
    sampler = ShardedSampler(len(dataset), cfg.data.batch_size, shuffle=False, seed=seed,
                             num_shards=shards, shard_index=index)
    return BatchLoader(dataset, sampler, num_workers=cfg.data.num_workers,
                       mask_collator=collator,
                       use_processes=cfg.data.source != "synthetic" and cfg.data.num_workers > 1)


def _psnr(mse: float, rng: float) -> float:
    return 10.0 * np.log10(max(1e-12, rng**2 / max(mse, 1e-12)))


def run(cfg: ExperimentConfig, max_batches: int = 50, require_probe: bool = True,
        require_jepa: Optional[bool] = None, device: str | torch.device = "cuda") -> dict:
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    handles, state, _ = avprediction.setup_probe(cfg, device)
    handles.loader.close()  # the eval reads its own loader
    if require_jepa is None:
        require_jepa = require_probe
    avprediction.restore_jepa_weights(handles, cfg, logger, require=require_jepa)
    path = avprediction.probe_path(cfg)
    try:
        path = resume_source(path) or path
        load_probe_state(path, state)
        logger.info(f"loaded trained probe from {path}")
    except FileNotFoundError:
        if require_probe:
            raise
        logger.warning(f"no trained probe at {path!r}; evaluating the INIT probe "
                       "(require_probe=False)")

    layout = cfg.layout()
    num_cfgs = len(cfg.mask)
    encoder, predictor = handles.state.target_encoder, handles.state.predictor
    v_meters = [AverageMeter() for _ in range(num_cfgs)]
    a_meters = [AverageMeter() for _ in range(num_cfgs)]
    loader = build_eval_loader(cfg, layout, mesh=handles.state.mesh)
    data_iter = iter(loader)
    try:
        for bi, (video, audio, _, masks) in enumerate(data_iter):
            if bi >= max_batches:
                break
            v, a, enc, pred = avprediction.batch_to_device(video, audio, masks, device)
            mses = []
            with torch.no_grad():
                for mi in range(num_cfgs):
                    full = avprediction.frozen_tokens(encoder, predictor, v, a, enc[mi],
                                                      pred[mi], mi)
                    mses.extend(avprediction.reconstruction_mse(state.probe, full, v, a))
            values = torch.stack(mses).tolist()  # one device sync a batch
            for mi in range(num_cfgs):
                v_meters[mi].update(values[2 * mi])
                a_meters[mi].update(values[2 * mi + 1])
    finally:
        data_iter.close()
        loader.close()

    # per-config means over every rank's batches (equal in number and size)
    totals = dist.reduce(torch.tensor([m.sum for m in v_meters + a_meters]
                                      + [v_meters[0].count], dtype=torch.float64), "sum",
                         handles.state.batch_group)
    *sums, num_batches = totals.tolist()
    mse_v_per = [x / max(num_batches, 1) for x in sums[:num_cfgs]]
    mse_v = float(np.mean(mse_v_per))
    summary = {
        "mse_video": mse_v,
        "psnr_video_db": _psnr(mse_v, _VIDEO_RANGE),
        "mse_video_per_mask": mse_v_per,
        "num_batches": int(num_batches),
    }
    msg = (f"[av_prediction eval] video MSE {mse_v:.5f} ({summary['psnr_video_db']:.1f} dB) "
           f"over {num_cfgs} mask cfgs")
    if layout.audio_enabled:
        mse_a_per = [x / max(num_batches, 1) for x in sums[num_cfgs:]]
        mse_a = float(np.mean(mse_a_per))
        summary.update(mse_audio=mse_a, psnr_audio_db=_psnr(mse_a, _AUDIO_RANGE_DB),
                       mse_audio_per_mask=mse_a_per)
        msg += f" | audio MSE {mse_a:.5f} ({summary['psnr_audio_db']:.1f} dB)"
    logger.info(msg)
    return summary


def main(args, resume_preempt: bool = False, device: str | torch.device = "cuda") -> dict:
    cfg = args if isinstance(args, ExperimentConfig) else load_config(args)
    return run(cfg, device=device)
