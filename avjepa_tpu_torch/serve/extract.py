"""Frozen-encoder batch feature extraction: the serving app, one process per GPU.

    python -m avjepa_tpu_torch.app.main --fname configs/extract/vitl16_extract.yaml

Counterpart of ``avjepa_tpu/serve/extract.py``, with the same config, the
same output files and the same fields. A config names a reference-layout
checkpoint (``meta.read_checkpoint``, a ``.pth.tar``) or allows a random
encoder (``extract.allow_random``), and a CSV of media files
(``data.datasets``) or ``data.source: synthetic``. Every clip streams through
the frozen (by default EMA/target) encoder in ``meta.dtype``; the tokens get
the parameter-free feature LayerNorm and, with ``pooling: mean``, the mean
over tokens.

Design:
  - the encoder runs eagerly in PyTorch on each rank's device; its attention
    layers launch the port's CUDA kernels (``ops/flash_attention.py``);
  - each rank (``parallel/dist.py``) encodes its shard of the unshuffled
    sampler, ``data.batch_size`` clips a batch, and writes the rows it owns
    (row ``r`` belongs to rank ``r % world``, as in the JAX package) to its
    own ``_r{rank}`` files: the ranks' files hold every row once;
  - the sampler wrap-pads the final partial batch so every batch has the
    same shape; rows are deduplicated by id on write;
  - host ingest decodes ahead of the device, media files in worker
    processes and synthetic clips in threads, with a deterministic
    transform (short-side resize, fixed crop, normalize, uniform clip
    window) so embeddings are reproducible run to run.

Outputs under ``extract.output`` (default <logging.folder>/<tag>-features),
one set a rank:
  - pooling 'mean': features_r{rank}.npz {indices, embeddings [n, D]} when
    the rows fit in one ``extract.chunk_rows`` chunk, else
    features_r{rank}_{k}.npz
  - pooling 'tokens': tokens_r{rank}_{k}.npz {indices, embeddings [n, N, D]}
  - index_r{rank}.csv: row -> media path, label
  - missing_r{rank}.csv: owned rows that produced no embedding (undecodable
    files)
  - summary_r{rank}.json: row counts, dim, clips/sec, device
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from avjepa_tpu_torch.config import ExperimentConfig, dump_config, load_config
from avjepa_tpu_torch.data.loader import BatchLoader, ShardedSampler
from avjepa_tpu_torch.data.synthetic import SyntheticAVDataset
from avjepa_tpu_torch.data.transforms import EvalVideoTransform
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import DTYPES, VIT_SPECS, make_encoder
from avjepa_tpu_torch.parallel import dist
from avjepa_tpu_torch.train.step import feature_layer_norm
from avjepa_tpu_torch.utils.checkpoint import load_encoder_checkpoint
from avjepa_tpu_torch.utils.device import resolve_device
from avjepa_tpu_torch.utils.logging import get_logger


class DeterministicClipTransform:
    """Short-side resize + single fixed crop + normalize (no random crop or
    flip), so the same file gives the same embedding. Accepts the dataset's
    ``(clip, rng)`` calling convention and ignores the rng."""

    def __init__(self, crop_size: int):
        self._t = EvalVideoTransform(num_views=1, short_side=crop_size, crop_size=crop_size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        return np.asarray(self._t(clip)[0], np.float32)


class _IndexedView:
    """Dataset wrapper: caps length and returns the dataset INDEX in the
    label slot, so a batch maps rows back to files even through
    retry-resample (a failed decode reports the index it resampled)."""

    def __init__(self, ds, limit=None):
        self.ds = ds
        self.n = len(ds) if limit is None else min(int(limit), len(ds))

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        video, mel, _label = self.ds[idx]
        return video, mel, int(idx)


def _build_dataset(cfg: ExperimentConfig, layout):
    if cfg.data.source == "synthetic" or not cfg.data.datasets:
        ds = SyntheticAVDataset(layout, length=max(64, cfg.data.batch_size * 4))
        paths = [f"synthetic://{i}" for i in range(len(ds))]
        return ds, paths, np.zeros(len(ds), np.int64)
    from avjepa_tpu_torch.data.av_dataset import AVFileDataset

    ds = AVFileDataset(
        csv_paths=list(cfg.data.datasets),
        layout=layout,
        frames_per_clip=cfg.data.num_frames,
        frame_step=cfg.data.sampling_rate,
        num_clips=1,
        random_clip_sampling=False,  # deterministic uniform clip window
        filter_short_videos=cfg.data.filter_short_videos,
        filter_long_videos=cfg.data.filter_long_videos,
        duration=cfg.data.clip_duration,
        crop_size=cfg.data.crop_size,
        transform=DeterministicClipTransform(cfg.data.crop_size),
        seed=cfg.meta.seed,
    )
    return ds, list(ds.paths), np.asarray(ds.labels)


def build_loader(cfg: ExperimentConfig, view: _IndexedView, rank: int = 0,
                 world: int = 1) -> BatchLoader:
    """This rank's loader over ``view``: its shard of the unshuffled rows,
    wrap-padded to whole batches; media files decode in worker processes,
    synthetic clips in threads (the JAX app's rule)."""
    sampler = ShardedSampler(
        dataset_len=len(view),
        batch_size=cfg.data.batch_size,
        shuffle=False,
        seed=cfg.meta.seed,
        num_shards=world,
        shard_index=rank,
        drop_last=False,
    )
    return BatchLoader(view, sampler, num_workers=cfg.data.num_workers,
                       use_processes=cfg.data.source != "synthetic" and cfg.data.num_workers > 1)


def build_encoder(cfg: ExperimentConfig, device: torch.device) -> Encoder:
    """The frozen encoder of the config on ``device``: read from
    ``meta.read_checkpoint``, or random from ``meta.seed`` where
    ``extract.allow_random`` permits."""
    logger = get_logger("avjepa_tpu_torch")
    ex = cfg.extract
    encoder = make_encoder(
        cfg.model.model_name,
        cfg.layout(),
        uniform_power=cfg.model.uniform_power,
        dtype=DTYPES[cfg.meta.dtype],
        attn_impl=cfg.tpu.attn_impl,
        gelu=cfg.tpu.gelu,
        seed=cfg.meta.seed,
    )
    path = cfg.meta.read_checkpoint
    if path and (os.path.exists(path) or not ex.allow_random):
        prefer = "target_encoder" if ex.use_target_encoder else "encoder"
        encoder.load_state_dict(load_encoder_checkpoint(path, prefer), strict=True)
        logger.info(f"extract: loaded {prefer} from {path}")
    elif path:
        logger.warning(f"extract: no checkpoint at {path}; RANDOM encoder")
    elif not ex.allow_random:
        raise ValueError(
            "app: extract needs meta.read_checkpoint (or set "
            "extract.allow_random: true to embed with a random encoder)"
        )
    return encoder.to(device).eval().requires_grad_(False)


@torch.inference_mode()
def encode(encoder: Encoder, video: torch.Tensor, audio: torch.Tensor | None,
           ex) -> torch.Tensor:
    """Encoder in its dtype, then f32 feature LN and pooling."""
    h = encoder(video, audio).float()
    if ex.layer_norm:
        h = feature_layer_norm(h)
    if ex.pooling == "mean":
        h = h.mean(dim=1)
    return h


def main(args, resume_preempt: bool = False, device: str | torch.device = "cuda") -> dict:
    """Run the app on ``device`` (the GPU unless the caller asks for the
    CPU)."""
    cfg = args if isinstance(args, ExperimentConfig) else load_config(args)
    ex = cfg.extract
    rank, world = dist.rank(), dist.world()
    logger = get_logger("avjepa_tpu_torch")
    device = resolve_device(device)
    layout = cfg.layout()
    if cfg.meta.dtype == "float16":
        logger.warning(
            "meta.dtype float16 runs as bfloat16 (the JAX package's mapping) — "
            "embeddings are bf16-precision"
        )

    os.makedirs(cfg.logging.folder, exist_ok=True)
    if rank == 0:
        dump_config(cfg, os.path.join(cfg.logging.folder, "params-extract.yaml"))

    encoder = build_encoder(cfg, device)
    dim = VIT_SPECS[cfg.model.model_name].embed_dim

    ds, paths, labels = _build_dataset(cfg, layout)
    loader = build_loader(cfg, _IndexedView(ds, ex.limit), rank, world)
    n_total = len(loader.dataset)

    out_dir = ex.output or os.path.join(
        cfg.logging.folder, f"{cfg.logging.write_tag}-features"
    )
    os.makedirs(out_dir, exist_ok=True)

    written = np.zeros(n_total, bool)
    pending: list[tuple[int, np.ndarray]] = []
    emitted_files: list[str] = []
    chunk_id = 0
    is_mean = ex.pooling == "mean"
    prefix = "features" if is_mean else "tokens"

    def flush(force: bool = False):
        """Bounded-memory writer: at most ``extract.chunk_rows`` rows are held.
        A mean-mode run whose rows fit in ONE chunk writes the single-file
        ``features_r{rank}.npz`` (sorted by row); larger runs spill chunks."""
        nonlocal pending, chunk_id
        # mean holds until STRICTLY over a chunk, so an exactly-chunk-sized
        # run still gets the single-file name at force time
        trigger = ex.chunk_rows + 1 if is_mean else ex.chunk_rows
        while (pending and force) or len(pending) >= trigger:
            if is_mean and force and chunk_id == 0 and len(pending) <= ex.chunk_rows:
                part, pending = sorted(pending, key=lambda t: t[0]), []
                name = f"features_r{rank}.npz"
            else:
                part, pending = pending[: ex.chunk_rows], pending[ex.chunk_rows:]
                name = f"{prefix}_r{rank}_{chunk_id:05d}.npz"
                chunk_id += 1
            np.savez(
                os.path.join(out_dir, name),
                indices=np.asarray([i for i, _ in part], np.int64),
                embeddings=np.stack([e for _, e in part]),
            )
            emitted_files.append(name)

    t0 = time.time()
    n_clips = 0
    try:
        for video, audio, idx_batch in loader:
            v = torch.from_numpy(video).to(device)
            a = torch.from_numpy(audio).to(device) if audio is not None else None
            out = encode(encoder, v, a, ex).cpu().numpy()
            for row, emb in zip(idx_batch, out):
                row = int(row)
                # the sampler's shard padding can put a copy of another
                # rank's row in this shard: keep the rows this rank owns
                if row % world != rank or row >= n_total or written[row]:
                    continue  # another rank's row or a wrap-padded duplicate
                written[row] = True
                pending.append((row, emb))
            n_clips += len(idx_batch)
            flush()
    finally:
        loader.close()

    flush(force=True)
    if is_mean and chunk_id == 0 and f"features_r{rank}.npz" not in emitted_files:
        # zero rows: still write the (empty) single file for consumers
        np.savez(
            os.path.join(out_dir, f"features_r{rank}.npz"),
            indices=np.zeros(0, np.int64),
            embeddings=np.zeros((0, dim), np.float32),
        )
        emitted_files.append(f"features_r{rank}.npz")
    dt = time.time() - t0
    done_rows = np.nonzero(written)[0]
    with open(os.path.join(out_dir, f"index_r{rank}.csv"), "w") as f:
        f.write("row,path,label\n")
        for r in done_rows:
            f.write(f"{int(r)},{paths[int(r)]},{int(labels[int(r)])}\n")

    # rows that never arrived: retry-resample substitutes a DIFFERENT index
    # for a failed decode, which dedup discards; name every dropped row
    owned = np.arange(rank, n_total, world)
    missing = owned[~written[owned]]
    if missing.size:
        with open(os.path.join(out_dir, f"missing_r{rank}.csv"), "w") as f:
            f.write("row,path\n")
            for r in missing:
                f.write(f"{int(r)},{paths[int(r)]}\n")
        shown = ", ".join(paths[int(r)] for r in missing[:5])
        logger.warning(
            f"extract: {missing.size} row(s) produced no embedding (decode "
            f"failures) — see missing_r{rank}.csv. First: {shown}"
        )

    summary = {
        "rows_written": int(written.sum()),
        "rows_missing": int(missing.size),
        "rows_total": n_total,
        "dim": dim,
        "tokens": layout.num_tokens if ex.pooling == "tokens" else 1,
        "pooling": ex.pooling,
        "clips_per_sec": round(n_clips / max(dt, 1e-9), 3),
        "output": out_dir,
        "chunked": chunk_id > 0,
        "files": emitted_files,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    with open(os.path.join(out_dir, f"summary_r{rank}.json"), "w") as f:
        json.dump(summary, f)
    logger.info(f"extract: {summary}")
    return summary
