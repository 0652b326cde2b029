"""Host-side mask sampling (numpy) with dense static-shape output: the port's
copy of ``avjepa_tpu/masks/multiblock3d.py``, which gives the same masks and
indices from the same seed and counter.

Behavioral spec from the reference collators
(reference: src/masks/avmultiblock3d.py:70-234, src/masks/multiblock3d.py:60-203,
src/masks/random_tube.py:60-117):

per mask *config* and per batch:
  1. one block size (t, h, w) is sampled from a generator seeded by a shared
     step counter (so every data worker / host agrees on the block size);
  2. per sample, ``num_blocks`` blocks are dropped from the token grid
     (union); audio drops ``num_blocks`` fixed 4x6 blocks on its 8x12 grid;
  3. context = surviving tokens (clamped to the first
     ``max_temporal_keep * duration`` time steps), target = dropped tokens;
     empty contexts are rejected and resampled;
  4. every sample's keep-list is truncated to the batch-min length per tensor
     (and ``max_keep`` if set), taking the first-k indices in ascending order.

Divergence from the reference (the JAX package's): instead of ragged index
tensors it returns *dense boolean masks* over the static token layout (the
truncation semantics above are applied first, so the kept sets are
identical), plus bucket-padded index arrays for the compacted paths. The RNG
is numpy's (seeded, reproducible) rather than torch's global MT.

Block *locations*, not just sizes, are seeded by (base_seed, counter), so
every process draws identical masks for a given step (the reference varied
locations per rank).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from avjepa_tpu_torch.layout import TokenLayout


@dataclasses.dataclass
class MaskSet:
    """Dense masks for one mask config over the combined token sequence.

    enc/pred: [B, N] bool; enc ∧ pred = ∅; positions in neither are dropped by
    the batch-min truncation and excluded from both context and targets.

    enc_idx: [B, K_pad] int32 — ascending kept-token indices for the
    *compacted* context-encoder path, bucket-padded to a multiple of 128 with
    the out-of-range sentinel N (so scatters drop the padding). The
    per-batch count K is uniform across samples (min-keep truncation), so the
    compact sequence is rectangular by construction.
    """

    enc: np.ndarray
    pred: np.ndarray
    enc_idx: np.ndarray | None = None
    # [B, Ku_pad] int32 ascending enc∪pred indices (sentinel N padding) for
    # the compacted-predictor path: the predictor's blocks only need to run
    # over context + target positions, and Ku = Ke + Kp is batch-uniform by
    # the same min-keep truncation that makes enc_idx rectangular.
    union_idx: np.ndarray | None = None

    @property
    def enc_count(self) -> np.ndarray:
        return self.enc.sum(axis=1)

    @property
    def pred_count(self) -> np.ndarray:
        return self.pred.sum(axis=1)

    @property
    def enc_cmask(self) -> np.ndarray:
        """[B, K_pad] bool validity of the compacted context sequence."""
        n = self.enc.shape[1]
        return self.enc_idx < n


def _truncate_to_min(keep_lists: list[np.ndarray], cap: int | None = None) -> list[np.ndarray]:
    """Reference min-keep truncation: cut every sample's ascending index list
    to the batch minimum (and ``cap``)."""
    m = min(len(k) for k in keep_lists)
    if cap is not None:
        m = min(m, cap)
    return [k[:m] for k in keep_lists]


def _dense(keep_lists: list[np.ndarray], n: int) -> np.ndarray:
    out = np.zeros((len(keep_lists), n), dtype=bool)
    for i, k in enumerate(keep_lists):
        out[i, k] = True
    return out


def _bucket_pad(
    index_lists: list[np.ndarray], batch_size: int, n: int, min_k: int = 0
) -> np.ndarray:
    """Rectangular [B, K_pad] int32 index array, K bucketed up to a multiple
    of 128 with sentinel ``n`` padding so scatters drop the pad lanes.
    ``min_k`` floors the bucket (the opt-in sticky mode passes a running
    max)."""
    k = len(index_lists[0])
    k_pad = max(-(-k // 128) * 128, 128, min_k)
    out = np.full((batch_size, k_pad), n, dtype=np.int32)
    for b, c in enumerate(index_lists):
        out[b, :k] = c
    return out


class _BlockGenerator:
    """One mask config's sampler (reference _AVMaskGenerator / _MaskGenerator)."""

    def __init__(
        self,
        layout: TokenLayout,
        spatial_scale: Sequence[float],
        temporal_scale: Sequence[float],
        aspect_ratio: Sequence[float],
        num_blocks: int,
        max_temporal_keep: float = 1.0,
        max_keep: int | None = None,
        audio_block: tuple[int, int] = (4, 6),
        base_seed: int = 0,
        sticky_buckets: bool = False,
    ):
        self.layout = layout
        self.height, self.width = layout.h_grid, layout.w_grid
        self.duration = layout.t_grid
        self.a_height, self.a_width = layout.ha_grid, layout.wa_grid
        self.spatial_scale = tuple(spatial_scale)
        self.temporal_scale = tuple(temporal_scale)
        self.aspect_ratio = tuple(aspect_ratio)
        self.num_blocks = num_blocks
        self.max_context_duration = max(1, int(self.duration * max_temporal_keep))
        self.max_keep = max_keep
        self.audio_block = audio_block
        self.base_seed = base_seed
        self._counter = -1
        # opt-in sticky bucket floors: once a draw needs a larger K bucket,
        # every later batch pads to it (identical numerics: pad lanes carry
        # the sentinel and are masked out)
        self.sticky_buckets = sticky_buckets
        self._k_enc_sticky = 0
        self._k_union_sticky = 0

    # counter discipline matches the reference's shared-Value step()
    # (avmultiblock3d.py:105-112); single-process here, the loader drives it.
    def step(self) -> int:
        self._counter += 1
        return self._counter

    def set_counter(self, value: int) -> None:
        """Fast-forward on resume (reference: app/avjepa/train.py:326-330)."""
        self._counter = value

    def _sample_block_size(self, rng: np.random.Generator) -> tuple[int, int, int]:
        min_t, max_t = self.temporal_scale
        t = max(1, int(self.duration * (min_t + rng.random() * (max_t - min_t))))
        min_s, max_s = self.spatial_scale
        spatial_num_keep = int(
            self.height * self.width * (min_s + rng.random() * (max_s - min_s))
        )
        min_ar, max_ar = self.aspect_ratio
        ar = min_ar + rng.random() * (max_ar - min_ar)
        h = min(int(round(math.sqrt(spatial_num_keep * ar))), self.height)
        w = min(int(round(math.sqrt(spatial_num_keep / ar))), self.width)
        return t, h, w

    def _drop_video_block(self, grid: np.ndarray, size, rng: np.random.Generator):
        t, h, w = size
        top = rng.integers(0, self.height - h + 1)
        left = rng.integers(0, self.width - w + 1)
        start = rng.integers(0, self.duration - t + 1)
        grid[start : start + t, top : top + h, left : left + w] = 0

    def _drop_audio_block(self, grid: np.ndarray, rng: np.random.Generator):
        h, w = self.audio_block
        top = rng.integers(0, self.a_height - h + 1)
        left = rng.integers(0, self.a_width - w + 1)
        grid[top : top + h, left : left + w] = 0

    def sample(self, batch_size: int) -> MaskSet:
        seed = self.step()
        size_rng = np.random.default_rng([self.base_seed, 0, 0, seed])
        p_size = self._sample_block_size(size_rng)
        loc_rng = np.random.default_rng([self.base_seed, 1, 1, seed])

        keeps_v, preds_v, keeps_a, preds_a = [], [], [], []
        for _ in range(batch_size):
            for attempt in range(1000):
                grid_v = np.ones((self.duration, self.height, self.width), np.int32)
                grid_a = np.ones((self.a_height, self.a_width), np.int32)
                for _ in range(self.num_blocks):
                    self._drop_video_block(grid_v, p_size, loc_rng)
                    if self.layout.audio_enabled:
                        self._drop_audio_block(grid_a, loc_rng)
                flat_v = grid_v.reshape(-1)
                if self.max_context_duration < self.duration:
                    ctx_v = flat_v.copy()
                    ctx_v[self.max_context_duration * self.height * self.width :] = 0
                else:
                    ctx_v = flat_v
                keep_v = np.flatnonzero(ctx_v)
                if len(keep_v) == 0:
                    # degenerate draw (blocks covered the whole raster): the
                    # reference retries forever here (avmultiblock3d.py
                    # rejection loop) — a mask config whose block size covers
                    # the full grid (possible on tiny test grids) would HANG
                    # the loader. Bound the loop and force-keep one position.
                    if attempt == 999:
                        ctx_v = flat_v.copy()
                        ctx_v[0] = 1
                        keep_v = np.flatnonzero(ctx_v)
                    else:
                        continue
                keeps_v.append(keep_v)
                preds_v.append(np.flatnonzero(ctx_v == 0))
                flat_a = grid_a.reshape(-1)
                keeps_a.append(np.flatnonzero(flat_a))
                preds_a.append(np.flatnonzero(flat_a == 0))
                break

        nv = self.layout.num_video_tokens
        na = self.layout.num_audio_tokens
        n = nv + na
        keeps_v = _truncate_to_min(keeps_v, self.max_keep)
        preds_v = _truncate_to_min(preds_v)
        enc = np.zeros((batch_size, n), dtype=bool)
        pred = np.zeros((batch_size, n), dtype=bool)
        enc[:, :nv] = _dense(keeps_v, nv)
        pred[:, :nv] = _dense(preds_v, nv)
        if self.layout.audio_enabled:
            keeps_a = _truncate_to_min(keeps_a)
            preds_a = _truncate_to_min(preds_a)
            enc[:, nv:] = _dense(keeps_a, na)
            pred[:, nv:] = _dense(preds_a, na)
            combined = [
                np.concatenate([kv, nv + ka]) for kv, ka in zip(keeps_v, keeps_a)
            ]
            unions = [
                np.concatenate(
                    [np.sort(np.concatenate([kv, pv])),
                     nv + np.sort(np.concatenate([ka, pa]))]
                )
                for kv, pv, ka, pa in zip(keeps_v, preds_v, keeps_a, preds_a)
            ]
        else:
            combined = keeps_v
            unions = [
                np.sort(np.concatenate([kv, pv]))
                for kv, pv in zip(keeps_v, preds_v)
            ]
        enc_idx = _bucket_pad(combined, batch_size, n, self._k_enc_sticky)
        union_idx = _bucket_pad(unions, batch_size, n, self._k_union_sticky)
        if self.sticky_buckets:
            self._k_enc_sticky = enc_idx.shape[1]
            self._k_union_sticky = union_idx.shape[1]
        return MaskSet(enc=enc, pred=pred, enc_idx=enc_idx, union_idx=union_idx)


class AVMaskCollator:
    """Multi-config AV mask sampler (reference AVMaskCollator).

    ``__call__(batch_size)`` returns one MaskSet per mask config.
    """

    def __init__(
        self,
        cfgs_mask: Sequence[dict],
        layout: TokenLayout,
        base_seed: int = 0,
        sticky_buckets: bool = False,
    ):
        self.layout = layout
        self.generators = [
            _BlockGenerator(
                layout=layout,
                spatial_scale=m.get("spatial_scale", (0.2, 0.8)),
                temporal_scale=m.get("temporal_scale", (1.0, 1.0)),
                aspect_ratio=m.get("aspect_ratio", (0.3, 3.0)),
                num_blocks=m.get("num_blocks", 1),
                max_temporal_keep=m.get("max_temporal_keep", 1.0),
                max_keep=m.get("max_keep", None),
                base_seed=base_seed + gi,
                sticky_buckets=sticky_buckets,
            )
            for gi, m in enumerate(cfgs_mask)
        ]

    def set_counter(self, value: int) -> None:
        for g in self.generators:
            g.set_counter(value)

    def __call__(self, batch_size: int) -> list[MaskSet]:
        return [g.sample(batch_size) for g in self.generators]


# The video-only collator is the same machinery with audio disabled
# (reference: src/masks/multiblock3d.py — adds only the max_keep cap, which
# _BlockGenerator already honors).
class MaskCollator(AVMaskCollator):
    def __init__(self, cfgs_mask, layout: TokenLayout, base_seed: int = 0,
                 sticky_buckets: bool = False):
        if layout.audio_enabled:
            layout = dataclasses.replace(layout, audio_enabled=False)
        super().__init__(cfgs_mask, layout, base_seed, sticky_buckets)


class RandomTubeCollator:
    """Random spatial keep-set tiled across time (reference random_tube.py).

    Note: the reference's AV app cannot use this collator (5-tuple unpack
    mismatch, reference app/avjepa/train.py:389); here it works for both
    layouts since masks are uniform dense sets.
    """

    def __init__(self, cfgs_mask, layout: TokenLayout, base_seed: int = 0):
        self.layout = layout
        self.cfgs = [
            {"ratio": m.get("ratio", 0.9), "seed": base_seed + i}
            for i, m in enumerate(cfgs_mask)
        ]
        self._counter = -1

    def set_counter(self, value: int) -> None:
        self._counter = value

    def __call__(self, batch_size: int) -> list[MaskSet]:
        self._counter += 1
        lo = self.layout
        hw = lo.h_grid * lo.w_grid
        out = []
        for cfg in self.cfgs:
            rng = np.random.default_rng([cfg["seed"], 2, 2, self._counter])
            num_keep_spatial = int(hw * (1.0 - cfg["ratio"]))
            enc = np.zeros((batch_size, lo.num_tokens), dtype=bool)
            pred = np.zeros((batch_size, lo.num_tokens), dtype=bool)
            for b in range(batch_size):
                keep_sp = rng.choice(hw, size=num_keep_spatial, replace=False)
                grid = np.zeros((lo.t_grid, hw), dtype=bool)
                grid[:, keep_sp] = True
                flat = grid.reshape(-1)
                enc[b, : lo.num_video_tokens] = flat
                pred[b, : lo.num_video_tokens] = ~flat
                if lo.audio_enabled:
                    enc[b, lo.num_video_tokens :] = True
            k = int(enc[0].sum())
            k_pad = max(-(-k // 128) * 128, 128)
            enc_idx = np.full((batch_size, k_pad), lo.num_tokens, dtype=np.int32)
            for b in range(batch_size):
                enc_idx[b, :k] = np.flatnonzero(enc[b])
            out.append(MaskSet(enc=enc, pred=pred, enc_idx=enc_idx))
        return out


class DefaultCollator:
    """No-mask collator (reference: src/masks/default.py — returns
    (batch, None, None)); here: an empty MaskSet list."""

    def __init__(self, *a, **k):
        pass

    def set_counter(self, value: int) -> None:
        pass

    def __call__(self, batch_size: int) -> list[MaskSet]:
        return []


def make_mask_collator(
    mask_type: str, cfgs_mask, layout: TokenLayout, base_seed: int = 0,
    sticky_buckets: bool = False,
):
    """Dispatch matching the reference's mask_type config key (the reference
    treats anything other than 'multiblock3d' as the random tube collator,
    app/avjepa/train.py:226-241; we accept its aliases but keep an explicit
    error for typos)."""
    if mask_type in ("multiblock3d", "avmultiblock3d"):
        cls = AVMaskCollator if layout.audio_enabled else MaskCollator
        return cls(cfgs_mask, layout, base_seed, sticky_buckets=sticky_buckets)
    if mask_type in ("random", "random_tube", "tube"):
        return RandomTubeCollator(cfgs_mask, layout, base_seed)
    if mask_type == "default":
        return DefaultCollator()
    raise ValueError(f"unknown mask_type: {mask_type}")


def stack_masksets(masksets: Sequence[MaskSet], with_idx: bool = False):
    """list[MaskSet] -> (enc [M,B,N], pred [M,B,N]) numpy bools, plus (with_idx)
    the per-config compact context index tuple ([B, K_i] each) and the
    [M, B, Ku] union-index stack for the compacted predictor (configs padded
    with the sentinel N to a common bucketed Ku). The JAX package keeps this
    in ``avjepa_tpu/train/step.py``."""
    enc = np.stack([m.enc for m in masksets])
    pred = np.stack([m.pred for m in masksets])
    if not with_idx:
        return enc, pred
    idx = tuple(m.enc_idx for m in masksets)
    if any(i is None for i in idx):
        idx = None
    unions = [m.union_idx for m in masksets]
    union = None
    if all(u is not None for u in unions):
        n = enc.shape[2]
        ku = max(u.shape[1] for u in unions)
        union = np.full((len(unions), unions[0].shape[0], ku), n, np.int32)
        for i, u in enumerate(unions):
            union[i, :, : u.shape[1]] = u
    return enc, pred, idx, union
