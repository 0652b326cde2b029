"""A frozen copy of the port's multiblock-3D mask sampler
(``avjepa_tpu_torch/masks/multiblock3d.py``, itself the JAX package's, from
the reference collators ``src/masks/avmultiblock3d.py`` and
``multiblock3d.py``), so that the benchmark's masks do not move when the
program's sampler does.

Per mask config and batch: one block size drawn from (base seed, counter),
``num_blocks`` blocks dropped a sample (and fixed 4 x 6 blocks on the
spectrogram's grid), the kept tokens the context and the dropped ones the
targets, every sample's lists cut to the batch's shortest. Returns the
dense [B, N] masks alone: the draws are the traffic. The index arrays that
the program's compacted paths take are the program's own format, built by
the program's code (``entries/train.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """The token grid the sampler draws on."""

    t_grid: int
    h_grid: int
    w_grid: int
    ha_grid: int
    wa_grid: int
    audio_enabled: bool

    @property
    def num_video_tokens(self) -> int:
        return self.t_grid * self.h_grid * self.w_grid

    @property
    def num_audio_tokens(self) -> int:
        return self.ha_grid * self.wa_grid if self.audio_enabled else 0


@dataclasses.dataclass
class Draw:
    """One mask config's draw for a batch over the combined token sequence:
    enc/pred [B, N] bool, disjoint; positions in neither are cut by the
    batch-min truncation and are neither context nor target."""

    enc: np.ndarray
    pred: np.ndarray


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


class _BlockGenerator:
    """One mask config's sampler (reference _AVMaskGenerator / _MaskGenerator)."""

    def __init__(
        self,
        layout: Grid,
        spatial_scale: Sequence[float],
        temporal_scale: Sequence[float],
        aspect_ratio: Sequence[float],
        num_blocks: int,
        max_temporal_keep: float = 1.0,
        max_keep: int | None = None,
        audio_block: tuple[int, int] = (4, 6),
        base_seed: int = 0,
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

    # counter discipline matches the reference's shared-Value step()
    # (avmultiblock3d.py:105-112); single-process here, the loader drives it.
    def step(self) -> int:
        self._counter += 1
        return self._counter

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

    def sample(self, batch_size: int) -> Draw:
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
            enc[:, nv:] = _dense(_truncate_to_min(keeps_a), na)
            pred[:, nv:] = _dense(_truncate_to_min(preds_a), na)
        return Draw(enc=enc, pred=pred)


class MaskCollator:
    """The sampler of several mask configs (reference AVMaskCollator, and
    MaskCollator on a grid without audio): ``__call__(batch_size)`` returns
    one Draw a config, config ``i`` seeded with ``base_seed + i``."""

    def __init__(self, cfgs_mask: Sequence[dict], layout: Grid, base_seed: int = 0):
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
            )
            for gi, m in enumerate(cfgs_mask)
        ]

    def __call__(self, batch_size: int) -> list[Draw]:
        return [g.sample(batch_size) for g in self.generators]
