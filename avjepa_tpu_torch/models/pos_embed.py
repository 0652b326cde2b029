"""Fixed sinusoidal positional embeddings, in numpy.

The functions of ``avjepa_tpu/models/pos_embed.py`` (reference:
src/models/utils/pos_embs.py), written again because importing that module
imports JAX: 1D sincos, the square and rectangular 2D grids (h-emb then
w-emb halves) and the 3D grid with either the D/4-D/4-D/2 split or the
``uniform_power`` split of ``ceil(D/6)*2`` per axis, cut to ``embed_dim``.
Interpolation to other resolutions is not ported yet.
"""

from __future__ import annotations

import numpy as np


def sincos_1d_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] sin/cos features."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_1d(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size, embed_dim] for positions 0..grid_size-1."""
    return sincos_1d_from_grid(embed_dim, np.arange(grid_size, dtype=np.float64))


def sincos_2d_rect(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Rectangular grid (the audio spectrogram raster): the first half of the
    channels encodes the row, the second half the column."""
    h = np.arange(grid_h, dtype=np.float64)
    w = np.arange(grid_w, dtype=np.float64)
    ww, hh = np.meshgrid(w, h)  # index as [h, w]
    emb_h = sincos_1d_from_grid(embed_dim // 2, hh)
    emb_w = sincos_1d_from_grid(embed_dim // 2, ww)
    return np.concatenate([emb_h, emb_w], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """Square grid, row-major [h, w] order."""
    return sincos_2d_rect(embed_dim, grid_size, grid_size)


def sincos_3d(
    embed_dim: int,
    grid_size: int,
    grid_depth: int,
    uniform_power: bool = False,
) -> np.ndarray:
    """[T*H*W, embed_dim] in [d, h, w] raster order, channels concatenated
    (depth, height, width)."""
    d = np.arange(grid_depth, dtype=np.float64)
    h = np.arange(grid_size, dtype=np.float64)
    w = np.arange(grid_size, dtype=np.float64)
    hh, dd, ww = np.meshgrid(h, d, w)  # index as [d, h, w]
    if uniform_power:
        h_dim = w_dim = d_dim = int(np.ceil(embed_dim / 6) * 2)
    else:
        h_dim, w_dim, d_dim = embed_dim // 4, embed_dim // 4, embed_dim // 2
    emb_h = sincos_1d_from_grid(h_dim, hh)
    emb_w = sincos_1d_from_grid(w_dim, ww)
    emb_d = sincos_1d_from_grid(d_dim, dd)
    return np.concatenate([emb_d, emb_h, emb_w], axis=1)[:, :embed_dim]
