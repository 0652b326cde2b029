"""Fixed sinusoidal positional embeddings, and their resizing to other grids.

The functions of ``avjepa_tpu/models/pos_embed.py`` (reference:
src/models/utils/pos_embs.py), written again because importing that module
imports JAX: 1D sincos, the square and rectangular 2D grids (h-emb then
w-emb halves) and the 3D grid with either the D/4-D/4-D/2 split or the
``uniform_power`` split of ``ceil(D/6)*2`` per axis, cut to ``embed_dim``,
in numpy; then the trilinear (video) and bicubic (image) resize of a table
to an off-native grid, in torch, with ``jax.image.resize``'s semantics:
one weight matrix an axis, half-pixel centres, the kernel widened by
1/scale when downsampling (antialiasing), each output's weights summing to
1, and Keys' cubic with a = -0.5. ``F.interpolate`` agrees only when
upsampling trilinearly: it does not antialias, and its cubic has a = -0.75.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1 - x.abs()).clamp(min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, at x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(m: int, n: int, kernel: Callable, device) -> torch.Tensor:
    """[m, n] f32: column j holds the weights of input rows for output j."""
    inv_scale = m / n
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs()
    w = kernel(dist / max(inv_scale, 1.0))  # widened when downsampling
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(grid: torch.Tensor, shape: tuple[int, ...], kernel: Callable) -> torch.Tensor:
    """``grid`` resized to ``shape`` one axis at a time, in its dtype; an axis
    whose size stays is left as it is."""
    for d, n in enumerate(shape):
        m = grid.shape[d]
        if m != n:
            w = _resize_weights(m, n, kernel, grid.device).to(grid.dtype)
            grid = torch.movedim(torch.tensordot(grid, w, dims=([d], [0])), -1, d)
    return grid


def interpolate_video_pos_embed(
    pos_embed: torch.Tensor,
    src_grid: tuple[int, int, int],
    dst_grid: tuple[int, int, int],
) -> torch.Tensor:
    """Trilinear resize of a [N, D] video pos-embed between (T, H, W) grids
    (reference: src/models/audiovision_transformer.py:241-272)."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = _resize(pos_embed.reshape(*src_grid, d), (*dst_grid, d), _triangle)
    return grid.reshape(-1, d)


def interpolate_image_pos_embed(
    pos_embed: torch.Tensor,
    src_grid: tuple[int, int],
    dst_grid: tuple[int, int],
) -> torch.Tensor:
    """Bicubic resize of a [N, D] image pos-embed between (H, W) grids."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = _resize(pos_embed.reshape(*src_grid, d), (*dst_grid, d), _keys_cubic)
    return grid.reshape(-1, d)
