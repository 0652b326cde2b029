"""Patchification: a reshape into patches, then one matmul.

Counterpart of ``avjepa_tpu/models/patch_embed.py``. Raster order is (t, h, w)
for video and (h, w) for images and audio; each patch is flattened row-major
as (t, kh, kw, C). The weights keep the reference's conv layout
(``patch_embed.proj.weight`` [D, C, t, kh, kw], or [D, C, kh, kw] in image
mode; ``patch_embed.audio_proj.weight`` [D, 1, kh, kw]), so reference state
dicts load with no mapping code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from avjepa_tpu_torch.layout import TokenLayout


def patchify_2d(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/p * W/p, p*p*C] (row-major within each patch)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def patchify_3d(x: torch.Tensor, t: int, p: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T/t * H/p * W/p, t*p*p*C]."""
    b, T, h, w, c = x.shape
    x = x.reshape(b, T // t, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (T // t) * (h // p) * (w // p), t * p * p * c)


class VideoPatchEmbed3D(nn.Module):
    """Tubelet embed: [B, T, H, W, C] -> [B, T'*H'*W', D]."""

    def __init__(self, embed_dim: int, patch_size: int = 16, tubelet_size: int = 2,
                 in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.tubelet_size = tubelet_size
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, tubelet_size, patch_size, patch_size)
        )
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = patchify_3d(x, self.tubelet_size, self.patch_size)
        w = self.weight.permute(0, 2, 3, 4, 1).reshape(self.weight.shape[0], -1)
        return F.linear(xf, w.to(xf.dtype), self.bias.to(xf.dtype))


class ImagePatchEmbed(nn.Module):
    """Patch embed: [B, H, W, C] -> [B, H'*W', D] (image mode)."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        yf = patchify_2d(y, self.patch_size)
        w = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return F.linear(yf, w.to(yf.dtype), self.bias.to(yf.dtype))


class AudioPatchEmbed(ImagePatchEmbed):
    """Spectrogram embed: [B, Hs, Ws, 1] -> [B, Hs'*Ws', D]."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 1):
        super().__init__(embed_dim, patch_size, in_chans)


class AVPatchEmbed(nn.Module):
    """The reference's ``patch_embed`` module: ``proj`` (video, or an image
    when the layout has one frame) and, when the layout has audio,
    ``audio_proj``."""

    def __init__(self, layout: TokenLayout, embed_dim: int):
        super().__init__()
        if layout.num_frames > 1:
            self.proj = VideoPatchEmbed3D(embed_dim, layout.patch_size, layout.tubelet_size)
        else:
            self.proj = ImagePatchEmbed(embed_dim, layout.patch_size)
        self.audio_proj = (
            AudioPatchEmbed(embed_dim, layout.patch_size) if layout.audio_enabled else None
        )
