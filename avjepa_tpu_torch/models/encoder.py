"""The JEPA encoder over a (video, audio) token sequence.

Counterpart of ``avjepa_tpu/models/encoder.py``: AV (video tokens, then
audio tokens), video-only (``layout.audio_enabled`` False) and image mode
(``layout.num_frames`` 1: a [B, H, W, C] image, the 2-D patch embed and
sincos table), dense with an optional ``[B, N]`` key mask, or compacted to
the tokens of ``gather_idx``. A video (or image) at another size than the
layout's gets its pos-embed resized to its grid (``models/pos_embed.py``).
The blocks are an ``nn.ModuleList`` (the JAX package scans one stacked
block).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.modules import LN_EPS, Block, layer_norm, run_blocks
from avjepa_tpu_torch.models.patch_embed import AVPatchEmbed


class Encoder(nn.Module):
    def __init__(
        self,
        layout: TokenLayout,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        uniform_power: bool = False,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "xla",
        gelu: str = "exact",
        remat: bool = False,
    ):
        super().__init__()
        self.layout = layout
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = AVPatchEmbed(layout, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, attn_impl=attn_impl, gelu=gelu, dtype=dtype)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        # fixed sincos tables, recomputed from the layout (not in state dicts)
        if layout.num_frames > 1:
            vpe = pe.sincos_3d(embed_dim, layout.h_grid, layout.t_grid,
                               uniform_power=uniform_power)
        else:
            vpe = pe.sincos_2d(embed_dim, layout.h_grid)
        self.register_buffer("pos_embed_v", torch.from_numpy(vpe).float(),
                             persistent=False)
        if layout.audio_enabled:
            ape = pe.sincos_2d_rect(embed_dim, layout.ha_grid, layout.wa_grid)
            self.register_buffer("pos_embed_a", torch.from_numpy(ape).float(),
                                 persistent=False)

    def forward(
        self,
        video: torch.Tensor,
        audio: Optional[torch.Tensor] = None,
        key_mask: Optional[torch.Tensor] = None,
        gather_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """video [B, T, H, W, 3] (an image [B, H, W, 3] in image mode); audio [B, Hs, Ws, 1]; key_mask [B, N] bool
        or None (every token valid), over the compacted sequence when
        ``gather_idx`` is given.

        gather_idx: optional [B, K] int — only these token positions enter
        the blocks (K is bucket-padded with the sentinel N, which is clamped
        for the gather and must be masked out by key_mask).

        Returns [B, N, D] (or [B, K, D]) in ``self.dtype``; rows at masked
        positions are finite garbage for callers to mask."""
        x = self.patch_embed.proj(video.to(self.dtype))
        vpe = self.pos_embed_v.to(self.dtype)
        if x.shape[1] != vpe.shape[0]:
            # off-native resolution: the table, cast first, resized to the
            # input's grid (trilinear for video, bicubic for images)
            lo = self.layout
            if lo.num_frames > 1:
                grid = (video.shape[1] // lo.tubelet_size, video.shape[2] // lo.patch_size,
                        video.shape[3] // lo.patch_size)
                vpe = pe.interpolate_video_pos_embed(vpe, lo.video_grid, grid)
            else:
                grid = (video.shape[1] // lo.patch_size, video.shape[2] // lo.patch_size)
                vpe = pe.interpolate_image_pos_embed(vpe, (lo.h_grid, lo.w_grid), grid)
        x = x + vpe
        if self.layout.audio_enabled:
            if audio is None:
                raise ValueError("layout has audio enabled but no audio given")
            a = self.patch_embed.audio_proj(audio.to(self.dtype))
            x = torch.cat([x, a + self.pos_embed_a.to(self.dtype)], dim=1)
        if gather_idx is not None:
            safe = gather_idx.clamp(max=x.shape[1] - 1).long()
            x = torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[-1]))
        x = run_blocks(self.blocks, x, key_mask, self.remat)
        return layer_norm(self.norm, x)
