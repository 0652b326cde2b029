"""The narrow JEPA predictor (dense-mask formulation, mask tokens).

Counterpart of ``avjepa_tpu/models/predictor.py:52-202`` with learnable mask
tokens (the reference's AudioVisionTransformerPredictor and the video-only
VisionTransformerPredictor). It runs over the full token raster: a position
is a context token (the encoder output projected to predictor width), a
prediction target (the mask token of its mask config), or invalid (excluded
from attention). Positional embeddings are added everywhere; attention uses
the enc|pred key mask. With ``gather_idx`` the blocks, norm and output
projection run only over the enc∪pred positions, and the result is scattered
back to the dense raster.

Module names are the reference state-dict keys (``predictor_embed_v``,
``mask_tokens_v.{j}``, ``predictor_blocks.{i}.*``, ``predictor_norm``,
``predictor_proj``), so ``predictor_params_to_state_dict`` loads flax weights
strictly. The diffusion fallback (``use_mask_tokens: false``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.modules import LN_EPS, Block, layer_norm, linear, run_blocks


class Predictor(nn.Module):
    def __init__(
        self,
        layout: TokenLayout,
        embed_dim: int = 768,
        predictor_embed_dim: int = 384,
        depth: int = 6,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        uniform_power: bool = False,
        use_mask_tokens: bool = True,
        num_mask_tokens: int = 2,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "xla",
        gelu: str = "exact",
        remat: bool = False,
    ):
        super().__init__()
        if not use_mask_tokens:
            raise NotImplementedError(
                "model.use_mask_tokens: false (the diffusion-fallback predictor) is not "
                "ported to avjepa_tpu_torch yet (see ROADMAP.md)"
            )
        if layout.num_frames <= 1:
            raise NotImplementedError("image mode is not ported yet (see ROADMAP.md)")
        dp = predictor_embed_dim
        self.layout = layout
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.remat = remat
        self.num_mask_tokens = num_mask_tokens
        self.predictor_embed_v = nn.Linear(embed_dim, dp)
        self.mask_tokens_v = nn.ParameterList(
            nn.Parameter(torch.zeros(1, 1, dp)) for _ in range(num_mask_tokens))
        if layout.audio_enabled:
            self.predictor_embed_a = nn.Linear(embed_dim, dp)
            self.mask_tokens_a = nn.ParameterList(
                nn.Parameter(torch.zeros(1, 1, dp)) for _ in range(num_mask_tokens))
        self.predictor_blocks = nn.ModuleList(
            Block(dp, num_heads, mlp_ratio, attn_impl=attn_impl, gelu=gelu)
            for _ in range(depth)
        )
        self.predictor_norm = nn.LayerNorm(dp, eps=LN_EPS)
        self.predictor_proj = nn.Linear(dp, embed_dim)
        vpe = pe.sincos_3d(dp, layout.h_grid, layout.t_grid, uniform_power=uniform_power)
        self.register_buffer("pos_embed_v", torch.from_numpy(vpe).float(), persistent=False)
        if layout.audio_enabled:
            ape = pe.sincos_2d_rect(dp, layout.ha_grid, layout.wa_grid)
            self.register_buffer("pos_embed_a", torch.from_numpy(ape).float(),
                                 persistent=False)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.predictor_blocks

    def _stream(self, embed: nn.Linear, tokens: nn.ParameterList, pos: torch.Tensor,
                ctx: torch.Tensor, pred_mask: torch.Tensor, mask_index) -> torch.Tensor:
        """embed(ctx); the mask token of ``mask_index`` (an int, or one per
        sample) at target positions; plus the sincos table."""
        x = linear(embed, ctx.to(self.dtype))
        table = torch.cat(list(tokens), 0)[:, 0].to(self.dtype)  # [M, dp]
        if isinstance(mask_index, int):
            fill = table[mask_index % self.num_mask_tokens][None, None, :]
        else:
            fill = table[mask_index % self.num_mask_tokens][:, None, :]
        x = torch.where(pred_mask[..., None], fill, x)
        return x + pos.to(self.dtype)

    def forward(
        self,
        ctx: torch.Tensor,
        enc_mask: torch.Tensor,
        pred_mask: torch.Tensor,
        mask_index=0,
        gather_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """ctx [B, N, D] dense encoder output; enc_mask, pred_mask [B, N] bool;
        mask_index an int or a [B] integer tensor; gather_idx optional [B, Ku]
        ascending enc∪pred indices (sentinel N padding).

        Returns [B, N, D] dense predictions in ``self.dtype`` (valid only at
        pred_mask positions; 0 outside enc∪pred when compacted)."""
        nv = self.layout.num_video_tokens
        x = self._stream(self.predictor_embed_v, self.mask_tokens_v, self.pos_embed_v,
                         ctx[:, :nv], pred_mask[:, :nv], mask_index)
        if self.layout.audio_enabled:
            xa = self._stream(self.predictor_embed_a, self.mask_tokens_a, self.pos_embed_a,
                              ctx[:, nv:], pred_mask[:, nv:], mask_index)
            x = torch.cat([x, xa], dim=1)
        key_mask = enc_mask | pred_mask

        b, n, dp = x.shape
        if gather_idx is not None:
            idx = gather_idx.long()
            safe = idx.clamp(max=n - 1)
            x = torch.gather(x, 1, safe[..., None].expand(-1, -1, dp))
            key_mask = torch.gather(key_mask, 1, safe) & (idx < n)

        x = run_blocks(self.predictor_blocks, x, key_mask, self.remat)
        x = linear(self.predictor_proj, layer_norm(self.predictor_norm, x))
        if gather_idx is not None:
            x = scatter_rows(x, idx, n)
        return x


def scatter_rows(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, K, D] rows to a dense [B, n, D] at positions ``idx`` [B, K]; rows
    at the sentinel n are dropped (the JAX package's ``mode="drop"``): they
    land in an extra row n, which is sliced off. Positions not in idx are 0."""
    b, _, d = rows.shape
    dense = rows.new_zeros((b, n + 1, d))
    dense = dense.scatter(1, idx.long()[..., None].expand(-1, -1, d), rows)
    return dense[:, :n]
