"""The narrow JEPA predictor (dense-mask formulation).

Counterpart of ``avjepa_tpu/models/predictor.py:52-202`` (the reference's
AudioVisionTransformerPredictor and the video-only
VisionTransformerPredictor), for video or, at one frame, an image (the
2-D sincos table). It runs over the full token raster: a position
is a context token (the encoder output projected to predictor width), a
prediction target, or invalid (excluded from attention). A target position
holds the learnable mask token of its mask config, or, with
``use_mask_tokens: false`` (the diffusion fallback, JAX
``predictor.py:98-110,124-131,152-154``), the projected target embedding
noised by forward diffusion. Positional embeddings are added everywhere;
attention uses the enc|pred key mask. With ``gather_idx`` the blocks, norm
and output projection run only over the enc∪pred positions, and the result
is scattered back to the dense raster. Under the tensor axis
``predictor_proj`` is row-parallel (``parallel/tensor.py``).

The diffusion fallback's random draws (a step t and unit normal noise per
stream) are explicit arguments, made by ``diffusion_draws`` from a
``torch.Generator``, so that a test can hand in JAX's own draws.

Module names are the reference state-dict keys (``predictor_embed_v``,
``mask_tokens_v.{j}``, ``predictor_blocks.{i}.*``, ``predictor_norm``,
``predictor_proj``), so ``predictor_params_to_state_dict`` loads flax weights
strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models import pos_embed as pe
from avjepa_tpu_torch.models.modules import LN_EPS, Block, layer_norm, linear, run_blocks
from avjepa_tpu_torch.parallel.tensor import copy_to_tensor_region, row_parallel_linear

DIFFUSION_STEPS = 1000  # steps of the fallback's forward-diffusion schedule


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
        dp = predictor_embed_dim
        self.layout = layout
        self.embed_dim = embed_dim
        self.predictor_embed_dim = dp
        self.dtype = dtype
        self.remat = remat
        self.num_mask_tokens = num_mask_tokens
        self.use_mask_tokens = use_mask_tokens

        def tokens():
            if not use_mask_tokens:
                return None
            return nn.ParameterList(
                nn.Parameter(torch.zeros(1, 1, dp)) for _ in range(num_mask_tokens))

        self.predictor_embed_v = nn.Linear(embed_dim, dp)
        self.mask_tokens_v = tokens()
        if layout.audio_enabled:
            self.predictor_embed_a = nn.Linear(embed_dim, dp)
            self.mask_tokens_a = tokens()
        self.predictor_blocks = nn.ModuleList(
            Block(dp, num_heads, mlp_ratio, attn_impl=attn_impl, gelu=gelu, dtype=dtype)
            for _ in range(depth)
        )
        self.predictor_norm = nn.LayerNorm(dp, eps=LN_EPS)
        self.predictor_proj = nn.Linear(dp, embed_dim)
        # the tensor group, when predictor_proj is row-parallel (parallel/tensor.py)
        self.tensor = None
        if layout.num_frames > 1:
            vpe = pe.sincos_3d(dp, layout.h_grid, layout.t_grid, uniform_power=uniform_power)
        else:  # image mode (a layout of one frame and tubelet_size 1)
            vpe = pe.sincos_2d(dp, layout.h_grid)
        self.register_buffer("pos_embed_v", torch.from_numpy(vpe).float(), persistent=False)
        if layout.audio_enabled:
            ape = pe.sincos_2d_rect(dp, layout.ha_grid, layout.wa_grid)
            self.register_buffer("pos_embed_a", torch.from_numpy(ape).float(),
                                 persistent=False)
        if not use_mask_tokens:
            # forward-diffusion schedule (reference audiovisionpredictor.py:182-200):
            # betas linear from 0.5 to 1.0, alphas = cumprod(1 - betas), f32
            betas = 0.5 + torch.arange(DIFFUSION_STEPS, dtype=torch.float32) * 0.5 / DIFFUSION_STEPS
            self.register_buffer("alphas", torch.cumprod(1.0 - betas, 0), persistent=False)

    @property
    def blocks(self) -> nn.ModuleList:
        return self.predictor_blocks

    def diffusion_draws(self, batch: int, generator: torch.Generator) -> dict:
        """The fallback's draws for one call, on the generator's device: per
        stream (``_v``, and ``_a`` with audio) a step ``t`` [B] in [0, 1000)
        and unit normal ``noise`` [B, N_stream, Dp] f32."""
        dev = generator.device
        lo, dp = self.layout, self.predictor_embed_dim
        streams = [("v", lo.num_video_tokens)]
        if lo.audio_enabled:
            streams.append(("a", lo.num_audio_tokens))
        draws = {}
        for name, n in streams:
            draws[f"t_{name}"] = torch.randint(0, DIFFUSION_STEPS, (batch,), generator=generator,
                                               device=dev)
            draws[f"noise_{name}"] = torch.randn((batch, n, dp), generator=generator, device=dev)
        return draws

    def _diffuse(self, x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """sqrt(alpha_t) * LN(x) + sqrt(1 - alpha_t) * noise (reference
        :182-200): LN without affine, eps 1e-5, biased variance, in x's dtype;
        alpha is f32, so the result is f32, as flax promotes it."""
        alpha = self.alphas[t.long()][:, None, None]
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return torch.sqrt(alpha) * xn + torch.sqrt(1.0 - alpha) * noise.to(x.dtype)

    def _stream(self, embed: nn.Linear, tokens: Optional[nn.ParameterList], pos: torch.Tensor,
                ctx: torch.Tensor, pred_mask: torch.Tensor, mask_index, target=None, t=None,
                noise=None) -> torch.Tensor:
        """embed(ctx); at target positions the mask token of ``mask_index``
        (an int, or one per sample), or embed(target) noised with (t,
        noise); plus the sincos table."""
        x = linear(embed, ctx.to(self.dtype))
        if tokens is None:
            fill = self._diffuse(linear(embed, target.to(self.dtype)), t, noise)
        else:
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
        target: Optional[torch.Tensor] = None,
        draws: Optional[dict] = None,
    ) -> torch.Tensor:
        """ctx [B, N, D] dense encoder output; enc_mask, pred_mask [B, N] bool;
        mask_index an int or a [B] integer tensor; gather_idx optional [B, Ku]
        ascending enc∪pred indices (sentinel N padding). Without mask tokens,
        ``target`` [B, N, D] (the target encoder's output) and ``draws``
        (``diffusion_draws``) are required.

        Returns [B, N, D] dense predictions in ``self.dtype`` (valid only at
        pred_mask positions; 0 outside enc∪pred when compacted)."""
        if not self.use_mask_tokens and (target is None or draws is None):
            raise ValueError("use_mask_tokens=False requires the target embeddings and the "
                             "diffusion draws (the diffusion fallback)")
        nv = self.layout.num_video_tokens

        def noising(name, cut):
            if self.use_mask_tokens:
                return {}
            return dict(target=target[:, cut], t=draws[f"t_{name}"], noise=draws[f"noise_{name}"])

        x = self._stream(self.predictor_embed_v, self.mask_tokens_v, self.pos_embed_v,
                         ctx[:, :nv], pred_mask[:, :nv], mask_index,
                         **noising("v", slice(None, nv)))
        if self.layout.audio_enabled:
            xa = self._stream(self.predictor_embed_a, self.mask_tokens_a, self.pos_embed_a,
                              ctx[:, nv:], pred_mask[:, nv:], mask_index,
                              **noising("a", slice(nv, None)))
            x = torch.cat([x, xa], dim=1)
        key_mask = enc_mask | pred_mask

        b, n, dp = x.shape
        if gather_idx is not None:
            idx = gather_idx.long()
            safe = idx.clamp(max=n - 1)
            x = torch.gather(x, 1, safe[..., None].expand(-1, -1, dp))
            key_mask = torch.gather(key_mask, 1, safe) & (idx < n)

        x = run_blocks(self.predictor_blocks, x, key_mask, self.remat)
        x = layer_norm(self.predictor_norm, x, self.dtype)
        if self.tensor is None:
            x = linear(self.predictor_proj, x)
        else:
            # row-parallel on this rank's slice of the (whole) features
            x = copy_to_tensor_region(x, self.tensor)
            x = row_parallel_linear(self.predictor_proj, x.chunk(self.tensor.size, -1)[
                self.tensor.index], self.tensor)
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
