"""Transformer primitives: Mlp, Attention, the pre-LN Block, CrossAttention
and CrossAttentionBlock (the attentive classifier's), and FastLayerNorm.

Counterpart of ``avjepa_tpu/models/modules.py``. Parameters are f32
``nn.Linear`` / ``nn.LayerNorm`` modules named with the reference state-dict
keys (``attn.qkv``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``, ``norm1``,
``norm2``; ``xattn.q``, ``xattn.kv``, ``xattn.proj`` for cross attention).
Compute follows the block's dtype, as flax's ``dtype=`` does:
LayerNorm takes its statistics in f32 and casts to it, linear layers cast
their f32 weights to their input's dtype; the residual stream keeps the
dtype it comes in with (f32 where the diffusion predictor's noised targets
promote it, as in flax).

The attention dispatch is the JAX package's: with ``attn_impl='flash'`` and
heads that pack, the packed kernel reads the fused qkv in place; otherwise
q, k, v go through ``attention(impl=...)`` as ``[B, H, N, Dh]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from avjepa_tpu_torch.ops.attention import attention
from avjepa_tpu_torch.ops.flash_attention import flash_attention_qkv, packed_qkv_eligible
from avjepa_tpu_torch.ops.layer_norm import layer_norm as fast_layer_norm


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (the weights stay f32)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``norm`` with f32 statistics, cast to ``dtype`` (default ``x``'s)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(dtype or x.dtype)


LN_EPS = 1e-6  # pre-LN and final-norm epsilon (reference: modules.py)


class FastLayerNorm(nn.Module):
    """LayerNorm through the port's K5/K6 kernels (``ops/layer_norm.py``;
    JAX ``FastLayerNorm``, ``avjepa_tpu/models/modules.py:30-48``): ``weight``
    and ``bias`` of [C] in f32, f32 statistics, output in the input's dtype.
    On the CPU it runs the kernels' plain versions. As in the JAX package, no
    model builds it: the Block's LayerNorm is the plain one."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layer_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, gelu: str = "exact"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        # 'exact' is torch nn.GELU (erf); 'tanh' the approximation the
        # configs default to (tpu.gelu)
        self.approximate = "tanh" if gelu == "tanh" else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(self.fc1, x), approximate=self.approximate)
        return linear(self.fc2, x)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = linear(self.qkv, x)
        if self.attn_impl == "flash" and packed_qkv_eligible(self.num_heads, head_dim):
            out = flash_attention_qkv(qkv, self.num_heads, key_mask=key_mask)
        else:
            q, k, v = qkv.reshape(b, n, 3, self.num_heads, head_dim).permute(
                2, 0, 3, 1, 4).unbind(0)  # [B, H, N, Dh] each
            out = attention(q, k, v, key_mask=key_mask, impl=self.attn_impl)
            out = out.transpose(1, 2).reshape(b, n, c)
        return linear(self.proj, out)


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, key_mask: Optional[torch.Tensor],
               remat: bool) -> torch.Tensor:
    """The block stack; with ``remat`` and gradients on, each block is
    recomputed in the backward pass (``torch.utils.checkpoint``), so only the
    block inputs are kept. Its attention kernels then run once more."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(blk, x, key_mask, use_reentrant=False)
        else:
            x = blk(x, key_mask)
    return x


class Block(nn.Module):
    """Pre-LN residual transformer block (reference: modules.py:81-120)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attn_impl: str = "xla", gelu: str = "exact",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype  # compute dtype; None: the input's
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu=gelu)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        x = x + self.attn(layer_norm(self.norm1, x, self.dtype), key_mask=key_mask)
        return x + self.mlp(layer_norm(self.norm2, x, self.dtype))


class CrossAttention(nn.Module):
    """Query tokens attend over a context sequence (JAX ``CrossAttention``,
    ``avjepa_tpu/models/modules.py:180-216``): ``q`` and ``kv`` are separate
    linears, the plain masked attention, then ``proj``; computed in ``dtype``
    (None: the query's)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.dtype or q.dtype
        b, nq, c = q.shape
        nk, h = x.shape[1], self.num_heads
        qp = linear(self.q, q.to(dtype)).reshape(b, nq, h, c // h).transpose(1, 2)
        k, v = linear(self.kv, x.to(dtype)).reshape(b, nk, 2, h, c // h).permute(
            2, 0, 3, 1, 4).unbind(0)  # [B, H, Nk, Dh] each
        out = attention(qp, k, v, key_mask=key_mask)
        return linear(self.proj, out.transpose(1, 2).reshape(b, nq, c))


class CrossAttentionBlock(nn.Module):
    """JAX ``CrossAttentionBlock`` (``modules.py:219-241``): ``norm1`` is
    applied to the context ``x``, not to the queries; then the residual,
    ``norm2`` and the MLP (exact GELU)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.xattn = CrossAttention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, q: torch.Tensor, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = q + self.xattn(q, layer_norm(self.norm1, x, self.dtype), key_mask)
        return q + self.mlp(layer_norm(self.norm2, q, self.dtype))
