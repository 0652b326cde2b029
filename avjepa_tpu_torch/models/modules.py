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
heads that pack (decided on the model's head count), the packed kernel reads
the fused qkv in place; otherwise q, k, v go through ``attention(impl=...)``
as ``[B, H, N, Dh]``. A remat'd block keeps the attention's out and lse and
recomputes the rest (``Block.forward``).

Under the tensor axis (``parallel/tensor.py``) an ``Attention`` or ``Mlp``
whose ``tensor`` group is set holds its rank's heads or hidden features: its
input passes ``copy_to_tensor_region``, its column-parallel linear (qkv,
fc1) gives local features, and its row-parallel linear (proj, fc2) sums the
ranks' partial products over the group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from avjepa_tpu_torch.ops.attention import attention
from avjepa_tpu_torch.ops.flash_attention import (
    classic_kernel_eligible,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_qkv,
    flash_attention_qkv_bwd,
    flash_attention_qkv_fwd,
    packed_qkv_eligible,
)
from avjepa_tpu_torch.ops.layer_norm import layer_norm as fast_layer_norm
from avjepa_tpu_torch.parallel.tensor import copy_to_tensor_region, row_parallel_linear


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
        self.tensor = None  # the tensor group, when sharded (parallel/tensor.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return linear(self.fc2, F.gelu(linear(self.fc1, x), approximate=self.approximate))
        x = copy_to_tensor_region(x, self.tensor)
        x = F.gelu(linear(self.fc1, x), approximate=self.approximate)
        return row_parallel_linear(self.fc2, x, self.tensor)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_impl: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.tensor = None  # the tensor group, when sharded (parallel/tensor.py)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        qkv = self.qkv_proj(x, self.qkv.weight, self.qkv.bias)
        return self.project(self.attend(qkv, key_mask))

    def qkv_proj(self, x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The (column-parallel) qkv projection with these weights: [B, N,
        3 x this rank's heads x Dh], rows in [3, H, Dh] order."""
        if self.tensor is not None:
            x = copy_to_tensor_region(x, self.tensor)
        return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))

    def _path(self, n: int) -> str:
        """The JAX rule on the model's heads: a rank's share of heads that
        pack takes the packed kernel too."""
        if self.attn_impl == "flash" and packed_qkv_eligible(self.num_heads, self.head_dim):
            return "packed"
        if self.attn_impl == "flash" and classic_kernel_eligible(self.head_dim, n):
            return "classic"
        return "plain"

    def _split(self, qkv: torch.Tensor):
        b, n, c3 = qkv.shape
        return qkv.reshape(b, n, 3, c3 // (3 * self.head_dim), self.head_dim).permute(
            2, 0, 3, 1, 4).unbind(0)  # [B, H, N, Dh] each

    @staticmethod
    def _merge(out: torch.Tensor) -> torch.Tensor:
        b, h, n, d = out.shape
        return out.transpose(1, 2).reshape(b, n, h * d)

    def attend(self, qkv: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        """The attention before ``proj``, differentiable: [B, N, this rank's
        heads x Dh]."""
        if self._path(qkv.shape[1]) == "packed":
            return flash_attention_qkv(qkv, qkv.shape[-1] // (3 * self.head_dim),
                                       key_mask=key_mask)
        q, k, v = self._split(qkv)
        return self._merge(attention(q, k, v, key_mask=key_mask, impl=self.attn_impl))

    def attend_fwd(self, qkv: torch.Tensor, key_mask: Optional[torch.Tensor]):
        """``attend``'s forward alone: (out, lse); lse is None on the plain
        path."""
        path = self._path(qkv.shape[1])
        if path == "packed":
            return flash_attention_qkv_fwd(qkv, qkv.shape[-1] // (3 * self.head_dim), key_mask)
        q, k, v = self._split(qkv)
        if path == "classic":
            out, lse = flash_attention_fwd(q, k, v, key_mask)
            return self._merge(out), lse
        return self._merge(attention(q, k, v, key_mask=key_mask)), None

    def attend_bwd(self, qkv: torch.Tensor, key_mask: Optional[torch.Tensor],
                   out: torch.Tensor, lse: Optional[torch.Tensor],
                   dout: torch.Tensor) -> torch.Tensor:
        """``attend``'s backward from ``attend_fwd``'s out and lse: dqkv.
        The kernels' backwards read them; the plain path runs its softmax
        again, as the JAX backward does from a saved output."""
        b, n, c3 = qkv.shape
        path = self._path(n)
        if path == "packed":
            return flash_attention_qkv_bwd(qkv, out, lse, dout, c3 // (3 * self.head_dim),
                                           key_mask)
        if path == "plain":
            with torch.enable_grad():
                qkv = qkv.detach().requires_grad_()
                out = self._merge(attention(*self._split(qkv), key_mask=key_mask))
            return torch.autograd.grad(out, qkv, dout)[0]
        heads = c3 // (3 * self.head_dim)
        as_heads = lambda t: t.view(b, n, heads, self.head_dim).transpose(1, 2)  # noqa: E731
        dq, dk, dv = flash_attention_bwd(*self._split(qkv), as_heads(out).contiguous(), lse,
                                         as_heads(dout), key_mask)
        return torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(b, n, c3)

    def project(self, out: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return linear(self.proj, out)
        return row_parallel_linear(self.proj, out, self.tensor)


class _RematAttention(torch.autograd.Function):
    """LN1, the qkv projection and the attention of a remat'd block. The
    forward keeps the block input and the attention's out and lse, as the
    JAX block stack's ``save_only_these_names("attn_out", "attn_lse")``
    does; the backward recomputes LN1 and qkv from the input, runs the
    attention's backward on the saved out and lse (``Attention.attend_bwd``)
    and takes LN1's and qkv's gradients, so the forward attention runs once
    a layer. ``params``: LN1's weight and bias, qkv's weight and bias."""

    @staticmethod
    def forward(ctx, block, x, key_mask, *params):
        out, lse = block.attn.attend_fwd(block.norm_qkv(x, *params), key_mask)
        ctx.block = block
        ctx.save_for_backward(x, key_mask, out, lse, *params)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, key_mask, out, lse, *params = ctx.saved_tensors
        needs = (ctx.needs_input_grad[1], *ctx.needs_input_grad[3:])
        with torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_(need)
                      for t, need in zip((x, *params), needs)]
            qkv = ctx.block.norm_qkv(*inputs)
        dqkv = ctx.block.attn.attend_bwd(qkv.detach(), key_mask, out, lse, dout)
        grads = iter(torch.autograd.grad(qkv, [t for t, need in zip(inputs, needs) if need],
                                         dqkv))
        gx, *gparams = (next(grads) if need else None for need in needs)
        return None, gx, None, *gparams


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, key_mask: Optional[torch.Tensor],
               remat: bool) -> torch.Tensor:
    """The block stack; with ``remat`` and gradients on, each block keeps
    only its input and its attention's out and lse, and the backward pass
    recomputes the rest of it (LN1, qkv, proj, LN2, the MLP) from them
    (``Block.forward``): the JAX block stack's
    ``save_only_these_names("attn_out", "attn_lse")``
    (``avjepa_tpu/models/encoder.py:73-93``), so the forward attention runs
    once a layer."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        x = blk(x, key_mask, remat=remat)
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

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                remat: bool = False):
        """With ``remat``, LN1, qkv and the attention run in
        ``_RematAttention``, which keeps the attention's out and lse, and
        proj, LN2 and the MLP under ``torch.utils.checkpoint``, which keeps
        its inputs (the block input and that out). Both run inside the
        module's call, so FSDP2's hooks on the block (its unit) gather the
        weights around them."""
        params = (self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias)
        if remat:
            a = _RematAttention.apply(self, x, key_mask, *params)
            return torch.utils.checkpoint.checkpoint(self._tail, x, a, use_reentrant=False)
        return self._tail(x, self.attn.attend(self.norm_qkv(x, *params), key_mask))

    def norm_qkv(self, x: torch.Tensor, norm_weight: torch.Tensor, norm_bias: torch.Tensor,
            weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """LN1 (f32 statistics) and the qkv projection, with these weights."""
        h = F.layer_norm(x.float(), self.norm1.normalized_shape, norm_weight, norm_bias,
                         self.norm1.eps).to(self.dtype or x.dtype)
        return self.attn.qkv_proj(h, weight, bias)

    def _tail(self, x: torch.Tensor, a: torch.Tensor):
        x = x + self.attn.project(a)
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
