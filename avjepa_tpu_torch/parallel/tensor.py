"""The tensor axis of ``avjepa_tpu/parallel/mesh.py``: Megatron tensor
parallelism over a tensor group (``dist.Mesh.tensor_group``).

The JAX package's ``_param_spec`` (``mesh.py:96-148``) puts 'tensor' on the
output features of the ``qkv``, ``fc1``, ``q`` and ``kv`` kernels and on the
input features of ``proj`` and ``fc2`` (not under ``patch_embed``), and GSPMD
inserts the collectives. Here the ranks of a tensor group share one batch,
each holds its piece of those layers, and the collectives are explicit: two
autograd Functions around each column/row linear pair,
  - ``copy_to_tensor_region``: identity forward, all-reduce backward (before
    the column-parallel linear: each rank's input gradient is a partial sum);
  - ``reduce_from_tensor_region``: all-reduce forward, identity backward
    (after the row-parallel linear: each rank's output is a partial sum);
so a block costs one all-reduce a linear pair forward and one backward, and
the residual stream stays whole on every rank.

``shard_models`` cuts each full parameter (state-dict layout) to this rank's
piece, in place, and marks the layer (``Split``):
  - ``attn.qkv``: its rows are ordered ``[3, H, d]`` (the packed kernel reads
    them so), so a rank takes heads ``[t H/T, (t+1) H/T)`` of each of q, k
    and v: the local ``[3 C/T, D]`` keeps the ``[3, H/T, d]`` order that
    K1/K2 read in place; the bias likewise;
  - ``mlp.fc1``: output rows; ``attn.proj``, ``mlp.fc2`` and the predictor's
    ``predictor_proj`` (JAX's substring rule matches its ``proj/kernel``):
    input columns, their biases whole and added once, after the all-reduce;
  - a layer whose dimension does not divide stays whole (heads % T != 0, as
    vit_tiny's 3 heads; an MLP width that does not divide), as
    ``param_shardings`` replicates an axis that does not divide
    (``mesh.py:160-172``): replication changes no numbers.
The row-parallel partial products are taken in f32 (``torch.mm`` with an f32
output on CUDA, from the bf16 operands) and summed over the group in f32,
then rounded to the compute dtype once, after the bias: the tensor axis
departs from the unsharded GEMM only by the order of an f32 sum.
Parameter names do not change, so the state-dict keys stay the reference's;
``gather`` joins a piece back (an all-reduce of the pieces padded with
zeros, which runs over gloo on CUDA tensors as over NCCL), and
``Split.piece`` cuts a full tensor, for checkpoints
(``parallel/fsdp.py``).

``dist.REDUCTIONS['tensor']`` counts the activation all-reduces (forward
and backward), ``'tensor_shards'`` those of the norms and statistics
(``parallel/fsdp.py``), ``'tensor_gather'`` the gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as torch_dist
from torch import nn

from avjepa_tpu_torch.parallel import dist


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """How a parameter is cut over a tensor group: along ``dim`` of the full
    tensor, by heads within each of q, k and v when ``heads`` (the fused
    qkv's ``[3, heads, d]`` rows), else in ``size`` contiguous pieces."""

    dim: int
    group: dist.Group
    heads: int = 0

    def piece(self, full: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        """Piece ``index`` (this rank's by default) of the full tensor."""
        index = self.group.index if index is None else index
        n = self.group.size
        if self.heads:
            rest = full.shape[1:]
            h = self.heads // n
            return full.reshape(3, self.heads, -1, *rest)[:, index * h:(index + 1) * h].reshape(
                -1, *rest)
        return full.chunk(n, self.dim)[index]

    def join(self, pieces: list[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every index's piece, in order."""
        if self.heads:
            rest = pieces[0].shape[1:]
            h = self.heads // len(pieces)
            return torch.cat([p.reshape(3, h, -1, *rest) for p in pieces], 1).reshape(-1, *rest)
        return torch.cat(pieces, self.dim)


def _all_reduce(t: torch.Tensor, tp: dist.Group, key: str = "tensor") -> torch.Tensor:
    torch_dist.all_reduce(t, group=tp.group)
    dist.REDUCTIONS[key] += 1
    return t


class _CopyToTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # a copy: the incoming gradient may also flow down the residual
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.tp), None


class _ReduceFromTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor_region(x: torch.Tensor, tp: dist.Group) -> torch.Tensor:
    """``x`` (whole on every rank of ``tp``) into a column-parallel linear:
    the identity, whose backward sums the ranks' partial input gradients."""
    return _CopyToTensorRegion.apply(x, tp)


def reduce_from_tensor_region(x: torch.Tensor, tp: dist.Group) -> torch.Tensor:
    """The ranks' partial sums ``x`` summed over ``tp``; the backward hands
    each rank the whole gradient."""
    return _ReduceFromTensorRegion.apply(x, tp)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result: f32 sums of the products of ``a``'s dtype,
    rounded once at the end (cuBLAS's bf16 GEMM without the last
    rounding)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _RowPartial(torch.autograd.Function):
    """x @ weight^T in f32 from x's dtype (weight cast to it, as ``linear``
    casts); the backward is ``F.linear``'s in x's dtype, weight gradient
    cast back to the weight's."""

    @staticmethod
    def forward(ctx, x, weight):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.weight_dtype = weight.dtype
        return _mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype).reshape(-1, w.shape[0])
        dx = (g @ w).reshape(x.shape)
        dw = (g.t() @ x.reshape(-1, x.shape[-1])).to(ctx.weight_dtype)
        return dx, dw


def row_parallel_linear(layer: nn.Linear, x: torch.Tensor, tp: dist.Group) -> torch.Tensor:
    """A row-parallel ``layer`` (its weight this rank's input columns) on
    this rank's input features ``x``: the partial products in f32, summed
    over ``tp``, the bias (whole, in x's dtype) added once, then rounded to
    x's dtype."""
    y = reduce_from_tensor_region(_RowPartial.apply(x, layer.weight), tp)
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype).float()
    return y.to(x.dtype)


def _cut(layer: nn.Linear, name: str, split: Split) -> None:
    p = getattr(layer, name)
    setattr(layer, name, nn.Parameter(split.piece(p.detach()).clone(memory_format=torch.contiguous_format),
                                      requires_grad=p.requires_grad))
    layer.tensor_splits = {**getattr(layer, "tensor_splits", {}), name: split}


def shard_models(tp: Optional[dist.Group], *modules: nn.Module) -> None:
    """Cut ``modules``' Megatron layers to this rank's piece over ``tp``
    (None, or a group of one: nothing to cut), in place, and set the
    ``tensor`` attribute of each sharded ``Attention``, ``Mlp`` and
    predictor, which then run the collectives. Run it before FSDP2 wraps
    the modules and before an optimizer is built over them."""
    if tp is None or tp.size == 1:
        return
    from avjepa_tpu_torch.models.modules import Attention, Mlp
    from avjepa_tpu_torch.models.predictor import Predictor

    n = tp.size
    for module in modules:
        for m in module.modules():
            if isinstance(m, Attention) and m.num_heads % n == 0:
                _cut(m.qkv, "weight", Split(0, tp, heads=m.num_heads))
                if m.qkv.bias is not None:
                    _cut(m.qkv, "bias", Split(0, tp, heads=m.num_heads))
                _cut(m.proj, "weight", Split(1, tp))
                m.tensor = tp
            elif isinstance(m, Mlp) and m.fc1.out_features % n == 0:
                _cut(m.fc1, "weight", Split(0, tp))
                _cut(m.fc1, "bias", Split(0, tp))
                _cut(m.fc2, "weight", Split(1, tp))
                m.tensor = tp
            elif isinstance(m, Predictor) and m.predictor_embed_dim % n == 0:
                _cut(m.predictor_proj, "weight", Split(1, tp))
                m.tensor = tp


def splits(module: nn.Module) -> dict[str, Split]:
    """The ``Split`` of each of ``module``'s tensor-sharded parameters, by
    state-dict name (empty without the tensor axis)."""
    out = {}
    for prefix, m in module.named_modules():
        for name, split in getattr(m, "tensor_splits", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = split
    return out


def param_splits(params: Iterable[torch.Tensor], modules: Iterable[nn.Module]
                 ) -> list[Optional[Split]]:
    """The ``Split`` (or None) of each of ``params``, looked up among
    ``modules``' parameters (an optimizer's parameters, in its order)."""
    by_id = {}
    for module in modules:
        own = splits(module)
        by_id.update({id(p): own.get(n) for n, p in module.named_parameters()})
    return [by_id.get(id(p)) for p in params]


def gather(local: torch.Tensor, split: Split) -> torch.Tensor:
    """The full tensor from every rank's piece (every rank of the group
    calls it): one all-reduce of the pieces, each padded with zeros in its
    own slot, so that it runs over gloo on CUDA tensors as over NCCL."""
    n = split.group.size
    buf = local.new_zeros((n, *local.shape))
    buf[split.group.index] = local
    return split.join(list(_all_reduce(buf, split.group, "tensor_gather").unbind(0)))
