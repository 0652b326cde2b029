"""The fsdp axis of ``avjepa_tpu/parallel/mesh.py`` over FSDP2
(``torch.distributed.fsdp.fully_shard`` on a ``DeviceMesh``).

The JAX package turns ``tpu.mesh_fsdp`` into ZeRO-3: ``_param_spec``
(``mesh.py:102-148``) shards a parameter's largest dimension over 'fsdp'
when it has 2+ dimensions and at least ``_FSDP_MIN_SIZE = 2**17`` elements
and is not under ``patch_embed``; every other parameter is replicated.
``state_shardings`` applies the rule to the encoder, the predictor, the
target encoder and both AdamW moments, and avprediction to its frozen
target encoder and predictor (``avjepa_tpu/train/avprediction.py:123-140``);
the probe stays replicated.

The port's rule (``shard_models``): each transformer block is an FSDP2 unit
(``blocks.{i}`` of the encoder and the target encoder,
``predictor_blocks.{i}`` of the predictor), and each model is the root unit
over the rest of its parameters. So every parameter of a sharded model is a
DTensor, sharded along dimension 0: a superset of the JAX rule's
(``tests/test_torch_fsdp.py`` holds the two against each other), which
replicates what is under ``patch_embed``, the 1-D parameters and the
tensors below ``_FSDP_MIN_SIZE`` (the mask tokens, the norms, the blocks'
biases). Which parameter is sharded, and along which dimension, is layout,
not numerics: gradients, norms, the EMA and the loss are those of the
unsharded step. Sharding every parameter keeps each model's parameters,
gradients and AdamW moments of one kind, so a foreach op, AdamW's two
groups and ``optimizer.state_dict()``'s index layout are those of the
unsharded model; and one root per model lets FSDP2 issue a block's
all-gather while the block before it computes (a root makes its gathers
wait for the compute stream at every forward).

Parameters stay f32 when gathered (no ``MixedPrecisionPolicy``; the blocks
cast to the compute dtype per use), so each rank's gradients reach the
reduce-scatter in f32, as they reach the data axis's all-reduce. The
reduce-scatter averages the gradients over every rank (HSDP: over 'fsdp',
then over 'data'); ``dist.all_reduce_grads`` leaves the DTensors alone.

Under the tensor axis (``parallel/tensor.py``) the models hold their
ranks' pieces of the Megatron layers before FSDP2 wraps them, and FSDP2
shards those pieces over the batch group's fsdp dimension: fsdp stacked on
the tensor dimension as JAX's ``("tensor", "fsdp")`` for the column layers
(dimension 0 is the cut one), on the output dimension for the row layers
(JAX stacks it on their cut input dimension; layout, not numerics). The
helpers below sum the tensor group too where a parameter is cut.

The helpers here take sharded (DTensor) and plain tensors alike, and are the
identity's equivalent without sharding:
  - ``leaf_norms`` / ``leaf_abs_means``: per-tensor L2 norms and mean |x| of
    the full tensors, from the local shards and one all-reduce over the
    shard group (``dist.REDUCTIONS['shards']``);
  - ``full_state_dict`` / ``load_full_state_dict``: a module's full state on
    rank 0's host (the gathers are collectives: every rank enters), and a
    full state loaded on every rank and re-sharded;
  - ``full_optimizer_state_dict`` / ``load_full_optimizer_state_dict``: the
    same for an optimizer's state, in ``optimizer.state_dict()``'s layout,
    so that a checkpoint crosses between fsdp, data and one process.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as torch_dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from avjepa_tpu_torch.parallel import dist, tensor

# the ModuleLists of transformer blocks: the encoder's and the predictor's
BLOCK_LISTS = ("blocks", "predictor_blocks")


def shard_models(mesh: DeviceMesh, *modules: nn.Module) -> None:
    """Shard every parameter of ``modules`` over ``mesh``: each transformer
    block an FSDP2 unit, each module the root unit over the rest. Parameters
    become DTensors sharded over the mesh's last dimension (replicated over
    'data' on a 2-D mesh), gathered before a unit's forward and again
    before its backward (and a block's recompute under remat: the block
    module itself is the unit, so the hooks fire inside
    ``torch.utils.checkpoint``), and freed after each, the root's too: the
    frozen models and the target encoder run no backward to free them.
    Parameter names do not change."""
    for module in modules:
        for name, blocks in module.named_children():
            if name in BLOCK_LISTS:
                for blk in blocks:
                    fully_shard(blk, mesh=mesh, reshard_after_forward=True)
        fully_shard(module, mesh=mesh, reshard_after_forward=True)


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` (``t`` itself when it is not sharded)."""
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_group(t: DTensor):
    """The process group over which ``t``'s shards are split."""
    dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    if len(dims) != 1:
        raise ValueError(f"expected one sharded mesh dimension, got {t.placements}")
    return t.device_mesh.get_group(dims[0])


def _sum_shards(values: torch.Tensor, tensors: Sequence[torch.Tensor],
                splits: Sequence | None = None) -> torch.Tensor:
    """``values[..., i]``, a sum over the local shard of ``tensors[i]``,
    summed over the shard group where that tensor is sharded (one
    all-reduce of the sharded columns), then over the tensor group where
    ``splits[i]`` (``parallel/tensor.py``) says it is cut (one more): a
    replicated column is counted once."""
    cols = [i for i, t in enumerate(tensors) if is_sharded(t)]
    if cols:
        idx = torch.tensor(cols, device=values.device)
        part = values.index_select(-1, idx).contiguous()
        torch_dist.all_reduce(part, group=_shard_group(tensors[cols[0]]))
        dist.REDUCTIONS["shards"] += 1
        values = values.index_copy(-1, idx, part)
    cols = [i for i, s in enumerate(splits or ()) if s is not None]
    if cols:
        idx = torch.tensor(cols, device=values.device)
        part = values.index_select(-1, idx).contiguous()
        torch_dist.all_reduce(part, group=splits[cols[0]].group.group)
        dist.REDUCTIONS["tensor_shards"] += 1
        values = values.index_copy(-1, idx, part)
    return values


def leaf_norms(tensors: Sequence[torch.Tensor], splits: Sequence | None = None) -> torch.Tensor:
    """The L2 norm of each full tensor, f32 ``[len(tensors)]``: the local
    shards' squared norms summed over the shard group and, for a tensor cut
    by the tensor axis (``splits[i]`` not None), over the tensor group, then
    the roots."""
    if not tensors:
        return torch.zeros(0)
    norms = torch.stack(torch._foreach_norm([local(t) for t in tensors])).float()
    if not any(is_sharded(t) for t in tensors) and not any(s is not None for s in splits or ()):
        return norms
    return _sum_shards(norms.square(), tensors, splits).sqrt()


def leaf_abs_means(tensors: Sequence[torch.Tensor], splits: Sequence | None = None
                   ) -> torch.Tensor:
    """The mean |x| of each full tensor, f32 ``[len(tensors)]``: the local
    shards' sums of |x| and element counts summed over the shard group (and
    the tensor group, as ``leaf_norms``)."""
    locs = [local(t) for t in tensors]
    sums = torch.stack(torch._foreach_norm(locs, 1)).float()
    counts = torch.tensor([float(t.numel()) for t in locs], device=sums.device)
    sums, counts = _sum_shards(torch.stack([sums, counts]), tensors, splits).unbind()
    return sums / counts


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole, detached, on the host (an all-gather when sharded: every
    rank of the mesh must call it)."""
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The full tensor ``full`` placed as ``like`` is: a DTensor holding this
    rank's shard when ``like`` is sharded (cut from ``full``, which every
    rank holds: no collective), else ``full`` itself."""
    if not isinstance(like, DTensor):
        return full
    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh,
                             like.placements, src_data_rank=None)


def _gather_on_main(t: torch.Tensor, split=None):
    """``full_tensor(t)`` on rank 0, joined over the tensor group where
    ``split`` (``parallel/tensor.py``) cuts it; on the other ranks only
    their part in the gathers, and None: a copy of the whole state on the
    host of every rank is what writing a checkpoint must not cost."""
    if split is not None:
        whole = tensor.gather(t.full_tensor() if is_sharded(t) else t.detach(), split)
        return whole.cpu() if dist.is_main() else None
    if dist.is_main():
        return full_tensor(t)
    if is_sharded(t):
        t.full_tensor()
    return None


def _cut(full: torch.Tensor, like: torch.Tensor, split=None) -> torch.Tensor:
    """A full tensor placed as ``like`` is: this rank's tensor piece, then
    its shard."""
    return shard_like(full if split is None else split.piece(full), like)


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with every tensor whole (gathered over the
    shard group and joined over the tensor group: the fused qkv's heads back
    in ``[3, H, d]`` order), on the host of rank 0; every rank must call it
    (the gathers), the others get an empty dict."""
    splits = tensor.splits(module)
    out = {k: _gather_on_main(v, splits.get(k)) for k, v in module.state_dict().items()}
    return out if dist.is_main() else {}


@torch.no_grad()
def load_full_state_dict(module: nn.Module, state: dict) -> None:
    """``module.load_state_dict(state, strict=True)`` for a full ``state``
    that every rank holds: each entry is cut to this rank's tensor piece and
    shard first."""
    own, splits = module.state_dict(), tensor.splits(module)
    module.load_state_dict({k: _cut(v, own[k], splits.get(k)) if k in own else v
                            for k, v in state.items()}, strict=True)


def _opt_splits(optimizer: torch.optim.Optimizer, modules) -> list:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return tensor.param_splits(params, modules or ())


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer,
                              modules: Sequence[nn.Module] = ()) -> dict:
    """``optimizer.state_dict()`` with every state tensor whole, on the
    host of rank 0, as ``full_state_dict``; the other ranks get an empty
    dict. ``modules``: the models the optimizer steps, whose tensor-axis
    splits the moments share."""
    own = optimizer.state_dict()
    splits = _opt_splits(optimizer, modules)
    state = {i: {k: _gather_on_main(v, splits[int(i)] if v.dim() else None)
                 for k, v in s.items()} for i, s in own["state"].items()}
    return {"state": state, "param_groups": own["param_groups"]} if dist.is_main() else {}


def load_full_optimizer_state_dict(optimizer: torch.optim.Optimizer, state: dict,
                                   modules: Sequence[nn.Module] = ()) -> None:
    """``optimizer.load_state_dict(state)`` for a whole ``state`` that every
    rank holds (``full_optimizer_state_dict``'s, or a file written without
    sharding): each state tensor of a sharded parameter is cut to this
    rank's piece and shard first."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if [len(g["params"]) for g in state["param_groups"]] != [
            len(g["params"]) for g in optimizer.param_groups]:
        raise ValueError("the optimizer state's parameter groups do not match the optimizer's")
    splits = _opt_splits(optimizer, modules)
    own = {j: {k: _cut(v, params[int(j)], splits[int(j)]) if v.dim() else v
               for k, v in s.items()}
           for j, s in state["state"].items()}
    optimizer.load_state_dict({"state": own, "param_groups": state["param_groups"]})
