"""Data parallelism over ``torch.distributed``: the port's counterpart of the
data and fsdp axes of ``avjepa_tpu/parallel/mesh.py``.

The JAX package builds a ``('data', 'fsdp', 'tensor')`` mesh over every
device of every host and lets XLA insert the collectives: its loss is a mean
over the global batch, so its gradients come out averaged. Here one process
drives one GPU (torchrun's layout: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), a rank is what a JAX host is, and the
collectives are explicit:
  - ``init_distributed``: join the process group (NCCL on CUDA, gloo when the
    CPU is asked for) and bind this rank's GPU;
  - ``make_mesh``: check a config's mesh against the world and lay the ranks
    out on it as JAX lays out devices (row-major ``(data, fsdp, tensor)``);
    with ``tensor > 1`` build the tensor groups (the ranks that share one
    batch, ``parallel/tensor.py``) and the batch groups (one rank per tensor
    index, ``data x fsdp`` ranks each); with ``fsdp > 1`` build the
    ``DeviceMesh`` of the batch group that ``parallel/fsdp.py`` shards the
    models over;
  - ``all_reduce_grads``: the gradients of a step averaged over the ranks of
    a batch group in one all-reduce of their flattened concatenation
    (FSDP2's reduce-scatter averages those of the sharded models);
  - ``reduce``: a tensor summed, averaged, or its min or max over the ranks,
    or over a batch group (the metrics a step logs);
  - ``count_correct`` / ``count_valid``: an eval's top-1 counts over the
    global batch (``mesh.py:224-248``);
  - ``agree``: a flag raised on any rank (the SIGTERM agreement);
  - ``broadcast_module``: rank 0's weights to every rank;
  - ``barrier``.
Without a process group (one process, ``app.main``), ``world()`` is 1 and
every helper is the identity. A helper given ``group=None`` works over the
world: without the tensor axis the batch group is the world. ``REDUCTIONS``
counts the collectives each helper issued, by helper.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

REDUCTIONS: collections.Counter = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def active() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    return rank() == 0


def init_distributed(device: str | torch.device = "cuda", backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group that torchrun's environment describes; returns
    this rank's device. On CUDA a device without an index becomes
    ``cuda:LOCAL_RANK``, and a local rank with no GPU raises (there is no
    fall back to the CPU). ``backend`` defaults to NCCL on CUDA and gloo on
    the CPU; collectives wait at most ``timeout_s`` seconds."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"torch.distributed environment incomplete, missing {missing}: "
                           "launch with torchrun or main_distributed --nproc-per-node N")
    rank_, world_ = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank_))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; to run on the CPU, ask for it "
                "with --device cpu (device='cpu')"
            )
        if device.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"local rank {local} has no GPU: this host has "
                                   f"{torch.cuda.device_count()}")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank_, world_size=world_, timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if active():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """A process group of some of the ranks: this rank is number ``index`` of
    ``size``."""

    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    fsdp: int = 1
    tensor: int = 1
    # the batch group as a ('data', 'fsdp') DeviceMesh (('fsdp',) when data is
    # 1), built when fsdp > 1: FSDP2 replicates over 'data' and shards over
    # 'fsdp'
    device_mesh: Optional[DeviceMesh] = dataclasses.field(default=None, compare=False, repr=False)
    # with tensor > 1: this rank's batch group (the data x fsdp ranks at its
    # tensor index; None is the world) and tensor group
    batch_group: Optional[Group] = dataclasses.field(default=None, compare=False, repr=False)
    tensor_group: Optional[Group] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def batch(self) -> int:
        """The ranks that load distinct samples: the global batch is the
        local batch times this."""
        return self.data * self.fsdp

    @property
    def batch_rank(self) -> int:
        """This rank's shard of the sampler, of ``batch``."""
        return rank() // self.tensor


def size(group: Optional[Group] = None) -> int:
    """The ranks of ``group``; the world's for None."""
    return group.size if group is not None else world()


def _subgroups(ranks: list[list[int]]) -> Group:
    """A process group for each list of ranks (every rank creates each, in
    the same order); this rank's."""
    own, _ = dist.new_subgroups_by_enumeration(ranks)
    mine = next(r for r in ranks if rank() in r)
    return Group(own, len(mine), mine.index(rank()))


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
              device: str | torch.device = "cpu") -> Mesh:
    """The config's ``tpu.mesh_*`` axes checked against the world: ``data ==
    -1`` takes what is left, and the axes must multiply to the world size
    (``mesh.py:72-86``). The ranks are laid out row-major as JAX lays its
    devices out: rank ``r`` is tensor index ``r % tensor``, fsdp index ``(r
    // tensor) % fsdp``, data index ``r // (fsdp * tensor)``. With ``tensor >
    1`` the mesh carries this rank's tensor group (its ``tensor`` ranks
    share one batch) and batch group (the ``data x fsdp`` ranks at its
    tensor index); with ``fsdp > 1`` a ``DeviceMesh`` of ``device``'s type
    over its batch group, from a 3-D ``('data', 'fsdp', 'tensor')`` mesh."""
    n = world()
    if data == -1:
        data = n // (fsdp * tensor)
    if data < 1 or data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} processes")
    device_mesh = batch_group = tensor_group = None
    kind = torch.device(device).type
    if fsdp > 1 and tensor > 1:
        full = init_device_mesh(kind, (data, fsdp, tensor), mesh_dim_names=("data", "fsdp",
                                                                            "tensor"))
        device_mesh = full["data", "fsdp"] if data > 1 else full["fsdp"]
    elif fsdp > 1:
        shape, names = ((data, fsdp), ("data", "fsdp")) if data > 1 else ((fsdp,), ("fsdp",))
        device_mesh = init_device_mesh(kind, shape, mesh_dim_names=names)
    if tensor > 1:
        tensor_group = _subgroups([list(range(b * tensor, (b + 1) * tensor))
                                   for b in range(n // tensor)])
        batch_group = _subgroups([list(range(t, n, tensor)) for t in range(tensor)])
    return Mesh(data, fsdp, tensor, device_mesh, batch_group, tensor_group)


def all_reduce_grads(modules: Iterable[nn.Module], group: Optional[Group] = None) -> None:
    """Average the gradients of ``modules`` over the ranks of ``group`` (a
    batch group; None: the world): one all-reduce of their concatenation,
    after the backward pass and before any norm or clip reads them. Each
    ``p.grad`` becomes a view of the reduced buffer. Every rank must hold
    gradients for the same parameters (the same graph), all of one dtype.
    FSDP2's sharded parameters (DTensors) are left out: its reduce-scatter
    in the backward pass averaged them already."""
    if not active():
        return
    params = [p for m in modules for p in m.parameters()
              if p.grad is not None and not isinstance(p, DTensor)]
    if not params:
        return
    if len({p.grad.dtype for p in params}) > 1:
        dtypes = sorted({str(p.grad.dtype) for p in params})
        raise ValueError(f"gradients of several dtypes: {dtypes}")
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=None if group is None else group.group)
    REDUCTIONS["grads"] += 1
    if size(group) > 1:
        flat.div_(size(group))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def reduce(t: torch.Tensor, op: str = "mean", group: Optional[Group] = None) -> torch.Tensor:
    """``t`` summed (``sum``), averaged (``mean``), or its elementwise
    ``min`` or ``max`` over the ranks of ``group`` (a batch group; None: the
    world), as a new tensor on ``t``'s device; ``t`` itself without a
    process group. A host tensor travels over NCCL through the current
    GPU."""
    if not active():
        return t
    out = t.detach().to(_scalar_device() if t.device.type == "cpu" else t.device, copy=True)
    dist.all_reduce(out, _OPS[op], group=None if group is None else group.group)
    REDUCTIONS[op] += 1
    if op == "mean" and size(group) > 1:
        out = out / size(group)
    return out.to(t.device)


def _scalar_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def count_correct(probs: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> int:
    """Rows of the global batch whose argmax is the label, among those
    ``valid`` marks (the wrap-padded and failed rows left out)."""
    ok = probs.argmax(-1) == labels
    if valid is not None:
        ok = ok & valid
    return int(reduce(ok.sum(), "sum").item())


def count_valid(valid: torch.Tensor) -> int:
    """Valid rows of the global batch."""
    return int(reduce(valid.sum(), "sum").item())


def agree(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any: a MAX all-reduce
    that every rank must enter at the same point of its loop."""
    if not active():
        return bool(flag)
    return bool(reduce(torch.tensor([int(flag)], device=_scalar_device()), "max").item())


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module``: one broadcast for each dtype."""
    if world() == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        REDUCTIONS["broadcast"] += 1
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


def barrier() -> None:
    if active():
        dist.barrier()
