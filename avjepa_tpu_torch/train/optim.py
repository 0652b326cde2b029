"""Schedules and the optimizer (step-derived, resume-friendly).

Counterpart of ``avjepa_tpu/train/optim.py``: every schedule is a function of
the global step, with the reference's increment-before-evaluate convention
and clamps (reference: src/utils/schedulers.py:11-76). AdamW is
``torch.optim.AdamW``, with decoupled weight decay on the parameters the JAX
package's ``wd_mask`` decays (``avjepa_tpu/train/optim.py:85-93``): those
of two or more dimensions whose names hold no 'bias', and the block
LayerNorm weights, which are 2-D ``[L, D]`` leaves of its depth-stacked
blocks (the PyTorch reference, app/avjepa/utils.py:245-263, decays no
LayerNorm weight); lr and wd are set on its groups every step. The
classification evals' classifier is not depth-stacked in JAX either, so its
groups follow ``wd_mask`` as written (``plain_decays``). Under the fsdp axis
(``parallel/fsdp.py``) the norms, the clip and the EMA work on local shards.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable

import torch
from torch import nn

from avjepa_tpu_torch.parallel import fsdp


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    ipe: int
    num_epochs: int
    ipe_scale: float = 1.25
    warmup_epochs: float = 40.0
    start_lr: float = 2e-4
    ref_lr: float = 6.25e-4
    final_lr: float = 1e-6
    ref_wd: float = 0.04
    final_wd: float = 0.4
    ema_start: float = 0.998
    ema_end: float = 1.0

    @property
    def warmup_steps(self) -> int:
        return int(self.warmup_epochs * self.ipe)

    @property
    def total_steps(self) -> int:
        return int(self.ipe_scale * self.num_epochs * self.ipe)


def lr_at_step(cfg: ScheduleConfig, step: int) -> float:
    """LR used on iteration ``step`` (0-based): WarmupCosineSchedule, whose
    counter is step + 1."""
    s = step + 1.0
    warm = float(cfg.warmup_steps)
    if s < warm:
        return cfg.start_lr + (s / max(warm, 1.0)) * (cfg.ref_lr - cfg.start_lr)
    progress = (s - warm) / max(float(cfg.total_steps - cfg.warmup_steps), 1.0)
    cos_lr = cfg.final_lr + (cfg.ref_lr - cfg.final_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return max(cfg.final_lr, cos_lr)


def wd_at_step(cfg: ScheduleConfig, step: int) -> float:
    """WD on iteration ``step``: CosineWDSchedule, counter step + 1."""
    progress = (step + 1.0) / cfg.total_steps
    wd = cfg.final_wd + (cfg.ref_wd - cfg.final_wd) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return max(cfg.final_wd, wd) if cfg.final_wd <= cfg.ref_wd else min(cfg.final_wd, wd)


def ema_at_step(cfg: ScheduleConfig, step: int) -> float:
    """EMA momentum on iteration ``step``, linear over total_steps
    (reference: app/avjepa/train.py:304-306)."""
    return cfg.ema_start + step / cfg.total_steps * (cfg.ema_end - cfg.ema_start)


# a block's LayerNorm weight: one row of a stacked [L, D] leaf in the JAX package
_BLOCK_NORM = re.compile(r"(^|\.)(blocks|predictor_blocks)\.\d+\.norm[12]\.weight$")


def decays(name: str, p: torch.Tensor) -> bool:
    """True where decoupled weight decay applies: non-bias params of 2+
    dimensions, and the block LayerNorm weights (2-D leaves in JAX)."""
    return (p.ndim >= 2 or _BLOCK_NORM.search(name) is not None) and "bias" not in name


def plain_decays(name: str, p: torch.Tensor) -> bool:
    """JAX ``wd_mask`` on modules that are not depth-stacked (the attentive
    classifier's ``blocks_{i}``): non-bias params of 2+ dimensions only, so
    no LayerNorm weight decays and the 3-D query tokens do."""
    return p.ndim >= 2 and "bias" not in name


def make_optimizer(models: Iterable[nn.Module], betas=(0.9, 0.999),
                   eps: float = 1e-8, rule=decays) -> torch.optim.AdamW:
    """One AdamW over the models' parameters in two groups, with and without
    weight decay as ``rule(name, param)`` says; lr and wd are set by
    ``set_lr_wd`` before every step."""
    decay, no_decay = [], []
    for model in models:
        for name, p in model.named_parameters():
            (decay if rule(name, p) else no_decay).append(p)
    groups = [{"params": decay, "weight_decay": 0.0, "decay": True},
              {"params": no_decay, "weight_decay": 0.0, "decay": False}]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=eps)


def set_lr_wd(optimizer: torch.optim.Optimizer, lr: float, wd: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
        group["weight_decay"] = wd if group["decay"] else 0.0


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all gradients (f32), sharded or not."""
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(fsdp.leaf_norms(grads))


def clip_(grads: list[torch.Tensor], norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ semantics on a precomputed norm; each
    rank scales its shards. Returns the factor applied."""
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_([fsdp.local(g) for g in grads], scale)
    return scale


@torch.no_grad()
def ema_update_(target: nn.Module, online: nn.Module, m: float) -> None:
    """target <- m * target + (1 - m) * online, over all parameters; shard
    by shard (no collective) where the two are sharded alike."""
    tgt = list(target.parameters())
    src = list(online.parameters())
    for t, s in zip(tgt, src):
        if fsdp.is_sharded(t) or fsdp.is_sharded(s):
            if not (fsdp.is_sharded(t) and fsdp.is_sharded(s) and t.placements == s.placements
                    and t.device_mesh == s.device_mesh):
                raise ValueError("the target encoder is not sharded as the encoder is")
    tgt, src = [fsdp.local(t) for t in tgt], [fsdp.local(s) for s in src]
    torch._foreach_mul_(tgt, m)
    torch._foreach_add_(tgt, src, alpha=1.0 - m)
