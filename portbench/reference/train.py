"""The plain float32 reference of the JEPA train step, and what is compared.

One step, as the published recipe sets it out (V-JEPA's ``app/vjepa/
train.py``, AV-JEPA's ``app/avjepa/train.py``):

- the target: the EMA encoder over every token, no gradient, then a
  LayerNorm over features without parameters (epsilon 1e-5);
- for each mask config: the encoder over its context tokens, the predictor
  from them to its target tokens, and mean(|z - h|^p) / p over the targets;
  the loss is the mean over the configs, plus ``reg_coeff`` times
  relu(1 - mean over configs of the predictions' standard deviation);
- the gradient of the encoder and the predictor; each model's gradient is
  clipped to ``clip_grad`` by its global norm once the step is past the
  warm-up epochs;
- AdamW with decoupled weight decay on the leaves of two or more dimensions
  and the blocks' LayerNorm weights, none on a bias (the wd mask of the
  repository's configs); warm-up-then-cosine learning rate, cosine weight
  decay, both read at step + 1;
- the EMA: target = m * target + (1 - m) * encoder, m linear in the step.

``train`` runs a few such steps from given weights and returns what the
benchmark compares: each step's loss, each leaf's gradient norm at the first
step (after the clip), and each leaf's change after the last step.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from portbench.reference.vit import ModelSpec, Numerics, encoder, feature_norm, predictor

_BLOCK_NORM = re.compile(r"(^|\.)(blocks|predictor_blocks)\.\d+\.norm[12]\.weight$")


@dataclasses.dataclass(frozen=True)
class OptSpec:
    lr: float
    start_lr: float
    final_lr: float
    warmup: float
    epochs: int
    ipe: int
    ipe_scale: float
    weight_decay: float
    final_weight_decay: float
    ema: tuple[float, float]
    clip_grad: float | None
    betas: tuple[float, float]
    eps: float
    loss_exp: float
    reg_coeff: float

    @classmethod
    def from_json(cls, d: dict) -> "OptSpec":
        return cls(**{f.name: tuple(d[f.name]) if isinstance(d[f.name], list) else d[f.name]
                      for f in dataclasses.fields(cls)})

    @property
    def warmup_steps(self) -> int:
        return int(self.warmup * self.ipe)

    @property
    def total_steps(self) -> int:
        return int(self.ipe_scale * self.epochs * self.ipe)


def lr_at(o: OptSpec, step: int) -> float:
    s, warm = step + 1.0, float(o.warmup_steps)
    if s < warm:
        return o.start_lr + s / warm * (o.lr - o.start_lr)
    progress = (s - warm) / max(float(o.total_steps - o.warmup_steps), 1.0)
    return max(o.final_lr,
               o.final_lr + (o.lr - o.final_lr) * 0.5 * (1.0 + math.cos(math.pi * progress)))


def wd_at(o: OptSpec, step: int) -> float:
    progress = (step + 1.0) / o.total_steps
    wd = o.final_weight_decay + (o.weight_decay - o.final_weight_decay) * 0.5 * (
        1.0 + math.cos(math.pi * progress))
    if o.final_weight_decay <= o.weight_decay:
        return max(o.final_weight_decay, wd)
    return min(o.final_weight_decay, wd)


def ema_at(o: OptSpec, step: int) -> float:
    return o.ema[0] + step / o.total_steps * (o.ema[1] - o.ema[0])


def decays(name: str, shape) -> bool:
    return (len(shape) >= 2 or _BLOCK_NORM.search(name) is not None) and "bias" not in name


def loss_fn(enc: dict, pred: dict, tgt: dict, s: ModelSpec, o: OptSpec, video, audio,
            masks, num: Numerics) -> torch.Tensor:
    """masks: per config (context indices [B, K], target indices [B, P])."""
    with torch.no_grad():
        h = feature_norm(encoder(tgt, s, video, audio, None, num))
    total, stds = 0.0, 0.0
    for i, (ci, pi) in enumerate(masks):
        z = predictor(pred, s, encoder(enc, s, video, audio, ci, num), ci, pi, i, num)
        ht = torch.gather(h, 1, pi[..., None].expand(-1, -1, h.shape[-1]))
        total = total + ((z - ht).abs() ** o.loss_exp).mean() / o.loss_exp
        if o.reg_coeff:
            stds = stds + torch.sqrt(z.var(1, unbiased=True) + 1e-4)
    loss = total / len(masks)
    if o.reg_coeff:
        loss = loss + o.reg_coeff * torch.relu(1.0 - stds / len(masks)).mean()
    return loss


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def train(s: ModelSpec, o: OptSpec, enc0: dict, pred0: dict, batches, steps: int,
          num: Numerics, half_batch: bool = False) -> dict:
    """``steps`` steps from the weights ``enc0`` (the encoder and the target
    encoder) and ``pred0``; ``batches[i]`` = (video, audio, masks) of step i.
    ``half_batch`` takes the first half of every batch alone (a fault the
    comparison has to catch). Returns {"losses": [...], "grad": {leaf:
    norm}, "change": {leaf: norm}}, leaves named ``encoder.<key>``,
    ``predictor.<key>``, ``target_encoder.<key>``."""
    enc = {k: v.detach().clone().requires_grad_() for k, v in enc0.items()}
    pred = {k: v.detach().clone().requires_grad_() for k, v in pred0.items()}
    tgt = {k: v.detach().clone() for k, v in enc0.items()}
    models = {"encoder": enc, "predictor": pred}
    moments = {(m, k): (torch.zeros_like(v), torch.zeros_like(v))
               for m, d in models.items() for k, v in d.items()}
    b1, b2 = o.betas
    losses, first_grads = [], {}
    for step in range(steps):
        video, audio, masks = batches[step]
        if half_batch:
            half = video.shape[0] // 2
            video = video[:half]
            audio = None if audio is None else audio[:half]
            masks = [(ci[:half], pi[:half]) for ci, pi in masks]
        loss = loss_fn(enc, pred, tgt, s, o, video, audio, masks, num)
        leaves = [(m, k, v) for m, d in models.items() for k, v in d.items()]
        grads = torch.autograd.grad(loss, [v for _, _, v in leaves])
        losses.append(float(loss.detach()))
        by_model: dict[str, list] = {}
        for (m, k, _), g in zip(leaves, grads):
            by_model.setdefault(m, []).append(g)
        if o.clip_grad is not None and step // o.ipe > int(o.warmup):
            for gs in by_model.values():
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                             for g in gs]))
                scale = torch.clamp(o.clip_grad / (norm + 1e-6), max=1.0)
                for g in gs:
                    g.mul_(scale)
        if step == 0:
            first_grads = {f"{m}.{k}": _norm(g) for (m, k, _), g in zip(leaves, grads)}
        lr, wd, t = lr_at(o, step), wd_at(o, step), step + 1
        with torch.no_grad():
            for (m, k, p), g in zip(leaves, grads):
                mu, nu = moments[(m, k)]
                if decays(k, p.shape):
                    p.mul_(1.0 - lr * wd)
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (nu.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(o.eps)
                p.addcdiv_(mu, denom, value=-lr / (1.0 - b1 ** t))
            m_ema = ema_at(o, step)
            for k, v in tgt.items():
                v.mul_(m_ema).add_(enc[k], alpha=1.0 - m_ema)
        del loss, grads
    change = {f"encoder.{k}": _norm(v.detach() - enc0[k]) for k, v in enc.items()}
    change.update({f"predictor.{k}": _norm(v.detach() - pred0[k]) for k, v in pred.items()})
    change.update({f"target_encoder.{k}": _norm(v - enc0[k]) for k, v in tgt.items()})
    return {"losses": losses, "grad": first_grads, "change": change}
