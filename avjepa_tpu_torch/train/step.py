"""The JEPA train step: target / context / predictor forward, masked L1 loss
with the variance regulariser, backward, per-model grad clip, AdamW, and the
EMA target update.

Counterpart of ``avjepa_tpu/train/step.py`` (reference:
app/avjepa/train.py:435-537). Every schedule is a function of
``state.step``; masks are dense bools, plus the compact index arrays of the
collator. PyTorch runs it eagerly: the attention layers launch the port's
CUDA kernels on the GPU, forward and backward.

Data parallel (one process per GPU, ``parallel/dist.py``): each rank runs
its local batch, and the step equals the JAX step over the global batch.
The JEPA loss is a masked mean over the global batch, so each rank divides
its local masked sum by the all-reduced count of masked elements, times the
world size: the gradients averaged over the ranks are then the global
mean's. The variance regulariser is a mean over samples, which equal local
batches keep. One all-reduce averages the encoder's and the predictor's
gradients after the backward pass, before the norms and the clip, so the
clip, AdamW and the EMA see the same gradients on every rank and the
weights stay the same. The logged scalars are reduced over the ranks.

Under the fsdp axis (``parallel/fsdp.py``) the models' parameters,
gradients and AdamW moments are sharded: FSDP2's reduce-scatter averages the
gradients in the backward pass and the all-reduce leaves them alone, so no
gradient is averaged twice. The per-parameter
gradient norms (for the global norms, the clip and ``grad_stats``) and the
moments' |x| sums come from the local shards and one all-reduce each over
the shard group; the clip and the EMA scale shard by shard.

Under the tensor axis (``parallel/tensor.py``) the ranks of a tensor group
run one batch and hold pieces of the Megatron layers: the batch group (one
rank per tensor index, ``state.batch_group``) takes the place of the world
in the loss's scale, the target count and every reduction above, and the
norms and moments' statistics of a cut parameter also sum over the tensor
group, so that the clip, ``grad_stats``, AdamW and the EMA see the global
tensors' statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from avjepa_tpu_torch.models.predictor import scatter_rows
from avjepa_tpu_torch.parallel import dist, fsdp, tensor
from avjepa_tpu_torch.train.optim import (
    ScheduleConfig,
    clip_,
    decays,
    ema_at_step,
    ema_update_,
    lr_at_step,
    set_lr_wd,
    wd_at_step,
)
from avjepa_tpu_torch.train.state import TrainState
from avjepa_tpu_torch.utils.tensors import masked_var


@dataclasses.dataclass(frozen=True)
class StepConfig:
    loss_exp: float = 1.0
    reg_coeff: float = 0.0
    clip_grad: Optional[float] = 10.0
    warmup_epochs: int = 40  # grad clip enabled only after this many epochs
    ipe: int = 300


def feature_layer_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LN over the feature dim (torch F.layer_norm's default
    eps), applied to target-encoder outputs (reference:
    app/avjepa/train.py:448)."""
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    return (h - mean) * torch.rsqrt(var + eps)


def jepa_loss(z: torch.Tensor, h: torch.Tensor, pred_mask: torch.Tensor,
              loss_exp: float, count: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Masked ``mean(|z-h|^loss_exp)/loss_exp`` over target positions
    (reference: app/avjepa/train.py:490-495): the local masked sum over
    ``count`` target tokens of the global batch, times ``shards``, the ranks
    that load distinct samples (the batch group's size), so that the mean
    over them is the global masked mean."""
    diff = (z.float() - h.float()).abs() ** loss_exp
    total = (diff * pred_mask[..., None].to(diff.dtype)).sum()
    denom = (count.to(diff.dtype) * diff.shape[-1]).clamp(min=1.0)
    return total / denom * shards / loss_exp


def loss_fn(state: TrainState, cfg: StepConfig, video, audio, enc_masks, pred_masks,
            enc_idx=None, union_idx=None, draws: Optional[dict] = None):
    """(loss, loss_jepa, loss_reg) of one batch; enc_masks/pred_masks
    [M, B, N] bool, enc_idx a sequence of M [B, K_i] or None, union_idx
    [M, B, Ku] or None. ``draws``: the diffusion predictor's
    (``Predictor.diffusion_draws``); by default drawn from a generator
    seeded with the step, as the JAX step folds the step into its key."""
    num_cfgs, b, n = enc_masks.shape
    encoder, predictor = state.encoder, state.predictor

    # target: full-sequence EMA encoder, feature-dim LN, no gradients
    with torch.no_grad():
        h = feature_layer_norm(state.target_encoder(video, audio).float())

    # the diffusion-fallback predictor (use_mask_tokens: false) seeds its
    # targets from h, noised with this step's draws; every mask config gets
    # the same draws, as in avjepa_tpu/train/step.py:139-146
    pred_kwargs = {}
    if not predictor.use_mask_tokens:
        if draws is None:
            draws = predictor.diffusion_draws(
                b, torch.Generator(device=h.device).manual_seed(state.step))
        pred_kwargs = dict(target=h, draws=draws)

    def encode_ctx(i):
        if enc_idx is not None:
            # compacted: encode only the kept tokens (a K bucket), scatter back
            idx = enc_idx[i]
            ctx_c = encoder(video, audio, key_mask=idx < n, gather_idx=idx)
            return scatter_rows(ctx_c, idx, n)
        return encoder(video, audio, key_mask=enc_masks[i])

    if predictor.use_mask_tokens and num_cfgs > 1:
        # every mask config through ONE predictor pass, merged batch-major
        # ([b0cfg0, b0cfg1, b1cfg0, ...]) with a per-sample mask-token index,
        # then split by reshape (avjepa_tpu/train/step.py:170-199)
        ctx_all = torch.stack([encode_ctx(i) for i in range(num_cfgs)], 1)
        ctx_all = ctx_all.reshape(b * num_cfgs, n, ctx_all.shape[-1])
        enc_all = enc_masks.transpose(0, 1).reshape(b * num_cfgs, n)
        pred_all = pred_masks.transpose(0, 1).reshape(b * num_cfgs, n)
        midx = torch.arange(num_cfgs, device=enc_masks.device).repeat(b)
        u_all = None
        if union_idx is not None:
            u_all = union_idx.transpose(0, 1).reshape(b * num_cfgs, union_idx.shape[-1])
        z_all = predictor(ctx_all, enc_all, pred_all, midx, gather_idx=u_all)
        zs = z_all.reshape(b, num_cfgs, n, z_all.shape[-1]).unbind(1)
    else:
        # one predictor call per mask config (avjepa_tpu/train/step.py:200-209)
        zs = [predictor(encode_ctx(i), enc_masks[i], pred_masks[i], i,
                        gather_idx=None if union_idx is None else union_idx[i], **pred_kwargs)
              for i in range(num_cfgs)]

    # target tokens of each mask config over the global batch
    group = state.batch_group
    counts = dist.reduce(pred_masks.flatten(1).sum(1), "sum", group)
    loss_jepa = 0.0
    pstd = 0.0
    for i, z in enumerate(zs):
        loss_jepa = loss_jepa + jepa_loss(z, h, pred_masks[i], cfg.loss_exp, counts[i],
                                          dist.size(group))
        # predictor std across target tokens (reference reg_fn, train.py:497-498)
        zv = masked_var(z.float(), pred_masks[i][..., None], dim=1)
        pstd = pstd + torch.sqrt(zv + 1e-4)
    loss_jepa = loss_jepa / num_cfgs
    loss_reg = torch.relu(1.0 - pstd / num_cfgs).mean()
    return loss_jepa + cfg.reg_coeff * loss_reg, loss_jepa, loss_reg


def _grads(module: torch.nn.Module) -> list[tuple[str, torch.Tensor]]:
    return [(n, p.grad) for n, p in module.named_parameters() if p.grad is not None]


def _splits(module: torch.nn.Module, named) -> list:
    """The tensor-axis split of each named tensor of ``module``."""
    own = tensor.splits(module)
    return [own.get(n) for n, _ in named]


def grad_stats(named_grads, norms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """The JAX package's grad_stats (``avjepa_tpu/train/step.py:337-362``;
    reference grad_logger, src/utils/logging.py:91-105) from the gradients'
    names and their norms (``norms[i]`` of ``named_grads[i]``): the mean of
    the per-leaf grad norms over the leaves that decay (``decays``: 2+ dims
    or a block LayerNorm weight, no bias), and the first and last block's
    qkv weight grad norm. Leaves are counted as the JAX package counts its
    own: one entry per block parameter (its stacked leaves count per layer),
    and one per stream for the mask tokens (an [M, Dp] leaf there)."""
    by_name = {n: v for (n, g), v in zip(named_grads, norms) if decays(n, g)}
    leaves: dict[str, list] = {}
    for n, v in by_name.items():
        leaves.setdefault(n.rsplit(".", 1)[0] if n.startswith("mask_tokens") else n, []).append(v)
    qkv = sorted((n for n in by_name if n.endswith("attn.qkv.weight")),
                 key=lambda n: int(n.split(".")[1]))
    z = torch.zeros((), device=norms.device)
    avg = torch.stack([v[0] if len(v) == 1 else torch.linalg.vector_norm(torch.stack(v))
                       for v in leaves.values()]).mean() if by_name else z
    return avg, by_name[qkv[0]] if qkv else z, by_name[qkv[-1]] if qkv else z


def _abs_means(optimizer: torch.optim.Optimizer, module: torch.nn.Module):
    """The mean over the module's params of mean |moment|, for AdamW's two
    moments (reference adamw_logger, src/utils/logging.py:108-118)."""
    named = [(n, p) for n, p in module.named_parameters() if p in optimizer.state]
    params = [p for _, p in named]
    means = fsdp.leaf_abs_means([optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq")
                                 for p in params], _splits(module, named) * 2)
    return [m.mean() for m in means.split(len(params))]


def train_step(state: TrainState, sched: ScheduleConfig, cfg: StepConfig, video, audio,
               enc_masks, pred_masks, enc_idx=None, union_idx=None,
               full_metrics: bool = True, draws: Optional[dict] = None) -> dict:
    """One step in place on ``state``; returns its metrics as Python numbers.

    ``full_metrics=False`` skips the diagnostics read only at log boundaries
    (``grad_stats``, optimizer moments, input variance); ``draws``
    goes to ``loss_fn``."""
    step = state.step
    lr, wd = lr_at_step(sched, step), wd_at_step(sched, step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_jepa, loss_reg = loss_fn(state, cfg, video, audio, enc_masks, pred_masks,
                                        enc_idx, union_idx, draws)
    loss.backward()
    dist.all_reduce_grads([state.encoder, state.predictor], state.batch_group)

    # per-model global norms from the per-parameter ones; the clip only
    # after warmup (reference: train.py:518-520)
    enc_g, pred_g = _grads(state.encoder), _grads(state.predictor)
    splits = _splits(state.encoder, enc_g) + _splits(state.predictor, pred_g)
    enc_n, pred_n = fsdp.leaf_norms([g for _, g in enc_g + pred_g], splits).split(
        [len(enc_g), len(pred_g)])
    enc_norm, pred_norm = torch.linalg.vector_norm(enc_n), torch.linalg.vector_norm(pred_n)
    if cfg.clip_grad is not None and step // cfg.ipe > cfg.warmup_epochs:
        enc_n = enc_n * clip_([g for _, g in enc_g], enc_norm, cfg.clip_grad)
        pred_n = pred_n * clip_([g for _, g in pred_g], pred_norm, cfg.clip_grad)

    set_lr_wd(state.optimizer, lr, wd)
    state.optimizer.step()
    m = ema_at_step(sched, step)
    ema_update_(state.target_encoder, state.encoder, m)
    state.step = step + 1

    scalars = {"loss": loss, "loss_jepa": loss_jepa, "loss_reg": loss_reg,
               "enc_grad_norm": enc_norm, "pred_grad_norm": pred_norm}
    if full_metrics:
        # the clipped gradients' statistics, as the JAX step logs them
        enc_avg, enc_first, enc_last = grad_stats(enc_g, enc_n)
        mu, nu = _abs_means(state.optimizer, state.encoder)
        var = video.float().flatten(1).var(1, unbiased=False)
        scalars.update({
            "enc_grad_avg": enc_avg,
            "enc_grad_first_qkv": enc_first,
            "enc_grad_last_qkv": enc_last,
            "pred_grad_avg": grad_stats(pred_g, pred_n)[0],
            "opt_mu_abs": mu,
            "opt_nu_abs": nu,
            "input_var": var.mean(),
            "input_var_min": var.min(),
        })
    # the losses and the input variance are means over the global batch, the
    # input variance's min a min; the norms and the optimizer statistics
    # already agree on every rank
    means = [k for k in ("loss", "loss_jepa", "loss_reg", "input_var") if k in scalars]
    scalars.update(zip(means, dist.reduce(torch.stack([scalars[k].float() for k in means]),
                                          "mean", state.batch_group).unbind()))
    if "input_var_min" in scalars:
        scalars["input_var_min"] = dist.reduce(scalars["input_var_min"].float(), "min",
                                               state.batch_group)
    values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=loss.device)
                          for v in scalars.values()]).tolist()  # one device sync
    metrics = dict(zip(scalars, values))
    metrics.update(lr=lr, wd=wd, ema=m,
                   mask_sizes=enc_masks[:, 0, :].sum(1).float().tolist())
    return metrics
