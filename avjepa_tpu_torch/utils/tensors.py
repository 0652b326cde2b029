"""Masked reductions of the training loss (counterpart of
``avjepa_tpu/utils/tensors.py:73-100``)."""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of ``x`` over the elements where ``mask`` (broadcastable) is True.

    The mask is broadcast to x's full shape before counting, so a [B, N, 1]
    token mask over [B, N, D] features divides by tokens * D, as a mean over
    gathered tokens does. An all-False mask gives 0, not NaN.
    """
    m = mask.to(x.dtype).expand_as(x)
    if dim is None:
        return (x * m).sum() / m.sum().clamp(min=1.0)
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1.0)


def masked_var(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Unbiased variance (correction 1) over the masked positions along
    ``dim``: ``torch.var`` of the mask-selected elements."""
    m = mask.to(x.dtype)
    count = m.sum(dim, keepdim=True)
    mean = (x * m).sum(dim, keepdim=True) / count.clamp(min=1.0)
    sq = ((x - mean) ** 2 * m).sum(dim, keepdim=True)
    return (sq / (count - 1.0).clamp(min=1.0)).squeeze(dim)
