"""Training-step pieces that the serving path shares with pretraining.

Counterpart of part of ``avjepa_tpu/train/step.py``.
"""

from __future__ import annotations

import torch


def feature_layer_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LN over the feature dim (torch F.layer_norm's default
    eps), applied to target-encoder outputs (reference:
    app/avjepa/train.py:448)."""
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    return (h - mean) * torch.rsqrt(var + eps)
