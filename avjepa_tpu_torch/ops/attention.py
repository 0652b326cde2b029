"""Attention dispatch: the plain masked softmax and the flash kernels.

Counterpart of ``avjepa_tpu/ops/attention.py``. Attention is a function over
``[B, H, N, Dh]`` tensors with an optional key validity mask ``[B, N]``:
masked keys are excluded from the softmax.
"""

from __future__ import annotations

import torch


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Masked scaled-dot-product attention in plain PyTorch (``attn_impl:
    xla``; also what the flash path falls back to for head dims not divisible
    by 8 and sequences shorter than 128, as the JAX package does).

    Logits are f32 whatever the input type; masked keys get ``-inf``; the
    probabilities are cast to ``v``'s type before the PV product. A row with
    no valid key gives NaN, as in the JAX version: such rows are don't-care.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Dispatch between the plain path and the classic flash kernel."""
    if impl == "flash":
        from avjepa_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, key_mask=key_mask, scale=scale)
    return xla_attention(q, k, v, key_mask=key_mask, scale=scale)
