"""Model factory: named ViT sizes, parameter init and the per-layer rescale.

Counterpart of ``avjepa_tpu/models/factory.py`` (the size table matches the
reference constructors, src/models/audiovision_transformer.py:313-371). Init
draws from a ``torch.Generator``, so it gives other numbers than the JAX
package from the same seed, from the same distributions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from avjepa_tpu.layout import TokenLayout
from avjepa_tpu_torch.models.encoder import Encoder


@dataclasses.dataclass(frozen=True)
class VitSpec:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    patch_size: int = 16


VIT_SPECS: dict[str, VitSpec] = {
    "vit_tiny": VitSpec(192, 12, 3),
    "vit_small": VitSpec(384, 12, 6),
    "vit_base": VitSpec(768, 12, 12),
    "vit_large": VitSpec(1024, 24, 16),
    "vit_huge": VitSpec(1280, 32, 16),
    "vit_giant": VitSpec(1408, 40, 16, mlp_ratio=48 / 11),
    "vit_gigantic": VitSpec(1664, 48, 16, mlp_ratio=64 / 13, patch_size=14),
}


def clipped_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02,
                    lo: float = -2.0, hi: float = 2.0) -> None:
    """Normal(0, std) clipped to the absolute bounds [lo, hi] (the reference's
    trunc_normal_ convention), drawn on the CPU so every device gets the
    same numbers."""
    x = torch.randn(t.shape, generator=generator) * std
    t.copy_(x.clamp_(lo, hi))


@torch.no_grad()
def init_encoder_params(encoder: nn.Module, seed: int) -> None:
    """Init in place: clipped-normal weights, zero biases, unit LayerNorms;
    then the output projections of block i (``attn.proj``, ``mlp.fc2``) are
    divided by sqrt(2*(i+1)) (reference: _rescale_blocks,
    audiovision_transformer.py:172-178)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in encoder.named_parameters():
        if name.startswith("norm") or ".norm" in name:
            if name.endswith("weight"):
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)
        elif name.endswith("bias"):
            nn.init.zeros_(p)
        else:
            clipped_normal_(p, g)
    for i, blk in enumerate(encoder.blocks):
        blk.attn.proj.weight.div_(math.sqrt(2.0 * (i + 1)))
        blk.mlp.fc2.weight.div_(math.sqrt(2.0 * (i + 1)))


def make_encoder(
    model_name: str,
    layout: TokenLayout,
    uniform_power: bool = False,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    gelu: str = "tanh",
    seed: int = 0,
) -> Encoder:
    """A named-size encoder on the CPU, initialised from ``seed``; move it
    with ``.to(device)``."""
    spec = VIT_SPECS[model_name]
    encoder = Encoder(
        layout=layout,
        embed_dim=spec.embed_dim,
        depth=spec.depth,
        num_heads=spec.num_heads,
        mlp_ratio=spec.mlp_ratio,
        uniform_power=uniform_power,
        dtype=dtype,
        attn_impl=attn_impl,
        gelu=gelu,
    )
    init_encoder_params(encoder, seed)
    return encoder
