"""Model factory: named ViT sizes, the encoder and predictor, parameter init
and the per-layer rescale.

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

from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor


@dataclasses.dataclass(frozen=True)
class VitSpec:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    patch_size: int = 16


# meta.dtype -> compute dtype; float16 configs run in bfloat16, as in the JAX
# package (bf16's range needs no loss scaling)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.bfloat16}

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
def _init_params(module: nn.Module, blocks: nn.ModuleList, seed: int,
                 zero_init: tuple[str, ...] = ()) -> None:
    """Init in place, drawing in parameter order from one CPU generator:
    clipped-normal weights, zero biases, unit LayerNorms, zeros for the names
    starting with ``zero_init``; then the output projections of block i
    (``attn.proj``, ``mlp.fc2``) are divided by sqrt(2*(i+1)) (reference:
    _rescale_blocks, audiovision_transformer.py:172-178)."""
    g = torch.Generator().manual_seed(seed)
    norms = {f"{name}.weight" for name, m in module.named_modules()
             if isinstance(m, nn.LayerNorm)}
    for name, p in module.named_parameters():
        if name in norms:
            nn.init.ones_(p)
        elif name.endswith("bias") or name.startswith(zero_init):
            nn.init.zeros_(p)
        else:
            clipped_normal_(p, g)
    for i, blk in enumerate(blocks):
        blk.attn.proj.weight.div_(math.sqrt(2.0 * (i + 1)))
        blk.mlp.fc2.weight.div_(math.sqrt(2.0 * (i + 1)))


def init_encoder_params(encoder: Encoder, seed: int) -> None:
    _init_params(encoder, encoder.blocks, seed)


def init_predictor_params(predictor: Predictor, seed: int,
                          zero_init_mask_tokens: bool = True) -> None:
    zero = ("mask_tokens_v", "mask_tokens_a") if zero_init_mask_tokens else ()
    _init_params(predictor, predictor.blocks, seed, zero)


def init_classifier_params(classifier: nn.Module, seed: int) -> None:
    """An ``AttentiveClassifier``'s init (flax's: no per-layer rescale)."""
    _init_params(classifier, nn.ModuleList(), seed)


def make_encoder(
    model_name: str,
    layout: TokenLayout,
    uniform_power: bool = False,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    gelu: str = "tanh",
    seed: int = 0,
    remat: bool = False,
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
        remat=remat,
    )
    init_encoder_params(encoder, seed)
    return encoder


def make_predictor(
    model_name: str,
    layout: TokenLayout,
    pred_depth: int = 6,
    pred_embed_dim: int = 384,
    uniform_power: bool = False,
    use_mask_tokens: bool = True,
    num_mask_tokens: int = 2,
    zero_init_mask_tokens: bool = True,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    gelu: str = "tanh",
    seed: int = 0,
    remat: bool = False,
) -> Predictor:
    """The predictor of a named-size encoder (the encoder's head count, at
    predictor width), on the CPU, initialised from ``seed``."""
    spec = VIT_SPECS[model_name]
    predictor = Predictor(
        layout=layout,
        embed_dim=spec.embed_dim,
        predictor_embed_dim=pred_embed_dim,
        depth=pred_depth,
        num_heads=spec.num_heads,
        mlp_ratio=4.0,
        uniform_power=uniform_power,
        use_mask_tokens=use_mask_tokens,
        num_mask_tokens=num_mask_tokens,
        dtype=dtype,
        attn_impl=attn_impl,
        gelu=gelu,
        remat=remat,
    )
    init_predictor_params(predictor, seed, zero_init_mask_tokens)
    return predictor
