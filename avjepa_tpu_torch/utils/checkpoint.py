"""Weight bridge into the port, and checkpoint reading.

The port's modules carry the reference state-dict keys, so both directions
reuse ``avjepa_tpu.utils.torch_import`` (numpy only, no JAX) and add no
mapping code:
- ``encoder_from_jax_params``: flax encoder params (as numpy arrays) ->
  ``encoder_params_to_state_dict`` -> ``load_state_dict(strict=True)``;
- ``load_encoder_checkpoint``: a reference-layout ``.pth.tar``.
An Orbax checkpoint directory cannot be read without JAX and is refused.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from avjepa_tpu.utils.torch_import import encoder_params_to_state_dict, strip_prefixes


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def encoder_from_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load flax ``Encoder`` params (a nested dict of arrays) into ``module``."""
    module.load_state_dict(_tensors(encoder_params_to_state_dict(params)), strict=True)
    return module


def load_encoder_checkpoint(path: str, prefer: str = "target_encoder") -> dict:
    """Encoder state dict from a reference-layout ``.pth.tar``.

    ``prefer`` names the entry to read (``target_encoder``, the EMA encoder,
    or ``encoder``). DataParallel prefixes are stripped; the fixed sincos pos-embed
    buffers a reference file may carry are dropped (they are recomputed from
    the layout).
    """
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory (an Orbax checkpoint?): avjepa_tpu_torch reads "
            "only reference-layout .pth.tar files, since Orbax needs JAX (see ROADMAP.md). "
            "Export one with: python tools/convert_reference_checkpoint.py --export "
            "<orbax dir> <out.pth.tar>"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if prefer not in ckpt:
        raise KeyError(f"{path!r} has no '{prefer}' entry; keys: {sorted(ckpt)[:8]}")
    return {k: v for k, v in strip_prefixes(ckpt[prefer]).items() if "pos_embed" not in k}
