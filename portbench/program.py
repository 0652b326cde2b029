"""What the entries (``entries/*.py``) share: the YAML the program loads, the
reference's numerics, and the device's memory given back."""

from __future__ import annotations

import copy
import gc

import torch

from portbench import masks
from portbench.reference.vit import ModelSpec


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k) or {}, v) if isinstance(v, dict) else v
    return out


def program_yaml(conf: dict, entry: str) -> dict:
    """The YAML the program loads: the repository's, as it stands, with the
    configuration file's overrides (the cuts listed in ``reduced``)."""
    return _merge(conf["yaml"][entry], conf.get("overrides", {}).get(entry, {}))


def reference_numerics() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def grid(s: ModelSpec) -> masks.Grid:
    ha, wa = s.audio_grid
    return masks.Grid(s.t_grid, s.grid, s.grid, ha, wa, s.audio)
