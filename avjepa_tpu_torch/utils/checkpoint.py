"""Weight bridge into the port, and checkpoints.

The port's modules carry the reference state-dict keys, so the flax bridge is
the JAX package's own mapping (the port's copy, ``utils/torch_import.py``)
and adds no mapping code:
- ``encoder_from_jax_params`` / ``predictor_from_jax_params``: flax params
  (as numpy arrays) -> ``*_params_to_state_dict`` ->
  ``load_state_dict(strict=True)``;
- ``load_encoder_checkpoint``: one encoder of a reference-layout ``.pth.tar``;
- ``save_train_state`` / ``load_train_state``: the pretrain app's state as the
  reference writes it (app/avjepa/train.py:332-350): ``encoder``,
  ``predictor``, ``target_encoder``, ``opt``, ``epoch``, ``loss``,
  ``batch_size``, ``world_size``, ``lr``, plus ``step``;
- ``load_jepa_weights``: the frozen ``target_encoder`` and ``predictor`` of
  such a file, for the avprediction app and the av_prediction eval;
- ``save_probe_state`` / ``load_probe_state``: the reconstruction probe, its
  AdamW state and its step, at ``<folder>/<tag>-probe-latest.pth.tar``
  (the JAX package keeps an Orbax ``<tag>-probe-ckpt`` directory).
An Orbax checkpoint directory cannot be read without JAX and is refused.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from avjepa_tpu_torch.utils.torch_import import (
    encoder_params_to_state_dict,
    predictor_params_to_state_dict,
    strip_prefixes,
)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def encoder_from_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load flax ``Encoder`` params (a nested dict of arrays) into ``module``."""
    module.load_state_dict(_tensors(encoder_params_to_state_dict(params)), strict=True)
    return module


def predictor_from_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load flax ``Predictor`` params (mask-token form) into ``module``."""
    module.load_state_dict(_tensors(predictor_params_to_state_dict(params)), strict=True)
    return module


def _load(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory (an Orbax checkpoint?): avjepa_tpu_torch reads "
            "only reference-layout .pth.tar files, since Orbax needs JAX (see ROADMAP.md). "
            "Export one with: python tools/convert_reference_checkpoint.py --export "
            "<orbax dir> <out.pth.tar>"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def _module_state(ckpt: dict, key: str, path: str) -> dict:
    """Entry ``key`` with DataParallel prefixes stripped and the fixed sincos
    pos-embed buffers a reference file may carry dropped (they are
    recomputed from the layout)."""
    if key not in ckpt:
        raise KeyError(f"{path!r} has no '{key}' entry; keys: {sorted(ckpt)[:8]}")
    return {k: v for k, v in strip_prefixes(ckpt[key]).items() if "pos_embed" not in k}


def load_encoder_checkpoint(path: str, prefer: str = "target_encoder") -> dict:
    """Encoder state dict from a reference-layout ``.pth.tar``; ``prefer``
    names the entry to read (``target_encoder``, the EMA encoder, or
    ``encoder``)."""
    return _module_state(_load(path), prefer, path)


def save_train_state(path: str, state, epoch: int, loss: float, batch_size: int,
                     lr: float) -> None:
    """Write ``state`` (a ``train.state.TrainState``) to ``path``, atomically."""
    out = {
        "encoder": state.encoder.state_dict(),
        "predictor": state.predictor.state_dict(),
        "target_encoder": state.target_encoder.state_dict(),
        "opt": state.optimizer.state_dict(),
        "scaler": None,
        "epoch": epoch,
        "loss": loss,
        "batch_size": batch_size,
        "world_size": 1,
        "lr": lr,
        "step": state.step,
    }
    _save(out, path)


def _save(out: dict, path: str) -> None:
    """torch.save to ``path`` atomically (a temporary file, then a rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(out, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state) -> None:
    """Restore ``state`` in place from a ``.pth.tar`` written by
    ``save_train_state`` (a reference file without ``step`` starts at 0)."""
    ckpt = _load(path)
    for key, module in (("encoder", state.encoder), ("predictor", state.predictor),
                        ("target_encoder", state.target_encoder)):
        module.load_state_dict(_module_state(ckpt, key, path), strict=True)
    if ckpt.get("opt") is not None:
        state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt.get("step", 0))


def load_jepa_weights(path: str, target_encoder: nn.Module, predictor: nn.Module) -> None:
    """Load the ``target_encoder`` and ``predictor`` entries of a
    reference-layout ``.pth.tar`` (the pretrain app's output) strictly; a
    directory (an Orbax checkpoint) raises, naming the converter."""
    ckpt = _load(path)
    target_encoder.load_state_dict(_module_state(ckpt, "target_encoder", path), strict=True)
    predictor.load_state_dict(_module_state(ckpt, "predictor", path), strict=True)


def save_probe_state(path: str, state) -> None:
    """Write a probe state (``train.avprediction.ProbeState``) atomically."""
    _save({"probe": state.probe.state_dict(), "opt": state.optimizer.state_dict(),
           "step": state.step}, path)


def load_probe_state(path: str, state) -> None:
    """Restore a probe state in place, strictly: every probe parameter must be
    in the file with its shape (``load_state_dict(strict=True)``), so a
    random probe never passes for a trained one. Raises FileNotFoundError
    when there is no file."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no probe checkpoint: {path!r}")
    ckpt = _load(path)
    state.probe.load_state_dict(ckpt["probe"], strict=True)
    state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
