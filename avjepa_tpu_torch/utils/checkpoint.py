"""Weight bridge into the port, and checkpoints.

The port's modules carry the reference state-dict keys, so the flax bridge is
the JAX package's own mapping (the port's copy, ``utils/torch_import.py``)
and adds no mapping code:
- ``encoder_from_jax_params`` / ``predictor_from_jax_params`` /
  ``classifier_from_jax_params``: flax params (as numpy arrays) ->
  ``*_params_to_state_dict`` -> ``load_state_dict(strict=True)``;
- ``load_encoder_checkpoint``: one encoder of a reference-layout ``.pth.tar``;
- ``merge_target_encoder``: the classification evals' leaf-by-leaf,
  shape-tolerant merge of such an encoder into a (video-only) encoder;
- ``save_train_state`` / ``load_train_state``: the pretrain app's state as the
  reference writes it (app/avjepa/train.py:332-350): ``encoder``,
  ``predictor``, ``target_encoder``, ``opt``, ``epoch``, ``loss``,
  ``batch_size``, ``world_size``, ``lr``, plus ``step``; whole tensors on
  the host whether the models are sharded (the fsdp and tensor axes, the
  fused qkv's heads back in ``[3, H, d]`` order) or not, so a file crosses
  between tensor, fsdp, data and one process;
- ``load_jepa_weights``: the frozen ``target_encoder`` and ``predictor`` of
  such a file, for the avprediction app and the av_prediction eval, into
  sharded modules or not;
- ``save_probe_state`` / ``load_probe_state``: the reconstruction probe, its
  AdamW state and its step, at ``<folder>/<tag>-probe-latest.pth.tar``
  (the JAX package keeps an Orbax ``<tag>-probe-ckpt`` directory);
- ``save_classifier_state`` / ``load_classifier_state``: a classification
  eval's attentive classifier, its AdamW state, step and epoch, at
  ``<folder>/<tag>-cls-latest.pth.tar`` (JAX: ``<tag>-cls-ckpt``).
An Orbax checkpoint directory cannot be read without JAX and is refused.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from avjepa_tpu_torch.parallel import dist, fsdp
from avjepa_tpu_torch.utils.logging import get_logger
from avjepa_tpu_torch.utils.torch_import import (
    classifier_params_to_state_dict,
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


def classifier_from_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load flax ``AttentiveClassifier`` params into ``module``."""
    module.load_state_dict(_tensors(classifier_params_to_state_dict(params)), strict=True)
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
                     lr: float, world_size: int = 1) -> None:
    """Write ``state`` (a ``train.state.TrainState``) to ``path``, atomically.
    ``batch_size`` is per rank and ``world_size`` the number of ranks that
    load distinct samples, as the reference writes them. Every rank must call it (the sharded tensors are
    gathered); rank 0 alone copies the state to its host and writes."""
    out = {
        "encoder": fsdp.full_state_dict(state.encoder),
        "predictor": fsdp.full_state_dict(state.predictor),
        "target_encoder": fsdp.full_state_dict(state.target_encoder),
        "opt": fsdp.full_optimizer_state_dict(state.optimizer, [state.encoder, state.predictor]),
        "scaler": None,
        "epoch": epoch,
        "loss": loss,
        "batch_size": batch_size,
        "world_size": world_size,
        "lr": lr,
        "step": state.step,
    }
    if dist.is_main():
        _save(out, path)


def _save(out: dict, path: str) -> None:
    """torch.save to ``path`` atomically (a temporary file, then a rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(out, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state) -> None:
    """Restore ``state`` in place from a ``.pth.tar`` written by
    ``save_train_state`` (a reference file without ``step`` starts at 0);
    every rank reads the whole file and keeps its shards."""
    ckpt = _load(path)
    for key, module in (("encoder", state.encoder), ("predictor", state.predictor),
                        ("target_encoder", state.target_encoder)):
        fsdp.load_full_state_dict(module, _module_state(ckpt, key, path))
    if ckpt.get("opt") is not None:
        fsdp.load_full_optimizer_state_dict(state.optimizer, ckpt["opt"],
                                            [state.encoder, state.predictor])
    state.step = int(ckpt.get("step", 0))


def load_jepa_weights(path: str, target_encoder: nn.Module, predictor: nn.Module) -> None:
    """Load the ``target_encoder`` and ``predictor`` entries of a
    reference-layout ``.pth.tar`` (the pretrain app's output) strictly; a
    directory (an Orbax checkpoint) raises, naming the converter."""
    ckpt = _load(path)
    fsdp.load_full_state_dict(target_encoder, _module_state(ckpt, "target_encoder", path))
    fsdp.load_full_state_dict(predictor, _module_state(ckpt, "predictor", path))


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


def merge_target_encoder(path: str, encoder: nn.Module, strict: bool = True,
                         prefer: str = "target_encoder") -> Optional[dict]:
    """Load entry ``prefer`` of the pretrain ``.pth.tar`` at ``path`` into
    ``encoder`` leaf by leaf (JAX ``load_target_encoder_params``,
    ``avjepa_tpu/evals/video_classification.py:248-336``; reference:
    evals/video_classification_frozen/eval.py:419-444): a leaf whose name and
    shape match is taken; a missing or shape-mismatched one keeps its init
    and is logged; checkpoint-only leaves (the audio patch embed of an AV
    checkpoint in a video-only encoder) are counted and dropped.

    With ``strict`` (unless ``pretrain.allow_missing_checkpoint``), a
    missing file or any missing or mismatched leaf raises: probing a random
    encoder wastes the run. Without it a missing file warns and returns
    None. A directory (an Orbax checkpoint) is refused, naming the
    converter. Returns the leaf names by outcome: ``taken``, ``missing``,
    ``mismatched``, ``dropped``."""
    logger = get_logger("avjepa_tpu_torch")
    if not os.path.exists(path):
        msg = f"pretrain checkpoint {path!r} does not exist"
        if strict:
            raise FileNotFoundError(msg + "; pass pretrain.allow_missing_checkpoint: true "
                                    "to probe a random encoder anyway")
        logger.warning(msg + "; evaluating a RANDOM encoder")
        return None
    src = load_encoder_checkpoint(path, prefer)
    merged = encoder.state_dict()
    out = {"taken": [], "missing": [], "mismatched": [],
           "dropped": sorted(set(src) - set(merged))}
    for name, init in merged.items():
        if name not in src:
            out["missing"].append(name)
            logger.warning(f"checkpoint merge: {name} NOT in checkpoint; keeping init")
        elif tuple(src[name].shape) != tuple(init.shape):
            out["mismatched"].append(name)
            logger.warning(f"checkpoint merge: {name} shape {tuple(src[name].shape)} != "
                           f"model {tuple(init.shape)}; keeping init")
        else:
            out["taken"].append(name)
            merged[name] = src[name]
    logger.info(
        f"checkpoint merge: {len(out['taken'])} leaves loaded, {len(out['missing'])} "
        f"missing, {len(out['mismatched'])} shape-mismatched, {len(out['dropped'])} "
        f"checkpoint-only dropped ({', '.join(out['dropped'][:4])})")
    if strict and (out["missing"] or out["mismatched"]):
        raise ValueError(
            f"checkpoint {path!r} does not cover the encoder: {len(out['missing'])} missing + "
            f"{len(out['mismatched'])} mismatched leaves (see log); pass "
            "pretrain.allow_missing_checkpoint: true to keep init values for them")
    encoder.load_state_dict(merged, strict=True)
    return out


def save_classifier_state(path: str, state, epoch: int) -> None:
    """Write a classification eval's probe state (``classifier``,
    ``optimizer``, ``step``) and the epoch to resume at, atomically."""
    _save({"classifier": state.classifier.state_dict(), "opt": state.optimizer.state_dict(),
           "step": state.step, "epoch": epoch}, path)


def load_classifier_state(path: str, state) -> Optional[int]:
    """Restore ``state`` in place from ``save_classifier_state``'s file and
    return the epoch to resume at; None, leaving ``state`` as it is, when
    there is no file or it does not fit (unreadable, or another classifier's
    names or shapes, e.g. another ``num_classes``): the eval then starts
    fresh, as the JAX evals do."""
    if not os.path.isfile(path):
        return None
    logger = get_logger("avjepa_tpu_torch")
    try:
        ckpt = _load(path)
    except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
        logger.warning(f"classifier checkpoint {path!r} is unreadable ({e}); starting fresh")
        return None
    own = state.classifier.state_dict()
    saved = ckpt.get("classifier", {})
    if set(saved) != set(own) or any(saved[k].shape != v.shape for k, v in own.items()):
        logger.warning(f"classifier checkpoint {path!r} does not fit this classifier; "
                       "starting fresh")
        return None
    state.classifier.load_state_dict(saved, strict=True)
    state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
