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

Every reader also takes the JAX package's Orbax directories
(``utils/orbax.py``, no JAX needed): a ``CheckpointManager`` directory
(``<tag>-ckpt``, ``<tag>-probe-ckpt``, ``<tag>-cls-ckpt``) is read at its
latest committed step and its state (``JepaState``, ``ProbeState`` or the
classifier's dict) mapped to the entries above (``from_jax_tree``): the
params through the ``*_params_to_state_dict`` mapping, the AdamW moments
``mu``/``nu`` parameter by parameter through the same mapping and ``count``
to each parameter's ``step``. ``jax_tree`` maps the pretrain app's
checkpoint the other way, into a ``JepaState`` tree that the JAX package
resumes. ``resume_source`` picks, of a ``<tag>[-probe|-cls]-latest.pth.tar``
and the JAX directory ``<tag>[-probe|-cls]-ckpt`` beside it, the one with the
later step.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from avjepa_tpu_torch.parallel import dist, fsdp
from avjepa_tpu_torch.train.optim import decays
from avjepa_tpu_torch.utils import orbax
from avjepa_tpu_torch.utils.logging import get_logger
from avjepa_tpu_torch.utils.torch_import import (
    classifier_params_to_state_dict,
    encoder_params_from_state_dict,
    encoder_params_to_state_dict,
    predictor_params_from_state_dict,
    predictor_params_to_state_dict,
    probe_params_to_state_dict,
    strip_prefixes,
)

# the pretrain checkpoint's module entries and their JepaState fields
_JAX_FIELDS = {"encoder": "enc_params", "predictor": "pred_params",
               "target_encoder": "target_params"}
_TO_STATE_DICT = {"encoder": encoder_params_to_state_dict,
                  "predictor": predictor_params_to_state_dict,
                  "target_encoder": encoder_params_to_state_dict}


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


def _numpy(tree):
    """A tree of the Orbax reader's tensors as numpy arrays, bf16 as f32."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()


def _latest(path: str) -> tuple[orbax.CheckpointManager, int]:
    mngr = orbax.CheckpointManager(path)
    step = mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"{path!r} holds no committed Orbax checkpoint step")
    return mngr, step


def _named_adamw(opt: dict, to_state_dict) -> dict:
    """A JAX ``AdamWState`` as the port's AdamW state keyed by parameter name:
    ``exp_avg`` (mu) and ``exp_avg_sq`` (nu) state dicts and ``step``
    (count)."""
    return {"exp_avg": _tensors(to_state_dict(_numpy(opt["mu"]))),
            "exp_avg_sq": _tensors(to_state_dict(_numpy(opt["nu"]))),
            "step": int(opt["count"])}


def from_jax_tree(tree: dict) -> dict:
    """A state of the JAX package, as ``orbax.CheckpointManager.restore``
    reads it, in the layout of the port's ``.pth.tar``: a ``JepaState``
    (pretrain), a ``ProbeState`` (avprediction) or the classification
    evals' ``{cls, opt, step, epoch}``. Its ``opt`` holds the AdamW state by
    parameter name, ``{"by_name": {entry: _named_adamw}}``, which the
    loaders map onto their optimizer."""
    if "enc_params" in tree:
        out = {key: _tensors(fn(_numpy(tree[_JAX_FIELDS[key]])))
               for key, fn in _TO_STATE_DICT.items()}
        out["opt"] = {"by_name": {
            "encoder": _named_adamw(tree["enc_opt"], encoder_params_to_state_dict),
            "predictor": _named_adamw(tree["pred_opt"], predictor_params_to_state_dict)}}
        out["step"] = int(tree["step"])
        return out
    if "probe_params" in tree:
        return {"probe": _tensors(probe_params_to_state_dict(_numpy(tree["probe_params"]))),
                "opt": {"by_name": {"probe": _named_adamw(tree["opt"],
                                                          probe_params_to_state_dict)}},
                "step": int(tree["step"])}
    if "cls" in tree:
        return {"classifier": _tensors(classifier_params_to_state_dict(_numpy(tree["cls"]))),
                "opt": {"by_name": {"classifier": _named_adamw(
                    tree["opt"], classifier_params_to_state_dict)}},
                "step": int(tree["step"]), "epoch": int(tree["epoch"])}
    raise ValueError(f"not a state of the JAX package: top-level keys {sorted(tree)}")


def read_checkpoint(path: str) -> dict:
    """A checkpoint in the ``.pth.tar`` layout: the file's dict, or the
    latest committed step of an Orbax directory (``from_jax_tree``)."""
    if os.path.isdir(path):
        mngr, step = _latest(path)
        return from_jax_tree(mngr.restore(step))
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_step(path: str) -> Optional[int]:
    """The step a checkpoint holds: a ``.pth.tar``'s ``step`` (0 when it has
    none), an Orbax directory's latest committed step; None when there is no
    file or no committed step."""
    if os.path.isdir(path):
        return orbax.CheckpointManager(path).latest_step()
    if not os.path.isfile(path):
        return None
    return int(torch.load(path, map_location="cpu", weights_only=True, mmap=True).get("step", 0))


def orbax_dir(pth: str) -> str:
    """The JAX package's Orbax directory that matches a port checkpoint:
    ``<tag>-latest.pth.tar`` -> ``<tag>-ckpt``, ``<tag>-probe-latest.pth.tar``
    -> ``<tag>-probe-ckpt``, ``<tag>-cls-latest.pth.tar`` -> ``<tag>-cls-ckpt``."""
    if not pth.endswith("-latest.pth.tar"):
        raise ValueError(f"{pth!r} is not a <tag>-latest.pth.tar path")
    return pth[:-len("-latest.pth.tar")] + "-ckpt"


def resume_source(pth: str) -> Optional[str]:
    """Of the port's ``pth`` and the JAX package's Orbax directory beside it
    (``orbax_dir``), the one that holds the later step, ``pth`` on a tie;
    None when neither holds one."""
    steps = [(s, p) for p in (pth, orbax_dir(pth)) if (s := checkpoint_step(p)) is not None]
    return max(steps, key=lambda sp: sp[0])[1] if steps else None


def _indexed_adamw(by_name: dict, optimizer: torch.optim.Optimizer,
                   modules: dict[str, nn.Module]) -> dict:
    """``optimizer``'s state dict (whole tensors) from AdamW state keyed by
    parameter name (``from_jax_tree``), for the parameters of ``modules``
    (entry name -> module). A state at step 0 is left out: AdamW starts
    it fresh, as JAX's zero moments are."""
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    state = {}
    for key, module in modules.items():
        named = by_name[key]
        for name, p in module.named_parameters():
            if named["step"]:
                state[index[id(p)]] = {"step": torch.tensor(float(named["step"])),
                                       "exp_avg": named["exp_avg"][name],
                                       "exp_avg_sq": named["exp_avg_sq"][name]}
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _load_optimizer(opt: dict, optimizer: torch.optim.Optimizer,
                    modules: dict[str, nn.Module]) -> None:
    """Load a checkpoint's ``opt`` (torch's layout, or by name) whole."""
    if "by_name" in opt:
        opt = _indexed_adamw(opt["by_name"], optimizer, modules)
    fsdp.load_full_optimizer_state_dict(optimizer, opt, list(modules.values()))


def _param_order(entries: dict[str, dict], rule) -> list[tuple[str, str]]:
    """(entry, parameter name) in the order ``make_optimizer(models, rule)``
    numbers the parameters of modules with these state dicts."""
    return [(key, name) for flag in (True, False) for key, sd in entries.items()
            for name, t in sd.items() if bool(rule(name, t)) == flag]


def _by_name(opt: Optional[dict], entries: dict[str, dict]) -> dict:
    """A pretrain checkpoint's AdamW state keyed by parameter name: from
    the port's layout (``make_optimizer``'s numbering over ``entries``, its
    groups marked ``decay``), kept as it is when it is by name already;
    zeros when there is none or it is another optimizer's (a reference
    file's Adam numbers its own groups), as the JAX converter does."""
    if opt is not None and "by_name" in opt:
        return opt["by_name"]
    out = {key: {"exp_avg": {}, "exp_avg_sq": {}, "step": 0} for key in entries}
    order = _param_order(entries, decays)
    if opt is not None and [g.get("decay") for g in opt["param_groups"]] != [True, False]:
        opt = None
    n_decay = sum(1 for key, name in order if decays(name, entries[key][name]))
    if opt is not None and [len(g["params"]) for g in opt["param_groups"]] != [
            n_decay, len(order) - n_decay]:
        raise ValueError("the optimizer state does not number the checkpoint's parameters")
    steps = {key: set() for key in entries}
    for i, (key, name) in enumerate(order):
        s = (opt or {}).get("state", {}).get(i)
        p = entries[key][name]
        out[key]["exp_avg"][name] = s["exp_avg"] if s else torch.zeros_like(p)
        out[key]["exp_avg_sq"][name] = s["exp_avg_sq"] if s else torch.zeros_like(p)
        steps[key].add(int(s["step"]) if s else 0)
    for key, seen in steps.items():
        if len(seen) > 1:
            raise ValueError(f"the {key}'s parameters are at different AdamW steps {seen}")
        out[key]["step"] = seen.pop() if seen else 0
    return out


def jax_tree(ckpt: dict) -> dict:
    """The pretrain app's checkpoint (``save_train_state``'s dict, or
    ``from_jax_tree``'s) as the JAX package's ``JepaState`` tree, numpy
    leaves: params through ``*_params_from_state_dict`` (the inverse
    mapping), the AdamW moments likewise with ``count``; a checkpoint
    without optimizer state gets zero moments at count 0."""
    entries = {key: _module_state(ckpt, key, "checkpoint") for key in _JAX_FIELDS}
    named = _by_name(ckpt.get("opt"), {k: entries[k] for k in ("encoder", "predictor")})
    np32 = lambda sd: {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    from_sd = {"encoder": encoder_params_from_state_dict,
               "predictor": predictor_params_from_state_dict}
    tree = {field: from_sd["predictor" if key == "predictor" else "encoder"](np32(entries[key]))
            for key, field in _JAX_FIELDS.items()}
    for key, field in (("encoder", "enc_opt"), ("predictor", "pred_opt")):
        tree[field] = {"mu": from_sd[key](np32(named[key]["exp_avg"])),
                       "nu": from_sd[key](np32(named[key]["exp_avg_sq"])),
                       "count": np.asarray(named[key]["step"], np.int32)}
    tree["step"] = np.asarray(int(ckpt.get("step", 0)), np.int32)
    return tree


def _module_entries(path: str, keys: tuple[str, ...]) -> dict[str, dict]:
    """Module entries ``keys`` of a pretrain checkpoint, as state dicts: a
    ``.pth.tar``'s, or, of an Orbax directory, the JepaState subtrees alone
    (found through ``item_metadata``); a directory that holds one encoder's
    params as its whole tree gives them for any encoder entry."""
    if not os.path.isdir(path):
        ckpt = read_checkpoint(path)
        return {key: _module_state(ckpt, key, path) for key in keys}
    mngr, step = _latest(path)
    meta = mngr.item_metadata(step)
    out = {}
    for key in keys:
        field = _JAX_FIELDS[key]
        if field in meta:
            sub = (field,)
        elif key != "predictor" and "blocks" in meta:
            sub = ()
        else:
            raise KeyError(f"{path!r} has no '{field}' subtree; keys: {sorted(meta)[:8]}")
        out[key] = _tensors(_TO_STATE_DICT[key](_numpy(mngr.restore(step, sub))))
    return out


def _module_state(ckpt: dict, key: str, path: str) -> dict:
    """Entry ``key`` with DataParallel prefixes stripped and the fixed sincos
    pos-embed buffers a reference file may carry dropped (they are
    recomputed from the layout)."""
    if key not in ckpt:
        raise KeyError(f"{path!r} has no '{key}' entry; keys: {sorted(ckpt)[:8]}")
    return {k: v for k, v in strip_prefixes(ckpt[key]).items() if "pos_embed" not in k}


def load_encoder_checkpoint(path: str, prefer: str = "target_encoder") -> dict:
    """Encoder state dict from a reference-layout ``.pth.tar`` or a pretrain
    Orbax directory; ``prefer`` names the entry to read (``target_encoder``,
    the EMA encoder, or ``encoder``)."""
    return _module_entries(path, (prefer,))[prefer]


def save_train_state(path: str, state, epoch: int, loss: float, batch_size: int,
                     lr: float, world_size: int = 1) -> None:
    """Write ``state`` (a ``train.state.TrainState``) to ``path``, atomically.
    ``batch_size`` is per rank and ``world_size`` the number of ranks that
    load distinct samples, as the reference writes them. Every rank must call it (the sharded tensors are
    gathered); rank 0 alone copies the state to its host and writes."""
    out = train_checkpoint(state, epoch, loss, batch_size, lr, world_size)
    if dist.is_main():
        _save(out, path)


def train_checkpoint(state, epoch: int = 0, loss: float = 0.0, batch_size: int = 0,
                     lr: float = 0.0, world_size: int = 1) -> dict:
    """``save_train_state``'s dict, on rank 0 (every rank must call it)."""
    return {
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


def _save(out: dict, path: str) -> None:
    """torch.save to ``path`` atomically (a temporary file, then a rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(out, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state) -> None:
    """Restore ``state`` in place from a ``.pth.tar`` written by
    ``save_train_state`` (a reference file without ``step`` starts at 0)
    or a JAX pretrain Orbax directory (params, EMA target, AdamW moments and
    counts, step); every rank reads the whole checkpoint and keeps its
    shards."""
    ckpt = read_checkpoint(path)
    for key, module in (("encoder", state.encoder), ("predictor", state.predictor),
                        ("target_encoder", state.target_encoder)):
        fsdp.load_full_state_dict(module, _module_state(ckpt, key, path))
    if ckpt.get("opt") is not None:
        _load_optimizer(ckpt["opt"], state.optimizer,
                        {"encoder": state.encoder, "predictor": state.predictor})
    state.step = int(ckpt.get("step", 0))


def save_train_state_orbax(directory: str, state, max_to_keep: int = 3) -> None:
    """Write ``state`` as the JAX package's pretrain app does: a
    ``JepaState`` step ``state.step`` of the Orbax manager directory
    ``directory`` (``<tag>-ckpt``), replacing that step if it exists. Every
    rank must call it; rank 0 writes."""
    ckpt = train_checkpoint(state)
    if dist.is_main():
        orbax.CheckpointManager(directory, max_to_keep).save(state.step, jax_tree(ckpt),
                                                             force=True)


def load_jepa_weights(path: str, target_encoder: nn.Module, predictor: nn.Module) -> None:
    """Load the ``target_encoder`` and ``predictor`` entries of a pretrain
    checkpoint (a ``.pth.tar``, or the ``target_params`` and ``pred_params``
    of an Orbax directory) strictly; a directory without a committed step
    raises FileNotFoundError."""
    entries = _module_entries(path, ("target_encoder", "predictor"))
    fsdp.load_full_state_dict(target_encoder, entries["target_encoder"])
    fsdp.load_full_state_dict(predictor, entries["predictor"])


def save_probe_state(path: str, state) -> None:
    """Write a probe state (``train.avprediction.ProbeState``) atomically."""
    _save({"probe": state.probe.state_dict(), "opt": state.optimizer.state_dict(),
           "step": state.step}, path)


def load_probe_state(path: str, state) -> None:
    """Restore a probe state in place from ``path`` (a ``.pth.tar`` or a JAX
    ``<tag>-probe-ckpt`` directory), strictly: every probe parameter must be
    in it with its shape (``load_state_dict(strict=True)``), so a random
    probe never passes for a trained one. Raises FileNotFoundError when
    there is no file or committed step."""
    if checkpoint_step(path) is None:
        raise FileNotFoundError(f"no probe checkpoint: {path!r}")
    ckpt = read_checkpoint(path)
    state.probe.load_state_dict(ckpt["probe"], strict=True)
    if "by_name" in ckpt["opt"]:
        ckpt["opt"] = _indexed_adamw(ckpt["opt"]["by_name"], state.optimizer,
                                     {"probe": state.probe})
    state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])


def merge_target_encoder(path: str, encoder: nn.Module, strict: bool = True,
                         prefer: str = "target_encoder") -> Optional[dict]:
    """Load entry ``prefer`` of the pretrain checkpoint at ``path`` (a
    ``.pth.tar`` or an Orbax directory) into ``encoder`` leaf by leaf (JAX ``load_target_encoder_params``,
    ``avjepa_tpu/evals/video_classification.py:248-336``; reference:
    evals/video_classification_frozen/eval.py:419-444): a leaf whose name and
    shape match is taken; a missing or shape-mismatched one keeps its init
    and is logged; checkpoint-only leaves (the audio patch embed of an AV
    checkpoint in a video-only encoder) are counted and dropped.

    With ``strict`` (unless ``pretrain.allow_missing_checkpoint``), a
    missing file or any missing or mismatched leaf raises: probing a random
    encoder wastes the run. Without it a missing file warns and returns
    None; so does a directory without a committed Orbax step. Returns the
    leaf names by outcome: ``taken``, ``missing``, ``mismatched``,
    ``dropped``."""
    logger = get_logger("avjepa_tpu_torch")
    if checkpoint_step(path) is None:
        msg = f"pretrain checkpoint {path!r} does not exist or holds no committed step"
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
    """Restore ``state`` in place from ``save_classifier_state``'s file at
    ``path`` or the JAX eval's ``<tag>-cls-ckpt`` beside it
    (``resume_source``: the later step) and return the epoch to resume at;
    None, leaving ``state`` as it is, when neither holds a step or it does
    not fit (unreadable, or another classifier's names or shapes, e.g.
    another ``num_classes``): the eval then starts fresh, as the JAX evals
    do."""
    logger = get_logger("avjepa_tpu_torch")
    try:
        src = resume_source(path)
        if src is None:
            return None
        ckpt = read_checkpoint(src)
    except (RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
        logger.warning(f"classifier checkpoint {path!r} is unreadable ({e}); starting fresh")
        return None
    own = state.classifier.state_dict()
    saved = ckpt.get("classifier", {})
    if set(saved) != set(own) or any(saved[k].shape != v.shape for k, v in own.items()):
        logger.warning(f"classifier checkpoint {path!r} does not fit this classifier; "
                       "starting fresh")
        return None
    state.classifier.load_state_dict(saved, strict=True)
    if "by_name" in ckpt["opt"]:
        ckpt["opt"] = _indexed_adamw(ckpt["opt"]["by_name"], state.optimizer,
                                     {"classifier": state.classifier})
    state.optimizer.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
