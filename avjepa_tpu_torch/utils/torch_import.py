"""Reference-checkpoint interop: PyTorch state-dict <-> flax param pytrees
(the port's copy of ``avjepa_tpu/utils/torch_import.py``).

The reference framework (johnshizhu/AVJEPA) saves checkpoints as
``torch.save({'encoder': sd, 'predictor': sd, 'target_encoder': sd, ...})``
(reference: app/avjepa/train.py:332-350). These functions map such state
dicts — given as plain ``{name: numpy array}`` — into this framework's
depth-stacked flax param trees, and back. They are the adoption path for
users switching from the reference: convert once with
``tools/convert_reference_checkpoint.py`` and resume/eval here.

This module never imports torch or jax: callers hand in numpy arrays
(``{k: v.detach().cpu().numpy() for k, v in sd.items()}``). The port's
modules carry the reference state-dict keys, so the ``*_to_state_dict``
direction loads flax weights into them, and ``*_from_state_dict`` gives the
JAX package the port's weights.

Layout notes (why the transposes):
- torch ``nn.Linear.weight`` is ``[out, in]``; flax ``Dense.kernel`` is
  ``[in, out]``.
- torch ``Conv3d.weight`` is ``[D, C, t, kh, kw]``; our video patch kernel
  is ``[t, kh, kw, C, D]`` (models/patch_embed.py — identical tree for the
  conv and matmul formulations).
- reference blocks are a ModuleList (``blocks.{i}.*``); ours are
  depth-stacked (leading axis = layer) for ``nn.scan``.
"""

from __future__ import annotations

import re

import numpy as np

_PREFIXES = ("module.", "backbone.")


def strip_prefixes(sd: dict) -> dict:
    """Drop DataParallel-style wrappers (reference evals do the same,
    evals/video_classification_frozen/eval.py:419-444)."""
    out = {}
    for k, v in sd.items():
        for p in _PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def infer_depth(sd: dict, prefix: str = "blocks") -> int:
    pat = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.")
    layers = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    if not layers:
        raise ValueError(f"no '{prefix}.<i>.' keys in state dict")
    return max(layers) + 1


def _stack(sd, fmt, depth, post=lambda x: x):
    return np.stack([post(np.asarray(sd[fmt.format(i=i)])) for i in range(depth)])


def _block_stack(sd: dict, prefix: str, depth: int) -> dict:
    t = lambda x: x.T
    return {
        "layers": {
            "norm1": {
                "scale": _stack(sd, prefix + ".{i}.norm1.weight", depth),
                "bias": _stack(sd, prefix + ".{i}.norm1.bias", depth),
            },
            "attn": {
                "qkv": {
                    "kernel": _stack(sd, prefix + ".{i}.attn.qkv.weight", depth, t),
                    "bias": _stack(sd, prefix + ".{i}.attn.qkv.bias", depth),
                },
                "proj": {
                    "kernel": _stack(sd, prefix + ".{i}.attn.proj.weight", depth, t),
                    "bias": _stack(sd, prefix + ".{i}.attn.proj.bias", depth),
                },
            },
            "norm2": {
                "scale": _stack(sd, prefix + ".{i}.norm2.weight", depth),
                "bias": _stack(sd, prefix + ".{i}.norm2.bias", depth),
            },
            "mlp": {
                "fc1": {
                    "kernel": _stack(sd, prefix + ".{i}.mlp.fc1.weight", depth, t),
                    "bias": _stack(sd, prefix + ".{i}.mlp.fc1.bias", depth),
                },
                "fc2": {
                    "kernel": _stack(sd, prefix + ".{i}.mlp.fc2.weight", depth, t),
                    "bias": _stack(sd, prefix + ".{i}.mlp.fc2.bias", depth),
                },
            },
        }
    }


def encoder_params_from_state_dict(sd: dict, depth: int | None = None) -> dict:
    """Reference AudioVisionTransformer / VisionTransformer state dict ->
    our Encoder params. Audio branch is included iff the state dict has it.

    Fixed sincos pos-embed buffers in the state dict are ignored: ours are
    recomputed from the token layout (models/pos_embed.py)."""
    sd = strip_prefixes(sd)
    if depth is None:
        depth = infer_depth(sd, "blocks")
    w = np.asarray(sd["patch_embed.proj.weight"])
    if w.ndim == 5:  # video tubelet conv [D, C, t, kh, kw]
        kernel = w.transpose(2, 3, 4, 1, 0)
    else:  # image conv [D, C, kh, kw]
        kernel = w.transpose(2, 3, 1, 0)
    params = {
        "patch_embed_v": {
            "proj": {
                "kernel": kernel,
                "bias": np.asarray(sd["patch_embed.proj.bias"]),
            }
        },
        "blocks": _block_stack(sd, "blocks", depth),
        "norm": {
            "scale": np.asarray(sd["norm.weight"]),
            "bias": np.asarray(sd["norm.bias"]),
        },
    }
    if "patch_embed.audio_proj.weight" in sd:
        params["patch_embed_a"] = {
            "proj": {
                "kernel": np.asarray(sd["patch_embed.audio_proj.weight"]).transpose(
                    2, 3, 1, 0
                ),
                "bias": np.asarray(sd["patch_embed.audio_proj.bias"]),
            }
        }
    return params


def predictor_params_from_state_dict(sd: dict, depth: int | None = None) -> dict:
    """Reference AudioVisionTransformerPredictor state dict -> our Predictor
    params (video-only predictors simply lack the audio keys)."""
    sd = strip_prefixes(sd)
    if depth is None:
        depth = infer_depth(sd, "predictor_blocks")
    num_mt = len(
        {k for k in sd if re.match(r"^mask_tokens_v\.\d+$", k)}
    ) or len({k for k in sd if re.match(r"^mask_tokens\.\d+$", k)})
    params = {
        "embed_v": {
            "kernel": np.asarray(
                sd.get("predictor_embed_v.weight", sd.get("predictor_embed.weight"))
            ).T,
            "bias": np.asarray(
                sd.get("predictor_embed_v.bias", sd.get("predictor_embed.bias"))
            ),
        },
        "blocks": _block_stack(sd, "predictor_blocks", depth),
        "norm": {
            "scale": np.asarray(sd["predictor_norm.weight"]),
            "bias": np.asarray(sd["predictor_norm.bias"]),
        },
        "proj": {
            "kernel": np.asarray(sd["predictor_proj.weight"]).T,
            "bias": np.asarray(sd["predictor_proj.bias"]),
        },
    }
    vkey = "mask_tokens_v" if "mask_tokens_v.0" in sd else "mask_tokens"
    if num_mt:
        params["mask_tokens_v"] = np.concatenate(
            [np.asarray(sd[f"{vkey}.{j}"]).reshape(1, -1) for j in range(num_mt)]
        )
    if "predictor_embed_a.weight" in sd:
        params["embed_a"] = {
            "kernel": np.asarray(sd["predictor_embed_a.weight"]).T,
            "bias": np.asarray(sd["predictor_embed_a.bias"]),
        }
        if num_mt:
            params["mask_tokens_a"] = np.concatenate(
                [
                    np.asarray(sd[f"mask_tokens_a.{j}"]).reshape(1, -1)
                    for j in range(num_mt)
                ]
            )
    return params


# --------------------------------------------------------------------------
# export: our params -> reference-style state dict (numpy values)
# --------------------------------------------------------------------------


def _unstack_blocks(blocks: dict, prefix: str, out: dict) -> None:
    L = blocks["layers"]
    depth = np.asarray(L["norm1"]["scale"]).shape[0]
    for i in range(depth):
        out[f"{prefix}.{i}.norm1.weight"] = np.asarray(L["norm1"]["scale"][i])
        out[f"{prefix}.{i}.norm1.bias"] = np.asarray(L["norm1"]["bias"][i])
        out[f"{prefix}.{i}.attn.qkv.weight"] = np.asarray(
            L["attn"]["qkv"]["kernel"][i]
        ).T
        out[f"{prefix}.{i}.attn.qkv.bias"] = np.asarray(L["attn"]["qkv"]["bias"][i])
        out[f"{prefix}.{i}.attn.proj.weight"] = np.asarray(
            L["attn"]["proj"]["kernel"][i]
        ).T
        out[f"{prefix}.{i}.attn.proj.bias"] = np.asarray(L["attn"]["proj"]["bias"][i])
        out[f"{prefix}.{i}.norm2.weight"] = np.asarray(L["norm2"]["scale"][i])
        out[f"{prefix}.{i}.norm2.bias"] = np.asarray(L["norm2"]["bias"][i])
        out[f"{prefix}.{i}.mlp.fc1.weight"] = np.asarray(L["mlp"]["fc1"]["kernel"][i]).T
        out[f"{prefix}.{i}.mlp.fc1.bias"] = np.asarray(L["mlp"]["fc1"]["bias"][i])
        out[f"{prefix}.{i}.mlp.fc2.weight"] = np.asarray(L["mlp"]["fc2"]["kernel"][i]).T
        out[f"{prefix}.{i}.mlp.fc2.bias"] = np.asarray(L["mlp"]["fc2"]["bias"][i])


def encoder_params_to_state_dict(params: dict) -> dict:
    """Inverse of encoder_params_from_state_dict (numpy values; wrap with
    torch.as_tensor to feed a reference model)."""
    out = {}
    k = np.asarray(params["patch_embed_v"]["proj"]["kernel"])
    out["patch_embed.proj.weight"] = (
        k.transpose(4, 3, 0, 1, 2) if k.ndim == 5 else k.transpose(3, 2, 0, 1)
    )
    out["patch_embed.proj.bias"] = np.asarray(params["patch_embed_v"]["proj"]["bias"])
    if "patch_embed_a" in params:
        out["patch_embed.audio_proj.weight"] = np.asarray(
            params["patch_embed_a"]["proj"]["kernel"]
        ).transpose(3, 2, 0, 1)
        out["patch_embed.audio_proj.bias"] = np.asarray(
            params["patch_embed_a"]["proj"]["bias"]
        )
    _unstack_blocks(params["blocks"], "blocks", out)
    out["norm.weight"] = np.asarray(params["norm"]["scale"])
    out["norm.bias"] = np.asarray(params["norm"]["bias"])
    return out


def probe_params_to_state_dict(params: dict) -> dict:
    """Flax params of a reconstruction probe (``models/prediction_probes.py``)
    -> the port's probe state dict, keeping the flax leaf names as module
    names: Dense kernels ``[in, out]`` become ``[out, in]`` weights, conv
    kernels ``[*k, in, out]`` become ``[out, in, *k]``, a LayerNorm ``scale``
    becomes ``weight``; other leaves keep their names and values. (Not in
    the JAX package: its probes have no PyTorch twin there.)"""
    out = {}

    def walk(tree: dict, prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
                continue
            a = np.asarray(value)
            if key == "kernel":
                out[prefix + "weight"] = a.T if a.ndim == 2 else np.moveaxis(a, (-1, -2), (0, 1))
            elif key == "scale":
                out[prefix + "weight"] = a
            else:
                out[prefix + key] = a

    walk(params, "")
    return out


def classifier_params_to_state_dict(params: dict) -> dict:
    """Flax ``AttentiveClassifier`` params -> the port's classifier state
    dict: ``probe_params_to_state_dict``'s renames, and the pooler's
    unscanned ``blocks_{i}`` as ``blocks.{i}`` (a ``ModuleList``). (Not in
    the JAX package.)"""
    return {re.sub(r"(^|\.)blocks_(\d+)\.", r"\1blocks.\2.", k): v
            for k, v in probe_params_to_state_dict(params).items()}


def predictor_params_to_state_dict(params: dict) -> dict:
    out = {}
    out["predictor_embed_v.weight"] = np.asarray(params["embed_v"]["kernel"]).T
    out["predictor_embed_v.bias"] = np.asarray(params["embed_v"]["bias"])
    if "embed_a" in params:
        out["predictor_embed_a.weight"] = np.asarray(params["embed_a"]["kernel"]).T
        out["predictor_embed_a.bias"] = np.asarray(params["embed_a"]["bias"])
    if "mask_tokens_v" in params:
        mt = np.asarray(params["mask_tokens_v"])
        for j in range(mt.shape[0]):
            out[f"mask_tokens_v.{j}"] = mt[j].reshape(1, 1, -1)
    if "mask_tokens_a" in params:
        mt = np.asarray(params["mask_tokens_a"])
        for j in range(mt.shape[0]):
            out[f"mask_tokens_a.{j}"] = mt[j].reshape(1, 1, -1)
    _unstack_blocks(params["blocks"], "predictor_blocks", out)
    out["predictor_norm.weight"] = np.asarray(params["norm"]["scale"])
    out["predictor_norm.bias"] = np.asarray(params["norm"]["bias"])
    out["predictor_proj.weight"] = np.asarray(params["proj"]["kernel"]).T
    out["predictor_proj.bias"] = np.asarray(params["proj"]["bias"])
    return out
