"""The port's tensor axis (``avjepa_tpu_torch/parallel/tensor.py``) without
a spawn: the sharding rule against the JAX package's ``_param_spec`` on the
same parameter tree, and the pieces' layout. The two- and four-rank steps
and apps are in tests/test_torch_parallel.py."""

import numpy as np
import pytest
import torch

import jax

from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.factory import make_encoder as jax_make_encoder
from avjepa_tpu.models.factory import make_predictor as jax_make_predictor
from avjepa_tpu.parallel.mesh import _param_spec
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import VIT_SPECS
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel import dist, tensor

# which features of a JAX kernel ([.., in, out]) 'tensor' cuts
NONE, OUT, IN = 0, 1, 2


def _jax_tensor_dims(shapes, to_state_dict) -> dict:
    """For each port state-dict key, which features of its JAX leaf
    ``_param_spec(..., tensor_axis=True, fsdp_axis=True)`` puts 'tensor' on
    (alone, or stacked with fsdp as ``("tensor", "fsdp")``): each mark rides
    the flax tree as a zero-copy broadcast through the weight bridge."""
    def mark(path, x):
        spec = _param_spec(path, x, True, True)
        dims = [d for d, ax in enumerate(spec)
                if ax == "tensor" or (isinstance(ax, tuple) and "tensor" in ax)]
        kind = NONE if not dims else (OUT if dims[0] == len(x.shape) - 1 else IN)
        return np.broadcast_to(np.int64(kind), x.shape)

    tree = jax.tree_util.tree_map_with_path(mark, shapes)
    return {k: int(np.asarray(v).flat[0]) for k, v in to_state_dict(tree).items()}


def _port_cut_dims(module, full) -> dict:
    """For each parameter of the cut ``module``, which of its torch
    dimensions ([out, in]) is smaller than the whole ``full`` module's."""
    whole = dict(full.named_parameters())
    out = {}
    for k, p in module.named_parameters():
        cut = [d for d in range(p.dim()) if p.shape[d] != whole[k].shape[d]]
        out[k] = NONE if not cut else (OUT if cut == [0] else IN)
    return out


@pytest.mark.parametrize("model,size", [("vit_huge", 2), ("vit_huge", 4), ("vit_tiny", 2)])
def test_tensor_rule_matches_jax_param_spec(model, size):
    """The AV models (224 layout, predictor 12 x 384) on the meta device, cut
    over a tensor group of ``size``: every parameter JAX puts on 'tensor' is
    cut on the same features in the port (qkv and fc1 their output rows,
    proj, fc2 and the predictor's proj their input columns) to 1/size, and
    nothing else is, but for the named differences:
      - qkv is cut by heads within each of q, k and v, not into contiguous
        rows (``parallel/tensor.py``; the same features, another order);
      - the qkv and fc1 biases are cut with their rows (JAX's rule keeps
        1-D leaves whole and GSPMD slices them at use);
      - where the heads do not divide (vit_tiny's 3), the attention stays
        whole, as ``param_shardings`` replicates an axis that does not
        divide: there JAX cuts qkv's 576 contiguous output features."""
    kw = dict(num_frames=16, crop_size=224, patch_size=16, tubelet_size=2)
    jl, layout = JaxTokenLayout(**kw), TokenLayout(**kw)
    jenc = jax_make_encoder(model, jl)
    jpred = jax_make_predictor(model, jl, pred_depth=12)
    key = jax.random.key(0)
    enc_shapes = jax.eval_shape(lambda k: jax_init_encoder_params(jenc, k), key)
    pred_shapes = jax.eval_shape(lambda k: jax_init_predictor_params(jpred, k), key)
    spec = VIT_SPECS[model]
    group = dist.Group(None, size, size - 1)
    seen = set()
    with torch.device("meta"):
        pairs = [(Encoder(layout, spec.embed_dim, spec.depth, spec.num_heads, spec.mlp_ratio),
                  Encoder(layout, spec.embed_dim, spec.depth, spec.num_heads, spec.mlp_ratio)),
                 (Predictor(layout, spec.embed_dim, 384, 12, spec.num_heads),
                  Predictor(layout, spec.embed_dim, 384, 12, spec.num_heads))]
    for (cut, full), shapes, to_sd in zip(
            pairs, (enc_shapes, pred_shapes),
            (jax_torch_import.encoder_params_to_state_dict,
             jax_torch_import.predictor_params_to_state_dict)):
        tensor.shard_models(group, cut)
        want = _jax_tensor_dims(shapes, to_sd)
        got = _port_cut_dims(cut, full)
        assert sorted(want) == sorted(got)
        splits = tensor.splits(cut)
        assert sorted(splits) == sorted(k for k, v in got.items() if v != NONE)
        whole = dict(full.named_parameters())
        for k, p in cut.named_parameters():
            if got[k] != NONE:
                d = 0 if got[k] == OUT else 1
                assert p.shape[d] * size == whole[k].shape[d], k
            heads = spec.num_heads if k.startswith("blocks") else cut.blocks[0].attn.num_heads
            if want[k] == got[k]:
                seen.add("same" if want[k] else "whole")
                if k.endswith("attn.qkv.weight"):
                    assert splits[k].heads == heads
                    seen.add("qkv by heads")
            elif k.endswith(("qkv.bias", "fc1.bias")) and got[k] == OUT and want[k] == NONE:
                seen.add("bias cut with its rows")
            else:
                assert heads % size and ".attn." in k and got[k] == NONE, (k, want[k], got[k])
                seen.add("heads do not divide")
    named = {"same", "whole", "qkv by heads", "bias cut with its rows"}
    assert seen == (named if model == "vit_huge" else
                    named - {"qkv by heads"} | {"heads do not divide"})


def test_qkv_pieces_keep_the_packed_layout():
    """A rank's piece of a fused qkv ([3 H d, D] rows) holds its heads of
    each of q, k and v in [3, H/T, d] order, which the packed kernels read
    in place; joining every rank's piece gives the whole back."""
    h, d, dim, size = 4, 3, 5, 2
    full = torch.arange(3 * h * d * dim, dtype=torch.float32).reshape(3 * h * d, dim)
    split = tensor.Split(0, dist.Group(None, size, 0), heads=h)
    pieces = [split.piece(full, i) for i in range(size)]
    for i, p in enumerate(pieces):
        want = full.reshape(3, h, d, dim)[:, i * 2:(i + 1) * 2].reshape(-1, dim)
        assert torch.equal(p, want)
    assert torch.equal(split.join(pieces), full)
    bias = torch.arange(3 * h * d, dtype=torch.float32)
    assert torch.equal(split.join([split.piece(bias, i) for i in range(size)]), bias)
    plain = tensor.Split(1, dist.Group(None, size, 1))
    assert torch.equal(plain.piece(full), full[:, 3:])
    assert torch.equal(plain.join([plain.piece(full, i) for i in range(size)]), full)
