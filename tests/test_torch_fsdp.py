"""The port's fsdp axis (``avjepa_tpu_torch/parallel/fsdp.py``) without a
spawn: the sharding rule against the JAX package's ``_param_spec`` on the
same parameter tree, the helpers without sharding, and the step with the
models sharded over a one-rank mesh (gloo, in this process) against the
unsharded step. The two- and four-rank runs are in
tests/test_torch_parallel.py."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed

import jax

import torch_dp_worker as worker
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.factory import make_encoder as jax_make_encoder
from avjepa_tpu.models.factory import make_predictor as jax_make_predictor
from avjepa_tpu.parallel.mesh import _param_spec
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator, stack_masksets
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.factory import VIT_SPECS, init_encoder_params, init_predictor_params
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.parallel import dist, fsdp
from avjepa_tpu_torch.train import optim
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
    save_train_state_orbax,
)

# the JAX rule's own threshold (avjepa_tpu/parallel/mesh.py, _FSDP_MIN_SIZE)
FSDP_MIN_SIZE = 2**17


def _jax_marks(shapes, to_state_dict) -> dict:
    """For each port state-dict key, whether ``_param_spec(...,
    fsdp_axis=True)`` shards its JAX leaf, and that leaf's ndim and size:
    each rides the flax tree as a zero-copy broadcast through the weight
    bridge's own mapping."""
    def through_bridge(fn):
        tree = jax.tree_util.tree_map_with_path(
            lambda path, x: np.broadcast_to(np.int64(fn(path, x)), x.shape), shapes)
        return {k: int(np.asarray(v).flat[0]) for k, v in to_state_dict(tree).items()}

    sharded = through_bridge(
        lambda path, x: any(a is not None for a in _param_spec(path, x, False, True)))
    ndim = through_bridge(lambda path, x: len(x.shape))
    size = through_bridge(lambda path, x: int(np.prod(x.shape)))
    return {k: (bool(sharded[k]), ndim[k], size[k]) for k in sharded}


@pytest.mark.parametrize("audio", [True, False], ids=["av", "video"])
def test_sharding_rule_matches_jax_param_spec(audio):
    """At vit_huge (32 x 1280, predictor 12 x 384) on the 224 layout, the
    port shards every parameter (``parallel/fsdp.py``), a superset of what
    ``_param_spec`` shards; the parameters JAX alone replicates are the
    allowed differences, each for one of its reasons: under
    ``patch_embed``, 1-D, or below ``_FSDP_MIN_SIZE``. Shapes only: JAX's
    tree from ``jax.eval_shape``, the port's models on the meta device."""
    kw = dict(num_frames=16, crop_size=224, patch_size=16, tubelet_size=2,
              audio_enabled=audio)
    jl, layout = JaxTokenLayout(**kw), TokenLayout(**kw)
    jenc = jax_make_encoder("vit_huge", jl)
    jpred = jax_make_predictor("vit_huge", jl, pred_depth=12)
    key = jax.random.key(0)
    enc_shapes = jax.eval_shape(lambda k: jax_init_encoder_params(jenc, k), key)
    pred_shapes = jax.eval_shape(lambda k: jax_init_predictor_params(jpred, k), key)
    spec = VIT_SPECS["vit_huge"]
    with torch.device("meta"):
        enc = Encoder(layout, spec.embed_dim, spec.depth, spec.num_heads, spec.mlp_ratio)
        pred = Predictor(layout, spec.embed_dim, 384, 12, spec.num_heads)
    seen = set()
    for module, shapes, to_sd in (
            (enc, enc_shapes, jax_torch_import.encoder_params_to_state_dict),
            (pred, pred_shapes, jax_torch_import.predictor_params_to_state_dict)):
        jax_sharded = _jax_marks(shapes, to_sd)
        params = dict(module.named_parameters())
        assert sorted(jax_sharded) == sorted(params)
        for name in params:
            sharded, ndim, size = jax_sharded[name]
            if sharded:
                seen.add("both")
            elif name.startswith("patch_embed"):
                seen.add("patch_embed")
            elif ndim < 2:
                seen.add("1-D")
            else:
                assert size < FSDP_MIN_SIZE, f"JAX alone replicates {name}"
                seen.add("small")
        # JAX shards every block matrix too
        assert all(jax_sharded[n][0] for n, p in params.items()
                   if n.split(".", 1)[0] in fsdp.BLOCK_LISTS and p.ndim >= 2)
    assert seen == {"both", "patch_embed", "1-D", "small"}


def test_helpers_without_sharding():
    """On plain tensors the helpers are the plain computations: per-tensor
    norms and mean |x|, the state dict on the host, and the optimizer's own
    state-dict layout, which loads back."""
    gen = torch.Generator().manual_seed(0)
    ts = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    torch.testing.assert_close(fsdp.leaf_norms(ts), torch.stack([t.norm() for t in ts]))
    torch.testing.assert_close(fsdp.leaf_abs_means(ts),
                               torch.stack([t.abs().mean() for t in ts]))
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    opt = optim.make_optimizer([model])
    model(torch.randn(2, 3, generator=gen)).sum().backward()
    opt.step()
    sd = fsdp.full_state_dict(model)
    assert sorted(sd) == sorted(model.state_dict())
    full = fsdp.full_optimizer_state_dict(opt)
    assert full["param_groups"] == opt.state_dict()["param_groups"]
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(full["state"][i][k], v, rtol=0, atol=0)
    opt2 = optim.make_optimizer([model])
    fsdp.load_full_optimizer_state_dict(opt2, full)
    assert opt2.state_dict()["param_groups"] == opt.state_dict()["param_groups"]
    before = dict(dist.REDUCTIONS)
    fsdp.load_full_state_dict(model, sd)
    assert dict(dist.REDUCTIONS) == before


@pytest.fixture
def one_rank_group():
    """A one-rank gloo process group in this process, left on exit, as a
    mesh whose fsdp axis is that one rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=0, world_size=1)
    try:
        yield dist.Mesh(1, 1, 1, torch.distributed.device_mesh.init_device_mesh(
            "cpu", (1,), mesh_dim_names=("fsdp",)))
    finally:
        torch.distributed.destroy_process_group()


def _inputs(seed: int, b: int = 4) -> dict:
    layout = TokenLayout(**worker.LAYOUT)
    rng = np.random.default_rng(seed)
    masks = [{"aspect_ratio": [0.75, 1.5], "num_blocks": n, "spatial_scale": [s, s],
              "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0}
             for n, s in ((8, 0.15), (2, 0.5))]
    enc, pred, idx, union = stack_masksets(
        make_mask_collator("multiblock3d", masks, layout, base_seed=seed)(b), True)
    t = torch.from_numpy
    return dict(video=t(rng.normal(size=(b, 4, 64, 64, 3)).astype(np.float32)),
                audio=t(rng.normal(size=(b, 128, 192, 1)).astype(np.float32)),
                enc_masks=t(enc), pred_masks=t(pred), enc_idx=tuple(t(i) for i in idx),
                union_idx=t(union))


def test_one_rank_mesh_step_and_checkpoint_match_unsharded(one_rank_group, tmp_path):
    """The models sharded over a one-rank mesh: three steps give the unsharded steps' losses, norms,
    gradient statistics and weights within 1e-6 relative; the checkpoint
    written from the sharded state equals the unsharded one's, and loads
    back into a sharded state."""
    layout = TokenLayout(**worker.LAYOUT)
    enc, pred = Encoder(layout, **worker.ENC), Predictor(layout, **worker.PRED)
    init_encoder_params(enc, 3)
    init_predictor_params(pred, 4)
    weights = {"encoder": enc.state_dict(), "predictor": pred.state_dict()}
    plain, sharded = worker.build_state(weights), worker.build_state(weights, one_rank_group)
    for name in ("encoder", "predictor", "target_encoder"):
        assert all(fsdp.is_sharded(p) for p in getattr(sharded, name).parameters()), name
    sched, cfg = optim.ScheduleConfig(**worker.SCHED), StepConfig(**worker.STEP)
    for i in range(3):
        inputs = _inputs(20 + i)
        a = train_step(plain, sched, cfg, **inputs)
        b = train_step(sharded, sched, cfg, **inputs)
        for k in ("loss", "enc_grad_norm", "pred_grad_norm", "enc_grad_avg",
                  "enc_grad_first_qkv", "pred_grad_avg", "opt_mu_abs", "opt_nu_abs"):
            assert abs(a[k] - b[k]) <= 1e-6 * abs(a[k]), (i, k)
    for name in ("encoder", "predictor", "target_encoder"):
        got = fsdp.full_state_dict(getattr(sharded, name))
        for k, v in getattr(plain, name).state_dict().items():
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-9)

    paths = [str(tmp_path / f"{n}.pth.tar") for n in ("plain", "sharded")]
    for path, state in zip(paths, (plain, sharded)):
        save_train_state(path, state, epoch=1, loss=0.0, batch_size=4, lr=0.0)
    want, got = (torch.load(p, weights_only=True) for p in paths)
    assert got["opt"]["param_groups"] == want["opt"]["param_groups"]
    for i, s in want["opt"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(got["opt"]["state"][i][k], v, rtol=1e-5, atol=1e-9)
    fresh = worker.build_state(weights, one_rank_group)
    load_train_state(paths[1], fresh)
    assert fresh.step == 3
    again = str(tmp_path / "again.pth.tar")
    save_train_state(again, fresh, epoch=1, loss=0.0, batch_size=4, lr=0.0)
    back = torch.load(again, weights_only=True)
    for key in ("encoder", "predictor", "target_encoder"):
        for k, v in got[key].items():
            assert torch.equal(back[key][k], v), (key, k)
    for i, s in got["opt"]["state"].items():
        for k, v in s.items():
            assert torch.equal(back["opt"]["state"][i][k], v), (i, k)


def test_one_rank_mesh_resumes_from_orbax(one_rank_group, tmp_path):
    """An unsharded state after one step, saved as the JAX package's Orbax
    directory, loads into models sharded over a one-rank mesh through the
    whole-tensor path of ``load_train_state`` (the AdamW state mapped by
    name onto the sharded parameters): its .pth.tar then equals the
    unsharded state's to the bit (params, EMA target, AdamW moments and
    steps, step). One torch thread, as the other port test modules run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        layout = TokenLayout(**worker.LAYOUT)
        enc, pred = Encoder(layout, **worker.ENC), Predictor(layout, **worker.PRED)
        init_encoder_params(enc, 5)
        init_predictor_params(pred, 6)
        weights = {"encoder": enc.state_dict(), "predictor": pred.state_dict()}
        plain = worker.build_state(weights)
        train_step(plain, optim.ScheduleConfig(**worker.SCHED), StepConfig(**worker.STEP),
                   **_inputs(30, b=2))
        save_train_state_orbax(str(tmp_path / "plain-ckpt"), plain)
        sharded = worker.build_state(weights, one_rank_group)
        load_train_state(str(tmp_path / "plain-ckpt"), sharded)
        assert all(fsdp.is_sharded(p) for p in sharded.encoder.parameters())
        outs = []
        for state, name in ((plain, "plain"), (sharded, "sharded")):
            save_train_state(str(tmp_path / f"{name}.pth.tar"), state, epoch=0, loss=0.0,
                             batch_size=2, lr=0.0)
            outs.append(torch.load(tmp_path / f"{name}.pth.tar", weights_only=True))
    finally:
        torch.set_num_threads(threads)
    want, got = outs
    assert want["step"] == got["step"] == 1 and want["opt"]["state"]
    for key in ("encoder", "predictor", "target_encoder"):
        assert all(torch.equal(got[key][k], v) for k, v in want[key].items()), key
    assert sorted(got["opt"]["state"]) == sorted(want["opt"]["state"])
    for i, s in want["opt"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["opt"]["state"][i][k], v), (i, k)
