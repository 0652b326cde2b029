"""The port's Orbax reader and writer (``avjepa_tpu_torch/utils/orbax.py``)
held against the JAX package's ``CheckpointManager`` and tensorstore, and
the state bridges (``utils/checkpoint.py``) against JAX's states: a
``JepaState`` saved by JAX resumes in the port, whose next step equals
JAX's, and back; JAX probe and classifier states load into the port's.
One JAX device (no mesh); small shapes; arrays made with numpy from a seed.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import tensorstore as ts

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import ENC, JAX_LAYOUT, LAYOUT, PRED, REPO, _batch, _rel_l2
from avjepa_tpu.evals.video_classification import _leaf_paths
from avjepa_tpu.models import prediction_probes as jax_probes
from avjepa_tpu.models.attentive_pooler import AttentiveClassifier as JaxClassifier
from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu.train.avprediction import ProbeState as JaxProbeState
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.train.step import stack_masksets as jax_stack_masksets
from avjepa_tpu.utils.checkpoint import CheckpointManager as JaxManager
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.evals.video_classification import ClassifierState
from avjepa_tpu_torch.models import prediction_probes as probes
from avjepa_tpu_torch.models.attentive_pooler import AttentiveClassifier
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.train import avprediction, optim, pretrain
from avjepa_tpu_torch.train.state import init_state
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils import orbax
from avjepa_tpu_torch.utils import torch_import
from avjepa_tpu_torch.utils.checkpoint import (
    load_classifier_state,
    load_probe_state,
    resume_source,
    save_train_state,
    save_train_state_orbax,
)


def _bits(x) -> np.ndarray:
    """The bytes of an array, tensor or JAX array, as comparable numpy."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                   "deep": {"b": jnp.asarray(rng.standard_normal(9), jnp.bfloat16)}},
        "count": np.asarray(7, np.int32),
        "idx": rng.integers(-2 ** 40, 2 ** 40, size=(3, 2)).astype(np.int64),
        "i32": rng.integers(-9, 9, size=(4,)).astype(np.int32),
        "half": rng.standard_normal((2, 3)).astype(np.float16),
        "flag": np.array([True, False, True]),
    }


def _assert_same(got: dict, want: dict):
    assert sorted(p for p, _ in orbax.flatten(got)) == sorted(p for p, _ in orbax.flatten(want))
    for path, w in orbax.flatten(want):
        g = got
        for k in path:
            g = g[k]
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, (path, gb.dtype, wb.dtype)
        np.testing.assert_array_equal(gb, wb, err_msg=str(path))


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------


def test_reads_what_jax_wrote_to_the_bit(tmp_path):
    """f32, bf16 (a JAX array), int32, int64, f16, bool, a rank-0 array and
    nested keys, as the JAX manager saves them (zstd chunks and nodes):
    read to the bit; item_metadata's shapes and dtypes are the JAX
    manager's."""
    tree = _tree()
    jm = JaxManager(str(tmp_path / "ckpt"))
    jm.save(3, tree)
    meta = jm.mngr.item_metadata(3)
    jm.close()
    mngr = orbax.CheckpointManager(str(tmp_path / "ckpt"))
    assert mngr.all_steps() == [3] and mngr.latest_step() == 3
    _assert_same(mngr.restore(), tree)
    ours = mngr.item_metadata(3)
    for path, m in _leaf_paths(meta.tree).items():
        o = ours
        for k in path.split("/"):
            o = o[k]
        assert o.shape == tuple(m.shape) and str(o.dtype)[len("torch."):] == str(m.dtype), path
    assert _bits(mngr.restore(3, ("params", "deep"))["b"]).tolist() == _bits(
        tree["params"]["deep"]["b"]).tolist()


@pytest.mark.parametrize("dtype,compressor,node_bytes", [
    ("<f4", {"id": "zstd", "level": 1}, 200),
    ("<i8", {"id": "zstd", "level": 5}, 100_000_000),
    ("<f2", None, 200),
    ("|b1", None, 100_000_000),
])
def test_reads_a_multichunk_tensorstore_array(tmp_path, dtype, compressor, node_bytes):
    """A zarr v2 array of 3 x 3 x 2 chunks, uneven at every edge, written
    by tensorstore into an OCDBT store (small nodes: a B-tree with interior
    levels), one row of chunks never written (the fill value 0): read whole
    to the bit."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((7, 5, 3)) * 1000).astype(np.dtype(dtype))
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
          "config": {"max_decoded_node_bytes": node_bytes}}
    arr = ts.open({"driver": "zarr", "kvstore": kv, "path": "p.q", "create": True,
                   "metadata": {"chunks": [3, 2, 2], "shape": [7, 5, 3], "dtype": dtype,
                                "compressor": compressor, "fill_value": None}}).result()
    arr[:6] = a[:6]
    store = orbax.OcdbtStore(str(tmp_path))
    if node_bytes < 1000:
        assert store.height > 0
    want = a.copy()
    want[6:] = 0
    got = orbax.read_zarr(store, "p.q").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if compressor is not None:  # a frame without its size: the streaming path
        frame = store.read("p.q/0.0.0")
        assert orbax.zstd_decompress(frame) == a[:3, :2, :2].tobytes()


@pytest.mark.parametrize("empty", [False, True])
def test_jax_restores_what_the_port_wrote(tmp_path, empty):
    """The port's writer (uncompressed; a bf16 tensor among numpy leaves;
    with ``empty``, a zero-size array, which has no chunk): the JAX manager
    restores it raw, into numpy leaves and into abstract arrays on a
    device, to the bit; tensorstore lists the port's OCDBT store."""
    tree = _tree()
    tree["t"] = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    tree["idx"] = tree["idx"] >> 12
    if empty:
        tree["params"]["none"] = np.zeros((0, 3), np.float32)
    orbax.CheckpointManager(str(tmp_path / "ckpt")).save(2, tree)
    jm = JaxManager(str(tmp_path / "ckpt"))
    assert jm.latest_step() == 2
    like = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, _bits(x).dtype), tree)
    like["params"]["deep"]["b"] = jnp.zeros((9,), jnp.bfloat16)
    like["t"] = jnp.zeros((4, 3), jnp.bfloat16)
    _assert_same(jm.restore(None, 2), tree)
    _assert_same(jm.restore(like, 2), tree)
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=dev), like)
    # JAX without x64 holds int64 as int32: the values here fit
    abstract["idx"] = jax.ShapeDtypeStruct((3, 2), jnp.int32, sharding=dev)
    got = jm.restore(abstract, 2)
    got["idx"] = np.asarray(got["idx"]).astype(np.int64)
    _assert_same(got, tree)
    jm.close()
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/ckpt/2/default/"}).result()
    assert b"params.w/0.0" in kv.list().result()


def test_steps_commit_prune_and_force(tmp_path):
    """latest_step ignores a step without _CHECKPOINT_METADATA and a
    temporary directory; max_to_keep prunes the oldest; an existing step
    raises unless forced, and force replaces it; a save writes no
    temporary directory that stays."""
    d = str(tmp_path / "ckpt")
    mngr = orbax.CheckpointManager(d, max_to_keep=2)
    for step in (1, 2, 3):
        mngr.save(step, {"x": np.full(3, step, np.float32)})
    assert mngr.all_steps() == [2, 3]
    os.makedirs(os.path.join(d, "9", "default"))  # uncommitted
    os.makedirs(os.path.join(d, "8.orbax-checkpoint-tmp-123"))
    with open(os.path.join(d, "8.orbax-checkpoint-tmp-123", "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({}, f)
    assert mngr.latest_step() == 3
    with pytest.raises(FileExistsError):
        mngr.save(3, {"x": np.zeros(3, np.float32)})
    mngr.save(3, {"x": np.full(3, 30, np.float32)}, force=True)
    assert mngr.restore()["x"].tolist() == [30.0] * 3
    assert sorted(os.listdir(d)) == ["2", "3", "8.orbax-checkpoint-tmp-123", "9"]
    assert JaxManager(d).restore(None, 3)["x"].tolist() == [30.0] * 3
    assert orbax.CheckpointManager(str(tmp_path / "none")).latest_step() is None


def test_zstd_through_libzstd():
    """The port's compressor and decompressor: a frame that states its
    size, decoded to bytes and into a given buffer; a cut frame raises
    (the streaming path: tensorstore's frames, above)."""
    data = np.random.default_rng(2).standard_normal(50_000).astype(np.float32)
    frame = orbax.zstd_compress(data, 3)
    assert frame[:4] == bytes.fromhex("28b52ffd")
    assert orbax.zstd_decompress(frame) == data.tobytes()
    out = bytearray(data.nbytes)
    assert orbax.zstd_decompress(frame, data.nbytes, out) is out and bytes(out) == data.tobytes()
    with pytest.raises(ValueError, match="zstd"):
        orbax.zstd_decompress(frame[:-7], data.nbytes)


# ---------------------------------------------------------------------------
# the slice: a JAX JepaState resumes in the port, and back
# ---------------------------------------------------------------------------


def _jax_setup():
    kw = dict(ipe=10, num_epochs=4, warmup_epochs=1)
    step_kw = dict(loss_exp=1.0, reg_coeff=0.5, clip_grad=10.0, warmup_epochs=1, ipe=10)
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    jpred = JaxPredictor(layout=JAX_LAYOUT, **PRED)
    jstate = jax_init_state(jax_init_encoder_params(jenc, jax.random.key(7)),
                            jax_init_predictor_params(jpred, jax.random.key(8)))
    jstep = jax.jit(make_train_step(jenc, jpred, jax_optim.ScheduleConfig(**kw),
                                    JaxStepConfig(**step_kw)))
    return jstate, jstep, optim.ScheduleConfig(**kw), StepConfig(**step_kw)


def _steps(jstep, jstate, state, sched, cfg, seed):
    """One JAX step and one port step on batch ``seed``: (JAX state, JAX
    loss, port loss)."""
    video, audio, masks = _batch(seed)
    enc, pred, idx, union = jax_stack_masksets(masks, True)
    jstate, jm = jstep(jstate, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(enc),
                       jnp.asarray(pred), tuple(jnp.asarray(x) for x in idx), jnp.asarray(union))
    loss = None
    if state is not None:
        loss = train_step(state, sched, cfg, torch.from_numpy(video), torch.from_numpy(audio),
                          torch.from_numpy(enc), torch.from_numpy(pred),
                          tuple(torch.from_numpy(x) for x in idx),
                          torch.from_numpy(union))["loss"]
    return jstate, float(jm["loss"]), loss


def _fresh_state():
    return init_state(Encoder(LAYOUT, **ENC), Predictor(LAYOUT, **PRED))


def _assert_state_matches(state, jstate, rel=1e-4):
    """The port's params, EMA target and AdamW moments against a JepaState
    (relative L2 over each module's tensors together), counts and step
    exactly."""
    sds = {"encoder": state.encoder.state_dict(), "predictor": state.predictor.state_dict(),
           "target_encoder": state.target_encoder.state_dict()}
    wants = {"encoder": torch_import.encoder_params_to_state_dict(jstate.enc_params),
             "predictor": torch_import.predictor_params_to_state_dict(jstate.pred_params),
             "target_encoder": torch_import.encoder_params_to_state_dict(jstate.target_params)}
    index = {id(p): i for i, p in enumerate(p for g in state.optimizer.param_groups
                                            for p in g["params"])}
    opt = state.optimizer.state_dict()["state"]
    for key, module, jopt, to_sd in (
            ("encoder", state.encoder, jstate.enc_opt, torch_import.encoder_params_to_state_dict),
            ("predictor", state.predictor, jstate.pred_opt,
             torch_import.predictor_params_to_state_dict)):
        mu, nu = to_sd(jopt.mu), to_sd(jopt.nu)
        names = [n for n, _ in module.named_parameters()]
        s = [opt[index[id(p)]] for _, p in module.named_parameters()]
        assert all(int(x["step"]) == int(jopt.count) for x in s), key
        for moment, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got = np.concatenate([x[moment].numpy().ravel() for x in s])
            assert _rel_l2(got, np.concatenate([want[n].ravel() for n in names])) <= rel, (
                key, moment)
    for key, sd in sds.items():
        names = sorted(k for k in sd if "pos_embed" not in k)
        assert names == sorted(wants[key]), key
        assert _rel_l2(np.concatenate([sd[n].numpy().ravel() for n in names]),
                       np.concatenate([wants[key][n].ravel() for n in names])) <= rel, key
    assert state.step == int(jstate.step)


def test_jax_state_resumes_in_the_port_and_back(tmp_path):
    """A JepaState after 2 JAX steps, saved by the JAX manager as the JAX
    pretrain app's ``<tag>-ckpt``, resumes in the port through
    ``meta.load_checkpoint`` (``pretrain.resume``): params, EMA target,
    moments, counts and step to the bit; the port's next step equals JAX's
    next step from the same directory (loss within 1e-5 relative, the new
    state within 1e-4 relative L2, test_torch_train's tolerances). Then the
    port saves its state through its Orbax writer, JAX resumes from it
    (the pretrain app's abstract-template restore) and the two take one more
    step alike."""
    jstate, jstep, sched, cfg = _jax_setup()
    for i in range(2):
        jstate, _, _ = _steps(jstep, jstate, None, sched, cfg, 10 + i)
    folder, tag = str(tmp_path / "run"), "jax"
    JaxManager(os.path.join(folder, f"{tag}-ckpt")).save(2, jstate)
    with open(os.path.join(REPO, "configs/pretrain/av-vitt16.yaml")) as f:
        d = yaml.safe_load(f)
    d["meta"]["load_checkpoint"] = True
    d["logging"].update(folder=folder, write_tag=tag)
    pcfg = load_config(d)

    state = _fresh_state()
    assert pretrain.resume(pcfg, state) == os.path.join(folder, f"{tag}-ckpt")
    _assert_state_matches(state, jax.device_get(jstate), rel=0.0)

    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding), jstate)
    jstate = JaxManager(os.path.join(folder, f"{tag}-ckpt")).restore(like)
    jstate, jloss, loss = _steps(jstep, jstate, state, sched, cfg, 12)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_state_matches(state, jax.device_get(jstate))

    # the port's .pth.tar at an earlier step loses to the JAX directory; at
    # the same step it wins
    pth = os.path.join(folder, f"{tag}-latest.pth.tar")
    state.step = 1
    save_train_state(pth, state, epoch=0, loss=0.0, batch_size=2, lr=0.0)
    assert resume_source(pth) == os.path.join(folder, f"{tag}-ckpt")
    state.step = 3
    save_train_state(pth, state, epoch=0, loss=0.0, batch_size=2, lr=0.0)
    assert resume_source(pth) == pth

    back = str(tmp_path / "back" / f"{tag}-ckpt")
    save_train_state_orbax(back, state)
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding), jstate)
    restored = JaxManager(back).restore(like)
    assert int(restored.step) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(restored)),
                    jax.tree_util.tree_leaves(_state_as_jax(state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    restored, jloss, loss = _steps(jstep, restored, state, sched, cfg, 13)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_state_matches(state, jax.device_get(restored))


def _state_as_jax(state):
    """The port's state as the JepaState the JAX package would hold."""
    from avjepa_tpu_torch.utils.checkpoint import jax_tree, train_checkpoint

    tree = jax_tree(train_checkpoint(state))
    return jax_init_state(tree["enc_params"], tree["pred_params"]).replace(
        step=tree["step"], target_params=tree["target_params"],
        enc_opt=jax_optim.AdamWState(**tree["enc_opt"]),
        pred_opt=jax_optim.AdamWState(**tree["pred_opt"]))


def test_jax_probe_and_classifier_states_load(tmp_path):
    """A JAX ProbeState (``<tag>-probe-ckpt``) and a classification eval's
    state (``<tag>-cls-ckpt``), with moments at count 3, load into the
    port's probe and classifier through the apps' sources
    (``resume_source``): weights, moments, steps and epoch to the bit."""
    rng = np.random.default_rng(3)
    noisy = lambda tree: jax.tree_util.tree_map(
        lambda x: np.asarray(rng.standard_normal(x.shape), np.float32), tree)

    jprobe = jax_probes.AttentionProbe(layout=JAX_LAYOUT, emb_dim=192)
    params = jax.device_get(jax.jit(jprobe.init)(
        jax.random.key(4), jnp.zeros((1, LAYOUT.num_tokens, 192)))["params"])
    opt = jax_optim.AdamWState(mu=noisy(params), nu=jax.tree_util.tree_map(
        np.abs, noisy(params)), count=np.asarray(3, np.int32))
    JaxManager(str(tmp_path / "p-probe-ckpt")).save(
        3, JaxProbeState(step=np.asarray(3, np.int32), probe_params=params, opt=opt))
    probe = probes.AttentionProbe(LAYOUT, emb_dim=192)
    state = avprediction.ProbeState(probe, optim.make_optimizer([probe]))
    src = resume_source(str(tmp_path / "p-probe-latest.pth.tar"))
    assert src == str(tmp_path / "p-probe-ckpt")
    load_probe_state(src, state)
    _assert_module_and_moments(probe, state.optimizer, params, opt,
                               torch_import.probe_params_to_state_dict)
    assert state.step == 3

    jcls = JaxClassifier(embed_dim=192, num_heads=3, depth=1, num_classes=5)
    cparams = jax.device_get(jax.jit(jcls.init)(jax.random.key(1),
                                                jnp.zeros((1, 16, 192)))["params"])
    copt = jax_optim.AdamWState(mu=noisy(cparams), nu=jax.tree_util.tree_map(
        np.abs, noisy(cparams)), count=np.asarray(3, np.int32))
    JaxManager(str(tmp_path / "e-cls-ckpt")).save(3, {
        "cls": cparams, "opt": copt, "step": np.asarray(3, np.int32),
        "epoch": np.asarray(2, np.int32)})
    cls = AttentiveClassifier(192, 3, num_classes=5)
    cstate = ClassifierState(cls, optim.make_optimizer([cls], rule=optim.plain_decays))
    assert load_classifier_state(str(tmp_path / "e-cls-latest.pth.tar"), cstate) == 2
    _assert_module_and_moments(cls, cstate.optimizer, cparams, copt,
                               torch_import.classifier_params_to_state_dict)
    assert cstate.step == 3
    other = AttentiveClassifier(192, 3, num_classes=4)  # another num_classes: fresh
    assert load_classifier_state(str(tmp_path / "e-cls-latest.pth.tar"), ClassifierState(
        other, optim.make_optimizer([other], rule=optim.plain_decays))) is None


def _assert_module_and_moments(module, optimizer, params, opt, to_sd):
    want, mu, nu = to_sd(params), to_sd(opt.mu), to_sd(opt.nu)
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    state = optimizer.state_dict()["state"]
    for name, p in module.named_parameters():
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
        s = state[index[id(p)]]
        assert int(s["step"]) == int(opt.count)
        np.testing.assert_array_equal(s["exp_avg"].numpy(), mu[name], err_msg=name)
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu[name], err_msg=name)


def test_reference_file_converts_without_its_moments(tmp_path):
    """``tools/torch_convert_checkpoint.py`` on a reference-layout file (no
    ``step``; an ``opt`` numbered over another optimizer's groups): step
    ``epoch * ipe``, the params through the mapping, zero moments at count
    0, as the JAX converter writes them; the JAX manager restores it."""
    from torch_cpu import load_tool

    state = _fresh_state()
    pth = str(tmp_path / "ref.pth.tar")
    save_train_state(pth, state, epoch=2, loss=0.0, batch_size=2, lr=0.0)
    ckpt = torch.load(pth, weights_only=True)
    del ckpt["step"]
    ckpt["opt"] = {"state": {}, "param_groups": [
        {"params": list(range(len(g["params"]))), "weight_decay": 0.04}
        for g in ckpt["opt"]["param_groups"]]}
    torch.save(ckpt, pth)
    out = str(tmp_path / "ref-ckpt")
    assert load_tool("torch_convert_checkpoint").to_orbax(pth, out, ipe=5) == 10
    tree = JaxManager(out).restore(None, 10)
    assert int(tree["step"]) == 10 and int(tree["enc_opt"]["count"]) == 0
    assert all(not np.asarray(x).any() for x in jax.tree_util.tree_leaves(tree["enc_opt"]["mu"]))
    want = torch_import.encoder_params_from_state_dict(
        {k: v.numpy() for k, v in ckpt["target_encoder"].items()})
    for a, b in zip(jax.tree_util.tree_leaves(tree["target_params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
