"""The port's remat policy (``avjepa_tpu_torch/models/modules.py``): a
remat'd block keeps its attention's out and lse, as the JAX block stack's
``save_only_these_names("attn_out", "attn_lse")``
(``avjepa_tpu/models/encoder.py:73-93``) does, so the forward attention runs
once a layer and the backward recomputes the rest. Held by the plain
versions' call counts, by gradients equal to ``remat=False`` to the bit,
and by the remat'd step against JAX's remat'd ``make_train_step``. f32,
the models and batches of tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avjepa_tpu.models.encoder import Encoder as JaxEncoder
from avjepa_tpu.models.factory import init_encoder_params as jax_init_encoder_params
from avjepa_tpu.models.factory import init_predictor_params as jax_init_predictor_params
from avjepa_tpu.models.predictor import Predictor as JaxPredictor
from avjepa_tpu.train import optim as jax_optim
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.train.step import stack_masksets as jax_stack_masksets
from avjepa_tpu_torch.models.encoder import Encoder
from avjepa_tpu_torch.models.predictor import Predictor
from avjepa_tpu_torch.ops import attention as plain_ops
from avjepa_tpu_torch.ops import flash_attention as fa
from avjepa_tpu_torch.train import optim
from avjepa_tpu_torch.train.state import init_state
from avjepa_tpu_torch.train.step import StepConfig, train_step
from avjepa_tpu_torch.utils import torch_import
from avjepa_tpu_torch.utils.checkpoint import encoder_from_jax_params, predictor_from_jax_params
from test_torch_train import ENC, JAX_LAYOUT, LAYOUT, PRED, _batch, _rel_l2


@pytest.fixture
def calls(monkeypatch):
    """Calls of the attention forwards' plain versions (the kernels' on the
    card) and of the plain attention, by name."""
    counts = {"packed": 0, "classic": 0, "plain": 0}
    for key, module, name in (("packed", fa, "flash_attention_qkv_ref"),
                              ("classic", fa, "flash_attention_ref"),
                              ("plain", plain_ops, "xla_attention")):
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _key=key, **k):
            counts[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, counted)
    return counts


def _models(remat: bool, attn_impl: str):
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC)
    jpred = JaxPredictor(layout=JAX_LAYOUT, **PRED)
    enc = encoder_from_jax_params(Encoder(LAYOUT, **{**ENC, "remat": remat,
                                                     "attn_impl": attn_impl}),
                                  jax_init_encoder_params(jenc, jax.random.key(3)))
    pred = predictor_from_jax_params(Predictor(LAYOUT, **{**PRED, "remat": remat,
                                                          "attn_impl": attn_impl}),
                                     jax_init_predictor_params(jpred, jax.random.key(4)))
    return enc, pred


def _forward_backward(enc, pred, seed: int = 5):
    """The context encoder on mask config 0's kept tokens and the predictor
    on its union, a random projection of the predictions backpropagated."""
    video, audio, masks = _batch(seed)
    m = masks[0]
    n = LAYOUT.num_tokens
    idx = torch.from_numpy(m.enc_idx)
    ctx = enc(torch.from_numpy(video), torch.from_numpy(audio), key_mask=idx < n,
              gather_idx=idx)
    from avjepa_tpu_torch.models.predictor import scatter_rows

    z = pred(scatter_rows(ctx, idx, n), torch.from_numpy(m.enc), torch.from_numpy(m.pred), 0,
             gather_idx=torch.from_numpy(m.union_idx))
    probe = torch.randn(z.shape, generator=torch.Generator().manual_seed(seed))
    (z * probe).sum().backward()
    return [p.grad.clone() for mod in (enc, pred) for p in mod.parameters()]


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_remat_runs_attention_once_a_layer_with_the_same_bits(calls, attn_impl):
    """Two encoder layers (3 heads of 64: the classic path, or the plain
    attention) and two predictor layers (3 heads of 128: the packed path),
    forward and backward: with remat each kernel path's attention forward
    runs once a layer, as without. The plain attention keeps no
    probabilities under remat, so its backward runs the softmax again from
    the recomputed qkv, as the JAX backward does from its saved output; it
    runs once a layer without remat. The gradients equal ``remat=False``'s
    to the bit."""
    grads, seen = [], []
    for remat in (False, True):
        for k in calls:
            calls[k] = 0
        grads.append(_forward_backward(*_models(remat, attn_impl)))
        seen.append(dict(calls))
    if attn_impl == "flash":
        assert seen == [{"packed": 2, "classic": 2, "plain": 0}] * 2
    else:
        assert seen == [{"packed": 0, "classic": 0, "plain": 4},
                        {"packed": 0, "classic": 0, "plain": 8}]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_train_step_matches_jax_remat_step():
    """The remat'd step (both sides ``remat=True``: the JAX blocks under
    ``nn.remat`` with ``save_only_these_names``, Pallas in interpret mode;
    the port's keeping the attention's out and lse) on the same
    weights, batches and masks: the first step's loss, grad-avg and every
    gradient (relative L2 <= 1e-4; JAX's read from its first AdamW moment,
    mu = (1 - b1) * g), three steps' losses within 0.2%, as
    tests/test_torch_train.py::test_train_step_matches_jax holds the step
    without remat."""
    kw = dict(ipe=10, num_epochs=4, warmup_epochs=1)
    step_kw = dict(loss_exp=1.0, reg_coeff=0.5, clip_grad=10.0, warmup_epochs=1, ipe=10)
    jenc = JaxEncoder(layout=JAX_LAYOUT, **ENC, remat=True)
    jpred = JaxPredictor(layout=JAX_LAYOUT, **PRED, remat=True)
    jstate = jax_init_state(jax_init_encoder_params(jenc, jax.random.key(7)),
                            jax_init_predictor_params(jpred, jax.random.key(8)))
    jstep = jax.jit(make_train_step(jenc, jpred, jax_optim.ScheduleConfig(**kw),
                                    JaxStepConfig(**step_kw)))
    state = init_state(
        encoder_from_jax_params(Encoder(LAYOUT, **ENC, remat=True), jstate.enc_params),
        predictor_from_jax_params(Predictor(LAYOUT, **PRED, remat=True), jstate.pred_params))
    sched, cfg = optim.ScheduleConfig(**kw), StepConfig(**step_kw)
    jax_losses, losses = [], []
    for i in range(3):
        video, audio, masks = _batch(10 + i)
        enc, pred, idx, union = jax_stack_masksets(masks, True)
        jstate, jm = jstep(jstate, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(enc),
                           jnp.asarray(pred), tuple(jnp.asarray(x) for x in idx),
                           jnp.asarray(union))
        m = train_step(state, sched, cfg, torch.from_numpy(video), torch.from_numpy(audio),
                       torch.from_numpy(enc), torch.from_numpy(pred),
                       tuple(torch.from_numpy(x) for x in idx), torch.from_numpy(union))
        jax_losses.append(float(jm["loss"]))
        losses.append(m["loss"])
        if i == 0:
            for k in ("loss", "enc_grad_avg", "pred_grad_avg"):
                assert abs(m[k] - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
            for name, mu, module in (("encoder", jstate.enc_opt.mu, state.encoder),
                                     ("predictor", jstate.pred_opt.mu, state.predictor)):
                to_sd = getattr(torch_import, f"{name}_params_to_state_dict")
                want = to_sd(jax.tree_util.tree_map(lambda x: np.asarray(x) / 0.1, mu))
                got = {k: p.grad.numpy() for k, p in module.named_parameters()}
                assert sorted(got) == sorted(want)
                for k in got:
                    assert _rel_l2(got[k], want[k]) <= 1e-4, (name, k)
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3)
