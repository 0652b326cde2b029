"""tools/torch_parity_bf16.py, the port's bf16-against-f32 fidelity curve,
held against the JAX tool (tools/parity_bf16.py) and the JAX step on the
CPU: its report on the JAX curve's committed losses, its mask draws, the
two runs' common start, and its f32 run against JAX's make_train_step at a
tiny geometry (vit_tiny at crop 64, 4 frames, batch 2, predictor 2 x 96)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_cpu import load_tool, one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.config import load_config as jax_load_config
from avjepa_tpu.masks.multiblock3d import make_mask_collator as jax_make_mask_collator
from avjepa_tpu.train import pretrain as jax_pretrain
from avjepa_tpu.train.optim import ScheduleConfig as JaxScheduleConfig
from avjepa_tpu.train.state import init_state as jax_init_state
from avjepa_tpu.train.step import StepConfig as JaxStepConfig
from avjepa_tpu.train.step import make_train_step
from avjepa_tpu.train.step import stack_masksets as jax_stack_masksets
from avjepa_tpu.utils import torch_import as jax_torch_import
from avjepa_tpu_torch.masks.multiblock3d import stack_masksets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


tp = load_tool("torch_parity_bf16")


def _tiny():
    d = tp.north_star_config("vit_tiny", 2)
    d["data"].update(crop_size=64, num_frames=4)
    d["model"].update(pred_depth=2, pred_embed_dim=96)
    d["mask"][1]["spatial_scale"] = [0.5, 0.5]  # 2 blocks on a 4 x 4 grid
    return d


def test_deviation_report_matches_the_jax_tool(capsys):
    """On the JAX curve's 200-step losses (ViT-L AV, batch 16, on its TPU)
    the port's report prints what the JAX tool's prints, and its JSON adds
    max_abs_dev: max rel 2.113e-2 (past 1% first at step 117), max abs
    1.909e-3."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        with open(os.path.join(REPO, "bench_artifacts",
                               f"parity_bf16_vit_large_b16_s200_{dtype}.json")) as f:
            runs[dtype] = json.load(f)
    args = (runs["float32"], runs["bfloat16"], "f32", "bf16(prod)", 5)
    load_tool("parity_bf16")._deviation_report(*args)
    want = capsys.readouterr().out.splitlines()
    report = tp._deviation_report(*args)
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]
    theirs = json.loads(want[-1])
    assert json.loads(got[-1]) == report == {**theirs, "max_abs_dev": report["max_abs_dev"]}
    assert round(report["max_rel_dev"], 5) == 2.113e-2
    assert round(report["max_abs_dev"], 6) == 1.909e-3
    assert report["first_step_over_1pct"] == 117


def test_mask_draws_equal_the_jax_tools():
    """The port's collator copy draws the JAX tool's masks at base seed 7,
    at the north-star geometry (1664 tokens, batch 16)."""
    d = tp.north_star_config()
    got = tp.draw_masks(d, 3)
    jcfg = jax_load_config(d)
    coll = jax_make_mask_collator("multiblock3d", jcfg.mask, jcfg.layout(), base_seed=7)
    for ours in got:
        theirs = jax_stack_masksets(coll(16), with_idx=True)
        ours = stack_masksets(ours, with_idx=True)
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(a, b)


def test_the_two_runs_start_bit_equal_and_stay_close():
    """Both runs start from the same weights (run_curve asserts it to the
    bit), run the same masks and data, and their 2-step curves agree to
    bf16's precision; here the f32 run is the control with bf16 products
    (the f32 run proper is held against JAX below)."""
    out = tp.run_curve(_tiny(), 2, "cpu", ref="float32-bf16-dots")
    assert out["same_start"] and out["finite"]
    assert len(out["bf16_losses"]) == len(out["f32_losses"]) == 2
    assert out["bf16_losses"] != out["f32_losses"]
    assert out["report"]["max_rel_dev"] < 1e-2


def test_f32_run_matches_the_jax_step():
    """The f32 run over 3 steps against the JAX package's f32 step
    (make_train_step, the Pallas kernels in interpret mode) on the bridged
    starting weights, the same data and the same masks: losses within 0.2%
    (ROADMAP's step tolerance)."""
    d = _tiny()
    masks = tp.draw_masks(d, 3)
    ours = tp.run_arm(d, "float32", masks, "cpu")

    d["meta"]["dtype"] = "float32"
    jcfg = jax_load_config(d)
    encoder, predictor = jax_pretrain.build_models(jcfg, jcfg.layout())
    start = {k: {n: t.numpy() for n, t in sd.items()} for k, sd in ours["start"].items()}
    state = jax_init_state(jax_torch_import.encoder_params_from_state_dict(start["encoder"]),
                           jax_torch_import.predictor_params_from_state_dict(start["predictor"]))
    opt = jcfg.optimization
    sched = JaxScheduleConfig(
        ipe=opt.ipe, num_epochs=opt.epochs, ipe_scale=opt.ipe_scale, warmup_epochs=opt.warmup,
        start_lr=opt.start_lr, ref_lr=opt.lr, final_lr=opt.final_lr, ref_wd=opt.weight_decay,
        final_wd=opt.final_weight_decay, ema_start=opt.ema[0], ema_end=opt.ema[1])
    step_cfg = JaxStepConfig(loss_exp=jcfg.loss.loss_exp, reg_coeff=jcfg.loss.reg_coeff,
                             clip_grad=opt.clip_grad, warmup_epochs=int(opt.warmup),
                             ipe=opt.ipe, betas=tuple(opt.betas), eps=opt.eps)
    step = jax.jit(make_train_step(encoder, predictor, sched, step_cfg))
    cfg = tp.load_config(d)
    losses = []
    for i, m in enumerate(masks):
        video, audio = (x.numpy() for x in tp.step_batch(cfg, i, torch.device("cpu")))
        enc, pred, idx, union = jax_stack_masksets(m, with_idx=True)
        state, metrics = step(state, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(enc),
                              jnp.asarray(pred), tuple(jnp.asarray(x) for x in idx),
                              jnp.asarray(union))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(ours["losses"], losses, rtol=2e-3)


@pytest.mark.parametrize("model,want", [
    ("vit_large", {"fwd_packed": 84, "bwd_packed": 60, "fwd": 0, "bwd": 0}),
    ("vit_tiny", {"fwd_packed": 0, "bwd_packed": 0, "fwd": 38, "bwd": 26}),
])
def test_launches_a_step(model, want):
    """The launch counts the tool asserts on a GPU: chip_smoke.py's
    VITL_K1_A_STEP and 60 K2 a ViT-L step; at the tiny geometry neither
    vit_tiny's 3 heads of 64 nor its 2 x 96 predictor's 3 heads of 32 pack,
    so the classic kernels run."""
    d = _tiny() if model == "vit_tiny" else tp.north_star_config()
    assert tp.launches_a_step(tp.load_config(d)) == want


def test_bf16_dots_round_each_product_s_operands():
    """The control run's linear layers (--ref float32-bf16-dots): the
    output and the three gradients equal f32 products of bf16-rounded
    operands, as a TPU's default-precision f32 matmul computes them, and
    F.linear is itself again once the context closes."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 7), generator=gen, requires_grad=True)
    w = torch.randn((3, 7), generator=gen, requires_grad=True)
    b = torch.randn((3,), generator=gen, requires_grad=True)
    dy = torch.randn((2, 5, 3), generator=gen)
    with tp.bf16_dots():
        y = torch.nn.functional.linear(x, w, b)
        y.backward(dy)
    r = lambda t: t.detach().to(torch.bfloat16).float()  # noqa: E731
    torch.testing.assert_close(y, r(x) @ r(w).T + b, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, r(dy) @ r(w), rtol=0, atol=0)
    torch.testing.assert_close(w.grad, r(dy).reshape(-1, 3).T @ r(x).reshape(-1, 7),
                               rtol=0, atol=0)
    torch.testing.assert_close(b.grad, dy.reshape(-1, 3).sum(0), rtol=0, atol=0)
    assert torch.nn.functional.linear is tp._LINEAR
    assert not torch.equal(y, torch.nn.functional.linear(x, w, b))
