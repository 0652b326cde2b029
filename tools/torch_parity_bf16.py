"""Training fidelity of the port's bf16 path against f32: the loss-curve
drift of avjepa_tpu_torch's production dtype, counterpart of
``tools/parity_bf16.py --mode chip``.

    python tools/torch_parity_bf16.py [--model vit_large] [--batch 16] [--steps 200]
        [--out-json PATH] [--device cuda|cpu]

Two runs of the port's pretrain step from the same weights, on the same
per-step data and the same mask draws: one at ``meta.dtype: bfloat16`` (the
production path), one at ``float32``. Both run the packed attention kernels
(K1/K2 take f32 as well as bf16), remat on, as the north-star benchmark
geometry (ViT-L/16 AV, 16 x 224^2 video plus the mel spectrogram, 1664
tokens; predictor 12 x 384; two multiblock mask configs; ipe 300, epochs 300,
warmup 40; seed 0) defines it. Each step's batch is drawn on the device
from a generator seeded ``1000 + step``, in f32, then cast to the run's
dtype; every mask set is drawn up front from one collator at base seed 7
(``--seed S`` draws weights from S, masks from 7 + S and batches from
1000 + 100000 S + step);
every 10th step computes the full metrics, the others the light ones. The
f32 run's matmuls are true f32 (TF32 off). Prints the per-step losses, the
max relative and absolute deviation and the first step past 1%, each run's
step ms (after the first step; CUDA events on a GPU) and peak memory, beside
two yardsticks: the JAX package's own bf16 drift at this geometry and the
reference's torch autocast drift. On a GPU it asserts the kernels' launch
counts a step in each run.

``--ref float32-bf16-dots`` runs the f32 run with every linear layer's
products at a TPU's default f32 matmul precision instead (operands rounded
to bf16, f32 sums, forward and backward; the attention kernels stay f32):
the precision the JAX package's f32 run had on its TPU, where nothing sets
a matmul precision.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import sys
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from avjepa_tpu_torch.config import load_config  # noqa: E402
from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator  # noqa: E402
from avjepa_tpu_torch.models.factory import DTYPES, VIT_SPECS  # noqa: E402
from avjepa_tpu_torch.ops import flash_attention as fa  # noqa: E402
from avjepa_tpu_torch.train import pretrain  # noqa: E402
from avjepa_tpu_torch.train.step import train_step  # noqa: E402
from avjepa_tpu_torch.utils.device import resolve_device  # noqa: E402

# max |loss_bf16 - loss_f32| over 200 steps at ViT-L AV, batch 16: the JAX
# package on its TPU (bench_artifacts/parity_bf16_vit_large_b16_s200_*.json)
# and the reference's torch f32 against torch.autocast(bf16) at the tiny
# step-parity geometry (bench_artifacts/parity_dtype_control_s200.json)
JAX_MAX_ABS_DEV = 1.91e-3
REFERENCE_AUTOCAST_MAX_ABS_DEV = 3.96e-3
MASK_SEED = 7
DATA_SEED = 1000
DATA_SEEDS_A_RUN = 100_000
FULL_METRICS_EVERY = 10


def north_star_config(model_name: str = "vit_large", batch: int = 16) -> dict:
    """The JAX benchmark's config dict (``bench.py::north_star_config``),
    copied: the geometry both fidelity curves run."""
    return {
        "app": "avjepa",
        "data": {
            "dataset_type": "audiovideodataset",
            "batch_size": batch,
            "num_frames": 16,
            "tubelet_size": 2,
            "crop_size": 224,
            "patch_size": 16,
            "num_workers": 4,
            "source": "synthetic",
        },
        "mask": [
            {"aspect_ratio": [0.75, 1.5], "num_blocks": 8,
             "spatial_scale": [0.15, 0.15], "temporal_scale": [1.0, 1.0]},
            {"aspect_ratio": [0.75, 1.5], "num_blocks": 2,
             "spatial_scale": [0.7, 0.7], "temporal_scale": [1.0, 1.0]},
        ],
        "meta": {"seed": 0, "dtype": "bfloat16"},
        "model": {"model_name": model_name, "pred_depth": 12,
                  "pred_embed_dim": 384, "uniform_power": True,
                  "use_mask_tokens": True, "zero_init_mask_tokens": True},
        "optimization": {"ipe": 300, "epochs": 300, "warmup": 40},
        "logging": {"folder": "/tmp/avjepa_bench", "write_tag": "bench"},
        "tpu": {"remat": True, "attn_impl": "flash"},
    }


def _deviation_report(losses_ref, losses_test, label_ref, label_test,
                      print_every: int = 1) -> dict:
    """``tools/parity_bf16.py``'s report, line for line; its JSON also
    carries ``max_abs_dev``, which it returns."""
    worst = 0.0
    worst_abs = 0.0
    first_over_1pct = None
    print(f"{'step':>5} {label_ref:>14} {label_test:>14} {'rel dev':>10}")
    for i, (lr, lt) in enumerate(zip(losses_ref, losses_test)):
        dev = abs(lt - lr) / max(abs(lr), 1e-9)
        worst = max(worst, dev)
        worst_abs = max(worst_abs, abs(lt - lr))
        if dev > 0.01 and first_over_1pct is None:
            first_over_1pct = i
        if i % print_every == 0 or dev > 0.01:
            print(f"{i:>5} {lr:>14.6f} {lt:>14.6f} {dev:>10.2e}")
    n = len(losses_ref)
    print(f"max relative deviation over {n} steps: {worst:.3e}"
          f" ({'WITHIN' if worst < 0.01 else 'OUTSIDE'} the 1% target)")
    if first_over_1pct is not None:
        print(f"first step past 1%: {first_over_1pct}")
    report = {
        "steps": n, "max_rel_dev": worst,
        "first_step_over_1pct": first_over_1pct,
        "ref": label_ref, "test": label_test, "max_abs_dev": worst_abs,
    }
    print(json.dumps(report))
    return report


def draw_masks(cfg_dict: dict, steps: int) -> list:
    """Every step's mask sets, from one collator at base seed 7 +
    ``meta.seed`` (at seed 0 the JAX tool's draws: the collator is the JAX
    package's, copied)."""
    cfg = load_config(cfg_dict)
    coll = make_mask_collator("multiblock3d", cfg.mask, cfg.layout(),
                              base_seed=MASK_SEED + cfg.meta.seed)
    return [coll(cfg.data.batch_size) for _ in range(steps)]


def step_batch(cfg, step: int, device: torch.device):
    """Step ``step``'s video [B, T, H, W, 3] and audio [B, 128, 192, 1], drawn
    in f32 on ``device`` from a generator seeded 1000 + step (plus 100000 x
    ``meta.seed``), then cast to the run's dtype (as the loader ships
    pixels)."""
    lo, b = cfg.layout(), cfg.data.batch_size
    seed = DATA_SEED + DATA_SEEDS_A_RUN * cfg.meta.seed + step
    gen = torch.Generator(device=device).manual_seed(seed)
    video = torch.randn((b, lo.num_frames, lo.crop_size, lo.crop_size, 3), generator=gen,
                        device=device)
    audio = torch.randn((b, lo.spec_height, lo.spec_width, 1), generator=gen, device=device)
    dt = DTYPES[cfg.meta.dtype]
    return video.to(dt), audio.to(dt)


def launches_a_step(cfg) -> dict:
    """Attention launches of one step: each layer's forward once (target,
    both context passes, predictor; remat keeps the attention's output) and
    each trained layer's backward once, on the packed or the classic kernel
    as the heads pack."""
    spec = VIT_SPECS[cfg.model.model_name]
    want = {k: 0 for k in fa.LAUNCHES}
    # (width, forward layers, backward layers); the predictor keeps the
    # encoder's head count
    for dim, fwd, bwd in ((spec.embed_dim, 3 * spec.depth, 2 * spec.depth),
                          (cfg.model.pred_embed_dim, cfg.model.pred_depth,
                           cfg.model.pred_depth)):
        packed = fa.packed_qkv_eligible(spec.num_heads, dim // spec.num_heads)
        want["fwd_packed" if packed else "fwd"] += fwd
        want["bwd_packed" if packed else "bwd"] += bwd
    return want


_LINEAR = torch.nn.functional.linear


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _Bf16DotLinear(torch.autograd.Function):
    """``F.linear`` of f32 tensors with each product's operands rounded to
    bf16 and f32 sums, in the forward and both backward products: an f32
    matmul at a TPU's default precision (one bf16 pass)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = _round_bf16(x), _round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = bias is not None
        return _LINEAR(xr, wr, bias)

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = _round_bf16(dy)
        dy2, x2 = dyr.reshape(-1, dy.shape[-1]), xr.reshape(-1, xr.shape[-1])
        db = dy.reshape(-1, dy.shape[-1]).sum(0) if ctx.has_bias else None
        return dyr @ wr, dy2.T @ x2, db


@contextlib.contextmanager
def bf16_dots():
    """While open, every f32 ``F.linear`` runs as ``_Bf16DotLinear``."""
    def linear(x, weight, bias=None):
        if x.dtype != torch.float32:
            return _LINEAR(x, weight, bias)
        return _Bf16DotLinear.apply(x, weight, bias)

    torch.nn.functional.linear = linear
    try:
        yield
    finally:
        torch.nn.functional.linear = _LINEAR


def _state_dicts(h) -> dict:
    return {name: {k: v.detach().to("cpu", copy=True) for k, v in
                   getattr(h.state, name).state_dict().items()}
            for name in ("encoder", "predictor", "target_encoder")}


def run_arm(cfg_dict: dict, dtype: str, masks: list, device, init: dict | None = None,
            dots_in_bf16: bool = False) -> dict:
    """``len(masks)`` steps of the pretrain step at ``meta.dtype: dtype``
    from the weights ``init`` (the state dicts of the three models; None
    takes this run's seeded ones), the linear layers' products under
    ``bf16_dots`` if ``dots_in_bf16``. Returns the losses, the state it
    started from, step ms after the first step, peak GiB and launches."""
    device = resolve_device(device)
    d = copy.deepcopy(cfg_dict)
    d["meta"]["dtype"] = dtype
    cfg = load_config(d)
    h = pretrain.setup(cfg, device)
    h.loader.close()
    if init is not None:
        for name, sd in init.items():
            getattr(h.state, name).load_state_dict(sd, strict=True)
    start = _state_dicts(h)
    steps = len(masks)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fa.reset_launches()
    losses, t0 = [], None
    dots = bf16_dots() if dots_in_bf16 else contextlib.nullcontext()
    with dots:
        for i in range(steps):
            if i == 1:
                if on_gpu:
                    events[0].record()
                t0 = time.perf_counter()
            video, audio = step_batch(cfg, i, device)
            m = train_step(h.state, h.sched, h.step_cfg, **h.to_device(video, audio, masks[i]),
                           full_metrics=i % FULL_METRICS_EVERY == 0)
            losses.append(float(m["loss"]))
    ms = None
    if steps > 1:
        if on_gpu:
            events[1].record()
            events[1].synchronize()
            ms = events[0].elapsed_time(events[1]) / (steps - 1)
        else:
            ms = 1000 * (time.perf_counter() - t0) / (steps - 1)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_gpu else None
    if on_gpu:
        want = {k: steps * v for k, v in launches_a_step(cfg).items()}
        if launches != want:
            raise AssertionError(f"{dtype} run: launches {launches}, expected {want}")
    del h
    if on_gpu:
        torch.cuda.empty_cache()
    return {"losses": losses, "start": start, "step_ms": ms, "peak_gib": peak,
            "launches": launches}


REFS = {"float32": "f32", "float32-bf16-dots": "f32(bf16 dots)"}


def run_curve(cfg_dict: dict, steps: int, device="cuda", ref: str = "float32") -> dict:
    """Both runs (bf16 first, then the f32 run ``ref`` names from the bf16
    run's starting weights) and the deviation report; raises unless both
    started from the same weights to the bit. TF32 is off for the whole
    call."""
    masks = draw_masks(cfg_dict, steps)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        bf16 = run_arm(cfg_dict, "bfloat16", masks, device)
        f32 = run_arm(cfg_dict, "float32", masks, device, init=bf16["start"],
                      dots_in_bf16=ref == "float32-bf16-dots")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    same = all(torch.equal(bf16["start"][m][k], f32["start"][m][k])
               for m in bf16["start"] for k in bf16["start"][m])
    if not same or any(bf16["start"][m].keys() != f32["start"][m].keys() for m in bf16["start"]):
        raise AssertionError("the bf16 and f32 runs did not start from the same weights")
    report = _deviation_report(f32["losses"], bf16["losses"], REFS[ref], "bf16",
                               print_every=max(1, steps // 40))
    for name, arm in (("bf16", bf16), (REFS[ref], f32)):
        ms = "n/a" if arm["step_ms"] is None else f"{arm['step_ms']:.1f}"
        peak = "n/a" if arm["peak_gib"] is None else f"{arm['peak_gib']:.2f}"
        print(f"{name}: {ms} ms a step after the first, peak {peak} GiB, "
              f"launches {arm['launches']}")
    print(f"max |bf16 - {REFS[ref]}| {report['max_abs_dev']:.3e}; yardsticks: the JAX "
          f"package {JAX_MAX_ABS_DEV:.2e}, the reference's autocast "
          f"{REFERENCE_AUTOCAST_MAX_ABS_DEV:.2e}")
    finite = all(math.isfinite(x) for x in bf16["losses"] + f32["losses"])
    return {"report": report, "same_start": same, "finite": finite,
            **{f"{name}_{k}": arm[k] for name, arm in (("bf16", bf16), ("f32", f32))
               for k in ("losses", "step_ms", "peak_gib", "launches")}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="vit_large")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, masks and batches from another seed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ref", choices=sorted(REFS), default="float32",
                    help="the run bf16 is held against: true f32 (TF32 off), or f32 "
                    "with the linear layers' products at a TPU's default precision")
    ap.add_argument("--out-json", default=None,
                    help="also write both runs' per-step losses and the report here")
    args = ap.parse_args(argv)
    print(f"== {args.model} b{args.batch} {args.steps} steps, seed {args.seed}: bf16 "
          f"against {REFS[args.ref]}, same weights, data and masks ==", flush=True)
    cfg = north_star_config(args.model, args.batch)
    cfg["meta"]["seed"] = args.seed
    out = run_curve(cfg, args.steps, args.device, args.ref)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
