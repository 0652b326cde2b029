#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (avjepa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (Hopper, for
the sm_90a kernels). Phases, each printed as it runs; any failure raises and
exits non-zero:
  1. toolchain and card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the CUDA kernels from avjepa_tpu_torch/csrc, one nvcc per source,
     all started together;
  3. each kernel against its plain PyTorch version on the card: the forward
     kernels in bf16, f16 and f32 at the serving shapes (head_dim 24, 64 and
     80, ragged N, an empty batch row), with their registers and spills from
     the build log; the backward kernels in bf16 and f32 at the training
     slice's shapes (with sentinel tails, an empty batch row, ragged N and
     saturated logits); then each kernel's time beside its plain version's,
     one PyTorch library call's (scaled_dot_product_attention, forward or
     backward) and its bound;
  4. the extract app through its CLI entry: ViT-L/16 AV, bf16, batch 24,
     96 synthetic clips of 16x224^2 video + 128x192 mel (1664 tokens), from
     a random encoder; then vit_tiny (3 heads, the classic kernel) for one
     batch; one batch is re-encoded through the plain attention and
     compared, and profiled (chiprun_out/extract_profile.txt);
  5. the pretrain app: ViT-L/16 AV (av-vitl16.yaml: bf16, batch 24, remat,
     synthetic clips) for 6 steps through train.pretrain, then the extract
     app reading its checkpoint's target encoder; vit_tiny (av-vitt16.yaml,
     all four kernels) for 2 steps through the CLI entry. CSV rows,
     checkpoints and finite losses are checked;
  6. one ViT-L step at batch 4 through the kernels against the same step
     through the plain attention (loss and grad norms);
  7. the ViT-L step on a resident batch of 24 (CUDA events, peak memory,
     a torch.profiler window), with remat and without;
  8. the LayerNorm kernels K5/K6 through FastLayerNorm, forward and
     backward, against their plain versions in bf16 and f32 at [39936,
     1024], [67584, 384] and a ragged [1003, 192]; two backward runs give
     the same dgamma/dbeta bits; times beside the plain version,
     F.layer_norm and the bound;
  9. the avprediction apps at av-vitl16_prediction.yaml (ViT-L AV, bf16,
     batch 24, synthetic clips) on the pretrain checkpoint of phase 5: 4
     probe steps through registry.app_main, avprediction_example, and the
     av_prediction eval through its CLI entry;
 10. one probe step's frozen tokens and loss at batch 4 through the kernels
     against the plain attention; the probe step timed on a resident batch
     of 24 (CUDA events, peak memory), with K1 timed at its two dense
     key-masked shapes of that path (d=64 encoder, d=24 predictor).
Every run of phases 4-5 and 9 is driven with the kernels' launch counts set
to 0 just before it and asserted just after. The last lines are a JSON
kernel table, the card's name and power limit, and {"ok": true, "device":
{...}}. Without a GPU it exits 1 and prints no result.

Phases run alone too; the forward kernels, for instance:
    python3 -c 'import chip_smoke as c, tempfile; c.toolchain(); c.build();
        c.check_kernels(); c.time_kernels();
        c.time_probe_k1(*c.probe_masks(tempfile.mkdtemp()))'
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FWD_SOURCE = "avjepa_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "avjepa_tpu_torch/csrc/attention_bwd.cu"
LN_SOURCE = "avjepa_tpu_torch/csrc/layer_norm.cu"

# max abs error of kernel vs plain version, (out, lse). bf16/f16: the two
# share every rounding point, but their f32 sums run in other orders, which
# can flip an output's last bit (2^-7 in bf16, 2^-10 in f16, near |out| = 2).
# f32: sums over up to 1664 keys in another order than cuBLAS's.
TOL = {"bfloat16": (2e-2, 1e-3), "float16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}
# max abs error of a backward kernel against its plain version, relative to
# max|plain|. bf16: the two share every rounding point (q*scale, k*scale, p and
# ds rounded to bf16 before their products, outputs rounded once), but their
# f32 sums run in other orders, which can move one rounding of p or ds by a
# bf16 ulp (2^-8 relative) and an output by an ulp: 2e-2. f32: sums over up to
# 1664 keys in other orders, and ds = p * (dp - delta) cancels: 1e-4.
BWD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# H100 SXM dense bf16 tensor-core peak and HBM3 rate (NVIDIA's data sheet), for
# the bound of each kernel (the larger of its operations and its bytes over
# these rates)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# f32 outside the tensor cores (NVIDIA's data sheet), for LayerNorm's work
PEAK_F32_FLOPS = 67e12
# max abs error of a LayerNorm kernel against its plain version, relative to
# max|plain|: y and dx share every rounding point with the plain version,
# whose f32 row sums run in another order, which can move the one rounding
# to bf16 by an ulp (2^-8 relative, as BWD_REL_TOL) or leave f32 within a
# few ulp; dgamma/dbeta sum up to 67,584 rows in f32 in other orders
LN_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
LN_PARAM_REL_TOL = 1e-4
# relative L2 error of the pooled ViT-L features, kernel vs plain attention,
# in bf16: same rounding points, other summation orders, over 24 layers
POOLED_REL_TOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def toolchain() -> None:
    import torch

    from avjepa_tpu_torch.ops._build import find_nvcc

    # show the build's nvcc command and seconds
    log = logging.getLogger("avjepa_tpu_torch")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    print(f"triton importable: {importlib.util.find_spec('triton') is not None}")
    print(f"card: {card_line()}; torch sees {torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    # f32 comparisons in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build() -> float:
    from avjepa_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library()
    secs = time.perf_counter() - t0
    print(f"build: kernels built and loaded in {secs:.1f} s")
    return secs


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def print_fwd_resources() -> None:
    """Registers, shared memory and spills of each forward kernel, from the
    build log (nvcc -Xptxas -v), demangled where cu++filt is found."""
    from pathlib import Path

    from avjepa_tpu_torch.ops._build import find_nvcc, load_library

    log = Path(load_library()._name).with_suffix(".log")
    if not log.exists():
        print(f"build log {log.name} not found (library built by another run)")
        return
    name, lines = None, []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "attn_fwd" in name and ("spill" in line or "Used" in line):
            lines.append((name, line.split(":", 1)[-1].strip()))
    demangle = Path(find_nvcc()).with_name("cu++filt")
    names = sorted({n for n, _ in lines})
    if demangle.exists() and names:
        out = subprocess.run([str(demangle), *names], capture_output=True, text=True)
        pretty = dict(zip(names, out.stdout.splitlines()))
    else:
        pretty = {}
    for n, line in lines:
        label = re.sub(r"\(bool\)1", "true", pretty.get(n, n))
        label = re.sub(r"\(bool\)0|\(int\)|^void |<unnamed>::|\(anonymous namespace\)::", "",
                       label.replace("(bool)0", "false"))
        print(f"  ptxas {label.split('(')[0]}: {line}")


def check_kernels() -> dict:
    """Each kernel vs its plain version; returns the bf16 max abs error at
    the serving path's shape for each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    print("forward kernels' resources (ptxas):")
    print_fwd_resources()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def compare(name, dtype, got, want):
        (out, lse), (ref_out, ref_lse) = got, want
        tol_out, tol_lse = TOL[str(dtype).split(".")[-1]]
        err = _max_err(out, ref_out)
        lse_err = _max_err(lse, ref_lse)
        ok = err <= tol_out and lse_err <= tol_lse
        print(f"  {name} {str(dtype).split('.')[-1]}: max|out err| {err:.3e} "
              f"(tol {tol_out:g}), max|lse err| {lse_err:.3e} (tol {tol_lse:g})"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    main_err = {}
    print("kernels vs plain versions:")
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        # K1, packed qkv: (B, N, H, d, masked); N(0, 1) inputs keep the
        # no-max softmax's p far below f16's overflow
        for b, n, h, d, masked in (
            (24, 1664, 16, 64, False),  # serving path (target encoder)
            (24, 1664, 16, 64, True),   # random key mask, batch row 0 all masked
            (48, 1408, 16, 24, True),   # predictor geometry
            (2, 200, 16, 64, False),    # ragged N
            (4, 1664, 16, 80, True),    # vit_huge geometry (head_dim 80 packs)
        ):
            qkv = randn((b, n, 3 * h * d), dtype)
            mask = None
            if masked:
                mask = torch.rand((b, n), generator=gen, device="cuda") < 0.7
                mask[0] = False
            got = fa.flash_attention_qkv_fwd(qkv, h, mask)
            torch.cuda.synchronize()
            err = compare(f"attn_fwd_packed B={b} N={n} H={h} d={d} masked={masked}",
                          dtype, got, fa.flash_attention_qkv_ref(qkv, h, mask))
            if masked and got[0][0].abs().max().item() != 0.0:
                raise AssertionError("attn_fwd_packed: a fully-masked row is not 0")
            if dtype == torch.bfloat16 and (n, d, masked) == (1664, 64, False):
                main_err["fwd_packed"] = err
            del qkv, got
        # K3, classic [B, H, N, d]: unmasked; one fully-masked 128-key
        # block; ragged N; random keys with batch row 0 fully masked, at
        # head_dim 64, 24 and 80
        for b, n, d, kind in ((24, 1664, 64, None), (24, 1664, 64, "block"),
                              (2, 200, 64, None), (4, 1664, 64, "empty row"),
                              (4, 1408, 24, "empty row"), (4, 1664, 80, "empty row")):
            h = 3
            q, k, v = (randn((b, h, n, d), dtype) for _ in range(3))
            mask = None
            if kind is not None:
                mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
            if kind == "block":
                mask[:, 128:256] = False
            elif kind == "empty row":
                mask &= torch.rand((b, n), generator=gen, device="cuda") < 0.7
                mask[0] = False
            got = fa.flash_attention_fwd(q, k, v, mask)
            torch.cuda.synchronize()
            want = fa.flash_attention_ref(q, k, v, mask)
            err = compare(f"attn_fwd B={b} H={h} N={n} d={d} mask={kind}", dtype, got, want)
            if kind == "empty row" and (got[0][0].abs().max().item() != 0.0
                                        or not torch.equal(got[1][0], want[1][0])):
                raise AssertionError("attn_fwd: a fully-masked row is not 0, or its lse "
                                     "differs from the plain version's")
            if dtype == torch.bfloat16 and kind is None and n == 1664:
                main_err["fwd"] = err
    return main_err


def _key_mask(gen, b: int, n: int, kind):
    """None, a sentinel tail (the compacted context: the first 7/8 of the
    keys valid), or random keys (p = 0.8) with a sentinel tail and batch row
    0 fully masked (the compacted predictor's union, and an empty row)."""
    import torch

    if kind is None:
        return None
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    mask[:, n - n // 8:] = False
    if kind == "random":
        mask &= torch.rand((b, n), generator=gen, device="cuda") < 0.8
        mask[0] = False
    return mask


def check_bwd_kernels() -> dict:
    """Each backward kernel against its plain version at the training
    slice's shapes, bf16 and f32; returns the bf16 max abs error at the main
    shape of each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def compare(name, dtype, got, want):
        tol = BWD_REL_TOL[str(dtype).split(".")[-1]]
        errs = []
        for g, w in zip(got, want):
            errs.append(_max_err(g, w) / max(w.float().abs().max().item(), 1e-30))
        ok = max(errs) <= tol
        print(f"  {name} {str(dtype).split('.')[-1]}: max|err|/max|plain| "
              f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return max(_max_err(g, w) for g, w in zip(got, want))

    main_err = {}
    print("backward kernels vs plain versions:")
    for dtype in (torch.bfloat16, torch.float32):
        # K2, packed qkv: (label, B, N, H, d, mask)
        for label, b, n, h, d, kind in (
            ("context", 24, 512, 16, 64, "tail"),
            ("predictor", 48, 1408, 16, 24, "random"),
            ("vit_tiny predictor", 48, 1408, 3, 128, "random"),
            ("ragged", 2, 200, 16, 64, None),
        ):
            qkv = randn((b, n, 3 * h * d), dtype)
            dout = randn((b, n, h * d), dtype)
            mask = _key_mask(gen, b, n, kind)
            out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)
            got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask)
            torch.cuda.synchronize()
            want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h, mask)
            c = h * d
            err = compare(f"attn_bwd_packed {label} B={b} N={n} H={h} d={d}", dtype,
                          [got[..., i * c:(i + 1) * c] for i in range(3)],
                          [want[..., i * c:(i + 1) * c] for i in range(3)])
            if kind == "random" and got[0].abs().max().item() != 0.0:
                raise AssertionError("attn_bwd_packed: a fully-masked batch row has a gradient")
            if dtype == torch.bfloat16 and label == "predictor":
                main_err["bwd_packed"] = err
            del qkv, dout, out, lse, got, want
        # K2 with saturated logits: query rows 0-7 see every logit above the
        # clamp, so their ds, and so their dq, is exactly 0
        b, n, h, d = 2, 256, 4, 32
        c = h * d
        qkv = randn((b, n, 3 * c), dtype)
        qkv[:, :, c:2 * c] = qkv[:, :, c:2 * c].abs() + 0.5
        qkv[:, :8, :c] = 32.0  # s >= 32 * 32**-0.5 * 32 * 0.5 > 80
        dout = randn((b, n, c), dtype)
        out, lse = fa.flash_attention_qkv_fwd(qkv, h)
        got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h)
        torch.cuda.synchronize()
        want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h)
        s = (qkv[:, :, :c].float() * d**-0.5).reshape(b, n, h, d)
        s = torch.einsum("bqhd,bkhd->bhqk", s, qkv[:, :, c:2 * c].float().reshape(b, n, h, d))
        if not bool((s[:, :, :8] > fa.SOFTMAX_CLAMP).all()):
            raise AssertionError("saturated case: rows 0-7 do not saturate")
        compare("attn_bwd_packed saturated B=2 N=256 H=4 d=32", dtype,
                [got[..., i * c:(i + 1) * c] for i in range(3)],
                [want[..., i * c:(i + 1) * c] for i in range(3)])
        zeros = want == 0
        if not bool(zeros[:, :8, :c].all()) or not bool((got[zeros] == 0).all()):
            raise AssertionError("attn_bwd_packed: saturated logits have a gradient")
        # K4, classic [B, H, N, d], one fully-masked 128-key block
        for n in (1664, 512):
            b, h, d = 24, 3, 64
            q, k, v, dout = (randn((b, h, n, d), dtype) for _ in range(4))
            mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
            mask[:, 128:256] = False
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask)
            err = compare(f"attn_bwd B={b} H={h} N={n} d={d} masked", dtype, got, want)
            if not bool((got[1][:, :, 128:256] == 0).all()):
                raise AssertionError("attn_bwd: masked keys have a dk")
            if dtype == torch.bfloat16 and n == 512:
                main_err["bwd"] = err
    return main_err


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for work whose operations
    run at ``peak`` (bf16 tensor cores by default)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels() -> dict:
    """bf16 kernel, plain and library (SDPA) times at each kernel's main
    shape, with its bound: {key: (ms, plain_ms, library_ms, bound_ms,
    bound_by)}. Work counts only valid keys (masked key tiles are skipped)."""
    import torch
    import torch.nn.functional as F

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    def sdpa_inputs(q, k, v, mask):
        q, k, v = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        m4 = None if mask is None else mask[:, None, None, :]
        return q, k, v, m4

    def sdpa_bwd_ms(q, k, v, mask):
        q, k, v, m4 = sdpa_inputs(q, k, v, mask)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=m4)
        g = torch.randn_like(o)
        return _time_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), 10)

    def sdpa_fwd_ms(q, k, v, mask):
        q, k, v, m4 = sdpa_inputs(q, k, v, mask)
        with torch.no_grad():
            return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m4), 10)

    times = {}
    # K1: the target encoder's unmasked layer; K2: a predictor layer
    for key, b, n, h, d, kind in (("fwd_packed", 24, 1664, 16, 64, None),
                                  ("bwd_packed", 48, 1408, 16, 24, "random")):
        qkv, dout = randn((b, n, 3 * h * d)), randn((b, n, h * d))
        mask = _key_mask(gen, b, n, kind)
        valid = b * n if mask is None else int(mask.sum().item())
        out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)
        q, k, v = fa._split_qkv(qkv, h)
        io = 4 * b * n * h * d * 2 + b * h * n * 4  # qkv read, out written; lse f32
        if key == "fwd_packed":
            run = (lambda: fa.flash_attention_qkv_fwd(qkv, h, mask),
                   lambda: fa.flash_attention_qkv_ref(qkv, h, mask))
            lib = sdpa_fwd_ms(q, k, v, mask)
            bound = _bound(4 * h * d * n * valid, io)
        else:
            run = (lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask),
                   lambda: fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h, mask))
            lib = sdpa_bwd_ms(q, k, v, mask)
            # reads qkv, out, dO, lse, bias; writes dqkv
            bound = _bound(10 * h * d * n * valid,
                           (8 * b * n * h * d) * 2 + b * h * n * 4 + b * n * 4)
        times[key] = (_time_ms(run[0], 20), _time_ms(run[1], 3), lib, *bound)
        del qkv, dout, out, lse, q, k, v
    # K3: the vit_tiny target encoder; K4: a vit_tiny context layer
    for key, b, h, n, d in (("fwd", 24, 3, 1664, 64), ("bwd", 24, 3, 512, 64)):
        q, k, v, dout = (randn((b, h, n, d)) for _ in range(4))
        mask = None if key == "fwd" else _key_mask(gen, b, n, "tail")
        valid = b * n if mask is None else int(mask.sum().item())
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        if key == "fwd":
            run = (lambda: fa.flash_attention_fwd(q, k, v, mask),
                   lambda: fa.flash_attention_ref(q, k, v, mask))
            lib = sdpa_fwd_ms(q, k, v, mask)
            bound = _bound(4 * h * d * n * valid, 4 * b * h * n * d * 2 + b * h * n * 4)
        else:
            run = (lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, mask),
                   lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask))
            lib = sdpa_bwd_ms(q, k, v, mask)
            bound = _bound(10 * h * d * n * valid, 8 * b * h * n * d * 2 + b * h * n * 4)
        times[key] = (_time_ms(run[0], 20), _time_ms(run[1], 3), lib, *bound)
    for key, (ms, plain, lib, bound, by) in times.items():
        print(f"time {key} bf16: kernel {ms:.3f} ms, plain {plain:.3f} ms, library (SDPA) "
              f"{lib:.3f} ms, bound {bound:.3f} ms ({by}), {100 * bound / ms:.1f}% of the bound")
    return times


@contextlib.contextmanager
def plain_packed_attention():
    """Route the encoder's packed attention through the plain version."""
    from avjepa_tpu_torch.models import modules
    from avjepa_tpu_torch.ops.flash_attention import flash_attention_qkv_ref

    kernel = modules.flash_attention_qkv
    modules.flash_attention_qkv = (
        lambda qkv, h, key_mask=None, scale=None:
        flash_attention_qkv_ref(qkv, h, key_mask, scale)[0]
    )
    try:
        yield
    finally:
        modules.flash_attention_qkv = kernel


def _profile(run, label: str, filename: str, steps: int = 2) -> float:
    """torch.profiler over ``steps`` calls of ``run``: the device time by
    kernel written to chiprun_out/<filename>; prints the device kernel ms per
    call, the top kernels and the forward attention kernel's share. Returns
    the device kernel ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / (1e3 * steps)
    fwd = sum(e.self_device_time_total for e in events
              if "attn_fwd" in e.key) / (1e3 * steps)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{label}: profile, {total:.1f} ms of device kernels per call; forward attention "
          f"kernel {fwd:.1f} ms ({100 * fwd / total:.1f}%); top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / (1e3 * steps):.2f} ms" for e in top))
    return total


def run_slice(workdir: str) -> dict:
    import numpy as np
    import torch
    import yaml

    from avjepa_tpu_torch.app.main import launch
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.serve import extract as ext

    with open(os.path.join(ROOT, "configs/extract/vitl16_extract.yaml")) as f:
        base = yaml.safe_load(f)
    base["meta"]["read_checkpoint"] = None
    base["data"].update(source="synthetic", datasets=[], num_workers=8)
    base["extract"].update(allow_random=True, limit=96)
    cfgs = {}
    for name, model, limit in (("vitl", "vit_large", 96), ("vitt", "vit_tiny", 24)):
        d = json.loads(json.dumps(base))
        d["model"]["model_name"] = model
        d["extract"]["limit"] = limit
        d["logging"]["folder"] = os.path.join(workdir, name)
        cfgs[name] = d
        with open(os.path.join(workdir, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(d, f)

    batch = base["data"]["batch_size"]
    n_batches = -(-96 // batch)
    fa.reset_launches()
    t0 = time.perf_counter()
    summary = launch(os.path.join(workdir, "vitl.yaml"))
    wall = time.perf_counter() - t0
    summary_tiny = launch(os.path.join(workdir, "vitt.yaml"))
    launches = dict(fa.LAUNCHES)
    print(f"slice: launches {launches} (expected fwd_packed {24 * n_batches}, fwd 12)")
    if launches["fwd_packed"] != 24 * n_batches:
        raise AssertionError(f"ViT-L extract launched attn_fwd_packed {launches['fwd_packed']}x")
    if launches["fwd"] != 12:
        raise AssertionError(f"vit_tiny extract launched attn_fwd {launches['fwd']}x")

    z = np.load(os.path.join(summary["output"], "features_r0.npz"))
    emb = z["embeddings"]
    if emb.shape != (96, 1024) or not np.all(np.isfinite(emb)):
        raise AssertionError(f"ViT-L features: shape {emb.shape}, finite {np.isfinite(emb).all()}")
    if z["indices"].tolist() != list(range(96)) or summary["rows_written"] != 96:
        raise AssertionError("ViT-L extract did not write rows 0..95 once each")
    zt = np.load(os.path.join(summary_tiny["output"], "features_r0.npz"))
    if zt["embeddings"].shape != (24, 192) or not np.all(np.isfinite(zt["embeddings"])):
        raise AssertionError("vit_tiny features are wrong")
    print(f"slice: ViT-L extract wrote {emb.shape} finite features, "
          f"{summary['clips_per_sec']} clips/s end to end ({wall:.1f} s for the app, "
          f"encoder init included); vit_tiny wrote {zt['embeddings'].shape}")

    # one batch again: kernel path vs plain attention, and vs what the app wrote
    cfg = load_config(cfgs["vitl"])
    device = torch.device("cuda", 0)
    encoder = ext.build_encoder(cfg, device)
    ds, _, _ = ext._build_dataset(cfg, cfg.layout())
    samples = [ds[i] for i in range(batch)]
    video = torch.from_numpy(np.stack([s[0] for s in samples])).to(device)
    audio = torch.from_numpy(np.stack([s[1] for s in samples])[..., None]).to(device)
    torch.cuda.reset_peak_memory_stats()
    h_kernel = ext.encode(encoder, video, audio, cfg.extract)
    ms_batch = _time_ms(lambda: ext.encode(encoder, video, audio, cfg.extract), 5)
    peak = torch.cuda.max_memory_allocated()
    with plain_packed_attention():
        h_plain = ext.encode(encoder, video, audio, cfg.extract)
    rel = ((h_kernel - h_plain).norm() / h_plain.norm()).item()
    app_err = np.abs(h_kernel.cpu().numpy() - emb[:batch]).max()
    print(f"slice: pooled features kernel vs plain attention: rel L2 {rel:.3e} "
          f"(tol {POOLED_REL_TOL:g}), max abs {_max_err(h_kernel, h_plain):.3e}; "
          f"vs the app's rows: max abs {app_err:.3e}")
    if rel > POOLED_REL_TOL or app_err > 1e-3:
        raise AssertionError("pooled features disagree")
    print(f"slice: encode (encoder + feature LN + pool) {ms_batch:.2f} ms per batch of "
          f"{batch} on the device (CUDA events); peak allocated "
          f"{peak / 2**30:.2f} GiB")
    _profile(lambda: ext.encode(encoder, video, audio, cfg.extract), "slice: encode",
             "extract_profile.txt")
    return launches


def _pretrain_cfg(name: str, workdir: str, **over) -> dict:
    """A pretrain YAML of the repo with synthetic clips, logging into
    ``workdir``; ``over`` updates sections."""
    import yaml

    with open(os.path.join(ROOT, "configs/pretrain", name)) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], num_workers=8)
    d["logging"].update(folder=os.path.join(workdir, name.split(".")[0]), log_freq=1)
    for section, values in over.items():
        d[section].update(values)
    return d


def _check_run(folder: str, tag: str, steps: int) -> tuple[list, list]:
    """The CSV rows and the checkpoint of a pretrain run; returns its losses
    and iteration times (ms, data wait included)."""
    import csv

    with open(os.path.join(folder, f"{tag}_r0.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if len(rows) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: CSV has {len(rows)} rows, losses {losses}")
    if not os.path.getsize(os.path.join(folder, f"{tag}-latest.pth.tar")):
        raise AssertionError(f"{tag}: no checkpoint written")
    return losses, [float(r["iter-time-ms"]) for r in rows]


def run_train(workdir: str) -> dict:
    """The training slice through the port's entry points: ViT-L/16 AV
    (av-vitl16.yaml, bf16, batch 24, remat) for 6 steps through
    train.pretrain.run, then vit_tiny (av-vitt16.yaml) for 2 steps through the
    CLI entry. Asserts the launch counts of each run, finite losses, the CSV
    rows and the .pth.tar, and that the extract app reads the ViT-L
    checkpoint's target encoder. Returns the launch counts of each run."""
    import numpy as np
    import torch
    import yaml

    from avjepa_tpu_torch.app.main import launch
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.registry import app_main
    from avjepa_tpu_torch.serve import extract as ext
    from avjepa_tpu_torch.train import pretrain

    steps = 6
    d = _pretrain_cfg("av-vitl16.yaml", workdir)
    cfg = load_config(d)
    fa.reset_launches()
    t0 = time.perf_counter()
    summary = pretrain.run(cfg, max_steps=steps, device="cuda")
    wall = time.perf_counter() - t0
    vitl = dict(fa.LAUNCHES)
    # per step: fwd_packed 24 (target) + 2 x 24 (context) + 12 (predictor),
    # plus the per-block recompute of the 60 trained layers under remat;
    # bwd_packed 2 x 24 + 12
    want = {"fwd_packed": steps * (84 + (60 if cfg.tpu.remat else 0)),
            "bwd_packed": steps * 60, "fwd": 0, "bwd": 0}
    print(f"train: ViT-L AV launches {vitl} (expected {want})")
    if vitl != want:
        raise AssertionError("ViT-L pretrain launch counts differ")
    folder, tag = cfg.logging.folder, cfg.logging.write_tag
    losses, iter_ms = _check_run(folder, tag, steps)
    later = iter_ms[1:]
    print(f"train: ViT-L AV {steps} steps, losses {losses}; iteration ms {iter_ms}; "
          f"end to end after the first step {1000 * cfg.data.batch_size * len(later) / sum(later):.2f} "
          f"clips/s; summary {summary}; {wall:.1f} s for the app (init, data and "
          f"checkpoint included)")

    # the port's extract reads that checkpoint's target encoder
    ckpt = os.path.join(folder, f"{tag}-latest.pth.tar")
    with open(os.path.join(ROOT, "configs/extract/vitl16_extract.yaml")) as f:
        xd = yaml.safe_load(f)
    xd["meta"]["read_checkpoint"] = ckpt
    xd["data"].update(source="synthetic", datasets=[], num_workers=8)
    xd["extract"].update(allow_random=False, limit=24)
    xd["logging"]["folder"] = os.path.join(workdir, "extract_ckpt")
    encoder = ext.build_encoder(load_config(xd), torch.device("cuda", 0))
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["target_encoder"]
    key = "blocks.23.attn.qkv.weight"
    if not torch.equal(encoder.state_dict()[key].cpu(), saved[key]):
        raise AssertionError("extract did not read the checkpoint's target encoder")
    del encoder, saved
    out = app_main("extract", xd, device="cuda")
    emb = np.load(os.path.join(out["output"], "features_r0.npz"))["embeddings"]
    if emb.shape != (24, 1024) or not np.all(np.isfinite(emb)):
        raise AssertionError("extract from the pretrain checkpoint wrote bad features")
    print(f"train: extract read {ckpt} (target_encoder) and wrote {emb.shape} finite features")

    # vit_tiny through the CLI: 3 heads of 64 do not pack (classic K3/K4);
    # its predictor's 3 heads of 128 do (K1/K2)
    d = _pretrain_cfg("av-vitt16.yaml", workdir, optimization={"ipe": 2, "epochs": 1})
    path = os.path.join(workdir, "vitt_pretrain.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    fa.reset_launches()
    launch(path)
    vitt = dict(fa.LAUNCHES)
    # per step: fwd 12 (target) + 2 x 12 (context) + 24 recomputed, bwd 24;
    # fwd_packed 12 (predictor) + 12 recomputed, bwd_packed 12
    want = {"fwd": 2 * 60, "bwd": 2 * 24, "fwd_packed": 2 * 24, "bwd_packed": 2 * 12}
    print(f"train: vit_tiny launches {vitt} (expected {want})")
    if vitt != want:
        raise AssertionError("vit_tiny pretrain launch counts differ")
    losses, _ = _check_run(d["logging"]["folder"], d["logging"]["write_tag"], 2)
    print(f"train: vit_tiny 2 steps through the CLI, losses {losses}")
    return {"vitl": vitl, "vitt": vitt, "ckpt": ckpt}


# one bf16 step through the kernels against the same step through the plain
# attention (same batch, masks and weights): they share every rounding point
# but sum in other orders, which moves bf16 roundings by an ulp (2^-8) here
# and there through 24 + 12 layers forward and backward
STEP_LOSS_REL_TOL = 1e-2
STEP_NORM_REL_TOL = 5e-2


def check_train_vs_plain(workdir: str, batch: int = 4) -> None:
    """Loss and encoder/predictor grad norms of one ViT-L AV step, kernel
    path against plain attention, at a batch where the plain path fits."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.optim import global_norm
    from avjepa_tpu_torch.train.step import loss_fn

    cfg = load_config(_pretrain_cfg("av-vitl16.yaml", workdir, data={"batch_size": batch}))
    h = pretrain.setup(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    inputs = h.to_device(video, audio, masks)

    def once():
        h.state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(h.state, h.step_cfg, **inputs)[0]
        loss.backward()
        norms = [global_norm([p.grad for p in m.parameters() if p.grad is not None]).item()
                 for m in (h.state.encoder, h.state.predictor)]
        return [loss.item(), *norms]

    kernel = once()
    with plain_packed_attention():
        plain = once()
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel, plain)]
    print(f"train: one ViT-L step at batch {batch}, kernel vs plain attention: "
          f"loss {kernel[0]:.6f} vs {plain[0]:.6f}, enc grad norm {kernel[1]:.4e} vs "
          f"{plain[1]:.4e}, pred grad norm {kernel[2]:.4e} vs {plain[2]:.4e}; rel "
          f"{', '.join(f'{r:.2e}' for r in rel)} (tol {STEP_LOSS_REL_TOL:g}, "
          f"{STEP_NORM_REL_TOL:g})")
    if rel[0] > STEP_LOSS_REL_TOL or max(rel[1:]) > STEP_NORM_REL_TOL:
        raise AssertionError("kernel-path step disagrees with the plain-attention step")


def time_train_step(workdir: str, remat: bool, steps: int = 5) -> dict:
    """ViT-L AV train step on a resident batch of 24, with per-block remat
    (the YAML's setting) or without: ms by CUDA events, clips/s, peak memory;
    with remat, then a torch.profiler window of 2 steps (_profile, to
    chiprun_out/train_profile.txt)."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step

    cfg = load_config(_pretrain_cfg("av-vitl16.yaml", workdir, tpu={"remat": remat}))
    h = pretrain.setup(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    inputs = h.to_device(video, audio, masks)

    def run():
        train_step(h.state, h.sched, h.step_cfg, **inputs, full_metrics=False)

    run()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(run, steps)
    peak = torch.cuda.max_memory_allocated()
    b = cfg.data.batch_size
    print(f"train: ViT-L AV step {ms:.1f} ms on a resident batch of {b} (CUDA events, "
          f"{steps} steps), {1000 * b / ms:.2f} clips/s; peak allocated "
          f"{peak / 2**30:.2f} GiB; remat {cfg.tpu.remat}")
    result = {"step_ms": ms, "clips_per_s": 1000 * b / ms, "peak_gib": peak / 2**30}
    if not remat:
        return result
    _profile(run, "train: ViT-L AV step", "train_profile.txt")
    return result


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|"""
    return _max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def check_ln_kernels() -> tuple[dict, dict]:
    """K5/K6 through FastLayerNorm (forward, then autograd's backward)
    against the plain versions, bf16 and f32, at the pretrain step's row
    counts (24 x 1664 encoder rows at width 1024; 48 x 1408 predictor rows
    at 384) and a ragged shape; K6 run twice more must give the same bits.
    Returns the bf16 max abs errors at [39936, 1024] and the phase's
    launch counts, asserted."""
    import torch

    from avjepa_tpu_torch.models.modules import FastLayerNorm
    from avjepa_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ln.reset_launches()
    want_launches = {"ln_fwd": 0, "ln_bwd": 0}
    main_err = {}
    print("LayerNorm kernels vs plain versions:")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for r, c in ((39936, 1024), (67584, 384), (1003, 192)):
            x = (2.0 * randn((r, c)) + 0.5).to(dtype).requires_grad_()
            dy = randn((r, c)).to(dtype)
            module = FastLayerNorm(c).cuda()
            with torch.no_grad():
                module.weight.copy_(1.0 + 0.3 * randn(c))
                module.bias.copy_(0.3 * randn(c))
            y = module(x)
            y.backward(dy)
            torch.cuda.synchronize()
            w, b = module.weight.detach(), module.bias.detach()
            want_y = ln.layer_norm_ref(x.detach(), w, b)
            want = ln.layer_norm_bwd_ref(x.detach(), w, dy)
            got = (x.grad, module.weight.grad, module.bias.grad)
            errs = [_rel_err(y, want_y)] + [_rel_err(g, v) for g, v in zip(got, want)]
            again = [ln.layer_norm_bwd(x.detach(), w, dy) for _ in range(2)]
            same = all(torch.equal(p, q) for p, q in zip(*again))
            same_sums = torch.equal(again[0][1], got[1]) and torch.equal(again[0][2], got[2])
            want_launches["ln_fwd"] += 1
            want_launches["ln_bwd"] += 3
            tol = LN_REL_TOL[name]
            ok = (max(errs[:2]) <= tol and max(errs[2:]) <= LN_PARAM_REL_TOL and same
                  and same_sums)
            print(f"  ln [{r}, {c}] {name}: max|err|/max|plain| y {errs[0]:.2e}, dx "
                  f"{errs[1]:.2e} (tol {tol:g}), dgamma {errs[2]:.2e}, dbeta {errs[3]:.2e} "
                  f"(tol {LN_PARAM_REL_TOL:g}); bwd bit-identical over 3 runs: "
                  f"{same and same_sums} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"LayerNorm kernels disagree at [{r}, {c}] {name}")
            if dtype == torch.bfloat16 and (r, c) == (39936, 1024):
                main_err = {"ln_fwd": _max_err(y, want_y),
                            "ln_bwd": max(_max_err(g, v) for g, v in zip(got, want))}
            del x, dy, y, want, got, again
    launches = dict(ln.LAUNCHES)
    print(f"LayerNorm launches in this phase {launches} (expected {want_launches})")
    if launches != want_launches:
        raise AssertionError("LayerNorm launch counts differ")
    return main_err, launches


def time_ln_kernels() -> dict:
    """bf16 K5/K6 at [39936, 1024] beside the plain versions, F.layer_norm
    (forward; its autograd backward) and the bound: {key: (ms, plain_ms,
    library_ms, bound_ms, bound_by)}."""
    import torch
    import torch.nn.functional as F

    from avjepa_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(4)
    r, c = 39936, 1024
    x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
    w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
    b = 0.3 * torch.randn(c, generator=gen, device="cuda")
    # F.layer_norm takes the affine in the input's type
    xr = x.clone().requires_grad_()
    wr = w.to(x.dtype).requires_grad_()
    br = b.to(x.dtype).requires_grad_()
    with torch.no_grad():
        lib_fwd = _time_ms(lambda: F.layer_norm(xr, (c,), wr, br, 1e-6), 20)
    yr = F.layer_norm(xr, (c,), wr, br, 1e-6)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(yr, (xr, wr, br), dy, retain_graph=True), 20)
    n = r * c
    times = {
        # x read, y written (bf16), gamma and beta read (f32); 7 f32 ops an element
        "ln_fwd": (_time_ms(lambda: ln.layer_norm_fwd(x, w, b), 20),
                   _time_ms(lambda: ln.layer_norm_ref(x, w, b), 3), lib_fwd,
                   *_bound(7 * n, 2 * n * 2 + 2 * c * 4, PEAK_F32_FLOPS)),
        # x and dy read, dx written (bf16), gamma read, dgamma and dbeta
        # written (f32); 16 f32 ops an element
        "ln_bwd": (_time_ms(lambda: ln.layer_norm_bwd(x, w, dy), 20),
                   _time_ms(lambda: ln.layer_norm_bwd_ref(x, w, dy), 3), lib_bwd,
                   *_bound(16 * n, 3 * n * 2 + 3 * c * 4, PEAK_F32_FLOPS)),
    }
    for key, (ms, plain, lib, bound, by) in times.items():
        print(f"time {key} bf16 [{r}, {c}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"(F.layer_norm) {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of the bound")
    return times


def _prediction_cfg(workdir: str, ckpt: str, **over) -> dict:
    """av-vitl16_prediction.yaml as it stands, with synthetic clips, 4 probe
    steps, logging into ``workdir`` and the JEPA weights of ``ckpt``."""
    import yaml

    with open(os.path.join(ROOT, "configs/pretrain/av-vitl16_prediction.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], num_workers=8)
    d["meta"]["read_checkpoint"] = ckpt
    d["optimization"].update(ipe=4, epochs=1)
    d["logging"].update(folder=os.path.join(workdir, "avpred"), log_freq=1)
    for section, values in over.items():
        d[section].update(values)
    return d


# K1 launches of one frozen pass (target encoder + predictor, dense over all
# 1664 tokens): ViT-L's 24 layers and the predictor's 12
FROZEN_PASS_LAUNCHES = 24 + 12


def run_avprediction(workdir: str, ckpt: str) -> dict:
    """The avprediction slice through the port's entry points on the
    pretrain checkpoint ``ckpt``: 4 probe steps (registry.app_main), the
    example app, and the av_prediction eval through its CLI entry, each run
    with the kernels' launch counts set to 0 just before it and asserted just
    after (K1 only: the frozen path launches no backward kernel, and no
    LayerNorm kernel). Checks the CSV, the probe checkpoint, the .npz and the
    eval summary. Returns the launch counts of each run."""
    import csv

    import numpy as np
    import torch
    import yaml

    from avjepa_tpu_torch.app.eval_main import launch as eval_launch
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.ops import layer_norm as ln
    from avjepa_tpu_torch.registry import app_main

    d = _prediction_cfg(workdir, ckpt)
    steps = d["optimization"]["ipe"]
    batch = d["data"]["batch_size"]
    launches = {}

    def counted(label, fn, want_fwd):
        fa.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        got = dict(fa.LAUNCHES)
        want = {"fwd_packed": want_fwd, "fwd": 0, "bwd_packed": 0, "bwd": 0}
        print(f"avpred: {label} launches {got} (expected {want}), LayerNorm "
              f"{dict(ln.LAUNCHES)}; {wall:.1f} s for the app (set-up and data included)")
        if got != want or any(ln.LAUNCHES.values()):
            raise AssertionError(f"{label}: launch counts differ")
        launches[label] = got
        return out

    summary = counted("avprediction", lambda: app_main("avprediction", d, device="cuda"),
                      steps * FROZEN_PASS_LAUNCHES)
    folder, tag = d["logging"]["folder"], d["logging"]["write_tag"]
    with open(os.path.join(folder, f"{tag}_probe_r0.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if (list(rows[0]) != ["epoch", "itr", "loss", "loss-video", "loss-audio"]
            or len(rows) != steps or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"avprediction CSV: {rows}")
    probe_file = os.path.join(folder, f"{tag}-probe-latest.pth.tar")
    if torch.load(probe_file, map_location="cpu", weights_only=True)["step"] != steps:
        raise AssertionError("avprediction: the probe checkpoint is not at the last step")
    print(f"avpred: {steps} probe steps, losses {losses} (video "
          f"{[round(float(r['loss-video']), 5) for r in rows]}); summary {summary}")

    out = counted("avprediction_example",
                  lambda: app_main("avprediction_example", d, device="cuda"),
                  FROZEN_PASS_LAUNCHES)
    z = np.load(out)
    shapes = {k: z[k].shape for k in z.files}
    if (shapes != {"video": (16, 224, 224, 3), "video_recon": (16, 224, 224, 3),
                   "audio": (128, 192, 1), "audio_recon": (128, 192, 1)}
            or not all(np.isfinite(z[k]).all() for k in z.files)):
        raise AssertionError(f"avprediction_example wrote {shapes}")
    print(f"avpred: example wrote {out} {shapes}")

    path = os.path.join(workdir, "av_prediction_eval.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({**d, "eval_name": "av_prediction"}, f)
    n_batches = min(50, max(256, 8 * batch) // batch)
    result = counted("av_prediction eval", lambda: eval_launch(path, device="cuda"),
                     n_batches * len(d["mask"]) * FROZEN_PASS_LAUNCHES)
    keys = {"mse_video", "psnr_video_db", "mse_video_per_mask", "num_batches", "mse_audio",
            "psnr_audio_db", "mse_audio_per_mask"}
    values = [result["mse_video"], result["mse_audio"], *result["mse_video_per_mask"],
              *result["mse_audio_per_mask"]]
    if set(result) != keys or result["num_batches"] != n_batches or not all(
            math.isfinite(v) for v in values):
        raise AssertionError(f"av_prediction eval summary: {result}")
    print(f"avpred: eval over {n_batches} batches: {result}")
    return launches


def check_probe_vs_plain(workdir: str, ckpt: str, batch: int = 4) -> None:
    """One probe step's frozen tokens and loss at batch 4, through the
    kernels against the plain attention (same weights, batch and masks)."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import avprediction as ap
    from avjepa_tpu_torch.utils.logging import get_logger

    cfg = load_config(_prediction_cfg(workdir, ckpt, data={"batch_size": batch}))
    h, state, _ = ap.setup_probe(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    ap.restore_jepa_weights(h, cfg, get_logger("avjepa_tpu_torch"))
    v, a, enc, pred = ap.batch_to_device(video, audio, masks, torch.device("cuda", 0))
    frozen = (h.state.target_encoder, h.state.predictor, v, a, enc[0], pred[0], 0)
    full_k = ap.frozen_tokens(*frozen)
    with plain_packed_attention():
        full_p = ap.frozen_tokens(*frozen)
    rel = ((full_k.float() - full_p.float()).norm() / full_p.float().norm()).item()
    with torch.no_grad():
        loss_k = [x.item() for x in ap.reconstruction_mse(state.probe, full_k, v, a)]
        loss_p = [x.item() for x in ap.reconstruction_mse(state.probe, full_p, v, a)]
    rel_loss = [abs(x - y) / abs(y) for x, y in zip(loss_k, loss_p)]
    print(f"avpred: frozen tokens at batch {batch}, kernels vs plain attention: rel L2 "
          f"{rel:.3e} (tol {POOLED_REL_TOL:g}); probe loss (video, audio) {loss_k} vs "
          f"{loss_p}, rel {', '.join(f'{r:.2e}' for r in rel_loss)} (tol {STEP_LOSS_REL_TOL:g})")
    if rel > POOLED_REL_TOL or max(rel_loss) > STEP_LOSS_REL_TOL:
        raise AssertionError("the kernel path's frozen tokens disagree with the plain path's")


def time_probe_step(workdir: str, ckpt: str, steps: int = 5) -> dict:
    """The probe step on a resident batch of 24 (CUDA events, peak memory, a
    torch.profiler window of 2 steps with the device time by kernel written
    to chiprun_out/probe_profile.txt), then K1 at the path's two shapes on
    this batch's masks (time_probe_k1)."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import avprediction as ap
    from avjepa_tpu_torch.utils.logging import get_logger

    cfg = load_config(_prediction_cfg(workdir, ckpt))
    h, state, sched = ap.setup_probe(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    ap.restore_jepa_weights(h, cfg, get_logger("avjepa_tpu_torch"))
    inputs = ap.batch_to_device(video, audio, masks, torch.device("cuda", 0))

    def run():
        ap.probe_step(state, sched, h.state.target_encoder, h.state.predictor, *inputs)

    run()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(run, steps)
    peak = torch.cuda.max_memory_allocated()
    b = cfg.data.batch_size
    print(f"avpred: probe step {ms:.1f} ms on a resident batch of {b} (CUDA events, {steps} "
          f"steps; frozen encoder + predictor + probe forward/backward + AdamW), "
          f"{1000 * b / ms:.2f} clips/s; peak allocated {peak / 2**30:.2f} GiB")
    result = {"step_ms": ms, "peak_gib": peak / 2**30}
    _profile(run, "avpred: probe step", "probe_profile.txt")

    result.update(time_probe_k1(inputs[2][0], inputs[3][0]))
    return result


def probe_masks(workdir: str):
    """The avprediction path's key masks of one batch (the context mask, and
    context | target of mask config 0), from av-vitl16_prediction.yaml's
    loader and collator, without a checkpoint: for timing K1 at the probe
    path's shapes phase by phase (``time_probe_k1(*probe_masks(dir))``)."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import avprediction as ap
    from avjepa_tpu_torch.train import pretrain

    cfg = load_config(_prediction_cfg(workdir, None))
    h = pretrain.setup(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    inputs = ap.batch_to_device(video, audio, masks, torch.device("cuda", 0))
    del h
    return inputs[2][0], inputs[3][0]


def time_probe_k1(enc_m, pred_m) -> dict:
    """K1 at the probe path's two shapes on a batch's masks: the encoder's
    (d=64, context key mask) and the predictor's (d=24, enc|pred key mask),
    dense over 1664 tokens, beside the plain version, SDPA and the bound
    (counting valid keys)."""
    import torch
    import torch.nn.functional as F

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    b = enc_m.shape[0]
    result = {}
    for label, d, mask in (("encoder d=64", 64, enc_m), ("predictor d=24", 24, enc_m | pred_m)):
        n, heads = mask.shape[1], 16
        qkv = torch.randn((b, n, 3 * heads * d), generator=gen, device="cuda").to(torch.bfloat16)
        valid = int(mask.sum().item())
        q, k, v = (t.contiguous() for t in fa._split_qkv(qkv, heads))
        with torch.no_grad():
            lib = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :]), 10)
        kernel = _time_ms(lambda: fa.flash_attention_qkv_fwd(qkv, heads, mask), 20)
        plain = _time_ms(lambda: fa.flash_attention_qkv_ref(qkv, heads, mask), 3)
        bound, by = _bound(4 * heads * d * n * valid, 4 * b * n * heads * d * 2
                           + b * heads * n * 4 + b * n * 4)
        print(f"time fwd_packed bf16, probe path {label}: B={b} N={n} H={heads}, "
              f"{valid / (b * n):.3f} of the keys valid: kernel {kernel:.3f} ms, plain "
              f"{plain:.3f} ms, library (SDPA) {lib:.3f} ms, bound {bound:.3f} ms ({by}), "
              f"{100 * bound / kernel:.1f}% of the bound")
        result[label] = (kernel, plain, lib, bound, by)
        del qkv, q, k, v
    return result


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    if importlib.util.find_spec("avjepa_tpu_torch") is None:
        fail("avjepa_tpu_torch is not importable: run from the root of a checkout")

    toolchain()
    build()
    errs = {**check_kernels(), **check_bwd_kernels()}
    ln_errs, ln_launches = check_ln_kernels()
    times = {**time_kernels(), **time_ln_kernels()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run_slice(workdir)
        train = run_train(workdir)
        check_train_vs_plain(workdir)
        time_train_step(workdir, remat=True)
        time_train_step(workdir, remat=False)
        run_avprediction(workdir, train["ckpt"])
        check_probe_vs_plain(workdir, train["ckpt"])
        time_probe_step(workdir, train["ckpt"])

    # launches: each kernel's count in this slice's run that uses it (ViT-L
    # AV pretrain for the packed kernels, vit_tiny pretrain for the classic)
    kernels = []
    for name, key, source, line in (
        ("attn_fwd_packed", "fwd_packed", FWD_SOURCE, 459),
        ("attn_bwd_packed", "bwd_packed", BWD_SOURCE, 510),
        ("attn_fwd", "fwd", FWD_SOURCE, 77),
        ("attn_bwd", "bwd", BWD_SOURCE, 196),
    ):
        ms, plain, lib, bound, by = times[key]
        run = train["vitl"] if key.endswith("packed") else train["vitt"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"avjepa_tpu/ops/flash_attention.py:{line}",
            "launches": run[key], "max_abs_err": errs[key], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
        })
    # K5/K6 are on no path (only FastLayerNorm reaches them, which no model
    # builds): their launches are those of their check phase
    for name, line in (("ln_fwd", 46), ("ln_bwd", 56)):
        ms, plain, lib, bound, by = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": LN_SOURCE,
            "replaces": f"avjepa_tpu/ops/layer_norm.py:{line}",
            "launches": ln_launches[name], "max_abs_err": ln_errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
