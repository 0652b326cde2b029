#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (avjepa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (Hopper, for
the sm_90a kernels). Phases, each printed as it runs; any failure raises and
exits non-zero:
  1. the host's media libraries (libavformat, libavcodec) and whether
     tensorstore and orbax import (in subprocesses), then the toolchain and
     card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the CUDA kernels from avjepa_tpu_torch/csrc, one nvcc per source,
     all started together;
  3. each kernel against its plain PyTorch version on the card: the forward
     kernels in bf16, f16 and f32 at the serving shapes (head_dim 24, 64 and
     80, ragged N, an empty batch row, N = 4608 at 80 with random keys and
     with vith16_384.yaml's context masks, a tensor rank's 8 heads of 24, 64
     and 80), with their registers and spills from the build log (failing if
     a head_dim 80 kernel spills); the backward kernels in bf16 and f32 (and
     f16 at head_dim 80) at the training slice's shapes and at head_dim 24,
     64, 80 and 128, N = 4608 (a sentinel tail; vith16_384's context
     masks), 8 heads, with the step's prefix masks, sentinel tails, an empty
     batch row, ragged N and saturated logits, and three runs of each giving
     the same bits; the f32 backward kernels handed the plain delta, equal
     to the plain versions to the bit; then each kernel's time (median of
     5 rounds) beside its plain version's, one PyTorch library call's
     (scaled_dot_product_attention, forward or backward), its bound and,
     for the backward kernels, the floor of their exponentials;
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
     a torch.profiler window), with remat (three rounds) and without: one
     K1 launch a layer in both, and the first step's loss and grad norms
     equal to the bit;
  8. the LayerNorm kernels K5/K6 through FastLayerNorm, forward and
     backward, against their plain versions in bf16 and f32 at [39936,
     1024], [37632, 1280], [67584, 384] and a ragged [1003, 192], in f16 at
     [4099, 1280], in bf16 at a width not a multiple of 8 and one past the
     register path; three backward runs give the same bits; their registers
     and spills; times at the three model widths (CUDA events, and the
     kernels' device time by torch.profiler) beside the plain version,
     F.layer_norm and the bound;
  9. the avprediction apps at av-vitl16_prediction.yaml (ViT-L AV, bf16,
     batch 24, synthetic clips) on the pretrain checkpoint of phase 5: 4
     probe steps through registry.app_main, avprediction_example, and the
     av_prediction eval through its CLI entry;
 10. one probe step's frozen tokens and loss at batch 4 through the kernels
     against the plain attention; the probe step timed on a resident batch
     of 24 (CUDA events, peak memory), with K1 timed at its two dense
     key-masked shapes of that path (d=64 encoder, d=24 predictor);
 11. the two frozen classification evals on the pretrain checkpoint of
     phase 5 (its target encoder merged into a video-only ViT-L, the audio
     leaves dropped), synthetic data: the video eval at
     vitl16_k400_16x8x3.yaml (bf16, batch 4, 8 segments x 3 views attended
     across, 4 probe steps), again resumed, with cached features, and with
     frame aggregation (image mode); the image eval at vitl16_in1k.yaml
     through the eval CLI; no attention or LayerNorm kernel runs (the JAX
     evals use the plain attention). Then the classifier's logits in bf16
     against f32, and the encode, probe and cached probe steps timed;
 12. data parallel: (a) the ViT-L AV pretrain (av-vitl16.yaml, 4 steps)
     through app.main, then through ``python -m
     avjepa_tpu_torch.app.main_distributed --nproc-per-node 1`` (one rank
     over NCCL) batch-launching it with the video eval on its checkpoint,
     then relaunched with ``--resume-preempt``: NCCL, K1/K2 launches,
     losses equal to app.main's, the resume, one gradient all-reduce a
     step, both entries' step ms; (b) two ranks on the one card over gloo
     (NCCL takes one rank a device) at batch 12 each against one process
     at batch 24 on the same global batch and masks: two steps' loss and
     grad norms, the ranks' weights the same to the bit, the ms a step;
 13. ViT-H: (a) vith16.yaml as it stands (ViT-H/16 video, 32 x 1280, 16 heads
     of 80; predictor 12 x 384; 1568 tokens; bf16; batch 24; remat;
     synthetic clips) in this process: the step on a resident batch (CUDA
     events, three rounds), peak memory, K1/K2 launches, a profiled step,
     and K1/K2 held against their plain versions and timed at the step's
     shapes beside SDPA and their bounds; (b)
     two gloo ranks on the one card at batch 12 each, under tpu.mesh_fsdp:
     2 (the models sharded by FSDP2) and under tpu.mesh_data: 2, both
     worlds at once, on (a)'s
     batch: losses and grad norms against each other and (a), each rank's
     slice of the weights to the bit, each rank's peak memory; (c)
     vith16_384.yaml as it stands (4608 tokens; batch 24, which must fit;
     remat; synthetic clips): the step ms over 2
     rounds, peak memory, K1/K2 launches, the profiled step's head_dim 80
     attention shares, and K1/K2 at its d = 80 shapes against their plain
     versions (2 rows) and SDPA. ``tools/torch_fsdp_cards.py`` runs
     vith16.yaml over NCCL on four cards (not part of this script's run);
 14. ViT-H under tpu.mesh_tensor: 2 (each block's heads and MLP width cut
     over two gloo ranks on the one card, which run one batch of 4): two
     steps against the unsharded step in this process on the same rows of
     (a)'s batch (losses, grad norms, each rank's pieces of checked
     weights), the packed kernels on 8 local heads, one K1 launch a layer,
     the tensor all-reduces a step, each rank's peak memory and step ms;
 15. (run after phase 7) ingest and the model modes no app reaches: (a) the
     ViT-L AV step (av-vitl16.yaml) from fresh handles for 6 steps, its
     loader at 12 workers once with threads (the app's rule for synthetic
     clips) and once with worker processes: the batches and losses of the
     two equal to the bit, K1/K2 launches, each mode's clips/s after the
     first step, the consumer's wait, the producer's fetch, collate and
     mask ms and the H2D copy; (b) the extract app's loader alone
     (vitl16_extract.yaml's view) with 12 threads and 12 processes,
     batches/s, and no worker initialising CUDA; (c) the ViT-L AV encoder
     fed 16 x 256^2 (its pos-embed resized to 2048 tokens, plus 96 audio)
     through K1 against the plain attention; (d) the predictor in image
     mode (12 x 384, 196 tokens, batch 24) forward and backward through
     K1/K2 against the plain attention;
 16. (run after phase 7) the bf16 fidelity curve, short: 30 steps of the
     ViT-L AV step at the north-star geometry (batch 16, remat) at bf16 and
     at f32 (TF32 off) from the same weights, on the same per-step data and
     masks (tools/torch_parity_bf16.py, whose --steps 200 runs the whole
     curve): both runs' losses, the deviation report, each run's step ms and
     peak memory; fails unless every loss is finite, both runs started from
     the same weights to the bit, each launched K1 84 and K2 60 times a step,
     and the max |bf16 - f32| loss is within the reference's own autocast
     drift (3.96e-3).
 17. (run last) checkpoints: the ViT-L AV pretrain state (av-vitl16.yaml)
     saved after 3 of 6 steps and restored into fresh models, through the
     JAX package's Orbax layout (the port's own writer and reader, no JAX)
     and through the port's .pth.tar: each resumed run's losses and final
     weights equal the uninterrupted run's to the bit, every restored
     tensor equals the saved one; each format's bytes on disk, save and
     restore seconds and GB/s; whether libzstd.so.1 loads, and with it a
     zstd frame the port wrote, decoded.
Every run of phases 4-5, 9, 11, 12, 13, 14, 15, 16 and 17 is driven with the kernels' launch
counts set to 0 just before it and asserted just after. The last lines are a JSON
kernel table, the card's name and power limit, and {"ok": true, "device":
{...}}. Without a GPU it exits 1 and prints no result.

Phases run alone too; the forward kernels, for instance:
    python3 -c 'import chip_smoke as c, tempfile; c.toolchain(); c.build();
        c.check_kernels(); c.time_kernels();
        c.time_probe_k1(*c.probe_masks(tempfile.mkdtemp()))'
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import logging
import math
import os
import re
import shutil
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
# bf16 ulp (2^-8 relative) and an output by an ulp: 2e-2. f16: the same with
# f16's ulp (2^-11 relative), with TOL's ratio to bf16: 1e-2. f32: sums over
# up to 1664 keys in other orders, and ds = p * (dp - delta) cancels: 1e-4.
BWD_REL_TOL = {"bfloat16": 2e-2, "float16": 1e-2, "float32": 1e-4}
# the backward wrappers' delta kernel against torch's attention_delta,
# relative to max|plain|: both sum d <= 128 exact f32 products in f32, in
# other orders
DELTA_REL_TOL = 1e-5
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
# to bf16 by an ulp (2^-8 relative, as BWD_REL_TOL) or f16 by an ulp (2^-10
# relative, two allowed) or leave f32 within a few ulp; dgamma/dbeta sum up
# to 67,584 rows in f32 in other orders
LN_REL_TOL = {"bfloat16": 2e-2, "float16": 2e-3, "float32": 1e-5}
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


def host_facts() -> None:
    """Facts later slices plan on, printed before anything else runs, failing
    on none: whether libavformat/libavcodec are on this host (the media
    decoder links them) and their major versions, and whether tensorstore
    and orbax import here (in a subprocess each, so that neither enters this
    process)."""
    import ctypes.util

    listing = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    for lib in ("avformat", "avcodec", "avutil", "swscale"):
        found = ctypes.util.find_library(lib)
        versions = sorted(set(re.findall(rf"lib{lib}\.so\.(\d+)", listing)))
        print(f"host: lib{lib}: find_library {found or 'not found'}; ldconfig majors "
              f"{versions or 'none'}")
    for mod in ("tensorstore", "orbax.checkpoint"):
        res = subprocess.run([sys.executable, "-c", f"import {mod} as m; "
                              "print(getattr(m, '__version__', 'no __version__'))"],
                             capture_output=True, text=True)
        said = (res.stdout.strip() if res.returncode == 0
                else res.stderr.strip().splitlines()[-1] if res.stderr.strip() else "failed")
        print(f"host: import {mod}: {'yes' if res.returncode == 0 else 'no'} ({said})")


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


def kernel_resources(prefix: str) -> list[tuple[str, str]]:
    """(kernel, ptxas line) for the registers, shared memory and spills of
    each kernel whose name holds ``prefix``, from the build log (nvcc -Xptxas
    -v), demangled where cu++filt is found: ``attn_fwd_wgmma_kernel<bf16,
    true, 80>`` and the like. Empty if the library was built by another run."""
    from pathlib import Path

    from avjepa_tpu_torch.ops._build import find_nvcc, load_library

    log = Path(load_library()._name).with_suffix(".log")
    if not log.exists():
        return []
    name, lines = None, []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and prefix in name and ("spill" in line or "Used" in line):
            lines.append((name, line.split(":", 1)[-1].strip()))
    demangle = Path(find_nvcc()).with_name("cu++filt")
    names = sorted({n for n, _ in lines})
    if demangle.exists() and names:
        out = subprocess.run([str(demangle), *names], capture_output=True, text=True)
        pretty = dict(zip(names, out.stdout.splitlines()))
    else:
        pretty = {}
    labelled = []
    for n, line in lines:
        label = re.sub(r"\(bool\)1", "true", pretty.get(n, n))
        label = re.sub(r"\(bool\)0|\(int\)|^void |<unnamed>::|\(anonymous namespace\)::", "",
                       label.replace("(bool)0", "false"))
        labelled.append((label.split("(")[0], line))
    return labelled


def print_resources(prefix: str = "attn_fwd") -> None:
    """Registers, shared memory and spills of each kernel whose name holds
    ``prefix`` (the forward attention kernels by default), from the build
    log; raises if a head_dim 80 or 64 instance (``<..., 80>``, ``<...,
    64>``) spills: those are the ViT-H and ViT-L encoders' paths (K1's
    warp-specialised ``<T, 64>`` and ``<T, 80>``), designed without
    spills."""
    lines = kernel_resources(prefix)
    if not lines:
        print("  build log not found (library built by another run)")
    for label, line in lines:
        print(f"  ptxas {label}: {line}")
    spills = [(label, line) for label, line in lines
              if label.endswith((", 80>", ", 64>"))
              and re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        raise AssertionError(f"head_dim 80 kernels spill: {spills}")


def check_kernels() -> dict:
    """Each kernel vs its plain version; returns the bf16 max abs error at
    the serving path's shape for each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    print("forward kernels' resources (ptxas):")
    print_resources()
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
    vith384 = vith384_context_masks(2)
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
            (2, 4608, 16, 80, True),    # vith16_384: 8 x 24 x 24 video tokens
            # vith16_384's context over all 4608 tokens, keys masked by its
            # two mask configs' context masks
            (2, 4608, 16, 80, "vith16_384"),
            # a tensor rank's 8 of 16 heads (mesh_tensor: 2): the predictor,
            # ViT-L and ViT-H
            (8, 1408, 8, 24, True),
            (8, 1664, 8, 64, True),
            (8, 1568, 8, 80, True),
        ):
            qkv = randn((b, n, 3 * h * d), dtype)
            mask = None
            if masked == "vith16_384":
                mask = vith384
            elif masked:
                mask = torch.rand((b, n), generator=gen, device="cuda") < 0.7
                mask[0] = False
            got = fa.flash_attention_qkv_fwd(qkv, h, mask)
            torch.cuda.synchronize()
            err = compare(f"attn_fwd_packed B={b} N={n} H={h} d={d} masked={masked}",
                          dtype, got, fa.flash_attention_qkv_ref(qkv, h, mask))
            if masked is True and got[0][0].abs().max().item() != 0.0:
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
    """None; a sentinel tail (the compacted context: the first 7/8 of the
    keys valid); a prefix (the pretrain step's compacted masks: gather_idx
    sorts each row's kept tokens first, so each row's valid keys are a
    prefix, here of a random length in [n/2, n)); or random keys (p = 0.8)
    with a sentinel tail and batch row 0 fully masked (the uncompacted
    union, and an empty row)."""
    import torch

    if kind is None:
        return None
    if kind == "prefix":
        lengths = torch.randint(n // 2, n, (b, 1), generator=gen, device="cuda")
        return torch.arange(n, device="cuda")[None, :] < lengths
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    mask[:, n - n // 8:] = False
    if kind == "random":
        mask &= torch.rand((b, n), generator=gen, device="cuda") < 0.8
        mask[0] = False
    return mask


def vith384_context_masks(batch: int):
    """[batch, 4608] bool key masks on the card: vith16_384.yaml's context
    over all its tokens (the tokens each mask config keeps, uncompacted),
    rows alternating between its two mask configs, drawn by its collator
    with its seed."""
    import numpy as np
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator

    cfg = load_config(_pretrain_cfg("vith16_384.yaml", tempfile.gettempdir()))
    collator = make_mask_collator(cfg.data.mask_type or cfg.tpu.mask_type, cfg.mask,
                                  cfg.layout(), base_seed=cfg.meta.seed)
    sets = collator(batch)
    enc = np.stack([sets[i % len(sets)].enc[i] for i in range(batch)])
    return torch.from_numpy(enc).cuda()


def check_bwd_kernels() -> dict:
    """Each backward kernel against its plain version, bf16 and f32 (and
    f16 at head_dim 80): at the training slice's shapes, at head_dim 24, 64,
    80 (vit_huge) and 128, at vith16_384's 4608 tokens (with a sentinel tail,
    and with its context's key masks), with the step's prefix masks,
    sentinel tails, random keys with an empty batch row, ragged N and
    saturated logits; and three runs of each on the same inputs give the
    same bits. Returns the bf16 max abs error at the main shape of each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.ops._build import load_library

    print("backward kernels' resources (ptxas):")
    print_resources("attn_bwd")
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

    def check_delta(name, dtype, out, dout, h):
        got = fa._delta_kernel(load_library(), out, dout, h)
        want = fa.attention_delta(out, dout, h)
        err = _rel_err(got, want)
        print(f"  {name} {str(dtype).split('.')[-1]}: max|err|/max|plain| {err:.2e} "
              f"(tol {DELTA_REL_TOL:g}) {'ok' if err <= DELTA_REL_TOL else 'FAIL'}")
        if err > DELTA_REL_TOL:
            raise AssertionError(f"{name} disagrees with attention_delta")

    def same_bits(name, run, first):
        again = [run() for _ in range(2)]
        torch.cuda.synchronize()
        first = first if isinstance(first, (tuple, list)) else (first,)
        for other in again:
            other = other if isinstance(other, (tuple, list)) else (other,)
            if not all(torch.equal(a, b) for a, b in zip(first, other)):
                raise AssertionError(f"{name}: three runs on the same inputs differ")
        print(f"  {name}: bit-identical over 3 runs ok")

    main_err = {}
    vith384 = vith384_context_masks(2)
    print("backward kernels vs plain versions:")
    # f16 at head_dim 80 only (ViT-H's kernels): bf16 and f32 cover the rest
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        # K2, packed qkv: (label, B, N, H, d, mask)
        for label, b, n, h, d, kind in (
            ("context", 24, 512, 16, 64, "tail"),
            ("predictor", 48, 1408, 16, 24, "random"),
            ("predictor prefix", 48, 1408, 16, 24, "prefix"),
            ("context prefix", 48, 512, 16, 64, "prefix"),
            ("vit_tiny predictor", 48, 1408, 3, 128, "random"),
            ("vit_huge context", 4, 1664, 16, 80, "random"),
            ("vith16_384", 2, 4608, 16, 80, "tail"),
            ("vith16_384 context", 2, 4608, 16, 80, "vith16_384"),
            ("ragged", 2, 200, 16, 64, None),
            # a tensor rank's 8 of 16 heads (mesh_tensor: 2)
            ("tensor predictor", 8, 1408, 8, 24, "prefix"),
            ("tensor vit_large context", 8, 512, 8, 64, "random"),
            ("tensor vit_huge context", 8, 512, 8, 80, "prefix"),
        ):
            if dtype == torch.float16 and d != 80:
                continue
            qkv = randn((b, n, 3 * h * d), dtype)
            dout = randn((b, n, h * d), dtype)
            mask = vith384 if kind == "vith16_384" else _key_mask(gen, b, n, kind)
            out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)

            def run():
                return fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask)

            got = run()
            torch.cuda.synchronize()
            want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h, mask)
            check_delta(f"attn_delta {label}", dtype, out, dout, h)
            c = h * d
            err = compare(f"attn_bwd_packed {label} B={b} N={n} H={h} d={d} mask={kind}", dtype,
                          [got[..., i * c:(i + 1) * c] for i in range(3)],
                          [want[..., i * c:(i + 1) * c] for i in range(3)])
            del want
            if kind == "random" and got[0].abs().max().item() != 0.0:
                raise AssertionError("attn_bwd_packed: a fully-masked batch row has a gradient")
            if kind is not None:
                valid = mask[:, :, None].expand(b, n, c)
                if not bool((got[..., c:][~valid.repeat(1, 1, 2)] == 0).all()):
                    raise AssertionError("attn_bwd_packed: masked keys have a dk or dv")
            if dtype == torch.bfloat16 and label in ("predictor", "predictor prefix"):
                same_bits(f"attn_bwd_packed {label}", run, got)
            if dtype == torch.bfloat16 and label == "predictor":
                main_err["bwd_packed"] = err
            del qkv, dout, out, lse, got
        # K2 with saturated logits: query rows 0-7 see every logit above the
        # clamp, so their ds, and so their dq, is exactly 0 (bf16, f32)
        if dtype != torch.float16:
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
        # K4, classic [B, H, N, d]: one fully-masked 128-key block (the
        # training slice's shapes), a sentinel tail, and random keys with an
        # empty batch row at head_dim 24, 80 and 128
        for b, n, d, kind in ((24, 1664, 64, "block"), (24, 512, 64, "block"),
                              (24, 512, 64, "tail"), (4, 1408, 24, "random"),
                              (4, 1664, 80, "random"), (4, 512, 128, "random")):
            if dtype == torch.float16 and d != 80:
                continue
            h = 3
            q, k, v, dout = (randn((b, h, n, d), dtype) for _ in range(4))
            if kind == "block":
                mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
                mask[:, 128:256] = False
            else:
                mask = _key_mask(gen, b, n, kind)
            out, lse = fa.flash_attention_fwd(q, k, v, mask)

            def run():
                return fa.flash_attention_bwd(q, k, v, out, lse, dout, mask)

            got = run()
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask)
            check_delta(f"attn_delta B={b} H={h} N={n} d={d}", dtype, out, dout, h)
            err = compare(f"attn_bwd B={b} H={h} N={n} d={d} mask={kind}", dtype, got, want)
            if not bool((got[1].transpose(1, 2)[~mask] == 0).all()):
                raise AssertionError("attn_bwd: masked keys have a dk")
            if kind == "random" and any(x[0].abs().max().item() != 0.0 for x in got):
                raise AssertionError("attn_bwd: a fully-masked batch row has a gradient")
            if dtype == torch.bfloat16 and (n, kind) == (512, "tail"):
                same_bits("attn_bwd", run, got)
            if dtype == torch.bfloat16 and (n, kind) == (512, "block"):
                main_err["bwd"] = err
            del q, k, v, dout, out, lse, got, want
    return main_err


def check_bwd_plain_delta() -> dict:
    """K2 and K4 in f32 handed the plain ``attention_delta`` in place of
    ``avj_attn_delta``'s: dq, dk and dv then equal the plain versions to the
    bit (raises otherwise). The f32 kernels sum each product with one fma
    after another in key or query order, as cuBLAS's f32 GEMMs do at these
    shapes, so only delta's sum order (a fused kernel against torch's
    reduction) separates them; dv, the one output without delta, reads 0 in
    check_bwd_kernels. Returns each shape's max abs errors."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    print("backward kernels in f32 with the plain delta, against their plain versions:")
    for b, n, h, d, kind in ((24, 512, 16, 64, "tail"), (48, 1408, 16, 24, "random"),
                             (4, 1664, 16, 80, "random"), (2, 200, 16, 64, None)):
        c = h * d
        qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda")
        dout = torch.randn((b, n, c), generator=gen, device="cuda")
        mask = _key_mask(gen, b, n, kind)
        out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)
        delta = fa.attention_delta(out, dout, h)
        got = fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask, delta=delta)
        want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h, mask)
        errs[f"attn_bwd_packed B={b} N={n} H={h} d={d}"] = [
            _max_err(got[..., i * c:(i + 1) * c], want[..., i * c:(i + 1) * c]) for i in range(3)]
    for b, n, d, kind in ((24, 512, 64, "tail"), (4, 1408, 24, "random")):
        q, k, v, dout = (torch.randn((b, 3, n, d), generator=gen, device="cuda") for _ in range(4))
        mask = _key_mask(gen, b, n, kind)
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        delta = fa.attention_delta(out, dout, 3)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, mask, delta=delta)
        want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask)
        errs[f"attn_bwd B={b} H=3 N={n} d={d}"] = [_max_err(g, w) for g, w in zip(got, want)]
    for name, e in errs.items():
        print(f"  {name} float32: dq, dk, dv max|err| "
              f"{', '.join(f'{x:.2e}' for x in e)} {'ok' if max(e) == 0.0 else 'FAIL'}")
    if any(max(e) != 0.0 for e in errs.values()):
        raise AssertionError("an f32 backward kernel given the plain delta differs from its "
                             "plain version")
    return errs


def _tool(name: str):
    """The module ``tools/<name>.py`` of this checkout."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


TIME_ROUNDS = 5


def _time_rounds(fn, iters: int, rounds: int = TIME_ROUNDS) -> tuple[float, float, float]:
    """(min, median, max) ms per call over ``rounds`` rounds of _time_ms."""
    import statistics

    ms = [_time_ms(fn, iters) for _ in range(rounds)]
    return min(ms), statistics.median(ms), max(ms)


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for work whose operations
    run at ``peak`` (bf16 tensor cores by default)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# exponentials a clock on one SM: 16 MUFU lanes (4 per SM sub-partition)
MUFU_PER_CLOCK = 16


def _exp_floor_ms(n_exp: float) -> float:
    """Least ms for ``n_exp`` exponentials on this card's MUFU units at its
    maximum SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * MUFU_PER_CLOCK * mhz * 1e6) * 1e3


def _sdpa_inputs(q, k, v, mask):
    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    m4 = None if mask is None else mask[:, None, None, :]
    return q, k, v, m4


def _sdpa_fwd_ms(q, k, v, mask):
    import torch
    import torch.nn.functional as F

    q, k, v, m4 = _sdpa_inputs(q, k, v, mask)
    with torch.no_grad():
        return _time_rounds(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m4), 10)


def _sdpa_bwd_ms(q, k, v, mask):
    import torch
    import torch.nn.functional as F

    q, k, v, m4 = _sdpa_inputs(q, k, v, mask)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=m4)
    g = torch.randn_like(o)
    return _time_rounds(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True), 10)


def _hold_packed(label: str, forward: bool, got, want) -> float:
    """K1's (out, lse) or K2's dqkv against its plain version's on the same
    inputs, at the check phases' bf16 tolerances (TOL, BWD_REL_TOL); raises
    on a mismatch. Returns the max abs error (out's, or dqkv's)."""
    if forward:
        tol_out, tol_lse = TOL["bfloat16"]
        err, lse_err = _max_err(got[0], want[0]), _max_err(got[1], want[1])
        ok = err <= tol_out and lse_err <= tol_lse
        note = (f"max|out err| {err:.3e} (tol {tol_out:g}), max|lse err| {lse_err:.3e} "
                f"(tol {tol_lse:g})")
    else:
        tol = BWD_REL_TOL["bfloat16"]
        err = _max_err(got, want)
        rel = err / max(want.float().abs().max().item(), 1e-30)
        ok = rel <= tol
        note = f"max|err|/max|plain| {rel:.2e} (tol {tol:g})"
    print(f"  {label} bf16 against its plain version: {note} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def _time_packed(forward: bool, b: int, n: int, h: int, d: int, mask, gen,
                 label: str, plain_batch: int | None = None) -> tuple:
    """K1 (``forward``) or K2 in bf16 on random qkv [b, n, 3 h d] with key
    mask ``mask`` ([b, n] bool or None), held against its plain version on
    these inputs first (``_hold_packed``, which raises): ((ms, plain_ms,
    library_ms, bound_ms, bound_by), (kernel's, SDPA's (min, median, max)
    rounds), exponential floor ms or None). With ``plain_batch`` the plain
    version runs on (and is held and timed on) the first ``plain_batch``
    rows only, where b rows would not fit its score tensors. Work counts only
    valid keys (masked key tiles are skipped); the backward's exponential
    floor counts two passes, one exponential per valid score each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    pb = plain_batch or b
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
    valid = b * n if mask is None else int(mask.sum().item())
    mask_pb = None if mask is None else mask[:pb]
    out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)
    q, k, v = fa._split_qkv(qkv, h)
    if forward:
        run = (lambda: fa.flash_attention_qkv_fwd(qkv, h, mask),
               lambda: fa.flash_attention_qkv_ref(qkv[:pb], h, mask_pb))
        lib = _sdpa_fwd_ms(q, k, v, mask)
        # qkv read, out written; lse f32
        bound = _bound(4 * h * d * n * valid, 4 * b * n * h * d * 2 + b * h * n * 4)
        floor = None
    else:
        dout = torch.randn((b, n, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        run = (lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask),
               lambda: fa.flash_attention_qkv_bwd_ref(qkv[:pb], out[:pb], lse[:pb], dout[:pb],
                                                     h, mask_pb))
        lib = _sdpa_bwd_ms(q, k, v, mask)
        # reads qkv, out, dO, lse, bias; writes dqkv
        bound = _bound(10 * h * d * n * valid, (8 * b * n * h * d) * 2 + b * h * n * 4 + b * n * 4)
        floor = _exp_floor_ms(2 * h * n * valid)
    got = run[0]()
    got = (got[0][:pb], got[1][:pb]) if forward else got[:pb]
    _hold_packed(label, forward, got, run[1]())
    del got
    rounds = (_time_rounds(run[0], 20), lib)
    return (rounds[0][1], _time_ms(run[1], 3), lib[1], *bound), rounds, floor


def _print_time(key: str, times: tuple, rounds: tuple, floor) -> None:
    ms, plain, lib, bound, by = times
    (k_min, _, k_max), (l_min, _, l_max) = rounds
    floor = f", exponential floor {floor:.3f} ms" if floor is not None else ""
    print(f"time {key} bf16: kernel {ms:.3f} ms (median of {TIME_ROUNDS} rounds; "
          f"{k_min:.3f}-{k_max:.3f}), plain {plain:.3f} ms, library (SDPA) {lib:.3f} ms "
          f"({l_min:.3f}-{l_max:.3f}), bound {bound:.3f} ms ({by}){floor}, "
          f"{100 * bound / ms:.1f}% of the bound, kernel/SDPA {ms / lib:.2f}")


def time_kernels() -> dict:
    """bf16 kernel, plain and library (SDPA) times at each kernel's main
    shape, with its bound: {key: (ms, plain_ms, library_ms, bound_ms,
    bound_by)}, kernel and library the medians of TIME_ROUNDS rounds (each
    round's min/median/max printed). Work counts only valid keys (masked key
    tiles are skipped). K2 at the predictor's shape with random keys (the
    uncompacted union) and with the step's prefix masks, and at the context
    encoder's d=64 shape; beside the backward kernels' bounds, the floor of
    their exponentials (two passes, one per valid score each)."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    times, rounds, floors = {}, {}, {}
    # K1: the target encoder's unmasked layer; K2: a predictor layer (random
    # keys, and the step's prefix masks) and a context layer
    for key, b, n, h, d, kind in (("fwd_packed", 24, 1664, 16, 64, None),
                                  ("bwd_packed", 48, 1408, 16, 24, "random"),
                                  ("bwd_packed prefix", 48, 1408, 16, 24, "prefix"),
                                  ("bwd_packed context", 24, 512, 16, 64, "tail")):
        times[key], rounds[key], floors[key] = _time_packed(
            key == "fwd_packed", b, n, h, d, _key_mask(gen, b, n, kind), gen,
            f"time {key} B={b} N={n} H={h} d={d}")
    # K3: the vit_tiny target encoder; K4: a vit_tiny context layer
    for key, b, h, n, d in (("fwd", 24, 3, 1664, 64), ("bwd", 24, 3, 512, 64)):
        q, k, v, dout = (randn((b, h, n, d)) for _ in range(4))
        mask = None if key == "fwd" else _key_mask(gen, b, n, "tail")
        valid = b * n if mask is None else int(mask.sum().item())
        out, lse = fa.flash_attention_fwd(q, k, v, mask)
        floors[key] = None
        if key == "fwd":
            run = (lambda: fa.flash_attention_fwd(q, k, v, mask),
                   lambda: fa.flash_attention_ref(q, k, v, mask))
            lib = _sdpa_fwd_ms(q, k, v, mask)
            bound = _bound(4 * h * d * n * valid, 4 * b * h * n * d * 2 + b * h * n * 4)
        else:
            run = (lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, mask),
                   lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask))
            lib = _sdpa_bwd_ms(q, k, v, mask)
            bound = _bound(10 * h * d * n * valid, 8 * b * h * n * d * 2 + b * h * n * 4)
            floors[key] = _exp_floor_ms(2 * h * n * valid)
        rounds[key] = (_time_rounds(run[0], 20), lib)
        times[key] = (rounds[key][0][1], _time_ms(run[1], 3), lib[1], *bound)
    for key in times:
        _print_time(key, times[key], rounds[key], floors[key])
    return times


@contextlib.contextmanager
def plain_packed_attention():
    """Route the models' packed attention through the plain versions: the
    differentiable one (autograd over K1's plain version) and, in a remat'd
    block, K1's and K2's plain versions."""
    from avjepa_tpu_torch.models import modules
    from avjepa_tpu_torch.ops import flash_attention as fa

    kernels = {name: getattr(modules, name) for name in (
        "flash_attention_qkv", "flash_attention_qkv_fwd", "flash_attention_qkv_bwd")}
    modules.flash_attention_qkv = (
        lambda qkv, h, key_mask=None, scale=None: fa.flash_attention_qkv_ref(qkv, h, key_mask,
                                                                              scale)[0])
    modules.flash_attention_qkv_fwd = fa.flash_attention_qkv_ref
    modules.flash_attention_qkv_bwd = fa.flash_attention_qkv_bwd_ref
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(modules, name, fn)


# torch.profiler (CUPTI) on the H100 host can return a profile that holds no
# device time: such a profile is taken again, this many times in all (each
# retry printed), and a share of a device time that stays 0 prints "not
# measured"
PROFILE_TRIES = 3


def _cuda_events(fn, calls: int, want: str = ""):
    """torch.profiler over ``calls`` calls of ``fn``: (the profiler, its
    key_averages() CUDA events). Profiled again, up to PROFILE_TRIES times,
    while the kernels whose names hold ``want`` (all of them by default)
    record no device time; each retry is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if sum(e.self_device_time_total for e in events if want in e.key) > 0:
            break
        print(f"profile: attempt {attempt} of {PROFILE_TRIES} recorded no device time for "
              f"{want or 'any kernel'} ({len(events)} CUDA events)"
              + ("; taking it again" if attempt < PROFILE_TRIES else "; giving up"))
    return prof, events


def _share(part: float, whole: float) -> str:
    return f"{100 * part / whole:.1f}%" if whole > 0 else "not measured"


def _kernel_ms(events, name: str, steps: int) -> list[tuple[str, float, int]]:
    """(instance, device ms a call, launches a call) of each kernel whose
    name holds ``name``, by template instance (``attn_fwd_wgmma_kernel<
    __nv_bfloat16, true, 80>``), largest first."""
    out = [(e.key[e.key.index(name):].split("(")[0], e.self_device_time_total / (1e3 * steps),
            e.count // steps) for e in events if name in e.key]
    return sorted(out, key=lambda x: -x[1])


def _profile(run, label: str, filename: str, steps: int = 2) -> dict:
    """torch.profiler over ``steps`` calls of ``run``: the device time by
    kernel written to chiprun_out/<filename>; prints the device kernel ms per
    call, the top kernels, and the forward and backward attention kernels by
    instance with their launches a call. Returns {"total": device kernel ms
    a call, "fwd"/"bwd": [(instance, ms, launches), ...]}."""
    prof, events = _cuda_events(run, steps)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    total = sum(e.self_device_time_total for e in events) / (1e3 * steps)
    kernels = {"fwd": _kernel_ms(events, "attn_fwd", steps),
               "bwd": _kernel_ms(events, "attn_bwd", steps)}
    fwd = sum(ms for _, ms, _ in kernels["fwd"])
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"{label}: profile, {total:.1f} ms of device kernels per call; forward attention "
          f"kernel {fwd:.1f} ms ({_share(fwd, total)}); top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / (1e3 * steps):.2f} ms" for e in top))
    for key, what in (("fwd", "forward"), ("bwd", "backward")):
        if kernels[key]:
            ms = sum(x for _, x, _ in kernels[key])
            print(f"{label}: {what} attention kernels {ms:.1f} ms ({_share(ms, total)}): "
                  + "; ".join(f"{name} {x:.2f} ms ({n} a call)" for name, x, n in kernels[key]))
    return {"total": total, **kernels}


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


# K1 launches a step: every attention layer once (the target encoder's, the
# two context passes', the predictor's), remat or not
VITL_K1_A_STEP = 24 + 2 * 24 + 12
VITH_K1_A_STEP = 32 + 2 * 32 + 12


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
    # remat or not (the remat policy keeps the attention's out and lse);
    # bwd_packed 2 x 24 + 12
    want = {"fwd_packed": steps * VITL_K1_A_STEP, "bwd_packed": steps * 60, "fwd": 0, "bwd": 0}
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
    # per step: fwd 12 (target) + 2 x 12 (context), bwd 24; fwd_packed 12
    # (predictor), bwd_packed 12; remat recomputes no attention
    want = {"fwd": 2 * 36, "bwd": 2 * 24, "fwd_packed": 2 * 12, "bwd_packed": 2 * 12}
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


def time_train_step(workdir: str, remat: bool, steps: int = 5, rounds: int = 1) -> dict:
    """ViT-L AV train step on a resident batch of 24, with the remat policy
    (the YAML's setting) or without: the first step's loss and grad norms
    and its K1 launches (asserted: one a layer either way), then ms by CUDA
    events over ``rounds`` rounds of ``steps`` steps (each round printed;
    the median kept), clips/s, peak memory; with remat, then a
    torch.profiler window of 2 steps (_profile, to
    chiprun_out/train_profile.txt)."""
    import statistics

    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
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
        return train_step(h.state, h.sched, h.step_cfg, **inputs, full_metrics=False)

    fa.reset_launches()
    m = run()
    first = {k: m[k] for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
    k1 = fa.LAUNCHES["fwd_packed"]
    if k1 != VITL_K1_A_STEP:
        raise AssertionError(f"ViT-L step (remat {remat}): K1 launched {k1} times, not "
                             f"{VITL_K1_A_STEP}")
    torch.cuda.reset_peak_memory_stats()
    all_ms = [_time_ms(run, steps) for _ in range(rounds)]
    ms = statistics.median(all_ms)
    peak = torch.cuda.max_memory_allocated()
    b = cfg.data.batch_size
    print(f"train: ViT-L AV step {ms:.1f} ms on a resident batch of {b} (CUDA events, "
          f"{steps} steps a round; rounds {', '.join(f'{x:.1f}' for x in all_ms)}), "
          f"{1000 * b / ms:.2f} clips/s; peak allocated {peak / 2**30:.2f} GiB; "
          f"remat {cfg.tpu.remat}; first step {first}, K1 launches {k1} a step")
    result = {"step_ms": ms, "clips_per_s": 1000 * b / ms, "peak_gib": peak / 2**30,
              "first": first}
    if not remat:
        return result
    _profile(run, "train: ViT-L AV step", "train_profile.txt")
    return result


def check_remat_bits(remat: dict, plain: dict) -> None:
    """The remat'd ViT-L step's first loss and grad norms against the step
    without remat on the same batch and weights: equal to the bit (the
    kernels and cuBLAS are deterministic at fixed shapes, and the recompute
    runs the same ops on the same inputs)."""
    same = {k: remat["first"][k] == plain["first"][k] for k in remat["first"]}
    print(f"train: remat vs no remat, first step: {remat['first']} vs {plain['first']}: "
          f"equal to the bit {same}; peak {remat['peak_gib']:.2f} vs {plain['peak_gib']:.2f} "
          f"GiB; {card_line()}")
    if not all(same.values()):
        raise AssertionError("the remat'd step differs from the step without remat")


def _rel_err(got, want) -> float:
    """max |got - want| / max |want|"""
    return _max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


# K6's check shapes: the pretrain step's row counts at each model width (24 x
# 1664 ViT-L encoder rows at 1024, 24 x 1568 ViT-H rows at 1280, 48 x 1408
# predictor rows at 384) and a ragged [1003, 192], in bf16 and f32; ViT-H's
# width in f16 with a ragged last tile; a width that is not a multiple of 8
# (scalar loads) and one past the register path (the streaming variant)
LN_CHECKS = tuple(
    (r, c, dtype) for dtype in ("bfloat16", "float32")
    for r, c in ((39936, 1024), (37632, 1280), (67584, 384), (1003, 192))
) + ((4099, 1280, "float16"), (517, 1001, "bfloat16"), (300, 2000, "bfloat16"))
# K5/K6 timing shapes (bf16): the three widths above at the step's row counts
LN_TIMED = ((39936, 1024), (37632, 1280), (67584, 384))


def check_ln_kernels() -> tuple[dict, dict]:
    """K5/K6 through FastLayerNorm (forward, then autograd's backward)
    against the plain versions at LN_CHECKS; K6 run twice more must give the
    same bits. Returns the bf16 max abs errors at [39936, 1024] and the
    phase's launch counts, asserted."""
    import torch

    from avjepa_tpu_torch.models.modules import FastLayerNorm
    from avjepa_tpu_torch.ops import layer_norm as ln

    print("LayerNorm kernels' resources (ptxas):")
    print_resources("ln_")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ln.reset_launches()
    want_launches = {"ln_fwd": 0, "ln_bwd": 0}
    main_err = {}
    print("LayerNorm kernels vs plain versions:")
    for r, c, name in LN_CHECKS:
        dtype = getattr(torch, name)
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
        same = same and all(torch.equal(p, q) for p, q in zip(again[0], got))
        want_launches["ln_fwd"] += 1
        want_launches["ln_bwd"] += 3
        tol = LN_REL_TOL[name]
        ok = max(errs[:2]) <= tol and max(errs[2:]) <= LN_PARAM_REL_TOL and same
        print(f"  ln [{r}, {c}] {name}: max|err|/max|plain| y {errs[0]:.2e}, dx "
              f"{errs[1]:.2e} (tol {tol:g}), dgamma {errs[2]:.2e}, dbeta {errs[3]:.2e} "
              f"(tol {LN_PARAM_REL_TOL:g}); bwd bit-identical over 3 runs: "
              f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"LayerNorm kernels disagree at [{r}, {c}] {name}")
        if name == "bfloat16" and (r, c) == (39936, 1024):
            main_err = {"ln_fwd": _max_err(y, want_y),
                        "ln_bwd": max(_max_err(g, v) for g, v in zip(got, want))}
        del x, dy, y, want, got, again
    launches = dict(ln.LAUNCHES)
    print(f"LayerNorm launches in this phase {launches} (expected {want_launches})")
    if launches != want_launches:
        raise AssertionError("LayerNorm launch counts differ")
    return main_err, launches


def _device_ms(fn, calls: int = 20, want: str = "") -> dict:
    """Device time of each CUDA kernel per call of ``fn`` by torch.profiler
    (after one warm call): {kernel name: ms per call}. See _cuda_events for
    ``want``."""
    import torch

    fn()
    torch.cuda.synchronize()
    _, events = _cuda_events(fn, calls, want)
    return {e.key: e.self_device_time_total / (1e3 * calls) for e in events}


def time_ln_kernels() -> dict:
    """bf16 K5/K6 at LN_TIMED: each wrapper's ms (CUDA events, median of
    TIME_ROUNDS rounds) beside its kernels' device ms (torch.profiler), the
    plain version, F.layer_norm (forward; its autograd backward, by events
    and by device time) and the bound. Returns {key: (ms, plain_ms,
    library_ms, bound_ms, bound_by)}, keyed "ln_fwd"/"ln_bwd" at [39936,
    1024] and "ln_fwd RxC"/"ln_bwd RxC" at the others."""
    import torch
    import torch.nn.functional as F

    from avjepa_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(4)
    times = {}
    for r, c in LN_TIMED:
        x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        b = 0.3 * torch.randn(c, generator=gen, device="cuda")
        # F.layer_norm takes the affine in the input's type
        xr = x.clone().requires_grad_()
        wr = w.to(x.dtype).requires_grad_()
        br = b.to(x.dtype).requires_grad_()
        yr = F.layer_norm(xr, (c,), wr, br, 1e-6)

        def lib_fwd():
            with torch.no_grad():
                F.layer_norm(xr, (c,), wr, br, 1e-6)

        def lib_bwd():
            torch.autograd.grad(yr, (xr, wr, br), dy, retain_graph=True)

        n = r * c
        runs = {
            # x read, y written (bf16), gamma and beta read (f32); 7 f32 ops an element
            "ln_fwd": (lambda: ln.layer_norm_fwd(x, w, b), lambda: ln.layer_norm_ref(x, w, b),
                       lib_fwd, _bound(7 * n, 2 * n * 2 + 2 * c * 4, PEAK_F32_FLOPS)),
            # x and dy read, dx written (bf16), gamma read, dgamma and dbeta
            # written (f32); 16 f32 ops an element
            "ln_bwd": (lambda: ln.layer_norm_bwd(x, w, dy),
                       lambda: ln.layer_norm_bwd_ref(x, w, dy), lib_bwd,
                       _bound(16 * n, 3 * n * 2 + 3 * c * 4, PEAK_F32_FLOPS)),
        }
        for name, (kernel, plain, lib, (bound, by)) in runs.items():
            k_min, k_ms, k_max = _time_rounds(kernel, 20)
            l_min, l_ms, l_max = _time_rounds(lib, 20)
            plain_ms = _time_ms(plain, 3)
            dev = _device_ms(kernel, want=name)
            k_dev = sum(ms for key, ms in dev.items() if name in key)
            l_dev = sum(_device_ms(lib).values())
            ratio = f"{k_dev / l_dev:.2f}" if k_dev > 0 and l_dev > 0 else "not measured"
            split = "; ".join(f"{key.split('(')[0][:48]} {ms:.4f}" for key, ms in dev.items())
            print(f"time {name} bf16 [{r}, {c}]: kernel {k_ms:.4f} ms (median of {TIME_ROUNDS} "
                  f"rounds; {k_min:.4f}-{k_max:.4f}), device {k_dev:.4f} ms ({split}); plain "
                  f"{plain_ms:.4f} ms; library (F.layer_norm) {l_ms:.4f} ms ({l_min:.4f}-"
                  f"{l_max:.4f}), device {l_dev:.4f} ms; bound {bound:.4f} ms ({by}): "
                  f"{_share(bound, k_ms)} of the bound by events, {_share(bound, k_dev)} "
                  f"by device time; kernel/library device {ratio}")
            key = name if (r, c) == LN_TIMED[0] else f"{name} {r}x{c}"
            times[key] = (k_ms, plain_ms, l_ms, bound, by)
        del x, dy, xr, wr, br, yr
    print(card_line())
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


def _eval_cfg(name: str, workdir: str, ckpt: str, tag: str, **opt) -> dict:
    """configs/evals/<name> with synthetic data, the pretrain checkpoint
    ``ckpt``, logging into ``workdir``/evals/``tag``; ``opt`` updates its
    optimization section."""
    import yaml

    with open(os.path.join(ROOT, "configs/evals", name)) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", num_workers=8)
    d["optimization"].update(opt)
    d["pretrain"].update(folder=os.path.dirname(ckpt), checkpoint=os.path.basename(ckpt))
    d.update(folder=os.path.join(workdir, "evals", tag), tag=tag)
    return d


class _Records(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_evals(workdir: str, ckpt: str) -> dict:
    """The frozen classification evals at ViT-L width on the pretrain
    checkpoint ``ckpt``, synthetic data (no K400/IN1k on the machine: top-1
    is a plumbing check, not an accuracy), random classifiers from a seed:
    - the video eval at vitl16_k400_16x8x3.yaml as it stands (16x224^2,
      bf16, batch 4; validation over 8 segments x 3 views attended across,
      the classifier over 8 x 1568 = 12,544 tokens), cut to 4 probe steps
      through evals.video_classification.run, then resumed for 4 more
      (``resume_checkpoint``); the synthetic sets hold 64 train and 32 val
      clips;
    - the same config with ``cache_features``: 64 clips encoded once, one
      epoch of 16 cached probe steps (the cached path stops at an epoch's
      end);
    - ``frame_aggregation`` (image mode: batch 4 x 16 frames = 64 images of
      196 tokens), cut to 2 segments x 1 view; the 2-D patch embed does not
      take the tubelet weights, so ``allow_missing_checkpoint`` keeps its
      init;
    - the image eval at vitl16_in1k.yaml (batch 16, each image repeated over
      16 frames) through the eval CLI entry, cut to 1 epoch (4 steps).
    Each run starts with the attention and LayerNorm kernels' launch counts
    at 0, and they stay 0. Checks finite losses, the CSV rows, 0 <= top-1 <=
    100, the merge logs (audio leaves dropped, no leaf missing), the resumed
    classifier; then one batch of classifier logits in bf16 against the same
    weights in f32 (relative L2 within POOLED_REL_TOL), and times encode per
    4-clip view, the probe step and the cached probe step (CUDA events,
    median of 5 rounds), with a profile of encode
    (chiprun_out/eval_encode_profile.txt)."""
    import csv

    import numpy as np
    import torch
    import yaml

    from avjepa_tpu_torch.app.eval_main import launch as eval_launch
    from avjepa_tpu_torch.evals import video_classification as vc
    from avjepa_tpu_torch.layout import TokenLayout
    from avjepa_tpu_torch.models.attentive_pooler import AttentiveClassifier
    from avjepa_tpu_torch.models.factory import VIT_SPECS
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.ops import layer_norm as ln
    from avjepa_tpu_torch.train.optim import ScheduleConfig
    from avjepa_tpu_torch.utils.device import resolve_device

    records = _Records()
    logging.getLogger("avjepa_tpu_torch").addHandler(records)
    result = {}

    def counted(label, fn, tag, steps, folder):
        fa.reset_launches()
        ln.reset_launches()
        records.messages.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = fn()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {**fa.LAUNCHES, **ln.LAUNCHES}
        with open(os.path.join(folder, f"{tag}_r0.csv")) as f:
            rows = [r for r in csv.DictReader(f) if r["epoch"] != "epoch"]
        losses = [float(r["loss"]) for r in rows]
        merge = [m for m in records.messages if m.startswith("checkpoint merge: ")
                 and "leaves loaded" in m]
        print(f"evals: {label}: summary {summary}; {len(rows)} CSV rows, last losses "
              f"{losses[-steps:]}; {wall:.1f} s (set-up, data and validation included), "
              f"peak allocated {peak:.2f} GiB; kernel launches {launches}; {merge}")
        if any(launches.values()):
            raise AssertionError(f"{label}: a kernel ran: {launches}")
        if (set(summary) != {"train_acc", "val_top1"} or not 0 <= summary["val_top1"] <= 100
                or len(losses) < steps or not all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"{label}: summary {summary}, losses {losses}")
        if len(merge) != 1:
            raise AssertionError(f"{label}: no checkpoint merge logged")
        result[label] = {"wall_s": wall, "peak_gib": peak, "rows": len(rows)}
        return merge[0]

    try:
        d = _eval_cfg("vitl16_k400_16x8x3.yaml", workdir, ckpt, "k400")
        cfg = vc.config_from_yaml(d)
        merge = counted("video eval", lambda: vc.run(cfg, max_steps=4, device="cuda"),
                        "k400", 4, cfg.folder)
        if ", 0 missing, 0 shape-mismatched, 2 checkpoint-only dropped (patch_embed." \
                "audio_proj.bias, patch_embed.audio_proj.weight)" not in merge:
            raise AssertionError(f"video eval: merge {merge!r}")
        saved = os.path.join(cfg.folder, "k400-cls-latest.pth.tar")
        first = torch.load(saved, map_location="cpu", weights_only=True)
        resumed = dataclasses.replace(cfg, resume_checkpoint=True)
        counted("video eval resumed", lambda: vc.run(resumed, max_steps=4, device="cuda"),
                "k400", 4, cfg.folder)
        second = torch.load(saved, map_location="cpu", weights_only=True)
        if ((first["step"], first["epoch"], second["step"], second["epoch"]) != (4, 1, 8, 2)
                or "resumed classifier at epoch 1" not in records.messages):
            raise AssertionError(f"the classifier was not resumed: {first['step']}, "
                                 f"{second['step']}")
        print(f"evals: classifier saved at step {first['step']}, resumed at epoch "
              f"{first['epoch']}, saved again at step {second['step']}")

        d = _eval_cfg("vitl16_k400_16x8x3.yaml", workdir, ckpt, "k400-cached",
                      cache_features=True)
        cached = vc.config_from_yaml(d)
        counted("video eval cached", lambda: vc.run(cached, max_steps=4, device="cuda"),
                "k400-cached", 16, cached.folder)

        d = _eval_cfg("vitl16_k400_16x8x3.yaml", workdir, ckpt, "k400-frames",
                      frame_aggregation=True)
        d["data"].update(num_segments=2, num_views_per_segment=1)
        d["pretrain"]["allow_missing_checkpoint"] = True
        frames = vc.config_from_yaml(d)
        merge = counted("video eval frame aggregation",
                        lambda: vc.run(frames, max_steps=4, device="cuda"),
                        "k400-frames", 4, frames.folder)
        if ", 0 missing, 1 shape-mismatched, 2 checkpoint-only" not in merge:
            raise AssertionError(f"frame aggregation: merge {merge!r}")

        d = _eval_cfg("vitl16_in1k.yaml", workdir, ckpt, "in1k", num_epochs=1)
        path = os.path.join(workdir, "in1k.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        counted("image eval", lambda: eval_launch(path, device="cuda"), "in1k", 4, d["folder"])
    finally:
        logging.getLogger("avjepa_tpu_torch").removeHandler(records)

    # the pieces on one batch: encoder, classifier bf16 vs f32, step times
    device = resolve_device("cuda")
    layout = TokenLayout(num_frames=cfg.frames_per_clip, crop_size=cfg.resolution,
                         patch_size=cfg.patch_size, tubelet_size=cfg.tubelet_size,
                         audio_enabled=False)
    encoder = vc.frozen_encoder(cfg.model_name, layout, cfg.uniform_power, torch.bfloat16,
                                cfg.gelu, cfg.seed, ckpt, False, device)
    state = vc.make_classifier(cfg.model_name, cfg.num_classes, torch.bfloat16, cfg.seed + 1,
                               device)
    spec = VIT_SPECS[cfg.model_name]
    f32 = AttentiveClassifier(spec.embed_dim, spec.num_heads, num_classes=cfg.num_classes)
    f32.load_state_dict(state.classifier.state_dict())
    f32.to(device)
    batched, seg_idx, labels = vc.collate(
        [vc.SyntheticVideoClsDataset(cfg, train=False)[i] for i in range(cfg.batch_size)])
    clips = [vc.to_device(batched[s][0], device) for s in range(len(batched))]
    feats = vc.aggregate(cfg, [vc.encode(encoder, c) for c in clips], seg_idx,
                         layout.h_grid * layout.w_grid)[0]
    with torch.no_grad():
        got, want = state.classifier(feats).float(), f32(feats.float())
    rel = ((got - want).norm() / want.norm()).item()
    print(f"evals: classifier logits over {tuple(feats.shape)} tokens, bf16 vs f32: rel L2 "
          f"{rel:.3e} (tol {POOLED_REL_TOL:g})")
    if rel > POOLED_REL_TOL:
        raise AssertionError("the bf16 classifier disagrees with the f32 one")

    fa.reset_launches()
    encode_ms = _time_rounds(lambda: vc.encode(encoder, clips[0]), 2)
    train = vc.collate([vc.SyntheticVideoClsDataset(cfg, train=True)[i]
                        for i in range(cfg.batch_size)])
    step_feats = vc.encode(encoder, vc.to_device(train[0][0][0], device))
    step_labels = vc.to_device(train[2], device)
    sched = ScheduleConfig(ipe=16, num_epochs=cfg.num_epochs, ipe_scale=1.0, warmup_epochs=0,
                           start_lr=cfg.start_lr, ref_lr=cfg.lr, final_lr=cfg.final_lr)
    step_ms = _time_rounds(lambda: vc.probe_step(state, sched, cfg.weight_decay, step_feats,
                                                 step_labels), 2)
    # the cached probe's step: a batch gathered from 64 resident clips
    cache = step_feats.repeat(64 // cfg.batch_size, 1, 1)
    cache_labels = step_labels.repeat(64 // cfg.batch_size)
    draw = np.random.default_rng([cfg.seed, 17])

    def cached_step():
        idx = vc.to_device(draw.choice(64, size=cfg.batch_size, replace=False), device)
        vc.probe_step(state, sched, cfg.weight_decay, cache[idx], cache_labels[idx])

    cached_ms = _time_rounds(cached_step, 2)
    predict_ms = _time_rounds(lambda: vc.predict(state.classifier, feats), 2)
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"an attention kernel ran in the eval timings: {fa.LAUNCHES}")
    b, n = step_feats.shape[:2]
    print(f"evals: encode {encode_ms[1]:.2f} ms per view of {b} clips ({cfg.frames_per_clip}x"
          f"{cfg.resolution}^2, {n} tokens, bf16, plain attention; min {encode_ms[0]:.2f}, "
          f"max {encode_ms[2]:.2f}); probe step {step_ms[1]:.2f} ms ({b} x {n} tokens; "
          f"{step_ms[0]:.2f}-{step_ms[2]:.2f}); cached probe step {cached_ms[1]:.2f} ms "
          f"({cached_ms[0]:.2f}-{cached_ms[2]:.2f}); classifier predict over {b} x "
          f"{feats.shape[1]} tokens {predict_ms[1]:.2f} ms; CUDA events, median of "
          f"{TIME_ROUNDS} rounds; {card_line()}")
    _profile(lambda: vc.encode(encoder, clips[0]), "evals: encode", "eval_encode_profile.txt")
    result.update(encode_ms=encode_ms, step_ms=step_ms, cached_ms=cached_ms,
                  predict_ms=predict_ms, logits_rel=rel)
    return result


# phase 12: data parallel. Loss and grad norms of world 2 against world 1 on
# the same global batch: the tolerances of the kernel-vs-plain step check
# (the two sum the batch in other orders, in bf16 through 36 layers)
DP_LOSS_REL_TOL = STEP_LOSS_REL_TOL
DP_NORM_REL_TOL = STEP_NORM_REL_TOL
# losses through main_distributed at world 1 against app.main's
DP_WORLD1_ABS_TOL = 1e-3


def _csv_rows(path: str) -> list:
    import csv

    with open(path) as f:
        return [r for r in csv.DictReader(f) if r["epoch"] != "epoch"]


def _launch_distributed(workdir: str, label: str, *argv) -> tuple[str, dict]:
    """``python -m avjepa_tpu_torch.app.main_distributed --nproc-per-node 1``
    with ``argv``; its output goes to chiprun_out/dp_<label>.log. Returns
    the output and rank 0's report."""
    report_dir = os.path.join(workdir, f"report-{label}")
    cmd = [sys.executable, "-m", "avjepa_tpu_torch.app.main_distributed", "--nproc-per-node",
           "1", "--report-dir", report_dir, *argv]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=400)
    out = res.stdout + res.stderr
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"dp_{label}.log"), "w") as f:
        f.write(out)
    if res.returncode != 0:
        raise AssertionError(f"main_distributed ({label}) exited {res.returncode}:\n"
                             f"{out[-3000:]}")
    with open(os.path.join(report_dir, "report_r0.json")) as f:
        return out, json.load(f)


def _median_step_ms(rows: list) -> float:
    import statistics

    return statistics.median(float(r["step-time-ms"]) for r in rows[1:])


def run_distributed_world1(workdir: str) -> dict:
    """Phase 12 (a): ViT-L/16 AV pretrain (av-vitl16.yaml at full width,
    bf16, batch 24, remat, synthetic clips) for 4 steps (one epoch of 4: one
    checkpoint) through app.main in this process, then through
    ``main_distributed --nproc-per-node 1`` (one rank over NCCL)
    batch-launching the same config and the video eval
    (vitl16_k400_16x8x3.yaml cut to one epoch of 16 probe steps and 2
    segments x 1 view, as phase 11's frame-aggregation run) on that run's
    checkpoint; then the pretrain relaunched with ``--resume-preempt`` and
    a second epoch. Asserts NCCL, the K1/K2 launches, losses within
    DP_WORLD1_ABS_TOL of app.main's, the resume and the eval's top-1;
    prints the median step ms of both entries."""
    import yaml

    from avjepa_tpu_torch.app.main import launch
    from avjepa_tpu_torch.ops import flash_attention as fa

    folder_app = os.path.join(workdir, "dp-app")
    folder_dp = os.path.join(workdir, "dp-nccl")
    paths = {}
    for epochs in (1, 2):
        d = _pretrain_cfg("av-vitl16.yaml", workdir, optimization={"ipe": 4, "epochs": epochs})
        d["logging"]["folder"] = folder_app
        paths[epochs] = os.path.join(workdir, f"dp-pretrain-{epochs}.yaml")
        with open(paths[epochs], "w") as f:
            yaml.safe_dump(d, f)
    tag = d["logging"]["write_tag"]
    ev = _eval_cfg("vitl16_k400_16x8x3.yaml", workdir,
                   os.path.join(folder_dp, f"{tag}-latest.pth.tar"), "dp-k400", num_epochs=1)
    ev["data"].update(num_segments=2, num_views_per_segment=1)
    paths["eval"] = os.path.join(workdir, "dp-eval.yaml")
    with open(paths["eval"], "w") as f:
        yaml.safe_dump(ev, f)

    t_phase = time.perf_counter()
    fa.reset_launches()
    launch(paths[1])
    app_launches = dict(fa.LAUNCHES)
    app_rows = _csv_rows(os.path.join(folder_app, f"{tag}_r0.csv"))

    t0 = time.perf_counter()
    out, report = _launch_distributed(workdir, "world1", "--batch-launch", "--folder", folder_dp,
                                      "--fname", paths[1], paths["eval"])
    wall = time.perf_counter() - t0
    rows = _csv_rows(os.path.join(folder_dp, f"{tag}_r0.csv"))
    want = {"fwd_packed": 4 * VITL_K1_A_STEP, "bwd_packed": 4 * 60}
    got = {k: report["launches"][k] for k in want}
    print(f"dp: world 1 through main_distributed: backend {report['backend']}, world "
          f"{report['world']}, device {report['device']}; launches {report['launches']} "
          f"(expected {want} from the pretrain, none from the eval; app.main's {app_launches}); "
          f"reductions {report['reductions']}; {wall:.1f} s for both runs (process start, "
          f"init, data, checkpoint and eval included)")
    losses = [float(r["loss"]) for r in rows]
    app_losses = [float(r["loss"]) for r in app_rows]
    diff = max(abs(a - b) for a, b in zip(losses, app_losses))
    print(f"dp: losses through main_distributed {losses}, app.main {app_losses}: max abs "
          f"diff {diff:.3e} (tol {DP_WORLD1_ABS_TOL:g})")
    if len(losses) != 4 or len(app_losses) != 4 or diff > DP_WORLD1_ABS_TOL:
        raise AssertionError("main_distributed's losses differ from app.main's")
    # one gradient all-reduce a step: 4 pretrain steps, 16 probe steps
    if report["reductions"].get("grads") != 4 + 16:
        raise AssertionError(f"{report['reductions']} gradient all-reduces for 4 pretrain "
                             "and 16 probe steps")
    if report["backend"] != "nccl" or report["world"] != 1:
        raise AssertionError(f"main_distributed did not run one NCCL rank: {report}")
    if got != want or {k: app_launches[k] for k in want} != want:
        raise AssertionError(f"launch counts differ: main_distributed {got}, app.main "
                             f"{app_launches}, expected {want}")
    top1 = report["summaries"][1].get("val_top1")
    if top1 is None or not 0 <= top1 <= 100 or "[eval] val top-1" not in out:
        raise AssertionError(f"the batch-launched eval did not validate: {report['summaries']}")
    ms, app_ms = _median_step_ms(rows), _median_step_ms(app_rows)
    print(f"dp: ViT-L AV step through main_distributed (one NCCL rank) {ms:.1f} ms, app.main "
          f"{app_ms:.1f} ms (median of steps 2-4 of the CSV's step-time-ms, host clock to the "
          f"step's sync, batch 24); eval top-1 {top1:.2f}% (synthetic); {card_line()}")

    out, report = _launch_distributed(workdir, "resume", "--resume-preempt", "--folder",
                                      folder_dp, "--fname", paths[2])
    rows = _csv_rows(os.path.join(folder_dp, f"{tag}_r0.csv"))
    if "resumed from step 4 " not in out or len(rows) != 8:
        raise AssertionError(f"--resume-preempt did not resume at step 4 ({len(rows)} rows)")
    if report["launches"]["fwd_packed"] != 4 * VITL_K1_A_STEP:
        raise AssertionError(f"resumed run launches {report['launches']}")
    print(f"dp: --resume-preempt resumed from step 4 and ran steps 5-8, losses "
          f"{[float(r['loss']) for r in rows[4:]]}; phase 12 (a) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": got, "step_ms": ms, "app_step_ms": app_ms, "wall_s": wall}


def _dp_cfg(workdir: str, batch: int) -> dict:
    return _pretrain_cfg("av-vitl16.yaml", workdir, data={"batch_size": batch, "num_workers": 2})


def _digest(modules, gather: bool = True, part=None) -> str:
    """A fingerprint of the modules' f32 weights, computed on the device:
    for each tensor the sum of its bit patterns as integers, plain and
    weighted by position (wrapping in int64), so that any changed bit shows.
    Sharded (DTensor) entries are gathered whole, or left out without
    ``gather``. With ``part`` = (index, parts), each tensor's chunk
    ``index`` of ``parts`` along dimension 0 instead, as ``torch.chunk``
    cuts it (FSDP2's cut): a DTensor's local shard, with no collective, and
    the same slice of a whole tensor."""
    import hashlib

    import torch

    sums = []
    for m in modules:
        for v in m.state_dict().values():
            if part is not None:
                if hasattr(v, "to_local"):
                    v = v.to_local()
                else:
                    chunks = torch.chunk(v, part[1]) if v.dim() else [v] * part[1]
                    v = chunks[part[0]] if part[0] < len(chunks) else v[:0]
            elif hasattr(v, "full_tensor"):
                if not gather:
                    continue
                v = v.full_tensor()
            bits = v.detach().reshape(-1).view(torch.int32).long()
            pos = torch.arange(1, bits.numel() + 1, device=bits.device)
            sums += [bits.sum(), (bits * pos).sum()]
    return hashlib.sha256(str(torch.stack(sums).tolist() if sums else []).encode()).hexdigest()


def _dp_steps(h, inputs: dict, steps: int = 2) -> list:
    """``steps`` train steps on ``inputs``; each step's loss, grad norms,
    gradient all-reduces, weight digest and ms (host clock to a sync)."""
    import torch

    from avjepa_tpu_torch.parallel import dist
    from avjepa_tpu_torch.train.step import train_step

    out = []
    for _ in range(steps):
        before = dist.REDUCTIONS["grads"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(h.state, h.sched, h.step_cfg, **inputs)
        torch.cuda.synchronize()
        out.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"],
                    "enc_grad_norm": m["enc_grad_norm"], "pred_grad_norm": m["pred_grad_norm"],
                    "reductions": dist.REDUCTIONS["grads"] - before,
                    "digest": _digest([h.state.encoder, h.state.predictor,
                                       h.state.target_encoder])})
    return out


def dp_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of phase 12 (b), run in a process of its own: gloo over the
    CUDA tensors of cuda:0 (NCCL refuses two ranks on one device), ViT-L AV
    at batch 24 / world a rank; the global batch from dp-batch.npz, this
    rank's rows of it; two steps; result to dp-rank<rank>.json."""
    import numpy as np
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.masks.multiblock3d import MaskSet
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.parallel import dist
    from avjepa_tpu_torch.train import pretrain

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    device = dist.init_distributed("cuda:0", backend="gloo", timeout_s=300)
    try:
        h = pretrain.setup(load_config(_dp_cfg(workdir, 24 // world)), device)
        h.loader.close()
        z = np.load(os.path.join(workdir, "dp-batch.npz"))
        masks = [MaskSet(enc=z[f"enc{i}"], pred=z[f"pred{i}"], enc_idx=z[f"idx{i}"],
                         union_idx=z[f"union{i}"]) for i in range(len(h.cfg.mask))]
        full = h.to_device(z["video"], z["audio"], masks)
        b = 24 // world
        rows = slice(rank * b, (rank + 1) * b)
        local = dict(video=full["video"][rows], audio=full["audio"][rows],
                     enc_masks=full["enc_masks"][:, rows], pred_masks=full["pred_masks"][:, rows],
                     enc_idx=tuple(i[rows] for i in full["enc_idx"]),
                     union_idx=full["union_idx"][:, rows])
        fa.reset_launches()
        steps = _dp_steps(h, local)
        result = {"backend": torch.distributed.get_backend(), "world": dist.world(),
                  "steps": steps, "launches": dict(fa.LAUNCHES),
                  "pred_counts": local["pred_masks"].flatten(1).sum(1).tolist()}
        with open(os.path.join(workdir, f"dp-rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.shutdown()


def run_distributed_world2(workdir: str) -> dict:
    """Phase 12 (b): two ranks on the one card over gloo, ViT-L AV at batch
    12 a rank, against one process at batch 24 on the same global batch,
    masks and initial weights (the synthetic loader's first batch), two
    steps each: loss within DP_LOSS_REL_TOL and grad norms within
    DP_NORM_REL_TOL, one gradient all-reduce a step, both ranks' weights
    the same to the bit after every step; prints the ms a step."""
    import numpy as np
    import socket

    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    t_phase = time.perf_counter()
    h = pretrain.setup(load_config(_dp_cfg(workdir, 24)), torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    arrays = {"video": video, "audio": audio}
    for i, m in enumerate(masks):
        arrays.update({f"enc{i}": m.enc, f"pred{i}": m.pred, f"idx{i}": m.enc_idx,
                       f"union{i}": m.union_idx})
    np.savez(os.path.join(workdir, "dp-batch.npz"), **arrays)
    ref = _dp_steps(h, h.to_device(video, audio, masks))
    del h
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_rank({r}, 2, {port}, "
                               f"{workdir!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dp_world2.log"), "w") as f:
        f.write("\n".join(outs))
    if any(p.returncode for p in procs):
        raise AssertionError("a world-2 rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"dp-rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"dp: world 2 on one card: backend {ranks[0]['backend']} over CUDA tensors, world "
          f"{ranks[0]['world']}; target tokens a mask config, rank 0 {ranks[0]['pred_counts']}, "
          f"rank 1 {ranks[1]['pred_counts']}; launches a rank {ranks[0]['launches']}")
    if ranks[0]["backend"] != "gloo" or ranks[0]["world"] != 2:
        raise AssertionError(f"world 2 did not run over gloo: {ranks[0]}")
    for i, want in enumerate(ref):
        got, other = ranks[0]["steps"][i], ranks[1]["steps"][i]
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
        print(f"dp: step {i + 1}: world 2 loss {got['loss']:.6f}, enc grad norm "
              f"{got['enc_grad_norm']:.4e}, pred {got['pred_grad_norm']:.4e}; world 1 "
              f"{want['loss']:.6f}, {want['enc_grad_norm']:.4e}, {want['pred_grad_norm']:.4e}; "
              f"rel {', '.join(f'{v:.2e}' for v in rel.values())} (tol {DP_LOSS_REL_TOL:g}, "
              f"{DP_NORM_REL_TOL:g}); gradient all-reduces {got['reductions']} and "
              f"{other['reductions']}; ranks' weights the same: "
              f"{got['digest'] == other['digest']}; {got['ms']:.1f} / {other['ms']:.1f} ms a "
              f"step (world 1 at batch 24: {want['ms']:.1f} ms)")
        if rel["loss"] > DP_LOSS_REL_TOL or max(rel["enc_grad_norm"],
                                                rel["pred_grad_norm"]) > DP_NORM_REL_TOL:
            raise AssertionError("the world-2 step disagrees with the world-1 step")
        if got["reductions"] != 1 or other["reductions"] != 1:
            raise AssertionError("not one gradient all-reduce a step")
        if got["digest"] != other["digest"] or got["loss"] != other["loss"]:
            raise AssertionError("the ranks' weights or losses differ")
    if not all(r["launches"]["fwd_packed"] and r["launches"]["bwd_packed"] for r in ranks):
        raise AssertionError(f"world 2 did not launch K1/K2: {ranks[0]['launches']}")
    ms = ranks[0]["steps"][1]["ms"]
    print(f"dp: world 2 (gloo, two ranks on one card, batch 12 each) {ms:.1f} ms a step "
          f"(step 2, host clock to a sync); phase 12 (b) took "
          f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return {"step_ms": ms, "ref_ms": ref[1]["ms"]}


# phase 13: ViT-H (vith16.yaml). (b) holds the two-rank fsdp step against
# the two-rank data-axis step on the same global batch: the weights are
# equal to the bit (the reduce-scatter sums the same two f32 halves of each
# gradient as the all-reduce, and the optimizer and the EMA work element by
# element), and so are the losses; a grad norm sums each parameter's two
# shards' squares where the data axis takes the whole tensor's norm. The
# first fsdp step is held against (a)'s unsharded step at batch 24, whose
# sums split the batch otherwise, in bf16 through 44 layers
FSDP_DATA_NORM_REL_TOL = 1e-6
FSDP_LOSS_REL_TOL = 1e-3
FSDP_NORM_REL_TOL = 1e-2


def _vith_cfg(workdir: str, batch: int = 24, **over) -> dict:
    return _pretrain_cfg("vith16.yaml", workdir, data={"batch_size": batch, "num_workers": 2},
                         **over)


def _step_record(h, inputs: dict, gather: bool, part=None) -> dict:
    """One train step on ``inputs``: its loss, grad norms, ms (host clock to
    a sync) and the digest of the three models' weights (``_digest``), and
    with ``part`` that of this rank's slice of them."""
    import torch

    from avjepa_tpu_torch.train.step import train_step

    models = [h.state.encoder, h.state.predictor, h.state.target_encoder]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = train_step(h.state, h.sched, h.step_cfg, **inputs)
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t0) * 1e3, "loss": m["loss"],
            "enc_grad_norm": m["enc_grad_norm"], "pred_grad_norm": m["pred_grad_norm"],
            "digest": _digest(models, gather),
            "slice_digest": None if part is None else _digest(models, part=part)}


def _vith_inputs(h, workdir: str, shard: int = 0, shards: int = 1, rows: int = None) -> dict:
    """Shard ``shard`` of ``shards`` of the first ``rows`` rows (all by
    default) of the ViT-H batch that phase 13 (a) saved."""
    import numpy as np

    from avjepa_tpu_torch.masks.multiblock3d import MaskSet

    z = np.load(os.path.join(workdir, "vith-batch.npz"))
    b = (rows or z["video"].shape[0]) // shards
    cut = slice(shard * b, (shard + 1) * b)
    masks = [MaskSet(enc=z[f"enc{i}"][cut], pred=z[f"pred{i}"][cut],
                     enc_idx=z[f"idx{i}"][cut], union_idx=z[f"union{i}"][cut])
             for i in range(len(h.cfg.mask))]
    return h.to_device(z["video"][cut], None, masks)


# phase 14: the parameters whose pieces each tensor rank holds against the
# unsharded step's after each step: cut by heads (qkv and its bias), by
# columns (proj, fc2, predictor_proj), by rows (fc1), and whole ones
TENSOR_CHECK = {
    "encoder": ("blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias", "blocks.0.attn.proj.weight",
                "blocks.31.mlp.fc1.weight", "blocks.31.mlp.fc2.weight", "blocks.31.mlp.fc2.bias",
                "norm.weight"),
    "predictor": ("predictor_blocks.0.attn.qkv.weight", "predictor_blocks.11.mlp.fc2.weight",
                  "predictor_proj.weight", "predictor_proj.bias"),
    "target_encoder": ("blocks.0.attn.qkv.weight", "blocks.31.mlp.fc2.weight"),
}


def _tensor_pieces(h) -> dict:
    """This rank's piece of each TENSOR_CHECK parameter (a copy), with its
    cut (None: held whole)."""
    from avjepa_tpu_torch.parallel import tensor

    out = {}
    for name, keys in TENSOR_CHECK.items():
        model = getattr(h.state, name)
        params, splits = dict(model.named_parameters()), tensor.splits(model)
        for k in keys:
            out[f"{name}/{k}"] = (params[k].detach().clone(), splits.get(k))
    return out


def _tensor_update_errors(start: dict, now: dict, ref_start: dict, ref_now: dict) -> dict:
    """Relative L2 distance of this rank's update of each TENSOR_CHECK piece
    since ``start`` (``_tensor_pieces``) from the same piece of the unsharded
    steps' update since ``ref_start`` (whole tensors)."""
    out = {}
    for key, (p, split) in now.items():
        want = (ref_now[key] - ref_start[key]).to(p.device)
        if split is not None:
            want = split.piece(want)
        out[key] = ((p - start[key][0] - want).norm() / want.norm()).item()
    return out


def fsdp_rank(rank: int, world: int, port: int, workdir: str, data: int, fsdp_: int,
              device: str = "cuda", backend: str = "nccl", profile: bool = False,
              tensor_: int = 1, batch: int = 24, reference: str = None) -> None:
    """One rank of a ViT-H run in a process of its own: vith16.yaml on a
    ``data`` x ``fsdp_`` x ``tensor_`` mesh (``tpu.mesh_*`` through
    ``pretrain.setup``; fsdp_ > 1 shards the blocks, tensor_ > 1 cuts their
    heads and MLP width) at a global batch of ``batch``; ``device`` "cuda"
    takes cuda:LOCAL_RANK, and two ranks on one card take "cuda:0" over gloo
    (NCCL takes one rank a device). Two steps on this rank's shard of the
    first ``batch`` rows of phase 13 (a)'s batch, then, with ``profile``,
    one step under torch.profiler; the result, with this process's peak
    memory, the tensor all-reduces a step and, with ``reference`` (a file of
    the TENSOR_CHECK tensors before and after each unsharded step), each
    checked piece's update against the unsharded update after each step
    (and what a rank that missed its second update reads), to
    fsdp-<data>x<fsdp_>x<tensor_>-rank<rank>.json. Over gloo the
    whole-weight digest leaves the sharded entries out: gathering them
    (``DTensor.full_tensor``, a functional collective) dies with SIGSEGV
    over gloo on CUDA tensors in torch 2.11, while FSDP2's own collectives
    run; so each rank also digests its slice (``_digest``'s ``part``: rank
    of world), which a sharded rank holds and a data rank cuts from its
    whole tensors."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.parallel import dist, fsdp
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    device = dist.init_distributed(device, backend=backend, timeout_s=600)
    try:
        label = f"{data}x{fsdp_}x{tensor_}"
        cfg = load_config(_vith_cfg(workdir, batch // (world // tensor_), tpu={
            "mesh_data": data, "mesh_fsdp": fsdp_, "mesh_tensor": tensor_},
            logging={"folder": os.path.join(workdir, f"vith16-{label}")}))
        h = pretrain.setup(cfg, device)
        h.loader.close()
        params = list(h.state.encoder.parameters())
        mesh = h.state.mesh
        inputs = _vith_inputs(h, workdir, mesh.batch_rank, mesh.batch, batch)
        ref = None if reference is None else torch.load(os.path.join(workdir, reference))
        pieces = [] if ref is None else [_tensor_pieces(h)]
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        records = []
        for i in range(2):
            before = dist.REDUCTIONS["tensor"]
            records.append(_step_record(h, inputs, backend == "nccl", (rank, world)))
            records[-1]["tensor_reductions"] = dist.REDUCTIONS["tensor"] - before
            if ref is not None:
                pieces.append(_tensor_pieces(h))
                records[-1]["update_errors"] = _tensor_update_errors(
                    pieces[0], pieces[-1], ref[0], ref[i + 1])
        if ref is not None:
            # what the check reads for a rank that missed its second update
            records[-1]["missed_update_errors"] = _tensor_update_errors(
                pieces[0], pieces[1], ref[0], ref[2])
        heads = {name: blk.attn.qkv.weight.shape[0] // (3 * blk.attn.head_dim)
                 for name, blk in (("encoder", h.state.encoder.blocks[0]),
                                   ("predictor", h.state.predictor.blocks[0]))}
        result = {"backend": torch.distributed.get_backend(), "world": dist.world(),
                  "mesh": [data, fsdp_, tensor_], "steps": records,
                  "launches": dict(fa.LAUNCHES), "local_heads": heads,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "encoder_sharded_params": sum(p.numel() for p in params
                                                if fsdp.is_sharded(p)),
                  "encoder_local_params": sum(fsdp.local(p).numel() for p in params),
                  "pred_counts": inputs["pred_masks"].flatten(1).sum(1).tolist()}
        if profile:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                train_step(h.state, h.sched, h.step_cfg, **inputs, full_metrics=False)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            result["profile_device_ms"] = sum(e.self_device_time_total for e in events) / 1e3
            result["profile_nccl_ms"] = sum(e.self_device_time_total for e in events
                                            if "nccl" in e.key.lower()) / 1e3
            if rank == 0:
                os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
                with open(os.path.join(ROOT, "chiprun_out",
                                       f"fsdp_{label}_profile.txt"), "w") as f:
                    f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                                      row_limit=40))
        with open(os.path.join(workdir, f"fsdp-{label}-rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.shutdown()


def _free_ports(n: int) -> list:
    """``n`` distinct free TCP ports of this host."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _start_fsdp_ranks(workdir: str, world: int, data: int, fsdp_: int, device: str = "cuda",
                      backend: str = "nccl", profile: bool = False, tensor_: int = 1,
                      batch: int = 24, reference: str = None, port: int = None,
                      cores: int = None) -> tuple:
    """Start ``world`` fsdp_rank processes, sharing ``cores`` of the host's
    cores (all by default); returns what _collect_fsdp_ranks takes."""
    port = port or _free_ports(1)[0]
    label = f"{data}x{fsdp_}x{tensor_}"
    threads = max(1, (cores or os.cpu_count() or 1) // world)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.fsdp_rank({r}, {world}, {port}, "
                               f"{workdir!r}, {data}, {fsdp_}, {device!r}, {backend!r}, "
                               f"profile={profile}, tensor_={tensor_}, batch={batch}, "
                               f"reference={reference!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        # the ranks share the host's cores, as main_distributed's do
        env=dict(os.environ, OMP_NUM_THREADS=str(threads)))
        for r in range(world)]
    return workdir, label, procs


def _collect_fsdp_ranks(workdir: str, label: str, procs: list) -> list:
    """Wait for the ranks of _start_fsdp_ranks; their results, rank by rank."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"fsdp_{label}.log"), "w") as f:
        f.write("\n".join(outs))
    if any(p.returncode for p in procs):
        raise AssertionError(f"a {label} rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    results = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"fsdp-{label}-rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _spawn_fsdp_ranks(*args, **kwargs) -> list:
    """``world`` fsdp_rank processes (_start_fsdp_ranks' arguments); their
    results, rank by rank."""
    return _collect_fsdp_ranks(*_start_fsdp_ranks(*args, **kwargs))


def run_vith(workdir: str) -> dict:
    """Phase 13 (a): vith16.yaml as it stands (ViT-H/16 video: 32 x 1280, 16
    heads of 80; predictor 12 x 384, 16 heads of 24; 1568 tokens; bf16;
    batch 24; remat; synthetic clips) in this process, unsharded: the first
    step's loss and grad norms, the step ms on a resident batch (CUDA
    events, three rounds), peak memory, the K1/K2 launches of a step, one
    profiled step, and K1/K2 held against their plain versions and timed at
    this step's shapes (the target encoder, each context pass's K bucket
    with its key mask, the merged predictor's Ku bucket). Saves the batch
    for (b)."""
    import statistics

    import numpy as np
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step

    t_phase = time.perf_counter()
    cfg = load_config(_vith_cfg(workdir))
    h = pretrain.setup(cfg, torch.device("cuda", 0))
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    arrays = {"video": video}
    for i, m in enumerate(masks):
        arrays.update({f"enc{i}": m.enc, f"pred{i}": m.pred, f"idx{i}": m.enc_idx,
                       f"union{i}": m.union_idx})
    np.savez(os.path.join(workdir, "vith-batch.npz"), **arrays)
    inputs = h.to_device(video, audio, masks)
    setup_s = time.perf_counter() - t_phase
    n_enc = sum(p.numel() for p in h.state.encoder.parameters())
    n_pred = sum(p.numel() for p in h.state.predictor.parameters())

    fa.reset_launches()
    first = _step_record(h, inputs, gather=False)
    launches = dict(fa.LAUNCHES)
    print(f"vith16: ViT-H encoder {n_enc:,} parameters, predictor {n_pred:,}; set-up "
          f"{setup_s:.1f} s; first step loss {first['loss']:.6f}, enc grad norm "
          f"{first['enc_grad_norm']:.4e}, pred grad norm {first['pred_grad_norm']:.4e}; "
          f"launches a step {launches}")
    want = {"fwd_packed": VITH_K1_A_STEP, "bwd_packed": VITH_K1_A_STEP - 32, "fwd": 0, "bwd": 0}
    if launches != want or not math.isfinite(first["loss"]):
        raise AssertionError(f"the ViT-H step's launches {launches} are not {want}, or its "
                             f"loss is not finite: {first}")

    def run():
        train_step(h.state, h.sched, h.step_cfg, **inputs, full_metrics=False)

    torch.cuda.reset_peak_memory_stats()
    all_ms = [_time_ms(run, 3) for _ in range(3)]
    ms = statistics.median(all_ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vith16: ViT-H step {ms:.1f} ms on a resident batch of 24 (CUDA events, 3 steps "
          f"a round; rounds {', '.join(f'{x:.1f}' for x in all_ms)}), {24000 / ms:.2f} "
          f"clips/s; peak allocated {peak:.2f} GiB; {card_line()}")
    _profile(run, "vith16: ViT-H step", "vith_profile.txt", steps=1)

    # K1/K2 at this step's shapes, with this batch's key masks
    n = h.cfg.layout().num_tokens
    gen = torch.Generator(device="cuda").manual_seed(2)
    enc_m, pred_m, union = inputs["enc_masks"], inputs["pred_masks"], inputs["union_idx"]
    cfgs = enc_m.shape[0]
    u_all = union.transpose(0, 1).reshape(-1, union.shape[-1]).long()
    either = (enc_m | pred_m).transpose(0, 1).reshape(-1, n)
    pred_key = torch.gather(either, 1, u_all.clamp(max=n - 1)) & (u_all < n)
    shapes = [("fwd_packed target", True, 24, n, 16, 80, None)]
    for i, idx in enumerate(inputs["enc_idx"]):
        shapes += [(f"{key} context {i}", fwd, 24, idx.shape[1], 16, 80, idx < n)
                   for key, fwd in (("fwd_packed", True), ("bwd_packed", False))]
    shapes += [(f"{key} predictor", fwd, 24 * cfgs, u_all.shape[1], 16, 24, pred_key)
               for key, fwd in (("fwd_packed", True), ("bwd_packed", False))]
    times = {}
    for key, fwd, b, nk, heads, d, mask in shapes:
        label = f"{key} B={b} N={nk} H={heads} d={d}"
        times[key], rounds, floor = _time_packed(fwd, b, nk, heads, d, mask, gen,
                                                 f"vith16 {label}")
        _print_time(label, times[key], rounds, floor)
    del run, h, inputs
    torch.cuda.empty_cache()  # (b) runs in a process of its own on this card
    print(f"vith16: phase 13 (a) took {time.perf_counter() - t_phase:.1f} s")
    return {"first": first, "step_ms": ms, "peak_gib": peak, "launches": launches,
            "times": times}


# phase 13 (c): vith16_384.yaml (V-JEPA's ViT-H/16-384: 8 x 24 x 24 = 4608
# tokens) as it stands, at the config's batch (27.1 GiB peak on an H100 80GB
# HBM3, 700 W): an out-of-memory error fails the phase
VITH384_BATCH = 24
VITH384_ROUNDS = 2
VITH384_PLAIN_BATCH = 2  # rows of the plain K1/K2 at 4608 tokens ([2, 16, N, N] f32 scores)


def run_vith384(workdir: str) -> dict:
    """Phase 13 (c): one vith16_384.yaml step as it stands (ViT-H/16 at
    384^2, 16 frames: 4608 tokens; predictor 12 x 384; bf16; remat;
    synthetic clips) at batch VITH384_BATCH: the first step's loss, the K1/K2
    launches of a step, the step ms (CUDA events, VITH384_ROUNDS rounds of
    one step), peak memory, one profiled step and its head_dim 80 forward
    and backward attention kernels' ms and shares of the device time; then
    K1/K2 at the step's d = 80 shapes (the target encoder, each context
    pass with its key mask) held against their plain versions (on the first
    VITH384_PLAIN_BATCH rows) and timed beside SDPA and their bounds."""
    import gc

    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    batch = VITH384_BATCH
    cfg = load_config(_pretrain_cfg("vith16_384.yaml", workdir,
                                    data={"batch_size": batch, "num_workers": 2}))
    h = pretrain.setup(cfg, dev)
    try:
        video, audio, _, masks = next(iter(h.loader))
    finally:
        h.loader.close()
    inputs = h.to_device(video, audio, masks)
    del video, audio
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    first = train_step(h.state, h.sched, h.step_cfg, **inputs)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    n = h.cfg.layout().num_tokens
    want = {"fwd_packed": VITH_K1_A_STEP, "bwd_packed": VITH_K1_A_STEP - 32, "fwd": 0, "bwd": 0}
    if launches != want or not math.isfinite(first["loss"]) or n != 4608:
        raise AssertionError(f"vith16_384: launches {launches} (want {want}), loss "
                             f"{first['loss']}, tokens {n}")

    def run():
        train_step(h.state, h.sched, h.step_cfg, **inputs, full_metrics=False)

    rounds = []
    for _ in range(VITH384_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end))
    ms = min(rounds)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vith16_384: ViT-H/16-384 step ({n} tokens) {ms:.1f} ms on a resident batch of "
          f"{batch} (CUDA events, one step a round; rounds "
          f"{', '.join(f'{x:.1f}' for x in rounds)}), {batch * 1000 / ms:.2f} clips/s; peak "
          f"allocated {peak:.2f} GiB; first step loss {first['loss']:.6f}; launches a step "
          f"{launches}; {card_line()}")
    prof = _profile(run, "vith16_384: ViT-H/16-384 step", "vith384_profile.txt", steps=1)
    shares = {}
    for key in ("fwd", "bwd"):
        shares[key] = sum(x for name, x, _ in prof[key] if name.endswith(", 80>"))
    print(f"vith16_384: head_dim 80 attention kernels in the profiled step: forward "
          f"{shares['fwd']:.1f} ms ({_share(shares['fwd'], prof['total'])}), backward "
          f"{shares['bwd']:.1f} ms ({_share(shares['bwd'], prof['total'])}) of "
          f"{prof['total']:.1f} ms of device kernels")

    enc_idx = [idx.clone() for idx in inputs["enc_idx"]]
    del run, h, inputs
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [("fwd_packed target", True, batch, n, None)]
    for i, idx in enumerate(enc_idx):
        shapes += [(f"{key} context {i}", fwd, batch, idx.shape[1], idx < n)
                   for key, fwd in (("fwd_packed", True), ("bwd_packed", False))]
    times = {}
    for key, fwd, b, nk, mask in shapes:
        label = f"{key} B={b} N={nk} H=16 d=80"
        times[key], t_rounds, floor = _time_packed(fwd, b, nk, 16, 80, mask, gen,
                                                   f"vith16_384 {label}", VITH384_PLAIN_BATCH)
        _print_time(f"vith16_384 {label} (plain at B={VITH384_PLAIN_BATCH})", times[key],
                    t_rounds, floor)
    torch.cuda.empty_cache()
    print(f"vith16_384: phase 13 (c) took {time.perf_counter() - t_phase:.1f} s")
    return {"batch": batch, "step_ms": ms, "rounds": rounds, "peak_gib": peak,
            "launches": launches, "d80_ms": shares, "total_ms": prof["total"], "times": times}


def run_vith_fsdp(workdir: str, vith: dict) -> dict:
    """Phase 13 (b): two ranks on the one card over gloo, ViT-H at batch 12
    a rank on (a)'s global batch and initial weights, two steps each, under
    ``tpu.mesh_fsdp: 2`` (the models sharded over the two ranks) and under
    ``tpu.mesh_data: 2``, the two worlds at once. After each step each fsdp rank's shards equal to
    the bit the same slice of the data rank's weights, and the data ranks'
    whole weights equal each other; the fsdp step's loss equals the data
    step's and its grad norms are within FSDP_DATA_NORM_REL_TOL; the first
    fsdp step is within FSDP_LOSS_REL_TOL and FSDP_NORM_REL_TOL of (a)'s
    unsharded first step; K1/K2 launched; each rank's peak memory in both
    runs."""
    t_phase = time.perf_counter()
    # both worlds at once (four ranks, ~50 GiB of the card): the weights and
    # losses they compare do not depend on what else runs on the card
    ports, cores = _free_ports(2), (os.cpu_count() or 2) // 2
    started = {"fsdp": _start_fsdp_ranks(workdir, 2, 1, 2, "cuda:0", "gloo", port=ports[0],
                                         cores=cores),
               "data": _start_fsdp_ranks(workdir, 2, 2, 1, "cuda:0", "gloo", port=ports[1],
                                         cores=cores)}
    runs = {name: _collect_fsdp_ranks(*run) for name, run in started.items()}
    for name, ranks in runs.items():
        r0, r1 = ranks
        print(f"vith16 {name} 2: transport {r0['backend']} over CUDA tensors, two ranks on one "
              f"card, world {r0['world']}, mesh (data, fsdp) {r0['mesh']}; encoder parameters "
              f"sharded {r0['encoder_sharded_params']:,}, held a rank "
              f"{r0['encoder_local_params']:,}; peak allocated rank 0 {r0['peak_gib']:.2f} GiB, "
              f"rank 1 {r1['peak_gib']:.2f} GiB; steps {[round(x['ms'], 1) for x in r0['steps']]}"
              f" ms (host clock to a sync); launches a rank {r0['launches']}")
        if r0["backend"] != "gloo" or r0["world"] != 2:
            raise AssertionError(f"{name}: not two gloo ranks: {r0}")
        if not all(r["launches"]["fwd_packed"] and r["launches"]["bwd_packed"] for r in ranks):
            raise AssertionError(f"{name}: K1/K2 not launched: {r0['launches']}")
        for a, b in zip(r0["steps"], r1["steps"]):
            if a["loss"] != b["loss"] or (name == "data" and a["digest"] != b["digest"]):
                raise AssertionError(f"{name}: the ranks' weights or losses differ")
    for rank, (f, d) in enumerate(zip(runs["fsdp"], runs["data"])):
        same = [a["slice_digest"] == b["slice_digest"] for a, b in zip(f["steps"], d["steps"])]
        print(f"vith16 fsdp 2 vs data 2, rank {rank}: its slice of the three models' weights "
              f"equal to the bit after steps 1, 2: {same}")
        if not all(same):
            raise AssertionError(f"rank {rank}: the sharded weights differ from the data axis's")
    if runs["fsdp"][0]["encoder_local_params"] * 2 < runs["fsdp"][0]["encoder_sharded_params"]:
        raise AssertionError("fsdp 2: a rank holds less than half the sharded parameters")
    if not runs["fsdp"][0]["encoder_sharded_params"] or runs["data"][0]["encoder_sharded_params"]:
        raise AssertionError("fsdp 2 did not shard, or data 2 did")
    want1 = vith["first"]
    for i, (got, want) in enumerate(zip(runs["fsdp"][0]["steps"], runs["data"][0]["steps"])):
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
        print(f"vith16 fsdp 2 vs data 2, step {i + 1}: loss {got['loss']:.6f} vs "
              f"{want['loss']:.6f}, enc grad norm {got['enc_grad_norm']:.4e} vs "
              f"{want['enc_grad_norm']:.4e}, pred {got['pred_grad_norm']:.4e} vs "
              f"{want['pred_grad_norm']:.4e}: rel {', '.join(f'{v:.2e}' for v in rel.values())}"
              f" (loss equal, norms tol {FSDP_DATA_NORM_REL_TOL:g})")
        if got["loss"] != want["loss"] or max(rel["enc_grad_norm"],
                                              rel["pred_grad_norm"]) > FSDP_DATA_NORM_REL_TOL:
            raise AssertionError("the fsdp ViT-H step disagrees with the data axis's")
        if i == 0:
            rel1 = {k: abs(got[k] - want1[k]) / abs(want1[k])
                    for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
            print(f"vith16 fsdp 2 step 1 vs the unsharded step at batch 24: rel "
                  f"{', '.join(f'{v:.2e}' for v in rel1.values())} (tol "
                  f"{FSDP_LOSS_REL_TOL:g}, {FSDP_NORM_REL_TOL:g})")
            if rel1["loss"] > FSDP_LOSS_REL_TOL or max(
                    rel1["enc_grad_norm"], rel1["pred_grad_norm"]) > FSDP_NORM_REL_TOL:
                raise AssertionError("the fsdp ViT-H step disagrees with the unsharded step")
    saving = runs["data"][0]["peak_gib"] - runs["fsdp"][0]["peak_gib"]
    print(f"vith16 fsdp: a rank's peak {runs['fsdp'][0]['peak_gib']:.2f} GiB sharded against "
          f"{runs['data'][0]['peak_gib']:.2f} GiB on the data axis ({saving:.2f} GiB saved); "
          f"(a) at batch 24 in one process {vith['peak_gib']:.2f} GiB; phase 13 (b) took "
          f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return runs


# phase 14: ViT-H under tpu.mesh_tensor: 2, two gloo ranks on the one card,
# against the unsharded step in this process on the same 4 rows of phase 13
# (a)'s batch: the row-parallel layers sum their ranks' f32 partial products
# in another order than one GEMM does, in bf16 through 44 layers, forward and
# backward (phase 13 (b)'s tolerances of a sharded step against the
# unsharded one). Each checked weight piece's update since the start against
# the same piece of the unsharded update, after each step: two AdamW steps
# move a weight by ~1e-3 of itself, too little for the weights themselves to
# show a wrong update. An AdamW update is about +-lr a step, the sign of an
# element's gradient, so the rounding of a near-zero gradient flips an
# element's update: a relative L2 of 2 sqrt(flipped share). The limit lies
# between that noise and what a rank that missed its second update reads
# (its first update against the unsharded two: printed, and asserted above
# the limit); a piece cut from the wrong place reads ~1.4.
TENSOR_BATCH = 4
TENSOR_LOSS_REL_TOL = 1e-3
TENSOR_NORM_REL_TOL = 1e-2
TENSOR_UPDATE_REL_TOL = 0.15
# the tensor all-reduces of a ViT-H step: two a layer forward (attention and
# MLP) and two backward; a remat'd layer's recompute stops after the last
# tensor the backward needs, before the MLP's all-reduce, so it adds one.
# The target encoder runs forward only; the two context passes and the
# predictor run all three; the predictor's output projection adds one
# forward and one backward
VITH_TENSOR_REDUCTIONS = 2 * 32 + 5 * (2 * 32 + 12) + 2


def run_vith_tensor(workdir: str) -> dict:
    """Phase 14: vith16.yaml (ViT-H/16 video at full width; predictor 12 x
    384, 16 heads of 24; bf16; remat) under ``tpu.mesh_tensor: 2``: two
    steps in this process unsharded on the first TENSOR_BATCH rows of phase
    13 (a)'s batch (their TENSOR_CHECK weights saved before and after
    each), then two gloo ranks on the one card, each running the whole
    batch of 4 with the Megatron layers cut over the two (``fsdp_rank``).
    Held: each rank's losses and grad norms against the unsharded step's,
    the updates of its pieces of the checked weights against the same
    pieces of the unsharded updates, the
    packed kernels on 8 local heads of 80 (encoder) and of 24 (predictor)
    with one K1 launch a layer, and the tensor all-reduces a step; printed:
    each rank's peak memory and ms a step."""
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    t_phase = time.perf_counter()
    h = pretrain.setup(load_config(_vith_cfg(workdir, TENSOR_BATCH)), torch.device("cuda", 0))
    h.loader.close()
    inputs = _vith_inputs(h, workdir, rows=TENSOR_BATCH)
    torch.cuda.reset_peak_memory_stats()

    def checked():
        return {f"{name}/{k}": dict(getattr(h.state, name).named_parameters())[k].detach().cpu()
                for name, keys in TENSOR_CHECK.items() for k in keys}

    ref_steps, saved = [], [checked()]
    for _ in range(2):
        ref_steps.append(_step_record(h, inputs, gather=False))
        saved.append(checked())
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.save(saved, os.path.join(workdir, "tensor-ref.pt"))
    del h, inputs
    torch.cuda.empty_cache()
    ranks = _spawn_fsdp_ranks(workdir, 2, 1, 1, "cuda:0", "gloo", tensor_=2,
                              batch=TENSOR_BATCH, reference="tensor-ref.pt")
    want_launches = {"fwd_packed": 2 * VITH_K1_A_STEP, "bwd_packed": 2 * (VITH_K1_A_STEP - 32),
                     "fwd": 0, "bwd": 0}
    for rank, r in enumerate(ranks):
        worst = {}
        for i, (got, want) in enumerate(zip(r["steps"], ref_steps)):
            rel = {k: abs(got[k] - want[k]) / abs(want[k])
                   for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
            worst = {k: max(worst.get(k, 0.0), v) for k, v in got["update_errors"].items()}
            print(f"vith16 tensor 2, rank {rank}, step {i + 1}: loss {got['loss']:.6f} vs "
                  f"{want['loss']:.6f} unsharded, enc grad norm {got['enc_grad_norm']:.4e} vs "
                  f"{want['enc_grad_norm']:.4e}, pred {got['pred_grad_norm']:.4e} vs "
                  f"{want['pred_grad_norm']:.4e}: rel {', '.join(f'{v:.2e}' for v in rel.values())}"
                  f" (tol {TENSOR_LOSS_REL_TOL:g}, {TENSOR_NORM_REL_TOL:g}); its weight pieces' "
                  f"updates since the start: largest rel L2 from the unsharded updates "
                  f"{max(got['update_errors'].values()):.2e} (tol {TENSOR_UPDATE_REL_TOL:g}); "
                  f"{got['tensor_reductions']} tensor all-reduces; {got['ms']:.1f} ms (host clock "
                  f"to a sync)")
            if rel["loss"] > TENSOR_LOSS_REL_TOL or max(
                    rel["enc_grad_norm"], rel["pred_grad_norm"]) > TENSOR_NORM_REL_TOL:
                raise AssertionError(f"rank {rank}: the tensor-parallel ViT-H step disagrees "
                                     "with the unsharded step")
            if max(got["update_errors"].values()) > TENSOR_UPDATE_REL_TOL:
                raise AssertionError(f"rank {rank}: weight pieces' updates differ from the "
                                     f"unsharded updates: {got['update_errors']}")
            if got["tensor_reductions"] != VITH_TENSOR_REDUCTIONS:
                raise AssertionError(f"rank {rank}: {got['tensor_reductions']} tensor "
                                     f"all-reduces a step, not {VITH_TENSOR_REDUCTIONS}")
        missed = r["steps"][-1]["missed_update_errors"]
        print(f"vith16 tensor 2, rank {rank}: a rank that missed its second update would read "
              f"{min(missed.values()):.2e} to {max(missed.values()):.2e} (tol "
              f"{TENSOR_UPDATE_REL_TOL:g})")
        if min(missed.values()) <= TENSOR_UPDATE_REL_TOL:
            raise AssertionError(f"rank {rank}: the update check cannot see a missed update: "
                                 f"{missed}")
        print(f"vith16 tensor 2, rank {rank}: transport {r['backend']} over CUDA tensors, world "
              f"{r['world']}; local heads {r['local_heads']}; launches over 2 steps "
              f"{r['launches']} (expected {want_launches}); peak allocated {r['peak_gib']:.2f} "
              f"GiB; worst update rel L2 by parameter "
              f"{ {k: float(f'{v:.2e}') for k, v in worst.items()} }")
        if r["backend"] != "gloo" or r["world"] != 2 or r["mesh"] != [1, 1, 2]:
            raise AssertionError(f"not two gloo ranks of tensor 2: {r}")
        if r["launches"] != want_launches or r["local_heads"] != {"encoder": 8, "predictor": 8}:
            raise AssertionError(f"rank {rank}: not the packed kernels on 8 local heads")
    print(f"vith16 tensor 2: a rank's peak {ranks[0]['peak_gib']:.2f} / {ranks[1]['peak_gib']:.2f}"
          f" GiB against {ref_peak:.2f} GiB unsharded at batch {TENSOR_BATCH} in one process; "
          f"step ms rank 0 {[round(x['ms'], 1) for x in ranks[0]['steps']]} against unsharded "
          f"{[round(x['ms'], 1) for x in ref_steps]}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return {"ranks": ranks, "ref": ref_steps, "ref_peak_gib": ref_peak}


# phase 15: the ViT-L AV step fed by the loader's threads and by its worker
# processes, the loader alone on the extract app's view, the encoder at an
# off-native input (its pos-embed resized) and the predictor in image mode
INGEST_STEPS = 6
INGEST_WORKERS = 12  # av-vitl16.yaml's and vitl16_extract.yaml's num_workers
# the extract batch's device time on an H100 80GB HBM3 at 700 W (PERF.md
# section 5), for the loader's bar
EXTRACT_DEVICE_MS = 80.1


def _batch_digest(batch) -> str:
    """sha256 over a host batch's video, audio, labels and every mask set's
    arrays."""
    import hashlib

    import numpy as np

    video, audio, labels, masks = batch
    h = hashlib.sha256()
    for a in (video, audio, labels):
        h.update(np.ascontiguousarray(a).tobytes())
    for m in masks:
        for a in (m.enc, m.pred, m.enc_idx, m.union_idx):
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _worker_state() -> dict:
    """Run in a loader worker: whether torch is imported there, and whether
    it initialised CUDA or loaded the kernels' library."""
    torch = sys.modules.get("torch")
    build = sys.modules.get("avjepa_tpu_torch.ops._build")
    return {"torch": torch is not None,
            "cuda_initialized": bool(torch and torch.cuda.is_initialized()),
            "kernels_loaded": bool(build and build.load_library.cache_info().currsize)}


def _ingest_steps(workdir: str, processes: bool) -> dict:
    """av-vitl16.yaml through pretrain.setup from fresh handles, its loader
    over the synthetic clips at 12 workers: the threads the app's rule picks
    (``processes`` False) or a process loader built over the same sampler
    and collator. INGEST_STEPS steps as the app's loop runs them: the batch
    waited for, copied to the device (timed to a sync), then the step.
    Returns the batches' digests, losses, launches and times."""
    import numpy as np
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.data.loader import BatchLoader
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step

    cfg = load_config(_pretrain_cfg("av-vitl16.yaml", workdir,
                                    data={"num_workers": INGEST_WORKERS}))
    h = pretrain.setup(cfg, torch.device("cuda", 0))
    if h.loader.use_processes:
        raise AssertionError("the app's rule picked processes for synthetic clips")
    loader = h.loader
    if processes:
        loader.close()
        loader = BatchLoader(h.loader.dataset, h.loader.sampler, num_workers=INGEST_WORKERS,
                             mask_collator=h.mask_collator, use_processes=True)
    batches, losses, wait, h2d, step, ends = [], [], [], [], [], []
    loader.set_epoch(0)
    it = iter(loader)
    fa.reset_launches()
    try:
        for _ in range(INGEST_STEPS):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            if not batches:
                first = dict(loader.stats)  # the pool's start-up is in these batches
            video, audio, _, masks = batch
            inputs = h.to_device(video, audio, masks)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            losses.append(train_step(h.state, h.sched, h.step_cfg, **inputs,
                                     full_metrics=False)["loss"])
            ends.append(time.perf_counter())
            wait.append(1e3 * (t1 - t0))
            h2d.append(1e3 * (t2 - t1))
            step.append(1e3 * (ends[-1] - t2))
            batches.append(batch)
    finally:
        it.close()
        stats = dict(loader.stats)
        loader.close()
    launches = dict(fa.LAUNCHES)
    b, later = cfg.data.batch_size, INGEST_STEPS - 1
    n = max(stats["batches"] - first["batches"], 1)
    return {
        "digests": [_batch_digest(x) for x in batches], "losses": losses,
        "launches": launches, "clips_per_s": b * later / (ends[-1] - ends[0]),
        "wait_ms": float(np.mean(wait[1:])), "h2d_ms": float(np.mean(h2d[1:])),
        "step_ms": float(np.mean(step[1:])),
        "first_wait_ms": wait[0],
        "producer_ms": {k: 1e3 * (stats[f"{k}_s"] - first[f"{k}_s"]) / n
                        for k in ("fetch", "collate", "masks")},
        "batches_timed": n,
    }


def run_ingest(workdir: str) -> dict:
    """Phase 15 (a): the ViT-L AV step fed by threads and by processes,
    INGEST_STEPS steps each on the same sampler seed and collator counter:
    every batch and every loss equal to the bit between the two, one K1 a
    layer and one K2 a trained layer a step; each mode's clips/s after the
    first step (host clock), the consumer's wait, the producer's stages and
    the H2D copy."""
    t_phase = time.perf_counter()
    print(f"ingest: host os.cpu_count() {os.cpu_count()}, sched_getaffinity "
          f"{len(os.sched_getaffinity(0))} cores")
    runs = {}
    for mode in ("threads", "processes"):
        runs[mode] = r = _ingest_steps(workdir, mode == "processes")
        want = {"fwd_packed": INGEST_STEPS * VITL_K1_A_STEP, "bwd_packed": INGEST_STEPS * 60,
                "fwd": 0, "bwd": 0}
        p = r["producer_ms"]
        print(f"ingest: ViT-L AV, {INGEST_WORKERS} {mode}: {r['clips_per_s']:.2f} clips/s after "
              f"the first step (host clock); the consumer waited {r['wait_ms']:.1f} ms a step "
              f"(first {r['first_wait_ms']:.1f}); producer per batch fetch {p['fetch']:.1f}, "
              f"collate {p['collate']:.1f}, masks {p['masks']:.1f} ms over the "
              f"{r['batches_timed']} batches made after the first arrived; H2D copy and cast {r['h2d_ms']:.1f} ms; "
              f"the step {r['step_ms']:.1f} ms (host clock to its metrics' sync); losses "
              f"{r['losses']}; launches {r['launches']}")
        if r["launches"] != want:
            raise AssertionError(f"ingest ({mode}): launches {r['launches']}, not {want}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"ingest ({mode}): losses {r['losses']}")
    t, p = runs["threads"], runs["processes"]
    if t["digests"] != p["digests"]:
        bad = [i for i, (a, b) in enumerate(zip(t["digests"], p["digests"])) if a != b]
        raise AssertionError(f"ingest: batches {bad} differ between threads and processes")
    if t["losses"] != p["losses"]:
        raise AssertionError(f"ingest: losses differ: {t['losses']} vs {p['losses']}")
    print(f"ingest: the {INGEST_STEPS} batches (video, audio, labels, masks) and losses of "
          f"threads and processes are equal to the bit; phase 15 (a) took "
          f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")
    return runs


def run_loader_alone(workdir: str, batches: int = 8) -> dict:
    """Phase 15 (b): the extract app's view (vitl16_extract.yaml, synthetic
    clips, batch 24) through its loader with 12 threads and with 12
    processes, no device work: batches/s over ``batches`` batches after the
    first, beside the rate extract's device time would take. The process
    workers unpickle the view (which imports torch and the models): asserts
    that none of them initialised CUDA or loaded the kernels."""
    import yaml

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.data.loader import BatchLoader
    from avjepa_tpu_torch.data.synthetic import SyntheticAVDataset
    from avjepa_tpu_torch.serve import extract as ext

    with open(os.path.join(ROOT, "configs/extract/vitl16_extract.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], num_workers=INGEST_WORKERS)
    d["logging"]["folder"] = os.path.join(workdir, "loader_alone")
    cfg = load_config(d)
    b = cfg.data.batch_size
    view = ext._IndexedView(SyntheticAVDataset(cfg.layout(), length=b * (batches + 1)))
    out = {}
    for mode in ("threads", "processes"):
        loader = ext.build_loader(cfg, view)
        if loader.use_processes:
            raise AssertionError("the app's rule picked processes for synthetic clips")
        if mode == "processes":
            loader.close()
            loader = BatchLoader(view, loader.sampler, num_workers=INGEST_WORKERS,
                                 use_processes=True)
        it = iter(loader)
        try:
            next(it)
            t0 = time.perf_counter()
            n = sum(1 for _ in it)
            secs = time.perf_counter() - t0
            state = loader._pool.submit(_worker_state).result() if mode == "processes" else None
        finally:
            it.close()
            loader.close()
        if n != batches:
            raise AssertionError(f"loader alone ({mode}): {n} batches, not {batches}")
        out[mode] = n / secs
        print(f"ingest: extract's loader alone, {INGEST_WORKERS} {mode}: {n / secs:.2f} "
              f"batches/s = {b * n / secs:.1f} clips/s against the "
              f"{1000 * b / EXTRACT_DEVICE_MS:.0f} clips/s that {EXTRACT_DEVICE_MS} ms of device "
              f"time a batch of {b} would take" + (f"; a worker's state {state}" if state else ""))
        if state and (state["cuda_initialized"] or state["kernels_loaded"]):
            raise AssertionError(f"a loader worker initialised CUDA or the kernels: {state}")
    return out


def check_off_native(workdir: str, batch: int = 8) -> float:
    """Phase 15 (c): the ViT-L AV encoder (vitl16_extract.yaml, a 224^2
    layout; random weights) fed a 16 x 256^2 clip: 2048 video tokens (the
    pos-embed resized trilinearly) plus 96 audio tokens through K1 (24
    launches), its pooled features against the plain attention's at
    POOLED_REL_TOL."""
    import torch
    import yaml

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.serve import extract as ext
    from avjepa_tpu_torch.train.step import feature_layer_norm

    with open(os.path.join(ROOT, "configs/extract/vitl16_extract.yaml")) as f:
        d = yaml.safe_load(f)
    d["meta"]["read_checkpoint"] = None
    d["extract"]["allow_random"] = True
    d["logging"]["folder"] = os.path.join(workdir, "off_native")
    cfg = load_config(d)
    device = torch.device("cuda", 0)
    encoder = ext.build_encoder(cfg, device)
    gen = torch.Generator(device=device).manual_seed(15)
    video = torch.randn((batch, 16, 256, 256, 3), generator=gen, device=device)
    audio = torch.randn((batch, 128, 192, 1), generator=gen, device=device)

    @torch.inference_mode()
    def pooled():
        h = encoder(video, audio)
        if h.shape != (batch, 2048 + 96, 1024):
            raise AssertionError(f"off-native tokens {tuple(h.shape)}")
        return feature_layer_norm(h.float()).mean(1)

    fa.reset_launches()
    got = pooled()
    launches = dict(fa.LAUNCHES)
    with plain_packed_attention():
        want = pooled()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"ingest: ViT-L AV encoder (224^2 layout) fed 16 x 256^2 at batch {batch}: 2048 + 96 "
          f"tokens, pooled features kernel vs plain attention rel L2 {rel:.3e} (tol "
          f"{POOLED_REL_TOL:g}), finite {bool(torch.isfinite(got).all())}; launches {launches}")
    if launches["fwd_packed"] != 24 or rel > POOLED_REL_TOL or not torch.isfinite(got).all():
        raise AssertionError("the off-native ViT-L encoder disagrees with the plain attention")
    return rel


def check_image_predictor(batch: int = 24) -> list:
    """Phase 15 (d): the predictor in image mode at ViT-L's predictor width
    (12 x 384, 16 heads of 24; encoder width 1024), a 224^2 image of 196
    tokens, batch 24, bf16: one forward and backward through K1/K2 (12
    launches each) against the plain attention: the loss at
    STEP_LOSS_REL_TOL, the predictor's grad norm at STEP_NORM_REL_TOL."""
    import torch

    from avjepa_tpu_torch.layout import TokenLayout
    from avjepa_tpu_torch.models.factory import make_predictor
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.train.optim import global_norm

    layout = TokenLayout(num_frames=1, crop_size=224, patch_size=16, tubelet_size=1,
                         audio_enabled=False)
    device = torch.device("cuda", 0)
    pred = make_predictor("vit_large", layout, pred_depth=12, pred_embed_dim=384,
                          uniform_power=True, zero_init_mask_tokens=False, dtype=torch.bfloat16,
                          attn_impl="flash", gelu="tanh", seed=16).to(device)
    n = layout.num_tokens
    gen = torch.Generator(device=device).manual_seed(16)
    ctx = torch.randn((batch, n, 1024), generator=gen, device=device).to(torch.bfloat16)
    target = torch.randn((batch, n, 1024), generator=gen, device=device)
    enc = torch.rand((batch, n), generator=gen, device=device) < 0.4
    pmask = ~enc & (torch.rand((batch, n), generator=gen, device=device) < 0.8)
    midx = torch.arange(batch, device=device) % 2

    def once():
        pred.zero_grad(set_to_none=True)
        out = pred(ctx, enc, pmask, midx).float()
        loss = ((out - target).abs().mean(-1) * pmask).sum() / pmask.sum()
        loss.backward()
        grads = [p.grad for p in pred.parameters() if p.grad is not None]
        return [loss.item(), global_norm(grads).item()]

    fa.reset_launches()
    kernel = once()
    launches = dict(fa.LAUNCHES)
    with plain_packed_attention():
        plain = once()
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel, plain)]
    print(f"ingest: image-mode predictor (12 x 384, 16 heads of 24, 196 tokens, batch {batch}, "
          f"bf16): loss {kernel[0]:.6f} vs {plain[0]:.6f}, grad norm {kernel[1]:.4e} vs "
          f"{plain[1]:.4e}; rel {rel[0]:.2e}, {rel[1]:.2e} (tol {STEP_LOSS_REL_TOL:g}, "
          f"{STEP_NORM_REL_TOL:g}); launches {launches}")
    if launches != {"fwd_packed": 12, "bwd_packed": 12, "fwd": 0, "bwd": 0}:
        raise AssertionError(f"image-mode predictor launches {launches}")
    if rel[0] > STEP_LOSS_REL_TOL or rel[1] > STEP_NORM_REL_TOL:
        raise AssertionError("the image-mode predictor disagrees with the plain attention")
    return rel


# the f32 ViT-L AV step takes ~2.8 s at batch 16 and the bf16 one ~0.39 s
# (H100 80GB HBM3, 700 W), so 30 steps keep phase 16 near two minutes
FIDELITY_STEPS = 30
FIDELITY_BATCH = 16


def run_fidelity(steps: int = FIDELITY_STEPS) -> dict:
    """Phase 16: ``steps`` steps of the fidelity curve
    (tools/torch_parity_bf16.py) at the north-star geometry, batch 16: both
    runs' losses, the deviation report, step ms and peak memory. Raises
    unless every loss is finite, both runs started from the same weights to
    the bit, each launched K1 84 and K2 60 times a step (counts set to 0
    before each run), and max |bf16 - f32| is within the reference's
    autocast drift."""
    tp = _tool("torch_parity_bf16")
    t0 = time.perf_counter()
    out = tp.run_curve(tp.north_star_config("vit_large", FIDELITY_BATCH), steps, "cuda")
    report = out["report"]
    want = {"fwd_packed": steps * VITL_K1_A_STEP, "bwd_packed": steps * 60, "fwd": 0, "bwd": 0}
    print(f"fidelity: bf16 losses {out['bf16_losses']}")
    print(f"fidelity: f32 losses {out['f32_losses']}")
    print(f"fidelity: ViT-L AV batch {FIDELITY_BATCH}, {steps} steps: max |bf16 - f32| "
          f"{report['max_abs_dev']:.3e} (limit {tp.REFERENCE_AUTOCAST_MAX_ABS_DEV:g}, the "
          f"reference's autocast drift; the JAX package's {tp.JAX_MAX_ABS_DEV:g} over 200 "
          f"steps), max rel {report['max_rel_dev']:.3e}; step ms bf16 {out['bf16_step_ms']:.1f}, "
          f"f32 {out['f32_step_ms']:.1f}; peak GiB bf16 {out['bf16_peak_gib']:.2f}, f32 "
          f"{out['f32_peak_gib']:.2f}; launches bf16 {out['bf16_launches']}, f32 "
          f"{out['f32_launches']} (expected {want} each); same start {out['same_start']}; "
          f"{card_line()}")
    if not out["finite"]:
        raise AssertionError("fidelity: a loss is not finite")
    if not out["same_start"]:
        raise AssertionError("fidelity: the two runs did not start from the same weights")
    if out["bf16_launches"] != want or out["f32_launches"] != want:
        raise AssertionError("fidelity: launch counts differ from one K1 a layer")
    if not report["max_abs_dev"] <= tp.REFERENCE_AUTOCAST_MAX_ABS_DEV:
        raise AssertionError(f"fidelity: max |bf16 - f32| {report['max_abs_dev']:.3e} exceeds "
                             f"{tp.REFERENCE_AUTOCAST_MAX_ABS_DEV:g}")
    print(f"fidelity: phase 16 took {time.perf_counter() - t0:.1f} s")
    return out


# phase 17: the ViT-L AV state saved after 3 steps and restored into fresh
# models must continue exactly as the run that was never interrupted
RESUME_STEPS = 6


def _dir_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _differing(saved: dict, restored: dict) -> list:
    """Names of the tensors of two ``train_checkpoint`` dicts that are not
    equal to the bit: the three models' entries, each AdamW state's moments
    and step, the step."""
    import torch

    bad = [f"{key}.{k}" for key in ("encoder", "predictor", "target_encoder")
           for k, v in saved[key].items()
           if k not in restored[key] or not torch.equal(v, restored[key][k])]
    s, r = saved["opt"]["state"], restored["opt"]["state"]
    if sorted(s) != sorted(r):
        bad.append("opt.state keys")
    bad += [f"opt.{i}.{k}" for i in s if i in r for k, v in s[i].items()
            if k not in r[i] or not torch.equal(v, r[i][k])]
    return bad + (["step"] if saved["step"] != restored["step"] else [])


def run_resume(workdir: str) -> dict:
    """Phase 17: the ViT-L AV state (av-vitl16.yaml: bf16 over f32, batch
    24, remat) through a save and a restore in each format, the JAX
    package's Orbax layout (the port's writer and reader,
    utils/orbax.py) and the port's .pth.tar. 6 steps uninterrupted; then,
    per format, 3 steps from the same start, a save of the whole state
    (params, EMA target, AdamW moments and steps, step), the models dropped,
    fresh ones built and restored, 3 more steps, on the same 6 batches and
    masks. Raises unless each format's 6 losses and final weight digest
    equal the uninterrupted run's to the bit, every restored tensor equals
    the saved one, and K1/K2 launched 84 and 60 times a step (counts set to
    0 before each run). Prints each format's bytes on disk, save and
    restore seconds and GB/s (the restore reads what the save just wrote:
    a warm page cache), and whether libzstd.so.1 loaded; with it, a zstd
    frame the port wrote (a weight of the restored predictor) is decoded."""
    import gc

    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.train import pretrain
    from avjepa_tpu_torch.train.step import train_step
    from avjepa_tpu_torch.utils import orbax
    from avjepa_tpu_torch.utils.checkpoint import (
        load_train_state,
        save_train_state,
        save_train_state_orbax,
        train_checkpoint,
    )

    t_phase = time.perf_counter()
    cfg = load_config(_pretrain_cfg("av-vitl16.yaml", workdir))
    dev = torch.device("cuda", 0)
    h = pretrain.setup(cfg, dev)
    try:
        it = iter(h.loader)
        batches = [(v, a, m) for v, a, _, m in (next(it) for _ in range(RESUME_STEPS))]
        it.close()
    finally:
        h.loader.close()
    del h

    def fresh():
        h = pretrain.setup(cfg, dev)
        h.loader.close()
        return h

    def drop(h):
        del h.state
        gc.collect()
        torch.cuda.empty_cache()

    def steps(h, first: int, n: int) -> list:
        return [train_step(h.state, h.sched, h.step_cfg, **h.to_device(*batches[i]),
                           full_metrics=False)["loss"] for i in range(first, first + n)]

    def check_launches(label: str, n: int) -> None:
        want = {"fwd_packed": n * VITL_K1_A_STEP, "bwd_packed": n * 60, "fwd": 0, "bwd": 0}
        if dict(fa.LAUNCHES) != want:
            raise AssertionError(f"resume: {label} launches {dict(fa.LAUNCHES)}, not {want}")

    h = fresh()
    fa.reset_launches()
    want_losses = steps(h, 0, RESUME_STEPS)
    check_launches("uninterrupted run", RESUME_STEPS)
    models = lambda h: [h.state.encoder, h.state.predictor, h.state.target_encoder]
    want_digest = _digest(models(h))
    n_values = sum(p.numel() for m in models(h) for p in m.parameters()) + sum(
        t.numel() for s in h.state.optimizer.state.values() for t in s.values() if t.dim())
    drop(h)
    print(f"resume: uninterrupted ViT-L AV run, losses {want_losses}, digest "
          f"{want_digest[:16]}; the state holds {n_values / 1e9:.3f} G values")

    half = RESUME_STEPS // 2
    formats = {
        "orbax": (os.path.join(workdir, "resume", "vitl-ckpt"),
                  lambda path, state: save_train_state_orbax(path, state)),
        "pth": (os.path.join(workdir, "resume", "vitl-latest.pth.tar"),
                lambda path, state: save_train_state(path, state, epoch=0, loss=0.0,
                                                     batch_size=cfg.data.batch_size, lr=0.0)),
    }
    os.makedirs(os.path.join(workdir, "resume"), exist_ok=True)
    out = {}
    for fmt, (path, save) in formats.items():
        h = fresh()
        fa.reset_launches()
        losses = steps(h, 0, half)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, h.state)
        save_s = time.perf_counter() - t0
        saved = train_checkpoint(h.state)
        drop(h)
        h = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_train_state(path, h.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = _differing(saved, train_checkpoint(h.state))
        del saved
        losses += steps(h, half, RESUME_STEPS - half)
        check_launches(f"{fmt} resume", RESUME_STEPS)
        digest = _digest(models(h))
        predictor = {k: v.cpu() for k, v in h.state.predictor.state_dict().items()}
        drop(h)
        nbytes = _dir_bytes(path)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        out[fmt] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                    "save_gb_s": nbytes / save_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9,
                    "losses": losses, "same_losses": losses == want_losses,
                    "same_digest": digest == want_digest, "differing": bad}
        print(f"resume: {fmt}: {nbytes} bytes on disk; save {save_s:.2f} s "
              f"({nbytes / save_s / 1e9:.3f} GB/s), restore {restore_s:.2f} s "
              f"({nbytes / restore_s / 1e9:.3f} GB/s, warm page cache); losses {losses}; "
              f"losses equal to the bit {losses == want_losses}, digest equal "
              f"{digest == want_digest}, restored tensors differing {len(bad)} "
              f"{bad[:4]}; {card_line()}")
        if bad or losses != want_losses or digest != want_digest:
            raise AssertionError(f"resume through {fmt} does not continue the run exactly")

    zstd = orbax.zstd_available()
    print(f"resume: libzstd.so.1 loaded: {zstd}")
    if zstd:
        w = predictor["predictor_blocks.0.attn.qkv.weight"].numpy()
        frame = orbax.zstd_compress(w, 1)
        if orbax.zstd_decompress(frame) != w.tobytes():
            raise AssertionError("resume: a zstd frame did not decode to its bytes")
        print(f"resume: a zstd frame of the predictor's first qkv weight ({w.nbytes} bytes "
              f"in {len(frame)}) written and read back to the bit through libzstd")
    out["zstd"] = zstd
    print(f"resume: phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    if importlib.util.find_spec("avjepa_tpu_torch") is None:
        fail("avjepa_tpu_torch is not importable: run from the root of a checkout")

    t_start = time.perf_counter()
    host_facts()
    toolchain()
    build()
    errs = {**check_kernels(), **check_bwd_kernels()}
    check_bwd_plain_delta()
    ln_errs, ln_launches = check_ln_kernels()
    times = {**time_kernels(), **time_ln_kernels()}
    print(f"kernels: phases 1-3 and 8 took {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        t0 = time.perf_counter()
        run_slice(workdir)
        train = run_train(workdir)
        check_train_vs_plain(workdir)
        check_remat_bits(time_train_step(workdir, remat=True, rounds=3),
                         time_train_step(workdir, remat=False))
        print(f"train: phases 4-7 took {time.perf_counter() - t0:.1f} s")
        run_fidelity()
        t0 = time.perf_counter()
        run_ingest(workdir)
        run_loader_alone(workdir)
        check_off_native(workdir)
        check_image_predictor()
        print(f"ingest: phase 15 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_avprediction(workdir, train["ckpt"])
        check_probe_vs_plain(workdir, train["ckpt"])
        time_probe_step(workdir, train["ckpt"])
        print(f"avpred: phases 9-10 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_evals(workdir, train["ckpt"])
        print(f"evals: phase 11 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_distributed_world1(workdir)
        run_distributed_world2(workdir)
        print(f"dp: phase 12 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_vith_fsdp(workdir, run_vith(workdir))
        run_vith384(workdir)
        print(f"vith16: phase 13 took {time.perf_counter() - t0:.1f} s")
        run_vith_tensor(workdir)
        run_resume(workdir)

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
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
