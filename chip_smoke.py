#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (avjepa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (Hopper, for
the sm_90a kernels). Phases, each printed as it runs; any failure raises and
exits non-zero:
  1. toolchain and card (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build the CUDA kernels from avjepa_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, bf16 and
     f32, at the serving path's shapes, then kernel and plain times;
  4. the extract app through its CLI entry: ViT-L/16 AV, bf16, batch 24,
     96 synthetic clips of 16x224^2 video + 128x192 mel (1664 tokens), from
     a random encoder; then vit_tiny (3 heads, the classic kernel) for one
     batch. Launch counts prove both runs went through the kernels; one
     batch is re-encoded through the plain attention and compared.
The last lines are a JSON kernel table, the card's name and power limit,
and {"ok": true, "device": {...}}. Without a GPU it exits 1 and prints no
result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CU_SOURCE = "avjepa_tpu_torch/csrc/attention_fwd.cu"

# max abs error of kernel vs plain version, (out, lse). bf16/f16: the two
# share every rounding point, but their f32 sums run in other orders, which
# can flip an output's last bit (2^-7 in bf16, 2^-10 in f16, near |out| = 2).
# f32: sums over up to 1664 keys in another order than cuBLAS's.
TOL = {"bfloat16": (2e-2, 1e-3), "float16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}
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


def check_kernels() -> dict:
    """Each kernel vs its plain version; returns the bf16 max abs error at
    the serving path's shape for each."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

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
        # K3, classic [B, H, N, d]
        for masked in (False, True):
            b, h, n, d = 24, 3, 1664, 64
            q, k, v = (randn((b, h, n, d), dtype) for _ in range(3))
            mask = None
            if masked:  # one fully-masked 128-key block
                mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
                mask[:, 128:256] = False
            got = fa.flash_attention_fwd(q, k, v, mask)
            torch.cuda.synchronize()
            err = compare(f"attn_fwd B={b} H={h} N={n} d={d} masked={masked}",
                          dtype, got, fa.flash_attention_ref(q, k, v, mask))
            if dtype == torch.bfloat16 and not masked:
                main_err["fwd"] = err
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


def time_kernels() -> dict:
    """bf16 kernel and plain times at the serving path's shapes."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n, d = 24, 1664, 64
    qkv = torch.randn((b, n, 3 * 16 * d), generator=gen, device="cuda").bfloat16()
    q, k, v = (torch.randn((b, 3, n, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    times = {
        "fwd_packed": (_time_ms(lambda: fa.flash_attention_qkv_fwd(qkv, 16), 20),
                       _time_ms(lambda: fa.flash_attention_qkv_ref(qkv, 16), 5)),
        "fwd": (_time_ms(lambda: fa.flash_attention_fwd(q, k, v), 20),
                _time_ms(lambda: fa.flash_attention_ref(q, k, v), 5)),
    }
    for name, heads in (("fwd_packed", 16), ("fwd", 3)):
        ms, plain = times[name]
        tflops = 4 * b * heads * n * n * d / (ms * 1e-3) / 1e12
        print(f"time {name} bf16 B={b} H={heads} N={n} d={d}: kernel {ms:.3f} ms "
              f"({tflops:.1f} TFLOP/s), plain {plain:.3f} ms")
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
    return launches


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
    errs = check_kernels()
    times = time_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = run_slice(workdir)

    kernels = [
        {"name": name, "route": "cuda", "source": CU_SOURCE,
         "replaces": f"avjepa_tpu/ops/flash_attention.py:{line}",
         "launches": launches[key], "max_abs_err": errs[key],
         "ms": times[key][0], "plain_ms": times[key][1]}
        for name, key, line in (("attn_fwd_packed", "fwd_packed", 459),
                                ("attn_fwd", "fwd", 77))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
