"""Variants of K6 (the LayerNorm backward kernel) built from text edits of
avjepa_tpu_torch/csrc/layer_norm.cu and timed side by side on one GPU.

    python tools/ln_bwd_variants.py [--variants JSON]

from the root of a checkout, on a machine with a CUDA GPU. ``--variants``
maps a name to a list of [old, new] replacements of the source (each old
text must occur in it); the default holds the source as it stands beside two
edits of its design: two blocks an SM under a 128-register bound
(``two_blocks``), and rings twice as deep (``deep_ring``). Each variant is
built with the library's nvcc flags into _archive/ln_bwd_variants/ (one nvcc
each, all started together) and loaded with ctypes beside the others; the
script prints each variant's bf16 K6 registers and spills, holds it against
the plain version at chip_smoke's LN_TIMED shapes (and two runs against each
other, to the bit), then times every variant at every shape by device time
(torch.profiler) and CUDA events, in two rounds, the second in reverse order.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = os.path.join(ROOT, "avjepa_tpu_torch", "csrc", "layer_norm.cu")
OUT = os.path.join(ROOT, "_archive", "ln_bwd_variants")
VARIANTS = {
    "this": [],
    "two_blocks": [
        ["__launch_bounds__(BWD_THREADS, 1)", "__launch_bounds__(BWD_THREADS, 2)"],
        ["*grid = static_cast<int>(sms < tiles ? sms : tiles);",
         "*grid = static_cast<int>(2 * sms < tiles ? 2 * sms : tiles);"],
    ],
    "deep_ring": [["return nchunk <= 3 ? 4 : nchunk == 4 ? 3 : 2;",
                   "return nchunk <= 3 ? 8 : nchunk == 4 ? 6 : nchunk <= 6 ? 4 : 2;"]],
}


def build(variants: dict) -> dict:
    """{name: ctypes library} of each variant that builds."""
    from avjepa_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc

    os.makedirs(OUT, exist_ok=True)
    src = open(SOURCE).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in {SOURCE}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-shared", "-o", os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif (kernel and "ln_bwd_kernelI13__nv_bfloat16" in kernel
                  and ("Used" in line or "spill" in line)):
                label = kernel[kernel.index("ln_bwd_kernel"):].split("EEEv")[0]
                print(f"{name} ptxas {label}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.avj_ln_bwd_workspace.argtypes = [i32, i64, i32]
        lib.avj_ln_bwd_workspace.restype = i64
        lib.avj_ln_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, ptr, i64, i32, f32, ptr]
        lib.avj_ln_bwd.restype = i32
        libs[name] = lib
    return libs


def bwd(lib, x, w, dy):
    """(dx, dgamma, dbeta, grid) of bf16 rows through one variant."""
    import torch

    r, c = x.shape
    dx = torch.empty_like(x)
    sums = torch.empty((2, c), device="cuda")
    floats = lib.avj_ln_bwd_workspace(2, r, c)
    if floats <= 0:
        raise RuntimeError(f"workspace query returned {floats}")
    part = torch.empty(floats, device="cuda")
    code = lib.avj_ln_bwd(2, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                          part.data_ptr(), floats, sums.data_ptr(), r, c, 1e-6,
                          torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"avj_ln_bwd returned CUDA error {code}")
    return dx, sums[0], sums[1], floats // (2 * c)


def main() -> None:
    import torch

    from avjepa_tpu_torch.ops import layer_norm as ln

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=None, help="JSON {name: [[old, new], ...]}")
    args = ap.parse_args()
    libs = build(json.loads(args.variants) if args.variants else VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    data = {}
    for r, c in cs.LN_TIMED:
        x = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn((r, c), generator=gen, device="cuda").to(torch.bfloat16)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        want = ln.layer_norm_bwd_ref(x, w, dy)
        for name, lib in libs.items():
            a, b = bwd(lib, x, w, dy), bwd(lib, x, w, dy)
            errs = [cs._rel_err(g, v) for g, v in zip(a[:3], want)]
            same = all(torch.equal(p, q) for p, q in zip(a[:3], b[:3]))
            ok = (errs[0] <= cs.LN_REL_TOL["bfloat16"] and max(errs[1:]) <= cs.LN_PARAM_REL_TOL
                  and same)
            print(f"check {name} [{r}, {c}]: grid {a[3]}, max|err|/max|plain| dx {errs[0]:.2e} "
                  f"dgamma {errs[1]:.2e} dbeta {errs[2]:.2e}, bit-identical {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"variant {name} disagrees at [{r}, {c}]")
        data[(r, c)] = (x, w, dy)
        del want
    times = {}
    for seq in (list(libs), list(libs)[::-1]):
        for name in seq:
            for (r, c), (x, w, dy) in data.items():
                run = lambda: bwd(libs[name], x, w, dy)  # noqa: E731
                dev = sum(ms for key, ms in cs._device_ms(run).items() if "ln_bwd" in key)
                times.setdefault((name, r, c), []).append((dev, cs._time_ms(run, 20)))
    for (name, r, c), runs in times.items():
        bound = cs._bound(16 * r * c, 3 * r * c * 2 + 3 * c * 4, cs.PEAK_F32_FLOPS)[0]
        print(f"{name} [{r}, {c}]: device " + ", ".join(f"{d:.4f}" for d, _ in runs)
              + f" ms ({100 * bound / min(d for d, _ in runs):.1f}% of the {bound:.4f} ms bound at "
              "best); events " + ", ".join(f"{e:.4f}" for _, e in runs) + " ms")
    print(cs.card_line())


if __name__ == "__main__":
    main()
