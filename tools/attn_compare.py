"""K1 and K2 (the packed attention kernels, avjepa_tpu_torch/csrc/attention_fwd.cu
and attention_bwd.cu; K4 at two shapes) of this checkout against another
checkout's, or against text edits of this one's sources, on one GPU, within
one run.

    python tools/attn_compare.py [--compare-root DIR] [--variants JSON]

from the root of a checkout, on a machine with a CUDA GPU; the trees, their
order and ``--variants`` are tools/tree_compare.py's (tools/attn_variants.json
holds the pass 1 and pass 2 splits of K2 at head_dim 80 that were measured
against the one kept). Each tree's process prints the registers and spills of
its head_dim 80 attention kernels (ptxas, from the build log), holds K1 and K2
against their plain versions (bf16) at the shapes of SHAPES (ViT-H's d = 80
shapes of vith16.yaml's step, vith16_384's 4608 tokens and its context
encoder's, and d <= 64 shapes of the ViT-L step and the predictor; K4, the
classic backward, at the vit_tiny step's
d = 64 and at d = 80), and times them there (CUDA events, median of
chip_smoke.TIME_ROUNDS rounds, and the kernels' device time by
torch.profiler) beside SDPA and the bound. The inputs come from one seed, so
the trees' outputs can be compared: each shape's digest of the kernel's
outputs is printed, and whether it equals the first run's. Writes
chiprun_out/attn_compare.json.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

from tree_compare import load_chip_smoke, main

# (label, forward, B, N, H, d, key mask kind of chip_smoke._key_mask); K1/K2
# on a packed qkv [B, N, 3 H d], K3/K4 on [B, H, N, d] q, k, v
SHAPES = (
    ("K1 vith16 target", True, 24, 1568, 16, 80, None),
    ("K1 vith16 context 0", True, 24, 512, 16, 80, "prefix"),
    ("K1 vith16 context 1", True, 24, 128, 16, 80, "prefix"),
    ("K2 vith16 context 0", False, 24, 512, 16, 80, "prefix"),
    ("K2 vith16 context 1", False, 24, 128, 16, 80, "prefix"),
    ("K1 vith16_384 target", True, 4, 4608, 16, 80, None),
    ("K1 vith16_384 context 0", True, 24, 1152, 16, 80, "prefix"),
    ("K1 vith16_384 context 1", True, 24, 384, 16, 80, "prefix"),
    ("K2 vith16_384 context", False, 4, 4608, 16, 80, "prefix"),
    ("K1 d=64 ViT-L target", True, 24, 1664, 16, 64, None),
    ("K1 d=24 vith16 predictor", True, 48, 1280, 16, 24, None),
    ("K2 d=64 ViT-L context", False, 24, 512, 16, 64, "tail"),
    ("K2 d=24 ViT-L predictor", False, 48, 1408, 16, 24, "random"),
    ("K4 d=64 vit_tiny context", False, 24, 512, 3, 64, "tail"),
    ("K4 d=80", False, 4, 1664, 3, 80, "random"),
)


def _digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root: str) -> dict:
    """Load ``root``'s kernels; check, digest and time them at SHAPES."""
    import torch

    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.ops._build import load_library

    assert Path(fa.__file__).resolve().is_relative_to(Path(root).resolve()), fa.__file__
    cs = load_chip_smoke()
    resources = cs.kernel_resources("attn")
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = []
    for label, forward, b, n, h, d, kind in SHAPES:
        classic = label[:2] in ("K3", "K4")
        mask = cs._key_mask(gen, b, n, kind)
        valid = b * n if mask is None else int(mask.sum().item())
        if classic:
            q, k, v, dout = (torch.randn((b, h, n, d), generator=gen, device="cuda")
                             .to(torch.bfloat16) for _ in range(4))
            out, lse = fa.flash_attention_fwd(q, k, v, mask)
            kernel = (lambda: fa.flash_attention_fwd(q, k, v, mask),
                      lambda: torch.stack(fa.flash_attention_bwd(q, k, v, out, lse, dout, mask)))
            plain = (lambda: fa.flash_attention_ref(q, k, v, mask),
                     lambda: torch.stack(fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask)))
        else:
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
            out, lse = fa.flash_attention_qkv_fwd(qkv, h, mask)
            q, k, v = fa._split_qkv(qkv, h)
            dout = torch.randn((b, n, h * d), generator=gen, device="cuda").to(torch.bfloat16)
            kernel = (lambda: fa.flash_attention_qkv_fwd(qkv, h, mask),
                      lambda: fa.flash_attention_qkv_bwd(qkv, out, lse, dout, h, mask))
            plain = (lambda: fa.flash_attention_qkv_ref(qkv, h, mask),
                     lambda: fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout, h, mask))
        run, want = kernel[not forward], plain[not forward]()
        if forward:
            lib = cs._sdpa_fwd_ms(q, k, v, mask)
            bound = cs._bound(4 * h * d * n * valid, 4 * b * n * h * d * 2 + b * h * n * 4)
        else:
            lib = cs._sdpa_bwd_ms(q, k, v, mask)
            bound = cs._bound(10 * h * d * n * valid,
                              8 * b * n * h * d * 2 + b * h * n * 4 + b * n * 4)
        got = run()
        torch.cuda.synchronize()
        err = cs._hold_packed(f"{label} B={b} N={n} H={h} d={d}", forward, got, want)
        digest = _digest(*got) if forward else _digest(got)
        del want, got
        k_min, k_ms, k_max = cs._time_rounds(run, 20)
        # the attention kernels' own device time (the events above also
        # hold the wrapper's host time, which the small shapes can exceed)
        dev = sum(ms for key, ms in cs._device_ms(run, want="attn_").items() if "attn_" in key)
        shapes.append({"label": label, "shape": [b, n, h, d], "mask": kind, "ms": k_ms,
                       "ms_min": k_min, "ms_max": k_max, "device_ms": dev, "sdpa_ms": lib[1],
                       "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err,
                       "digest": digest})
        del out, lse, q, k, v, dout, kernel, plain, run
        torch.cuda.empty_cache()
    return {"root": root, "card": cs.card_line(), "library": Path(load_library()._name).name,
            "resources": resources, "shapes": shapes}


def report(out: dict, first: dict) -> None:
    print(f"  {out['library']}; {out['card']}")
    for name, line in out["resources"]:
        if ", 80>" in name:
            print(f"  ptxas {name}: {line}")
    for s in out["shapes"]:
        b, n, h, d = s["shape"]
        same = first.setdefault(s["label"], s["digest"]) == s["digest"]
        print(f"  {s['label']} B={b} N={n} H={h} d={d} mask={s['mask']}: {s['ms']:.3f} ms "
              f"({s['ms_min']:.3f}-{s['ms_max']:.3f}), device {s['device_ms']:.4f} ms, "
              f"SDPA {s['sdpa_ms']:.3f} ms, bound "
              f"{s['bound_ms']:.3f} ms ({s['bound_by']}), kernel/SDPA "
              f"{s['ms'] / s['sdpa_ms']:.2f}; digest {s['digest']} "
              f"{'equal to' if same else 'differs from'} the first run's")


if __name__ == "__main__":
    main(worker, report, "attn_compare")
