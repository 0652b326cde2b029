"""The numerics of the 16-bit backward attention kernels (K2 packed, K4
classic; avjepa_tpu_torch/csrc/attention_bwd.cu), emulated tile by tile in
torch and held against the port's plain versions, which are the kernels'
contracts (and are themselves held against the JAX package in
tests/test_torch_attention_bwd.py).

The emulation follows the kernels' two passes. Pass 1 (dk, dv) walks blocks
of keys (64 here; the wgmma kernels take 128, which moves no result, as a
masked key's p is 0 either way), skips a block whose keys are all masked
or past N, adds no bias in a "full" block (every key below N with bias
exactly 0), and streams the query tiles; pass 2 (dq) walks each query
tile's list of 64-key tiles with the same skip and full rules. Both work in log2 units: nl = -(lse * log2e)
per query row (-1e30 past N), K2 p = 2^min(x * log2e + nl, 80 * log2e + nl)
with x = s (+ bias) and the clamp test x < 80 on the natural-units logit,
K4 p = 2^(s * (scale * log2e) + nl) in one FMA (bias * log2e added in a
partial tile). qs = T(q * scale) and ks = T(k * scale) are rounded once
(K2); p and ds are rounded to the input type T before their products; sums
are f32. Every product runs over d zero-padded as the kernels pad it (to
32 or 64 on the wgmma path at d <= 64, to a multiple of 16 above), and the
outputs are cut to d.
Inputs are made with numpy from a seed. Tolerances: f32 1e-5 of max|plain|
(2^x of a rounded log2-unit logit against exp of the natural one moves p by
up to ~5e-6 relative near the clamp); bf16 chip_smoke.BWD_REL_TOL, the
kernels' tolerance on the card.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from avjepa_tpu_torch.ops import flash_attention as fa

BK = 64   # keys a tile (pass 2) and a block (pass 1's skip rule)
QT = 64   # queries a streamed tile (pass 1)
NEG_BIAS = -1e30
F32 = torch.float32
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)
CLAMP = torch.tensor(fa.SOFTMAX_CLAMP, dtype=F32)
CLAMP2 = CLAMP * LOG2E  # f32 product, as in the kernel
F32_REL_TOL = 1e-5


def _fma(a, b, c):
    """f32 fma: the exact product of two f32 (in f64) plus c, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _key_tile(bias_row, n, k0):
    """(bias of keys k0..k0+63 with NEG_BIAS past N, any valid, full)."""
    keys = torch.arange(k0, k0 + BK)
    bv = torch.full((BK,), NEG_BIAS, dtype=F32)
    inside = keys < n
    bv[inside] = 0.0 if bias_row is None else bias_row[keys[inside]]
    return bv, bool((bv > -1.0).any()), bool((bv == 0.0).all())


def _rows(t, r0, rows, n, width):
    """Rows r0..r0+rows-1 of [H, N, d] t, zero past N and past d, as
    [H, rows, width] f32 (the kernel's zero-filled shared-memory tile)."""
    h, _, d = t.shape
    out = torch.zeros((h, rows, width), dtype=F32)
    hi = min(r0 + rows, n)
    if hi > r0:
        out[:, :hi - r0, :d] = t[:, r0:hi].float()
    return out


def _p_ds(s, dp, bias, nl, c2, delta, scale, clamped, full):
    """p and ds of a score tile [H, rows, cols] in log2 units: bias [1 or
    rows, 1 or cols] in natural units, nl, c2 and delta broadcast by query."""
    if clamped:
        x = s if full else s + bias
        p = torch.exp2(torch.minimum(_fma(x, LOG2E, nl), c2))
        ds = torch.where(x < CLAMP, p * (dp - delta), torch.zeros((), dtype=F32))
    else:
        xs = torch.tensor(scale, dtype=F32) * LOG2E
        p = torch.exp2(_fma(s, xs, nl)) if full else torch.exp2(_fma(s, xs, bias * LOG2E) + nl)
        ds = p * (dp - delta) * torch.tensor(scale, dtype=F32)
    return p, ds


def emulate(q, k, v, dout, lse, delta, bias, scale, clamped):
    """Both passes on [B, H, N, d] tensors of one dtype T: (dq, dk, dv) in T."""
    dt = q.dtype
    b, h, n, d = q.shape
    dk_pad = 32 if d <= 32 else 64 if d <= 64 else -(-d // 16) * 16
    do_pad = dk_pad
    sc = torch.tensor(scale, dtype=F32)
    rnd = lambda x: x.to(dt).float()  # noqa: E731 (rounding to T)
    grads = [torch.zeros((b, h, n, d), dtype=F32) for _ in range(3)]
    for bi in range(b):
        brow = None if bias is None else bias[bi]
        qs = rnd(q[bi].float() * sc) if clamped else q[bi]
        ks = rnd(k[bi].float() * sc) if clamped else k[bi]
        # per query row: nl = -(lse * log2e), c2 = 80 * log2e + nl
        nl = -(lse[bi] * LOG2E)
        c2 = CLAMP2 + nl
        # pass 1: dk, dv of each 64-key block over every query tile
        for k0 in range(0, n, BK):
            bv, any_valid, full = _key_tile(brow, n, k0)
            if not any_valid:
                continue
            kt, vt = _rows(k[bi], k0, BK, n, dk_pad), _rows(v[bi], k0, BK, n, dk_pad)
            dkt = torch.zeros((h, BK, do_pad), dtype=F32)
            dvt = torch.zeros((h, BK, do_pad), dtype=F32)
            for q0 in range(0, n, QT):
                qt = _rows(qs, q0, QT, n, dk_pad)
                ot = _rows(dout[bi], q0, QT, n, dk_pad)
                rows = torch.arange(q0, q0 + QT)
                inside = rows < n
                tnl = torch.full((h, QT), -1e30, dtype=F32)
                tc2 = torch.full((h, QT), CLAMP2.item() - 1e30, dtype=F32)
                tdl = torch.zeros((h, QT), dtype=F32)
                tnl[:, inside], tc2[:, inside] = nl[:, rows[inside]], c2[:, rows[inside]]
                tdl[:, inside] = delta[bi][:, rows[inside]]
                st = kt @ qt.transpose(-1, -2)    # [H, keys, queries]
                dpt = vt @ ot.transpose(-1, -2)
                p, ds = _p_ds(st, dpt, bv[None, :, None], tnl[:, None], tc2[:, None],
                              tdl[:, None], scale, clamped, full)
                dvt += rnd(p) @ ot[..., :do_pad]   # p^T . dO: p is [H, keys, queries]
                dkt += rnd(ds) @ qt[..., :do_pad]
            hi = min(k0 + BK, n)
            grads[1][bi][:, k0:hi] = dkt[:, :hi - k0, :d]
            grads[2][bi][:, k0:hi] = dvt[:, :hi - k0, :d]
        # pass 2: dq of each query tile over its listed key tiles
        for q0 in range(0, n, QT):
            qt = _rows(qs, q0, QT, n, dk_pad)
            ot = _rows(dout[bi], q0, QT, n, dk_pad)
            rows = torch.arange(q0, q0 + QT)
            inside = rows < n
            tnl = torch.full((h, QT), -1e30, dtype=F32)
            tc2 = torch.full((h, QT), CLAMP2.item() - 1e30, dtype=F32)
            tdl = torch.zeros((h, QT), dtype=F32)
            tnl[:, inside], tc2[:, inside] = nl[:, rows[inside]], c2[:, rows[inside]]
            tdl[:, inside] = delta[bi][:, rows[inside]]
            dqt = torch.zeros((h, QT, do_pad), dtype=F32)
            for k0 in range(0, n, BK):
                bv, any_valid, full = _key_tile(brow, n, k0)
                if not any_valid:
                    continue
                kt, vt = _rows(k[bi], k0, BK, n, dk_pad), _rows(v[bi], k0, BK, n, dk_pad)
                kst = _rows(ks, k0, BK, n, dk_pad)
                s = qt @ kt.transpose(-1, -2)     # [H, queries, keys]
                dp = ot @ vt.transpose(-1, -2)
                _, ds = _p_ds(s, dp, bv[None, None, :], tnl[..., None], tc2[..., None],
                              tdl[..., None], scale, clamped, full)
                dqt += rnd(ds) @ kst[..., :do_pad]
            hi = min(q0 + QT, n)
            grads[0][bi][:, q0:hi] = dqt[:, :hi - q0, :d]
    return tuple(g.to(dt) for g in grads)


def _inputs(seed, b, h, n, d, mask_kind, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, b, h, n, d)).astype(np.float32)
    q, k, v, dout = (torch.from_numpy(t).to(dtype) for t in x)
    mask = None
    if mask_kind == "random":  # random keys, one fully-masked 64-key tile, an empty row
        m = rng.random((b, n)) < 0.6
        m[:, 64:128] = False
        m[0] = False
        mask = torch.from_numpy(m)
    elif mask_kind == "prefix":  # the step's compacted masks: a valid prefix, sentinel tail
        lengths = rng.integers(n // 2, n, size=(b, 1))
        mask = torch.from_numpy(np.arange(n)[None, :] < lengths)
    return q, k, v, dout, mask


def _check(name, dtype, got, want, empty_row):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = (g.float() - w.float()).abs().max().item()
        tol = (F32_REL_TOL if dtype == torch.float32
               else chip_smoke.BWD_REL_TOL[str(dtype).split(".")[-1]])
        assert err <= tol * w.float().abs().max().item(), (name, err)
        if empty_row:  # a batch row with no valid key: every gradient exactly 0
            assert torch.count_nonzero(g[0]) == 0, name


CASES = [  # (b, h, n, d, mask)
    (2, 2, 200, 24, "random"),   # ragged N, predictor head_dim, an empty batch row
    (2, 2, 256, 24, "prefix"),   # the step's prefix masks with a sentinel tail
    (2, 2, 192, 64, None),
    (2, 2, 130, 64, "prefix"),   # ragged N with a 2-key last tile
    (2, 2, 160, 80, "random"),   # vit_huge head_dim
]


def _packed(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,mask_kind", CASES)
def test_packed_bwd_design_matches_plain(b, h, n, d, mask_kind, dtype):
    """K2: the clamped softmax's gradient in log2 units against
    flash_attention_qkv_bwd_ref, on the packed [B, N, 3C] layout."""
    q, k, v, dout, mask = _inputs(n + d, b, h, n, d, mask_kind, dtype)
    qkv = torch.cat([_packed(t) for t in (q, k, v)], -1)
    out, lse = fa.flash_attention_qkv_ref(qkv, h, mask)
    dout_p = _packed(dout)
    want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, dout_p, h, mask)
    delta = fa.attention_delta(out, dout_p, h)
    got = emulate(q, k, v, dout, lse, delta, fa._key_bias(mask, b, n), d**-0.5, clamped=True)
    got = torch.cat([_packed(g) for g in got], -1)
    c = h * d
    _check("packed", dtype, [got[..., i * c:(i + 1) * c] for i in range(3)],
           [want[..., i * c:(i + 1) * c] for i in range(3)], mask_kind == "random")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,mask_kind", CASES)
def test_classic_bwd_design_matches_plain(b, h, n, d, mask_kind, dtype):
    """K4: p = 2^(s * scale * log2e + nl) against flash_attention_bwd_ref."""
    q, k, v, dout, mask = _inputs(n + d + 1, b, h, n, d, mask_kind, dtype)
    out, lse = fa.flash_attention_ref(q, k, v, mask)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, mask)
    delta = fa.attention_delta(out, dout, h)
    got = emulate(q, k, v, dout, lse, delta, fa._key_bias(mask, b, n), d**-0.5, clamped=False)
    _check("classic", dtype, got, want, mask_kind == "random")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_saturated_logits(dtype):
    """K2 with logits far above 80 in query rows 0-7: the clamp test on the
    natural-units logit gives those rows ds = 0, so dq = 0 there exactly,
    in the emulation as in the plain version."""
    b, h, n, d = 2, 2, 160, 32
    q, k, v, dout, mask = _inputs(11, b, h, n, d, "prefix", dtype)
    k = (k.float().abs() + 0.5).to(dtype)
    q[:, :, :8] = 32.0  # s >= (32 * 32**-0.5) * 0.5 * 32 > 80
    s = (q.float() * d**-0.5).to(dtype).float() @ k.float().transpose(-1, -2)
    assert bool((s[:, :, :8] > fa.SOFTMAX_CLAMP).all())
    qkv = torch.cat([_packed(t) for t in (q, k, v)], -1)
    out, lse = fa.flash_attention_qkv_ref(qkv, h, mask)
    want = fa.flash_attention_qkv_bwd_ref(qkv, out, lse, _packed(dout), h, mask)
    delta = fa.attention_delta(out, _packed(dout), h)
    got = emulate(q, k, v, dout, lse, delta, fa._key_bias(mask, b, n), d**-0.5, clamped=True)
    c = h * d
    want = [want[..., i * c:(i + 1) * c] for i in range(3)]
    _check("saturated", dtype, [_packed(g) for g in got], want, False)
    assert torch.count_nonzero(got[0][:, :, :8]) == 0
    assert torch.count_nonzero(want[0][:, :8]) == 0
