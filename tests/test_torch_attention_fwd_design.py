"""The numerics of the 16-bit forward attention kernel (K1 packed, K3
classic; avjepa_tpu_torch/csrc/attention_fwd.cu), emulated tile by tile in
torch and held against the port's plain versions, which are the kernels'
contracts (and are themselves held against the JAX package in
tests/test_torch_attention.py).

The emulation follows the kernel's loop, which both of its designs (the
warp-specialised K1 at DP = 64 and 80, the cp.async ring elsewhere) run in
the same order of sums: one 64-key tile a stage, in list order, with the skip
rule (a tile whose keys are all masked or past N is never read), a "full"
tile (every key below N with bias exactly 0) adding no bias, logits in log2
units (K1: s * log2e after q was scaled and rounded to the input type; K3:
s * (scale * log2e) folded with bias * log2e), p = 2^x with the clamp at
80 * log2e (K1) or a running max in log2 units (K3), p rounded to the input
type before the PV product, f32 sums, and lse written back in natural units
with K3's exact sentinel for a row that saw no valid key. Products run
over head_dim zero-padded as the kernel pads it (``width``: to 32, 64, 80
or 128; d = 80 is not padded), and out is cut to d. Inputs are made
with numpy from a seed. Tolerances: f32 1e-5 of max|plain| (exp2 of a
rounded s * log2e against exp of s moves p by up to ~5e-6 relative at the
clamp); bf16 chip_smoke.TOL, the kernels' tolerance on the card.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from avjepa_tpu_torch.ops import flash_attention as fa
from torch_cpu import kernel_source, launch_width

BK = 64
NEG_BIAS = -1e30
F32 = torch.float32
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)
LN2 = torch.tensor(0.6931471805599453, dtype=F32)
CLAMP2 = torch.tensor(fa.SOFTMAX_CLAMP, dtype=F32) * LOG2E  # f32 product, as in the kernel
F32_REL_TOL = 1e-5


def width(d):
    """The kernel's tile width DP at head_dim d, read from attention_fwd.cu's
    launch_16bit: d zero-padded in shared memory and registers."""
    return launch_width("attention_fwd.cu", d)[0]


def _pad(t, dp):
    """[..., d] zero-padded to [..., dp]."""
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


def _key_tiles(bias_row, n):
    """The kernel's compacted tile list of one batch row: (k0, full)."""
    tiles = []
    for k0 in range(0, n, BK):
        keys = torch.arange(k0, k0 + BK)
        bv = torch.full((BK,), NEG_BIAS, dtype=F32)
        inside = keys < n
        bv[inside] = 0.0 if bias_row is None else bias_row[keys[inside]]
        if bool((bv > -1.0).any()):
            tiles.append((k0, bool((bv == 0.0).all())))
    return tiles


def _fma(a, b, c):
    """f32 fma: the exact product of two f32 (in f64) plus c, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def emulate(q, k, v, bias, scale, clamped):
    """The kernel's tile loop on [B, H, N, d] q, k, v of one dtype:
    (out [B, H, N, d] in that dtype, lse [B, H, N] f32)."""
    dt = q.dtype
    b, h, n, d = q.shape
    dp = width(d)
    q, k, v = (_pad(t, dp) for t in (q, k, v))
    scale = torch.tensor(scale, dtype=F32)
    qs = (q.float() * scale).to(dt).float() if clamped else q.float()
    xs = LOG2E if clamped else scale * LOG2E
    out = torch.zeros((b, h, n, dp), dtype=F32)
    lse = torch.zeros((b, h, n), dtype=F32)
    for bi in range(b):
        m = torch.full((h, n), NEG_BIAS, dtype=F32)
        l = torch.zeros((h, n), dtype=F32)
        acc = torch.zeros((h, n, dp), dtype=F32)
        for k0, full in _key_tiles(None if bias is None else bias[bi], n):
            keys = torch.arange(k0, k0 + BK)
            inside = keys < n
            kt = torch.zeros((h, BK, dp), dtype=dt)
            vt = torch.zeros((h, BK, dp), dtype=dt)
            kt[:, inside], vt[:, inside] = k[bi][:, keys[inside]], v[bi][:, keys[inside]]
            s = torch.matmul(qs[bi], kt.float().transpose(-1, -2))
            if full:
                x = s * xs
            else:
                bv = torch.full((BK,), NEG_BIAS, dtype=F32)
                bv[inside] = 0.0 if bias is None else bias[bi][keys[inside]]
                x = _fma(s, xs, bv * LOG2E)
            if clamped:
                p = torch.exp2(torch.minimum(x, CLAMP2))
            else:
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - m_new)
                l, acc, m = l * corr, acc * corr[..., None], m_new
                p = torch.exp2(x - m[..., None])
            l = l + p.sum(-1)
            acc = acc + torch.matmul(p.to(dt).float(), vt.float())
        l = l.clamp(min=1e-30)
        out[bi] = acc / l[..., None]
        if clamped:
            lse[bi] = torch.log(l)
        else:
            lse[bi] = torch.where(m == NEG_BIAS, NEG_BIAS + torch.log(l),
                                  (m + torch.log2(l)) * LN2)
    return out[..., :d].to(dt), lse


def _inputs(seed, b, h, n, d, masked, dtype, empty_row=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, b, h, n, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(t).to(dtype) for t in x)
    mask = None
    if masked == "prefix":
        # the pretrain step's compacted keys: each row's valid keys a prefix
        # whose end falls inside a tile (the last listed tile is partial, the
        # tiles after it are skipped)
        lengths = rng.integers(n // 2, n - 8, size=(b, 1))
        lengths[0] = n - 37
        mask = torch.from_numpy(np.arange(n)[None, :] < lengths)
    elif masked:
        m = rng.random((b, n)) < 0.6
        m[:, 64:128] = False  # one fully-masked 64-key tile: skipped
        if empty_row:
            m[0] = False
        mask = torch.from_numpy(m)
    return q, k, v, mask


def _check(name, dtype, got, want, sentinel_rows=None):
    (out, lse), (ref_out, ref_lse) = got, want
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    assert torch.isfinite(out).all()
    keep = torch.ones(lse.shape, dtype=torch.bool)
    if sentinel_rows is not None:  # batch rows with no valid key: exact
        keep[sentinel_rows] = False
        assert torch.count_nonzero(out[sentinel_rows]) == 0, name
        assert torch.equal(lse[sentinel_rows], ref_lse[sentinel_rows]), name
    out_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse[keep] - ref_lse[keep]).abs().max().item()
    if dtype == torch.float32:
        assert out_err <= F32_REL_TOL * ref_out.abs().max().item(), (name, out_err)
        assert lse_err <= F32_REL_TOL * ref_lse[keep].abs().max().item(), (name, lse_err)
    else:
        tol_out, tol_lse = chip_smoke.TOL[str(dtype).split(".")[-1]]
        assert out_err <= tol_out and lse_err <= tol_lse, (name, out_err, lse_err)


CASES = [  # (b, h, n, d, masked, empty_row)
    (2, 2, 192, 64, False, False),
    (2, 2, 200, 24, True, True),   # ragged N, predictor head_dim, an empty batch row
    (2, 2, 256, 80, True, False),  # vit_huge head_dim
    (2, 3, 130, 64, True, True),   # ragged N with a 2-key last tile
    (2, 2, 130, 80, True, True),   # ViT-H head_dim, ragged N, an empty batch row
    (1, 2, 136, 72, False, False),  # head_dim 72, zero-padded to 80
    (1, 2, 1664, 64, False, False),  # ViT-L's encoders: 26 full tiles
    (2, 1, 1152, 80, "prefix", False),  # vith16_384's context: a partial last tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,masked,empty_row", CASES)
def test_packed_design_matches_plain(b, h, n, d, masked, empty_row, dtype):
    """K1: the no-max clamped softmax in log2 units against
    flash_attention_qkv_ref, on the packed [B, N, 3C] layout."""
    q, k, v, mask = _inputs(n + d, b, h, n, d, masked, dtype, empty_row)
    qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * d) for t in (q, k, v)], -1)
    bias = fa._key_bias(mask, b, n)
    out, lse = emulate(q, k, v, bias, d**-0.5, clamped=True)
    got = (out.transpose(1, 2).reshape(b, n, h * d), lse)
    _check("packed", dtype, got, fa.flash_attention_qkv_ref(qkv, h, mask),
           [0] if empty_row else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,masked,empty_row", CASES)
def test_classic_design_matches_plain(b, h, n, d, masked, empty_row, dtype):
    """K3: the running max in log2 units against flash_attention_ref; a row
    with no valid key writes out 0 and the plain version's lse exactly."""
    q, k, v, mask = _inputs(n + d + 1, b, h, n, d, masked, dtype, empty_row)
    bias = fa._key_bias(mask, b, n)
    got = emulate(q, k, v, bias, d**-0.5, clamped=False)
    want = fa.flash_attention_ref(q, k, v, mask)
    if empty_row:
        assert torch.equal(want[1][0], torch.full_like(want[1][0], NEG_BIAS + np.log(1e-30)))
    _check("classic", dtype, got, want, [0] if empty_row else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_saturated_logits(dtype):
    """Logits far above 80: K1's p saturates at 2^(80 log2e) (the clamp in
    log2 units), K3's running max keeps p <= 1; both against their plain
    versions, with a key mask."""
    b, h, n, d = 2, 2, 160, 32
    q, k, v, mask = _inputs(11, b, h, n, d, True, dtype)
    # s >= (32 * 32**-0.5) * 0.5 * 32 > 80 for every query and key
    q = (q.float().abs() + 32.0).to(dtype)
    k = (k.float().abs() + 0.5).to(dtype)
    bias = fa._key_bias(mask, b, n)
    s = (q.float() * d**-0.5).to(dtype).float() @ k.float().transpose(-1, -2)
    assert bool((s > fa.SOFTMAX_CLAMP).all())
    qkv = torch.cat([t.transpose(1, 2).reshape(b, n, h * d) for t in (q, k, v)], -1)
    out, lse = emulate(q, k, v, bias, d**-0.5, clamped=True)
    _check("packed saturated", dtype, (out.transpose(1, 2).reshape(b, n, h * d), lse),
           fa.flash_attention_qkv_ref(qkv, h, mask))
    _check("classic saturated", dtype, emulate(q, k, v, bias, d**-0.5, clamped=False),
           fa.flash_attention_ref(q, k, v, mask))


def test_skip_and_full_tiles():
    """The tile list the kernel builds: an all-masked 64-key tile is left
    out, a tile is "full" only when all its keys are below N with bias 0
    (a valid key with another bias, or the ragged edge, makes it partial)."""
    n = 200
    bias = torch.zeros(n)
    bias[64:128] = NEG_BIAS
    bias[5] = -0.5  # valid (> -1), but not 0
    assert _key_tiles(bias, n) == [(0, False), (128, True), (192, False)]
    assert _key_tiles(None, 128) == [(0, True), (64, True)]
    assert _key_tiles(torch.full((n,), NEG_BIAS), n) == []


@pytest.mark.parametrize("d,dp", [(24, 32), (64, 64), (72, 80), (80, 80), (96, 128)])
def test_tile_width(d, dp):
    """The kernel's dispatch pads d = 80 (ViT-H) no further; only 24, 72 and
    96 pay for padding."""
    assert width(d) == dp


@pytest.mark.parametrize("dtype,d,clamped,design", [
    (torch.bfloat16, 64, True, "ws"),
    (torch.float16, 64, True, "ws"),
    (torch.bfloat16, 80, True, "ws"),
    (torch.float16, 80, True, "ws"),
    (torch.bfloat16, 24, True, "ring"),
    (torch.float16, 24, True, "ring"),
    (torch.bfloat16, 128, True, "ring"),
    (torch.bfloat16, 64, False, "ring"),  # K3 keeps the ring
    (torch.bfloat16, 80, False, "ring"),
    (torch.float32, 64, True, "fma"),
    (torch.float32, 80, False, "fma"),
])
def test_fwd_design_rule(dtype, d, clamped, design):
    """The forward kernel's design by what the call is: K1 in 16 bits at
    head_dim 64 and 80 is warp-specialised, d = 24 and 128 and K3 take the
    ring, f32 the FMA kernel."""
    assert fa.fwd_design(dtype, d, clamped) == design


def test_fwd_design_rule_is_the_kernels():
    """fwd_design and attention_fwd.cu's dispatch agree at every 16-bit
    head_dim: warp-specialised exactly where launch_16bit's tile width is
    one that uses_ws names, for K1 alone."""
    rule = re.search(r"constexpr bool uses_ws\(bool clamped, int dp\) \{\s*return clamped && "
                     r"\(([^;]+)\);", kernel_source("attention_fwd.cu")).group(1)
    ws_widths = {int(w) for w in re.findall(r"dp == (\d+)", rule)}
    assert ws_widths == {64, 80}
    for d in range(8, 129, 8):
        for clamped in (True, False):
            want = "ws" if clamped and width(d) in ws_widths else "ring"
            assert fa.fwd_design(torch.bfloat16, d, clamped) == want, (d, clamped)


def test_fwd_designs_count_as_launches():
    """FWD_DESIGNS counts each forward launch by its design, as LAUNCHES
    counts it by kernel, and resets with it; a CPU call (the plain version)
    counts in neither."""
    fa.reset_launches()
    qkv = torch.zeros((1, 64, 3 * 64), dtype=torch.bfloat16)
    fa.flash_attention_qkv_fwd(qkv, 1)
    assert not any(fa.LAUNCHES.values()) and not any(fa.FWD_DESIGNS.values())
    for kind, dtype, d in (("fwd_packed", torch.bfloat16, 64), ("fwd_packed", torch.bfloat16, 80),
                           ("fwd_packed", torch.bfloat16, 24), ("fwd", torch.float16, 64),
                           ("fwd_packed", torch.float32, 64)):
        fa._count_fwd(kind, dtype, d)
    assert fa.LAUNCHES == {"fwd_packed": 4, "fwd": 1, "bwd_packed": 0, "bwd": 0}
    assert fa.FWD_DESIGNS == {"ws": 2, "ring": 2, "fma": 1}
    fa.reset_launches()
    assert not any(fa.LAUNCHES.values()) and not any(fa.FWD_DESIGNS.values())
