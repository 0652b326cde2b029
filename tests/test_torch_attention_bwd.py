"""The port's attention backward (avjepa_tpu_torch.ops) held against the JAX
package.

The same inputs and output cotangent, made with numpy from a seed, go through
``jax.vjp`` of the JAX function (its Pallas backward kernels run in interpret
mode on the CPU) and through the port's plain backward versions, which are
what its wrappers run on a CPU tensor. f32 throughout; tolerance 2e-5 max
abs, the JAX tests' own. Then each autograd Function against autograd
through the plain forward. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avjepa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from avjepa_tpu.ops.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from avjepa_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _mask(rng, b, n, p=0.7):
    mask = rng.random((b, n)) < p
    mask[:, 0] = True
    return mask


def _jax_packed_grad(qkv, g, h, mask):
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x: jax_flash_attention_qkv(x, h, key_mask=jm), jnp.asarray(qkv))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _port_packed_grad(qkv, g, h, mask):
    tq = torch.from_numpy(qkv)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_qkv_fwd(tq, h, tm)
    return fa.flash_attention_qkv_bwd(tq, out, lse, torch.from_numpy(g), h, tm).numpy()


@pytest.mark.parametrize(
    "b,n,h,d,case",
    [
        (2, 256, 4, 32, "masked"),
        (2, 128, 2, 64, "unmasked"),       # d=64, the encoders' head_dim
        (1, 128, 16, 24, "masked"),        # the ViT-L predictor's head_dim
        (2, 200, 4, 32, "masked"),         # ragged N: JAX pads to 256 and masks the pad
        (2, 128, 2, 64, "empty_row"),      # batch row 1 has no valid key
        (1, 128, 8, 80, "masked"),         # vit_huge's head_dim (8 heads of 80 pack)
        (2, 192, 16, 24, "prefix"),        # the step's compacted masks: a valid prefix
    ],
)
def test_packed_bwd_ref_matches_jax(b, n, h, d, case):
    rng = np.random.default_rng(n + d + len(case))
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    g = rng.normal(size=(b, n, h * d)).astype(np.float32)
    mask = None if case == "unmasked" else _mask(rng, b, n)
    if case == "empty_row":
        mask[1] = False
    if case == "prefix":  # sentinel tails of 40 and 101 keys
        mask = np.arange(n)[None, :] < np.array([[152], [91]])
    got = _port_packed_grad(qkv, g, h, mask)
    want = _jax_packed_grad(qkv, g, h, mask)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if case == "empty_row":
        assert not got[1].any()


def test_packed_bwd_ref_saturated_logits():
    """Logits above the clamp (tests/test_flash_attention.py:140's case): a
    clamped logit gets exactly zero gradient in both packages."""
    b, n, h, d = 1, 128, 4, 32
    c = h * d
    rng = np.random.default_rng(7)
    qkv = np.asarray(rng.normal(size=(b, n, 3 * c)), np.float32)
    qkv[:, :8, :c] *= 40.0
    g = rng.normal(size=(b, n, c)).astype(np.float32)
    s = np.einsum("bqhd,bkhd->bhqk", *(qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
                                        for i in range(2))) * d**-0.5
    assert (s >= fa.SOFTMAX_CLAMP).any()
    got = _port_packed_grad(qkv, g, h, None)
    want = _jax_packed_grad(qkv, g, h, None)
    # gradients of saturated rows are large: compare relative to their scale
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize(
    "n,d,case",
    [
        (256, 32, "unmasked"),
        (256, 64, "masked"),        # with one whole 128-key block masked
        (128, 64, "empty_row"),     # batch row 1 has no valid key
    ],
)
def test_classic_bwd_ref_matches_jax(n, d, case):
    b, h = 2, 3
    rng = np.random.default_rng(31 + n + d)
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(4))
    mask = None
    if case != "unmasked":
        mask = _mask(rng, b, n, 0.6)
        mask[0, 128:] = False
        if case == "empty_row":
            mask[1] = False
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, key_mask=jm), q, k, v)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tm = None if mask is None else torch.from_numpy(mask)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, tm)
    got = [x.numpy() for x in fa.flash_attention_bwd(tq, tk, tv, out, lse,
                                                     torch.from_numpy(g), tm)]
    # a batch row with no valid key: the port's kernels skip every key tile
    # of it and give exactly 0; JAX's single full-width block gives garbage
    # there (its forward output is don't-care too), so compare the rest
    rows = slice(0, 1) if case == "empty_row" else slice(None)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a[rows], w[rows], rtol=0, atol=TOL)
    if case == "empty_row":
        assert all(not a[1].any() for a in got)


def test_packed_function_grad_matches_autograd_of_plain_forward():
    b, n, h, d = 2, 130, 4, 32
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32))
    mask = torch.from_numpy(_mask(rng, b, n))
    x1 = qkv.clone().requires_grad_()
    fa.flash_attention_qkv_ref(x1, h, mask)[0].backward(g)
    x2 = qkv.clone().requires_grad_()
    before = dict(fa.LAUNCHES)
    fa.flash_attention_qkv(x2, h, mask).backward(g)
    assert fa.LAUNCHES == before  # CPU tensors never count a kernel launch
    torch.testing.assert_close(x2.grad, x1.grad, rtol=0, atol=TOL)


def test_classic_function_grad_matches_autograd_of_plain_forward():
    b, h, n, d = 2, 3, 160, 64
    rng = np.random.default_rng(4)
    base = [torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
            for _ in range(3)]
    g = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
    mask = torch.from_numpy(_mask(rng, b, n, 0.6))
    ref = [t.clone().requires_grad_() for t in base]
    fa.flash_attention_ref(*ref, mask)[0].backward(g)
    got = [t.clone().requires_grad_() for t in base]
    fa.flash_attention(*got, key_mask=mask).backward(g)
    for a, w in zip(got, ref):
        torch.testing.assert_close(a.grad, w.grad, rtol=0, atol=TOL)


def test_mask_gets_no_gradient_and_bad_devices_are_refused():
    qkv = torch.zeros(1, 128, 384, requires_grad=True)
    bias = torch.zeros(1, 128, requires_grad=True)  # an f32 additive key bias
    fa.flash_attention_qkv(qkv, 2, bias).sum().backward()
    assert bias.grad is None and qkv.grad is not None
    meta = torch.zeros(1, 128, 384, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_qkv_bwd(meta, meta[..., :128], torch.zeros(1, 2, 128, device="meta"),
                                   meta[..., :128], 2)
