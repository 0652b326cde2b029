"""The port's attention (avjepa_tpu_torch.ops) held against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernels run in interpret mode on the CPU) and through the port's
plain versions of the CUDA kernels, which are what the port's wrappers run on
a CPU tensor. f32 throughout; tolerance 2e-5 max abs, the JAX tests' own.
The CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avjepa_tpu.ops.attention import xla_attention as jax_xla_attention
from avjepa_tpu.ops.flash_attention import SOFTMAX_CLAMP
from avjepa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from avjepa_tpu.ops.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from avjepa_tpu_torch.ops import flash_attention as fa
from avjepa_tpu_torch.ops.attention import xla_attention

TOL = 2e-5


def _mask(rng, b, n, p=0.7):
    mask = rng.random((b, n)) < p
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize(
    "b,n,h,d,masked",
    [
        (2, 256, 4, 32, False),
        (2, 256, 4, 32, True),
        (1, 128, 16, 24, False),  # predictor head_dim, padded inside the kernel
        (2, 200, 4, 32, False),   # ragged N: JAX pads to 256 and masks the pad
        (2, 200, 4, 32, True),
    ],
)
def test_packed_ref_matches_jax(b, n, h, d, masked):
    rng = np.random.default_rng(n + d + masked)
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = _mask(rng, b, n) if masked else None
    want = jax_flash_attention_qkv(
        jnp.asarray(qkv), h, key_mask=None if mask is None else jnp.asarray(mask)
    )
    got = fa.flash_attention_qkv(
        torch.from_numpy(qkv), h, key_mask=None if mask is None else torch.from_numpy(mask)
    )
    assert got.shape == (b, n, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_packed_ref_fully_masked_row_is_zero():
    """A batch row whose keys are all masked outputs exactly 0, in both."""
    rng = np.random.default_rng(3)
    b, n, h, d = 2, 128, 2, 64
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = _mask(rng, b, n)
    mask[1] = False
    want = np.asarray(jax_flash_attention_qkv(jnp.asarray(qkv), h, jnp.asarray(mask)))
    got, lse = fa.flash_attention_qkv_fwd(torch.from_numpy(qkv), h, torch.from_numpy(mask))
    assert torch.count_nonzero(got[1]) == 0
    np.testing.assert_array_equal(want[1], 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(lse[1].numpy(), np.log(np.float32(1e-30)), rtol=1e-6)


def test_packed_ref_saturated_logits():
    """Logits above the clamp saturate the no-max softmax: the case of
    tests/test_flash_attention.py::test_packed_qkv_saturated_logits."""
    b, n, h, d = 1, 128, 4, 32
    c = h * d
    rng = np.random.default_rng(7)
    qkv = np.asarray(rng.normal(size=(b, n, 3 * c)), np.float32)
    qkv[:, :8, :c] *= 40.0
    want = np.asarray(jax_flash_attention_qkv(jnp.asarray(qkv), h))
    got = fa.flash_attention_qkv(torch.from_numpy(qkv), h).numpy()
    # the float64 softmax of the clamped logits
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d).astype(np.float64)
               for i in range(3))
    s = np.minimum(np.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5, SOFTMAX_CLAMP)
    assert (s >= SOFTMAX_CLAMP).any()
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    exact = np.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, c)
    assert np.abs(got - exact).max() < 5e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_classic_ref_matches_jax(masked):
    b, h, n, d = 2, 3, 256, 32
    rng = np.random.default_rng(11 + masked)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = _mask(rng, b, n, 0.6)
        mask[0, 128:256] = False  # a whole 128-key block
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.jit(jax_flash_attention)(q, k, v, key_mask=jm))
    tm = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), key_mask=tm).numpy()
    # rows are query rows, all valid here; JAX compares its own at valid rows
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_classic_ref_lse_and_fully_masked_batch():
    """lse is m + log(l); a batch row with no valid key gives 0 (the kernel
    skips every key tile of it), where the plain softmax gives garbage."""
    b, h, n, d = 2, 3, 128, 32
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones((b, n), dtype=torch.bool)
    mask[1] = False
    out, lse = fa.flash_attention_fwd(q, k, v, mask)
    assert torch.count_nonzero(out[1]) == 0
    s = torch.einsum("bhqd,bhkd->bhqk", q[:1], k[:1]) * d**-0.5
    torch.testing.assert_close(lse[:1], torch.logsumexp(s, -1), rtol=0, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_xla_attention_matches_jax(masked):
    b, h, nq, nk, d = 2, 3, 40, 56, 24
    rng = np.random.default_rng(21 + masked)
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, nk, d)).astype(np.float32) for _ in range(2))
    mask = _mask(rng, b, nk) if masked else None
    want = jax_xla_attention(q, k, v, key_mask=None if mask is None else jnp.asarray(mask))
    got = xla_attention(*map(torch.from_numpy, (q, k, v)),
                        key_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_flash_falls_back_like_jax():
    """Head dims not divisible by 8 and N < 128 take the plain path."""
    rng = np.random.default_rng(9)
    for n, d in ((100, 32), (128, 12)):
        q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, n, d)).astype(np.float32))
                   for _ in range(3))
        before = dict(fa.LAUNCHES)
        torch.testing.assert_close(fa.flash_attention(q, k, v), xla_attention(q, k, v))
        assert fa.LAUNCHES == before


def test_wrappers_check_inputs():
    qkv = torch.zeros(1, 128, 3 * 3 * 64)
    with pytest.raises(ValueError, match="does not split"):
        fa.flash_attention_qkv(qkv, 5)  # 576 features are not 3 x 5 heads
    with pytest.raises(ValueError, match="does not split"):
        fa.flash_attention_qkv(torch.zeros(1, 128, 3 * 2 * 192), 2)  # head_dim 192 > 128
    with pytest.raises(ValueError, match="key_mask shape"):
        fa.flash_attention_qkv(torch.zeros(1, 128, 384), 2, torch.ones(1, 127, dtype=torch.bool))
    # a tensor on another device is refused, never computed on the CPU
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention_qkv(torch.zeros(1, 128, 384, device="meta"), 2)
