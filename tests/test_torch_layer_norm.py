"""The port's LayerNorm (K5/K6 plain versions, FastLayerNorm) held against the
JAX package's Pallas LayerNorm.

``[64, 256]``, ``[2, 24, 128]`` and the model widths ``[16, 384]`` (the
predictor) and ``[8, 1280]`` (ViT-H) reach the Pallas kernels (interpret mode
on the CPU, as tests/test_kernels_misc.py runs them); ``[37, 192]`` takes the
JAX wrapper's plain jnp branch (rows not a multiple of 8, width not of 128),
which the port's CUDA kernel covers itself. y, dx, dgamma and dbeta through
``jax.vjp`` against ``torch.autograd`` on the same numpy inputs: 1e-5 in f32
(sums in other orders), one bf16 ulp of the largest value in bf16 (the two
share every rounding point; a sum in another order can move one rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avjepa_tpu.models.modules import FastLayerNorm as JaxFastLayerNorm
from avjepa_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from avjepa_tpu_torch.models.modules import FastLayerNorm
from avjepa_tpu_torch.ops import layer_norm as ln

TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0.5, 2.0, size=shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    gamma = rng.normal(1.0, 0.3, size=c).astype(np.float32)
    beta = rng.normal(0.0, 0.3, size=c).astype(np.float32)
    return x, dy, gamma, beta


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256), (37, 192), (2, 24, 128), (16, 384), (8, 1280)])
def test_layer_norm_matches_jax(shape, dtype):
    x, dy, gamma, beta = _inputs(shape, seed=sum(shape))
    jdt = jnp.dtype(dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y_j, vjp = jax.vjp(lambda a, g, b: jax_layer_norm(a, g, b), jx, jnp.asarray(gamma),
                       jnp.asarray(beta))
    dx_j, dg_j, db_j = vjp(jdy)

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y = ln.layer_norm(tx, tg, tb)
    assert y.dtype == tdt and y.shape == tx.shape
    y.backward(torch.from_numpy(np.array(jdy.astype(jnp.float32))).to(tdt))
    assert tx.grad.dtype == tdt and tg.grad.dtype == torch.float32

    tol = TOL[dtype]
    _close(y.detach().float(), y_j.astype(jnp.float32), tol, "y")
    _close(tx.grad.float(), dx_j.astype(jnp.float32), tol, "dx")
    # dgamma/dbeta are f32 sums on both sides, from the same bf16 inputs
    _close(tg.grad, dg_j, 1e-5, "dgamma")
    _close(tb.grad, db_j, 1e-5, "dbeta")
    assert ln.LAUNCHES == {"ln_fwd": 0, "ln_bwd": 0}  # the CPU runs the plain versions


def test_fast_layer_norm_module_matches_flax():
    """The port's FastLayerNorm against flax's with carried weights: forward,
    and the input and parameter gradients of a weighted sum."""
    x, dy, gamma, beta = _inputs((3, 10, 256), seed=4)
    module = JaxFastLayerNorm()
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    y_j, vjp = jax.vjp(lambda p, a: module.apply({"params": p}, a), params, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(dy))

    port = FastLayerNorm(256)
    assert port.eps == 1e-6 and port.weight.dtype == torch.float32
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(gamma))
        port.bias.copy_(torch.from_numpy(beta))
    tx = torch.from_numpy(x).requires_grad_()
    y = port(tx)
    y.backward(torch.from_numpy(dy))
    _close(y.detach(), y_j, 1e-5, "y")
    _close(tx.grad, dx_j, 1e-5, "dx")
    _close(port.weight.grad, dp_j["scale"], 1e-5, "dscale")
    _close(port.bias.grad, dp_j["bias"], 1e-5, "dbias")


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version: here a
    'meta' tensor (no CUDA on this host) is refused."""
    x = torch.empty(4, 8, device="meta")
    g = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ln.layer_norm_fwd(x, g, g)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ln.layer_norm_bwd(x, g, x)
