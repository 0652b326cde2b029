"""LayerNorm over the last dim: wrappers of two hand-written CUDA kernels
(forward K5 and backward K6), their plain PyTorch versions, and the
autograd Function that joins them.

Counterpart of ``avjepa_tpu/ops/layer_norm.py`` (its Pallas ``_fwd_kernel``
and ``_bwd_kernel``); the CUDA source is ``avjepa_tpu_torch/csrc/layer_norm.cu``.

Numerics (the kernels' contract, as the TPU kernels compute it): per row,
mean and variance in f32 by two passes (var = mean((x - mean)^2)), xhat =
(x - mean) * rsqrt(var + eps), y = xhat * gamma + beta in f32, rounded once
to x's type. The backward recomputes mean and rstd from x (nothing else is
saved) and gives dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) with g =
dy * gamma, rounded once to x's type, and dgamma = sum(dy * xhat), dbeta =
sum(dy) over all rows in f32, cast to gamma's type.

A wrapper given a tensor on the CPU runs the plain version (``*_ref``);
given a CUDA tensor it launches its kernel or raises. Every shape goes to
the kernel, ragged rows and widths included (the JAX package sends widths
that are not multiples of 128, or row counts not multiples of 8, to plain
jnp: the same function). dgamma/dbeta are summed in a fixed order, so two
runs give the same bits.
"""

from __future__ import annotations

import torch

from avjepa_tpu_torch.ops._build import check, load_library

# kernel launches since the last reset, one count per kernel; a wrapper adds
# one where it launches its kernel and nowhere else (a backward launch runs
# the row pass and the fixed-order column sum)
LAUNCHES = {"ln_fwd": 0, "ln_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions: the kernels' contracts in PyTorch
# ---------------------------------------------------------------------------


def _stats(x32: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(xc, rstd) of f32 rows: xc = x - mean, rstd = rsqrt(mean(xc^2) + eps)."""
    xc = x32 - x32.mean(-1, keepdim=True)
    return xc, torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """K5's contract over the last dim of ``x`` [..., C]."""
    xc, rstd = _stats(x.float(), eps)
    xhat = xc * rstd
    return (xhat * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                       eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's contract: (dx in x's type, dgamma, dbeta in gamma's type)."""
    c = x.shape[-1]
    xc, rstd = _stats(x.reshape(-1, c).float(), eps)
    xhat = xc * rstd
    dy32 = dy.reshape(-1, c).float()
    g = dy32 * gamma.float()
    a = g.mean(-1, keepdim=True)
    bt = (g * xhat).mean(-1, keepdim=True)
    dx = (rstd * (g - a - xhat * bt)).to(x.dtype).reshape(x.shape)
    return dx, (dy32 * xhat).sum(0).to(gamma.dtype), dy32.sum(0).to(gamma.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    """``t`` as contiguous [R, C] rows on ``device``, or raise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    return t.reshape(-1, t.shape[-1]).contiguous()


def _param(p: torch.Tensor, c: int, name: str, device: torch.device) -> torch.Tensor:
    if tuple(p.shape) != (c,) or p.device != device:
        raise ValueError(f"{name} must be [{c}] on {device}, got {tuple(p.shape)} on {p.device}")
    return p.to(torch.float32).contiguous()


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm of ``x`` [..., C] with affine ``gamma``, ``beta`` [C]."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    c = x.shape[-1]
    x2 = _rows(x, "x", x.device)
    g, b = _param(gamma, c, "gamma", x.device), _param(beta, c, "beta", x.device)
    y = torch.empty_like(x2)
    lib = load_library()
    with torch.cuda.device(x.device):
        code = lib.avj_ln_fwd(_DTYPE_CODES[x.dtype], x2.data_ptr(), g.data_ptr(), b.data_ptr(),
                              y.data_ptr(), x2.shape[0], c, eps,
                              torch.cuda.current_stream().cuda_stream)
    check(lib, code, "ln_fwd")
    LAUNCHES["ln_fwd"] += 1
    return y.reshape(x.shape)


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                   eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``layer_norm_fwd``: (dx, dgamma, dbeta)."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(x, gamma, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    c = x.shape[-1]
    x2 = _rows(x, "x", x.device)
    dy2 = _rows(dy.to(x.dtype), "dy", x.device)
    g = _param(gamma, c, "gamma", x.device)
    dx = torch.empty_like(x2)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = load_library()
    dtype = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        # one f32 partial row pair (dgamma, dbeta) per block of the launch
        floats = lib.avj_ln_bwd_workspace(dtype, x2.shape[0], c)
        check(lib, max(-floats, 0), "ln_bwd workspace")
        part = torch.empty(floats, dtype=torch.float32, device=x.device)
        code = lib.avj_ln_bwd(dtype, x2.data_ptr(), g.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                              part.data_ptr(), floats, sums.data_ptr(), x2.shape[0], c, eps,
                              torch.cuda.current_stream().cuda_stream)
    check(lib, code, "ln_bwd")
    LAUNCHES["ln_bwd"] += 1
    return dx.reshape(x.shape), sums[0].to(gamma.dtype), sums[1].to(gamma.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, dy, ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` [..., C], differentiable in x,
    gamma and beta; f32 statistics, output in x's type."""
    return _LayerNorm.apply(x, gamma, beta, eps)
