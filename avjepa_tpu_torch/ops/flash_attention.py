"""Flash attention: wrappers of four hand-written CUDA kernels (forward and
backward of two paths), their plain PyTorch versions, and the custom ops that
join them.

Counterpart of ``avjepa_tpu/ops/flash_attention.py``; the CUDA sources are
``avjepa_tpu_torch/csrc/attention_fwd.cu`` and ``attention_bwd.cu``.

- ``flash_attention_qkv`` (packed path, every model whose heads pack):
  attention read in place off the fused qkv projection ``[B, N, 3C]``, with
  the clamped no-max softmax of the TPU kernel; its backward writes dq | dk |
  dv into one ``[B, N, 3C]`` gradient.
- ``flash_attention`` (classic path, for heads that do not pack, as with
  vit_tiny's 3): ``[B, H, N, Dh]`` streaming softmax with a running max.

Each forward is a ``torch.library.custom_op`` (``avjepa::attn_fwd_packed``,
``avjepa::attn_fwd``) returning (out, lse); its registered backward is the
backward kernel's path, fed the saved inputs, key bias, out and lse; delta =
rowsum(dO * O) is taken outside the backward kernel, as the TPU wrapper
does. The key mask gets no gradient. A remat'd block calls the forward and
backward wrappers itself (``models/modules.py``).

The packed wrappers take any head count of head_dim <= 128: a tensor rank's
share of a model's heads too. The TPU kernel's lane packing
(``packed_qkv_eligible``) is the JAX dispatch rule, which the models apply
on the model's head count; it is not a limit of the CUDA kernels.

A wrapper given a tensor on the CPU runs the plain version (``*_ref``); given
a CUDA tensor it launches its kernel or raises. The kernels mask the ragged
edge of N themselves, so unlike the TPU wrappers nothing is padded: keys past
N are excluded exactly as the TPU wrapper's padded keys are. On the GPU,
bf16/f16 inputs need a head_dim that is a multiple of 8 and rows aligned to
16 bytes (true of any qkv projection output); f32 inputs take a slower exact
kernel. In f16 the packed path's p = exp(min(s, 80)) overflows above s ~ 11
(the apps run float16 configs in bf16, as the JAX package does).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from avjepa_tpu_torch.ops._build import check, load_library
from avjepa_tpu_torch.ops.attention import xla_attention

NEG_INF = -1e30
BLOCK = 128
SOFTMAX_CLAMP = 80.0  # logit clamp of the packed path's no-max softmax
LANE = 128

# kernel launches since the last reset, one count per kernel; a wrapper adds
# one where it launches its kernel and nowhere else (a backward launch runs
# its kernel's two passes)
LAUNCHES = {"fwd_packed": 0, "fwd": 0, "bwd_packed": 0, "bwd": 0}
# forward launches (K1 and K3) since the last reset, by the design of the
# kernel each launched (fwd_design)
FWD_DESIGNS = {"ws": 0, "ring": 0, "fma": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for counts in (LAUNCHES, FWD_DESIGNS):
        for name in counts:
            counts[name] = 0


def fwd_design(dtype: torch.dtype, head_dim: int, clamped: bool) -> str:
    """The design of the forward kernel that a call launches, the rule of
    attention_fwd.cu's ``uses_ws`` and ``launch_16bit``: "fma" for f32;
    "ws" (warp-specialised: a TMA producer warp, an mbarrier ring and two
    ping-pong consumer warpgroups) for K1's numerics (``clamped``) at a tile
    width of 64 or 80 (32 < head_dim <= 80); else "ring" (the cp.async ring,
    several blocks a SM)."""
    if dtype == torch.float32:
        return "fma"
    return "ws" if clamped and 32 < head_dim <= 80 else "ring"


def _count_fwd(kind: str, dtype: torch.dtype, head_dim: int) -> None:
    """One forward launch of ``kind`` ("fwd_packed": K1, "fwd": K3)."""
    LAUNCHES[kind] += 1
    FWD_DESIGNS[fwd_design(dtype, head_dim, kind == "fwd_packed")] += 1


def _heads_per_block(head_dim: int) -> int:
    """Heads per 128-wide lane group in the TPU kernel (lcm(d, 128) / d).
    Kept so that the port takes the packed path exactly when the JAX
    package does."""
    return LANE // math.gcd(LANE, head_dim)


def packed_qkv_eligible(num_heads: int, head_dim: int) -> bool:
    hpb = _heads_per_block(head_dim)
    return head_dim <= LANE and hpb <= num_heads and num_heads % hpb == 0


def _key_bias(key_mask: torch.Tensor | None, b: int, n: int) -> torch.Tensor | None:
    """[B, N] bool mask (True = valid) or f32 additive bias -> f32 bias
    (0 for a valid key, -1e30 for a masked one)."""
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (b, n):
        raise ValueError(f"key_mask shape {tuple(key_mask.shape)} != {(b, n)}")
    if key_mask.dtype == torch.bool:
        return torch.where(key_mask, 0.0, NEG_INF).to(torch.float32)
    if key_mask.dtype != torch.float32:
        raise ValueError(f"key_mask must be bool or float32, got {key_mask.dtype}")
    return key_mask.contiguous()


# ---------------------------------------------------------------------------
# plain versions: the kernels' contracts in PyTorch
# ---------------------------------------------------------------------------


def flash_attention_qkv_ref(
    qkv: torch.Tensor,
    num_heads: int,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed kernel's contract: (out [B, N, C], lse [B, H, N] f32).

    q is scaled in f32 and rounded to the input type; logits are f32;
    p = exp(min(s, 80)) with no max; p is rounded to the input type for the
    PV product; out = acc / max(l, 1e-30), lse = log(max(l, 1e-30)). A
    masked key gives p = 0, so a row with no valid key gives exactly 0.
    """
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if scale is None:
        scale = d**-0.5
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    qs = (q.float() * scale).to(qkv.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    bias = _key_bias(key_mask, b, n)
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP))
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    acc = torch.matmul(p.to(qkv.dtype).float(), v.float())
    out = (acc / l).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, n, c), torch.log(l[..., 0])


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The classic kernel's contract: (out [B, H, N, d], lse [B, H, N] f32).

    s = q.k^T * scale (f32) + bias; p = exp(s - max s), rounded to the input
    type for the PV product; out = acc / max(l, 1e-30),
    lse = m + log(max(l, 1e-30)). A row with no valid key gives 0 (the
    kernel skips every tile of it).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = _key_bias(key_mask, q.shape[0], k.shape[2])
    if bias is not None:
        s = s + bias[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if bias is not None:
        p = torch.where(bias[:, None, None, :] > -1.0, p, 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _split_qkv(qkv: torch.Tensor, num_heads: int):
    b, n, c3 = qkv.shape
    d = c3 // (3 * num_heads)
    return qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def attention_delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, f32 [B, H, N], from [B, N, C] or
    [B, H, N, d] tensors (the TPU wrappers' softmax-correction term)."""
    prod = dout.float() * out.float()
    if prod.dim() == 4:
        return prod.sum(-1)
    b, n, c = prod.shape
    return prod.reshape(b, n, num_heads, c // num_heads).sum(-1).transpose(1, 2).contiguous()


def flash_attention_qkv_bwd_ref(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
    delta: torch.Tensor | None = None,
) -> torch.Tensor:
    """The packed backward kernel's contract: dqkv [B, N, 3C]. ``delta``
    defaults to ``attention_delta(out, dout)``.

    qs and ks are scaled in f32 and rounded to the input type;
    p = exp(min(s, 80) - lse); dv = T(p)^T.dO; ds = p * (dp - delta) where
    s < 80, else 0; dk = T(ds)^T.qs, dq = T(ds).ks; f32 sums, cast out.
    """
    b, n, c3 = qkv.shape
    dt = qkv.dtype
    d = c3 // (3 * num_heads)
    if scale is None:
        scale = d**-0.5
    q, k, v = _split_qkv(qkv, num_heads)
    do = dout.reshape(b, n, num_heads, d).transpose(1, 2).float()
    if delta is None:
        delta = attention_delta(out, dout, num_heads)
    qs = (q.float() * scale).to(dt).float()
    ks = (k.float() * scale).to(dt).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    bias = _key_bias(key_mask, b, n)
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP) - lse[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = torch.where(s < SOFTMAX_CLAMP, p * (dp - delta[..., None]), 0.0).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, ks)
    grads = torch.stack([dq, dk, dv], 2).to(dt)  # [B, H, 3, N, d]
    return grads.permute(0, 3, 2, 1, 4).reshape(b, n, c3)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The classic backward kernel's contract: (dq, dk, dv) [B, H, N, d].
    ``delta`` defaults to ``attention_delta(out, dout)``.

    p = exp(s * scale + bias - lse), 0 at masked keys (the kernel skips
    all-masked key tiles, and a masked key's p underflows to 0 elsewhere);
    ds = p * (dp - delta) * scale; dk = T(ds)^T.q, dq = T(ds).k,
    dv = T(p)^T.dO; f32 sums, cast out.
    """
    dt = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if delta is None:
        delta = attention_delta(out, dout, q.shape[1])
    do = dout.float()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = _key_bias(key_mask, q.shape[0], k.shape[2])
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    if bias is not None:
        p = torch.where(bias[:, None, None, :] > -1.0, p, 0.0)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along its last dim")


def _launch_args(bias: torch.Tensor | None) -> tuple[int | None, int]:
    return (bias.data_ptr(), bias.stride(0)) if bias is not None else (None, 0)


def _delta_kernel(lib, out: torch.Tensor, dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """attention_delta on the card (avj_attn_delta): f32 [B, H, N] from
    [B, N, C] or [B, H, N, d] out and dout, one kernel in place of torch's
    casts, product, sum and transpose."""
    out = out.contiguous()
    if out.shape != dout.shape or out.dtype != dout.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match dout")
    if out.dim() == 4:
        b, h, n, d = out.shape
        o_strides = (out.stride(0), out.stride(1), out.stride(2))
        d_strides = (dout.stride(0), dout.stride(1), dout.stride(2))
    else:
        b, n, c = out.shape
        h, d = num_heads, c // num_heads
        o_strides = (out.stride(0), d, out.stride(1))
        d_strides = (dout.stride(0), d, dout.stride(1))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=out.device)
    code = lib.avj_attn_delta(
        _DTYPE_CODES[out.dtype], out.data_ptr(), *o_strides, dout.data_ptr(), *d_strides,
        delta.data_ptr(), b, h, n, d, torch.cuda.current_stream().cuda_stream,
    )
    check(lib, code, "attn_delta")
    return delta


def _check_packed(qkv: torch.Tensor, num_heads: int) -> int:
    """head_dim of a packed qkv [B, N, 3 x num_heads x d]; raises unless the
    shape splits so, d <= 128 and the tensor is on the CPU or a GPU."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if c3 != 3 * c or c != num_heads * d or not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into {num_heads} heads "
                         f"of head_dim <= {_MAX_HEAD_DIM}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qkv must be a CPU or CUDA tensor, got {qkv.device}")
    return d


def flash_attention_qkv_fwd(
    qkv: torch.Tensor,
    num_heads: int,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed attention off the fused qkv: (out [B, N, C], lse [B, H, N])."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_packed(qkv, num_heads)
    if scale is None:
        scale = d**-0.5
    if qkv.device.type == "cpu":
        return flash_attention_qkv_ref(qkv, num_heads, key_mask, scale)
    _check_cuda(qkv, "qkv")
    bias = _key_bias(key_mask, b, n)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        code = lib.avj_attn_fwd_packed(
            _DTYPE_CODES[qkv.dtype], qkv.data_ptr(), qkv.stride(0), qkv.stride(1),
            out.data_ptr(), lse.data_ptr(), *_launch_args(bias),
            b, n, num_heads, d, scale, torch.cuda.current_stream().cuda_stream,
        )
    check(lib, code, "attn_fwd_packed")
    _count_fwd("fwd_packed", qkv.dtype, d)
    return out, lse


def flash_attention_qkv_bwd(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
    delta: torch.Tensor | None = None,
) -> torch.Tensor:
    """Backward of the packed attention: dqkv [B, N, 3C]. ``key_mask`` is
    the forward's (bool, or its f32 bias); ``delta`` (f32 [B, H, N]) is
    rowsum(dO * O), computed by ``avj_attn_delta`` when None."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * num_heads)
    if scale is None:
        scale = d**-0.5
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_ref(qkv, out, lse, dout, num_heads, key_mask, scale,
                                           delta)
    _check_cuda(qkv, "qkv")
    dout = dout.contiguous()
    if dout.shape != out.shape or dout.dtype != qkv.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match the output")
    bias = _key_bias(key_mask, b, n)
    lse = lse.contiguous()
    dqkv = torch.empty((b, n, c3), dtype=qkv.dtype, device=qkv.device)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        if delta is None:
            delta = _delta_kernel(lib, out, dout, num_heads)
        delta = delta.float().contiguous()
        code = lib.avj_attn_bwd_packed(
            _DTYPE_CODES[qkv.dtype], qkv.data_ptr(), qkv.stride(0), qkv.stride(1),
            dout.data_ptr(), dout.stride(0), dout.stride(1),
            lse.data_ptr(), delta.data_ptr(), *_launch_args(bias), dqkv.data_ptr(),
            b, n, num_heads, d, scale, torch.cuda.current_stream().cuda_stream,
        )
    check(lib, code, "attn_bwd_packed")
    LAUNCHES["bwd_packed"] += 1
    return dqkv


@torch.library.custom_op("avjepa::attn_fwd_packed", mutates_args=())
def _attn_fwd_packed_op(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_qkv_fwd(qkv, num_heads, bias, scale)


@_attn_fwd_packed_op.register_fake
def _(qkv, bias, num_heads, scale):
    b, n, c3 = qkv.shape
    return (qkv.new_empty((b, n, c3 // 3)),
            qkv.new_empty((b, num_heads, n), dtype=torch.float32))


def _packed_setup(ctx, inputs, output):
    qkv, bias, num_heads, scale = inputs
    ctx.save_for_backward(qkv, bias, *output)
    ctx.num_heads, ctx.scale = num_heads, scale


def _packed_backward(ctx, dout, _dlse):
    qkv, bias, out, lse = ctx.saved_tensors
    dqkv = flash_attention_qkv_bwd(qkv, out, lse, dout, ctx.num_heads, bias, ctx.scale)
    return dqkv, None, None, None


_attn_fwd_packed_op.register_autograd(_packed_backward, setup_context=_packed_setup)


def flash_attention_qkv(
    qkv: torch.Tensor,
    num_heads: int,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention straight off the fused qkv projection, differentiable, through
    the ``avjepa::attn_fwd_packed`` op (its backward is K2's).

    qkv: [B, N, 3*C] (feature packing [q | k | v], heads contiguous within
    each C), C = num_heads x head_dim, head_dim <= 128. Returns [B, N, C].
    """
    d = _check_packed(qkv, num_heads)
    bias = _key_bias(key_mask, qkv.shape[0], qkv.shape[1])
    return _attn_fwd_packed_op(qkv, bias, num_heads, d**-0.5 if scale is None else scale)[0]


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Classic flash attention over [B, H, N, d]: (out, lse [B, H, N])."""
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, key_mask, scale)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda(t, name)
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} differs from q in dtype or device")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    bias = _key_bias(key_mask, b, n)
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.avj_attn_fwd(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), lse.data_ptr(), *_launch_args(bias),
            b, h, n, d, scale, torch.cuda.current_stream().cuda_stream,
        )
    check(lib, code, "attn_fwd")
    _count_fwd("fwd", q.dtype, d)
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the classic attention: (dq, dk, dv) [B, H, N, d];
    ``delta`` as for ``flash_attention_qkv_bwd``."""
    b, h, n, d = q.shape
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, key_mask, scale, delta)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda(t, name)
    dout = dout.contiguous()
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match q")
    bias = _key_bias(key_mask, b, n)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=q.device) for _ in range(3))
    lib = load_library()
    with torch.cuda.device(q.device):
        if delta is None:
            delta = _delta_kernel(lib, out, dout, h)
        delta = delta.float().contiguous()
        code = lib.avj_attn_bwd(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), *_launch_args(bias),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, d, scale, torch.cuda.current_stream().cuda_stream,
        )
    check(lib, code, "attn_bwd")
    LAUNCHES["bwd"] += 1
    return dq, dk, dv


@torch.library.custom_op("avjepa::attn_fwd", mutates_args=())
def _attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, bias, scale)


@_attn_fwd_op.register_fake
def _(q, k, v, bias, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:-1], dtype=torch.float32)


def _classic_setup(ctx, inputs, output):
    q, k, v, bias, scale = inputs
    ctx.save_for_backward(q, k, v, bias, *output)
    ctx.scale = scale


def _classic_backward(ctx, dout, _dlse):
    q, k, v, bias, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, bias, ctx.scale)
    return dq, dk, dv, None, None


_attn_fwd_op.register_autograd(_classic_backward, setup_context=_classic_setup)


def classic_kernel_eligible(head_dim: int, n: int) -> bool:
    """Whether ``flash_attention`` launches the classic kernel (else the
    plain path), as the JAX package decides."""
    return head_dim % 8 == 0 and n >= BLOCK


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """[B, H, N, Dh] attention, differentiable; takes the plain path for head
    dims not divisible by 8 and sequences shorter than 128, as the JAX
    package does."""
    d, n = q.shape[-1], q.shape[-2]
    if not classic_kernel_eligible(d, n):
        return xla_attention(q, k, v, key_mask=key_mask, scale=scale)
    bias = _key_bias(key_mask, q.shape[0], n)
    return _attn_fwd_op(q, k, v, bias, d**-0.5 if scale is None else scale)[0]
