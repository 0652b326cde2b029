"""Softmax attention in float32, computed in blocks of queries.

softmax(q k^T / sqrt(d)) v over every key, with a row-wise max, for q, k, v
of [B, H, N, d]. The scores of one block of queries of one group of samples
are formed at a time, so that a sequence of 4608 tokens needs no [N, N]
matrix per head at once. The backward pass forms each block's
probabilities again from the saved log-sum-exp and returns dq, dk, dv.
No key is masked: the reference gathers the tokens that take part first.
"""

from __future__ import annotations

import torch

# score elements formed at once: 2**27 float32 numbers, 512 MiB
SCORE_BUDGET = 1 << 27


def _blocks(b: int, h: int, n: int, nk: int):
    """(sample slice, query slice) pairs covering [b, n] within the budget."""
    per_sample = h * n * nk
    if per_sample <= SCORE_BUDGET:
        step = max(1, SCORE_BUDGET // per_sample)
        for s in range(0, b, step):
            yield slice(s, min(b, s + step)), slice(0, n)
        return
    rows = max(1, SCORE_BUDGET // (h * nk))
    for s in range(b):
        for r in range(0, n, rows):
            yield slice(s, s + 1), slice(r, min(n, r + rows))


class BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        b, h, n, d = q.shape
        scale = d ** -0.5
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for bs, rs in _blocks(b, h, n, k.shape[2]):
            s = torch.matmul(q[bs, :, rs], k[bs].transpose(-1, -2)) * scale
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            out[bs, :, rs] = torch.matmul(p, v[bs]) / l
            lse[bs, :, rs] = (m + torch.log(l)).squeeze(-1)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, n, d = q.shape
        scale = d ** -0.5
        delta = (dout * out).sum(-1)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for bs, rs in _blocks(b, h, n, k.shape[2]):
            s = torch.matmul(q[bs, :, rs], k[bs].transpose(-1, -2)) * scale
            p = torch.exp(s - lse[bs, :, rs, None])
            do = dout[bs, :, rs]
            dv[bs] += torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, v[bs].transpose(-1, -2)) - delta[bs, :, rs, None])
            dq[bs, :, rs] = torch.matmul(ds, k[bs]) * scale
            dk[bs] += torch.matmul(ds.transpose(-1, -2), q[bs, :, rs]) * scale
        return dq, dk, dv


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return BlockAttention.apply(q, k, v)
