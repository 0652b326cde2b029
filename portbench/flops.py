"""The work of a step, counted from the model's shapes and the masks handed in.

Model FLOPs (for ``mfu.*``): every linear layer 2 x tokens x in x out, and
attention 4 x heads x head_dim x queries x keys a sample (q.k and p.v),
counted on the tokens that take part: every token in the target encoder,
the kept tokens in a context encoder, the context and target tokens in the
predictor, whose output projection serves the targets alone. A backward
pass counts twice its forward (the gradients of the inputs and of the
weights), except the patch embeds, whose inputs are data (once). LayerNorm,
GELU, the softmax and the optimizer are left out, and so is what remat and
bucket padding compute again or in vain.

Attention work (for ``attn_roofline_pct.*``), the arithmetic of the port's
kernel table: a forward call does 4 x H x d x T^2 operations a sample and
moves q, k, v and out (2 bytes an element in bf16) and the log-sum-exp (4
bytes a row and head); a backward call does 10 x H x d x T^2 (the scores
formed again, and four products) and moves q, k, v, out, dout, dq, dk, dv,
the log-sum-exp and the row sums of dout * out. Its least time is the
larger of operations over the peak rate and bytes over the peak bandwidth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.vit import ModelSpec


@dataclasses.dataclass(frozen=True)
class MaskCounts:
    """Tokens a sample of one mask config: context (video part), targets."""

    ctx: int
    ctx_video: int
    pred: int

    @property
    def union(self) -> int:
        return self.ctx + self.pred


def mask_counts(enc: np.ndarray, pred: np.ndarray, num_video_tokens: int) -> MaskCounts:
    """From dense [B, N] masks whose rows hold equal counts."""
    ctx = enc.sum(1)
    if not (ctx == ctx[0]).all() or not (pred.sum(1) == pred.sum(1)[0]).all():
        raise ValueError("mask rows hold different token counts")
    return MaskCounts(int(ctx[0]), int(enc[0, :num_video_tokens].sum()), int(pred[0].sum()))


@dataclasses.dataclass
class AttnCall:
    """One attention call over ``batch`` samples of ``tokens`` valid tokens."""

    batch: int
    tokens: int
    heads: int
    head_dim: int
    backward: bool

    def ops(self) -> float:
        return (10 if self.backward else 4) * self.heads * self.head_dim * self.batch * \
            float(self.tokens) ** 2

    def bytes(self, elt: int = 2) -> float:
        rows = self.batch * self.tokens * self.heads * self.head_dim
        stats = self.batch * self.heads * self.tokens * 4
        return (8 * rows * elt + 2 * stats) if self.backward else (4 * rows * elt + stats)

    def least_s(self, peak_flops: float, peak_bytes: float) -> float:
        return max(self.ops() / peak_flops, self.bytes() / peak_bytes)


def tower_flops(batch: int, tokens: int, dim: int, depth: int, mlp_ratio: float) -> float:
    """Forward FLOPs of ``depth`` blocks over ``tokens`` tokens a sample."""
    gemm = 2.0 * batch * tokens * dim * dim * (4 + 2 * mlp_ratio)
    attn = 4.0 * batch * float(tokens) ** 2 * dim
    return depth * (gemm + attn)


def embed_flops(s: ModelSpec, batch: int, video_tokens: int, audio_tokens: int) -> float:
    """Forward FLOPs of the tubelet and spectrogram embeds."""
    p = s.patch_size
    return 2.0 * batch * s.embed_dim * (video_tokens * 3 * s.tubelet_size * p * p
                                        + audio_tokens * p * p)


def encode_flops(s: ModelSpec, batch: int) -> float:
    """One forward of the encoder over every token."""
    return (embed_flops(s, batch, s.num_video_tokens, s.num_audio_tokens)
            + tower_flops(batch, s.num_tokens, s.embed_dim, s.depth, s.mlp_ratio))


def train_flops(s: ModelSpec, batch: int, masks: list[MaskCounts]) -> float:
    """Model FLOPs of one train step."""
    total = encode_flops(s, batch)  # the target encoder, forward only
    d, dp = s.embed_dim, s.pred_embed_dim
    for m in masks:
        total += 2 * embed_flops(s, batch, m.ctx_video, m.ctx - m.ctx_video)
        total += 3 * tower_flops(batch, m.ctx, d, s.depth, s.mlp_ratio)
        pred = (2.0 * batch * m.ctx * d * dp
                + tower_flops(batch, m.union, dp, s.pred_depth, 4.0)
                + 2.0 * batch * m.pred * dp * d)
        total += 3 * pred
    return total


def train_attention(s: ModelSpec, batch: int, masks: list[MaskCounts]) -> list[AttnCall]:
    """The attention calls of one train step, a call a layer and pass."""
    hd, phd = s.embed_dim // s.num_heads, s.pred_embed_dim // s.pred_num_heads
    calls = [AttnCall(batch, s.num_tokens, s.num_heads, hd, False)] * s.depth
    for m in masks:
        for bwd in (False, True):
            calls += [AttnCall(batch, m.ctx, s.num_heads, hd, bwd)] * s.depth
            calls += [AttnCall(batch, m.union, s.pred_num_heads, phd, bwd)] * s.pred_depth
    return calls


def encode_attention(s: ModelSpec, batch: int) -> list[AttnCall]:
    hd = s.embed_dim // s.num_heads
    return [AttnCall(batch, s.num_tokens, s.num_heads, hd, False)] * s.depth


def launches_match(calls: list[AttnCall], s: ModelSpec, num_configs: int, fwd: int,
                   bwd: int) -> bool:
    """Whether the program's launch counts ``fwd`` and ``bwd`` (a step) are
    those of ``calls``: one a call, or one a predictor layer for all the mask
    configs together (the predictor may batch the configs as one)."""
    n_fwd = sum(not c.backward for c in calls)
    n_bwd = len(calls) - n_fwd
    merged = (num_configs - 1) * s.pred_depth if num_configs > 1 else 0
    return (fwd, bwd) in ((n_fwd, n_bwd), (n_fwd - merged, n_bwd - merged))
