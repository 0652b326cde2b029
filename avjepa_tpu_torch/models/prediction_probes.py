"""Pixel/spectrogram reconstruction probes for the avprediction app.

Counterpart of ``avjepa_tpu/models/prediction_probes.py:24-321`` (reference:
src/models/prediction_probes.py). ``AttentionProbe`` is the probe the app
trains; the other seven are kept for parity with the JAX package. Every probe
is parameterized by the token layout; outputs are channels-last, as in the
JAX package: video [B, T, H, W, 3], audio [B, Hs, Ws, 1].

Module and parameter names are the flax leaf names (``input_proj``,
``video_query``, ``v_attn_in``, ``to_video``, ...), so
``utils/torch_import.probe_params_to_state_dict`` loads flax probe params
strictly. Flax infers input widths at init; here they are constructor
arguments (``emb_dim``, ``seq_len``). Convolutions run channels-first inside
and give the flax channels-last layout back before any flatten.

The probes' attention is the plain masked softmax (``xla_attention``: f32
logits, f32 softmax, probabilities cast to v's type), not a kernel, as in
the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.models.factory import clipped_normal_
from avjepa_tpu_torch.models.modules import layer_norm, linear
from avjepa_tpu_torch.ops.attention import xla_attention


def _conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d/Conv2d with 'SAME' padding (odd kernels), in x's dtype."""
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    conv = F.conv1d if w.dim() == 3 else F.conv2d
    return conv(x, w, b, padding=w.shape[-1] // 2)


def _mha(q: torch.Tensor, kv: torch.Tensor, in_proj: nn.Linear, out_proj: nn.Linear,
         num_heads: int) -> torch.Tensor:
    """torch nn.MultiheadAttention's shape (JAX ``_mha``,
    prediction_probes.py:24-36): ONE in-projection of 3d features applied to
    q and to kv, q taking its first third and k, v the second and third."""
    b, nq, d = q.shape
    nk = kv.shape[1]
    dh = d // num_heads
    qp = linear(in_proj, q)
    kvp = qp if kv is q else linear(in_proj, kv)

    def heads(t, n):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    out = xla_attention(heads(qp[..., :d], nq), heads(kvp[..., d:2 * d], nk),
                        heads(kvp[..., 2 * d:], nk))
    return linear(out_proj, out.transpose(1, 2).reshape(b, nq, d))


class AttentionProbe(nn.Module):
    """Per-modality self-attention + learned-query cross-attention decoder
    (JAX :39-107, reference :278-348). The audio output reshape is the JAX
    package's ([B, 12, Hs*16] -> [B, 12, Hs, 16] -> [B, Hs, 12, 16] ->
    [B, Hs, 192, 1]: 12 width segments side by side), not the reference's."""

    def __init__(self, layout: TokenLayout, emb_dim: int = 384, hidden_dim: int = 256,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.num_heads, self.dtype = lo, num_heads, dtype
        self.input_proj = nn.Linear(emb_dim, hidden_dim)
        self.video_query = nn.Parameter(torch.zeros(1, lo.num_frames, hidden_dim))
        self.audio_query = nn.Parameter(torch.zeros(1, lo.wa_grid, hidden_dim))
        self.v_attn_in = nn.Linear(hidden_dim, 3 * hidden_dim)
        self.v_attn_out = nn.Linear(hidden_dim, hidden_dim)
        if lo.audio_enabled:
            self.a_attn_in = nn.Linear(hidden_dim, 3 * hidden_dim)
            self.a_attn_out = nn.Linear(hidden_dim, hidden_dim)
        self.to_video = nn.Linear(hidden_dim, 3 * lo.crop_size * lo.crop_size)
        if lo.audio_enabled:
            self.to_audio = nn.Linear(hidden_dim, lo.spec_height * (lo.spec_width // lo.wa_grid))

    def _decode(self, x, query, attn_in, attn_out):
        x = _mha(x, x, attn_in, attn_out, self.num_heads)
        q = query.to(self.dtype).expand(x.shape[0], -1, -1)
        return _mha(q, x, attn_in, attn_out, self.num_heads)

    def forward(self, x: torch.Tensor):
        lo = self.layout
        x = x.to(self.dtype)
        b, nv, crop = x.shape[0], lo.num_video_tokens, lo.crop_size
        vf = self._decode(linear(self.input_proj, x[:, :nv]), self.video_query,
                          self.v_attn_in, self.v_attn_out)
        video_out = linear(self.to_video, vf).reshape(b, lo.num_frames, 3, crop, crop)
        video_out = video_out.permute(0, 1, 3, 4, 2)  # [B, T, H, W, 3]
        if not lo.audio_enabled:
            return video_out, None
        af = self._decode(linear(self.input_proj, x[:, nv:]), self.audio_query,
                          self.a_attn_in, self.a_attn_out)
        n_seg = lo.wa_grid
        audio_out = linear(self.to_audio, af).reshape(b, n_seg, lo.spec_height,
                                                      lo.spec_width // n_seg)
        return video_out, audio_out.permute(0, 2, 1, 3).reshape(b, lo.spec_height,
                                                                lo.spec_width, 1)


def _video(x: torch.Tensor, lo: TokenLayout) -> torch.Tensor:
    return x.reshape(x.shape[0], lo.num_frames, lo.crop_size, lo.crop_size, 3)


class LinearProbe(nn.Module):
    """3-layer MLP over flattened tokens -> full video (JAX :110-130)."""

    def __init__(self, layout: TokenLayout, seq_len: int, emb_dim: int = 384,
                 hidden_1: int = 2048, hidden_2: int = 800, dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.dtype = lo, dtype
        self.fc1 = nn.Linear(seq_len * emb_dim, hidden_1)
        self.fc2 = nn.Linear(hidden_1, hidden_2)
        self.fc3 = nn.Linear(hidden_2, lo.num_frames * 3 * lo.crop_size * lo.crop_size)

    def forward(self, x):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        x = F.relu(linear(self.fc2, F.relu(linear(self.fc1, x))))
        return _video(linear(self.fc3, x), self.layout)


class PoolingProbe(nn.Module):
    """Mean-pool tokens -> MLP -> video (JAX :133-152)."""

    def __init__(self, layout: TokenLayout, emb_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.dtype = lo, dtype
        self.feat1 = nn.Linear(emb_dim, 256)
        self.feat2 = nn.Linear(256, 256)
        self.proj1 = nn.Linear(256, 512)
        self.proj2 = nn.Linear(512, lo.num_frames * 3 * lo.crop_size * lo.crop_size)

    def forward(self, x):
        x = F.relu(linear(self.feat2, F.relu(linear(self.feat1, x.to(self.dtype)))))
        x = F.relu(linear(self.proj1, x.mean(1)))
        return _video(linear(self.proj2, x), self.layout)


class FactorizedProbe(nn.Module):
    """Temporal compression then feature expansion (JAX :155-177)."""

    def __init__(self, layout: TokenLayout, seq_len: int, emb_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.dtype = lo, dtype
        self.temporal_compress = nn.Linear(seq_len, lo.num_frames)
        self.ft1 = nn.Linear(emb_dim, 256)
        self.ft2 = nn.Linear(256, lo.crop_size)
        self.final = nn.Linear(1, 3 * lo.crop_size)

    def forward(self, x):
        lo = self.layout
        x = linear(self.temporal_compress, x.to(self.dtype).transpose(1, 2)).transpose(1, 2)
        x = linear(self.ft2, F.relu(linear(self.ft1, x)))  # [B, T, H]
        x = linear(self.final, x[..., None])  # [B, T, H, 3 * W]
        return x.reshape(x.shape[0], lo.num_frames, lo.crop_size, 3,
                         lo.crop_size).permute(0, 1, 2, 4, 3)


class ConvTemporalProbe(nn.Module):
    """1-D temporal convs + adaptive pool -> per-frame projection (JAX
    :180-200)."""

    def __init__(self, layout: TokenLayout, emb_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.dtype = lo, dtype
        self.conv1 = nn.Conv1d(emb_dim, 256, 3)
        self.conv2 = nn.Conv1d(256, 256, 3)
        self.to_video = nn.Linear(256, 3 * lo.crop_size * lo.crop_size)

    def forward(self, x):
        x = x.to(self.dtype).transpose(1, 2)  # [B, D, N]
        x = F.relu(_conv(self.conv2, F.relu(_conv(self.conv1, x)))).transpose(1, 2)
        n, t = x.shape[1], self.layout.num_frames
        # t nearly-equal chunks (AdaptiveAvgPool1d), the JAX package's bounds
        bounds = [(int(i * n / t), max(int(i * n / t) + 1, int((i + 1) * n / t)))
                  for i in range(t)]
        pooled = torch.stack([x[:, s:e].mean(1) for s, e in bounds], 1)
        return _video(linear(self.to_video, pooled), self.layout)


class ConvolutionalProbe(nn.Module):
    """Project tokens, reshape to a [plane, M] single-channel map, 2-D convs,
    per-frame projection to video (JAX :203-230)."""

    def __init__(self, layout: TokenLayout, seq_len: int, emb_dim: int = 384,
                 dtype: torch.dtype = torch.float32, plane: int = 32):
        super().__init__()
        lo = layout
        self.layout, self.dtype, self.plane = lo, dtype, plane
        self.initial_project = nn.Linear(emb_dim, 256)
        self.conv1 = nn.Conv2d(1, 16, 3)
        self.conv2 = nn.Conv2d(16, 32, 3)
        self.conv3 = nn.Conv2d(32, 48, 3)
        self.to_frames = nn.Linear(seq_len * 256 * 48, lo.num_frames * 256)
        self.to_video = nn.Linear(256, 3 * lo.crop_size * lo.crop_size)

    def forward(self, x):
        b = x.shape[0]
        x = linear(self.initial_project, x.to(self.dtype))  # [B, N, 256]
        x = x.reshape(b, 1, self.plane, -1)  # channels-first of flax's [B, plane, M, 1]
        x = F.relu(_conv(self.conv2, F.relu(_conv(self.conv1, x))))
        x = _conv(self.conv3, x).permute(0, 2, 3, 1).reshape(b, -1)  # flax's NHWC order
        x = linear(self.to_frames, x).reshape(b, self.layout.num_frames, 256)
        return _video(linear(self.to_video, x), self.layout)


class ProgressiveProbe(nn.Module):
    """Compress all tokens, seed a coarse plane, conv and upsample x8 to the
    full crop, broadcast over time (JAX :233-267)."""

    def __init__(self, layout: TokenLayout, seq_len: int, emb_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        self.layout, self.dtype = lo, dtype
        self.base = lo.crop_size // 8
        self.compress = nn.Linear(seq_len * emb_dim, 1024)
        self.to_4d = nn.Linear(1024, 16 * self.base * self.base)
        self.up1 = nn.Conv2d(16, 32, 3)
        self.up2 = nn.Conv2d(32, 32, 3)
        self.up3 = nn.Conv2d(32, 16, 3)
        self.to_rgb = nn.Conv2d(16, 3, 3)

    def forward(self, x):
        b = x.shape[0]
        x = linear(self.compress, x.to(self.dtype).reshape(b, -1))
        x = linear(self.to_4d, x).reshape(b, self.base, self.base, 16).permute(0, 3, 1, 2)

        def up2(y):
            return y.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        x = up2(F.relu(_conv(self.up1, x)))
        x = up2(F.relu(_conv(self.up2, x)))
        x = up2(F.relu(_conv(self.up3, x)))
        x = _conv(self.to_rgb, x).permute(0, 2, 3, 1)  # [B, H, W, 3]
        return x[:, None].expand(b, self.layout.num_frames, *x.shape[1:])


class AttentiveProbe(nn.Module):
    """Learned per-frame queries cross-attend over the embedding, then a
    per-frame projection to pixels (JAX :270-309); depth > 1 adds post-LN
    self-attention + FFN blocks (torch TransformerEncoderLayer's shape)."""

    def __init__(self, layout: TokenLayout, emb_dim: int = 384, num_heads: int = 12,
                 depth: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        lo = layout
        d = emb_dim
        self.layout, self.num_heads, self.depth, self.dtype = lo, num_heads, depth, dtype
        self.query_tokens = nn.Parameter(torch.zeros(1, lo.num_frames, d))
        self.in_proj = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        for i in range(depth - 1):
            setattr(self, f"blk{i}_in", nn.Linear(d, 3 * d))
            setattr(self, f"blk{i}_out", nn.Linear(d, d))
            setattr(self, f"blk{i}_ln1", nn.LayerNorm(d, eps=1e-6))
            setattr(self, f"blk{i}_ff1", nn.Linear(d, 4 * d))
            setattr(self, f"blk{i}_ff2", nn.Linear(4 * d, d))
            setattr(self, f"blk{i}_ln2", nn.LayerNorm(d, eps=1e-6))
        self.linear = nn.Linear(d, 3 * lo.crop_size * lo.crop_size)

    def forward(self, x):
        if x.dim() == 2:
            x = x[:, None, :]  # pooled embeddings
        b = x.shape[0]
        q = self.query_tokens.to(self.dtype).expand(b, -1, -1)
        q = _mha(q, x.to(self.dtype), self.in_proj, self.out_proj, self.num_heads)
        for i in range(self.depth - 1):
            blk = lambda name: getattr(self, f"blk{i}_{name}")  # noqa: E731
            y = _mha(q, q, blk("in"), blk("out"), self.num_heads)
            q = layer_norm(blk("ln1"), q + y)
            y = linear(blk("ff2"), F.relu(linear(blk("ff1"), q)))
            q = layer_norm(blk("ln2"), q + y)
        return _video(linear(self.linear, q), self.layout)


PROBES = {
    "attention": AttentionProbe,
    "linear": LinearProbe,
    "pooling": PoolingProbe,
    "factorized": FactorizedProbe,
    "conv_temporal": ConvTemporalProbe,
    "convolutional": ConvolutionalProbe,
    "progressive": ProgressiveProbe,
    "attentive": AttentiveProbe,
}


@torch.no_grad()
def init_probe_(probe: nn.Module, seed: int) -> nn.Module:
    """Init in place, drawing in parameter order from one CPU generator, from
    the JAX probes' distributions: zero biases, unit LayerNorm weights,
    N(0, 1) ``video_query``/``audio_query``, clipped N(0, 0.02)
    ``input_proj`` and ``query_tokens``, and flax's default lecun normal
    (truncated at 2 std, std sqrt(1 / fan_in) / 0.8796) for every other
    weight."""
    g = torch.Generator().manual_seed(seed)
    norms = {f"{name}.weight" for name, m in probe.named_modules()
             if isinstance(m, nn.LayerNorm)}
    for name, p in probe.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name in norms:
            p.fill_(1.0)
        elif name in ("video_query", "audio_query"):
            p.copy_(torch.randn(p.shape, generator=g))
        elif name in ("query_tokens", "input_proj.weight"):
            clipped_normal_(p, g)
        else:
            fan_in = p.shape[1] * math.prod(p.shape[2:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std,
                                                2 * std, generator=g))
    return probe
