"""The plain float32 reference of the JEPA encoder and predictor.

Written from the published architecture (V-JEPA, arXiv:2404.08471; the
AV-JEPA audio branch), in plain PyTorch over a dict of parameters named by
the reference state-dict keys:

- the video tubelet embed is a 3-D convolution of stride (t, p, p) over
  [B, 3, T, H, W], the spectrogram's a 2-D convolution of stride p; tokens
  in (t, h, w) and then (h, w) raster order, video first;
- fixed sin-cos position tables: 3-D for video (the ``uniform_power`` split of
  ceil(D/6)*2 channels an axis, cut to D, or D/2-D/4-D/4), 2-D for the
  spectrogram (rows, then columns), added after the embed;
- pre-LN blocks: x + proj(attn(LN1 x)), x + fc2(gelu(fc1(LN2 x))), LN
  epsilon 1e-6, softmax attention over the tokens taken in (``attention.py``);
  a final LN;
- the predictor: the context tokens embedded to the predictor width (a
  linear for video tokens, another for audio), a learnt mask token of the
  mask config at every target position, its own sin-cos tables, pre-LN
  blocks, a final LN and a projection back to the encoder width.

Only the tokens that take part are computed: the context encoder takes the
kept tokens, the predictor the context and target tokens, in that order. With
gradients on, each block is recomputed in the backward pass
(``torch.utils.checkpoint``) so that the activations of a full-size step fit.

``Numerics`` rounds the operands of every product and every tensor a layer
hands on (the LayerNorms', the products', the GELU's, the attention's output,
the residual stream), where a model computed in a lower precision rounds
them: not at all in float32 (TF32 must be off), to bfloat16, or to float8
e4m3 with one scale a tensor (the control of the benchmark's comparison).
Products accumulate in float32 either way.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference.attention import attention

LN_EPS = 1e-6
FP8_MAX = 448.0  # largest float8 e4m3fn number


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The widths of one configuration (the ``model`` object of its file)."""

    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float
    pred_embed_dim: int
    pred_depth: int
    pred_num_heads: int
    patch_size: int
    tubelet_size: int
    num_frames: int
    crop_size: int
    spec_height: Optional[int]  # None: video only
    spec_width: Optional[int]
    uniform_power: bool
    gelu: str  # 'tanh' or 'exact'
    num_mask_tokens: int

    @classmethod
    def from_json(cls, d: dict) -> "ModelSpec":
        audio = d.get("audio") or {}
        return cls(
            embed_dim=d["embed_dim"], depth=d["depth"], num_heads=d["num_heads"],
            mlp_ratio=float(d["mlp_ratio"]), pred_embed_dim=d["pred_embed_dim"],
            pred_depth=d["pred_depth"], pred_num_heads=d["pred_num_heads"],
            patch_size=d["patch_size"], tubelet_size=d["tubelet_size"],
            num_frames=d["num_frames"], crop_size=d["crop_size"],
            spec_height=audio.get("spec_height"), spec_width=audio.get("spec_width"),
            uniform_power=bool(d["uniform_power"]), gelu=d["gelu"],
            num_mask_tokens=d["num_mask_tokens"],
        )

    @property
    def grid(self) -> int:
        return self.crop_size // self.patch_size

    @property
    def t_grid(self) -> int:
        return self.num_frames // self.tubelet_size

    @property
    def num_video_tokens(self) -> int:
        return self.t_grid * self.grid * self.grid

    @property
    def audio(self) -> bool:
        return self.spec_height is not None

    @property
    def audio_grid(self) -> tuple[int, int]:
        if not self.audio:
            return (0, 0)
        return (self.spec_height // self.patch_size, self.spec_width // self.patch_size)

    @property
    def num_audio_tokens(self) -> int:
        ha, wa = self.audio_grid
        return ha * wa

    @property
    def num_tokens(self) -> int:
        return self.num_video_tokens + self.num_audio_tokens


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    name: str
    shape: tuple[int, ...]
    kind: str  # 'weight' (normal), 'bias', 'norm_weight', 'norm_bias', 'token'
    rescale: float = 1.0  # the weight's std is divided by this


def _block_params(prefix: str, d: int, hidden: int, layer: int) -> list[ParamSpec]:
    r = math.sqrt(2.0 * (layer + 1))  # the per-layer rescale of proj and fc2
    return [
        ParamSpec(f"{prefix}.norm1.weight", (d,), "norm_weight"),
        ParamSpec(f"{prefix}.norm1.bias", (d,), "norm_bias"),
        ParamSpec(f"{prefix}.attn.qkv.weight", (3 * d, d), "weight"),
        ParamSpec(f"{prefix}.attn.qkv.bias", (3 * d,), "bias"),
        ParamSpec(f"{prefix}.attn.proj.weight", (d, d), "weight", r),
        ParamSpec(f"{prefix}.attn.proj.bias", (d,), "bias"),
        ParamSpec(f"{prefix}.norm2.weight", (d,), "norm_weight"),
        ParamSpec(f"{prefix}.norm2.bias", (d,), "norm_bias"),
        ParamSpec(f"{prefix}.mlp.fc1.weight", (hidden, d), "weight"),
        ParamSpec(f"{prefix}.mlp.fc1.bias", (hidden,), "bias"),
        ParamSpec(f"{prefix}.mlp.fc2.weight", (d, hidden), "weight", r),
        ParamSpec(f"{prefix}.mlp.fc2.bias", (d,), "bias"),
    ]


def encoder_params(s: ModelSpec) -> list[ParamSpec]:
    d, p = s.embed_dim, s.patch_size
    out = [ParamSpec("patch_embed.proj.weight", (d, 3, s.tubelet_size, p, p), "weight"),
           ParamSpec("patch_embed.proj.bias", (d,), "bias")]
    if s.audio:
        out += [ParamSpec("patch_embed.audio_proj.weight", (d, 1, p, p), "weight"),
                ParamSpec("patch_embed.audio_proj.bias", (d,), "bias")]
    for i in range(s.depth):
        out += _block_params(f"blocks.{i}", d, int(d * s.mlp_ratio), i)
    return out + [ParamSpec("norm.weight", (d,), "norm_weight"),
                  ParamSpec("norm.bias", (d,), "norm_bias")]


def predictor_params(s: ModelSpec) -> list[ParamSpec]:
    d, dp = s.embed_dim, s.pred_embed_dim
    streams = ["v", "a"] if s.audio else ["v"]
    out = []
    for st in streams:
        out += [ParamSpec(f"predictor_embed_{st}.weight", (dp, d), "weight"),
                ParamSpec(f"predictor_embed_{st}.bias", (dp,), "bias")]
        out += [ParamSpec(f"mask_tokens_{st}.{j}", (1, 1, dp), "token")
                for j in range(s.num_mask_tokens)]
    for i in range(s.pred_depth):
        out += _block_params(f"predictor_blocks.{i}", dp, int(dp * 4), i)
    return out + [ParamSpec("predictor_norm.weight", (dp,), "norm_weight"),
                  ParamSpec("predictor_norm.bias", (dp,), "norm_bias"),
                  ParamSpec("predictor_proj.weight", (d, dp), "weight"),
                  ParamSpec("predictor_proj.bias", (d,), "bias")]


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


class Numerics:
    """How tensors are rounded: 'float32' (not at all), 'bfloat16', or 'fp8'
    (float8 e4m3fn, one scale a tensor that maps its largest magnitude to
    448). The values stay float32 tensors; the gradient passes straight
    through."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"numerics {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        xd = x.detach()
        if self.kind == "bfloat16":
            q = xd.to(torch.bfloat16).to(x.dtype)
        else:
            scale = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
            q = (xd * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (q - xd) if x.requires_grad else q


def linear(x, w, b, num: Numerics):
    return num(F.linear(num(x), num(w), b))


def layer_norm(x, w, b, num: Numerics):
    return num(F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS))


# ---------------------------------------------------------------------------
# position tables
# ---------------------------------------------------------------------------


def _sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = pos.astype(np.float64).reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=8)
def position_table(s: ModelSpec, dim: int) -> np.ndarray:
    """[num_tokens, dim]: the video rows, then the spectrogram rows."""
    tt, hh, ww = np.meshgrid(np.arange(s.t_grid), np.arange(s.grid), np.arange(s.grid),
                             indexing="ij")
    if s.uniform_power:
        dd = hd = wd = int(math.ceil(dim / 6) * 2)
    else:
        dd, hd, wd = dim // 2, dim // 4, dim // 4
    video = np.concatenate([_sincos(dd, tt), _sincos(hd, hh), _sincos(wd, ww)], 1)[:, :dim]
    if not s.audio:
        return video
    ha, wa = s.audio_grid
    ah, aw = np.meshgrid(np.arange(ha), np.arange(wa), indexing="ij")
    audio = np.concatenate([_sincos(dim // 2, ah), _sincos(dim // 2, aw)], 1)
    return np.concatenate([video, audio], 0)


def _table(s: ModelSpec, dim: int, device) -> torch.Tensor:
    return torch.from_numpy(position_table(s, dim)).to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def _gelu(x, kind: str):
    return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")


def block(p: dict, prefix: str, x: torch.Tensor, heads: int, gelu: str,
          num: Numerics) -> torch.Tensor:
    b, n, d = x.shape
    h = layer_norm(x, p[f"{prefix}.norm1.weight"], p[f"{prefix}.norm1.bias"], num)
    qkv = linear(h, p[f"{prefix}.attn.qkv.weight"], p[f"{prefix}.attn.qkv.bias"], num)
    q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)
    o = num(attention(q, k, v).transpose(1, 2).reshape(b, n, d))
    x = num(x + linear(o, p[f"{prefix}.attn.proj.weight"], p[f"{prefix}.attn.proj.bias"], num))
    h = layer_norm(x, p[f"{prefix}.norm2.weight"], p[f"{prefix}.norm2.bias"], num)
    h = num(_gelu(linear(h, p[f"{prefix}.mlp.fc1.weight"], p[f"{prefix}.mlp.fc1.bias"], num),
                  gelu))
    return num(x + linear(h, p[f"{prefix}.mlp.fc2.weight"], p[f"{prefix}.mlp.fc2.bias"], num))


def _blocks(p: dict, prefix: str, depth: int, x, heads: int, gelu: str, num: Numerics):
    for i in range(depth):
        def f(y, i=i):
            return block(p, f"{prefix}.{i}", y, heads, gelu, num)
        x = torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False) \
            if torch.is_grad_enabled() else f(x)
    return x


def embed_tokens(p: dict, s: ModelSpec, video: torch.Tensor, audio: Optional[torch.Tensor],
                 num: Numerics) -> torch.Tensor:
    """[B, N, D]: the tubelet and spectrogram embeds plus their tables.
    video [B, T, H, W, 3], audio [B, Hs, Ws, 1]."""
    t, ps = s.tubelet_size, s.patch_size
    x = F.conv3d(num(video.permute(0, 4, 1, 2, 3)), num(p["patch_embed.proj.weight"]),
                 p["patch_embed.proj.bias"], stride=(t, ps, ps))
    x = num(x.flatten(2).transpose(1, 2))
    if s.audio:
        a = F.conv2d(num(audio.permute(0, 3, 1, 2)), num(p["patch_embed.audio_proj.weight"]),
                     p["patch_embed.audio_proj.bias"], stride=ps)
        x = torch.cat([x, num(a.flatten(2).transpose(1, 2))], 1)
    return num(x + num(_table(s, s.embed_dim, x.device)))


def encoder(p: dict, s: ModelSpec, video, audio, keep: Optional[torch.Tensor],
            num: Numerics) -> torch.Tensor:
    """[B, K, D] over the tokens ``keep`` [B, K] (every token when None)."""
    x = embed_tokens(p, s, video, audio, num)
    if keep is not None:
        x = torch.gather(x, 1, keep[..., None].expand(-1, -1, x.shape[-1]))
    x = _blocks(p, "blocks", s.depth, x, s.num_heads, s.gelu, num)
    return layer_norm(x, p["norm.weight"], p["norm.bias"], num)


def predictor(p: dict, s: ModelSpec, ctx: torch.Tensor, ctx_idx: torch.Tensor,
              pred_idx: torch.Tensor, mask_index: int, num: Numerics) -> torch.Tensor:
    """Predictions [B, P, D] at ``pred_idx`` [B, P] from the context
    encoder's tokens ``ctx`` [B, K, D] at ``ctx_idx`` [B, K]. Both index
    arrays are ascending, video positions before spectrogram ones, with the
    same number of each in every sample."""
    nv, dp = s.num_video_tokens, s.pred_embed_dim
    kv = int((ctx_idx[0] < nv).sum())
    pv = int((pred_idx[0] < nv).sum())
    b, npred = pred_idx.shape
    j = mask_index % s.num_mask_tokens
    parts = [linear(ctx[:, :kv], p["predictor_embed_v.weight"], p["predictor_embed_v.bias"],
                    num)]
    if s.audio:
        parts.append(linear(ctx[:, kv:], p["predictor_embed_a.weight"],
                            p["predictor_embed_a.bias"], num))
    parts.append(num(p[f"mask_tokens_v.{j}"]).expand(b, pv, dp))
    if s.audio:
        parts.append(num(p[f"mask_tokens_a.{j}"]).expand(b, npred - pv, dp))
    pos = num(_table(s, dp, ctx.device))[torch.cat([ctx_idx, pred_idx], 1)]
    x = num(torch.cat(parts, 1) + pos)
    x = _blocks(p, "predictor_blocks", s.pred_depth, x, s.pred_num_heads, s.gelu, num)
    x = layer_norm(x[:, ctx_idx.shape[1]:], p["predictor_norm.weight"],
                   p["predictor_norm.bias"], num)
    return linear(x, p["predictor_proj.weight"], p["predictor_proj.bias"], num)


def feature_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over features without parameters (biased variance)."""
    return F.layer_norm(h, (h.shape[-1],), eps=eps)


@torch.no_grad()
def embed_clips(p: dict, s: ModelSpec, video, audio, num: Numerics,
                chunk: int = 8) -> torch.Tensor:
    """The extract path's embeddings [B, D]: the encoder over every token,
    the feature norm, the mean over tokens; ``chunk`` clips at a time."""
    outs = []
    for i in range(0, video.shape[0], chunk):
        a = None if audio is None else audio[i:i + chunk]
        h = feature_norm(encoder(p, s, video[i:i + chunk], a, None, num))
        outs.append(h.mean(1))
    return torch.cat(outs, 0)
