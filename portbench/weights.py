"""Weights and inputs made from ``--seed``, on the device, in a few large calls.

Every parameter is drawn at once from one normal draw of a ``torch.Generator``
on the device: weights N(0, 0.02), the output projections of block i (attn.proj,
mlp.fc2) divided by sqrt(2 (i + 1)) as the published init does; biases, mask
tokens and LayerNorm shifts N(0, 0.02) and LayerNorm scales 1 + N(0, 0.02), so
that no part of the model starts at a value that hides it. The same seed gives
the same tensors, which go to the program (through its ``load_state_dict``) and
to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.vit import ModelSpec, ParamSpec, encoder_params, predictor_params

STD = 0.02


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of the stream ``stream`` of ``seed`` (any whole number)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _draw(specs: list[ParamSpec], g: torch.Generator, device) -> dict:
    flat = torch.randn(sum(int(np.prod(p.shape)) for p in specs), generator=g, device=device)
    out, at = {}, 0
    for p in specs:
        n = int(np.prod(p.shape))
        t = flat[at:at + n].view(p.shape)
        at += n
        t.mul_(STD / p.rescale)
        if p.kind == "norm_weight":
            t.add_(1.0)
        out[p.name] = t
    return out


def make(s: ModelSpec, seed: int, device, predictor: bool = True) -> tuple[dict, dict | None]:
    """(encoder state dict, predictor state dict or None), float32 on
    ``device``; the encoder's is also the target encoder's."""
    enc = _draw(encoder_params(s), generator(seed, 1, device), device)
    if not predictor:
        return enc, None
    return enc, _draw(predictor_params(s), generator(seed, 2, device), device)


def clips(s: ModelSpec, batch: int, g: torch.Generator, device):
    """A batch of clips: video [B, T, H, W, 3] and spectrograms [B, Hs, Ws, 1]
    (None without audio), float32 N(0, 1) as normalised pixels and mels."""
    video = torch.randn((batch, s.num_frames, s.crop_size, s.crop_size, 3), generator=g,
                        device=device)
    audio = None
    if s.audio:
        audio = torch.randn((batch, s.spec_height, s.spec_width, 1), generator=g, device=device)
    return video, audio
