"""Deterministic synthetic AV clip source (the port's copy of
``avjepa_tpu/data/synthetic.py``).

Generates structured (not pure-noise) fake clips: moving gradient patterns for
video and chirp-like mel patterns for audio, seeded per index — so tests and
benchmarks run without media files while still exercising the full input
contract: video [T, H, W, 3] f32 (normalized), audio mel [Hs, Ws] f32 dB-scale.
"""

from __future__ import annotations

import numpy as np

from avjepa_tpu_torch.layout import TokenLayout


class SyntheticAVDataset:
    def __init__(
        self,
        layout: TokenLayout,
        length: int = 10_000,
        seed: int = 0,
        num_classes: int = 10,
    ):
        self.layout = layout
        self.length = length
        self.seed = seed
        self.num_classes = num_classes

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        lo = self.layout
        rng = np.random.default_rng([self.seed, 0, 0, idx])
        t = np.arange(lo.num_frames, dtype=np.float32)[:, None, None]
        y = np.linspace(0, 2 * np.pi, lo.crop_size, dtype=np.float32)[None, :, None]
        x = np.linspace(0, 2 * np.pi, lo.crop_size, dtype=np.float32)[None, None, :]
        fy, fx = rng.uniform(0.5, 3.0, 2).astype(np.float32)
        vy, vx = rng.uniform(-0.3, 0.3, 2).astype(np.float32)
        base = np.sin(fy * y + vy * t) * np.cos(fx * x + vx * t)
        video = np.stack(
            [base, np.roll(base, 3, axis=1), np.roll(base, 7, axis=2)], axis=-1
        ).astype(np.float32)
        video += rng.normal(0, 0.1, video.shape).astype(np.float32)

        if lo.audio_enabled:
            m = np.arange(lo.spec_height, dtype=np.float32)[:, None]
            f = np.arange(lo.spec_width, dtype=np.float32)[None, :]
            f0 = rng.uniform(5, 40)
            sweep = rng.uniform(-0.2, 0.2)
            audio = -80.0 + 60.0 * np.exp(
                -0.5 * ((m - (f0 + sweep * f)) / 6.0) ** 2
            )
            audio = (audio + rng.normal(0, 1.0, audio.shape)).astype(np.float32)
        else:
            audio = None

        label = int(rng.integers(0, self.num_classes))
        return video, audio, label
