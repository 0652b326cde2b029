"""Token layout registry (the port's copy of ``avjepa_tpu/layout.py``).

The reference hardcodes the token geometry (1568 video + 96 audio tokens) in at
least four places (reference: app/avjepa/train.py:449, src/masks/utils.py:57-59,
src/models/audiovision_transformer.py:92-94, src/models/prediction_probes.py:318-319).
Here the geometry lives in exactly one place and every component derives from it.

A `TokenLayout` describes the dual-modality token sequence:

    [ video tokens : T_grid * H_grid * W_grid ] [ audio tokens : Ha_grid * Wa_grid ]

Video tokens come from a Conv3d tubelet patchification of a
``[T, H, W, 3]`` clip; audio tokens from a Conv2d patchification of a
``[Ha_spec, Wa_spec, 1]`` mel spectrogram.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Static token geometry for one (video, audio) clip."""

    # video raster
    num_frames: int = 16
    crop_size: int = 224
    patch_size: int = 16
    tubelet_size: int = 2
    # audio spectrogram raster (mel bins x time-frames), fixed by the ingest
    # pipeline (reference: src/datasets/audiovideo_dataset.py:322-339 produces a
    # 128x192 spectrogram; reference: src/models/audiovision_transformer.py:140-153)
    spec_height: int = 128
    spec_width: int = 192
    # set audio_enabled=False for the video-only (v-jepa) apps
    audio_enabled: bool = True

    # --- video grid ---
    @property
    def t_grid(self) -> int:
        return self.num_frames // self.tubelet_size

    @property
    def h_grid(self) -> int:
        return self.crop_size // self.patch_size

    @property
    def w_grid(self) -> int:
        return self.crop_size // self.patch_size

    @property
    def video_grid(self) -> tuple[int, int, int]:
        return (self.t_grid, self.h_grid, self.w_grid)

    @property
    def num_video_tokens(self) -> int:
        return self.t_grid * self.h_grid * self.w_grid

    # --- audio grid ---
    @property
    def ha_grid(self) -> int:
        return self.spec_height // self.patch_size

    @property
    def wa_grid(self) -> int:
        return self.spec_width // self.patch_size

    @property
    def audio_grid(self) -> tuple[int, int]:
        return (self.ha_grid, self.wa_grid)

    @property
    def num_audio_tokens(self) -> int:
        if not self.audio_enabled:
            return 0
        return self.ha_grid * self.wa_grid

    # --- combined sequence ---
    @property
    def num_tokens(self) -> int:
        return self.num_video_tokens + self.num_audio_tokens

    @property
    def video_slice(self) -> slice:
        return slice(0, self.num_video_tokens)

    @property
    def audio_slice(self) -> slice:
        return slice(self.num_video_tokens, self.num_tokens)


# The canonical pretraining layout: 16 frames x 224^2, patch 16, tubelet 2,
# 128x192 spectrogram  ->  8*14*14 = 1568 video + 8*12 = 96 audio = 1664 tokens.
DEFAULT_AV_LAYOUT = TokenLayout()
DEFAULT_VIDEO_LAYOUT = TokenLayout(audio_enabled=False)
