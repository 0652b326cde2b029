"""Video augmentation pipeline (host-side numpy, channels-last; the port's
copy of ``avjepa_tpu/data/transforms.py``).

Behavioral parity with the reference's VideoTransform
(reference: app/vjepa/transforms.py:40-115 — identical copies exist in all four
apps) and the vendored SlowFast crop ops
(src/datasets/utils/video/transforms.py:580-659):

  random-resized-crop (optionally with *motion shift*: the crop box
  interpolates linearly across time) -> horizontal flip p=0.5 ->
  normalize (ImageNet mean/std) -> optional RandomErasing (pixel mode).

AutoAugment (rand-m7-n4-mstd0.5-inc1) is a PIL-op stack in the reference; here
a numpy implementation of the same op family lives in randaugment.py.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W, C] float -> [out_h, out_w, C] bilinear (align_corners=False)."""
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def sample_crop_box(
    h: int,
    w: int,
    scale: Sequence[float],
    ratio: Sequence[float],
    rng: np.random.Generator,
    max_attempts: int = 10,
):
    """timm/SlowFast-style crop box: uniform scale x log-uniform aspect."""
    area = h * w
    for _ in range(max_attempts):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop at min ratio
    cw = min(w, h)
    ch = min(w, h)
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def _interp_boxes(box0, box1, t: int) -> np.ndarray:
    rects = np.empty((t, 4), np.int32)
    for i in range(t):
        a = i / max(t - 1, 1)
        rects[i] = [int(round(box0[j] * (1 - a) + box1[j] * a)) for j in range(4)]
    return rects


def random_resized_crop(
    clip: np.ndarray,
    out_size: int,
    scale: Sequence[float],
    ratio: Sequence[float],
    rng: np.random.Generator,
    motion_shift: bool = False,
) -> np.ndarray:
    """[T, H, W, C] -> [T, out, out, C]. With motion_shift, the box corners
    interpolate between two sampled boxes across time
    (reference: transforms.py:580-623).

    uint8 RGB clips take the native libswscale path (SIMD, GIL-free) — the
    numpy bilinear was the host pipeline's bottleneck; float inputs (synthetic
    data, post-autoaugment) use the numpy path.
    """
    t, h, w = clip.shape[:3]
    box0 = sample_crop_box(h, w, scale, ratio, rng)
    box1 = sample_crop_box(h, w, scale, ratio, rng) if motion_shift else box0
    rects = _interp_boxes(box0, box1, t)

    if clip.dtype == np.uint8 and clip.shape[3] == 3:
        try:
            from avjepa_tpu_torch.data.video_decoder import crop_resize_rgb

            return crop_resize_rgb(clip, rects, out_size, out_size).astype(
                np.float32
            )
        except Exception:
            pass  # fall back to numpy (native lib unavailable)

    out = np.empty((t, out_size, out_size, clip.shape[3]), np.float32)
    for i in range(t):
        top, left, ch, cw = rects[i]
        crop = clip[i, top : top + ch, left : left + cw].astype(np.float32)
        out[i] = _bilinear_resize(crop, out_size, out_size)
    return out


def random_erasing(
    clip: np.ndarray,
    rng: np.random.Generator,
    prob: float = 0.25,
    area_range=(0.02, 1 / 3),
    aspect_range=(0.3, 3.3),
    max_count: int = 1,
) -> np.ndarray:
    """Pixel-mode cutout across all frames (reference randerase.py:34-180)."""
    if rng.random() >= prob:
        return clip
    t, h, w, c = clip.shape
    count = int(rng.integers(1, max_count + 1))
    for _ in range(count):
        for _ in range(10):
            target_area = rng.uniform(*area_range) * h * w / count
            aspect = math.exp(rng.uniform(math.log(aspect_range[0]), math.log(aspect_range[1])))
            eh = int(round(math.sqrt(target_area * aspect)))
            ew = int(round(math.sqrt(target_area / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                top = int(rng.integers(0, h - eh))
                left = int(rng.integers(0, w - ew))
                noise = rng.normal(size=(eh, ew, c)).astype(np.float32)
                clip[:, top : top + eh, left : left + ew] = noise
                break
    return clip


class VideoTransform:
    """Pretraining train-time transform (reference VideoTransform)."""

    def __init__(
        self,
        crop_size: int = 224,
        random_resize_scale=(0.3, 1.0),
        random_resize_aspect_ratio=(0.75, 1.35),
        horizontal_flip: bool = True,
        reprob: float = 0.0,
        motion_shift: bool = False,
        auto_augment: bool = False,
        normalize=(IMAGENET_MEAN, IMAGENET_STD),
    ):
        self.crop_size = crop_size
        self.scale = tuple(random_resize_scale)
        # reference stores aspect as (min, max) and samples log-uniform
        self.ratio = tuple(random_resize_aspect_ratio)
        self.horizontal_flip = horizontal_flip
        self.reprob = reprob
        self.motion_shift = motion_shift
        self.auto_augment = auto_augment
        self.mean, self.std = normalize

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """clip: [T, H, W, 3] uint8 -> [T, crop, crop, 3] f32 normalized."""
        if self.auto_augment:
            from avjepa_tpu_torch.data.randaugment import rand_augment_video

            clip = rand_augment_video(clip, rng)
        clip = random_resized_crop(
            clip, self.crop_size, self.scale, self.ratio, rng,
            motion_shift=self.motion_shift,
        )
        if self.horizontal_flip and rng.random() < 0.5:
            clip = clip[:, :, ::-1]
        # fused normalize: (x/255 - mean)/std == (x - 255*mean) * 1/(255*std)
        clip = (clip - self.mean * 255.0) * (1.0 / (self.std * 255.0))
        if self.reprob > 0:
            clip = random_erasing(np.ascontiguousarray(clip), rng, prob=self.reprob)
        return np.ascontiguousarray(clip, np.float32)


class EvalVideoTransform:
    """Short-side resize + N spatial views sliding along the long side
    (reference: evals/video_classification_frozen/utils.py:286-323)."""

    def __init__(self, num_views: int = 3, short_side: int = 224, crop_size: int = 224):
        self.num_views = num_views
        self.short_side = short_side
        self.crop_size = crop_size

    def __call__(self, clip: np.ndarray) -> list[np.ndarray]:
        t, h, w = clip.shape[:3]
        if h <= w:
            nh, nw = self.short_side, max(self.crop_size, int(w * self.short_side / h))
        else:
            nh, nw = max(self.crop_size, int(h * self.short_side / w)), self.short_side
        resized = np.stack(
            [_bilinear_resize(clip[i].astype(np.float32), nh, nw) for i in range(t)]
        )
        views = []
        long_len = max(nh, nw)
        span = long_len - self.crop_size
        for v in range(self.num_views):
            off = 0 if self.num_views == 1 else int(span * v / (self.num_views - 1))
            if nh <= nw:
                crop = resized[:, :, off : off + self.crop_size]
                crop = crop[:, : self.crop_size]
            else:
                crop = resized[:, off : off + self.crop_size, :]
                crop = crop[:, :, : self.crop_size]
            crop = crop / 255.0
            crop = (crop - IMAGENET_MEAN) / IMAGENET_STD
            views.append(np.ascontiguousarray(crop, np.float32))
        return views
