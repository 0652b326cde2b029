"""Composable clip-transform class family; the port's copy of
``avjepa_tpu/data/video_transforms.py``.

Capability-parity port surface for the reference's vendored torchvision-style
video transforms (reference: src/datasets/utils/video/transforms.py:280-1184 —
Compose / flips / resizes / crops / rotation / ColorJitter / Normalize and the
functional jitter helpers). The reference's main configs never use these (its
pipelines call VideoTransform directly, as ours do); they are provided so
downstream code written against that API has an equivalent here.

Design differences from the reference (deliberate, host-idiomatic):
- clips are numpy ``[T, H, W, C]`` float32 (channels-last, like the rest of
  the ingest stack) instead of torch ``[C, T, H, W]`` tensors;
- every random transform takes the RNG explicitly (``__call__(clip, rng)``) —
  reproducible across loader worker processes, no global torch RNG;
- interpolation uses the same bilinear resampler as the main pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from avjepa_tpu_torch.data.transforms import _bilinear_resize


def _resize_bilinear(clip: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    return np.stack([_bilinear_resize(f, out_h, out_w) for f in clip])


def _as_clip(clip: np.ndarray) -> np.ndarray:
    clip = np.asarray(clip, np.float32)
    assert clip.ndim == 4, f"expected [T, H, W, C], got {clip.shape}"
    return clip


# --- functional helpers (reference transforms.py:280-500) -------------------


def blend(images1: np.ndarray, images2: np.ndarray, alpha: float) -> np.ndarray:
    """images1 * alpha + images2 * (1 - alpha) (reference :280-295)."""
    return images1 * alpha + images2 * (1.0 - alpha)


def grayscale(images: np.ndarray) -> np.ndarray:
    """Rec601 luma, broadcast back over RGB (reference :296-317)."""
    lum = (
        0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    )
    return np.repeat(lum[..., None], 3, axis=-1)


def brightness_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + float(rng.uniform(-var, var))
    return blend(images, np.zeros_like(images), alpha)


def contrast_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + float(rng.uniform(-var, var))
    gray = grayscale(images)
    mean = gray.mean(axis=(1, 2, 3), keepdims=True)
    return blend(images, np.broadcast_to(mean, images.shape), alpha)


def saturation_jitter(var: float, images: np.ndarray, rng) -> np.ndarray:
    alpha = 1.0 + float(rng.uniform(-var, var))
    return blend(images, grayscale(images), alpha)


def color_jitter(
    images: np.ndarray,
    rng,
    img_brightness: float = 0,
    img_contrast: float = 0,
    img_saturation: float = 0,
) -> np.ndarray:
    """Apply enabled jitters in random order (reference :318-352)."""
    jitters = []
    if img_brightness != 0:
        jitters.append(("brightness", img_brightness))
    if img_contrast != 0:
        jitters.append(("contrast", img_contrast))
    if img_saturation != 0:
        jitters.append(("saturation", img_saturation))
    if not jitters:
        return images
    for i in rng.permutation(len(jitters)):
        kind, var = jitters[int(i)]
        if kind == "brightness":
            images = brightness_jitter(var, images, rng)
        elif kind == "contrast":
            images = contrast_jitter(var, images, rng)
        else:
            images = saturation_jitter(var, images, rng)
    return images


def lighting_jitter(
    images: np.ndarray, alphastd: float, eigval: Sequence[float],
    eigvec: Sequence[Sequence[float]], rng,
) -> np.ndarray:
    """AlexNet-style PCA lighting noise (reference :411-458)."""
    if alphastd == 0:
        return images
    alpha = rng.normal(0, alphastd, size=3)
    ev = np.asarray(eigval, np.float32)
    evec = np.asarray(eigvec, np.float32)  # [3, 3]
    rgb = (evec * alpha[None, :] * ev[None, :]).sum(axis=1)  # [3]
    return images + rgb[None, None, None, :]


def color_normalization(
    images: np.ndarray, mean: Sequence[float], stddev: Sequence[float]
) -> np.ndarray:
    """(x - mean) / std per channel (reference :459-502)."""
    m = np.asarray(mean, np.float32)[None, None, None, :]
    s = np.asarray(stddev, np.float32)[None, None, None, :]
    return (images - m) / s


def random_short_side_scale_jitter(
    images: np.ndarray, min_size: int, max_size: int, rng
) -> np.ndarray:
    """Scale so the short side lands uniformly in [min, max] (reference :48-104)."""
    size = int(round(float(rng.uniform(min_size, max_size))))
    t, h, w, c = images.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return images
    if w < h:
        new_w, new_h = size, int(np.floor(h / w * size))
    else:
        new_w, new_h = int(np.floor(w / h * size)), size
    return _resize_bilinear(images, new_h, new_w)


def uniform_crop(images: np.ndarray, size: int, spatial_idx: int) -> np.ndarray:
    """Deterministic left/center/right (or top/center/bottom) crop
    (reference :195-257)."""
    assert spatial_idx in (0, 1, 2)
    t, h, w, c = images.shape
    y = max(0, (h - size) // 2)
    x = max(0, (w - size) // 2)
    if h > w:
        y = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y)
    else:
        x = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x)
    return images[:, y : y + size, x : x + size]


# --- class family (reference transforms.py:803-1184) ------------------------


class Compose:
    """Chain transforms; random ones receive the rng (reference :803-818)."""

    def __init__(self, transforms: Sequence):
        import inspect

        self.transforms = list(transforms)
        # decide once per transform (not per sample — this runs in the decode
        # workers' hot path) whether it accepts the rng; decided by signature,
        # not by catching TypeError (which would swallow genuine TypeErrors
        # raised inside the transform and re-run it). The second parameter
        # must be named 'rng' or 'generator' so arbitrary two-arg callables
        # don't silently receive a Generator; a two-arg transform named
        # otherwise gets a loud construction-time warning instead of silently
        # losing per-sample determinism.
        self._takes_rng = []
        for t in self.transforms:
            try:
                params = list(inspect.signature(t).parameters)
                takes = len(params) >= 2 and params[1] in ("rng", "generator")
                if len(params) >= 2 and not takes:
                    import warnings

                    warnings.warn(
                        f"Compose: transform {t!r} takes a second parameter "
                        f"{params[1]!r}; name it 'rng' (or 'generator') to "
                        "receive the seeded np.random.Generator — it will "
                        "NOT be passed one",
                        stacklevel=2,
                    )
            except (TypeError, ValueError):
                takes = False
            self._takes_rng.append(takes)

    def __call__(self, clip: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t, takes_rng in zip(self.transforms, self._takes_rng):
            clip = t(clip, rng) if takes_rng else t(clip)
        return clip


class RandomHorizontalFlip:
    """Flip the width axis with probability p (reference :819-844)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip: np.ndarray, rng) -> np.ndarray:
        clip = _as_clip(clip)
        if rng.random() < self.p:
            return clip[:, :, ::-1]
        return clip


class RandomResize:
    """Scale both sides by a uniform ratio (reference :845-874)."""

    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.ratio = ratio

    def __call__(self, clip: np.ndarray, rng) -> np.ndarray:
        clip = _as_clip(clip)
        scale = float(rng.uniform(self.ratio[0], self.ratio[1]))
        t, h, w, c = clip.shape
        return _resize_bilinear(clip, int(h * scale), int(w * scale))


class Resize:
    """Resize to an exact (h, w) (reference :875-894)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        clip = _as_clip(clip)
        return _resize_bilinear(clip, self.size[0], self.size[1])


class RandomCrop:
    """Random spatial crop (reference :895-938)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: np.ndarray, rng) -> np.ndarray:
        clip = _as_clip(clip)
        ch, cw = self.size
        t, h, w, c = clip.shape
        assert h >= ch and w >= cw, f"clip {h}x{w} smaller than crop {ch}x{cw}"
        y = int(rng.integers(0, h - ch + 1))
        x = int(rng.integers(0, w - cw + 1))
        return clip[:, y : y + ch, x : x + cw]


class ThreeCrop:
    """Three uniform crops along the long side (reference :939-985)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        clip = _as_clip(clip)
        t, h, w, c = clip.shape
        size = self.size[0]
        # resize the SHORT side to `size` (keeping the long side proportional)
        # so the three uniform_crop positions slide along the long side —
        # resizing both sides to (size, size) would make all three crops
        # identical
        if min(h, w) != size:
            if h <= w:
                clip = _resize_bilinear(clip, size, max(size, round(w * size / h)))
            else:
                clip = _resize_bilinear(clip, max(size, round(h * size / w)), size)
        crops = [uniform_crop(clip, size, i) for i in range(3)]
        return np.concatenate(crops, axis=0)


class RandomRotation:
    """Rotate by a uniform angle in [-degrees, degrees] (reference :986-1028).

    Pure-numpy nearest-neighbor rotation about the center (the reference
    shells out to PIL/torchvision; no PIL dependency here)."""

    def __init__(self, degrees):
        self.degrees = (
            (-degrees, degrees) if np.isscalar(degrees) else tuple(degrees)
        )

    def __call__(self, clip: np.ndarray, rng) -> np.ndarray:
        clip = _as_clip(clip)
        angle = np.deg2rad(float(rng.uniform(self.degrees[0], self.degrees[1])))
        t, h, w, c = clip.shape
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        cos, sin = np.cos(angle), np.sin(angle)
        src_y = cos * (yy - cy) + sin * (xx - cx) + cy
        src_x = -sin * (yy - cy) + cos * (xx - cx) + cx
        sy = np.clip(np.round(src_y).astype(np.int64), 0, h - 1)
        sx = np.clip(np.round(src_x).astype(np.int64), 0, w - 1)
        valid = (
            (src_y >= 0) & (src_y <= h - 1) & (src_x >= 0) & (src_x <= w - 1)
        )[None, :, :, None]
        return np.where(valid, clip[:, sy, sx], 0.0)


class CenterCrop:
    """Center spatial crop (reference :1029-1072)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        clip = _as_clip(clip)
        ch, cw = self.size
        t, h, w, c = clip.shape
        y = max(0, (h - ch) // 2)
        x = max(0, (w - cw) // 2)
        return clip[:, y : y + ch, x : x + cw]


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter with random order and
    torchvision factor semantics (reference :1073-1157): each factor is drawn
    from [max(0, 1-v), 1+v] (or the given (lo, hi)) and applied
    multiplicatively; hue shifts the HSV hue channel."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = self._range(hue, center=0.0, bound=0.5)

    @staticmethod
    def _range(v, center: float = 1.0, bound: float = float("inf")):
        if v is None or (np.isscalar(v) and v == 0):
            return None
        if np.isscalar(v):
            lo, hi = center - float(v), center + float(v)
            lo = max(lo, 0.0 if center == 1.0 else -bound)
            hi = min(hi, bound) if bound != float("inf") else hi
            return (lo, hi)
        return (float(v[0]), float(v[1]))

    def __call__(self, clip: np.ndarray, rng) -> np.ndarray:
        clip = _as_clip(clip)
        ops = []
        if self.brightness is not None:
            f = float(rng.uniform(*self.brightness))
            ops.append(lambda x, f=f: x * f)
        if self.contrast is not None:
            f = float(rng.uniform(*self.contrast))

            def contrast(x, f=f):
                mean = grayscale(x).mean(axis=(1, 2, 3), keepdims=True)
                return blend(x, np.broadcast_to(mean, x.shape), f)

            ops.append(contrast)
        if self.saturation is not None:
            f = float(rng.uniform(*self.saturation))
            ops.append(lambda x, f=f: blend(x, grayscale(x), f))
        if self.hue is not None:
            shift = float(rng.uniform(*self.hue))
            ops.append(lambda x, s=shift: self._hue_shift(x, s))
        for i in rng.permutation(len(ops)):
            clip = ops[int(i)](clip)
        return clip

    @staticmethod
    def _hue_shift(clip: np.ndarray, shift: float) -> np.ndarray:
        """Rotate hue by ``shift`` (fraction of a full turn) via the YIQ
        rotation approximation — exact-enough HSV-free hue rotation."""
        theta = 2.0 * np.pi * shift
        cos, sin = np.cos(theta), np.sin(theta)
        # RGB -> YIQ rotate I/Q -> RGB
        to_yiq = np.array(
            [[0.299, 0.587, 0.114],
             [0.596, -0.274, -0.322],
             [0.211, -0.523, 0.312]], np.float32)
        to_rgb = np.linalg.inv(to_yiq).astype(np.float32)
        rot = np.array(
            [[1, 0, 0], [0, cos, -sin], [0, sin, cos]], np.float32)
        m = to_rgb @ rot @ to_yiq
        return clip @ m.T


class Normalize:
    """Per-channel (x - mean) / std (reference :1158-1184)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        return color_normalization(_as_clip(clip), self.mean, self.std)
