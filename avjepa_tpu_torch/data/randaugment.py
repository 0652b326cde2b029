"""RandAugment for video clips, in numpy (no PIL; the port's copy of
``avjepa_tpu/data/randaugment.py``).

Behavioral equivalent of the reference's vendored PIL-op RandAugment with the
``rand-m7-n4-mstd0.5-inc1`` policy used by the pretraining transform
(reference: src/datasets/utils/video/randaugment.py:27,189-264,352-369;
src/datasets/utils/video/transforms.py:625-659): per clip, pick N=4 ops at
random; each op fires with probability 0.5 (AugmentOp prob=0.5); its
magnitude is m/10 of its range, jittered by N(0, 0.5) and clipped to
[0, 10]; 'inc1' makes magnitude increase severity (PosterizeIncreasing,
SolarizeIncreasing, *Increasing enhance ops). The same op+magnitude is
applied to every frame of the clip (temporal consistency, as the reference
applies one augment to the PIL frame list).
"""

from __future__ import annotations

import numpy as np

# timm's controller-RNN magnitude ceiling (reference randaugment.py:27).
# All level->arg mappings divide by this, so a policy magnitude of 7 means
# 7/10 of each op's full range.
_MAX_LEVEL = 10.0


def _affine(clip: np.ndarray, matrix: np.ndarray, fill: float = 128.0) -> np.ndarray:
    """Apply a 2x3 inverse affine matrix to every frame (nearest neighbor)."""
    t, h, w, c = clip.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    src = matrix @ coords
    sx = np.round(src[0]).astype(np.int64)
    sy = np.round(src[1]).astype(np.int64)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    sx = np.clip(sx, 0, w - 1)
    sy = np.clip(sy, 0, h - 1)
    out = clip[:, sy, sx].reshape(t, h, w, c).astype(np.float32)
    out[:, ~valid.reshape(h, w)] = fill
    return out


def shear_x(clip, level):
    m = np.array([[1, level, 0], [0, 1, 0]], np.float64)
    return _affine(clip, m)


def shear_y(clip, level):
    m = np.array([[1, 0, 0], [level, 1, 0]], np.float64)
    return _affine(clip, m)


def translate_x(clip, frac):
    w = clip.shape[2]
    m = np.array([[1, 0, frac * w], [0, 1, 0]], np.float64)
    return _affine(clip, m)


def translate_y(clip, frac):
    h = clip.shape[1]
    m = np.array([[1, 0, 0], [0, 1, frac * h]], np.float64)
    return _affine(clip, m)


def rotate(clip, degrees):
    h, w = clip.shape[1:3]
    cx, cy = w / 2, h / 2
    rad = np.deg2rad(degrees)
    cos, sin = np.cos(rad), np.sin(rad)
    # inverse rotation about center
    m = np.array(
        [
            [cos, sin, cx - cx * cos - cy * sin],
            [-sin, cos, cy + cx * sin - cy * cos],
        ],
        np.float64,
    )
    return _affine(clip, m)


def auto_contrast(clip, _):
    out = clip.astype(np.float32)
    for ch in range(clip.shape[-1]):
        lo, hi = out[..., ch].min(), out[..., ch].max()
        if hi > lo:
            out[..., ch] = (out[..., ch] - lo) * (255.0 / (hi - lo))
    return out


def invert(clip, _):
    return 255.0 - clip.astype(np.float32)


def equalize(clip, _):
    out = clip.astype(np.uint8).copy()
    for ch in range(clip.shape[-1]):
        hist, _ = np.histogram(out[..., ch], bins=256, range=(0, 256))
        cdf = hist.cumsum()
        nz = cdf[cdf > 0]
        if len(nz) == 0:
            continue
        lut = np.clip(((cdf - nz[0]) * 255.0 / max(cdf[-1] - nz[0], 1)), 0, 255)
        out[..., ch] = lut[out[..., ch]].astype(np.uint8)
    return out.astype(np.float32)


def solarize(clip, thresh):
    c = clip.astype(np.float32)
    return np.where(c >= thresh, 255.0 - c, c)


def solarize_add(clip, add, thresh=128.0):
    c = clip.astype(np.float32)
    return np.where(c < thresh, np.clip(c + add, 0, 255), c)


def posterize(clip, bits):
    """Keep the top `bits` bits of each channel (PIL ImageOps.posterize).

    bits >= 8 is the reference's explicit no-op (randaugment.py:289-292);
    bits == 0 blacks the image out, matching PIL's mask = ~(2**(8-bits)-1).
    """
    bits = int(np.clip(bits, 0, 8))
    if bits >= 8:
        return clip.astype(np.float32)
    shift = 8 - bits
    return ((clip.astype(np.uint8) >> shift) << shift).astype(np.float32)


def contrast(clip, factor):
    c = clip.astype(np.float32)
    mean = c.mean()
    return np.clip(mean + factor * (c - mean), 0, 255)


def color(clip, factor):
    c = clip.astype(np.float32)
    gray = c.mean(axis=-1, keepdims=True)
    return np.clip(gray + factor * (c - gray), 0, 255)


def brightness(clip, factor):
    return np.clip(clip.astype(np.float32) * factor, 0, 255)


def sharpness(clip, factor):
    c = clip.astype(np.float32)
    # 3x3 smoothing kernel per frame
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    blurred = np.zeros_like(c)
    pad = np.pad(c, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    for dy in range(3):
        for dx in range(3):
            blurred += k[dy, dx] * pad[:, dy : dy + c.shape[1], dx : dx + c.shape[2]]
    return np.clip(blurred + factor * (c - blurred), 0, 255)


# (name, fn, level -> arg) with 'inc1' increasing-severity mappings,
# argument-for-argument equal to the reference's LEVEL_TO_ARG entries for
# _RAND_INCREASING_TRANSFORMS (reference randaugment.py:189-264,391-407):
#   Rotate          level/10 * 30, signed
#   PosterizeIncreasing  4 - int(level/10 * 4) kept bits
#   SolarizeIncreasing   256 - int(level/10 * 256) threshold
#   SolarizeAdd     int(level/10 * 110)
#   *Increasing enhance  1.0 +/- level/10 * 0.9
#   ShearX/Y        level/10 * 0.3, signed
#   TranslateX/YRel level/10 * 0.45 of the dimension, signed
def _lvl(level, maxval, signed, rng):
    v = level / _MAX_LEVEL * maxval
    if signed and rng.random() < 0.5:
        v = -v
    return v


OPS = [
    ("AutoContrast", auto_contrast, lambda l, r: 0),
    ("Equalize", equalize, lambda l, r: 0),
    ("Invert", invert, lambda l, r: 0),
    ("Rotate", rotate, lambda l, r: _lvl(l, 30.0, True, r)),
    ("Posterize", posterize, lambda l, r: 4 - int(l / _MAX_LEVEL * 4)),
    ("Solarize", solarize, lambda l, r: 256 - int(l / _MAX_LEVEL * 256)),
    ("SolarizeAdd", solarize_add, lambda l, r: int(l / _MAX_LEVEL * 110)),
    ("Color", color, lambda l, r: 1.0 + _lvl(l, 0.9, True, r)),
    ("Contrast", contrast, lambda l, r: 1.0 + _lvl(l, 0.9, True, r)),
    ("Brightness", brightness, lambda l, r: 1.0 + _lvl(l, 0.9, True, r)),
    ("Sharpness", sharpness, lambda l, r: 1.0 + _lvl(l, 0.9, True, r)),
    ("ShearX", shear_x, lambda l, r: _lvl(l, 0.3, True, r)),
    ("ShearY", shear_y, lambda l, r: _lvl(l, 0.3, True, r)),
    ("TranslateX", translate_x, lambda l, r: _lvl(l, 0.45, True, r)),
    ("TranslateY", translate_y, lambda l, r: _lvl(l, 0.45, True, r)),
]


def rand_augment_video(
    clip: np.ndarray,
    rng: np.random.Generator,
    num_ops: int = 4,
    magnitude: float = 7.0,
    mag_std: float = 0.5,
) -> np.ndarray:
    """[T, H, W, C] uint8 -> float32, rand-m7-n4-mstd0.5-inc1 policy.

    Matches the reference pipeline: RandAugment.__call__ draws num_layers ops
    with replacement, and each AugmentOp fires with prob=0.5, jittering its
    magnitude by N(m, mstd) clipped to [0, 10] when it does
    (reference randaugment.py:330-369,441-456).
    """
    out = clip.astype(np.float32)
    for _ in range(num_ops):
        name, fn, arg_fn = OPS[int(rng.integers(0, len(OPS)))]
        if rng.random() > 0.5:  # AugmentOp prob=0.5 gate
            continue
        level = float(np.clip(rng.normal(magnitude, mag_std), 0, _MAX_LEVEL))
        out = fn(np.clip(out, 0, 255), arg_fn(level, rng))
    return np.clip(out, 0, 255)


# --- AutoAugment 'original' ImageNet policy -------------------------------
#
# The image-classification eval trains its probe with timm's
# auto_augment='original' (reference: evals/image_classification_frozen/
# eval.py:393-403) — the 25-sub-policy AutoAugment ImageNet policy from
# Cubuk et al. (2019), NOT RandAugment. Each sub-policy is two
# (op, prob, magnitude) stages; one sub-policy is drawn per image and each
# stage fires independently with its probability. Magnitudes are on the same
# 0..10 scale timm uses (10 == _MAX_LEVEL severity), translated through the
# shared OPS level->arg mappings above.

_OPS_BY_NAME = {name: (fn, arg_fn) for name, fn, arg_fn in OPS}

AUTO_AUGMENT_ORIGINAL_POLICY = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def _posterize_original(clip, level_0_10):
    # AutoAugment's posterize range is 4..8 kept bits (timm posterize_original),
    # unlike RandAugment's harsher 4..8-minus mapping in OPS
    bits = int(4 + level_0_10 / 10.0 * 4)
    return posterize(clip, bits)


def _aa_enhance_arg(mag_0_10, rng):
    # timm _enhance_level_to_arg: deterministic 0.1..1.9 — NOT the RandAugment
    # 'inc1' 1.0 +/- 0.09*level random-sign mapping (magnitude 0 must mean a
    # STRONG 0.1 enhance, e.g. the policy's ("Color", 0.4, 0) near-grayscale)
    return mag_0_10 / 10.0 * 1.8 + 0.1


# timm LEVEL_TO_ARG entries whose AutoAugment-'original' semantics differ
# from the RandAugment-'inc1' mappings in OPS. Solarize in particular is a
# plain threshold int(mag/10*256) — HIGHER magnitude = HIGHER threshold =
# MILDER (fewer pixels inverted); the inc1 mapping inverts that severity.
_AA_ARG_OVERRIDES = {
    "Solarize": lambda mag, rng: int(mag / 10.0 * 256),
    "Color": _aa_enhance_arg,
    "Contrast": _aa_enhance_arg,
    "Brightness": _aa_enhance_arg,
    "Sharpness": _aa_enhance_arg,
}


def auto_augment_original(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Apply one randomly drawn AutoAugment-'original' sub-policy.

    img: [H, W, 3] (or [T, H, W, 3]) float32 in 0..255. Returns same shape,
    clipped to 0..255.
    """
    squeeze = img.ndim == 3
    clip = img[None] if squeeze else img
    clip = np.clip(clip.astype(np.float32), 0, 255)
    sub = AUTO_AUGMENT_ORIGINAL_POLICY[
        int(rng.integers(0, len(AUTO_AUGMENT_ORIGINAL_POLICY)))
    ]
    for name, prob, magnitude in sub:
        if rng.random() > prob:
            continue
        if name == "PosterizeOriginal":
            clip = _posterize_original(clip, magnitude)
            continue
        fn, arg_fn = _OPS_BY_NAME[name]
        if name in _AA_ARG_OVERRIDES:
            arg = _AA_ARG_OVERRIDES[name](magnitude, rng)
        else:
            # geometric ops (Rotate/ShearX) share the signed OPS mapping;
            # policy magnitudes are already on the 0..10 _MAX_LEVEL scale
            arg = arg_fn(float(magnitude), rng)
        clip = np.clip(fn(np.clip(clip, 0, 255), arg), 0, 255)
    return clip[0] if squeeze else clip
