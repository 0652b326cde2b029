"""ctypes bindings to the native libav decoder (native/avdecode.cpp); the
port's copy of ``avjepa_tpu/data/video_decoder.py``.

The C library releases the GIL during decode, so the thread-pool loader gets
real parallelism. It is built from ``native/`` with ``make`` at first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libavdecode.so"))
    if not os.path.exists(so):
        # build on demand (g++ + libav dev headers are part of the toolchain)
        subprocess.run(["make", "-C", os.path.dirname(so)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(so)
    lib.avdec_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.avdec_probe.restype = ctypes.c_int
    lib.avdec_decode_frames.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.avdec_decode_frames.restype = ctypes.c_int
    lib.avdec_decode_audio.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.avdec_decode_audio.restype = ctypes.c_long
    if hasattr(lib, "avdec_crop_resize_rgb"):
        lib.avdec_crop_resize_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ]
        lib.avdec_crop_resize_rgb.restype = ctypes.c_int
    if hasattr(lib, "avdec_write_test_video"):
        lib.avdec_write_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.avdec_write_test_video.restype = ctypes.c_int
    _LIB = lib
    return lib


def crop_resize_rgb(
    frames: np.ndarray, rects: np.ndarray, out_h: int, out_w: int
) -> np.ndarray:
    """Batched per-frame crop + bilinear resize via libswscale (GIL-free).

    frames: [T, H, W, 3] uint8 contiguous; rects: [T, 4] int32
    (top, left, crop_h, crop_w). Returns [T, out_h, out_w, 3] uint8.
    """
    lib = _load_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    rects = np.ascontiguousarray(rects, np.int32)
    t, h, w = frames.shape[:3]
    out = np.empty((t, out_h, out_w, 3), np.uint8)
    rc = lib.avdec_crop_resize_rgb(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), t, h, w,
        rects.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out_h, out_w,
    )
    if rc != 0:
        raise ValueError(f"crop_resize failed ({rc})")
    return out


class VideoFile:
    """Probe + decode interface for one media file."""

    def __init__(self, path: str):
        self.path = path
        lib = _load_lib()
        fps = ctypes.c_double()
        nf = ctypes.c_long()
        w = ctypes.c_int()
        h = ctypes.c_int()
        sr = ctypes.c_int()
        rc = lib.avdec_probe(path.encode(), ctypes.byref(fps), ctypes.byref(nf),
                             ctypes.byref(w), ctypes.byref(h), ctypes.byref(sr))
        if rc != 0:
            raise IOError(f"probe failed ({rc}): {path}")
        self.fps = fps.value
        self.num_frames = int(nf.value)
        self.width = int(w.value)
        self.height = int(h.value)
        self.sample_rate = int(sr.value)

    def decode_frames(self, indices: np.ndarray) -> np.ndarray:
        """Sorted frame indices -> [N, H, W, 3] uint8."""
        lib = _load_lib()
        indices = np.ascontiguousarray(np.asarray(indices, np.int64))
        # validate HERE so a buggy sampler raises a Python error instead of
        # tripping the native library's bounds guard (rc -22)
        if len(indices) and (indices[0] < 0 or np.any(np.diff(indices) < 0)):
            raise ValueError(
                f"frame indices must be sorted and non-negative: {indices[:8]}..."
            )
        n = len(indices)
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        rc = lib.avdec_decode_frames(
            self.path.encode(),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self.height,
            self.width,
        )
        if rc != 0:
            raise IOError(f"decode failed ({rc}): {self.path}")
        return out

    def decode_audio(self) -> tuple[np.ndarray, int]:
        """Full audio track as mono f32 + sample rate."""
        if self.sample_rate <= 0:
            raise IOError(f"no audio stream: {self.path}")
        lib = _load_lib()
        sr = ctypes.c_int()
        needed = lib.avdec_decode_audio(self.path.encode(), None, 0, ctypes.byref(sr))
        if needed <= 0:
            raise IOError(f"audio decode failed ({needed}): {self.path}")
        out = np.empty(int(needed), np.float32)
        got = lib.avdec_decode_audio(
            self.path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(needed),
            ctypes.byref(sr),
        )
        return out[: int(got)], int(sr.value)


def write_test_video(path: str, n_frames: int = 64, w: int = 128, h: int = 96,
                     fps: float = 25.0, with_audio: bool = True) -> None:
    """Encode a synthetic test clip (used by tests; needs the native lib)."""
    lib = _load_lib()
    rc = lib.avdec_write_test_video(
        path.encode(), n_frames, w, h, fps, 1 if with_audio else 0
    )
    if rc != 0:
        raise IOError(f"test video write failed ({rc})")


def write_av_clip(path: str, frames: "np.ndarray", fps: float = 25.0,
                  pcm: "np.ndarray | None" = None,
                  sample_rate: int = 44100) -> None:
    """Encode caller-provided content: ``frames`` [T, H, W, 3] uint8 RGB and
    optional mono ``pcm`` f32 in [-1, 1] -> AVI (MPEG4 + PCM_S16LE).

    The content-controllable sibling of :func:`write_test_video`; chain/test
    tooling uses it to author media with known class statistics (motion
    direction, tone frequency) so downstream evals can demonstrate learning
    against a random-encoder control."""
    lib = _load_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
    t, h, w, _ = frames.shape
    if pcm is not None:
        pcm = np.ascontiguousarray(pcm, np.float32)
        pcm_ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n_samples = len(pcm)
    else:
        pcm_ptr, n_samples = None, 0
    lib.avdec_encode_av.restype = ctypes.c_int
    lib.avdec_encode_av.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
    ]
    rc = lib.avdec_encode_av(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        t, w, h, fps, pcm_ptr, n_samples, sample_rate,
    )
    if rc != 0:
        raise IOError(f"av clip encode failed ({rc})")
