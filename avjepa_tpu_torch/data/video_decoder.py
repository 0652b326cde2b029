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
