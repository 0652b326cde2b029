"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Every ``*.cu`` under ``avjepa_tpu_torch/csrc/`` is compiled for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
are linked into one shared library with a plain C interface. No PyTorch
header is included, so a build takes seconds. The library lands in
``avjepa_tpu_torch/_build/``, named by a hash of the sources and the flags, so
an edited source rebuilds and an unchanged one loads the library already
built. Nothing is fetched: the build needs only ``nvcc`` and the sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the .log
)

log = logging.getLogger("avjepa_tpu_torch")


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.avj_attn_fwd_packed.argtypes = [
        i32, ptr, i64, i64, ptr, ptr, ptr, i64, i32, i32, i32, i32, f32, ptr,
    ]
    lib.avj_attn_fwd_packed.restype = i32
    lib.avj_attn_fwd.argtypes = [
        i32,
        ptr, i64, i64, i64,
        ptr, i64, i64, i64,
        ptr, i64, i64, i64,
        ptr, ptr, ptr, i64, i32, i32, i32, i32, f32, ptr,
    ]
    lib.avj_attn_fwd.restype = i32
    lib.avj_attn_bwd_packed.argtypes = [
        i32, ptr, i64, i64, ptr, i64, i64, ptr, ptr, ptr, i64, ptr,
        i32, i32, i32, i32, f32, ptr,
    ]
    lib.avj_attn_bwd_packed.restype = i32
    lib.avj_attn_bwd.argtypes = [
        i32,
        ptr, i64, i64, i64,
        ptr, i64, i64, i64,
        ptr, i64, i64, i64,
        ptr, ptr, ptr, ptr, i64, ptr, ptr, ptr,
        i32, i32, i32, i32, f32, ptr,
    ]
    lib.avj_attn_bwd.restype = i32
    lib.avj_attn_delta.argtypes = [i32, ptr, i64, i64, i64, ptr, i64, i64, i64, ptr,
                                   i32, i32, i32, i32, ptr]
    lib.avj_attn_delta.restype = i32
    lib.avj_ln_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, i64, i32, f32, ptr]
    lib.avj_ln_fwd.restype = i32
    lib.avj_ln_bwd_workspace.argtypes = [i32, i64, i32]
    lib.avj_ln_bwd_workspace.restype = i64
    lib.avj_ln_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, ptr, i64, i32, f32, ptr]
    lib.avj_ln_bwd.restype = i32
    lib.avj_error_string.argtypes = [i32]
    lib.avj_error_string.restype = ctypes.c_char_p


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile the kernels if their library is not built yet, then load it."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"libavjepa_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        for cmd in cmds:
            log.info("building CUDA kernels: %s", " ".join(cmd))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs) if proc.returncode]
        if not failed:
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True, check=False)
            outs.append(link.stdout + link.stderr)
            if link.returncode:
                failed = [(link.args, outs[-1])]
        lib_path.with_suffix(".log").write_text("\n".join(outs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            cmd, out = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-6000:]}")
        os.replace(tmp, lib_path)
        log.info("built %s in %.1f s", lib_path.name, time.perf_counter() - t0)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.avj_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
