"""Build and load the CUDA kernels of ``ops/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ctypes.  The library is built
at first use and rebuilt when a source is newer, into
``optimization_solvers_tpu_torch/_build/`` (not tracked by git).  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libost_torch_kernels.so")
LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of optimization_solvers_tpu_torch "
        "build only where the CUDA toolkit is installed (a CPU tensor takes "
        "the plain PyTorch version instead)")


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or older than a
    source; returns the library's path.  The compiler's output, with
    ``ptxas`` register and spill counts, is kept in ``_build/build.log``."""
    deps = _sources() + sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))
    if not force and os.path.exists(LIB) and all(
            os.path.getmtime(s) <= os.path.getmtime(LIB) for s in deps):
        return LIB
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()],
                          capture_output=True, text=True)
    with open(LOG, "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)          # atomic: a concurrent loader sees old or new
    return LIB


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            lib.lbfgsb_fused_smem_per_warp.restype = ctypes.c_longlong
            lib.lbfgsb_fused_smem_per_warp.argtypes = [i, i, i]
            lib.lbfgsb_fused_launch.restype = i
            lib.lbfgsb_fused_launch.argtypes = [
                i, i, i,                 # dtype, objective, unbounded
                vp, vp, vp, i,           # x0, lower, upper, bound stride
                vp, vp,                  # objective data
                i, i, i,                 # B, n, m
                d, d, i, i, d,           # pgtol, factr, max_iter, ls, c1
                vp, vp, vp, vp,          # x, f, iterations, status
                vp,                      # stream
            ]
            lib.ost_error_string.restype = ctypes.c_char_p
            lib.ost_error_string.argtypes = [i]
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().ost_error_string(int(code)).decode()
