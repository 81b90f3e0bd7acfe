"""Build and load the CUDA kernels of ``ops/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
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
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libost_torch_kernels.so")
LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

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
    ``ptxas`` register and spill counts and each source's seconds from the
    start of the build (``== name: t s``), is kept in
    ``_build/build.log``."""
    deps = _sources() + sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))
    if not force and os.path.exists(LIB) and all(
            os.path.getmtime(s) <= os.path.getmtime(LIB) for s in deps):
        return LIB
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in _sources()]
    start = time.monotonic()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(_sources(), objs)]
    outs = [None] * len(procs)

    def wait(k):
        out = procs[k].communicate()[0]
        outs[k] = (f"{out}== {os.path.basename(_sources()[k])}: "
                   f"{time.monotonic() - start:.1f} s\n", procs[k].returncode)

    waiters = [threading.Thread(target=wait, args=(k,))
               for k in range(len(procs))]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join()
    tmp = f"{LIB}.{tag}"
    if all(rc == 0 for _, rc in outs):
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        outs.append((link.stdout + link.stderr, link.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(out for out, _ in outs)
    with open(LOG, "w") as fh:
        fh.write(log)
    failed = [rc for _, rc in outs if rc != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
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
            lib.lbfgsb_fused_smem_per_warp.argtypes = [i, i, i, i]
            lib.lbfgsb_fused_launch.restype = i
            lib.lbfgsb_fused_launch.argtypes = [
                i, i, i,                 # dtype, objective, unbounded
                vp, vp, vp, i,           # x0, lower, upper, bound stride
                vp, vp, i,               # objective data, LOG_SUM_EXP rows
                vp,                      # scale (null: unscaled)
                i, i, i,                 # B, n, m
                d, d, i, i, d,           # pgtol, factr, max_iter, ls, c1
                vp, vp, vp, vp,          # x, f, iterations, status
                vp,                      # stream
            ]
            lib.lbfgsb_fused_kernel_info.restype = i
            lib.lbfgsb_fused_kernel_info.argtypes = [
                i, i, i, i,              # dtype, objective, unbounded, scaled
                i, i, i, i,              # B, n, m, LOG_SUM_EXP rows
                ctypes.POINTER(i),       # out: 5 ints
            ]
            lib.lbfgsb_tall_work_elems.restype = ctypes.c_longlong
            lib.lbfgsb_tall_work_elems.argtypes = [i, i, i]
            lib.lbfgsb_tall_fit_tile.restype = i
            lib.lbfgsb_tall_fit_tile.argtypes = [i, i, i, i, i]
            lib.lbfgsb_tall_fit_groups.restype = i
            lib.lbfgsb_tall_fit_groups.argtypes = [i, i, i, i, i]
            lib.lbfgsb_tall_launch.restype = i
            lib.lbfgsb_tall_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp, i,           # x0, lower, upper, bound stride
                vp, vp, i,               # objective data, LOG_SUM_EXP rows
                i, i, i, i, i,           # B, n, m, tile, groups
                d, d, i, i, d,           # pgtol, factr, max_iter, ls, c1
                i, i, i,                 # bisect_iters, guard, line search
                vp,                      # workspace
                vp, vp, vp, vp, vp,      # x, f, iterations, status, flag
                vp,                      # stream
            ]
            lib.driver_smem_per_warp.restype = ctypes.c_longlong
            lib.driver_smem_per_warp.argtypes = [i, i, i, i, i]
            lib.driver_smem_newton.restype = ctypes.c_longlong
            lib.driver_smem_newton.argtypes = [i, i, i, i]
            lib.driver_workspace_elems.restype = ctypes.c_longlong
            lib.driver_workspace_elems.argtypes = [
                ctypes.c_longlong, i, i,  # B, n, method
                i, i, i, i,               # ring, update kind, rows, element size
            ]
            lib.driver_dense_info.restype = i
            lib.driver_dense_info.argtypes = [
                i, i, i, i,              # dtype, n, ring, update kind
                ctypes.POINTER(i),       # out: 6 ints
            ]
            lib.driver_first_info.restype = i
            lib.driver_first_info.argtypes = [
                i, i, i, i, i,           # dtype, B, n, ring, method
                ctypes.POINTER(i),       # out: 6 ints
            ]
            lib.driver_smem_dense.restype = ctypes.c_longlong
            lib.driver_smem_dense.argtypes = [i, i, i, i, i]
            lib.driver_launch.restype = i
            lib.driver_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp, i,           # x0, lower, upper, bound stride
                vp, vp, vp,              # objective data, inverse_p
                i, i,                    # B, n
                ctypes.POINTER(i),       # int parameter slots
                ctypes.POINTER(d),       # double parameter slots
                i, i,                    # max_iter, max_iter_ls
                vp,                      # workspace (QN and Newton slabs)
                vp, vp, vp, vp, vp,      # x, f, iterations, status, nfev
                vp,                      # stream
            ]
            lib.newton_cg_smem_per_warp.restype = ctypes.c_longlong
            lib.newton_cg_smem_per_warp.argtypes = [i, i, i]
            lib.newton_cg_kernel_info.restype = i
            lib.newton_cg_kernel_info.argtypes = [
                i, i, i,                 # dtype, B, n
                ctypes.POINTER(i),       # out: 5 ints
            ]
            lib.newton_cg_launch.restype = i
            lib.newton_cg_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp,              # x0, lower, upper
                vp, vp, i,               # objective data, LOG_SUM_EXP rows
                i, i,                    # B, n
                d, d, d,                 # pgtol, factr * eps, eps
                i, i, i, d,              # max_iter, cg_max, ls, c1
                vp, vp, vp, vp,          # x, f, iterations, status
                vp, vp,                  # HVP and trial counts
                vp,                      # stream
            ]
            lib.qn_update_smem_elems.restype = ctypes.c_longlong
            lib.qn_update_smem_elems.argtypes = [i]
            lib.qn_update_launch.restype = i
            lib.qn_update_launch.argtypes = [
                i,                       # dtype
                vp, vp, vp, vp,          # B, s, y, g
                vp, vp,                  # B', B' g
                i, i, i, d,              # batch, n, kind, tol
                vp,                      # stream
            ]
            lib.cholesky_solve_panel.restype = i
            lib.cholesky_solve_panel.argtypes = [i, i]
            lib.cholesky_solve_launch.restype = i
            lib.cholesky_solve_launch.argtypes = [
                i,                       # dtype
                vp, vp,                  # H, g
                vp, vp,                  # workspace (the factors), x
                i, i,                    # B, n
                vp,                      # stream
            ]
            lib.lbfgs_fused_smem_per_warp.restype = ctypes.c_longlong
            lib.lbfgs_fused_smem_per_warp.argtypes = [i, i, i]
            lib.lbfgs_fused_kernel_info.restype = i
            lib.lbfgs_fused_kernel_info.argtypes = [
                i, i, i, i,              # dtype, B, n, m
                ctypes.POINTER(i),       # out: 5 ints
            ]
            lib.lbfgs_fused_launch.restype = i
            lib.lbfgs_fused_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp,              # x0, objective data
                i, i, i,                 # B, n, m
                d, i, i, d,              # tol, max_iter, ls, c1
                vp, vp, vp, vp, vp,      # x, f, iterations, status, trials
                vp,                      # stream
            ]
            lib.spg_fused_smem_per_warp.restype = ctypes.c_longlong
            lib.spg_fused_smem_per_warp.argtypes = [i, i, i]
            lib.spg_fused_info.restype = i
            lib.spg_fused_info.argtypes = [
                i, i, i, i,              # dtype, B, n, gll_m
                ctypes.POINTER(i),       # out: 6 ints
            ]
            lib.spg_fused_launch.restype = i
            lib.spg_fused_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp,              # x0, lower, upper
                vp, vp,                  # objective data
                i, i,                    # B, n
                d, d, d, i, d,           # tol, lam_min, lam_max, gll_m, c1
                i, i,                    # max_iter, ls
                vp, vp, vp, vp, vp,      # x, f, iterations, status, trials
                vp,                      # stream
            ]
            lib.bfgs_fused_workspace_elems.restype = ctypes.c_longlong
            lib.bfgs_fused_workspace_elems.argtypes = [ctypes.c_longlong,
                                                       i, i, i]
            lib.bfgs_fused_smem.restype = ctypes.c_longlong
            lib.bfgs_fused_smem.argtypes = [i, i, i]
            lib.bfgs_fused_info.restype = i
            lib.bfgs_fused_info.argtypes = [i, i, ctypes.POINTER(i)]
            lib.bfgs_fused_launch.restype = i
            lib.bfgs_fused_launch.argtypes = [
                i, i,                    # dtype, objective
                vp, vp, vp, i,           # x0, objective data, LOG_SUM_EXP rows
                i, i,                    # B, n
                d, i, i, d,              # tol, max_iter, ls, c1
                vp,                      # workspace (or None: shared memory)
                vp, vp, vp, vp,          # x, f, iterations, status
                vp, vp,                  # trials, updates
                vp,                      # stream
            ]
            lib.ost_error_string.restype = ctypes.c_char_p
            lib.ost_error_string.argtypes = [i]
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().ost_error_string(int(code)).decode()
