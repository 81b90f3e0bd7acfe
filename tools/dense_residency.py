#!/usr/bin/env python3
"""How the dense quasi-Newton kernels' block trades warps against
residency, and the packed triangle against the full slab, at config 2 on
one NVIDIA GPU.

Builds K3's dense form (``ops/csrc/driver.cu`` with ``driver_dense.cu``;
the other forms answer with an error) and K9 (``ops/csrc/bfgs_fused.cu``)
once per variant (nvcc, ``sm_90a``, all in parallel, into
``chip_tree/dense_residency/``, listed in ``.gitignore``):

* ``DENSE_WARPS`` 2, 4 and 8 warps per instance, with the blocks per SM
  that ``__launch_bounds__`` makes the registers allow
  (``DENSE_MIN_BLOCKS``: 8, 8 and 4: 128, 64 and 64 registers a thread),
  and 4 warps at 4 blocks (128 registers);
* two designs the kernels do not ship, each built from a copy of the
  sources with one line patched (``PATCHES``): the full (n, n) slab for
  the symmetric kinds (stride ``n | 1``, B v by rows, as Broyden's), and
  K3's block commands called instead of inlined, both at 4 warps.

For each it prints the launch (threads per block, resident blocks per SM,
registers, local bytes, shared memory) and the converged and success
fractions; then it times config 2 as the bench calls it (1,024 x
Rosenbrock-100, float32, dense BFGS with tol 2e-4, ``scale_b0`` and
``restart_on_degeneracy`` + More-Thuente, max_iter 1,500, max_iter_ls 40,
starts ``RandomState(42)`` uniform(-2, 2)) through K3 and K9's workload
(the same starts, tol 1e-5, max_iter 600, max_iter_ls 24) through each
build in turns (CUDA events around the launch, ROUNDS rounds, the order
alternating) and prints the medians.

    python3 tools/dense_residency.py
"""

import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "optimization_solvers_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "chip_tree", "dense_residency")
# name -> (nvcc defines, the patch of PATCHES its sources take or None)
VARIANTS = {
    "2 warps, 8 blocks": (["-DDENSE_WARPS=2", "-DDENSE_MIN_BLOCKS=8"], None),
    "4 warps, 8 blocks": (["-DDENSE_WARPS=4", "-DDENSE_MIN_BLOCKS=8"], None),
    "4 warps, 4 blocks": (["-DDENSE_WARPS=4", "-DDENSE_MIN_BLOCKS=4"], None),
    "8 warps, 4 blocks": (["-DDENSE_WARPS=8", "-DDENSE_MIN_BLOCKS=4"], None),
    "4 warps, full slab": (["-DDENSE_WARPS=4", "-DDENSE_MIN_BLOCKS=8"],
                           "full slab"),
    "4 warps, 8 blocks, K3's commands called": (
        ["-DDENSE_WARPS=4", "-DDENSE_MIN_BLOCKS=8"], "called commands"),
}
# patch -> (source file, the line as shipped, the line of the variant)
PATCHES = {
    "full slab": (
        "dense_slab.cuh",
        "inline bool slab_packed(int kind) { return kind != kSlabBroyden; }",
        "inline bool slab_packed(int kind) { return false; }"),
    "called commands": (
        "driver.cuh",
        "__device__ __forceinline__ void dense_command(",
        "__device__ __noinline__ void dense_command("),
}
ROUNDS = 5
B, N = 1024, 100
# K3's C interface reaches the other forms; only the dense form is built
K3_UNIT = """#include "driver.cu"
#include "driver_dense.cu"
#include "driver_dense_data.cu"
namespace ost_driver {
template <typename T> int launch_qn(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template <typename T> int launch_newton(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template int launch_qn<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn<double>(const Params<double>&, int, cudaStream_t);
template int launch_newton<float>(const Params<float>&, int, cudaStream_t);
template int launch_newton<double>(const Params<double>&, int, cudaStream_t);
}  // namespace ost_driver
"""


def nvcc():
    return os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")


def sources(patch):
    """The directory of the sources a variant builds: the package's, or a
    copy under OUT with the patch's one line replaced."""
    if patch is None:
        return SRC
    path, old, new = PATCHES[patch]
    dst = os.path.join(OUT, "src_" + patch.replace(" ", "_"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(SRC, dst)
    with open(os.path.join(dst, path)) as fh:
        text = fh.read()
    if text.count(old) != 1:
        raise RuntimeError(f"{path} no longer holds the line the "
                           f"{patch!r} variant patches: {old!r}")
    with open(os.path.join(dst, path), "w") as fh:
        fh.write(text.replace(old, new))
    return dst


def build():
    """Start every build together; returns {variant: (K3 lib, K9 lib)}."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, (defines, patch)) in enumerate(VARIANTS.items()):
        src = sources(patch)
        unit = os.path.join(OUT, f"k3_dense_unit_{k}.cu")
        with open(unit, "w") as fh:
            fh.write(K3_UNIT)
        for kernel, paths in (("k3", [unit]),
                              ("k9", [os.path.join(src, "bfgs_fused.cu"),
                                      os.path.join(src,
                                                   "bfgs_fused_data.cu")])):
            lib = os.path.join(OUT, f"{kernel}_{k}.so")
            procs[name, kernel] = (lib, subprocess.Popen(
                [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
                 "-shared", "-I", src, *defines, "-o", lib, *paths],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, kernel), (path, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({kernel}):\n"
                               + "\n".join(out.splitlines()[-30:]))
        libs.setdefault(name, {})[kernel] = ctypes.CDLL(path)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for pair in libs.values():
        k3, k9 = pair["k3"], pair["k9"]
        k3.driver_launch.restype = i
        k3.driver_launch.argtypes = [
            i, i, vp, vp, vp, i, vp, vp, vp, i, i, ctypes.POINTER(i),
            ctypes.POINTER(d), i, i, vp, vp, vp, vp, vp, vp, vp]
        k3.driver_workspace_elems.restype = ctypes.c_longlong
        k3.driver_workspace_elems.argtypes = [ctypes.c_longlong, i, i, i, i,
                                              i, i]
        k3.driver_dense_info.argtypes = [i, i, i, i, vp]
        k9.bfgs_fused_launch.restype = i
        k9.bfgs_fused_launch.argtypes = [
            i, i, vp, vp, vp, i, i, i, d, i, i, d, vp, vp, vp, vp, vp, vp, vp,
            vp]
        k9.bfgs_fused_workspace_elems.restype = ctypes.c_longlong
        k9.bfgs_fused_workspace_elems.argtypes = [ctypes.c_longlong, i, i, i]
        k9.bfgs_fused_info.argtypes = [i, i, vp]
    return libs


def launch_line(v):
    where = {1: "shared memory", 2: "the workspace"}.get(v[5], "?")
    return (f"{v[0]} threads per block, {v[1]} resident blocks per SM, "
            f"{v[2]} registers, {v[3]} local bytes a thread, {v[4]} bytes of "
            f"shared memory, slabs in {where}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dense_residency: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from optimization_solvers_tpu_torch import linesearch as ls, solvers
    from optimization_solvers_tpu_torch.ops import fused_driver

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build()
    print(f"built {2 * len(libs)} libraries in {time.perf_counter() - t0:.1f}"
          " s")
    dev = torch.device("cuda")
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2.0, 2.0, (B, N)),
                      dtype=torch.float32, device=dev)
    spec = fused_driver.build_spec(
        solvers.QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
                            restart_on_degeneracy=True), ls.MoreThuente())
    ints, doubles = fused_driver._slots(spec, torch.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def outputs():
        return [torch.empty_like(x0), torch.empty(B, device=dev),
                *(torch.empty(B, dtype=torch.int32, device=dev)
                  for _ in range(4))]

    def k3_launch(lib):
        out = outputs()
        elems = lib.driver_workspace_elems(B, N, spec.method, spec.ring,
                                           spec.qn_update, 0, 4)
        work = torch.empty(max(elems, 1), device=dev)
        rc = lib.driver_launch(
            0, 0, x0.data_ptr(), None, None, 0, None, None, None, B, N, ints,
            doubles, 1500, 40, work.data_ptr() if elems else None,
            *(t.data_ptr() for t in out[:5]), stream)
        if rc != 0:
            raise RuntimeError(f"driver_launch returned {rc}")
        return out

    def k9_launch(lib):
        out = outputs()
        elems = lib.bfgs_fused_workspace_elems(B, N, 0, 4)
        work = torch.empty(max(elems, 1), device=dev)
        rc = lib.bfgs_fused_launch(
            0, 0, x0.data_ptr(), None, None, 0, B, N, 1e-5, 600, 24, 1e-4,
            work.data_ptr() if elems else None,
            *(t.data_ptr() for t in out), stream)
        if rc != 0:
            raise RuntimeError(f"bfgs_fused_launch returned {rc}")
        return out

    runs = {"config 2 (K3)": k3_launch, "K9": k9_launch}
    for name, pair in libs.items():
        info3, info9 = (ctypes.c_int * 6)(), (ctypes.c_int * 6)()
        pair["k3"].driver_dense_info(0, N, 0, 0, ctypes.addressof(info3))
        pair["k9"].bfgs_fused_info(0, N, ctypes.addressof(info9))
        st3 = k3_launch(pair["k3"])[3]
        st9 = k9_launch(pair["k9"])[3]
        torch.cuda.synchronize()
        print(f"{name}: K3 {launch_line(list(info3))}; status 1 "
              f"(converged or stalled) {(st3 == 1).float().mean().item():.4f};"
              f" K9 {launch_line(list(info9))}; converged "
              f"{(st9 == 1).float().mean().item():.4f}")
    names = list(libs)
    times = {(v, r): [] for v in names for r in runs}
    for rnd in range(ROUNDS):
        for v in (names if rnd % 2 == 0 else names[::-1]):
            for r, fn in runs.items():
                lib = libs[v]["k3" if r.startswith("config") else "k9"]
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(lib)
                stop.record()
                torch.cuda.synchronize()
                times[v, r].append(start.elapsed_time(stop))
    for (v, r), ts in times.items():
        print(f"{r}, {v}: median {statistics.median(ts):.3f} ms (min "
              f"{min(ts):.3f}, max {max(ts):.3f}; {ROUNDS} rounds in turns)"
              f"  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
