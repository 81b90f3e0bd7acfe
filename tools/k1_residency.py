#!/usr/bin/env python3
"""How the whole-solve L-BFGS-B kernel K1's register budget trades against
the warps an SM holds, at the headline, on one NVIDIA GPU.

Builds ``optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu`` alone
three times (nvcc, ``sm_90a``, in parallel, into ``chip_tree/
k1_residency/``, listed in ``.gitignore``) with ``-DK1_MIN_BLOCKS`` 2, 3 and
4: the blocks of 8 warps per SM that ``__launch_bounds__`` makes the
registers allow (128, 80 and 64 a thread).  For each it prints what
``ptxas`` reports for the float32 Rosenbrock kernels, the launch at the
headline (warps per block, resident warps per SM, registers, local bytes),
and the headline's converged fraction; then it times the headline
(10,240 x Rosenbrock-100, float32, box [-5, 5], m 5, pgtol 1e-3, factr
100, max_iter 600, starts ``RandomState(42)``) and its first 1,056 starts
through each build in turns (CUDA events around the launch, ROUNDS rounds,
the order alternating), and prints the medians.

    python3 tools/k1_residency.py
"""

import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "optimization_solvers_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "chip_tree", "k1_residency")
MIN_BLOCKS = (2, 3, 4)
ROUNDS = 6
B, N, M = 10_240, 100, 5


def nvcc():
    return os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")


def build():
    """Start the three builds together; returns {min_blocks: library}."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k in MIN_BLOCKS:
        lib = os.path.join(OUT, f"k1_min_blocks_{k}.so")
        procs[k] = (lib, subprocess.Popen(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared",
             f"-DK1_MIN_BLOCKS={k}", "-o", lib,
             os.path.join(SRC, "lbfgsb_fused.cu"),
             os.path.join(SRC, "lbfgsb_fused_data.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, (path, proc) in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for K1_MIN_BLOCKS={k}:\n"
                               + "\n".join(lines[-30:]))
        for j, line in enumerate(lines):
            if "Compiling entry" in line and "IfNS_10Rosenbrock" in line:
                body = "bounded" if "Lb0E" in line else "unbounded"
                print(f"K1_MIN_BLOCKS={k} float32 Rosenbrock {body}: "
                      + "; ".join(v.split(":", 1)[-1].strip()
                                  for v in lines[j + 1:j + 3]))
        lib = ctypes.CDLL(path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.lbfgsb_fused_launch.restype = i
        lib.lbfgsb_fused_launch.argtypes = [
            i, i, i, vp, vp, vp, i, vp, vp, i, vp, i, i, i, d, d, i, i, d,
            vp, vp, vp, vp, vp]
        lib.lbfgsb_fused_kernel_info.restype = i
        lib.lbfgsb_fused_kernel_info.argtypes = [i, i, i, i, i, i, i, i, vp]
        libs[k] = lib
    return libs


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_residency: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build()
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2.0, 2.0, (B, N)),
                      dtype=torch.float32, device=dev)
    lo = torch.full((N,), -5.0, device=dev)
    up = torch.full((N,), 5.0, device=dev)

    def launch(lib, x):
        b = x.shape[0]
        out = [torch.empty_like(x), torch.empty(b, device=dev),
               torch.empty(b, dtype=torch.int32, device=dev),
               torch.empty(b, dtype=torch.int32, device=dev)]
        rc = lib.lbfgsb_fused_launch(
            0, 0, 0, x.data_ptr(), lo.data_ptr(), up.data_ptr(), 0, None,
            None, 0, None, b, N, M, 1e-3, 100.0, 600, 20, 1e-3,
            *(t.data_ptr() for t in out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"lbfgsb_fused_launch returned {rc}")
        return out

    for k, lib in libs.items():
        info = (ctypes.c_int * 5)()
        lib.lbfgsb_fused_kernel_info(0, 0, 0, 0, B, N, M, 0,
                                     ctypes.addressof(info))
        _, f, _, st = launch(lib, x0)
        torch.cuda.synchronize()
        wpb, blocks, regs, local, _ = list(info)
        print(f"K1_MIN_BLOCKS={k}: {wpb} warps per block, {wpb * blocks} "
              f"resident warps per SM, {regs} registers, {local} local "
              f"bytes a thread; headline converged "
              f"{(st == 1).float().mean().item():.4f}, median f "
              f"{f.median().item():.4g}")
    times = {(k, b): [] for k in libs for b in (B, 1056)}
    for r in range(ROUNDS):
        for k in (MIN_BLOCKS if r % 2 == 0 else MIN_BLOCKS[::-1]):
            for b in (B, 1056):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(libs[k], x0[:b])
                stop.record()
                torch.cuda.synchronize()
                times[k, b].append(start.elapsed_time(stop))
    for (k, b), ts in times.items():
        print(f"K1_MIN_BLOCKS={k}, B = {b}: median {statistics.median(ts):.3f}"
              f" ms (min {min(ts):.3f}, max {max(ts):.3f}; {ROUNDS} rounds "
              f"in turns)  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
