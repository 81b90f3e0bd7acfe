#!/usr/bin/env python3
"""Where the whole-solve L-BFGS kernel K7's time goes, on one NVIDIA GPU.

Builds ``optimization_solvers_tpu_torch/ops/csrc/lbfgs_fused.cu`` alone
(nvcc, ``sm_90a``, the builds in parallel, into ``chip_tree/k7_profile/``,
listed in ``.gitignore``): once with ``-DK7_PROFILE``, which compiles in the
kernel's ``clock64`` counters (lane 0 of each warp times the phases of every
iteration of its instance), and once as shipped.  At ``chip_smoke.py``'s K7
inputs (the headline's without the box: 10,240 x Rosenbrock-100, float32,
m 5, tol 1e-3 on max|g|, max_iter 600, max_iter_ls 16, c1 1e-4, starts
``RandomState(42)`` uniform(-2, 2)) it prints each phase's share of the
summed per-warp cycles, the cycles per instance-iteration and the Armijo
trials per iteration (full solves, and capped at 1 and 10 iterations);
what ``ptxas`` reports for the float32 Rosenbrock kernel (registers,
spills) and the launch (warps per block, resident warps per SM); then a
batch sweep of the shipped build (B = 132, 1,056, 4,224, 10,240: the
first B starts, CUDA events, median of ROUNDS), which shows the wave tail:
a block holds its SM slot until its slowest instance ends.  The counters
cost time of their own, so only the shipped build is timed.

``--residency`` also builds the shipped source with ``-DK7_MIN_BLOCKS`` 2,
3 and 4 (the blocks of 8 warps per SM that ``__launch_bounds__`` makes the
registers allow: 16, 24 and 32 warps) and times them in turns at B =
10,240 and 1,056.

    python3 tools/k7_phase_profile.py [--residency]
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "optimization_solvers_tpu_torch", "ops", "csrc",
                   "lbfgs_fused.cu")
OUT = os.path.join(ROOT, "chip_tree", "k7_profile")
# the kernel's counters k7_prof[0..4], in order
PHASES = ["direction", "Armijo trials", "value-gradient after the search",
          "checks and ring write", "stopping test"]
B, N, M, TOL, MAX_ITER, LS, C1 = 10_240, 100, 5, 1e-3, 600, 16, 1e-4
SWEEP = (132, 1056, 4224, 10_240)
ROUNDS = 5
MIN_BLOCKS = (2, 3, 4)


def nvcc():
    return os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")


def build(variants):
    """Start one build per variant (name -> extra nvcc flags) together;
    returns {name: loaded library}, after printing ptxas's lines for the
    float32 Rosenbrock kernel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        lib = os.path.join(OUT, f"k7_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", *flags,
             "-o", lib, SRC],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + "\n".join(lines[-30:]))
        for j, line in enumerate(lines):
            if ("Compiling entry" in line and "IfNS_10Rosenbrock" in line):
                print(f"{name}: float32 Rosenbrock kernel: "
                      + "; ".join(v.split(":", 1)[-1].strip()
                                  for v in lines[j + 1:j + 3]))
        lib = ctypes.CDLL(path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.lbfgs_fused_launch.restype = i
        lib.lbfgs_fused_launch.argtypes = [
            i, i, vp, vp, vp, i, i, i, d, i, i, d, vp, vp, vp, vp, vp, vp]
        lib.lbfgs_fused_kernel_info.restype = i
        lib.lbfgs_fused_kernel_info.argtypes = [i, i, i, i, vp]
        libs[name] = lib
    return libs


def main(argv=None):
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--residency", action="store_true",
                        help="also time K7_MIN_BLOCKS 2, 3 and 4 in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    variants = {"profile": ["-DK7_PROFILE"], "shipped": []}
    if args.residency:
        variants.update({f"min_blocks_{k}": [f"-DK7_MIN_BLOCKS={k}"]
                         for k in MIN_BLOCKS})
    t0 = time.perf_counter()
    libs = build(variants)
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2.0, 2.0, (B, N)),
                      dtype=torch.float32, device=dev)

    def launch(lib, x, max_iter=MAX_ITER):
        b = x.shape[0]
        out = [torch.empty_like(x), torch.empty(b, device=dev),
               *(torch.empty(b, dtype=torch.int32, device=dev)
                 for _ in range(3))]
        rc = lib.lbfgs_fused_launch(
            0, 0, x.data_ptr(), None, None, b, N, M, TOL, max_iter, LS, C1,
            *(t.data_ptr() for t in out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"lbfgs_fused_launch returned {rc}")
        return out

    def info(lib, b):
        out = (ctypes.c_int * 5)()
        rc = lib.lbfgs_fused_kernel_info(0, b, N, M, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"lbfgs_fused_kernel_info returned {rc}")
        wpb, blocks, regs, local, smem = list(out)
        return (f"{wpb} warps per block, {wpb * blocks} resident warps per "
                f"SM, {regs} registers, {local} local bytes a thread, {smem} "
                f"bytes of shared memory a block")

    for name, lib in libs.items():
        _, f, it, st, _ = launch(lib, x0)
        torch.cuda.synchronize()
        print(f"{name}: {info(lib, B)}; converged "
              f"{(st == 1).float().mean().item():.4f}, median f "
              f"{f.median().item():.4g}, median iterations "
              f"{it.float().median().item():.0f} (max {it.max().item()})")

    prof = libs["profile"]
    prof.k7_prof_read.argtypes = [ctypes.c_void_p]
    for max_iter in (MAX_ITER, 1, 10):
        prof.k7_prof_reset()
        launch(prof, x0, max_iter)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        prof.k7_prof_read(ctypes.addressof(buf))
        v = list(buf)
        total = sum(v[:5])
        its = max(v[5], 1)
        print(f"max_iter {max_iter}: {v[7]} instances, {v[5]} "
              f"instance-iterations, {v[6] / its:.3f} Armijo trials per "
              f"iteration; cycles per instance-iteration {total / its:.0f}, "
              f"the loop {total / max(v[8], 1):.3f} of the instances' "
              f"cycles")
        print("   " + "; ".join(f"{name} {v[k] / total:.3f}"
                                for k, name in enumerate(PHASES)))

    def timed(lib, b):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(lib, x0[:b])
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    shipped = libs["shipped"]
    for b in SWEEP:
        ts = [timed(shipped, b) for _ in range(ROUNDS)]
        print(f"shipped, B = {b}: {info(shipped, b)}; median "
              f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}; {ROUNDS} calls)  [{card}]")
    if args.residency:
        names = [f"min_blocks_{k}" for k in MIN_BLOCKS]
        times = {(k, b): [] for k in names for b in (B, 1056)}
        for r in range(ROUNDS):
            for k in (names if r % 2 == 0 else names[::-1]):
                for b in (B, 1056):
                    times[k, b].append(timed(libs[k], b))
        for (k, b), ts in times.items():
            print(f"{k}, B = {b}: median {statistics.median(ts):.3f} ms "
                  f"(min {min(ts):.3f}, max {max(ts):.3f}; {ROUNDS} rounds "
                  f"in turns)  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
