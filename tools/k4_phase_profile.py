#!/usr/bin/env python3
"""Where the Newton-CG kernel K4's time goes, on one NVIDIA GPU.

Builds ``optimization_solvers_tpu_torch/ops/csrc/newton_cg.cu`` alone (or
the ``newton_cg.cu`` of another checkout's package, ``--root``; nvcc,
``sm_90a``, the builds in parallel, into ``chip_tree/k4_profile/``, listed
in ``.gitignore``): once with ``-DK4_PROFILE``, which compiles in the
kernel's ``clock64`` counters (lane 0 of each warp times the phases of its
instance), and once as shipped.  At the Newton-CG headline (10,240 x
Rosenbrock-100, float32, box [-5, 5], pgtol 1e-3, factr 100, max_iter 600,
cg_max 12, max_iter_ls 25, c1 1e-4, starts ``RandomState(42)``
uniform(-2, 2)) it prints:

* what ``ptxas`` reports for the float32 Rosenbrock kernel (registers,
  spills) and the launch (warps per block, resident warps per SM);
* each phase's share of the summed per-warp cycles, the cycles per
  instance-iteration and per Hessian-vector product (CG step), and HVPs
  and trials per iteration (full solves, and capped at 1 and 10
  iterations); the counters cost time of their own, so only the shipped
  build is timed;
* the spread of iterations, HVPs and trials across instances (median, p99,
  max) from the kernel's own counts;
* a batch sweep of the shipped build (B = 132, 1,056, 4,224, 8,448,
  10,240: the first B starts, CUDA events, median of ROUNDS);
* the host's share of ``minimize(method="newton_cg")`` at the headline,
  with the shipped build as the package's kernel library: ``torch.profiler``
  device time against the wall (median of ROUNDS calls), and the kernel's
  launch alone (CUDA events).

``--residency`` also builds the source with ``-DK4_MIN_BLOCKS`` 2, 3 and 4
(the blocks of 8 warps per SM that ``__launch_bounds__`` asks the float32
register layout's registers to allow; the source's default is 3), and
``--variants NAME=FLAG[,FLAG] ...`` with those nvcc flags; each is timed in
turns with the shipped build (B = 10,240 and 1,056).

    python3 tools/k4_phase_profile.py [--root DIR] [--residency] [--variants ...]
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chip_tree", "k4_profile")
# the kernel's counters k4_prof[0..5], in order
PHASES = ["free mask and norms", "CG passes", "HVPs", "CG reductions",
          "trials", "step and value-gradient"]
B, N, BOX = 10_240, 100, 5.0
PGTOL, FACTR, MAX_ITER, CG_MAX, LS, C1 = 1e-3, 100.0, 600, 12, 25, 1e-4
SWEEP = (132, 1056, 4224, 8448, 10_240)
MIN_BLOCKS = (2, 3, 4)
ROUNDS = 5


def nvcc():
    return os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")


def build(src, variants):
    """Start one build of ``src`` per variant (name -> extra nvcc flags)
    together; returns {name: loaded library}, after printing ptxas's lines
    for the float32 Rosenbrock kernel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        lib = os.path.join(OUT, f"k4_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", *flags,
             "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               + "\n".join(lines[-30:]))
        for j, line in enumerate(lines):
            if "Compiling entry" in line and "newton_cg" in line and (
                    "IfNS_10Rosenbrock" in line):
                print(f"{name}: float32 Rosenbrock kernel: "
                      + "; ".join(v.split(":", 1)[-1].strip()
                                  for v in lines[j + 1:j + 3]))
        lib = ctypes.CDLL(path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.newton_cg_launch.restype = i
        lib.newton_cg_launch.argtypes = [
            i, i, vp, vp, vp, vp, vp, i, i, i, d, d, d, i, i, i, d,
            vp, vp, vp, vp, vp, vp, vp]
        lib.newton_cg_smem_per_warp.restype = ctypes.c_longlong
        lib.newton_cg_smem_per_warp.argtypes = [i, i, i]
        lib.newton_cg_kernel_info.restype = i
        lib.newton_cg_kernel_info.argtypes = [i, i, i, vp]
        libs[name] = lib
    return libs


def quantiles(v):
    import torch

    v = v.double()
    return (f"median {v.median().item():.0f}, p99 "
            f"{torch.quantile(v, 0.99).item():.0f}, max {v.max().item():.0f}, "
            f"mean {v.mean().item():.1f}")


def main(argv=None):
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="checkout whose newton_cg.cu to build")
    parser.add_argument("--residency", action="store_true",
                        help="also time K4_MIN_BLOCKS 2, 3 and 4 in turns")
    parser.add_argument("--variants", nargs="*", default=[],
                        metavar="NAME=FLAG[,FLAG]",
                        help="extra builds timed in turns with the shipped one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    src = os.path.join(os.path.abspath(args.root), "optimization_solvers_tpu_torch",
                       "ops", "csrc", "newton_cg.cu")
    variants = {"profile": ["-DK4_PROFILE"], "shipped": []}
    if args.residency:
        variants.update({f"min_blocks_{k}": [f"-DK4_MIN_BLOCKS={k}"]
                         for k in MIN_BLOCKS})
    for v in args.variants:
        name, flags = v.split("=", 1)
        variants[name] = [f for f in flags.split(",") if f]
    t0 = time.perf_counter()
    libs = build(src, variants)
    print(f"{src}: built {len(libs)} copies in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    dev = torch.device("cuda")
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2.0, 2.0, (B, N)),
                      dtype=torch.float32, device=dev)
    lo = torch.full((N,), -BOX, device=dev)
    up = torch.full((N,), BOX, device=dev)
    eps = float(torch.finfo(torch.float32).eps)

    def launch(lib, x, max_iter=MAX_ITER):
        b = x.shape[0]
        out = [torch.empty_like(x), torch.empty(b, device=dev),
               *(torch.empty(b, dtype=torch.int32, device=dev)
                 for _ in range(4))]
        rc = lib.newton_cg_launch(
            0, 0, x.data_ptr(), lo.data_ptr(), up.data_ptr(), None, None, 0,
            b, N, PGTOL, FACTR * eps, eps, max_iter, CG_MAX, LS, C1,
            *(t.data_ptr() for t in out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"newton_cg_launch returned {rc}")
        return out

    def info(lib, b):
        out = (ctypes.c_int * 5)()
        rc = lib.newton_cg_kernel_info(0, b, N, ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"newton_cg_kernel_info returned {rc}")
        wpb, blocks, regs, local, smem = list(out)
        return (f"{wpb} warps per block, {wpb * blocks} resident warps per "
                f"SM, {regs} registers, {local} local bytes a thread, {smem} "
                f"bytes of shared memory a block")

    for name, lib in libs.items():
        _, f, it, st, ncg, nfev = launch(lib, x0)
        torch.cuda.synchronize()
        print(f"{name}: {info(lib, B)}; converged "
              f"{(st == 1).float().mean().item():.4f}, median f "
              f"{f.median().item():.4g}, median iterations "
              f"{it.float().median().item():.0f} (max {it.max().item()})")

    prof = libs["profile"]
    prof.k4_prof_read.restype = prof.k4_prof_reset.restype = ctypes.c_int
    prof.k4_prof_read.argtypes = [ctypes.c_void_p]
    prof.k4_prof_reset.argtypes = []
    for max_iter in (MAX_ITER, 1, 10):
        prof.k4_prof_reset()
        launch(prof, x0, max_iter)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        prof.k4_prof_read(ctypes.addressof(buf))
        v = list(buf)
        total = sum(v[:6])
        its, hvps = max(v[6], 1), max(v[7], 1)
        print(f"max_iter {max_iter}: {v[9]} instances, {v[6]} "
              f"instance-iterations, {v[7] / its:.3f} HVPs and {v[8] / its:.3f}"
              f" trials per iteration; cycles per instance-iteration "
              f"{total / its:.0f}, per HVP (CG passes, HVP, reductions) "
              f"{sum(v[1:4]) / hvps:.0f}; the phases {total / max(v[10], 1):.3f}"
              f" of the instances' cycles")
        print("   " + "; ".join(f"{name} {v[k] / total:.3f}"
                                for k, name in enumerate(PHASES)))

    shipped = libs["shipped"]
    _, _, it, _, ncg, nfev = launch(shipped, x0)
    torch.cuda.synchronize()
    print(f"spread across the {B} instances: iterations {quantiles(it)}; "
          f"HVPs {quantiles(ncg)}; trials {quantiles(nfev)}")

    def timed(lib, b):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(lib, x0[:b])
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    for b in SWEEP:
        ts = [timed(shipped, b) for _ in range(ROUNDS)]
        print(f"shipped, B = {b}: {info(shipped, b)}; median "
              f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}; {ROUNDS} calls)  [{card}]")
    extra = [k for k in libs if k not in ("profile", "shipped")]
    if extra:
        names = ["shipped"] + extra
        times = {(k, b): [] for k in names for b in (B, 1056)}
        for r in range(ROUNDS):
            for k in (names if r % 2 == 0 else names[::-1]):
                for b in (B, 1056):
                    times[k, b].append(timed(libs[k], b))
        for (k, b), ts in times.items():
            print(f"{k}, B = {b}: median {statistics.median(ts):.3f} ms (min "
                  f"{min(ts):.3f}, max {max(ts):.3f}; {ROUNDS} rounds in "
                  f"turns)  [{card}]")

    # the host's share of minimize(method="newton_cg"), the shipped build as
    # the package's library (the wrapper loads it through _build.load)
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, ROOT)
    from chip_smoke import device_busy_s
    import optimization_solvers_tpu_torch as ostt
    from optimization_solvers_tpu_torch.ops import _build, fused_newton_cg

    _build._lib = shipped
    rosen = ostt.problems.rosenbrock()

    def sync_time(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def solve():
        return ostt.minimize(rosen, x0, method="newton_cg", bounds=(-BOX, BOX),
                             tol=PGTOL, max_iter=MAX_ITER, cg_max=CG_MAX)

    before = fused_newton_cg.newton_cg_solve_fused.launches
    solve()
    walls = [sync_time(solve)[1] for _ in range(ROUNDS)]
    launches = fused_newton_cg.newton_cg_solve_fused.launches - before
    wall = statistics.median(walls)
    busy = device_busy_s(solve, sync_time)
    kernel_ms = statistics.median(timed(shipped, B) for _ in range(ROUNDS))
    if busy is None:
        print("host share: the profiler shows no device time (not measured)")
    else:
        print(f"minimize(method='newton_cg') at the headline: {launches} K4 "
              f"launches in {ROUNDS + 1} calls; wall {1e3 * wall:.3f} ms "
              f"(median of {ROUNDS}; min {1e3 * min(walls):.3f}), device busy "
              f"{1e3 * busy:.3f} ms, host share {max(0.0, 1 - busy / wall):.4f}"
              f"; the kernel's launch alone {kernel_ms:.3f} ms  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
