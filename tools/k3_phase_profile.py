#!/usr/bin/env python3
"""Where the dense quasi-Newton kernels' time goes, by phase, on one NVIDIA
GPU: K3's dense form at config 2 and K9 at its workload.

Copies ``optimization_solvers_tpu_torch`` into ``chip_tree/k3_profile/``
(listed in ``.gitignore``) and builds the copy with ``-DK3_PROFILE
-DK9_PROFILE``, which compile in the ``clock64`` counters of
``ops/csrc/driver.cuh`` (the dense methods QN and QNB) and
``ops/csrc/bfgs_fused.cu``: lane 0 of the warp that runs an instance times
the phases of every iteration.  Then it solves

* config 2 as the bench calls it (1,024 x Rosenbrock-100, float32,
  ``QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
  restart_on_degeneracy=True)`` + ``MoreThuente()``, max_iter 1,500,
  max_iter_ls 40, starts ``RandomState(42)`` uniform(-2, 2), through
  ``solvers.batch_minimize``) and
* K9's workload (``ops.bfgs_solve_fused`` on the same starts, tol 1e-5,
  max_iter 600, max_iter_ls 24, c1 1e-4),

each in full and capped at 1 and 10 iterations, and prints each phase's
share of the summed per-warp cycles, the cycles per instance-iteration,
the trials and updates per iteration, and each kernel's launch (threads
per block, resident blocks per SM, registers, local bytes, shared memory,
where the slabs live).  The counters cost time of their own, so no time
is printed from the counting copy.

With ``--breakdown`` it first runs, in a child process, the package at
``--root`` (default: this checkout) without counters: the launches and
the kernels' device times (CUDA events around the wrapper's launch,
median of 3) at iteration caps 0, 1 and 10 and at B = 132, 1,024 and
1,056 (the first starts of a ``RandomState(6)`` draw).

    python3 tools/k3_phase_profile.py [--breakdown] [--root DIR]
"""

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "chip_tree", "k3_profile")
# the counters [0..5] of k3_prof and k9_prof, in order
PHASES = ["direction's pass", "search trials", "value and gradient", "B y",
          "update", "checks"]
B, N = 1024, 100
CONFIG2 = dict(tol=2e-4, max_iter=1500, max_iter_ls=40)
K9 = dict(tol=1e-5, max_iter=600, max_iter_ls=24, c1=1e-4)
SWEEP = (132, 1024, 1056)
CAPS = (0, 1, 10)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def runners():
    """The two launches on the package imported: ``k3(x, max_iter)`` and
    ``k9(x, max_iter)``, each returning the wrapper's outputs; and
    ``info(lib, dtype)``, the two launch lines."""
    from optimization_solvers_tpu_torch import linesearch as ls, problems
    from optimization_solvers_tpu_torch import solvers
    from optimization_solvers_tpu_torch.ops import fused_bfgs, fused_driver

    rosen = problems.rosenbrock()
    method = solvers.QuasiNewton(tol=CONFIG2["tol"], update="bfgs",
                                 scale_b0=True, restart_on_degeneracy=True)
    spec = fused_driver.build_spec(method, ls.MoreThuente())

    def k3(x, max_iter=CONFIG2["max_iter"]):
        return fused_driver._launch_cuda(spec, rosen, x, None, None, (),
                                         max_iter, CONFIG2["max_iter_ls"])

    def k9(x, max_iter=K9["max_iter"]):
        return fused_bfgs._launch_cuda(rosen, x, (), **dict(
            K9, max_iter=max_iter))

    def info(lib, dtype=0):
        out = (ctypes.c_int * 6)()
        rc = lib.driver_dense_info(dtype, N, 0, 0, out)
        k3_line = f"rc {rc}" if rc else launch_line(list(out))
        out9 = (ctypes.c_int * 6)()
        rc = lib.bfgs_fused_info(dtype, N, out9)
        k9_line = f"rc {rc}" if rc else launch_line(list(out9))
        return k3_line, k9_line

    return k3, k9, info


def launch_line(v):
    where = {0: "no slab", 1: "shared memory", 2: "the workspace"}[v[5]]
    return (f"{v[0]} threads per block, {v[1]} resident blocks "
            f"({v[1] * v[0] // 32} warps) per SM, {v[2]} registers, {v[3]} "
            f"local bytes a thread, {v[4]} bytes of shared memory per block, "
            f"slabs in {where}")


def starts(torch, b, seed):
    import numpy as np

    return torch.tensor(np.random.RandomState(seed).uniform(-2.0, 2.0,
                                                            (b, N)),
                        dtype=torch.float32, device="cuda")


def times(root):
    """The child of ``--breakdown``: the package at ``root`` without
    counters."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import optimization_solvers_tpu_torch as ostt
    from optimization_solvers_tpu_torch.ops import _build

    card = card_line()
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"package {os.path.dirname(ostt.__file__)}; build or load "
          f"{time.perf_counter() - t0:.1f} s")
    k3, k9, info = runners()
    for dtype, name in ((0, "float32"), (1, "float64")):
        k3_line, k9_line = info(lib, dtype)
        print(f"launch at B = {B}, n = {N}, {name}: K3 dense BFGS: {k3_line}; "
              f"K9: {k9_line}")

    def event_ms(fn, x, cap):
        fn(x, cap)
        ts = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x, cap)
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop))
        return statistics.median(ts)

    x = starts(torch, B, 42)
    for what, fn, full in (("config 2 (K3)", k3, CONFIG2["max_iter"]),
                           ("K9", k9, K9["max_iter"])):
        caps = {cap: event_ms(fn, x, cap) for cap in CAPS + (full,)}
        sweep = {b: event_ms(fn, starts(torch, b, 6), full) for b in SWEEP}
        print(f"{what}: iteration cap " + ", ".join(
            f"{c}: {ms:.3f} ms" for c, ms in caps.items())
            + "; batch sweep " + ", ".join(
                f"B={b}: {ms:.3f} ms" for b, ms in sweep.items())
            + f" (CUDA events, median of 3)  [{card}]")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--breakdown", action="store_true",
                        help="also time the package at --root without "
                        "counters: caps 0/1/10 and B = 132, 1,024, 1,056")
    parser.add_argument("--root", default=ROOT, help="the checkout whose "
                        "package --breakdown times (default: this one)")
    parser.add_argument("--times", metavar="ROOT", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k3_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.times:
        return times(args.times)
    if args.breakdown:
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--times", args.root])
        if child.returncode != 0:
            return child.returncode

    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "optimization_solvers_tpu_torch"),
                    os.path.join(COPY, "optimization_solvers_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, COPY)
    from optimization_solvers_tpu_torch.ops import _build

    _build.NVCC_FLAGS.extend(["-DK3_PROFILE", "-DK9_PROFILE"])
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"built the counting copy in {time.perf_counter() - t0:.1f} s")
    for name in ("k3", "k9"):
        getattr(lib, f"{name}_prof_read").argtypes = [ctypes.c_void_p]
    k3, k9, info = runners()
    k3_line, k9_line = info(lib)
    print(f"launch (counting copy) at B = {B}, n = {N}, float32: K3 dense "
          f"BFGS: {k3_line}; K9: {k9_line}")
    x = starts(torch, B, 42)
    for what, fn, name, full in (
            ("config 2 (K3 dense BFGS + More-Thuente)", k3, "k3",
             CONFIG2["max_iter"]),
            ("K9 (dense BFGS + Armijo)", k9, "k9", K9["max_iter"])):
        for cap in (full, 1, 10):
            getattr(lib, f"{name}_prof_reset")()
            fn(x, cap)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            getattr(lib, f"{name}_prof_read")(ctypes.addressof(buf))
            v = list(buf)
            total = sum(v[:6])
            its = max(v[6], 1)
            print(f"{what}, max_iter {cap}: {v[8]} instances, {v[6]} "
                  f"instance-iterations, {v[7] / its:.3f} trials and "
                  f"{v[9] / its:.3f} updates per iteration; cycles per "
                  f"instance-iteration {total / its:.0f}, the loop "
                  f"{total / max(v[10], 1):.3f} of the instances' cycles")
            print("   " + "; ".join(f"{p} {v[k] / max(total, 1):.3f}"
                                    for k, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
