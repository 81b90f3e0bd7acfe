#!/usr/bin/env python3
"""Where the whole-solve L-BFGS-B kernel K1's time goes at the headline, by
phase, on one NVIDIA GPU.

Copies ``optimization_solvers_tpu_torch`` into ``chip_tree/k1_profile/``
(listed in ``.gitignore``) and builds the copy with ``-DK1_PROFILE``, which
compiles in the ``clock64`` counters of ``ops/csrc/lbfgsb_fused.cu`` (lane
0 of each warp times the phases of every iteration of its instance), then
solves the headline (10,240 x Rosenbrock-100, float32, box [-5, 5], m 5,
pgtol 1e-3, factr 100, max_iter 600, starts ``RandomState(42)``, as
``chip_smoke.py``) through K1, and again over its first iteration and its
first 10.  Prints each phase's share of the summed per-warp cycles, the
cycles per instance-iteration, the fast-path share of the iterations, the
Cauchy walk's trips and the Armijo trials per iteration, and the kernel's
launch (warps per block, resident warps per SM, registers, spills).  The
counters cost time of their own, so the times printed here are not the
kernel's; ``chip_smoke.py`` times it.

    python3 tools/k1_phase_profile.py
"""

import ctypes
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "chip_tree", "k1_profile")
# the kernel's counters k1_prof[0..7], in order
PHASES = ["middle matrix and Cholesky", "gate", "Cauchy walk",
          "subspace step", "Armijo trials", "step value and gradient",
          "checks and history update", "stopping test"]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "optimization_solvers_tpu_torch"),
                    os.path.join(COPY, "optimization_solvers_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, COPY)
    from optimization_solvers_tpu_torch import problems
    from optimization_solvers_tpu_torch.ops import _build, fused_lbfgsb

    _build.NVCC_FLAGS.append("-DK1_PROFILE")
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"built the counting copy in {time.perf_counter() - t0:.1f} s")
    lib.k1_prof_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    B, n = 10_240, 100
    box = torch.full((n,), 5.0, device=dev)
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2.0, 2.0, (B, n)),
                      dtype=torch.float32, device=dev)
    info = fused_lbfgsb.kernel_info(torch.float32, B, n, 5)
    print(f"launch at the headline: {info}")
    for max_iter in (600, 1, 10):
        lib.k1_prof_reset()
        fused_lbfgsb.lbfgsb_solve_fused(
            problems.rosenbrock(), x0, -box, box, m=5, pgtol=1e-3,
            factr=100.0, max_iter=max_iter)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.k1_prof_read(ctypes.addressof(buf))
        v = list(buf)
        total = sum(v[:8])
        its = max(v[8], 1)
        walks = its - v[9]
        print(f"max_iter {max_iter}: {v[12]} instances, {v[8]} "
              f"instance-iterations, fast path {v[9] / its:.4f}, "
              f"{walks} walking iterations with "
              f"{v[10] / max(walks, 1):.2f} trips each, "
              f"{v[11] / its:.3f} Armijo trials per iteration; cycles per "
              f"instance-iteration {total / its:.0f}, the loop "
              f"{total / max(v[13], 1):.3f} of the instances' cycles")
        print("   " + "; ".join(f"{name} {v[k] / total:.3f}"
                                for k, name in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
