#!/usr/bin/env python3
"""Where the tall kernel K2's time goes at config 4, by phase, on one
NVIDIA GPU.

Copies ``optimization_solvers_tpu_torch`` into ``chip_tree/k2_profile/``
(listed in ``.gitignore``) and builds the copy with ``-DK2_PROFILE``, which
compiles in the ``clock64`` counters of ``ops/csrc/lbfgsb_tall.cu`` (each
group's thread 0 times the phases of every iteration; the two objective
passes are timed per block), then solves config 4 (512 x the 10,000-dim
bounded log-sum-exp, float32, m 10, as ``chip_smoke.py``) through K2 with
Armijo, with dcsrch, and over 10 iterations at ``bisect_iters`` 40 and 2.  Prints each phase's
share of the summed per-group cycles, the bisection's probes and the
coordinates they read.  The counters cost time of their own, so the times
printed here are not the kernel's; ``chip_smoke.py`` times it.

    python3 tools/k2_phase_profile.py
"""

import ctypes
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "chip_tree", "k2_profile")
# the kernel's counters k2_prof[0..9], in order
PHASES = ["build_middle", "Cauchy first pass (t = 0, hi0)", "bisection",
          "W^T (xcp - x)", "Gram pass and tables", "small algebra",
          "direction and step bound", "line search", "step evaluation",
          "checks, update, stopping test"]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "optimization_solvers_tpu_torch"),
                    os.path.join(COPY, "optimization_solvers_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, COPY)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_geometries import lse_arrays
    from optimization_solvers_tpu_torch import problems
    from optimization_solvers_tpu_torch.ops import _build, fused_lbfgsb_tall

    _build.NVCC_FLAGS.append("-DK2_PROFILE")
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"built the counting copy in {time.perf_counter() - t0:.1f} s")
    lib.k2_prof_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    B, n, rows = 512, 10_000, 512
    lse = problems.log_sum_exp(*(torch.tensor(a, dtype=torch.float32,
                                              device=dev)
                                 for a in lse_arrays(n, rows)))
    box = torch.full((n,), 1.0, device=dev)
    x0 = torch.tensor(np.random.RandomState(4).uniform(-0.5, 0.5, (B, n)),
                      dtype=torch.float32, device=dev)
    for kw in (dict(), dict(line_search="dcsrch"), dict(max_iter=10),
               dict(max_iter=10, bisect_iters=2)):
        lib.k2_prof_reset()
        fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
            lse, x0, -box, box, m=10, pgtol=1e-5, factr=1e3,
            **dict(dict(max_iter=200), **kw))
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.k2_prof_read(ctypes.addressof(buf))
        v = list(buf)
        total = sum(v[:10]) + v[15]
        its = max(v[11], 1)
        print(f"{kw or 'Armijo, max_iter 200'}: {v[11]} instance-iterations, "
              f"{v[12] / its:.2f} bisection probes each, "
              f"{v[13] / max(v[12], 1):.0f} listed coordinates per warp and "
              f"probe; cycles per instance-iteration {total / its:.0f}")
        print("   " + "; ".join(f"{name} {v[k] / total:.3f}"
                                for k, name in enumerate(PHASES)))
        print(f"   per block, summed over the blocks: value passes "
              f"{v[14]:.4g} cycles, gradient passes {v[10]:.4g} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
