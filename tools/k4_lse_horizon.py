"""How far K4's float64 per-instance hold on the log-sum-exp can reach.

K4's plain version (``ops/fused_newton_cg.py:newton_cg_solve_plain``) on
phase 38's inputs of ``chip_smoke.py`` (config 4's A and b construction at
n = 1,000, 512 rows, B = 512, box [-1, 1], float64), over short horizons
of ``max_iter`` Newton steps of at most ``cg_max`` CG steps.  For each
horizon it prints the plain version's own spread (x0 moved by 1e-15
relative; the first 8 instances solved alone against the batch) and what
an HVP without its ``-p (p . A v)`` term changes (the fraction of
instances whose iterations, status, HVP and trial counts stay equal, and
max|dx|); then, over full solves of the first 64 instances, the total
iterations and HVPs of the two HVPs.  A horizon suits a per-instance hold
where the spread is far below the hold's tolerance and the wrong HVP far
above it.

    python tools/k4_lse_horizon.py            # on the CPU, ~15 s
"""

import copy
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from _torch_geometries import lse_arrays  # noqa: E402
from optimization_solvers_tpu_torch import problems  # noqa: E402
from optimization_solvers_tpu_torch.ops import fused_newton_cg  # noqa: E402

HORIZONS = ((1, 2), (2, 2), (2, 4), (3, 4), (2, 8), (8, 32))
KW = dict(pgtol=1e-5, factr=1e3, max_iter_ls=25, c1=1e-4)


def main():
    torch.set_num_threads(4)
    B, n, rows = 512, 1000, 512
    A, b = (torch.as_tensor(v) for v in lse_arrays(n, rows))
    lse = problems.log_sum_exp(A, b)

    def hvp_without_rank_one(X, V):
        p = torch.softmax(X @ A.T + b, dim=-1)
        return (p * (V @ A.T)) @ A

    wrong = copy.copy(lse)
    wrong._hvp = hvp_without_rank_one
    x0 = torch.as_tensor(
        np.random.RandomState(4).uniform(-0.5, 0.5, (B, n)))
    noise = torch.as_tensor(
        np.random.RandomState(100).standard_normal((B, n)))
    lo = torch.full((n,), -1.0, dtype=torch.float64)
    up = torch.full((n,), 1.0, dtype=torch.float64)
    solve = fused_newton_cg.newton_cg_solve_plain

    for max_iter, cg_max in HORIZONS:
        kw = dict(KW, max_iter=max_iter, cg_max=cg_max)
        ref = solve(lse, x0, lo, up, **kw)
        moved = solve(lse, x0 * (1 + 1e-15 * noise), lo, up, **kw)[0]
        alone = torch.cat([solve(lse, x0[i:i + 1], lo, up, **kw)[0]
                           for i in range(8)])
        bad = solve(wrong, x0, lo, up, **kw)
        same = [(a == r).float().mean().item()
                for a, r in zip(bad[2:], ref[2:])]
        print(f"{max_iter} iterations, cg_max {cg_max}: plain spread max|dx| "
              f"{(moved - ref[0]).abs().max().item():.3g} (x0 moved), "
              f"{(alone - ref[0][:8]).abs().max().item():.3g} (alone); "
              f"without -p (p . A v): iterations / status / HVPs / trials "
              f"equal {' / '.join(f'{v:.4f}' for v in same)}, max|dx| "
              f"{(bad[0] - ref[0]).abs().max().item():.3g}", flush=True)

    kw = dict(KW, max_iter=200, cg_max=32)
    for what, obj in (("the HVP", lse), ("without -p (p . A v)", wrong)):
        _, f, it, st, ncg, _ = solve(obj, x0[:64], lo, up, **kw)
        print(f"full solves, 64 instances, {what}: iterations "
              f"{int(it.sum())}, HVPs {int(ncg.sum())}, converged "
              f"{(st == 1).float().mean().item():.4f}, median f "
              f"{f.median().item():.12g}", flush=True)


if __name__ == "__main__":
    main()
