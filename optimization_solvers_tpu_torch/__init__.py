"""PyTorch + CUDA port of the batched smooth-optimization solver suite.

The JAX package ``optimization_solvers_tpu`` is the reference; this package
mirrors its layout and module names:

  core/      -- Status, SolveResult, numerics, the oracle, the problem
                library
  ops/       -- batched oracle, seven whole-solve kernels and two kernels of
                the lockstep loop, each a plain PyTorch version (CPU) and
                a hand-written CUDA kernel (GPU): K1
                ops/csrc/lbfgsb_fused.cu (L-BFGS-B, small n, and its
                diagonally scaled form), the tall K2
                ops/csrc/lbfgsb_tall.cu (L-BFGS-B, large n, config 4), the
                generic driver K3 ops/csrc/driver.cu (template methods:
                first-order, configs 3 and 6; dense quasi-Newton and
                L-BFGS, config 2; Newton, PN and SPN, config 5), the
                Newton-CG kernel K4 ops/csrc/newton_cg.cu, the fused dense
                quasi-Newton update K5 ops/csrc/qn_update.cu, the
                batched Cholesky solve K6 ops/csrc/cholesky_solve.cu
                (behind ops.linalg), and the whole-solve kernels K7
                ops/csrc/lbfgs_fused.cu (ops.lbfgs_solve_fused), K8
                ops/csrc/spg_fused.cu (ops.spg_solve_fused) and K9
                ops/csrc/bfgs_fused.cu (ops.bfgs_solve_fused)
  linesearch/ -- the Armijo- and Wolfe-family searches (configs K3 runs,
                lockstep bodies), and the MINPACK dcstep update of K2's
                and K3's dcsrch
  solvers/   -- the first-order, dense quasi-Newton, L-BFGS and Newton
                methods, the lockstep driver (minimize, minimize_recorded,
                make_step, lockstep_loop) and batch_minimize (the route to
                K3 or the lockstep loop), the lockstep L-BFGS-B
                (lbfgsb_minimize, lbfgsb_batch_minimize,
                lbfgsb_minimize_scaled) and LbfgsbConfig, NewtonCGConfig
                and newton_cg_batch_minimize (the route to K4)
  utils/     -- the package logger and the per-iteration tracer
  frontend   -- minimize(f, x0, method=..., ...)
  interop    -- numpy hand-over between the two packages

Ported so far: the batched box-constrained L-BFGS-B main path at small and
large n, its scaled form (ops.lbfgsb_solve_fused_scaled), the lockstep
L-BFGS-B (single, batched and scaled), the template methods gd, cd, pgd, pnorm, spg, ncg, bfgs, dfp,
broyden, bfgsb, dfpb, broydenb, sr1b, lbfgs, newton, pn and spn with every
line search, batched (K3 or the lockstep loop) and single-instance,
newton_cg, and the whole-solve entries lbfgs_solve_fused, spg_solve_fused
and bfgs_solve_fused of ops: every TPU kernel of the JAX package has its
CUDA counterpart.  ROADMAP.md lists what follows.
"""

from . import linesearch, solvers
from . import ops  # after solvers: K3's wrapper imports the method configs
from .core import problems
from .core.oracle import Oracle, make_oracle
from .core.types import FuncEval, SolveResult, Status
from .frontend import minimize

__version__ = "0.1.0"

__all__ = ["FuncEval", "Oracle", "SolveResult", "Status", "linesearch",
           "make_oracle", "minimize", "ops", "problems", "solvers"]
