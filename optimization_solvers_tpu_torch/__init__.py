"""PyTorch + CUDA port of the batched smooth-optimization solver suite.

The JAX package ``optimization_solvers_tpu`` is the reference; this package
mirrors its layout and module names:

  core/      -- Status, SolveResult, numerics, the oracle, the problem
                library
  ops/       -- batched oracle and four whole-solve kernels, each a plain
                PyTorch version (CPU) and a hand-written CUDA kernel (GPU):
                K1 ops/csrc/lbfgsb_fused.cu (L-BFGS-B, small n), the tall
                K2 ops/csrc/lbfgsb_tall.cu (L-BFGS-B, large n, config 4),
                the generic driver K3 ops/csrc/driver.cu (template
                methods: first-order, configs 3 and 6; dense quasi-Newton
                and L-BFGS, config 2; Newton, PN and SPN, config 5) and
                the Newton-CG kernel K4 ops/csrc/newton_cg.cu
  linesearch/ -- the Armijo- and Wolfe-family search configs K3 runs, and
                the MINPACK dcstep update of K2's and K3's dcsrch
  solvers/   -- the first-order, dense quasi-Newton, L-BFGS and Newton
                method configs, batch_minimize (the route to K3),
                LbfgsbConfig, NewtonCGConfig and newton_cg_batch_minimize
                (the route to K4)
  frontend   -- minimize(f, x0, method=..., ...)
  interop    -- numpy hand-over between the two packages

Ported so far: the batched box-constrained L-BFGS-B main path at small and
large n, the template methods gd, cd, pgd, pnorm, spg, ncg, bfgs, dfp,
broyden, bfgsb, dfpb, broydenb, sr1b, lbfgs, newton, pn and spn with every
line search, and newton_cg.  ROADMAP.md lists what follows.
"""

from . import linesearch, solvers
from .core import problems
from .core.oracle import Oracle, make_oracle
from .core.types import FuncEval, SolveResult, Status
from .frontend import minimize

__version__ = "0.1.0"

__all__ = ["FuncEval", "Oracle", "SolveResult", "Status", "linesearch",
           "make_oracle", "minimize", "problems", "solvers"]
