"""PyTorch + CUDA port of the batched smooth-optimization solver suite.

The JAX package ``optimization_solvers_tpu`` is the reference; this package
mirrors its layout and module names:

  core/      -- Status, SolveResult, numerics, the oracle, the problem
                library
  ops/       -- batched oracle and three whole-solve kernels, each a plain
                PyTorch version (CPU) and a hand-written CUDA kernel (GPU):
                K1 ops/csrc/lbfgsb_fused.cu (L-BFGS-B, small n), the tall
                K2 ops/csrc/lbfgsb_tall.cu (L-BFGS-B, large n, config 4)
                and the generic driver K3 ops/csrc/driver.cu (first-order
                template methods, configs 3 and 6)
  linesearch/ -- the Armijo-family search configs K3 runs, and the
                MINPACK dcstep update of K2's dcsrch mode
  solvers/   -- the first-order method configs, batch_minimize (the route
                to K3), LbfgsbConfig
  frontend   -- minimize(f, x0, method=..., ...)
  interop    -- numpy hand-over between the two packages

Ported so far: the batched box-constrained L-BFGS-B main path at small and
large n, and the first-order template methods (gd, cd, pgd, pnorm, spg,
ncg).  ROADMAP.md lists what follows.
"""

from . import linesearch, solvers
from .core import problems
from .core.oracle import Oracle, make_oracle
from .core.types import FuncEval, SolveResult, Status
from .frontend import minimize

__version__ = "0.1.0"

__all__ = ["FuncEval", "Oracle", "SolveResult", "Status", "linesearch",
           "make_oracle", "minimize", "problems", "solvers"]
