"""PyTorch + CUDA port of the batched smooth-optimization solver suite.

The JAX package ``optimization_solvers_tpu`` is the reference; this package
mirrors its layout and module names:

  core/      -- Status, SolveResult, numerics, the problem library
  ops/       -- batched oracle and the two fused L-BFGS-B kernels, each a
                plain PyTorch version (CPU) and a hand-written CUDA kernel
                (GPU): K1 ops/csrc/lbfgsb_fused.cu (small n) and the tall
                K2 ops/csrc/lbfgsb_tall.cu (large n, config 4)
  linesearch/ -- the MINPACK dcstep update of K2's dcsrch mode
  solvers/   -- LbfgsbConfig
  frontend   -- minimize(f, x0, method="lbfgsb", ...), routed by fit
  interop    -- numpy hand-over between the two packages

Ported so far: the batched box-constrained L-BFGS-B main path at small and
large n.  ROADMAP.md lists what follows.
"""

from .core import problems
from .core.types import FuncEval, SolveResult, Status
from .frontend import minimize

__version__ = "0.1.0"

__all__ = ["FuncEval", "SolveResult", "Status", "minimize", "problems"]
