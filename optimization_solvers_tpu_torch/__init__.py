"""PyTorch + CUDA port of the batched smooth-optimization solver suite.

The JAX package ``optimization_solvers_tpu`` is the reference; this package
mirrors its layout and module names:

  core/      -- Status, SolveResult, numerics, the problem library
  ops/       -- batched oracle, the fused L-BFGS-B (plain PyTorch on CPU,
                the hand-written CUDA kernel ops/csrc/lbfgsb_fused.cu on GPU)
  solvers/   -- LbfgsbConfig
  frontend   -- minimize(f, x0, method="lbfgsb", ...)
  interop    -- numpy hand-over between the two packages

Ported so far: the batched box-constrained L-BFGS-B main path.  ROADMAP.md
lists what follows.
"""

from .core import problems
from .core.types import FuncEval, SolveResult, Status
from .frontend import minimize

__version__ = "0.1.0"

__all__ = ["FuncEval", "SolveResult", "Status", "minimize", "problems"]
