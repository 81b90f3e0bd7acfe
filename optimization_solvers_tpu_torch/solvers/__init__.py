"""Solver layer: the first-order template methods that the whole-solve
kernel K3 runs, the batched driver that routes them there, and the
L-BFGS-B config."""

from .base import BoundedMethod, Method
from .driver import batch_minimize
from .lbfgsb import LbfgsbConfig
from .nonlinear_cg import NonlinearCG
from .steepest import (CoordinateDescent, GradientDescent, PnormDescent,
                       ProjectedGradientDescent, SpectralProjectedGradient)

__all__ = ["BoundedMethod", "Method", "batch_minimize", "LbfgsbConfig",
           "NonlinearCG", "CoordinateDescent", "GradientDescent",
           "PnormDescent", "ProjectedGradientDescent",
           "SpectralProjectedGradient"]
