"""Solver layer: the template-method configs that the whole-solve kernel K3
runs (first-order, dense quasi-Newton and L-BFGS), the batched driver that
routes them there, and the L-BFGS-B config."""

from .base import BoundedMethod, Method
from .driver import batch_minimize
from .lbfgs import LBFGS
from .lbfgsb import LbfgsbConfig
from .nonlinear_cg import NonlinearCG
from .quasi_newton import (BFGS, BFGSB, DFP, DFPB, SR1B, Broyden, BroydenB,
                           QuasiNewton, QuasiNewtonB)
from .steepest import (CoordinateDescent, GradientDescent, PnormDescent,
                       ProjectedGradientDescent, SpectralProjectedGradient)

__all__ = ["BoundedMethod", "Method", "batch_minimize", "LBFGS",
           "LbfgsbConfig", "NonlinearCG", "BFGS", "BFGSB", "DFP", "DFPB",
           "SR1B", "Broyden", "BroydenB", "QuasiNewton", "QuasiNewtonB",
           "CoordinateDescent", "GradientDescent", "PnormDescent",
           "ProjectedGradientDescent", "SpectralProjectedGradient"]
