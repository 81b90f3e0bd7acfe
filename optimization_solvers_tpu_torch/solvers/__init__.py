"""Solver layer: the template-method configs that the whole-solve kernel K3
runs (first-order, dense quasi-Newton, L-BFGS and Newton), the batched
driver that routes them there, the L-BFGS-B config, and the Newton-CG
solver (the kernel K4)."""

from .base import BoundedMethod, Method
from .driver import batch_minimize
from .lbfgs import LBFGS
from .lbfgsb import LbfgsbConfig
from .newton import Newton, ProjectedNewton, SpectralProjectedNewton
from .newton_cg import (NewtonCGConfig, newton_cg_batch_minimize,
                        newton_cg_minimize)
from .nonlinear_cg import NonlinearCG
from .quasi_newton import (BFGS, BFGSB, DFP, DFPB, SR1B, Broyden, BroydenB,
                           QuasiNewton, QuasiNewtonB)
from .steepest import (CoordinateDescent, GradientDescent, PnormDescent,
                       ProjectedGradientDescent, SpectralProjectedGradient)

__all__ = ["BoundedMethod", "Method", "batch_minimize", "LBFGS",
           "LbfgsbConfig", "Newton", "ProjectedNewton",
           "SpectralProjectedNewton", "NewtonCGConfig",
           "newton_cg_batch_minimize", "newton_cg_minimize", "NonlinearCG",
           "BFGS", "BFGSB", "DFP", "DFPB", "SR1B", "Broyden", "BroydenB", "QuasiNewton", "QuasiNewtonB",
           "CoordinateDescent", "GradientDescent", "PnormDescent",
           "ProjectedGradientDescent", "SpectralProjectedGradient"]
