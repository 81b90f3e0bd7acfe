"""Solver layer: the template methods (first-order, dense quasi-Newton,
L-BFGS and Newton) with their lockstep bodies, the generic driver
(``minimize``, ``minimize_recorded``, ``batch_minimize``, which routes a
batch to the whole-solve kernel K3 or the lockstep loop, ``make_step``,
``make_solver``, ``lockstep_loop``), the lockstep L-BFGS-B
(``make_lbfgsb_step``, ``lbfgsb_minimize``, ``lbfgsb_batch_minimize``,
``lbfgsb_minimize_scaled``) and its config, and the Newton-CG solvers
(``make_newton_cg_step``, ``newton_cg_minimize``, and
``newton_cg_batch_minimize``, which routes a batch to the kernel K4 or the
lockstep loop)."""

from .base import BoundedMethod, Method
from .driver import (SolverCarry, batch_minimize, lockstep_loop,
                     make_solver, make_step, minimize, minimize_recorded)
from .lbfgs import LBFGS, LbfgsState
from .lbfgsb import (LbfgsbConfig, lbfgsb_batch_minimize, lbfgsb_minimize,
                     lbfgsb_minimize_scaled, make_lbfgsb_step)
from .newton import Newton, ProjectedNewton, SpectralProjectedNewton
from .newton_cg import (NewtonCGConfig, make_newton_cg_step,
                        newton_cg_batch_minimize, newton_cg_minimize)
from .nonlinear_cg import NonlinearCG
from .quasi_newton import (BFGS, BFGSB, DFP, DFPB, SR1B, Broyden, BroydenB,
                           QuasiNewton, QuasiNewtonB)
from .steepest import (CoordinateDescent, GradientDescent, PnormDescent,
                       ProjectedGradientDescent, SpectralProjectedGradient)

__all__ = ["BoundedMethod", "Method", "SolverCarry", "batch_minimize",
           "lockstep_loop", "make_solver", "make_step", "minimize",
           "minimize_recorded", "LBFGS", "LbfgsState",
           "LbfgsbConfig", "lbfgsb_batch_minimize", "lbfgsb_minimize",
           "lbfgsb_minimize_scaled", "make_lbfgsb_step", "Newton", "ProjectedNewton",
           "SpectralProjectedNewton", "NewtonCGConfig",
           "make_newton_cg_step", "newton_cg_batch_minimize", "newton_cg_minimize", "NonlinearCG",
           "BFGS", "BFGSB", "DFP", "DFPB", "SR1B", "Broyden", "BroydenB", "QuasiNewton", "QuasiNewtonB",
           "CoordinateDescent", "GradientDescent", "PnormDescent",
           "ProjectedGradientDescent", "SpectralProjectedGradient"]
