"""Kernels with their plain PyTorch versions, the dense linear-algebra
seam :mod:`.linalg` (``cholesky_solve``, ``solve_spd``, ``config``), and
the small unrolled Choleskys of the lockstep L-BFGS-B
(:mod:`.smallchol`).  CUDA sources live in ``csrc/`` and are built on
first use by :mod:`._build`."""

from . import linalg
from .fused_bfgs import bfgs_solve_fused, bfgs_solve_plain
from .fused_driver import fused_minimize, fused_minimize_plain
from .fused_lbfgs import lbfgs_solve_fused, lbfgs_solve_plain
from .fused_lbfgsb import (lbfgsb_solve_fused, lbfgsb_solve_fused_scaled,
                           lbfgsb_solve_plain)
from .fused_lbfgsb_tall import lbfgsb_solve_fused_tall, lbfgsb_solve_tall_plain
from .fused_newton import cholesky_solve_fused, cholesky_solve_plain
from .fused_newton_cg import newton_cg_solve_fused, newton_cg_solve_plain
from .fused_qn import qn_update_direction_fused, qn_update_direction_plain
from .fused_spg import spg_solve_fused, spg_solve_plain
from .linalg import cholesky_solve, config, solve_spd

__all__ = ["bfgs_solve_fused", "bfgs_solve_plain", "cholesky_solve",
           "cholesky_solve_fused", "cholesky_solve_plain", "config",
           "fused_minimize", "fused_minimize_plain", "linalg",
           "lbfgs_solve_fused", "lbfgs_solve_plain",
           "lbfgsb_solve_fused", "lbfgsb_solve_fused_scaled",
           "lbfgsb_solve_plain",
           "lbfgsb_solve_fused_tall", "lbfgsb_solve_tall_plain",
           "newton_cg_solve_fused", "newton_cg_solve_plain",
           "qn_update_direction_fused", "qn_update_direction_plain",
           "solve_spd", "spg_solve_fused", "spg_solve_plain"]
