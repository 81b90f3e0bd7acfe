"""Kernels with their plain PyTorch versions.  CUDA sources live in
``csrc/`` and are built on first use by :mod:`._build`."""

from .fused_driver import fused_minimize, fused_minimize_plain
from .fused_lbfgsb import lbfgsb_solve_fused, lbfgsb_solve_plain
from .fused_lbfgsb_tall import lbfgsb_solve_fused_tall, lbfgsb_solve_tall_plain
from .fused_newton_cg import newton_cg_solve_fused, newton_cg_solve_plain

__all__ = ["fused_minimize", "fused_minimize_plain", "lbfgsb_solve_fused",
           "lbfgsb_solve_plain", "lbfgsb_solve_fused_tall",
           "lbfgsb_solve_tall_plain", "newton_cg_solve_fused",
           "newton_cg_solve_plain"]
