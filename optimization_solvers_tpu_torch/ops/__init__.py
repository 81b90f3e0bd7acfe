"""Kernels with their plain PyTorch versions.  CUDA sources live in
``csrc/`` and are built on first use by :mod:`._build`."""

from .fused_lbfgsb import lbfgsb_solve_fused, lbfgsb_solve_plain

__all__ = ["lbfgsb_solve_fused", "lbfgsb_solve_plain"]
