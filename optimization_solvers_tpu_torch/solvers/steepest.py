"""Steepest-descent family: the configs of gradient descent, Gauss-Southwell
coordinate descent, preconditioned p-norm descent, projected gradient
descent and the spectral projected gradient method.

Counterpart of :mod:`optimization_solvers_tpu.solvers.steepest`, with the
same fields and defaults; the whole-solve kernel K3
(:mod:`..ops.fused_driver`) runs them.  As in the JAX package,
CoordinateDescent steps along ``-sign(g_i) e_i`` (the reference's
``coordinate_descent.rs:40-44`` always takes ``-e_i``).
"""

from __future__ import annotations

import dataclasses

import torch

from .base import BoundedMethod, Method


@dataclasses.dataclass(frozen=True)
class GradientDescent(Method):
    """Direction ``-g``; stops when ``||g||_inf < grad_tol``
    (``gradient_descent.rs:8-79``)."""

    grad_tol: float = 1e-8


@dataclasses.dataclass(frozen=True)
class CoordinateDescent(Method):
    """Gauss-Southwell: ``-sign(g_i) e_i`` at the first largest ``|g_i|``
    (``coordinate_descent.rs:24-46``); stops when ``||g||_inf < grad_tol``."""

    grad_tol: float = 1e-8


@dataclasses.dataclass(frozen=True, eq=False)
class PnormDescent(Method):
    """Preconditioned steepest descent ``d = -P^{-1} g`` with a user
    ``inverse_p`` (``(n, n)`` tensor or array; ``pnorm_descent.rs:12-85``).
    Compared by identity, as its tensor field makes it unhashable by
    value."""

    grad_tol: float = 1e-8
    inverse_p: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class ProjectedGradientDescent(BoundedMethod):
    """Projected gradient (Andrei alg. 12.1): ``d = P_box(x - g) - x``;
    stops when the projected gradient's infinity norm is below
    ``grad_tol`` (``projected_gradient_descent.rs:50-83``)."""

    grad_tol: float = 1e-8


@dataclasses.dataclass(frozen=True)
class SpectralProjectedGradient(BoundedMethod):
    """SPG (Birgin-Martinez-Raydan): ``d = P_box(x - lambda g) - x`` with
    ``lambda_0 = clamp(1 / ||P(x0 - g0) - x0||_inf)`` and, after each step,
    ``lambda = clamp(s.s / s.y)``, reset to ``lambda_max`` when
    ``s.y <= 0`` (``spg.rs``).  ``bb_variant="alternate"`` alternates that
    BB1 scalar with BB2 (``s.y / y.y``) step by step, the cycling-breaker
    the JAX package adds for the config-3 float32 tail; ``"bb1"`` is the
    reference's rule."""

    grad_tol: float = 1e-8
    lambda_min: float = 1e-3
    lambda_max: float = 1e3
    bb_variant: str = "bb1"

    def __post_init__(self):
        if self.bb_variant not in ("bb1", "alternate"):
            raise ValueError(
                f"bb_variant must be 'bb1' or 'alternate', "
                f"got {self.bb_variant!r}")
