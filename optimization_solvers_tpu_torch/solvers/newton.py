"""Newton family: the configs of damped Newton, projected Newton and
spectral projected Newton (SPN).

Counterpart of :mod:`optimization_solvers_tpu.solvers.newton`, with the same
fields and defaults.  The whole-solve kernel K3 runs them in its Newton
form (:mod:`..ops.fused_driver`): each iteration writes the instance's
dense Hessian, factors it by Cholesky with a diagonal-scaled pivot test,
and solves against the factor.

* :class:`Newton`: ``d = -H^{-1} g``, ``-g`` where the factor is not
  numerically positive definite; stops when half the squared decrement
  ``(H^{-1} d) . d`` is below ``tol``.
* :class:`ProjectedNewton`: ``d = P_box(x - H^{-1} g) - x``, the projected
  gradient step where the factor fails; stops on the projected-gradient
  infinity norm or when ``||s||`` or ``||y||`` falls below ``grad_tol``.
* :class:`SpectralProjectedNewton`: ``d = P_box(x - lam H^{-1} g) - x``
  with the safeguarded Barzilai-Borwein scalar ``lam``; ``precond_bb``
  forms it in the Newton metric, ``s.s / s.(H^{-1} y)``, from the factor
  of the direction's Hessian.
"""

from __future__ import annotations

import dataclasses

from .base import BoundedMethod, Method


@dataclasses.dataclass(frozen=True)
class Newton(Method):
    """Damped Newton (``newton/mod.rs:26-69``)."""

    tol: float = 1e-8
    needs_hessian = True


@dataclasses.dataclass(frozen=True)
class ProjectedNewton(BoundedMethod):
    """Projected Newton (``newton/projected_newton.rs:64-110``)."""

    grad_tol: float = 1e-8
    needs_hessian = True


@dataclasses.dataclass(frozen=True)
class SpectralProjectedNewton(BoundedMethod):
    """Spectral projected Newton (``newton/spn.rs:76-91,139-148``)."""

    grad_tol: float = 1e-8
    lambda_min: float = 1e-3
    lambda_max: float = 1e3
    precond_bb: bool = False
    needs_hessian = True
