"""Newton family: the configs of damped Newton, projected Newton and
spectral projected Newton (SPN).

Counterpart of :mod:`optimization_solvers_tpu.solvers.newton`, with the same
fields, defaults and lockstep bodies.  The whole-solve kernel K3 runs them
in its Newton form (:mod:`..ops.fused_driver`): each iteration writes the
instance's dense Hessian, factors it by Cholesky with a diagonal-scaled
pivot test, and solves against the factor.  The lockstep bodies below
invert ``H`` for Newton (``torch.linalg.inv_ex``, as JAX's
``jnp.linalg.inv``; a singular ``H`` gives a non-finite direction and the
``-g`` fallback) and solve through :func:`..ops.linalg.cholesky_solve` for
PN and SPN, which takes the Cholesky kernel K6 when
``ops.linalg.config.use_kernel`` asks for it; a non-PD ``H`` gives NaN and,
at the next iteration, OUT_OF_DOMAIN.

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
from typing import NamedTuple

import torch

from ..core.numerics import box_projection, dot, infinity_norm, matvec
from ..linesearch.base import Bounds, lanes
from ..ops.linalg import cholesky_solve
from .base import BoundedMethod, Method, clamp_lambda


class _NewtonState(NamedTuple):
    decrement_squared: torch.Tensor


class _PNState(NamedTuple):
    s_norm: torch.Tensor
    y_norm: torch.Tensor


class _SPNState(NamedTuple):
    lam: torch.Tensor


def _inverse(h):
    """``H^{-1}`` per instance; NaN where ``H`` is singular, where
    ``torch.linalg.inv`` would raise."""
    inv, info = torch.linalg.inv_ex(h)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(inv, float("nan")), inv)


@dataclasses.dataclass(frozen=True)
class Newton(Method):
    """Damped Newton (``newton/mod.rs:26-69``): ``d = -H^{-1} g``, ``-g``
    where that is not finite; stops when half the squared decrement is
    below ``tol``.  The reference's decrement is ``(H^{-1} d) . d`` with
    ``d = -H^{-1} g`` (``newton/mod.rs:40``), reproduced as is."""

    tol: float = 1e-8
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        # the reference's decrement starts as None: not converged
        return _NewtonState(torch.full_like(ev.f, float("inf")))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return mstate.decrement_squared * 0.5 < self.tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        h_inv = _inverse(ev.hessian)
        d_newton = -matvec(h_inv, ev.g)
        ok = torch.isfinite(d_newton).all(-1)
        d = torch.where(ok[:, None], d_newton, -ev.g)
        dec2 = torch.where(ok, dot(matvec(h_inv, d_newton), d_newton),
                           mstate.decrement_squared)
        return d, _NewtonState(dec2)


@dataclasses.dataclass(frozen=True)
class ProjectedNewton(BoundedMethod):
    """Projected Newton (``newton/projected_newton.rs:64-110``):
    ``d = P_box(x - H^{-1} g) - x``; stops on the projected-gradient norm
    or when the iterate or the gradient stopped moving."""

    grad_tol: float = 1e-8
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        inf = torch.full_like(ev.f, float("inf"))
        return _PNState(inf, inf)

    def converged(self, mstate, x, ev, bounds: Bounds):
        too_close = ((mstate.s_norm < self.grad_tol)
                     | (mstate.y_norm < self.grad_tol))
        return too_close | (self.projected_gradient_norm(x, ev, bounds)
                            < self.grad_tol)

    def direction(self, mstate, x, ev, bounds: Bounds):
        step = cholesky_solve(ev.hessian, ev.g)
        return box_projection(x - step, *bounds) - x, mstate

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        return _PNState(torch.linalg.vector_norm(x_new - x, dim=-1),
                        torch.linalg.vector_norm(ev_new.g - ev.g, dim=-1))


@dataclasses.dataclass(frozen=True)
class SpectralProjectedNewton(BoundedMethod):
    """Spectral projected Newton (``newton/spn.rs:76-91,139-148``):
    ``d = P_box(x - lam H^{-1} g) - x`` with SPG's safeguarded BB scalar;
    ``precond_bb`` forms it in the Newton metric, ``s.s / s.(H^{-1} y)``
    with H at the pair's left end (a second solve per iteration)."""

    grad_tol: float = 1e-8
    lambda_min: float = 1e-3
    lambda_max: float = 1e3
    precond_bb: bool = False
    needs_hessian = True

    def init(self, x, ev, bounds: Bounds):
        d0 = box_projection(x - ev.g, *bounds) - x
        lam = torch.ones_like(ev.f) / infinity_norm(d0)
        return _SPNState(clamp_lambda(lam, self.lambda_min, self.lambda_max))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return self.projected_gradient_norm(x, ev, bounds) < self.grad_tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        step = cholesky_solve(ev.hessian, ev.g)
        return (box_projection(x - lanes(mstate.lam) * step, *bounds) - x,
                mstate)

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        if self.precond_bb:
            y = cholesky_solve(ev.hessian, y)
        sy = dot(s, y)
        lam_bb = clamp_lambda(dot(s, s) / sy, self.lambda_min,
                              self.lambda_max)
        # sy > 0 (not sy <= 0), so a NaN pair also resets to lambda_max
        return _SPNState(torch.where(sy > 0.0, lam_bb,
                                     torch.full_like(lam_bb,
                                                     self.lambda_max)))
