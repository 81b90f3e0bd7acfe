"""Steepest-descent family: the configs of gradient descent, Gauss-Southwell
coordinate descent, preconditioned p-norm descent, projected gradient
descent and the spectral projected gradient method.

Counterpart of :mod:`optimization_solvers_tpu.solvers.steepest`, with the
same fields, defaults and lockstep bodies; the whole-solve kernel K3
(:mod:`..ops.fused_driver`) runs them too.  As in the JAX package,
CoordinateDescent steps along ``-sign(g_i) e_i`` (the reference's
``coordinate_descent.rs:40-44`` always takes ``-e_i``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.numerics import (box_projection, dot, infinity_norm, matvec,
                             sign)
from ..linesearch.base import Bounds, lanes
from .base import BoundedMethod, Method, clamp_lambda


class _GradNorm:
    """``converged`` on ``||g||_inf < grad_tol``."""

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.grad_tol


class _ProjectedGradNorm:
    """``converged`` on the projected gradient's infinity norm."""

    def converged(self, mstate, x, ev, bounds: Bounds):
        return self.projected_gradient_norm(x, ev, bounds) < self.grad_tol


@dataclasses.dataclass(frozen=True)
class GradientDescent(_GradNorm, Method):
    """Direction ``-g``; stops when ``||g||_inf < grad_tol``
    (``gradient_descent.rs:8-79``)."""

    grad_tol: float = 1e-8

    def direction(self, mstate, x, ev, bounds: Bounds):
        return -ev.g, mstate


@dataclasses.dataclass(frozen=True)
class CoordinateDescent(_GradNorm, Method):
    """Gauss-Southwell: ``-sign(g_i) e_i`` at the first largest ``|g_i|``
    (``coordinate_descent.rs:24-46``); stops when ``||g||_inf < grad_tol``."""

    grad_tol: float = 1e-8

    def direction(self, mstate, x, ev, bounds: Bounds):
        idx = torch.argmax(torch.abs(ev.g), dim=-1, keepdim=True)
        d = torch.zeros_like(ev.g).scatter(-1, idx,
                                           -sign(ev.g.gather(-1, idx)))
        return d, mstate


class _PnormState(NamedTuple):
    inverse_p: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PnormDescent(_GradNorm, Method):
    """Preconditioned steepest descent ``d = -P^{-1} g`` with a user
    ``inverse_p`` (``(n, n)`` tensor or array; ``pnorm_descent.rs:12-85``).
    Compared by identity, as its tensor field makes it unhashable by
    value.  The lockstep state holds the one ``(n, n)`` matrix, shared by
    the batch."""

    grad_tol: float = 1e-8
    inverse_p: torch.Tensor | None = None

    def init(self, x, ev, bounds: Bounds):
        if self.inverse_p is None:
            raise ValueError("PnormDescent requires inverse_p")
        return _PnormState(torch.as_tensor(self.inverse_p, dtype=x.dtype,
                                           device=x.device))

    def direction(self, mstate, x, ev, bounds: Bounds):
        return -matvec(mstate.inverse_p, ev.g), mstate


@dataclasses.dataclass(frozen=True)
class ProjectedGradientDescent(_ProjectedGradNorm, BoundedMethod):
    """Projected gradient (Andrei alg. 12.1): ``d = P_box(x - g) - x``;
    stops when the projected gradient's infinity norm is below
    ``grad_tol`` (``projected_gradient_descent.rs:50-83``)."""

    grad_tol: float = 1e-8

    def direction(self, mstate, x, ev, bounds: Bounds):
        return box_projection(x - ev.g, *bounds) - x, mstate


class _SPGState(NamedTuple):
    lam: torch.Tensor
    k: torch.Tensor    # completed-step parity (bb_variant="alternate")


@dataclasses.dataclass(frozen=True)
class SpectralProjectedGradient(_ProjectedGradNorm, BoundedMethod):
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

    def init(self, x, ev, bounds: Bounds):
        d0 = box_projection(x - ev.g, *bounds) - x
        lam = torch.ones_like(ev.f) / infinity_norm(d0)
        return _SPGState(clamp_lambda(lam, self.lambda_min, self.lambda_max),
                         torch.zeros_like(ev.f, dtype=torch.int32))

    def direction(self, mstate, x, ev, bounds: Bounds):
        return (box_projection(x - lanes(mstate.lam) * ev.g, *bounds) - x,
                mstate)

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        sy = dot(s, y)
        raw = dot(s, s) / sy
        if self.bb_variant == "alternate":
            # odd steps use BB2 = s.y / y.y, even steps the reference's BB1
            raw = torch.where(mstate.k % 2 == 1, sy / dot(y, y), raw)
        lam_bb = clamp_lambda(raw, self.lambda_min, self.lambda_max)
        lam = torch.where(sy <= 0.0, torch.full_like(lam_bb, self.lambda_max),
                          lam_bb)
        return _SPGState(lam, mstate.k + 1)
