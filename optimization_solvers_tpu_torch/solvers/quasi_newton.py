"""Dense quasi-Newton family: the configs of BFGS, DFP, Broyden ("bad"
rank-1 on the inverse), their box-constrained twins BFGSB/DFPB/BroydenB,
and the bounded-only SR1B.

Counterpart of :mod:`optimization_solvers_tpu.solvers.quasi_newton`, with
the same fields, defaults, factories, ``__post_init__`` check and lockstep
bodies; the whole-solve kernel K3 (:mod:`..ops.fused_driver`) runs them
too.  A dense approximate inverse Hessian ``B`` per instance, seeded at
the identity, direction ``-B g`` (bounded: ``P_box(x - B g) - x``),
convergence on the gradient 2-norm or on ``||s||, ||y|| < tol``, and the
update skipped on a degenerate pair.  ``scale_b0`` rescales ``B0 = (s.y /
y.y) I`` before the first update; ``restart_on_degeneracy`` resets ``B``
to the identity on a degenerate pair and exits only after a restarted step
stalls again.  A CONVERGED exit whose gradient test did not pass is
relabelled STALLED (6) by :meth:`stall_status`, as in the JAX package.

The BFGS update is expanded as in JAX (two matvecs and three rank-1 terms
instead of two ``n x n`` products):

    B' = B - rho (s (B y)^T + (B y) s^T) + (rho^2 y.By + rho) s s^T.

``fused=True`` runs the update and the next direction's ``B' g`` in one
pass over ``B``: the kernel K5 on a CUDA tensor, its plain version on a
CPU tensor (:mod:`..ops.fused_qn`), as JAX takes its TPU kernel on a TPU
and the XLA reference elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.numerics import box_projection, dot, matvec, outer
from ..linesearch.base import Bounds
from ..ops import fused_qn
from .base import BoundedMethod, Method


class _QNState(NamedTuple):
    B: torch.Tensor        # (B, n, n) approximate inverse Hessians
    s_norm: torch.Tensor
    y_norm: torch.Tensor
    Bg: torch.Tensor       # B g at the current iterate (fused mode: from K5)
    stalls: torch.Tensor   # consecutive degenerate pairs (restart mode)


def _scale(v, M):
    return v[:, None, None] * M


def _bfgs_update(B, s, y, rho):
    """Nocedal-Wright eq. 2.21, expanded (see the module docstring)."""
    By = matvec(B, y)
    yBy = dot(y, By)
    return (B - _scale(rho, outer(s, By) + outer(By, s))
            + _scale(rho * rho * yBy + rho, outer(s, s)))


def _dfp_update(B, s, y, sy):
    """``B += s s^T / s.y - (B y)(B y)^T / (y^T B y)`` (``dfp.rs:114-120``)."""
    By = matvec(B, y)
    return (B + outer(s, s) / sy[:, None, None]
            - outer(By, By) / dot(y, By)[:, None, None])


def _broyden_update(B, s, y, sy):
    """"Bad" Broyden rank-1 on the inverse:
    ``B += (s - B y) (B^T s)^T / s.y`` (``broyden.rs:114-118``)."""
    By = matvec(B, y)
    return B + outer(s - By, matvec(B.transpose(-1, -2), s)) / (
        sy[:, None, None])


def _sr1_update(B, s, y, sy):
    """SR1: ``B += (s - B y)(s - B y)^T / (s - B y).y``
    (``sr1_b.rs:143-147``)."""
    shy = s - matvec(B, y)
    return B + outer(shy, shy) / dot(shy, y)[:, None, None]


_UPDATES = {
    "bfgs": lambda B, s, y, sy: _bfgs_update(B, s, y,
                                             torch.ones_like(sy) / sy),
    "dfp": _dfp_update,
    "broyden": _broyden_update,
    "sr1": _sr1_update,
}


def _eye_batch(x):
    B, n = x.shape
    return torch.eye(n, dtype=x.dtype, device=x.device).expand(B, n, n)


@dataclasses.dataclass(frozen=True)
class _QuasiNewtonCommon:
    """Shared quasi-Newton fields; ``update`` picks the B-update rule
    (``"bfgs"``, ``"dfp"``, ``"broyden"``, ``"sr1"``)."""

    tol: float = 1e-8
    update: str = "bfgs"
    # the update and the next B g in one pass over B (the kernel K5 on CUDA)
    fused: bool = False
    scale_b0: bool = False
    restart_on_degeneracy: bool = False

    def __post_init__(self):
        if self.fused and (self.scale_b0 or self.restart_on_degeneracy):
            raise ValueError(
                "fused per-iteration QN mode does not implement "
                "scale_b0/restart_on_degeneracy; use the whole-solve fused "
                "kernel (ops.fused_minimize) or fused=False")

    def init(self, x, ev, bounds: Bounds):
        inf = torch.full_like(ev.f, float("inf"))
        # B0 = I, so B0 g = g
        return _QNState(_eye_batch(x), inf, inf, ev.g,
                        torch.zeros_like(ev.f, dtype=torch.int32))

    def converged(self, mstate, x, ev, bounds: Bounds):
        # the s/y-too-close early exits, then the gradient 2-norm test
        # (bfgs.rs:64-76; the 2-norm, not the infinity norm)
        g_small = torch.linalg.vector_norm(ev.g, dim=-1) < self.tol
        if self.restart_on_degeneracy:
            return g_small | (mstate.stalls >= 2)
        too_close = (mstate.s_norm < self.tol) | (mstate.y_norm < self.tol)
        return too_close | g_small

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        s = x_new - x
        y = ev_new.g - ev.g
        s_norm = torch.linalg.vector_norm(s, dim=-1)
        y_norm = torch.linalg.vector_norm(y, dim=-1)
        # freeze B on a degenerate pair (bfgs.rs:104-112)
        skip = (s_norm < self.tol) | (y_norm < self.tol)
        if self.scale_b0 or self.restart_on_degeneracy:
            return self._robust_post_step(mstate, s, y, s_norm, y_norm, skip)
        if self.fused:
            B_new, Bg = fused_qn.qn_update_direction_fused(
                mstate.B, s, y, ev_new.g, tol=self.tol, kind=self.update)
        else:
            B_new = _UPDATES[self.update](mstate.B, s, y, dot(s, y))
            B_new = torch.where(skip[:, None, None], mstate.B, B_new)
            Bg = mstate.Bg     # recomputed in direction()
        return _QNState(B_new, s_norm, y_norm, Bg, mstate.stalls)

    def _robust_post_step(self, mstate, s, y, s_norm, y_norm, skip):
        """The scale_b0 / restart_on_degeneracy variants."""
        eye = _eye_batch(s)
        sy = dot(s, y)
        curvature_ok = sy > torch.finfo(s.dtype).eps * s_norm * y_norm
        B_cur = mstate.B
        if self.scale_b0:
            first = ~torch.isfinite(mstate.s_norm)
            gamma = torch.where(curvature_ok, sy / dot(y, y),
                                torch.ones_like(sy))
            B_cur = torch.where((first & curvature_ok)[:, None, None],
                                _scale(gamma, eye), B_cur)
        B_new = _UPDATES[self.update](B_cur, s, y, sy)
        ok = (curvature_ok & torch.isfinite(B_new).flatten(1).all(-1)
              & ~skip)
        fallback = eye if self.restart_on_degeneracy else B_cur
        B_next = torch.where(ok[:, None, None], B_new, fallback)
        stalls = torch.where(ok, torch.zeros_like(mstate.stalls),
                             mstate.stalls + 1)
        return _QNState(B_next, s_norm, y_norm, mstate.Bg, stalls)

    def _bg(self, mstate, ev):
        return mstate.Bg if self.fused else matvec(mstate.B, ev.g)

    def stall_status(self, x, f, g, pg_norm, bounds):
        """Per-instance "the exit was the s/y-stall at a non-KKT point"
        mask: a CONVERGED exit with ``||g||_2 >= tol`` (the gradient test
        did not fire) and a projected-gradient norm above ``tol``.  Exits
        at a certified stationary point keep CONVERGED."""
        g_small = torch.sqrt(torch.sum(g * g, dim=-1)) < self.tol
        return ~g_small & (pg_norm > self.tol)


@dataclasses.dataclass(frozen=True)
class QuasiNewton(_QuasiNewtonCommon, Method):
    """Unconstrained quasi-Newton: direction ``-B g`` (``bfgs.rs:42-49``)."""

    def direction(self, mstate, x, ev, bounds: Bounds):
        d = -self._bg(mstate, ev)
        if self.restart_on_degeneracy:
            # descent safeguard
            d = torch.where((dot(ev.g, d) < 0.0)[:, None], d, -ev.g)
        return d, mstate


@dataclasses.dataclass(frozen=True)
class QuasiNewtonB(_QuasiNewtonCommon, BoundedMethod):
    """Box-constrained quasi-Newton: ``d = P_box(x - B g) - x``
    (``bfgs_b.rs:66-77``); convergence still tests the raw gradient
    2-norm, as the reference does (``bfgs_b.rs:92-104``)."""

    def direction(self, mstate, x, ev, bounds: Bounds):
        d = box_projection(x - self._bg(mstate, ev), *bounds) - x
        if self.restart_on_degeneracy:
            d = torch.where((dot(ev.g, d) < 0.0)[:, None], d,
                            box_projection(x - ev.g, *bounds) - x)
        return d, mstate


def BFGS(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="bfgs", **kw)


def DFP(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="dfp", **kw)


def Broyden(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="broyden", **kw)


def BFGSB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="bfgs", **kw)


def DFPB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="dfp", **kw)


def BroydenB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="broyden", **kw)


def SR1B(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    """SR1 exists only in bounded form in the reference (``lib.rs:60-61``)."""
    return QuasiNewtonB(tol=tol, update="sr1", **kw)
