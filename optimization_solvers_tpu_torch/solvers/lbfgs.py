"""Limited-memory BFGS (unbounded), two-loop recursion.

Counterpart of :mod:`optimization_solvers_tpu.solvers.lbfgs`, with the same
fields, defaults and lockstep body; the whole-solve kernel K3
(:mod:`..ops.fused_driver`) runs it too.  The last ``m`` correction pairs
per instance, ``(B, m, n)`` in chronological order (row ``m - 1`` the
newest); a pair is kept when ``s.y > eps y.y`` with ``eps`` floored at the
working dtype's machine epsilon; the history is reset on a non-finite or
non-descent direction and on a step that leaves the iterate unchanged;
convergence on ``||g||_inf < tol``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.numerics import dot, infinity_norm
from ..linesearch.base import Bounds, lanes, tree_where
from .base import Method


class LbfgsState(NamedTuple):
    S: torch.Tensor       # (B, m, n), row m-1 = newest correction pair
    Y: torch.Tensor       # (B, m, n)
    rho: torch.Tensor     # (B, m) 1 / s.y  (0 on invalid slots)
    valid: torch.Tensor   # (B, m) bool
    gamma: torch.Tensor   # (B,) H0 = gamma I scaling


def two_loop_direction(state: LbfgsState, g: torch.Tensor) -> torch.Tensor:
    """``d = -H g`` via the two-loop recursion over the valid pairs."""
    m = state.S.shape[1]
    q = g
    alphas = [None] * m
    for j in range(m - 1, -1, -1):          # newest -> oldest
        a = state.rho[:, j] * dot(state.S[:, j], q)
        a = torch.where(state.valid[:, j], a, torch.zeros_like(a))
        q = q - lanes(a) * state.Y[:, j]
        alphas[j] = a
    r = lanes(state.gamma) * q
    for j in range(m):                      # oldest -> newest
        b = state.rho[:, j] * dot(state.Y[:, j], r)
        b = torch.where(state.valid[:, j], b, torch.zeros_like(b))
        r = r + lanes(alphas[j] - b) * state.S[:, j]
    return -r


def push_pair(state: LbfgsState, s, y, eps: float) -> LbfgsState:
    """Append ``(s, y)`` where the curvature test ``s.y > eps ||y||^2``
    holds (the Fortran ``setulb`` acceptance); ``eps`` is floored at the
    working dtype's machine epsilon."""
    sy = dot(s, y)
    yy = dot(y, y)
    eps = max(float(eps), float(torch.finfo(y.dtype).eps))
    accept = sy > eps * yy

    def roll_in(hist, new):
        return torch.cat([hist[:, 1:], new[:, None]], dim=1)

    pushed = LbfgsState(
        S=roll_in(state.S, s), Y=roll_in(state.Y, y),
        rho=roll_in(state.rho, torch.ones_like(sy) / sy),
        valid=roll_in(state.valid, torch.ones_like(accept)),
        gamma=sy / yy)
    return tree_where(accept, pushed, state)


def init_state(B: int, n: int, m: int, dtype, device) -> LbfgsState:
    return LbfgsState(
        S=torch.zeros((B, m, n), dtype=dtype, device=device),
        Y=torch.zeros((B, m, n), dtype=dtype, device=device),
        rho=torch.zeros((B, m), dtype=dtype, device=device),
        valid=torch.zeros((B, m), dtype=torch.bool, device=device),
        gamma=torch.ones((B,), dtype=dtype, device=device))


def _reset(state: LbfgsState, where: torch.Tensor) -> LbfgsState:
    """Drop the history (the pairs stay, marked invalid) where ``where``."""
    return state._replace(
        rho=torch.where(where[:, None], torch.zeros_like(state.rho),
                        state.rho),
        valid=state.valid & ~where[:, None],
        gamma=torch.where(where, torch.ones_like(state.gamma), state.gamma))


@dataclasses.dataclass(frozen=True)
class LBFGS(Method):
    """Unbounded L-BFGS; ``m`` in [3, 20] recommended
    (``lbfgsb.rs:150-154``)."""

    tol: float = 1e-8
    m: int = 10
    curvature_eps: float = 2.2e-16

    def init(self, x, ev, bounds: Bounds):
        return init_state(x.shape[0], x.shape[-1], self.m, x.dtype, x.device)

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        d = two_loop_direction(mstate, ev.g)
        # descent safeguard with history reset: a non-descent or non-finite
        # two-loop direction is discarded and the iteration retried from
        # steepest descent (mainlb's restart)
        ok = torch.isfinite(d).all(-1) & (dot(ev.g, d) < 0.0)
        d = torch.where(ok[:, None], d, -ev.g)
        return d, _reset(mstate, ~ok)

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        mstate = push_pair(mstate, x_new - x, ev_new.g - ev.g,
                           self.curvature_eps)
        # zero-progress repair: a step that leaves x unchanged drops the
        # model, so the next iteration retries from steepest descent
        return _reset(mstate, (x_new == x).all(-1))
