"""Grippo-Lampariello-Lucidi non-monotone search with safeguarded quadratic
interpolation.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.gll`, with the
same fields and defaults.  The non-monotone Armijo test compares against
the max of the last ``m`` objective values (``gll_quadratic.rs``), kept per
instance as a ``(B, m)`` ring (initialised to -inf) and a write position
carried across solver iterations; ``m = 1`` is the monotone Armijo search.
As in JAX, a nonpositive or non-finite interpolated trial falls back to
bisection (the guard against the rejected-interpolant halving freezing
``t`` at -0 when ``f`` overflows).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import dot
from .base import (Bounds, LineSearch, full_like_batch, lanes, masked_while,
                   start_done)


@dataclasses.dataclass(frozen=True)
class GLLQuadratic(LineSearch):
    """``GLLQuadratic::new(c1, m)`` with the sigma window defaults 0.1/0.9
    (``gll_quadratic.rs:12-28``)."""

    c1: float = 1e-4
    m: int = 10
    sigma1: float = 0.1
    sigma2: float = 0.9

    def init_state(self, ev0):
        fhist = torch.full(ev0.f.shape + (self.m,), -float("inf"),
                           dtype=ev0.f.dtype, device=ev0.f.device)
        return (fhist, full_like_batch(ev0.f, 0, torch.int32))

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        fhist, pos = state
        # append f(x_k) to the history ring (gll_quadratic.rs:62)
        fhist = fhist.scatter(1, (pos % self.m).long()[:, None],
                              ev.f[:, None])
        pos = pos + 1
        f_max = torch.amax(fhist, dim=-1)
        f0 = ev.f
        g_dot_d = dot(ev.g, d)

        def cond(c):
            t, i, done = c
            return ~done & (i < max_iter)

        def body(c):
            t, i, done = c
            f_t = oracle.value(x + lanes(t) * d)
            # non-monotone Armijo vs f_max (gll_quadratic.rs:73)
            accept = f_t - f_max <= self.c1 * t * g_dot_d
            # safeguarded quadratic interpolation (gll_quadratic.rs:78-93)
            t_half = t * 0.5
            t_tmp = -0.5 * t * t * g_dot_d / (f_t - f0 - t * g_dot_d)
            t_quad = torch.where((t_tmp > self.sigma1)
                                 & (t_tmp < self.sigma2 * t), t_tmp,
                                 t_tmp * 0.5)
            t_next = torch.where(accept, t,
                                 torch.where(t <= 0.1, t_half, t_quad))
            t_next = torch.where(torch.isfinite(t_next) & (t_next > 0.0),
                                 t_next, t_half)
            return (t_next, i + 1, accept)

        t, _, _ = masked_while(cond, body, (
            full_like_batch(x, 1.0), full_like_batch(x, 0, torch.int32),
            start_done(x, active)))
        return t, (fhist, pos)
