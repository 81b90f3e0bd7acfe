"""Armijo backtracking searches (Boyd ch. 9.2).

Counterpart of :mod:`optimization_solvers_tpu.linesearch.backtracking`,
with the same fields and defaults.  The lockstep body evaluates only the
objective's value per trial.  As in the reference, an out-of-domain trial
(NaN or inf f) shrinks ``t`` by ``beta`` without consuming a trial
(``backtracking.rs:37-41``), with the total trips bounded at ``max_iter +
max_domain_shrinks``; on exhaustion the already shrunk ``t`` is returned
(``backtracking.rs:53``).  The whole-solve kernel K3 folds the
out-of-domain shrink into the one trial budget instead
(``pallas_driver.py:38-43``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import box_projection, dot
from .base import (Bounds, LineSearch, full_like_batch, lanes, masked_while,
                   start_done)


def _armijo_loop(x, max_iter, total_cap, beta, active, trial):
    """The shared trip loop: ``trial(t) -> (f_t, accept)`` per trip."""
    def cond(c):
        t, i, total, done = c
        return ~done & (i < max_iter) & (total < total_cap)

    def body(c):
        t, i, total, done = c
        f_t, accept = trial(t)
        out = ~torch.isfinite(f_t)
        accept = ~out & accept
        t_next = torch.where(accept, t, t * beta)
        i_next = i + torch.where(out | accept, 0, 1).to(i.dtype)
        return (t_next, i_next, total + 1, accept)

    zero = full_like_batch(x, 0, torch.int32)
    t, _, _, _ = masked_while(
        cond, body, (full_like_batch(x, 1.0), zero, zero,
                     start_done(x, active)))
    return t


@dataclasses.dataclass(frozen=True)
class BackTracking(LineSearch):
    """Unconstrained Armijo backtracking: accept ``t`` when
    ``f(x + t d) - f(x) <= c1 t g.d``, else ``t *= beta``
    (``backtracking.rs:3-58``)."""

    c1: float = 1e-4
    beta: float = 0.5
    max_domain_shrinks: int = 64

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        g_dot_d = dot(ev.g, d)

        def trial(t):
            f_t = oracle.value(x + lanes(t) * d)
            return f_t, f_t - ev.f <= self.c1 * t * g_dot_d

        return _armijo_loop(x, max_iter, max_iter + self.max_domain_shrinks,
                            self.beta, active, trial), state


@dataclasses.dataclass(frozen=True)
class BackTrackingB(LineSearch):
    """Box-constrained backtracking: each trial is projected onto the box
    before evaluation and accepted when ``f(x_t) - f(x) <= (-c1/t)
    ||x_t - x||^2`` (``backtracking_b.rs:1-90``)."""

    c1: float = 1e-4
    beta: float = 0.5
    max_domain_shrinks: int = 64

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        if bounds is None:
            raise ValueError("BackTrackingB requires bounds")
        lower, upper = bounds

        def trial(t):
            x_t = box_projection(x + lanes(t) * d, lower, upper)
            f_t = oracle.value(x_t)
            diff = x_t - x
            # a true division: python's scalar / tensor is a reciprocal
            # times the scalar in PyTorch, which rounds otherwise
            slope = torch.full_like(t, -self.c1) / t
            return f_t, f_t - ev.f <= slope * dot(diff, diff)

        return _armijo_loop(x, max_iter, max_iter + self.max_domain_shrinks,
                            self.beta, active, trial), state
