"""Nonlinear conjugate gradient (Fletcher-Reeves, Polak-Ribiere+,
Hestenes-Stiefel, Dai-Yuan): its config.

Counterpart of :mod:`optimization_solvers_tpu.solvers.nonlinear_cg` (the
reference crate has no CG solver), with its lockstep body; the whole-solve
kernel K3 runs it too.  The state is the previous gradient and direction
and the iterations since the last restart: the direction restarts to
``-g`` when it loses descent and every ``restart_every`` iterations (every
n when 0), and a non-finite beta counts as 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.numerics import dot, infinity_norm
from ..linesearch.base import Bounds, lanes
from .base import Method

VARIANTS = ("fr", "pr+", "hs", "dy")


class _CGState(NamedTuple):
    g_prev: torch.Tensor
    d_prev: torch.Tensor
    k_since_restart: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NonlinearCG(Method):
    """``variant`` in {"fr", "pr+", "hs", "dy"}; ``restart_every=0`` means
    restart every n iterations."""

    grad_tol: float = 1e-8
    variant: str = "pr+"
    restart_every: int = 0

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(
                f"variant must be one of {VARIANTS}, got {self.variant!r}")

    def init(self, x, ev, bounds: Bounds):
        return _CGState(ev.g, -ev.g, torch.zeros_like(ev.f,
                                                      dtype=torch.int32))

    def converged(self, mstate, x, ev, bounds: Bounds):
        return infinity_norm(ev.g) < self.grad_tol

    def direction(self, mstate, x, ev, bounds: Bounds):
        g, gp, dp = ev.g, mstate.g_prev, mstate.d_prev
        y = g - gp
        gg = dot(g, g)
        if self.variant == "fr":
            beta = gg / dot(gp, gp)
        elif self.variant == "pr+":
            beta = torch.clamp(dot(g, y) / dot(gp, gp), min=0.0)
        elif self.variant == "hs":
            beta = dot(g, y) / dot(dp, y)
        else:
            beta = gg / dot(dp, y)
        # degenerate denominators (first iteration: y = 0) give inf/NaN
        # betas; fall back to steepest descent
        zero = torch.zeros_like(beta)
        beta = torch.where(torch.isfinite(beta), beta, zero)
        period = self.restart_every if self.restart_every > 0 else (
            x.shape[-1])
        periodic = mstate.k_since_restart >= period
        d = -g + lanes(torch.where(periodic, zero, beta)) * dp
        # restart to steepest descent if d is not a descent direction
        descent = dot(g, d) < 0.0
        d = torch.where(descent[:, None], d, -g)
        k_new = torch.where(periodic | ~descent,
                            torch.zeros_like(mstate.k_since_restart),
                            mstate.k_since_restart)
        return d, mstate._replace(k_since_restart=k_new)

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        return _CGState(ev.g, d, mstate.k_since_restart + 1)
