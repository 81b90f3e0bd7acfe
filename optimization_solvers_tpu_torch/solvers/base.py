"""Solver method protocol.

Counterpart of :mod:`optimization_solvers_tpu.solvers.base`.  A method is a
frozen config; its per-iteration state is an explicit tuple of tensors with
a leading batch axis, threaded through the lockstep driver
(:mod:`.driver`), and the whole-solve kernel K3 reads its fields
(:mod:`..ops.fused_driver`).  The hooks work on a batch: ``x`` and the
gradient are ``(B, n)``, ``f`` and every per-instance scalar ``(B,)``.

  * ``prepare_x0``: the constructor-time box projection of x0;
  * ``init``: the constructor-time state;
  * ``converged``: the per-solver stopping test, ``(B,)`` bool;
  * ``direction``: ``(d, state)``;
  * ``post_step``: the state refresh after the step, from the pair
    ``s = x_new - x``, ``y = g_new - g``; ``ev_new`` comes from the driver,
    which shares the reference's extra post-step evaluation with the next
    iteration's.
"""

from __future__ import annotations

import torch

from ..core.numerics import box_projection, infinity_norm, projected_gradient
from ..linesearch.base import Bounds


class Method:
    """Base solver config."""

    needs_hessian: bool = False

    def prepare_x0(self, x0: torch.Tensor, bounds: Bounds) -> torch.Tensor:
        return x0

    def init(self, x, ev, bounds: Bounds):
        return None

    def converged(self, mstate, x, ev, bounds: Bounds):
        raise NotImplementedError

    def direction(self, mstate, x, ev, bounds: Bounds):
        raise NotImplementedError

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        return mstate


class BoundedMethod(Method):
    """Mixin for box-constrained methods: x0 is projected onto the box, and
    convergence tests the infinity norm of the projected gradient
    (``ls_solver.rs:121-133``)."""

    def prepare_x0(self, x0: torch.Tensor, bounds: Bounds) -> torch.Tensor:
        if bounds is None:
            raise ValueError(f"{type(self).__name__} requires bounds")
        return box_projection(x0, *bounds)

    def projected_gradient_norm(self, x, ev, bounds: Bounds) -> torch.Tensor:
        """``||g||_inf`` with the components that push against an active
        bound zeroed, over the last axis."""
        lower, upper = bounds
        return infinity_norm(projected_gradient(ev.g, x, lower, upper))


def clamp_lambda(lam, lambda_min, lambda_max):
    """``lam.min(lambda_max).max(lambda_min)`` as the reference orders it
    (``spg.rs:44-46``), NaN propagating as ``jnp.minimum`` does."""
    return torch.clamp(torch.clamp(lam, max=lambda_max), min=lambda_min)
