"""Solver method protocol.

Counterpart of :mod:`optimization_solvers_tpu.solvers.base`.  A method is a
frozen config; the whole-solve kernel K3 reads its fields
(:mod:`..ops.fused_driver`).  The per-iteration hooks of the JAX lockstep
driver (``init``, ``converged``, ``direction``, ``post_step``) come with the
lockstep driver (ROADMAP.md Queue 1 item 7); until then they raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..core.numerics import box_projection, infinity_norm, projected_gradient
from ..linesearch.base import Bounds


_LOCKSTEP = ("the lockstep method bodies are not ported yet; the methods "
             "run inside the whole-solve kernel K3 (ROADMAP.md Queue 1 item "
             "7)")


class Method:
    """Base solver config."""

    needs_hessian: bool = False

    def init(self, x, ev, bounds: Bounds):
        raise NotImplementedError(_LOCKSTEP)

    def converged(self, mstate, x, ev, bounds: Bounds):
        raise NotImplementedError(_LOCKSTEP)

    def direction(self, mstate, x, ev, bounds: Bounds):
        raise NotImplementedError(_LOCKSTEP)

    def post_step(self, mstate, x, ev, d, t, x_new, ev_new, bounds: Bounds):
        raise NotImplementedError(_LOCKSTEP)

    def prepare_x0(self, x0: torch.Tensor, bounds: Bounds) -> torch.Tensor:
        return x0


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
