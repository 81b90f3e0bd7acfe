"""Armijo backtracking searches: their configs.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.backtracking`, with
the same fields and defaults.  In the whole-solve kernel K3 an
out-of-domain trial shrinks ``t`` within the one trial budget, so
``max_domain_shrinks`` is read only by the lockstep body (not ported yet,
ROADMAP.md Queue 1 item 7); on exhaustion the already shrunk ``t`` is
taken, as in the reference (``backtracking.rs:53``).
"""

from __future__ import annotations

import dataclasses

from .base import LineSearch


@dataclasses.dataclass(frozen=True)
class BackTracking(LineSearch):
    """Unconstrained Armijo backtracking: accept ``t`` when
    ``f(x + t d) - f(x) <= c1 t g.d``, else ``t *= beta``
    (``backtracking.rs:3-58``)."""

    c1: float = 1e-4
    beta: float = 0.5
    max_domain_shrinks: int = 64


@dataclasses.dataclass(frozen=True)
class BackTrackingB(LineSearch):
    """Box-constrained backtracking: each trial is projected onto the box
    and accepted when ``f(x_t) - f(x) <= (-c1/t) ||x_t - x||^2``
    (``backtracking_b.rs:1-90``)."""

    c1: float = 1e-4
    beta: float = 0.5
    max_domain_shrinks: int = 64
