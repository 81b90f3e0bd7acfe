"""Limited-memory BFGS (unbounded), two-loop recursion: its config.

Counterpart of :mod:`optimization_solvers_tpu.solvers.lbfgs`, with the same
fields and defaults.  The whole-solve kernel K3 (:mod:`..ops.fused_driver`)
runs it: the last ``m`` correction pairs, a pair kept when ``s.y > eps
y.y`` with ``eps`` floored at the working dtype's machine epsilon, the
history reset on a non-finite or non-descent direction and on a step that
leaves the iterate unchanged, and convergence on ``||g||_inf < tol``.
"""

from __future__ import annotations

import dataclasses

from .base import Method


@dataclasses.dataclass(frozen=True)
class LBFGS(Method):
    """Unbounded L-BFGS; ``m`` in [3, 20] recommended
    (``lbfgsb.rs:150-154``)."""

    tol: float = 1e-8
    m: int = 10
    curvature_eps: float = 2.2e-16
