"""Nonlinear conjugate gradient (Fletcher-Reeves, Polak-Ribiere+,
Hestenes-Stiefel, Dai-Yuan): its config.

Counterpart of :mod:`optimization_solvers_tpu.solvers.nonlinear_cg` (the
reference crate has no CG solver).  The whole-solve kernel K3 runs it: the
direction restarts to ``-g`` when it loses descent and every
``restart_every`` iterations (every n when 0), and a non-finite beta
counts as 0.
"""

from __future__ import annotations

import dataclasses

from .base import Method

VARIANTS = ("fr", "pr+", "hs", "dy")


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
