"""Constant unit step (``nosearch.rs:3-15``).

Counterpart of :mod:`optimization_solvers_tpu.linesearch.nosearch`.
"""

from __future__ import annotations

import dataclasses

from .base import Bounds, LineSearch, full_like_batch


@dataclasses.dataclass(frozen=True)
class NoSearch(LineSearch):
    """``t = 1`` at every iteration."""

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        return full_like_batch(x, 1.0), state
