"""Constant unit step (``nosearch.rs:3-15``): its config.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.nosearch`.
"""

from __future__ import annotations

import dataclasses

from .base import LineSearch


@dataclasses.dataclass(frozen=True)
class NoSearch(LineSearch):
    """``t = 1`` at every iteration."""
