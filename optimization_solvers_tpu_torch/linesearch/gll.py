"""Grippo-Lampariello-Lucidi non-monotone search with safeguarded quadratic
interpolation: its config.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.gll`.  The
non-monotone Armijo test compares against the max of the last ``m``
objective values (``gll_quadratic.rs``); K3 keeps them per instance across
iterations.  The lockstep body is not ported yet (ROADMAP.md Queue 1 item
7).
"""

from __future__ import annotations

import dataclasses

from .base import LineSearch


@dataclasses.dataclass(frozen=True)
class GLLQuadratic(LineSearch):
    """``GLLQuadratic::new(c1, m)`` with the sigma window defaults 0.1/0.9
    (``gll_quadratic.rs:12-28``)."""

    c1: float = 1e-4
    m: int = 10
    sigma1: float = 0.1
    sigma2: float = 0.9
