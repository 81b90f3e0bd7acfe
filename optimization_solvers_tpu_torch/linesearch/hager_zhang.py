"""Hager-Zhang line search (CG_DESCENT, Hager & Zhang 2005/2006): its
configs.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.hager_zhang`, with
the same fields and defaults.  K3 (:mod:`..ops.fused_driver`) runs the
flattened bracket / bisect / secant state machine of the JAX kernel's
``_HZSpec``: one value-and-gradient per trial, standard or approximate
Wolfe acceptance, and the best trial returned when the budget is spent.
"""

from __future__ import annotations

import dataclasses

from .base import LineSearch


@dataclasses.dataclass(frozen=True)
class HagerZhang(LineSearch):
    """CG_DESCENT line search with approximate Wolfe acceptance:
    ``delta`` / ``sigma`` are the Wolfe constants, ``eps`` the relative
    objective-error tolerance, ``theta`` the bisection weight, ``gamma``
    the required bracket-shrink factor, ``rho`` the expansion factor."""

    delta: float = 0.1
    sigma: float = 0.9
    eps: float = 1e-6
    theta: float = 0.5
    gamma: float = 0.66
    rho: float = 5.0


@dataclasses.dataclass(frozen=True)
class HagerZhangB(HagerZhang):
    """Box-constrained Hager-Zhang: the bracketing expansion is capped at
    the per-coordinate max feasible step to the box boundary, and a
    boundary trial that still descends inside the eps band is accepted."""
