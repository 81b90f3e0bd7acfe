"""More-Thuente (1994) strong-Wolfe line search: its configs and the
trial-value helpers.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.morethuente`, with
the same fields and defaults.  The helpers are elementwise tensor functions
of the JAX module's formulas (Sun & Yuan, ``morethuente.rs:64-132``); K3's
plain version (:mod:`..ops.fused_driver`) runs them, and
``ops/csrc/driver.cuh`` repeats them per warp.  As in JAX K3, only the
corrected interval update (revised at the evaluated ``t``) has a fused
form: ``reference_quirks=True`` has none and raises ``NotImplementedError``
in the port until the lockstep search exists (ROADMAP.md Queue 1 item 7).
``approx_wolfe`` adds the Hager-Zhang approximate-Wolfe acceptance beside
the strong-Wolfe test, which ``minimize`` turns on for float32 under
``policy="fast"``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import LineSearch


def _cubic_minimizer(ta, tb, f_ta, f_tb, g_ta, g_tb):
    """Sun & Yuan eq. 2.4.51 / 2.4.56 (``morethuente.rs:93-108``)."""
    s = 3.0 * (f_tb - f_ta) / (tb - ta)
    z = s - g_ta - g_tb
    w = torch.sqrt(z * z - g_ta * g_tb)
    return ta + (tb - ta) * ((w - g_ta - z) / (g_tb - g_ta + 2.0 * w))


def _quadratic_minimizer_1(ta, tb, f_ta, f_tb, g_ta):
    """Sun & Yuan eq. 2.4.2 (``morethuente.rs:110-121``)."""
    lin_int = (f_ta - f_tb) / (ta - tb)
    return ta - 0.5 * ((ta - tb) * g_ta / (g_ta - lin_int))


def _quadratic_minimizer_2(ta, tb, g_ta, g_tb):
    """Sun & Yuan eq. 2.4.5 (``morethuente.rs:123-132``)."""
    return ta - g_ta * ((ta - tb) / (g_ta - g_tb))


def _update_interval(f_tl, f_t, g_t, tl, t, tu):
    """Cases U1/U2/U3 of the (modified) updating algorithm
    (``morethuente.rs:64-91``); returns ``(tl, tu, interval_converged)``."""
    u1 = f_t > f_tl
    gd = g_t * (tl - t)
    u2 = ~u1 & (gd > 0.0)
    u3 = ~u1 & ~u2 & (gd < 0.0)
    conv = ~(u1 | u2 | u3)
    new_tu = torch.where(u1, t, torch.where(u3, tl, tu))
    new_tl = torch.where(u2 | u3, t, tl)
    return new_tl, new_tu, conv


@dataclasses.dataclass(frozen=True)
class MoreThuente(LineSearch):
    """Strong-Wolfe search; defaults per ``morethuente.rs:16-28``.
    ``approx_wolfe`` accepts a trial also under the derivative-only test
    ``(2 c1 - 1) phi'(0) >= phi'(t) >= c2 phi'(0)`` with
    ``phi(t) <= phi(0) + aw_eps |phi(0)|`` (CG_DESCENT 2005, eq. 4.1)."""

    c1: float = 1e-4
    c2: float = 0.9
    t_min: float = 0.0
    t_max: float = math.inf
    delta_min: float = 0.58333333
    delta: float = 0.66
    delta_max: float = 1.1
    reference_quirks: bool = False
    approx_wolfe: bool = False
    aw_eps: float = 1e-6

    def __post_init__(self):
        assert 0.0 < self.c1 < self.c2 < 1.0, "require 0 < c1 < c2 < 1"


@dataclasses.dataclass(frozen=True)
class MoreThuenteB(MoreThuente):
    """Box-constrained More-Thuente (``morethuente_b.rs``): ``t_max`` is
    capped at the per-coordinate max feasible step to the box boundary,
    kept as a running minimum across the searches of one solve
    (``morethuente_b.rs:185-205``)."""
