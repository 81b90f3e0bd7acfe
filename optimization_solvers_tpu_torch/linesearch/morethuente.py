"""More-Thuente (1994) strong-Wolfe line search: its configs, the
trial-value helpers and the lockstep search.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.morethuente`, with
the same fields and defaults.  The helpers are elementwise tensor functions
of the JAX module's formulas (Sun & Yuan, ``morethuente.rs:64-132``); the
lockstep search and K3's plain version (:mod:`..ops.fused_driver`) run
them, and ``ops/csrc/driver.cuh`` repeats them per warp.  The reference's
branchy state machine is per-instance dataflow over ``(B,)`` tensors, one
trial per trip of :func:`.base.masked_while`.  By default the interval is
revised at the evaluated ``t`` (the corrected More-Thuente update);
``reference_quirks=True`` revises it at the next trial, bug for bug with
``morethuente.rs:293``, which only the lockstep search runs (K3 has no
form for it, as in JAX).  ``approx_wolfe`` adds the Hager-Zhang
approximate-Wolfe acceptance beside the strong-Wolfe test, which
``minimize`` turns on for float32 under ``policy="fast"``.

A trip evaluates ``phi`` at ``t``, at ``tl`` only when some instance does
not finish on ``t``, and at ``tu`` only when some instance takes the
case-4 step: JAX evaluates ``tl`` on every trip and discards the values a
finishing instance does not use, so every step here is JAX's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.numerics import dot, rust_clamp, rust_max, rust_min
from .base import (Bounds, LineSearch, dtype_const, full_like_batch, lanes,
                   masked_while, max_feasible_step, start_done, strong_wolfe)


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
    ``reference_quirks`` revises the interval at the next trial instead of
    the evaluated one (the reference's ``morethuente.rs:293``: after a
    case-1 step that sets ``tu`` to the next trial, the search can exit on
    ``t == tu`` without the Wolfe conditions holding).  ``approx_wolfe``
    accepts a trial also under the derivative-only test
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

    def _t_bounds(self, x, d, state, bounds: Bounds):
        """``(t_min, t_max, state)``, each bound ``(B,)``; the bounded
        variant caps ``t_max``."""
        return (full_like_batch(x, self.t_min), full_like_batch(x, self.t_max),
                state)

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        c1, c2, delta = self.c1, self.c2, self.delta
        t_min, t_max, state = self._t_bounds(x, d, state, bounds)
        f0 = ev.f
        g0d = dot(ev.g, d)
        aw_slope = dtype_const(lambda c: 2.0 * c(self.c1) - 1.0, x)

        def phi(t):
            """``phi(t) = f(x + t d)``, ``phi'(t) = g(x + t d) . d``
            (``morethuente.rs:134-139``)."""
            ev_t = oracle(x + lanes(t) * d)
            return ev_t.f, dot(ev_t.g, d)

        def psi_of(phi_f, phi_g, t):
            """Auxiliary psi (``morethuente.rs:140-149``)."""
            return phi_f - f0 - c1 * t * g0d, phi_g - c1 * g0d

        def cond(c):
            i, t, tl, tu, modified, int_conv, done = c
            return ~done & (i < max_iter)

        def body(c):
            i, t, tl, tu, modified, int_conv, done = c
            phi_t_f, phi_t_g = phi(t)
            swc = strong_wolfe(c1, c2, f0, phi_t_f, g0d, phi_t_g, t)
            if self.approx_wolfe:
                swc = swc | ((aw_slope * g0d >= phi_t_g)
                             & (phi_t_g >= c2 * g0d)
                             & (phi_t_f <= f0 + self.aw_eps * torch.abs(f0))
                             & (t > 0.0))
            # return conditions in reference order (morethuente.rs:184-205)
            finish = swc | int_conv | (t == tl) | (t == tu)
            psi_t_f, psi_t_g = psi_of(phi_t_f, phi_t_g, t)
            # switch to modified updating for good (morethuente.rs:212-215)
            modified = modified | ((psi_t_f <= 0.0) & (phi_t_g > 0.0))
            going = ~finish & ~done & (i < max_iter)
            if not bool(going.any()):
                return (i + 1, t, tl, tu, modified, int_conv, done | finish)

            phi_tl_f, phi_tl_g = phi(tl)
            psi_tl_f, psi_tl_g = psi_of(phi_tl_f, phi_tl_g, tl)
            f_l = torch.where(modified, phi_tl_f, psi_tl_f)
            g_l = torch.where(modified, phi_tl_g, psi_tl_g)
            f_c = torch.where(modified, phi_t_f, psi_t_f)
            g_c = torch.where(modified, phi_t_g, psi_t_g)

            # trial value selection, section 4 of the paper
            # (morethuente.rs:228-287)
            case1 = f_c > f_l
            case2 = ~case1 & (g_c * g_l < 0.0)
            case3 = ~case1 & ~case2 & (torch.abs(g_c) <= torch.abs(g_l))
            case4 = ~(case1 | case2 | case3)
            tc = _cubic_minimizer(tl, t, f_l, f_c, g_l, g_c)
            tq = _quadratic_minimizer_1(tl, t, f_l, f_c, g_l)
            ts = _quadratic_minimizer_2(tl, t, g_l, g_c)
            t1 = torch.where(torch.abs(tc - tl) < torch.abs(tq - tl), tc,
                             0.5 * (tq + tc))
            t2 = torch.where(torch.abs(tc - t) >= torch.abs(ts - t), tc, ts)
            t_plus = torch.where(torch.abs(tc - t) < torch.abs(ts - t), tc, ts)
            reach = t + delta * (tu - t)
            t3 = torch.where(t > tl, rust_min(t_plus, reach),
                             rust_max(t_plus, reach))
            # case 4 needs phi at tu (morethuente.rs:275-287)
            t4 = t
            need = case4 & going
            if bool(need.any()):
                phi_tu_f, phi_tu_g = phi(tu)
                psi_tu_f, psi_tu_g = psi_of(phi_tu_f, phi_tu_g, tu)
                f_u = torch.where(modified, phi_tu_f, psi_tu_f)
                g_u = torch.where(modified, phi_tu_g, psi_tu_g)
                t4 = torch.where(need, _cubic_minimizer(tu, t, f_c, f_u, g_c,
                                                        g_u), t)
            t_new = torch.where(case1, t1, torch.where(
                case2, t2, torch.where(case3, t3, t4)))
            # clamp with Rust NaN-collapsing semantics (morethuente.rs:290)
            t_new = rust_clamp(t_new, t_min, t_max)
            if not self.reference_quirks:
                # force-progress safeguard (MINPACK dcsrch): a trial on an
                # interval end extrapolates while unbracketed and bisects
                # once bracketed
                no_prog = ((t_new == tl) | (t_new == tu)
                           | ~torch.isfinite(t_new))
                fallback = torch.where(torch.isfinite(tu), 0.5 * (tl + tu),
                                       2.0 * t)
                t_new = torch.where(no_prog,
                                    rust_clamp(fallback, t_min, t_max), t_new)
            t_upd = t_new if self.reference_quirks else t
            tl_new, tu_new, conv_new = _update_interval(f_l, f_c, g_c, tl,
                                                        t_upd, tu)
            keep = finish
            return (i + 1, torch.where(keep, t, t_new),
                    torch.where(keep, tl, tl_new),
                    torch.where(keep, tu, tu_new), modified,
                    torch.where(keep, int_conv, conv_new), done | finish)

        no = start_done(x, None)
        init = (full_like_batch(x, 0, torch.int32),
                rust_min(rust_max(full_like_batch(x, 1.0), t_min), t_max),
                t_min, t_max, no, no, start_done(x, active))
        _, t, *_ = masked_while(cond, body, init)
        return t, state


@dataclasses.dataclass(frozen=True)
class MoreThuenteB(MoreThuente):
    """Box-constrained More-Thuente (``morethuente_b.rs``): ``t_max`` is
    capped at the per-coordinate max feasible step to the box boundary
    ``min_i (bound_i - x_i) / d_i``, kept as a running minimum across the
    searches of one solve (``morethuente_b.rs:185-205``; the reference
    mutates ``self.t_max``), carried in the search state."""

    def init_state(self, ev0):
        return full_like_batch(ev0.f, self.t_max)

    def _t_bounds(self, x, d, state, bounds: Bounds):
        if bounds is None:
            raise ValueError("MoreThuenteB requires bounds")
        running = torch.minimum(state, max_feasible_step(x, d, bounds))
        return full_like_batch(x, self.t_min), running, running

