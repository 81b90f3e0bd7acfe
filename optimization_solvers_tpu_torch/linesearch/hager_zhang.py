"""Hager-Zhang line search (CG_DESCENT, Hager & Zhang 2005/2006).

Counterpart of :mod:`optimization_solvers_tpu.linesearch.hager_zhang`,
with the same fields and defaults: the approximate Wolfe condition

    (2 delta - 1) phi'(0) >= phi'(t) >= sigma phi'(0),
    phi(t) <= phi(0) + eps |phi(0)|,

beside the standard Wolfe test, one value-and-gradient per trial, and the
bracket / theta-bisection / secant phases flattened into a per-instance
``mode`` tag (JAX's deviation from the paper included: single secant plus
the ``gamma`` forced-bisection safeguard).  An accepted instance freezes;
on exhaustion the best trial is returned with its evaluation, so
:meth:`HagerZhang.step_len_ev` needs no second oracle call.  K3
(:mod:`..ops.fused_driver`) runs the same state machine.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import dot
from ..core.types import FuncEval
from .base import (Bounds, LineSearch, dtype_const, full_like_batch, lanes,
                   masked_while, max_feasible_step, start_done, tree_where)

# mode tags of the flattened state machine
_BRACKET = 0   # expanding c by rho until phi'(c) >= 0 or phi(c) > f0 + eps
_BISECT = 1    # theta-bisection inside [a, b] (paper routine U3a-c)
_SECANT = 2    # secant step inside a valid opposite-slope bracket


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

    def _t_max(self, x, d, bounds: Bounds):
        """Max admissible step ``(B,)``; the bounded variant caps it."""
        return full_like_batch(x, float("inf"))

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        t, state, _, _ = self.step_len_ev(oracle, x, ev, d, state, bounds,
                                          max_iter, active)
        return t, state

    def step_len_ev(self, oracle, x, ev, d, state, bounds: Bounds,
                    max_iter: int, active=None):
        dtype = x.dtype
        t_max = self._t_max(x, d, bounds)
        delta, sigma, theta, gamma = (self.delta, self.sigma, self.theta,
                                      self.gamma)
        aw_slope = dtype_const(lambda c: 2.0 * c(self.delta) - 1.0, x)
        keep_a = dtype_const(lambda c: 1.0 - c(self.theta), x)
        tiny = torch.finfo(dtype).tiny
        f0 = ev.f
        d0 = dot(ev.g, d)                     # phi'(0)
        f_eps = f0 + self.eps * torch.abs(f0)

        def accept(t, ft, dt):
            # standard Wolfe (T1) or approximate Wolfe (T2) with the
            # f <= f0 + eps_k membership T2 needs
            wolfe = (ft - f0 <= delta * t * d0) & (dt >= sigma * d0)
            approx = (dt <= aw_slope * d0) & (dt >= sigma * d0) & (ft <= f_eps)
            return wolfe | approx

        def cond(carry):
            return ~carry[-2] & (carry[-1] < max_iter)

        def body(carry):
            (a, da_, b, c, mode, t_best, f_best, shrink_ref, f_ret, g_ret,
             done, i) = carry
            ev_t = oracle(x + lanes(c) * d)
            fc, dc = ev_t.f, dot(ev_t.g, d)
            ok = accept(c, fc, dc)
            # at the feasibility cap and still descending in-domain: the
            # boundary point is the answer
            ok = ok | ((c >= t_max) & (dc < 0.0) & (fc <= f_eps))
            # the best feasible point seen, returned on exhaustion
            better = (fc < f_best) & (c > 0.0)
            t_best = torch.where(ok, c, torch.where(better, c, t_best))
            f_best = torch.where(better, fc, f_best)
            # the returned evaluation tracks t_best; the first trial is
            # recorded unconditionally (it is the fallback min(1, t_max))
            sel_ev = ok | better | (i == 0)
            f_ret = torch.where(sel_ev, fc, f_ret)
            g_ret = torch.where(sel_ev[:, None], ev_t.g, g_ret)

            # interval update, the same for every mode
            to_secant = dc >= 0.0
            advance = ~to_secant & (fc <= f_eps)
            to_bisect = ~to_secant & (fc > f_eps)
            a_new = torch.where(advance, c, a)
            da_new = torch.where(advance, dc, da_)
            b_new = torch.where(to_secant | to_bisect, c, b)

            # next trial per mode
            grow = torch.minimum(self.rho * c, t_max)
            bis = keep_a * a_new + theta * b_new
            denom = dc - da_new
            sec = torch.where(torch.abs(denom) > tiny,
                              (a_new * dc - c * da_new) / denom, bis)
            width = b_new - a_new
            stalled = width > gamma * shrink_ref
            sec = torch.where((sec <= a_new) | (sec >= b_new) | stalled,
                              0.5 * (a_new + b_new), sec)
            shrink_ref = width
            next_mode = torch.where(
                to_secant, _SECANT,
                torch.where(to_bisect, _BISECT, mode)).to(mode.dtype)
            in_bracket_phase = (mode == _BRACKET) & advance
            c_new = torch.where(in_bracket_phase, grow,
                                torch.where(next_mode == _SECANT, sec, bis))
            frozen = done | ok
            moved = tree_where(~frozen, (a_new, da_new, b_new, c_new,
                                         next_mode, shrink_ref),
                               (a, da_, b, c, mode, shrink_ref))
            return (*moved[:5], t_best, f_best, moved[5], f_ret, g_ret,
                    frozen, i + 1)

        big = full_like_batch(x, torch.finfo(dtype).max)
        first = torch.minimum(full_like_batch(x, 1.0), t_max)
        carry = masked_while(cond, body, (
            full_like_batch(x, 0.0), d0, big, first,
            full_like_batch(x, _BRACKET, torch.int32), first, big, big, f0,
            ev.g, start_done(x, active), full_like_batch(x, 0, torch.int32)))
        t = carry[5]
        return t, state, x + lanes(t) * d, FuncEval(carry[8], carry[9])


@dataclasses.dataclass(frozen=True)
class HagerZhangB(HagerZhang):
    """Box-constrained Hager-Zhang: the bracketing expansion is capped at
    the per-coordinate max feasible step to the box boundary
    (:func:`.base.max_feasible_step`), and a boundary trial that
    still descends inside the eps band is accepted."""

    def _t_max(self, x, d, bounds: Bounds):
        if bounds is None:
            raise ValueError("HagerZhangB requires bounds")
        return max_feasible_step(x, d, bounds)
