"""MINPACK-2 ``dcsrch`` strong-Wolfe search: its config
(:class:`StrongWolfe`) and the safeguarded trial-value and interval update
``dcstep``.

PyTorch counterpart of :mod:`optimization_solvers_tpu.linesearch.dcsrch`.
``_dcstep`` is elementwise over tensors of any one shape;
``torch.minimum``/``torch.maximum`` propagate NaN as
``jnp.minimum``/``jnp.maximum`` do, and the NaN-trial handling is the JAX
function's: a NaN trial value counts as higher, and a NaN trial polynomial
bisects the bracket.  The search around it runs in the tall kernel's
dcsrch mode (``ops/fused_lbfgsb_tall.py``), in K3's StrongWolfe spec
(``ops/fused_driver.py``) and in the lockstep :class:`StrongWolfe` here,
whose per-instance state is JAX's ``_State`` over ``(B,)`` tensors; it
returns the accepted step's evaluation with the step, so the driver makes
no second oracle call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.numerics import box_projection, dot
from ..core.types import FuncEval
from .base import (Bounds, LineSearch, full_like_batch, lanes, masked_while,
                   max_feasible_step, start_done)


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stmin, stmax):
    """One safeguarded trial-value + interval update (MINPACK-2 ``dcstep``).

    Every operand is a tensor of one shape (``brackt`` boolean); returns
    the updated ``(stx, fx, dx, sty, fy, dy, stp, brackt)``."""
    where = torch.where
    # jnp.sign keeps NaN, torch.sign maps it to 0
    sgnd = dp * torch.where(torch.isnan(dx), dx, torch.sign(dx))

    # cubic / quadratic candidates for each of the four cases
    theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp
    s = torch.maximum(torch.maximum(theta.abs(), dx.abs()), dp.abs())
    gamma_sq = (theta / s) ** 2 - (dx / s) * (dp / s)
    gamma = s * torch.sqrt(torch.clamp_min(gamma_sq, 0.0))

    # case 1: higher function value (or NaN) -> minimum bracketed
    g1 = where(stp < stx, -gamma, gamma)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    stpc1 = stx + (p1 / q1) * (stp - stx)
    stpq1 = stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / 2.0) * (stp - stx)
    case1 = ~(fp <= fx)
    stpf1 = where((stpc1 - stx).abs() < (stpq1 - stx).abs(), stpc1,
                  stpc1 + (stpq1 - stpc1) / 2.0)

    # case 2: lower value, derivatives of opposite sign -> bracketed
    g2 = where(stp > stx, -gamma, gamma)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    stpc2 = stp + (p2 / q2) * (stx - stp)
    stpq2 = stp + (dp / (dp - dx)) * (stx - stp)
    case2 = ~case1 & (sgnd < 0.0)
    stpf2 = where((stpc2 - stp).abs() > (stpq2 - stp).abs(), stpc2, stpq2)

    # case 3: lower value, same sign, decreasing derivative magnitude
    g3 = where(stp > stx, -gamma, gamma)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    r3 = p3 / q3
    stpc3 = where((r3 < 0.0) & (g3 != 0.0), stp + r3 * (stx - stp),
                  where(stp > stx, stmax, stmin))
    stpq3 = stp + (dp / (dp - dx)) * (stx - stp)
    case3 = ~case1 & ~case2 & (dp.abs() < dx.abs())
    near = where((stpc3 - stp).abs() < (stpq3 - stp).abs(), stpc3, stpq3)
    cap = stp + 0.66 * (sty - stp)
    stpf3_brackt = where(stp > stx, torch.minimum(cap, near),
                         torch.maximum(cap, near))
    stpf3_free = box_projection(
        where((stpc3 - stp).abs() > (stpq3 - stp).abs(), stpc3, stpq3),
        stmin, stmax)
    stpf3 = where(brackt, stpf3_brackt, stpf3_free)

    # case 4: lower value, same sign, non-decreasing derivative magnitude
    theta4 = 3.0 * (fp - fy) / (sty - stp) + dy + dp
    s4 = torch.maximum(torch.maximum(theta4.abs(), dy.abs()), dp.abs())
    gamma4 = s4 * torch.sqrt(torch.clamp_min(
        (theta4 / s4) ** 2 - (dy / s4) * (dp / s4), 0.0))
    g4 = where(stp > sty, -gamma4, gamma4)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    stpc4 = stp + (p4 / q4) * (sty - stp)
    stpf4 = where(brackt, stpc4, where(stp > stx, stmax, stmin))

    stpf = where(case1, stpf1, where(case2, stpf2, where(case3, stpf3, stpf4)))
    new_brackt = brackt | case1 | case2

    # interval update: fp > fx: sty <- stp; elif sgnd < 0: sty <- stx,
    # stx <- stp; else stx <- stp
    sty_n = where(case1, stp, where(sgnd < 0.0, stx, sty))
    fy_n = where(case1, fp, where(sgnd < 0.0, fx, fy))
    dy_n = where(case1, dp, where(sgnd < 0.0, dx, dy))
    stx_n = where(case1, stx, stp)
    fx_n = where(case1, fx, fp)
    dx_n = where(case1, dx, dp)

    stpf = box_projection(stpf, stmin, stmax)
    # a NaN trial polynomial bisects the bracket (its ends are finite)
    mid = stx_n + 0.5 * (sty_n - stx_n)
    stpf = where(torch.isnan(stpf), where(new_brackt, mid, stmin), stpf)
    return stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, stpf, new_brackt


class _State(NamedTuple):
    i: torch.Tensor
    stp: torch.Tensor
    stx: torch.Tensor
    fx: torch.Tensor
    dx: torch.Tensor
    sty: torch.Tensor
    fy: torch.Tensor
    dy: torch.Tensor
    brackt: torch.Tensor
    stage1: torch.Tensor
    width: torch.Tensor
    width1: torch.Tensor
    stmin: torch.Tensor
    stmax: torch.Tensor
    done: torch.Tensor
    # (f, g) at the step the search will return: the current trial's on a
    # Wolfe or forced exit, the best point stx's on exhaustion
    f_ret: torch.Tensor
    g_ret: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StrongWolfe(LineSearch):
    """MINPACK-2 ``dcsrch`` strong-Wolfe search.  Defaults match the Fortran
    L-BFGS-B driver (``ftol=1e-3, gtol=0.9, xtol=0.1``).  When ``bounded``
    the max step is capped at the distance to the box boundary along ``d``
    (the L-BFGS-B ``stpmx`` computation)."""

    c1: float = 1e-3
    c2: float = 0.9
    xtol: float = 0.1
    stp_min: float = 0.0
    stp_max: float = math.inf
    bounded: bool = False
    xtrapl: float = 1.1
    xtrapu: float = 4.0

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        t, state, _, _ = self.step_len_ev(oracle, x, ev, d, state, bounds,
                                          max_iter, active)
        return t, state

    def step_len_ev(self, oracle, x, ev, d, state, bounds: Bounds,
                    max_iter: int, active=None):
        """``(t, state, x_new, ev_new)``: JAX ``dcsrch.py:189-329`` per
        instance; ``ev_new`` is the returned step's own trial evaluation."""
        where = torch.where
        c1, c2, xtol = self.c1, self.c2, self.xtol
        f0 = ev.f
        ginit = dot(ev.g, d)
        gtest = c1 * ginit
        stpmax_g = full_like_batch(x, self.stp_max)
        if self.bounded:
            if bounds is None:
                raise ValueError("bounded StrongWolfe requires bounds")
            stpmax_g = torch.minimum(stpmax_g, max_feasible_step(x, d, bounds))
        stpmin_g = full_like_batch(x, self.stp_min)
        stp0 = box_projection(full_like_batch(x, 1.0), stpmin_g, stpmax_g)
        # MINPACK's 'ERROR: INITIAL G .GE. ZERO' guard: a non-descent direction
        # returns t = 0 at once
        descent = ginit < 0.0
        stp0 = where(descent, stp0, torch.zeros_like(stp0))
        width0 = stpmax_g - stpmin_g
        zero = torch.zeros_like(stp0)
        init = _State(
            i=full_like_batch(x, 0, torch.int32), stp=stp0, stx=zero, fx=f0,
            dx=ginit, sty=zero, fy=f0, dy=ginit,
            brackt=torch.zeros_like(descent), stage1=torch.ones_like(descent),
            width=width0, width1=width0 / 0.5, stmin=zero,
            stmax=stp0 + self.xtrapu * stp0,
            done=~descent | start_done(x, active), f_ret=f0, g_ret=ev.g)

        def cond(s):
            return ~s.done & (s.i < max_iter)

        def body(s):
            ev_t = oracle(x + lanes(s.stp) * d)
            f = ev_t.f
            g = dot(ev_t.g, d)
            ftest = f0 + s.stp * gtest
            stage1 = s.stage1 & ~((f <= ftest) & (g >= 0.0))
            # convergence: strong Wolfe; forced termination: the bracket
            # collapsed below xtol, or the step is pinned at a global limit
            wolfe = (f <= ftest) & (torch.abs(g) <= c2 * (-ginit))
            small = s.brackt & (s.stmax - s.stmin <= xtol * s.stmax)
            at_max = (s.stp == stpmax_g) & (f <= ftest) & (g <= gtest)
            at_min = (s.stp == stpmin_g) & ((f > ftest) | (g >= gtest))
            out_of_interval = s.brackt & ((s.stp <= s.stmin)
                                          | (s.stp >= s.stmax))
            finish = wolfe | small | at_max | at_min | out_of_interval

            # stage-1 psi-modified update when the trial is below fx but above
            # the Armijo line
            use_mod = stage1 & (f <= s.fx) & (f > ftest)
            fm = where(use_mod, f - s.stp * gtest, f)
            fxm = where(use_mod, s.fx - s.stx * gtest, s.fx)
            fym = where(use_mod, s.fy - s.sty * gtest, s.fy)
            gm = where(use_mod, g - gtest, g)
            gxm = where(use_mod, s.dx - gtest, s.dx)
            gym = where(use_mod, s.dy - gtest, s.dy)
            stx, fx, dx, sty, fy, dy, stp, brackt = _dcstep(
                s.stx, fxm, gxm, s.sty, fym, gym, s.stp, fm, gm, s.brackt,
                s.stmin, s.stmax)
            fx = where(use_mod, fx + stx * gtest, fx)
            fy = where(use_mod, fy + sty * gtest, fy)
            dx = where(use_mod, dx + gtest, dx)
            dy = where(use_mod, dy + gtest, dy)

            # forced bisection if the bracket failed to shrink enough
            bisect = brackt & (torch.abs(sty - stx) >= 0.66 * s.width1)
            stp = where(bisect, stx + 0.5 * (sty - stx), stp)
            width1 = where(brackt, s.width, s.width1)
            width = where(brackt, torch.abs(sty - stx), s.width)
            # fmin/fmax skip a NaN (out-of-domain) far end
            stmin = where(brackt, torch.fmin(stx, sty),
                          stp + self.xtrapl * (stp - stx))
            stmax = where(brackt, torch.fmax(stx, sty),
                          stp + self.xtrapu * (stp - stx))
            stp = box_projection(stp, stpmin_g, stpmax_g)
            # no further progress possible: return the best point so far
            give_up = (brackt & ((stp <= stmin) | (stp >= stmax))) | (
                brackt & (stmax - stmin <= xtol * stmax))
            stp = where(give_up, stx, stp)
            # the returned evaluation tracks the returned step
            sel_ev = finish | (stx != s.stx)
            f_ret = where(sel_ev, f, s.f_ret)
            g_ret = where(sel_ev[:, None], ev_t.g, s.g_ret)
            return _State(
                i=s.i + 1, stp=where(finish, s.stp, stp),
                stx=where(finish, s.stx, stx), fx=where(finish, s.fx, fx),
                dx=where(finish, s.dx, dx), sty=where(finish, s.sty, sty),
                fy=where(finish, s.fy, fy), dy=where(finish, s.dy, dy),
                brackt=brackt | s.brackt, stage1=stage1,
                width=where(finish, s.width, width),
                width1=where(finish, s.width1, width1),
                stmin=where(finish, s.stmin, stmin),
                stmax=where(finish, s.stmax, stmax), done=finish, f_ret=f_ret,
                g_ret=g_ret)

        out = masked_while(cond, body, init)
        # on exhaustion the best step found (stx), not the live trial
        t = where(out.done, out.stp, out.stx)
        return t, state, x + lanes(t) * d, FuncEval(out.f_ret, out.g_ret)
