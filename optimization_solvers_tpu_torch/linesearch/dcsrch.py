"""MINPACK-2 ``dcsrch`` strong-Wolfe search: its config
(:class:`StrongWolfe`) and the safeguarded trial-value and interval update
``dcstep``.

PyTorch counterpart of :mod:`optimization_solvers_tpu.linesearch.dcsrch`.
``_dcstep`` is elementwise over tensors of any one shape;
``torch.minimum``/``torch.maximum`` propagate NaN as
``jnp.minimum``/``jnp.maximum`` do, and the NaN-trial handling is the JAX
function's: a NaN trial value counts as higher, and a NaN trial polynomial
bisects the bracket.  The search around it runs in the tall kernel's
dcsrch mode (``ops/fused_lbfgsb_tall.py``) and in K3's StrongWolfe spec
(``ops/fused_driver.py``); the lockstep search waits for the lockstep
solvers (ROADMAP.md Queue 1 items 3 and 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.numerics import box_projection
from .base import LineSearch


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
