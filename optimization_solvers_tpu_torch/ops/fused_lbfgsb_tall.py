"""Whole batched large-n L-BFGS-B solves (the tall kernel K2): one CUDA
kernel on the GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_lbfgsb_tall.py``
(``lbfgsb_solve_fused_tall``, kernel body ``_make_kernel``).  Both versions
here run its algorithm, instance by instance:

* the compact middle matrix inverted explicitly each iteration (Cholesky of
  the Schur complement, column solves, then the ``JU``/``TL`` blocks), with
  invalid history slots patched by ``D = 1`` and ``+1`` on the S.S diagonal;
* the generalized Cauchy point by geometric bisection over breakpoint
  values, each probe a closed-form evaluation of the path derivative
  (``seg_eval``), with the budget-exhausted fallback into the ``lo``
  segment and the single-crossing guard flag (``gcp_multimodal``);
* the primal subspace step with the explicit E / H / Gm tables;
* a projected value-only Armijo backtracking search, or the MINPACK
  ``dcsrch`` strong-Wolfe state machine (``line_search="dcsrch"``);
* Fortran failure semantics: a failed step restores the iterate and
  restarts the history, or ends ABNORMAL with an empty history.

Every loop of the TPU kernel runs until no lane of its tile is open and
every write is masked per lane, so the instances are independent: an
instance solved alone computes what the tile computes.

:func:`lbfgsb_solve_fused_tall` takes the plain version for a CPU ``x0``
and launches the CUDA kernel ``csrc/lbfgsb_tall.cu`` for a CUDA ``x0``; it
never falls back from one to the other.  The kernel runs a tile of up to
``MAX_TILE`` instances per thread block in lockstep, as the TPU kernel
does: the wrapper picks the tile from the batch and the card's SM count
(:func:`tile_for`), and shrinks it where the block's shared memory would
not hold it.  A block has one group of 128 threads per instance, and a
tile below ``MAX_TILE`` keeps up to ``MAX_TILE`` groups for the
objective's tile products.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm, box_projection
from ..core.types import SolveResult, Status
from ..linesearch.dcsrch import _dcstep
from .batched_oracle import (KERNEL_OBJECTIVES, batched_value,
                             batched_value_and_grad, kernel_operands)
from .fused_lbfgsb import EPS_MACH, MAX_M, _chol

LINE_SEARCHES = ("armijo", "dcsrch")
# kMaxRows of csrc/lbfgsb_tall.cu: LOG_SUM_EXP keeps its softmax in shared
# memory
MAX_ROWS = 4096
# kMaxTile of csrc/lbfgsb_tall.cu: instances per thread block
MAX_TILE = 4


def tile_for(B, sms):
    """Instances per block of K2 for a batch of ``B`` on a card with
    ``sms`` SMs: the fewest that put at most one block on each SM (at B =
    512 on 132 SMs, 4: 128 blocks), at most ``MAX_TILE``."""
    return max(1, min(MAX_TILE, -(-B // sms)))


def _cauchy_bisection(tb, g, z, Y, S, th, M, active, *, eps, bisect_iters,
                      gcp_guard_maxseg, trace=None):
    """The generalized Cauchy point of the plain version, every probe a full
    pass: segment bisection over the breakpoints ``tb`` (B, n), each probe
    a closed-form evaluation of the path derivative (``seg_eval``), and
    the budget-exhausted fallback into the bracket's ``lo`` segment.

    ``z`` is the bound each coordinate moves to, less x; ``Y``, ``S`` (B, m,
    n), ``th`` (B, 1) and the middle inverse ``M`` (B, 2m, 2m) are the
    model.  Returns ``(t_lo_fin, dtm, multimodal)``: the Cauchy point lies
    at ``t_lo_fin + dtm``, and ``multimodal`` is the guard's flag per
    instance (None when ``gcp_guard_maxseg`` is 0).  With a list as
    ``trace``, each bisection probe appends ``(open, t_lo, t_hi, f1,
    f2)``."""
    dt = g.dtype
    inf = float("inf")
    zero = torch.zeros_like(th)
    movingf = (tb > 0.0).to(dt)
    moving = movingf > 0

    def rsum(v):
        return torch.sum(v, dim=1, keepdim=True)

    def w_dot(v):
        return torch.cat([Y @ v, th[:, :, None] * (S @ v)], dim=1)

    def mapp(v):
        return (M @ v[..., None])[..., 0]

    def seg_min(f1, f2):
        return torch.where(f2 > eps, -f1 / f2,
                           torch.where(f1 < 0.0, inf, 0.0))

    def seg_eval(t_lo):
        """(f1, f2) of the model along the projected path at t_lo+."""
        freeseg = movingf * (tb > t_lo).to(dt)
        G2F = rsum(freeseg * g * g)
        d = -g * freeseg
        u = movingf * torch.where(tb <= t_lo, z, -g * t_lo)
        pc = w_dot(torch.stack([d, u], dim=-1))
        p2, c2 = pc[..., 0], pc[..., 1]
        f1 = (th * t_lo - 1.0) * G2F - rsum(p2 * mapp(c2))
        f2 = th * G2F - rsum(p2 * mapp(p2))
        return f1, f2

    def segment(t_at):
        """Start of the segment holding t_at, and its end."""
        t_lo_seg = torch.amax(torch.where(moving & (tb <= t_at), tb, 0.0),
                              dim=1, keepdim=True)
        t_hi_seg = torch.amin(
            torch.where(moving & (tb > t_lo_seg), tb, inf), dim=1,
            keepdim=True)
        return t_lo_seg, t_hi_seg

    t_min = torch.amin(torch.where(moving, tb, inf), dim=1, keepdim=True)
    hi0 = torch.amax(torch.where(moving & torch.isfinite(tb), tb, -inf),
                     dim=1, keepdim=True)
    has_fin = hi0 > 0.0
    f1_0, f2_0 = seg_eval(zero)
    dt0 = seg_min(f1_0, f2_0)
    doneA = f1_0 >= 0.0                         # t_cp = 0
    doneB = ~doneA & (dt0 <= t_min)             # min in the 1st segment
    f1_L, f2_L = seg_eval(torch.where(has_fin, hi0, zero))
    dtL = seg_min(f1_L, f2_L)
    doneC = ~doneA & ~doneB & has_fin & (f1_L < 0.0)
    done = doneA | doneB | doneC
    t_fin = torch.where(doneC, hi0, zero)
    dtm = torch.where(doneA, zero, torch.where(doneB, dt0, dtL))
    b_lo, b_hi = t_min, hi0
    for _ in range(bisect_iters):
        open_ = ~done & active
        if not bool(open_.any()):
            break
        t_lo_seg, t_hi_seg = segment(torch.sqrt(b_lo) * torch.sqrt(b_hi))
        f1, f2 = seg_eval(t_lo_seg)
        dtt = seg_min(f1, f2)
        if trace is not None:
            trace.append((open_, t_lo_seg, t_hi_seg, f1, f2))
        found = open_ & (((f1 >= 0.0) & (t_lo_seg <= b_lo))
                         | ((f1 < 0.0) & (t_lo_seg + dtt <= t_hi_seg)))
        godn = open_ & ~found & (f1 >= 0.0)
        goup = open_ & ~found & (f1 < 0.0)
        b_lo = torch.where(goup, t_hi_seg, b_lo)
        b_hi = torch.where(godn, t_lo_seg, b_hi)
        done = done | found
        t_fin = torch.where(found, t_lo_seg, t_fin)
        dtm = torch.where(found, dtt, dtm)

    # budget exhausted (non-monotone path derivative): finalize in the
    # bracket's lo segment with dt clamped into it
    open_ = ~done
    t_lo_seg, t_hi_seg = segment(b_lo)
    dt_fb = box_projection(seg_min(*seg_eval(t_lo_seg)), zero,
                       t_hi_seg - t_lo_seg)
    t_lo_fin = torch.where(open_, t_lo_seg, t_fin)
    dtm = torch.maximum(torch.where(open_, dt_fb, dtm), zero)
    multimodal = None
    if gcp_guard_maxseg:
        # exhausted in a bracket of <= maxseg segments: the path
        # derivative is non-monotone at this precision for this lane
        cnt = rsum((moving & (tb > b_lo) & (tb <= b_hi)).to(dt))
        multimodal = open_ & active & (cnt <= float(gcp_guard_maxseg))
    return t_lo_fin, dtm, multimodal


def lbfgsb_solve_tall_plain(obj, x0, lower, upper, data=(), *, m=10,
                            pgtol=1e-5, factr=1e7, max_iter=500,
                            max_iter_ls=20, c1=1e-3, bisect_iters=40,
                            gcp_guard_maxseg=4, line_search="armijo"):
    """Plain batched PyTorch version of K2, the same algorithm as the CUDA
    kernel.

    ``x0`` is ``(B, n)``; ``lower``/``upper`` are ``(n,)`` shared or
    ``(B, n)`` per instance.  Per-instance scalars are ``(B, 1)`` columns,
    as in the TPU kernel.  Returns ``(x, f, iterations, status, flag)``;
    the caller adds the epilogue."""
    if line_search not in LINE_SEARCHES:
        raise ValueError(f"line_search must be one of {LINE_SEARCHES}, got "
                         f"{line_search!r}")
    B, n = x0.shape
    dt = x0.dtype
    dev = x0.device
    eps = EPS_MACH[dt]
    f_rtol = factr * eps
    inf = float("inf")
    lo = lower.to(dt)
    up = upper.to(dt)
    bvg = batched_value_and_grad(obj, data)
    bval = batched_value(obj, data)

    def col(shape_fill):
        return torch.full((B, 1), shape_fill, dtype=dt, device=dev)

    def rsum(v):
        return torch.sum(v, dim=1, keepdim=True)

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    X = clip(x0)
    fv, G = bvg(X)
    Fv = fv[:, None]
    Fprev = col(inf)
    S = torch.zeros((B, m, n), dtype=dt, device=dev)
    Y = torch.zeros((B, m, n), dtype=dt, device=dev)
    SY = torch.zeros((B, m, m), dtype=dt, device=dev)
    SS = torch.zeros((B, m, m), dtype=dt, device=dev)
    valid = torch.zeros((B, m), dtype=torch.bool, device=dev)
    theta = col(1.0)
    iters = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    abn = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    gflag = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    zero = col(0.0)
    one = col(1.0)

    def converged():
        pg = torch.amax(torch.abs(X - clip(X - G)), dim=1, keepdim=True)
        fmax = torch.clamp(torch.maximum(torch.abs(Fv), torch.abs(Fprev)),
                           min=1.0)
        return (pg <= pgtol) | (torch.isfinite(Fprev)
                                & ((Fprev - Fv) <= f_rtol * fmax))

    def active_mask():
        return torch.isfinite(Fv) & ~abn & ~converged()

    def build_middle():
        """The explicit 2m x 2m inverse M of the middle matrix, with D, the
        strictly lower L = tril(S.Y) and the patched S.S."""
        Dg = torch.where(valid, torch.diagonal(SY, dim1=1, dim2=2), 1.0)
        L = torch.tril(SY, -1)
        SSp = SS + torch.diag_embed((~valid).to(dt))
        U = L / Dg[:, None, :]
        Sc = theta[:, :, None] * SSp + U @ L.transpose(1, 2)
        Ch = _chol(Sc, eps)
        eye = torch.eye(m, dtype=dt, device=dev).expand(B, m, m)
        J = torch.cholesky_solve(eye, Ch)
        JU = J @ U
        TL = U.transpose(1, 2) @ JU - torch.diag_embed(1.0 / Dg)
        M = torch.cat([torch.cat([TL, JU.transpose(1, 2)], 2),
                       torch.cat([JU, J], 2)], 1)
        return M, Dg, L, SSp

    def w_dot(v):
        """W^T v for (B, n) or (B, n, k) v; W = [Y^T, theta S^T]."""
        c = v if v.dim() == 3 else v[..., None]
        out = torch.cat([Y @ c, theta[:, :, None] * (S @ c)], dim=1)
        return out if v.dim() == 3 else out[..., 0]

    def w_apply(coef):
        """W coef: (B, n) from (B, 2m)."""
        return ((Y.transpose(1, 2) @ coef[:, :m, None])[..., 0]
                + (S.transpose(1, 2)
                   @ (coef[:, m:] * theta)[..., None])[..., 0])

    def line_search_armijo(x, d, f0, g0d, stpmax, active):
        t = torch.minimum(one, stpmax)
        ldone = ~active
        for _ in range(max_iter_ls):
            if bool(ldone.all()):
                break
            fv_t = bval(x + t * d)[:, None]
            ok = (fv_t <= f0 + c1 * t * g0d) & torch.isfinite(fv_t)
            keep = ldone | ok
            t = torch.where(keep, t, t * 0.5)
            ldone = keep
        return t

    def line_search_dcsrch(x, d, f0, g0d, stpmax, active):
        """MINPACK dcsrch (ftol = c1, gtol 0.9, xtol 0.1), first trial
        capped at the largest feasible step; exhaustion returns stx."""
        gtol, xtol, xtrapl, xtrapu = 0.9, 0.1, 1.1, 4.0
        ginit = g0d
        gtest = c1 * ginit
        stpmin = zero
        descent = ginit < 0.0
        stp = torch.where(descent, box_projection(one, stpmin, stpmax), zero)
        stx, fx, dx = zero, f0, ginit
        sty, fy, dy = zero, f0, ginit
        brackt = torch.zeros_like(active)
        stage1 = torch.ones_like(active)
        width = stpmax - stpmin
        width1 = width / 0.5
        stmin, stmax = zero, stp + xtrapu * stp
        wdone = ~active | ~descent
        for _ in range(max_iter_ls):
            if bool(wdone.all()):
                break
            f_t, g_row = bvg(x + stp * d)
            f_t = f_t[:, None]
            gd = rsum(g_row * d)
            ftest = f0 + stp * gtest
            stage1_n = stage1 & ~((f_t <= ftest) & (gd >= 0.0))
            finish = (((f_t <= ftest) & (torch.abs(gd) <= gtol * (-ginit)))
                      | (brackt & (stmax - stmin <= xtol * stmax))
                      | ((stp == stpmax) & (f_t <= ftest) & (gd <= gtest))
                      | ((stp == stpmin) & ((f_t > ftest) | (gd >= gtest)))
                      | (brackt & ((stp <= stmin) | (stp >= stmax))))
            mod = stage1_n & (f_t <= fx) & (f_t > ftest)

            def shifted(v, by):
                return torch.where(mod, v - by, v)

            (stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, stp_n,
             brackt_n) = _dcstep(stx, shifted(fx, stx * gtest),
                                 shifted(dx, gtest), sty,
                                 shifted(fy, sty * gtest),
                                 shifted(dy, gtest), stp,
                                 shifted(f_t, stp * gtest),
                                 shifted(gd, gtest), brackt, stmin, stmax)
            fx_n = torch.where(mod, fx_n + stx_n * gtest, fx_n)
            fy_n = torch.where(mod, fy_n + sty_n * gtest, fy_n)
            dx_n = torch.where(mod, dx_n + gtest, dx_n)
            dy_n = torch.where(mod, dy_n + gtest, dy_n)
            bisect = brackt_n & (torch.abs(sty_n - stx_n) >= 0.66 * width1)
            stp_n = torch.where(bisect, stx_n + 0.5 * (sty_n - stx_n), stp_n)
            width1_n = torch.where(brackt_n, width, width1)
            width_n = torch.where(brackt_n, torch.abs(sty_n - stx_n), width)
            stmin_n = torch.where(brackt_n, torch.fmin(stx_n, sty_n),
                                  stp_n + xtrapl * (stp_n - stx_n))
            stmax_n = torch.where(brackt_n, torch.fmax(stx_n, sty_n),
                                  stp_n + xtrapu * (stp_n - stx_n))
            stp_n = box_projection(stp_n, stpmin, stpmax)
            give_up = brackt_n & ((stp_n <= stmin_n) | (stp_n >= stmax_n)
                                  | (stmax_n - stmin_n <= xtol * stmax_n))
            stp_n = torch.where(give_up, stx_n, stp_n)

            frozen = wdone | finish

            def keep(old, new):
                return torch.where(frozen, old, new)

            stp, stx, fx, dx = (keep(stp, stp_n), keep(stx, stx_n),
                                keep(fx, fx_n), keep(dx, dx_n))
            sty, fy, dy = keep(sty, sty_n), keep(fy, fy_n), keep(dy, dy_n)
            brackt = keep(brackt, brackt | brackt_n)
            stage1 = keep(stage1, stage1_n)
            width, width1 = keep(width, width_n), keep(width1, width1_n)
            stmin, stmax = keep(stmin, stmin_n), keep(stmax, stmax_n)
            wdone = frozen
        return torch.where(wdone, stp, stx)

    search = (line_search_dcsrch if line_search == "dcsrch"
              else line_search_armijo)

    active = active_mask()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        g, x, th = G, X, theta
        M, Dg, L, SSp = build_middle()

        def mapp(v):
            return (M @ v[..., None])[..., 0]

        # ---- generalized Cauchy point by segment bisection
        tb = torch.where(g < 0.0, (x - up) / g,
                         torch.where(g > 0.0, (x - lo) / g, inf))
        movingf = (tb > 0.0).to(dt)
        bound_vec = torch.where(g < 0.0, up, torch.where(g > 0.0, lo, x))
        z = bound_vec - x

        t_lo_fin, dtm, multimodal = _cauchy_bisection(
            tb, g, z, Y, S, th, M, active, eps=eps,
            bisect_iters=bisect_iters, gcp_guard_maxseg=gcp_guard_maxseg)
        t_cp = t_lo_fin + dtm
        if multimodal is not None:
            gflag = gflag | multimodal

        fixedf = movingf * (tb <= t_lo_fin).to(dt)
        freef = movingf * (tb > t_lo_fin).to(dt)
        d_rem = -g * freef
        # t_cp is inf only where d_rem == 0: skip the inf * 0
        xcp = torch.where(fixedf > 0, bound_vec,
                          x + torch.where(d_rem == 0.0, 0.0, t_cp * d_rem))
        c2 = w_dot(xcp - x)

        # ---- subspace minimization from the Cauchy point
        rF = (g + th * (xcp - x) - w_apply(mapp(c2))) * freef
        fr = freef[:, None, :]
        YF, SF = Y * fr, S * fr
        th3 = th[:, :, None]
        E = (YF @ YF.transpose(1, 2)) / th3 + torch.diag_embed(Dg)
        H = th3 * (SSp - SF @ SF.transpose(1, 2))
        Gm = L.transpose(1, 2) - YF @ SF.transpose(1, 2)
        Ech = _chol(E, eps)
        L2 = _chol(H + Gm.transpose(1, 2) @ torch.cholesky_solve(Gm, Ech),
                   eps)
        u2 = w_dot(rF)
        a, b = u2[:, :m, None], u2[:, m:, None]
        v = torch.cholesky_solve(
            b + Gm.transpose(1, 2) @ torch.cholesky_solve(a, Ech), L2)
        u = torch.cholesky_solve(-a + Gm @ v, Ech)
        du = -(rF / th + freef * w_apply(torch.cat([u, v], 1)[..., 0])
               / (th * th))
        steps = torch.where(du > 0.0, (up - xcp) / du,
                            torch.where(du < 0.0, (lo - xcp) / du, inf))
        steps = torch.where(freef > 0, steps, inf)
        steps = torch.where(torch.isnan(steps), inf, steps)
        alpha = torch.minimum(one, torch.amin(steps, dim=1, keepdim=True))
        d = clip(xcp + alpha * torch.where(freef > 0, du, 0.0)) - x

        # ---- line search
        g0d = rsum(g * d)
        f0 = Fv
        fs = torch.where(d > 0.0, (up - x) / d,
                         torch.where(d < 0.0, (lo - x) / d, inf))
        fs = torch.where(torch.isnan(fs), inf, fs)
        stpmax = torch.amin(fs, dim=1, keepdim=True)
        t = search(x, d, f0, g0d, stpmax, active)

        # ---- step, failure semantics and history update
        X_new = x + t * d
        f_new, g_new = bvg(X_new)
        f_new = f_new[:, None]
        ok = (torch.isfinite(f_new)
              & torch.isfinite(X_new).all(1, keepdim=True)
              & torch.isfinite(g_new).all(1, keepdim=True))
        no_move = (X_new == x).all(1, keepdim=True)
        fail = active & (~ok | (f_new > f0) | (t <= 0.0) | no_move)
        has_hist = valid.any(1, keepdim=True)
        restart = fail & has_hist
        abn = abn | (fail & ~has_hist)
        keepx = ok & ~fail
        X_new = torch.where(keepx, X_new, x)
        f_new = torch.where(keepx, f_new, f0)
        g_new = torch.where(keepx, g_new, g)
        s = X_new - x
        y = g_new - g
        sy = rsum(s * y)
        yy = rsum(y * y)
        accept = active & ok & (sy > eps * yy)

        acc3 = accept[:, :, None]
        S = torch.where(acc3, torch.cat([S[:, 1:], s[:, None]], 1), S)
        Y = torch.where(acc3, torch.cat([Y[:, 1:], y[:, None]], 1), Y)
        valid = torch.where(accept, torch.cat(
            [valid[:, 1:], torch.ones_like(valid[:, :1])], 1), valid)
        theta = torch.where(accept, yy / sy, theta)
        SYn = torch.zeros_like(SY)
        SSn = torch.zeros_like(SS)
        SYn[:, :m - 1, :m - 1] = SY[:, 1:, 1:]
        SSn[:, :m - 1, :m - 1] = SS[:, 1:, 1:]
        SYn[:, m - 1, :] = (S[:, m - 1:] @ Y.transpose(1, 2))[:, 0]
        SYn[:, :, m - 1] = (S @ Y[:, m - 1, :, None])[..., 0]
        SSn[:, m - 1, :] = (S[:, m - 1:] @ S.transpose(1, 2))[:, 0]
        SSn[:, :, m - 1] = SSn[:, m - 1, :]
        SY = torch.where(acc3, SYn, SY)
        SS = torch.where(acc3, SSn, SS)

        rs3 = restart[:, :, None]
        S = torch.where(rs3, 0.0, S)
        Y = torch.where(rs3, 0.0, Y)
        SY = torch.where(rs3, 0.0, SY)
        SS = torch.where(rs3, 0.0, SS)
        valid = valid & ~restart
        theta = torch.where(restart, 1.0, theta)

        # a restart disables the stall exit for the retry iteration
        Fprev = torch.where(restart, inf, torch.where(active, f0, Fprev))
        X = torch.where(active, X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(active, g_new, G)
        iters = iters + active.to(torch.int32)
        active = active_mask()

    finite = torch.isfinite(Fv)
    status = torch.where(
        abn, int(Status.ABNORMAL),
        torch.where(converged() & finite, int(Status.CONVERGED),
                    torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                                int(Status.MAX_ITER_REACHED))))
    return (X, Fv[:, 0], iters[:, 0], status[:, 0].to(torch.int32),
            gflag[:, 0])


def _launch_cuda(obj, x0, lower, upper, data, *, m, pgtol, factr, max_iter,
                 max_iter_ls, c1, bisect_iters, gcp_guard_maxseg,
                 line_search):
    """Check the operands, launch ``csrc/lbfgsb_tall.cu`` on the current
    stream and return ``(x, f, iterations, status, flag)``."""
    from . import _build

    if x0.dim() != 2 or x0.dtype not in EPS_MACH:
        raise ValueError(f"x0 must be a (B, n) float32/float64 tensor, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    B, n = x0.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m must lie in [1, {MAX_M}], got {m}")
    bounds = []
    for name, v in (("lower", lower), ("upper", upper)):
        if v.device != x0.device:
            raise ValueError(f"{name} lies on {v.device}, x0 on {x0.device}")
        if tuple(v.shape) not in ((n,), (B, n)):
            raise ValueError(f"{name} must be ({n},) or ({B}, {n}), got "
                             f"{tuple(v.shape)}")
        bounds.append(v.to(x0.dtype).contiguous())
    lo, up = bounds
    if lo.shape != up.shape:
        raise ValueError("lower and upper must have the same shape")
    code, arrays = kernel_operands(obj, data, x0,
                                   kernel="the tall CUDA L-BFGS-B kernel K2")
    rows = arrays[0].shape[0] if code == KERNEL_OBJECTIVES["LOG_SUM_EXP"] else 0
    if rows > MAX_ROWS:
        raise ValueError(f"LOG_SUM_EXP with {rows} rows: the kernel keeps at "
                         f"most {MAX_ROWS} in shared memory")
    x0 = x0.contiguous()
    lib = _build.load()
    dtype = 1 if x0.dtype == torch.float64 else 0
    sms = torch.cuda.get_device_properties(x0.device).multi_processor_count
    tile = lib.lbfgsb_tall_fit_tile(dtype, code, m, rows, tile_for(B, sms))
    if tile < 1:
        raise ValueError(f"K2 takes no tile at m = {m}, {rows} rows: the "
                         "block's shared memory is too small")
    # a tile below MAX_TILE comes from a batch that puts at most one block
    # on each SM: the block keeps as many groups as fit, which join only
    # the objective's tile products and spread them over more threads
    groups = lib.lbfgsb_tall_fit_groups(dtype, code, m, rows, tile)
    work = torch.empty(lib.lbfgsb_tall_work_elems(B, n, m), dtype=x0.dtype,
                       device=x0.device)
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype, device=x0.device)
    it, st, flag = (torch.empty((B,), dtype=torch.int32, device=x0.device)
                    for _ in range(3))
    d0 = arrays[0].data_ptr() if len(arrays) > 0 else None
    d1 = arrays[1].data_ptr() if len(arrays) > 1 else None
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.lbfgsb_tall_launch(
            dtype, code, x0.data_ptr(),
            lo.data_ptr(), up.data_ptr(), n if lo.dim() == 2 else 0, d0, d1,
            rows, B, n, m, tile, groups, float(pgtol), float(factr),
            int(max_iter), int(max_iter_ls), float(c1), int(bisect_iters),
            int(gcp_guard_maxseg), LINE_SEARCHES.index(line_search),
            work.data_ptr(), x.data_ptr(), f.data_ptr(), it.data_ptr(),
            st.data_ptr(), flag.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lbfgsb_tall_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    lbfgsb_solve_fused_tall.launches += 1
    lbfgsb_solve_fused_tall.last_tile = tile
    lbfgsb_solve_fused_tall.last_groups = groups
    return x, f, it, st, flag


def lbfgsb_solve_fused_tall(obj, x0, lower, upper, data=(), *, m=10,
                            pgtol=1e-5, factr=1e7, max_iter=500,
                            max_iter_ls=20, c1=1e-3, bisect_iters=40,
                            gcp_guard_maxseg=4, line_search="armijo"):
    """Batched large-n box-constrained solves, a tile of instances per CUDA
    block.

    ``x0`` is ``(B, n)``; ``lower``/``upper`` are ``(n,)`` shared or
    ``(B, n)`` per instance; ``data`` is the objective's problem data,
    shared across instances.  A CPU ``x0`` runs
    :func:`lbfgsb_solve_tall_plain`; a CUDA ``x0`` launches the kernel (the
    objective needs a ``kernel_form``) or raises.  ``line_search`` is
    ``"armijo"`` or ``"dcsrch"``.  The final ``g`` and ``pg_norm`` come
    from the objective's batched value-and-gradient, as in the JAX
    epilogue; ``gcp_multimodal`` is the guard flag (``None`` when
    ``gcp_guard_maxseg`` is 0)."""
    if line_search not in LINE_SEARCHES:
        raise ValueError(f"line_search must be one of {LINE_SEARCHES}, got "
                         f"{line_search!r}")
    kw = dict(m=m, pgtol=pgtol, factr=factr, max_iter=max_iter,
              max_iter_ls=max_iter_ls, c1=c1, bisect_iters=bisect_iters,
              gcp_guard_maxseg=gcp_guard_maxseg, line_search=line_search)
    if x0.device.type == "cpu":
        x, f, it, st, flag = lbfgsb_solve_tall_plain(obj, x0, lower, upper,
                                                     data, **kw)
    elif x0.device.type == "cuda":
        x, f, it, st, flag = _launch_cuda(obj, x0, lower, upper, data, **kw)
    else:
        raise ValueError(f"no L-BFGS-B route for device {x0.device}")
    _, g = batched_value_and_grad(obj, data)(x)
    return SolveResult(x, f, g, it, st,
                       pg_norm=batched_pg_inf_norm(x, g, lower.to(x.dtype),
                                                   upper.to(x.dtype)),
                       gcp_multimodal=(flag > 0) if gcp_guard_maxseg else None)


lbfgsb_solve_fused_tall.launches = 0
# instances per block of the last launch, and its groups of 128 threads
lbfgsb_solve_fused_tall.last_tile = None
lbfgsb_solve_fused_tall.last_groups = None
