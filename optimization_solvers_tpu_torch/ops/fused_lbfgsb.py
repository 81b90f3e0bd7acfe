"""Whole batched L-BFGS-B solves: one CUDA kernel on the GPU, and its plain
PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_lbfgsb.py``
(``lbfgsb_solve_fused``, kernel body ``_make_kernel``).  Both versions here
run the same algorithm, instance by instance:

* the compact Byrd-Lu-Nocedal-Zhu middle matrix kept as its Schur
  factorization, rebuilt each iteration from incrementally kept S.Y / S.S
  Gram tables (history in chronological order, newest last);
* the generalized Cauchy point by a breakpoint walk (iterative
  min-extraction, ties to the lowest coordinate);
* the primal subspace step from the Cauchy point;
* a projected value-only Armijo backtracking search whose first trial is
  capped at the largest feasible step;
* the interior fast path: when no coordinate is pinned, the first Cauchy
  segment's minimizer precedes the first breakpoint and the quasi-Newton
  point lies in the box, the step is the two-loop direction.  The gate is
  decided per instance (the TPU kernel decides it per tile of 128-512);
* Fortran failure semantics: a failed step restores the iterate and
  restarts the history, or ends ABNORMAL with an empty history;
* a body without the gate and the middle matrix when every bound is
  infinite.

:func:`lbfgsb_solve_fused` takes the plain version for a CPU ``x0`` and
launches the CUDA kernel ``csrc/lbfgsb_fused.cu`` for a CUDA ``x0``; it
never falls back from one to the other.  :func:`lbfgsb_solve_fused_scaled`
(JAX ``pallas_lbfgsb.py:993``) is the diagonally scaled solve around the
same algorithm: the change of variables ``z = sqrt(diag) x``, the kernel
evaluating the objective at ``z / sqrt(diag)`` through its ``Scaled<Obj>``
functors (``csrc/objectives.cuh``), the plain version through
:class:`ScaledObjective`.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult, Status
from .batched_oracle import (KERNEL_OBJECTIVES, batched_value,
                             batched_value_and_grad, kernel_operands)

# machine epsilon as the literal the JAX kernel uses: factr, the curvature
# gate and the Cholesky floor agree across JAX, plain and CUDA only with it
EPS_MACH = {torch.float64: 2.2e-16, torch.float32: 1.2e-7}
# kMaxM and kSmemPerBlock of csrc/common.cuh: the largest history the
# reference recommends, and the shared memory a Hopper block may opt into
MAX_M = 20
SMEM_PER_BLOCK = 232448
# the objective functors csrc/lbfgsb_fused.cu compiles: all four, as the
# TPU kernel traces any objective; its scaled form the first two
K1_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC", "LOG_SUM_EXP")
K1_SCALED_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES")


def smem_per_instance(n: int, m: int, itemsize: int, rows: int = 0) -> int:
    """Shared memory one instance takes in the CUDA kernel: ``work_bytes``
    of ``csrc/lbfgsb_fused.cu`` ((2m+5) n + 7 m^2 + 13 m elements, a
    log-sum-exp's z of ``rows`` elements (0 for the other objectives), and
    a bit mask of 32-bit words, 32 per 1,024 coordinates), mirrored here so
    that the route can decide on a machine without the library."""
    return (((2 * m + 5) * n + 7 * m * m + 13 * m + rows) * itemsize
            + 4 * 32 * ((n + 1023) // 1024))


def fits(n: int, m: int, itemsize: int, rows: int = 0) -> bool:
    """Whether an instance of width ``n`` and history ``m`` (and a
    log-sum-exp's ``rows``) fits a block."""
    return smem_per_instance(n, m, itemsize, rows) <= SMEM_PER_BLOCK


def _chol(A, eps):
    """Lower Cholesky factor of a batch of small SPD matrices, each pivot
    floored at ``eps`` before its square root (NaN propagates)."""
    m = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(m):
        d = A[:, j, j] - torch.sum(L[:, j, :j] * L[:, j, :j], dim=-1)
        dj = torch.sqrt(torch.clamp(d, min=eps))
        L[:, j, j] = dj
        if j + 1 < m:
            s = A[:, j + 1:, j] - torch.sum(
                L[:, j + 1:, :j] * L[:, j:j + 1, :j], dim=-1)
            L[:, j + 1:, j] = s / dj[:, None]
    return L


def lbfgsb_solve_plain(obj, x0, lower, upper, data=(), *, m=5, pgtol=1e-5,
                       factr=1e7, max_iter=500, max_iter_ls=20, c1=1e-3):
    """Plain batched PyTorch L-BFGS-B, the same algorithm as the CUDA kernel.

    ``x0`` is ``(B, n)``; ``lower``/``upper`` are ``(n,)`` shared or
    ``(B, n)`` per instance.  Returns ``(x, f, iterations, status)``; the
    caller adds the epilogue."""
    B, n = x0.shape
    dt = x0.dtype
    dev = x0.device
    eps = EPS_MACH[dt]
    f_rtol = factr * eps
    inf = float("inf")
    lo = lower.to(dt)
    up = upper.to(dt)
    unbounded = bool(torch.isneginf(lo).all() and torch.isposinf(up).all())
    bvg = batched_value_and_grad(obj, data)
    bval = batched_value(obj, data)
    lo_b = lo.expand(B, n)
    up_b = up.expand(B, n)

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    X = clip(x0)
    Fv, G = bvg(X)
    Fprev = torch.full((B,), inf, dtype=dt, device=dev)
    S = torch.zeros((B, m, n), dtype=dt, device=dev)
    Y = torch.zeros((B, m, n), dtype=dt, device=dev)
    SY = torch.zeros((B, m, m), dtype=dt, device=dev)
    SS = torch.zeros((B, m, m), dtype=dt, device=dev)
    valid = torch.zeros((B, m), dtype=torch.bool, device=dev)
    theta = torch.ones((B,), dtype=dt, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    abn = torch.zeros((B,), dtype=torch.bool, device=dev)

    def converged():
        pg = torch.amax(torch.abs(X - clip(X - G)), dim=-1)
        fmax = torch.clamp(torch.maximum(torch.abs(Fv), torch.abs(Fprev)),
                           min=1.0)
        return (pg <= pgtol) | (torch.isfinite(Fprev)
                                & ((Fprev - Fv) <= f_rtol * fmax))

    def active_mask():
        return torch.isfinite(Fv) & ~abn & ~converged()

    def breakpoints():
        return torch.where(G < 0.0, (X - up) / G,
                           torch.where(G > 0.0, (X - lo) / G, inf))

    def w_dot(v):
        """W^T v for (B, n) or (B, n, k) v; W = [Y^T, theta S^T]."""
        col = v if v.dim() == 3 else v[..., None]
        out = torch.cat([Y @ col, theta[:, None, None] * (S @ col)], dim=1)
        return out if v.dim() == 3 else out[..., 0]

    def w_apply(c):
        """W c: (B, n) from (B, 2m)."""
        return ((Y.transpose(1, 2) @ c[:, :m, None])[..., 0]
                + (S.transpose(1, 2)
                   @ (c[:, m:] * theta[:, None])[..., None])[..., 0])

    def two_loop(g, Dh):
        """r with x - r the quasi-Newton point (H0 = I / theta)."""
        coef = valid.to(dt) / Dh
        q = g
        alphas = [None] * m
        for j in range(m - 1, -1, -1):
            a = coef[:, j] * torch.sum(S[:, j] * q, dim=-1)
            q = q - a[:, None] * Y[:, j]
            alphas[j] = a
        r = q / theta[:, None]
        for j in range(m):
            b = coef[:, j] * torch.sum(Y[:, j] * r, dim=-1)
            r = r + (alphas[j] - b)[:, None] * S[:, j]
        return r

    def middle():
        """Dh, strictly lower L and the Cholesky factor of the Schur
        complement theta S S^T + L D^-1 L^T (invalid slots patched)."""
        Dh = torch.where(valid, torch.diagonal(SY, dim1=1, dim2=2), 1.0)
        Lc = torch.tril(SY, -1)
        Sch = (theta[:, None, None] * SS
               + (Lc / Dh[:, None, :]) @ Lc.transpose(1, 2))
        diag = torch.diagonal(Sch, dim1=1, dim2=2)
        diag.copy_(torch.where(valid, diag, 1.0))
        return Dh, Lc, _chol(Sch, eps)

    def mid_solve(ab, Dh, Lc, Lsch):
        """M^{-1} applied to (B, 2m) or (B, 2m, k)."""
        col = ab if ab.dim() == 3 else ab[..., None]
        a, b = col[:, :m], col[:, m:]
        rhs = b + Lc @ (a / Dh[..., None])
        v = torch.cholesky_solve(rhs, Lsch)
        u = (-a + Lc.transpose(1, 2) @ v) / Dh[..., None]
        out = torch.cat([u, v], dim=1)
        return out if ab.dim() == 3 else out[..., 0]

    def seg_min(f1, f2):
        return torch.where(f2 > eps, -f1 / f2, torch.where(f1 < 0.0, inf, 0.0))

    def cauchy_point(walk, Dh, Lc, Lsch):
        """Generalized Cauchy point for the lanes in ``walk``; returns the
        free mask, the Cauchy point and c = W^T (xcp - x)."""
        tb = breakpoints()
        d0 = torch.where(tb > 0.0, -G, 0.0)
        tbr = torch.where(tb > 0.0, tb, inf)
        dgc = d0.clone()
        xcp = X.clone()
        fixed = torch.zeros_like(X, dtype=torch.bool)
        p = w_dot(d0)
        c = torch.zeros_like(p)
        Mp = mid_solve(p, Dh, Lc, Lsch)
        f1 = -torch.sum(d0 * d0, dim=-1)
        f2 = -theta * f1 - torch.sum(p * Mp, dim=-1)
        t_old = torch.zeros_like(f1)
        dt_min = seg_min(f1, f2)
        rows = torch.arange(B, device=dev)
        for _ in range(n):
            b_idx = torch.argmin(tbr, dim=-1)
            t_b = tbr[rows, b_idx]
            go = walk & torch.isfinite(t_b) & (dt_min >= t_b - t_old)
            if not bool(go.any()):
                break
            dt_ = torch.where(go, t_b - t_old, 0.0)
            gb = G[rows, b_idx]
            db = dgc[rows, b_idx]
            bound_b = torch.where(db > 0.0, up_b[rows, b_idx],
                                  lo_b[rows, b_idx])
            zb = bound_b - X[rows, b_idx]
            c = c + dt_[:, None] * p
            wb = torch.cat([Y[rows, :, b_idx],
                            theta[:, None] * S[rows, :, b_idx]], dim=1)
            M = mid_solve(torch.stack([c, p, wb], dim=-1), Dh, Lc, Lsch)
            wMc, wMp, wMw = torch.sum(wb[..., None] * M, dim=1).unbind(-1)
            f1n = f1 + dt_ * f2 + gb * gb + theta * gb * zb - gb * wMc
            f2n = f2 - theta * gb * gb - 2.0 * gb * wMp - gb * gb * wMw
            p = p + torch.where(go, gb, 0.0)[:, None] * wb
            gr, gi = rows[go], b_idx[go]
            dgc[gr, gi] = 0.0
            xcp[gr, gi] = bound_b[go]
            fixed[gr, gi] = True
            tbr[gr, gi] = inf
            f1 = torch.where(go, f1n, f1)
            f2 = torch.where(go, f2n, f2)
            t_old = torch.where(go, t_b, t_old)
            dt_min = torch.where(go, seg_min(f1, f2), dt_min)
        dt_min = torch.clamp(dt_min, min=0.0)
        t_cp = t_old + dt_min
        # the model minimizer may lie past every breakpoint (dt_min = inf);
        # the remaining direction is zero there, so skip the inf * 0
        dt_fin = torch.where(torch.isfinite(dt_min), dt_min, 0.0)
        c = c + dt_fin[:, None] * p
        xcp = torch.where(fixed, xcp,
                          X + torch.where(dgc == 0.0, 0.0,
                                          t_cp[:, None] * dgc))
        return (tb > 0.0) & ~fixed, xcp, c

    def subspace(free, xcp, c, Dh, Lc, Lsch):
        """Primal subspace minimization from the Cauchy point; returns the
        projected subspace point."""
        th = theta[:, None]
        Mc = mid_solve(c, Dh, Lc, Lsch)
        r_full = G + th * (xcp - X) - w_apply(Mc)
        rF = torch.where(free, r_full, 0.0)
        fr = free.to(dt)[:, None, :]
        YF, SF, SA = Y * fr, S * fr, S * (1.0 - fr)
        eye = torch.eye(m, dtype=torch.bool, device=dev)
        E = (YF @ YF.transpose(1, 2)) / th[..., None] + torch.diag_embed(Dh)
        H = (theta[:, None, None] * (SA @ SA.transpose(1, 2))
             + (eye & ~valid[:, None, :]).to(dt))
        Gm = Lc.transpose(1, 2) - YF @ SF.transpose(1, 2)
        Ech = _chol(E, eps)
        EinvG = torch.cholesky_solve(Gm, Ech)
        L2 = _chol(H + Gm.transpose(1, 2) @ EinvG, eps)
        u2 = w_dot(rF)
        a, b = u2[:, :m, None], u2[:, m:, None]
        rhs = b + Gm.transpose(1, 2) @ torch.cholesky_solve(a, Ech)
        v = torch.cholesky_solve(rhs, L2)
        u = torch.cholesky_solve(-a + Gm @ v, Ech)
        dvec = rF / th + torch.where(
            free, w_apply(torch.cat([u, v], dim=1)[..., 0]), 0.0) / (th * th)
        du = -dvec
        steps = torch.where(du > 0.0, (up - xcp) / du,
                            torch.where(du < 0.0, (lo - xcp) / du, inf))
        steps = torch.where(free, steps, inf)
        steps = torch.where(torch.isnan(steps), inf, steps)
        alpha = torch.clamp(torch.amin(steps, dim=-1), max=1.0)
        # clip rounding dust: an epsilon-outward step on a coordinate that
        # sits on its bound would collapse the next max feasible step to -0
        return clip(xcp + alpha[:, None] * torch.where(free, du, 0.0))

    def line_search(d, active):
        g0d = torch.sum(G * d, dim=-1)
        if unbounded:
            t = torch.ones_like(Fv)
        else:
            fs = torch.where(d > 0.0, (up - X) / d,
                             torch.where(d < 0.0, (lo - X) / d, inf))
            fs = torch.where(torch.isnan(fs), inf, fs)
            t = torch.clamp(torch.amin(fs, dim=-1), max=1.0)
        done = ~active
        for _ in range(max_iter_ls):
            if bool(done.all()):
                break
            fv_t = bval(X + t[:, None] * d)
            ok = (fv_t <= Fv + c1 * t * g0d) & torch.isfinite(fv_t)
            keep = done | ok
            t = torch.where(keep, t, t * 0.5)
            done = keep
        return t

    active = active_mask()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        if unbounded:
            Dh = torch.where(valid, torch.diagonal(SY, dim1=1, dim2=2), 1.0)
            d = -two_loop(G, Dh)
        else:
            Dh, Lc, Lsch = middle()
            tb = breakpoints()
            blocked = torch.amin(tb, dim=-1) <= 0.0
            t_first = torch.amin(torch.where(tb > 0.0, tb, inf), dim=-1)
            d0 = torch.where(tb > 0.0, -G, 0.0)
            p0 = w_dot(d0)
            pMp = torch.sum(p0 * mid_solve(p0, Dh, Lc, Lsch), dim=-1)
            f1 = -torch.sum(d0 * d0, dim=-1)
            dt0 = seg_min(f1, -theta * f1 - pMp)
            xn = X - two_loop(G, Dh)
            in_box = torch.amin(torch.minimum(xn - lo, up - xn),
                                dim=-1) >= 0.0
            slow = active & ~(~blocked & (dt0 < t_first) & in_box)
            d = clip(xn) - X
            if bool(slow.any()):
                free, xcp, c = cauchy_point(slow, Dh, Lc, Lsch)
                d_slow = subspace(free, xcp, c, Dh, Lc, Lsch) - X
                d = torch.where(slow[:, None], d_slow, d)

        # ---- line search, step and history update
        t = line_search(d, active)
        X_new = X + t[:, None] * d
        f_new, g_new = bvg(X_new)
        ok = (torch.isfinite(f_new) & torch.isfinite(X_new).all(-1)
              & torch.isfinite(g_new).all(-1))
        no_move = (X_new == X).all(-1)
        fail = active & (~ok | (f_new > Fv) | (t <= 0.0) | no_move)
        has_hist = valid.any(-1)
        restart = fail & has_hist
        abn = abn | (fail & ~has_hist)
        keep = ok & ~fail
        X_new = torch.where(keep[:, None], X_new, X)
        f_new = torch.where(keep, f_new, Fv)
        g_new = torch.where(keep[:, None], g_new, G)
        s = X_new - X
        y = g_new - G
        sy = torch.sum(s * y, dim=-1)
        yy = torch.sum(y * y, dim=-1)
        accept = active & ok & (sy > eps * yy)

        acc3 = accept[:, None, None]
        S = torch.where(acc3, torch.cat([S[:, 1:], s[:, None]], 1), S)
        Y = torch.where(acc3, torch.cat([Y[:, 1:], y[:, None]], 1), Y)
        valid = torch.where(accept[:, None], torch.cat(
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

        rs3 = restart[:, None, None]
        S = torch.where(rs3, 0.0, S)
        Y = torch.where(rs3, 0.0, Y)
        SY = torch.where(rs3, 0.0, SY)
        SS = torch.where(rs3, 0.0, SS)
        valid = valid & ~restart[:, None]
        theta = torch.where(restart, 1.0, theta)

        # a restart disables the stall exit for the retry iteration
        Fprev = torch.where(restart, inf, torch.where(active, Fv, Fprev))
        X = torch.where(active[:, None], X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(active[:, None], g_new, G)
        iters = iters + active.to(torch.int32)
        active = active_mask()

    finite = torch.isfinite(Fv)
    status = torch.where(
        abn, int(Status.ABNORMAL),
        torch.where(converged() & finite, int(Status.CONVERGED),
                    torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                                int(Status.MAX_ITER_REACHED))))
    return X, Fv, iters, status.to(torch.int32)


class ScaledObjective:
    """``obj`` at ``z / s`` with the gradient in z, ``g / s``: the plain
    counterpart of the kernel's ``Scaled<Obj>`` functors and of JAX's
    ``fz(z, s, *cs) = f(z / s, *cs)``, whose derivative divides by s.  Its
    batched forms take no data (``data`` is bound here)."""

    def __init__(self, obj, data, s):
        self._vg = batched_value_and_grad(obj, data)
        self._value = batched_value(obj, data)
        self.s = s

    def value(self, Z):
        return self._value(Z / self.s)

    def value_and_grad(self, Z):
        f, g = self._vg(Z / self.s)
        return f, g / self.s


def _launch_cuda(obj, x0, lower, upper, data, *, m, pgtol, factr, max_iter,
                 max_iter_ls, c1, scale=None):
    """Check the operands, launch ``csrc/lbfgsb_fused.cu`` on the current
    stream and return ``(x, f, iterations, status)``.  ``scale`` (the
    scaled form's ``sqrt(diag)``, ``(n,)`` of x0's dtype on x0's device, as
    :func:`lbfgsb_solve_fused_scaled` makes it) launches the scaled kernel,
    with x0 and the bounds already in z."""
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
                                   kernel="the CUDA L-BFGS-B kernel K1")
    name = next(k for k, v in KERNEL_OBJECTIVES.items() if v == code)
    if scale is not None and name not in K1_SCALED_OBJECTIVES:
        raise NotImplementedError(
            f"K1's scaled form compiles the functors {K1_SCALED_OBJECTIVES}, "
            f"not {name}; the plain version takes it on a CPU tensor")
    rows = arrays[0].shape[0] if name == "LOG_SUM_EXP" else 0
    x0 = x0.contiguous()
    lib = _build.load()
    itemsize = x0.element_size()
    per_warp = lib.lbfgsb_fused_smem_per_warp(n, m, itemsize, rows)
    if per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"n={n}, m={m}" + (f", rows={rows}" if rows else "")
            + f" needs {per_warp} bytes of shared memory per instance, more "
            f"than a block's {SMEM_PER_BLOCK}; such a batch is the tall "
            "kernel's (ops.fused_lbfgsb_tall.lbfgsb_solve_fused_tall), and "
            "minimize routes it there")
    unbounded = bool(torch.isneginf(lo).all() and torch.isposinf(up).all())
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype, device=x0.device)
    it = torch.empty((B,), dtype=torch.int32, device=x0.device)
    st = torch.empty((B,), dtype=torch.int32, device=x0.device)
    d0 = arrays[0].data_ptr() if len(arrays) > 0 else None
    d1 = arrays[1].data_ptr() if len(arrays) > 1 else None
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.lbfgsb_fused_launch(
            1 if x0.dtype == torch.float64 else 0, code, int(unbounded),
            x0.data_ptr(), lo.data_ptr(), up.data_ptr(),
            n if lo.dim() == 2 else 0, d0, d1, rows,
            None if scale is None else scale.contiguous().data_ptr(), B, n,
            m,
            float(pgtol), float(factr), int(max_iter), int(max_iter_ls),
            float(c1), x.data_ptr(), f.data_ptr(), it.data_ptr(),
            st.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"lbfgsb_fused_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    if scale is None:
        lbfgsb_solve_fused.launches += 1
    else:
        lbfgsb_solve_fused_scaled.launches += 1
    return x, f, it, st


def kernel_info(dtype, B, n, m, objective="ROSENBROCK", unbounded=False,
                scaled=False, rows=0):
    """The CUDA kernel's launch for a ``(B, n)`` batch of ``dtype`` at
    history ``m`` with the functor ``objective`` (one of ``K1_OBJECTIVES``,
    a log-sum-exp of ``rows`` rows; its ``Scaled<...>`` form if ``scaled``,
    one of ``K1_SCALED_OBJECTIVES``), and its compiled resources:
    warps per block, resident blocks and warps per SM (the card's occupancy
    calculator), registers and local (spill) bytes per thread, dynamic
    shared memory per block."""
    from . import _build

    code = KERNEL_OBJECTIVES[objective]
    out = (ctypes.c_int * 5)()
    rc = _build.load().lbfgsb_fused_kernel_info(
        1 if dtype == torch.float64 else 0, code, int(unbounded),
        int(scaled), B, n, m, int(rows), out)
    if rc != 0:
        raise RuntimeError(f"lbfgsb_fused_kernel_info failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    wpb, blocks, regs, local, smem = list(out)
    return dict(warps_per_block=wpb, blocks_per_sm=blocks,
                warps_per_sm=wpb * blocks, registers=regs, local_bytes=local,
                smem_per_block=smem)


def lbfgsb_solve_fused(obj, x0, lower, upper, data=(), *, m=5, pgtol=1e-5,
                       factr=1e7, max_iter=500, max_iter_ls=20, c1=1e-3):
    """Batched box-constrained solves, one instance per CUDA warp.

    ``x0`` is ``(B, n)``; ``lower``/``upper`` are ``(n,)`` shared or
    ``(B, n)`` per instance; ``data`` is the objective's problem data,
    shared across instances.  A CPU ``x0`` runs :func:`lbfgsb_solve_plain`;
    a CUDA ``x0`` launches the kernel (the objective needs a
    ``kernel_form``) or raises.  The final ``g`` and ``pg_norm`` come from
    the objective's batched value-and-gradient, as in the JAX epilogue."""
    kw = dict(m=m, pgtol=pgtol, factr=factr, max_iter=max_iter,
              max_iter_ls=max_iter_ls, c1=c1)
    if x0.device.type == "cpu":
        x, f, it, st = lbfgsb_solve_plain(obj, x0, lower, upper, data, **kw)
    elif x0.device.type == "cuda":
        x, f, it, st = _launch_cuda(obj, x0, lower, upper, data, **kw)
    else:
        raise ValueError(f"no L-BFGS-B route for device {x0.device}")
    _, g = batched_value_and_grad(obj, data)(x)
    return SolveResult(x, f, g, it, st,
                       pg_norm=batched_pg_inf_norm(x, g, lower.to(x.dtype),
                                                   upper.to(x.dtype)))


lbfgsb_solve_fused.launches = 0


def lbfgsb_solve_fused_scaled(obj, x0, lower, upper, diag, data=(), *, m=5,
                              pgtol=1e-5, factr=1e7, max_iter=500,
                              max_iter_ls=20, c1=1e-3):
    """Diagonally scaled batched solves: ``B0 = theta diag(diag)`` in place
    of ``theta I`` through ``z = s x``, ``s = sqrt(diag)`` (JAX
    ``pallas_lbfgsb.py:993-1046``).  ``diag`` is ``(n,)`` and positive;
    ``lower``/``upper`` are ``(n,)`` or ``(B, n)`` (infinite bounds stay
    infinite); the options are :func:`lbfgsb_solve_fused`'s.  A CPU
    ``x0`` runs :func:`lbfgsb_solve_plain` on :class:`ScaledObjective`; a
    CUDA ``x0`` launches the kernel's scaled form (the objective needs a
    ``ROSENBROCK`` or ``WEIGHTED_SQUARES`` kernel form) or raises.  Returns x and g in the original
    coordinates (``x / s``, ``g * s``), f, and ``pg_norm`` in the scaled
    metric, the one ``pgtol`` and ``factr`` act in."""
    n = x0.shape[-1]
    s = torch.sqrt(torch.as_tensor(diag, dtype=x0.dtype, device=x0.device))
    if tuple(s.shape) != (n,):
        raise ValueError(f"diag must be ({n},), got {tuple(s.shape)}")
    lo = lower.to(x0.dtype) * s
    up = upper.to(x0.dtype) * s
    z0 = x0 * s
    scaled = ScaledObjective(obj, data, s)
    opts = dict(m=m, pgtol=pgtol, factr=factr, max_iter=max_iter,
                max_iter_ls=max_iter_ls, c1=c1)
    if x0.device.type == "cpu":
        z, f, it, st = lbfgsb_solve_plain(scaled, z0, lo, up, (), **opts)
    elif x0.device.type == "cuda":
        z, f, it, st = _launch_cuda(obj, z0, lo, up, data, scale=s, **opts)
    else:
        raise ValueError(f"no L-BFGS-B route for device {x0.device}")
    _, gz = scaled.value_and_grad(z)
    return SolveResult(z / s, f, gz * s, it, st,
                       pg_norm=batched_pg_inf_norm(z, gz, lo, up))


lbfgsb_solve_fused_scaled.launches = 0
