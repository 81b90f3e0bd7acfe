"""L-BFGS-B (Byrd, Lu, Nocedal and Zhu), the lockstep solver, and its
configuration.

PyTorch counterpart of ``optimization_solvers_tpu/solvers/lbfgsb.py``: the
same algorithm with the same order of operations, written over ``(B, n)``
batches as :mod:`.driver` writes the template methods, and run by the
driver's :func:`.driver.lockstep_loop` (JAX vmaps one instance's step and
freezes finished lanes with masks; here every merge is a ``where`` on the
``(B,)`` active mask):

* ``B_k = theta I - W M W^T`` with ``W = [Y  theta S]`` and ``M^{-1} =
  [[-D, L^T], [L, theta S^T S]]``; history slots in chronological order
  (newest last) by roll-and-write, invalid slots with zero rows in W and
  unit diagonal entries in ``M^{-1}``;
* the generalized Cauchy point by a chunked breakpoint walk: one stable
  sort of the breakpoints, then ``gcp_chunk`` segments a trip with their
  recurrences as prefix sums (triangular-ones products), the stop test a
  prefix-AND;
* the primal subspace step by Sherman-Morrison-Woodbury with the middle
  matrix of the free set, factored by two small Choleskys
  (:mod:`..ops.smallchol`);
* MINPACK ``dcsrch`` (:class:`..linesearch.dcsrch.StrongWolfe`, bounded),
  whose accepted trial's evaluation is the step's;
* the Fortran failure semantics: a failed search (non-finite evaluation,
  a higher f, a zero step, an iterate that did not move) restores the
  iterate and, with history, restarts from an empty (zeroed) model, or
  else ends ABNORMAL; the curvature gate ``s.y > max(curvature_eps,
  eps(dtype)) y.y``; ``pgtol``, ``factr`` and ``rel_pg_stop``; the
  per-iteration tracer of ``verbose >= 1`` or ``OST_LOG=debug``.

No kernel runs here: every step is PyTorch tensor operations on x0's
device.  The host reads ``any(...)`` once per lockstep iteration, once per
trip of the Cauchy walk and once per ``dcsrch`` trial.

The fused routes (K1 :mod:`..ops.fused_lbfgsb`, K2
:mod:`..ops.fused_lbfgsb_tall`) honour ``m``, ``pgtol``, ``factr``,
``max_iter``, ``max_iter_ls`` and ``ls_c1``, and the tall kernel also
``tall_line_search`` (``"armijo"`` or ``"dcsrch"``; any other value raises
``ValueError``); ``ls_c2``, ``rel_pg_stop``, ``verbose``,
``curvature_eps``, ``gcp_chunk`` and ``lockstep_unroll`` act here.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple

import torch

from ..core.numerics import box_projection, dot, infinity_norm
from ..core.oracle import Oracle, ensure_oracle
from ..core.types import FuncEval, SolveResult, Status
from ..linesearch.base import tree_where
from ..linesearch.dcsrch import StrongWolfe
from ..ops.smallchol import (cholesky_small, spd_solve_small,
                             spd_solve_small_mat)
from ..utils import telemetry
from .driver import as_batch, lockstep_loop


@dataclasses.dataclass(frozen=True)
class LbfgsbConfig:
    """``factr`` is multiplied by machine epsilon (Fortran convention);
    ``m`` defaults to 5, recommended range [3, 20]."""

    m: int = 5
    factr: float = 1e7
    pgtol: float = 1e-5
    rel_pg_stop: bool = False   # reference wrapper rule: pg_inf <= 1e-10 * f
    max_iter: int = 500
    max_iter_ls: int = 20
    ls_c1: float = 1e-3         # Armijo / dcsrch ftol
    ls_c2: float = 0.9          # dcsrch gtol
    curvature_eps: float = 2.2e-16
    verbose: int = -1
    gcp_chunk: int = 256        # lockstep GCP walk chunk
    lockstep_unroll: int = 1    # lockstep iterations per loop trip
    tall_line_search: str = "armijo"   # line search of the tall kernel

    def __post_init__(self):
        if self.tall_line_search not in ("armijo", "dcsrch"):
            raise ValueError(
                "tall_line_search must be 'armijo' or 'dcsrch', got "
                f"{self.tall_line_search!r}")


class _History(NamedTuple):
    S: torch.Tensor      # (B, m, n) correction steps, row m-1 newest
    Y: torch.Tensor      # (B, m, n) gradient differences
    valid: torch.Tensor  # (B, m) bool
    theta: torch.Tensor  # (B,) B0 = theta I scaling


class _Carry(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    hist: _History
    f_prev: torch.Tensor
    k: torch.Tensor
    # the search failed with an empty history: ABNORMAL at the restored
    # iterate (the Fortran's ABNORMAL_TERMINATION_IN_LNSRCH)
    abnormal: torch.Tensor


def _projected_gradient_norm(x, g, lower, upper):
    """``||x - P(x - g)||_inf``, the Fortran's ``sbgnrm``."""
    return infinity_norm(x - box_projection(x - g, lower, upper))


def _t(a):
    return a.transpose(-1, -2)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


class _Mid(NamedTuple):
    """The middle operator ``P = [[-E, G], [G^T, H]]`` factored through the
    SPD Schur complement ``H + G^T E^{-1} G``."""

    Ech: torch.Tensor    # (B, m, m) lower Cholesky factor of E
    G: torch.Tensor      # (B, m, m)
    Sch: torch.Tensor    # (B, m, m) lower Cholesky factor of the complement


def _mid_solve(mid: _Mid, ab):
    """``P z = ab`` by block elimination: ``u = E^{-1}(G v - a)``, ``(H +
    G^T E^{-1} G) v = b + G^T E^{-1} a``."""
    m = mid.G.shape[-1]
    a, b = ab[..., :m], ab[..., m:]
    einv_a = spd_solve_small(mid.Ech, a)
    v = spd_solve_small(mid.Sch, b + _mv(_t(mid.G), einv_a))
    u = spd_solve_small(mid.Ech, _mv(mid.G, v) - a)
    return torch.cat([u, v], dim=-1)


def _grams(hist: _History):
    """The patched curvature diagonal D, the strictly lower L of S Y^T and
    S S^T, computed once per iteration."""
    S, Y, valid, _ = hist
    D = torch.sum(S * Y, dim=-1)
    D = torch.where(valid, D, torch.ones_like(D))
    SY = S @ _t(Y)                     # SY[i, j] = s_i . y_j
    return D, torch.tril(SY, -1), S @ _t(S)


def _unit_invalid(valid, dtype):
    return torch.diag_embed(torch.where(
        valid, torch.zeros((), dtype=dtype, device=valid.device),
        torch.ones((), dtype=dtype, device=valid.device)))


def _middle_factors(hist: _History, free, grams) -> _Mid:
    """The subspace matrix ``MM - W_F^T W_F / theta`` of the free set
    ``free`` ((B, n) bool), factored; invalid slots get unit diagonal
    entries."""
    S, Y, valid, theta = hist
    D, L, SS = grams
    th = theta[:, None, None]
    YF = Y * free[:, None, :]
    SF = S * free[:, None, :]
    E = torch.diag_embed(D) + (YF @ _t(YF)) / th
    G = _t(L) - YF @ _t(SF)
    H = th * (SS - SF @ _t(SF))
    H = H + _unit_invalid(valid, S.dtype)
    Ech = cholesky_small(E)
    EinvG = spd_solve_small_mat(Ech, G)
    return _Mid(Ech, G, cholesky_small(H + _t(G) @ EinvG))


def _middle_inverse(D, Lm, H):
    """The explicit inverse of ``MM = [[-diag(D), Lm^T], [Lm, H]]`` by block
    elimination on the diagonal block: the Schur complement ``H + Lm
    diag(1/D) Lm^T`` is SPD, one small Cholesky."""
    dtype = D.dtype
    m = D.shape[-1]
    D = torch.maximum(D, torch.tensor(torch.finfo(dtype).tiny, dtype=dtype,
                                      device=D.device))
    U = Lm / D[:, None, :]                      # Lm diag(1/D)
    Sc = H + U @ _t(Lm)
    eye = torch.eye(m, dtype=dtype, device=D.device).expand_as(Sc)
    J = spd_solve_small_mat(cholesky_small(Sc), eye)
    JU = J @ U
    TL = _t(U) @ JU - torch.diag_embed(1.0 / D)
    return torch.cat([torch.cat([TL, _t(JU)], dim=-1),
                      torch.cat([JU, J], dim=-1)], dim=-2)


def _build_middle(hist: _History, grams):
    """W as rows ``(B, 2m, n)`` and the dense middle inverse ``M``."""
    S, Y, valid, theta = hist
    Wt = torch.cat([Y, theta[:, None, None] * S], dim=1)
    D, L, SS = grams
    SS = SS + _unit_invalid(valid, S.dtype)
    return Wt, _middle_inverse(D, L, theta[:, None, None] * SS)


def _cauchy_point(x, g, lower, upper, Wt, M, theta, chunk: int = 256,
                  walk=None):
    """Generalized Cauchy point of each instance: ``(xcp, c, free)`` with
    ``c = W^T (xcp - x)``.  The instances outside ``walk`` ((B,) bool)
    take no trip (their results are discarded by the caller).

    The walk retires up to ``chunk`` sorted breakpoints a trip: within a
    chunk, p is a prefix sum of ``g_b w_b``, c a prefix sum of ``dt p`` and
    f1, f2 prefix sums given those (JAX ``lbfgsb.py:239-420``)."""
    B, n = x.shape
    dtype, dev = x.dtype, x.device
    eps = torch.finfo(dtype).tiny
    inf = float("inf")
    two_m = Wt.shape[1]
    zero = torch.zeros((), dtype=dtype, device=dev)

    t_break = torch.where(g < 0.0, (x - upper) / g,
                          torch.where(g > 0.0, (x - lower) / g, inf))
    d0 = torch.where(t_break > 0.0, -g, zero)
    # a stable sort: tied breakpoints keep index order
    keys = torch.where(t_break > 0.0, t_break, inf)
    t_sorted, order = torch.sort(keys, dim=-1, stable=True)

    K = min(chunk, n)
    Lp = ((n + K - 1) // K) * K
    pad = Lp - n
    bound_vec = torch.where(d0 > 0.0, upper, lower)
    z = bound_vec - x
    t_pad = torch.cat([t_sorted, torch.full((B, pad), inf, dtype=dtype,
                                            device=dev)], dim=-1)
    ord_pad = torch.cat([order, order.new_zeros((B, pad))], dim=-1)
    GZW = torch.cat([g[:, None], z[:, None], Wt], dim=1)    # (B, 2m+2, n)
    U_incl = torch.triu(torch.ones((K, K), dtype=dtype, device=dev))
    lanes_k = torch.arange(K, device=dev)

    def seg_min(f1, f2):
        return torch.where(f2 > eps, -f1 / f2,
                           torch.where(f1 < 0.0, inf, zero))

    p0 = _mv(Wt, d0)
    f1_0 = -dot(d0, d0)
    f2_0 = -theta * f1_0 - dot(p0, _mv(M, p0))
    full = (torch.ones((B,), dtype=torch.bool, device=dev) if walk is None
            else walk.clone())
    carry = (torch.zeros((B,), dtype=torch.int64, device=dev),
             torch.zeros((B, two_m), dtype=dtype, device=dev), p0, f1_0,
             f2_0, seg_min(f1_0, f2_0), torch.zeros((B,), dtype=dtype,
                                                    device=dev), full)

    def body(carry, j0):
        cnt, c, p, f1, f2, dt_min, t_old, _ = carry
        t_b = t_pad[:, j0:j0 + K]
        idx = ord_pad[:, j0:j0 + K]
        gzw = torch.gather(GZW, 2, idx[:, None, :].expand(B, two_m + 2, K))
        gb, zb, Wb = gzw[:, 0], gzw[:, 1], gzw[:, 2:]
        finite = torch.isfinite(t_b)
        t_prev = torch.cat([t_old[:, None], t_b[:, :-1]], dim=-1)
        # a non-finite breakpoint is never processed: zero its dt so inf
        # cannot poison the chunk's prefix sums
        dt = torch.where(finite, t_b - t_prev, zero)
        GW = Wb * gb[:, None, :]
        csGW = GW @ U_incl
        Pexc = p[:, :, None] + (csGW - GW)          # p before segment j
        Cj = c[:, :, None] + (Pexc * dt[:, None, :]) @ U_incl
        MCPW = M @ torch.cat([Cj, Pexc, Wb], dim=-1)  # (B, 2m, 3K)
        a = torch.sum(Wb * MCPW[..., :K], dim=1)      # w_j . M c_j
        bq = torch.sum(Wb * MCPW[..., K:2 * K], dim=1)
        e = torch.sum(Wb * MCPW[..., 2 * K:], dim=1)
        th = theta[:, None]
        # masked before the prefix sums: past the finite breakpoints zb
        # may be +-inf (infinite bounds)
        r = torch.where(finite, th * gb * gb + 2.0 * gb * bq + gb * gb * e,
                        zero)
        q = torch.where(finite, gb * gb + th * gb * zb - gb * a, zero)
        cs_r = r @ U_incl
        F2exc = f2[:, None] - (cs_r - r)
        F1inc = f1[:, None] + (dt * F2exc + q) @ U_incl
        F2inc = f2[:, None] - cs_r
        dtm = seg_min(F1inc, F2inc)
        # segment j is processed iff every i <= j passed the walk test
        dtm_prev = torch.cat([dt_min[:, None], dtm[:, :-1]], dim=-1)
        proceed = finite & (dtm_prev >= dt)
        procmask = ((1.0 - proceed.to(dtype)) @ U_incl) < 0.5
        n_proc = torch.sum(procmask, dim=-1)
        oh = lanes_k[None, :] == (n_proc - 1)[:, None]
        some = n_proc > 0

        # mask-then-sum: a +inf at a lane past the stop must not meet a 0
        def sel_vec(arr, default):
            picked = torch.sum(torch.where(oh[:, None, :], arr, zero), dim=-1)
            return torch.where(some[:, None], picked, default)

        def sel(arr, default):
            picked = torch.sum(torch.where(oh, arr, zero), dim=-1)
            return torch.where(some, picked, default)

        return (cnt + n_proc, sel_vec(Cj, c), sel_vec(p[:, :, None] + csGW, p),
                sel(F1inc, f1), sel(F2inc, f2), sel(dtm, dt_min),
                sel(t_b, t_old), n_proc == K)

    j0 = 0
    while j0 < Lp:
        run = carry[-1]
        if not bool(run.any()):
            break
        carry = tree_where(run, body(carry, j0), carry)
        j0 += K
    cnt, c, p, _, _, dt_min, t_old, _ = carry

    # the processed set is the first cnt entries of the sorted order
    rank = torch.arange(n, device=dev).expand(B, n)
    fixed = torch.zeros((B, n), dtype=torch.bool, device=dev).scatter(
        1, order, rank < cnt[:, None])
    d = torch.where(fixed, zero, d0)
    dt_min = torch.maximum(dt_min, zero)
    t_cp = t_old + dt_min
    # p is zero where dt_min is infinite (every moving coordinate is fixed)
    c = c + torch.where(torch.isfinite(dt_min), dt_min, zero)[:, None] * p
    xcp = torch.where(fixed, bound_vec,
                      x + torch.where(d == 0.0, zero, t_cp[:, None] * d))
    free = (t_break > 0.0) & ~fixed
    return xcp, c, free


def _subspace_step(x, g, xcp, c, free, lower, upper, hist, Wt, M, grams):
    """Direct primal subspace minimization with the SMW inverse; returns
    the search point ``xbar`` (free coordinates moved, the step clipped to
    the box)."""
    theta = hist.theta[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    r = g + theta * (xcp - x) - _mv(_t(Wt), _mv(M, c))
    rF = torch.where(free, r, zero)
    WtF = Wt * free[:, None, :]
    mid = _middle_factors(hist, free, grams)
    v = _mid_solve(mid, _mv(WtF, rF))
    dvec = rF / theta + torch.where(free, _mv(_t(Wt), v), zero) / (
        theta * theta)
    du = -dvec
    inf = float("inf")
    steps = torch.where(du > 0.0, (upper - xcp) / du,
                        torch.where(du < 0.0, (lower - xcp) / du, inf))
    steps = torch.where(free, steps, inf)
    steps = torch.where(torch.isnan(steps), inf, steps)
    alpha = torch.clamp(torch.amin(steps, dim=-1), max=1.0)
    # the projection removes the +-1 ulp a coordinate on its bound may
    # carry; an outward step there would collapse the search's bound to -0
    return box_projection(xcp + alpha[:, None] * torch.where(free, du, zero),
                          lower, upper)


def make_lbfgsb_step(oracle, lower: torch.Tensor, upper: torch.Tensor,
                     config: LbfgsbConfig = LbfgsbConfig()):
    """``(init_fn, keep_going_fn, step_fn)`` of the L-BFGS-B loop over a
    ``(B, n)`` batch; one ``step_fn(carry, active=None)`` call is an outer
    iteration of every instance (Cauchy point, subspace step, ``dcsrch``,
    history update).  ``lower``/``upper`` are ``(n,)`` or per-instance
    ``(B, n)``; ``active`` marks the instances whose step will be kept."""
    oracle = ensure_oracle(oracle)
    evaluate = Oracle(oracle.first_order, value_fn=oracle.value)
    cfg = config
    ls = StrongWolfe(c1=cfg.ls_c1, c2=cfg.ls_c2, bounded=True)

    trace_cb = None
    if cfg.verbose >= 1:
        trace_cb = telemetry.iteration_tracer("solver.Lbfgsb", logging.INFO)
    elif telemetry.debug_enabled():
        trace_cb = telemetry.iteration_tracer("solver.Lbfgsb")

    def init_fn(x0: torch.Tensor) -> _Carry:
        B, n = x0.shape
        dtype, dev = x0.dtype, x0.device
        x0 = box_projection(x0, lower, upper)
        ev0 = evaluate(x0)
        hist0 = _History(
            S=torch.zeros((B, cfg.m, n), dtype=dtype, device=dev),
            Y=torch.zeros((B, cfg.m, n), dtype=dtype, device=dev),
            valid=torch.zeros((B, cfg.m), dtype=torch.bool, device=dev),
            theta=torch.ones((B,), dtype=dtype, device=dev))
        return _Carry(x0, ev0.f, ev0.g, hist0,
                      torch.full((B,), math.inf, dtype=dtype, device=dev),
                      torch.zeros((B,), dtype=torch.int32, device=dev),
                      torch.zeros((B,), dtype=torch.bool, device=dev))

    def converged(c: _Carry):
        f_rtol = cfg.factr * torch.finfo(c.f.dtype).eps
        pg = _projected_gradient_norm(c.x, c.g, lower, upper)
        done = pg <= cfg.pgtol
        if cfg.rel_pg_stop:
            # the reference wrapper's rule (lbfgsb.rs:67-72)
            done = done | (pg <= 1e-10 * c.f)
        # relative decrease (Fortran factr); off until a step completed
        fmax = torch.clamp(torch.maximum(torch.abs(c.f), torch.abs(c.f_prev)),
                           min=1.0)
        return done | (torch.isfinite(c.f_prev)
                       & ((c.f_prev - c.f) <= f_rtol * fmax))

    def keep_going_fn(c: _Carry):
        return torch.isfinite(c.f) & ~c.abnormal & ~converged(c)

    def step_fn(c: _Carry, active=None) -> _Carry:
        dtype = c.x.dtype
        hist = c.hist
        grams = _grams(hist)
        Wt, M = _build_middle(hist, grams)
        xcp, cc, free = _cauchy_point(c.x, c.g, lower, upper, Wt, M,
                                      hist.theta, chunk=cfg.gcp_chunk,
                                      walk=active)
        xbar = _subspace_step(c.x, c.g, xcp, cc, free, lower, upper, hist,
                              Wt, M, grams)
        d = xbar - c.x
        t, _, x_new, ev_new = ls.step_len_ev(
            evaluate, c.x, FuncEval(c.f, c.g), d, None, (lower, upper),
            cfg.max_iter_ls, active)
        f_new, g_new = ev_new.f, ev_new.g

        # Fortran mainlb failure semantics (lbfgsb.rs:76-84): a poisoned
        # evaluation, an accepted higher f, a zero step or an iterate that
        # did not move restores the iterate; with history the model
        # restarts, without it the instance ends ABNORMAL
        ok = (torch.isfinite(x_new).all(-1) & torch.isfinite(f_new)
              & torch.isfinite(g_new).all(-1))
        ls_fail = (~ok | (f_new > c.f) | (t <= 0.0)
                   | (x_new == c.x).all(-1))
        has_hist = hist.valid.any(-1)
        restart = ls_fail & has_hist
        abnormal = c.abnormal | (ls_fail & ~has_hist)
        x_new = torch.where(ls_fail[:, None], c.x, x_new)
        f_new = torch.where(ls_fail, c.f, f_new)
        g_new = torch.where(ls_fail[:, None], c.g, g_new)

        s = x_new - c.x
        y = g_new - c.g
        sy = dot(s, y)
        yy = dot(y, y)
        curv_eps = max(cfg.curvature_eps, torch.finfo(dtype).eps)
        accept = ok & (sy > curv_eps * yy)
        acc3 = accept[:, None, None]
        S = torch.where(acc3, torch.cat([hist.S[:, 1:], s[:, None]], 1),
                        hist.S)
        Y = torch.where(acc3, torch.cat([hist.Y[:, 1:], y[:, None]], 1),
                        hist.Y)
        valid = torch.where(accept[:, None], torch.cat(
            [hist.valid[:, 1:], torch.ones_like(hist.valid[:, :1])], 1),
            hist.valid)
        theta = torch.where(accept, yy / sy, hist.theta)
        # a restart ZEROES S and Y: invalid slots stay inert only through
        # zero rows of W
        rs3 = restart[:, None, None]
        zero = torch.zeros((), dtype=dtype, device=c.x.device)
        hist = _History(
            S=torch.where(rs3, zero, S), Y=torch.where(rs3, zero, Y),
            valid=valid & ~restart[:, None],
            theta=torch.where(restart, torch.ones_like(theta), theta))
        # the retry iteration has no stall exit (f did not move)
        f_prev = torch.where(restart, math.inf, c.f)
        if trace_cb is not None:
            trace_cb(c.k + 1, f_new,
                     _projected_gradient_norm(x_new, g_new, lower, upper), t)
        return _Carry(x_new, f_new, g_new, hist, f_prev, c.k + 1, abnormal)

    return init_fn, keep_going_fn, step_fn


def _lbfgsb_result(final: _Carry, cfg: LbfgsbConfig, lower,
                   upper) -> SolveResult:
    """ABNORMAL first (the Fortran task string wins over the budget), then
    the budget, then the domain, then CONVERGED."""
    status = torch.where(
        final.abnormal, int(Status.ABNORMAL),
        torch.where(final.k >= cfg.max_iter, int(Status.MAX_ITER_REACHED),
                    torch.where(~torch.isfinite(final.f),
                                int(Status.OUT_OF_DOMAIN),
                                int(Status.CONVERGED)))).to(torch.int32)
    return SolveResult(
        final.x, final.f, final.g, final.k, status,
        pg_norm=_projected_gradient_norm(final.x, final.g, lower, upper))


def _bounds_like(x0, lower, upper):
    return tuple(torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                 for b in (lower, upper))


def lbfgsb_batch_minimize(oracle, x0, lower, upper,
                          config: LbfgsbConfig = LbfgsbConfig()
                          ) -> SolveResult:
    """Lockstep batched L-BFGS-B over ``x0`` ``(B, n)``: one loop whose
    step advances every open instance, finished instances frozen bit for
    bit.  ``lower``/``upper`` are ``(n,)`` shared or ``(B, n)`` per
    instance (JAX's front end vmaps the single solver for those; each
    instance's numbers are the same)."""
    x0 = as_batch(x0)
    if x0.dim() != 2:
        raise ValueError(f"x0 must be (B, n), got {tuple(x0.shape)}")
    lower, upper = _bounds_like(x0, lower, upper)
    cfg = config
    init_fn, keep_going_fn, step_fn = make_lbfgsb_step(oracle, lower, upper,
                                                       cfg)
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, cfg.max_iter,
                          unroll=cfg.lockstep_unroll)
    return _lbfgsb_result(final, cfg, lower, upper)


def lbfgsb_minimize(oracle, x0, lower, upper,
                    config: LbfgsbConfig = LbfgsbConfig()) -> SolveResult:
    """L-BFGS-B on one instance ``x0`` ``(n,)``: a batch of one through
    :func:`lbfgsb_batch_minimize`, the result without a batch axis (JAX
    vmaps this function over a batch; here that is
    :func:`lbfgsb_batch_minimize`)."""
    x0 = as_batch(x0)
    if x0.dim() != 1:
        raise ValueError(f"x0 must be (n,), got {tuple(x0.shape)}; a batch "
                         "goes to lbfgsb_batch_minimize")
    lower, upper = _bounds_like(x0, lower, upper)
    r = lbfgsb_batch_minimize(oracle, x0[None], lower, upper, config)
    return SolveResult(*(None if v is None else v[0] for v in r))


def lbfgsb_minimize_scaled(oracle, x0, lower, upper, diag,
                           config: LbfgsbConfig = LbfgsbConfig()
                           ) -> SolveResult:
    """Diagonally scaled L-BFGS-B: ``B0 = theta diag(diag)`` instead of
    ``theta I``, through the change of variables ``z = sqrt(diag) x`` (boxes
    map to boxes, ``g_z = g_x / sqrt(diag)``).  On a quadratic with Hessian
    H, ``diag = diagonal(H)`` is Jacobi preconditioning.  ``pgtol``,
    ``factr`` and the returned ``pg_norm`` are in the scaled metric; x and g
    come back in the original coordinates.  ``diag`` must be positive.
    ``x0`` is one instance ``(n,)``, as in JAX."""
    base = ensure_oracle(oracle)
    x0 = as_batch(x0)
    s = torch.sqrt(torch.as_tensor(diag, dtype=x0.dtype, device=x0.device))
    lower, upper = _bounds_like(x0, lower, upper)

    def full(z):
        ev = base(z / s)
        return FuncEval(ev.f, ev.g / s)

    def value(z):
        return base.value(z / s)

    r = lbfgsb_minimize(Oracle(full, value), x0 * s, lower * s, upper * s,
                        config)
    return SolveResult(r.x / s, r.f, r.g * s, r.iterations, r.status,
                       pg_norm=r.pg_norm)
