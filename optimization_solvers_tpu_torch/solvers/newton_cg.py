"""Truncated Newton-CG: the config, the lockstep solver and the batched
route.

Counterpart of :mod:`optimization_solvers_tpu.solvers.newton_cg`
(``NewtonCGConfig`` with the same fields and defaults,
``make_newton_cg_step``, ``newton_cg_minimize``,
``newton_cg_batch_minimize``).  The JAX package runs this algorithm twice:
as the XLA lockstep loop there and as the fused TPU kernel
``ops/pallas_newton_cg.py``; its own tests hold the two together.  The port
has both too:

* the lockstep loop (:func:`make_newton_cg_step`), the same algorithm with
  the same order of operations written over ``(B, n)`` batches, run by
  :func:`.driver.lockstep_loop`, every inner loop a
  :func:`..linesearch.base.masked_while` (JAX's per-instance
  ``lax.while_loop`` under ``vmap``): the two-metric projection, truncated
  CG on the free subspace with the Eisenstat-Walker forcing term ``min(0.5,
  sqrt(||g_F||)) ||g_F||`` and the Steihaug exit, projected backtracking
  Armijo on ``P(x + t d)`` with the ``g . (P(x + t d) - x)`` model, a step
  taken where its value and point are finite, ``f_prev`` advancing only on
  accepted steps, and the exit labels of the TPU kernel (a lane that
  converges exactly at the budget reports CONVERGED).  No kernel runs
  there: every step is PyTorch tensor operations on x0's device, the
  Hessian-vector products the oracle's ``hvp`` (the objective's analytic
  one, or ``torch.func``'s jvp of the gradient for any other callable).
  The host reads ``any(...)`` once per lockstep iteration, once per CG step
  and once per search trial;
* the Newton-CG kernel K4 (:mod:`..ops.fused_newton_cg`: its plain version
  for a CPU ``x0``, the CUDA kernel for a CUDA ``x0``).

:func:`newton_cg_batch_minimize` takes K4 where K4 compiles the objective's
functor and an instance fits a block's shared memory
(:func:`..ops.fused_newton_cg.takes`, the same rule on both devices), and
the lockstep loop for everything else: a callable without a kernel form, an
oracle without a raw objective, a batch too wide for K4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.numerics import batched_pg_inf_norm, box_projection, dot
from ..core.oracle import ensure_oracle
from ..core.types import SolveResult, Status
from ..linesearch.base import masked_while
from ..ops import fused_newton_cg
from ..ops.fused_newton_cg import newton_cg_solve_fused
from .driver import _as_bounds, as_batch, lockstep_loop


@dataclasses.dataclass(frozen=True)
class NewtonCGConfig:
    pgtol: float = 1e-5
    factr: float = 1e7
    max_iter: int = 200
    cg_max: int = 32
    max_iter_ls: int = 25
    c1: float = 1e-4


class _Carry(NamedTuple):
    x: torch.Tensor        # (B, n)
    f: torch.Tensor        # (B,)
    g: torch.Tensor        # (B, n)
    f_prev: torch.Tensor   # (B,)
    k: torch.Tensor        # (B,) int32


def make_newton_cg_step(oracle, lower, upper,
                        config: NewtonCGConfig = NewtonCGConfig()):
    """``(init_fn, keep_going_fn, step_fn, result_fn)`` of the Newton-CG
    loop over a ``(B, n)`` batch (the :func:`.driver.make_step` shape plus a
    result finalizer), ``lower``/``upper`` ``(n,)`` shared by the batch.
    ``step_fn(carry, active=None)``: ``active`` lets the inner loops start
    the instances whose step will be discarded done.  An oracle without
    ``hvp`` raises ``ValueError``, as in JAX."""
    oracle = ensure_oracle(oracle)
    hvp = getattr(oracle, "hvp", None)
    if hvp is None:
        raise ValueError(
            "Newton-CG needs Hessian-vector products: build the oracle "
            "with make_oracle(f) (which derives hvp by forward-over-"
            "reverse AD) or attach an `hvp(x, v)` callable to the oracle")
    cfg = config

    def clip(v):
        return box_projection(v, lower, upper)

    def pg_inf_norm(x, g):
        return torch.amax(torch.abs(x - clip(x - g)), dim=-1)

    def init_fn(x0: torch.Tensor) -> _Carry:
        x0 = clip(x0)
        ev = oracle.first_order(x0)
        B = x0.shape[0]
        return _Carry(x0, ev.f, ev.g,
                      torch.full((B,), math.inf, dtype=ev.f.dtype,
                                 device=x0.device),
                      torch.zeros((B,), dtype=torch.int32, device=x0.device))

    def converged(c: _Carry):
        f_rtol = cfg.factr * torch.finfo(c.f.dtype).eps
        done = pg_inf_norm(c.x, c.g) <= cfg.pgtol
        fmax = torch.maximum(torch.maximum(torch.abs(c.f), torch.abs(c.f_prev)),
                             torch.ones_like(c.f))
        return done | (torch.isfinite(c.f_prev)
                       & ((c.f_prev - c.f) <= f_rtol * fmax))

    def keep_going_fn(c: _Carry):
        return torch.isfinite(c.f) & ~converged(c)

    def _direction(x, g, active):
        eps = float(torch.finfo(x.dtype).eps)
        pgn = pg_inf_norm(x, g)
        # epsilon-active bound coordinates (two-metric projection)
        w = torch.minimum(pgn, torch.full_like(pgn, 1e-2))[:, None]
        bound_act = ((x - lower <= w) & (g > 0.0)) | (
            (upper - x <= w) & (g < 0.0))
        free = ~bound_act
        zero = torch.zeros((), dtype=x.dtype, device=x.device)

        gF = torch.where(free, g, zero)
        gn2 = dot(gF, gF)
        gn = torch.sqrt(gn2)
        eta = torch.minimum(torch.sqrt(torch.clamp(gn, min=0.0)),
                            torch.full_like(gn, 0.5))
        rtol2 = (eta * gn) ** 2

        def cond(s):
            i, d, r, p, rr, done, steps = s
            return (i < cfg.cg_max) & ~done

        def body(s):
            i, d, r, p, rr, done, steps = s
            q = torch.where(free, hvp(x, torch.where(free, p, zero)), zero)
            pq = dot(p, q)
            pp = dot(p, p)
            negc = pq <= eps * pp
            first = steps == 0
            d = torch.where((negc & first)[:, None], -gF, d)
            step_ok = ~negc
            alpha = torch.where(step_ok, rr / torch.where(negc, 1.0, pq), 0.0)
            d = d + alpha[:, None] * p
            r = r + alpha[:, None] * q
            rr_new = dot(r, r)
            hit_tol = step_ok & (rr_new <= rtol2)
            beta = torch.where(step_ok,
                               rr_new / torch.clamp(rr, min=eps), 0.0)
            p = torch.where(step_ok[:, None], -r + beta[:, None] * p, p)
            rr = torch.where(step_ok, rr_new, rr)
            done = negc | hit_tol
            return (i + 1, d, r, p, rr, done, steps + step_ok.to(torch.int32))

        i0 = torch.zeros_like(pgn, dtype=torch.int32)
        done0 = gn2 <= rtol2
        if active is not None:
            done0 = done0 | ~active
        _, d, _, _, _, _, _ = masked_while(
            cond, body, (i0, torch.zeros_like(x), gF, -gF, gn2, done0, i0))

        # epsilon-active coordinates move along -g; zero-direction
        # safeguard falls back to the full negative gradient
        d = torch.where(free, d, -g)
        return torch.where((dot(d, d) > 0.0)[:, None], d, -g)

    def _line_search(x, f0, g, d, active):
        def cond(s):
            i, t, done = s
            return (i < cfg.max_iter_ls) & ~done

        def body(s):
            i, t, done = s
            xt = clip(x + t[:, None] * d)
            ft = oracle.value(xt)
            gstep = dot(g, xt - x)
            ok = (ft <= f0 + cfg.c1 * gstep) & torch.isfinite(ft)
            return (i + 1, torch.where(ok, t, t * 0.5), ok)

        B = x.shape[0]
        done0 = (torch.zeros((B,), dtype=torch.bool, device=x.device)
                 if active is None else ~active)
        _, t, _ = masked_while(cond, body, (
            torch.zeros((B,), dtype=torch.int32, device=x.device),
            torch.ones((B,), dtype=x.dtype, device=x.device), done0))
        return t

    def step_fn(c: _Carry, active=None) -> _Carry:
        d = _direction(c.x, c.g, active)
        t = _line_search(c.x, c.f, c.g, d, active)
        x_new = clip(c.x + t[:, None] * d)
        ev = oracle.first_order(x_new)
        ok = torch.isfinite(ev.f) & torch.isfinite(x_new).all(-1)
        # f_prev advances only on ACCEPTED steps (the fused kernel's
        # ``Fprev = where(upd, Fv, Fprev)``)
        return _Carry(torch.where(ok[:, None], x_new, c.x),
                      torch.where(ok, ev.f, c.f),
                      torch.where(ok[:, None], ev.g, c.g),
                      torch.where(ok, c.f, c.f_prev), c.k + 1)

    def result_fn(final: _Carry) -> SolveResult:
        # the fused kernel's exit semantics: convergence recomputed on the
        # final state, so a lane that lands converged exactly at the budget
        # reports CONVERGED
        finite = torch.isfinite(final.f)
        status = torch.where(
            converged(final) & finite, int(Status.CONVERGED),
            torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                        int(Status.MAX_ITER_REACHED))).to(torch.int32)
        pg = batched_pg_inf_norm(final.x, final.g, lower, upper)
        return SolveResult(final.x, final.f, final.g, final.k, status,
                           pg_norm=pg)

    return init_fn, keep_going_fn, step_fn, result_fn


def _lockstep(oracle, x0, lower, upper, cfg) -> SolveResult:
    init_fn, keep_going_fn, step_fn, result_fn = make_newton_cg_step(
        oracle, lower, upper, cfg)
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, cfg.max_iter)
    return result_fn(final)


def newton_cg_batch_minimize(oracle, x0, lower, upper,
                             config: NewtonCGConfig = NewtonCGConfig()
                             ) -> SolveResult:
    """Batched box-constrained Newton-CG from ``x0`` (B, n) in the box
    ``[lower, upper]`` (each ``(n,)``; ``+-inf`` for a free coordinate).

    K4 takes the batch where it compiles the objective's functor and an
    instance fits (``oracle`` from :func:`..core.oracle.make_oracle`, which
    keeps the raw objective and its data for the kernel); the lockstep loop
    takes every other batch, on x0's device.  A non-tensor ``x0`` goes to
    the GPU."""
    x0 = as_batch(x0)
    if x0.dim() != 2:
        raise ValueError(f"x0 must be (B, n), got {tuple(x0.shape)}")
    lower, upper = _as_bounds((lower, upper), x0)
    raw_f = getattr(oracle, "raw_f", None)
    data = getattr(oracle, "data", ())
    if raw_f is None or not fused_newton_cg.takes(raw_f, data, x0):
        return _lockstep(oracle, x0, lower, upper, config)
    consts = tuple(torch.as_tensor(c, device=x0.device) for c in data)
    return newton_cg_solve_fused(raw_f, x0, lower, upper, consts,
                                 **dataclasses.asdict(config))


def newton_cg_minimize(oracle, x0, lower, upper,
                       config: NewtonCGConfig = NewtonCGConfig()
                       ) -> SolveResult:
    """Box-constrained truncated Newton-CG on one instance ``x0`` ``(n,)``:
    the lockstep loop on a batch of one, the result without a batch axis
    (JAX runs this function's ``lax.while_loop``; the iterates are the
    same).  Matrix-free: scales to large ``n``."""
    x0 = as_batch(x0)
    if x0.dim() != 1:
        raise ValueError(f"x0 must be (n,), got {tuple(x0.shape)}; a batch "
                         "goes to newton_cg_batch_minimize")
    lower, upper = _as_bounds((lower, upper), x0)
    r = _lockstep(oracle, x0[None], lower, upper, config)
    return SolveResult(*(None if v is None else v[0] for v in r))
