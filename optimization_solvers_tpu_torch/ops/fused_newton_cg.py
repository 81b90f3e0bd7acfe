"""The Newton-CG kernel K4: batched box-constrained truncated Newton-CG
whole solves, one CUDA kernel on the GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_newton_cg.py``
(``newton_cg_solve_fused``, kernel body ``_make_kernel``).  Both versions
here run the TPU kernel's algorithm (``pallas_newton_cg.py:70-267``):

* outer loop: stop where the projection-arc residual ``max_i |x_i -
  P(x - g)_i|`` is at most ``pgtol``, or where f fell by at most
  ``factr * eps (max(|f|, |f_prev|, 1))`` on the last accepted step
  (``eps = finfo(dtype).eps``: 1.1920929e-7 and 2.220446e-16, not K3's
  literals);
* two-metric projection: coordinates within ``w = min(pg, 1e-2)`` of a
  bound with the gradient pushing outward take ``-g``; the free ones a
  truncated CG solve of ``H d = -g`` on the free subspace, with the
  Steihaug exit on ``p.Hp <= eps p.p`` (falling back to ``-g_F`` before
  the first step), the Eisenstat-Walker forcing ``||r|| <= min(sqrt(||g_F||),
  0.5) ||g_F||`` and ``beta = rr_new / max(rr, eps)``; a zero direction
  falls back to ``-g``;
* projected backtracking Armijo on ``P(x + t d)``: t halves from 1 for up
  to ``max_iter_ls`` trials, accepting ``f_t <= f0 + c1 g.(x_t - x)`` with
  f_t finite; on exhaustion the last, untested halving is taken;
* a step whose value or point is not finite is not taken; ``f_prev``
  advances only on accepted steps;
* status: CONVERGED where the final state passes the test and f is finite,
  else OUT_OF_DOMAIN where f is not finite, else MAX_ITER_REACHED.

The Hessian-vector products are the objective's analytic ``hvp`` (JAX
traces forward-over-reverse AD into its kernel, so the two round
differently).  :func:`newton_cg_solve_fused` takes the plain version for a
CPU ``x0`` and launches ``csrc/newton_cg.cu`` for a CUDA ``x0``; it never
falls back from one to the other.  The JAX front end's ``newton_cg``
method runs the XLA twin of this algorithm
(``solvers/newton_cg.py:newton_cg_batch_minimize`` there); the port's
``solvers.newton_cg_batch_minimize`` runs this kernel where :func:`takes`
says so, and that twin, its lockstep loop, for every other batch.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult, Status
from .batched_oracle import (KERNEL_OBJECTIVES, batched_hvp, batched_value,
                             batched_value_and_grad, kernel_functor,
                             kernel_operands)

# kSmemPerBlock of csrc/common.cuh, and the functors csrc/newton_cg.cu
# compiles
SMEM_PER_BLOCK = 232448
K4_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC",
                 "LOG_SUM_EXP")
KERNEL = "the CUDA Newton-CG kernel K4"
LOCKSTEP = ("solvers.newton_cg_batch_minimize, which routes such a batch to "
            "the lockstep Newton-CG loop")


def smem_per_instance(n: int, itemsize: int, rows: int = 0) -> int:
    """Shared memory one instance takes in the CUDA kernel's shared-memory
    layout (``InShared`` of ``csrc/newton_cg.cu``): X, G, D, R, P, the
    product Hp (also the trial's gradient), the trial point and the free
    mask, 8 n elements, and the log-sum-exp's z and p, 2 ``rows`` elements
    (``rows`` 0 for the other objectives).  It decides the widest instance
    the kernel takes; the register layout (Rosenbrock and weighted squares
    up to n = 128) takes none."""
    return (8 * n + 2 * rows) * itemsize


def fits(n: int, itemsize: int, rows: int = 0) -> bool:
    """Whether an instance of width ``n`` (and a log-sum-exp's ``rows``)
    fits a block's shared memory."""
    return smem_per_instance(n, itemsize, rows) <= SMEM_PER_BLOCK


def takes(f, consts, x0) -> bool:
    """Whether ``solvers.newton_cg_batch_minimize`` runs this batch on K4
    (the plain version for a CPU ``x0``) rather than on the lockstep loop:
    ``f`` has a functor K4 compiles and one instance fits a block's shared
    memory.  A static decision on shapes, the same on both devices."""
    name, rows = kernel_functor(f, consts)
    return name in K4_OBJECTIVES and fits(x0.shape[-1], x0.element_size(),
                                          rows)


def kernel_info(dtype, B, n):
    """The CUDA kernel's launch for a ``(B, n)`` batch of ``dtype`` (the
    Rosenbrock functor's kernel, in the layout n takes) and its compiled
    resources: warps per block, resident blocks and warps per SM (the
    card's occupancy calculator), registers and local (spill) bytes per
    thread, dynamic shared memory per block."""
    from . import _build

    out = (ctypes.c_int * 5)()
    rc = _build.load().newton_cg_kernel_info(
        1 if dtype == torch.float64 else 0, B, n, out)
    if rc != 0:
        raise RuntimeError(f"newton_cg_kernel_info failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    wpb, blocks, regs, local, smem = list(out)
    return dict(warps_per_block=wpb, blocks_per_sm=blocks,
                warps_per_sm=wpb * blocks, registers=regs, local_bytes=local,
                smem_per_block=smem)


def newton_cg_solve_plain(f, x0, lower, upper, consts=(), *, pgtol=1e-5,
                          factr=1e7, max_iter=200, cg_max=32, max_iter_ls=25,
                          c1=1e-4):
    """K4's algorithm in plain batched PyTorch, on x0's device, every
    instance masked by its own flags as the TPU kernel's lanes are.
    Returns ``(x, f, iterations, status, ncg, nfev)`` without the epilogue:
    ``ncg`` counts each instance's Hessian-vector products, ``nfev`` its
    line-search trials."""
    B, n = x0.shape
    dt = x0.dtype
    dev = x0.device
    consts = tuple(consts)
    bvg = batched_value_and_grad(f, consts)
    bval = batched_value(f, consts)
    bhvp = batched_hvp(f, consts)
    eps = float(torch.finfo(dt).eps)
    f_rtol = factr * eps
    lo, up = lower.to(dt), upper.to(dt)

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    X = clip(x0)
    F, G = bvg(X)
    Fprev = torch.full((B,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    ncg = torch.zeros_like(iters)
    nfev = torch.zeros_like(iters)

    def pg_inf_norm():
        return torch.amax(torch.abs(X - clip(X - G)), dim=-1)

    def converged():
        fmax = torch.maximum(torch.maximum(torch.abs(F), torch.abs(Fprev)),
                             torch.ones_like(F))
        return (pg_inf_norm() <= pgtol) | (
            torch.isfinite(Fprev) & ((Fprev - F) <= f_rtol * fmax))

    def cg_direction(active):
        """``pallas_newton_cg.py:126-202``."""
        g = G
        w = torch.minimum(pg_inf_norm(), torch.full_like(F, 1e-2))[:, None]
        bound_act = ((X - lo <= w) & (g > 0.0)) | ((up - X <= w) & (g < 0.0))
        freem = (~bound_act).to(dt)
        gF = g * freem
        gn2 = dot(gF, gF)
        gn = torch.sqrt(gn2)
        eta = torch.minimum(torch.sqrt(torch.clamp(gn, min=0.0)),
                            torch.full_like(gn, 0.5))
        e = eta * gn
        rtol2 = e * e
        D = torch.zeros_like(X)
        R = gF.clone()
        P = -gF
        rr = gn2
        done = ~active | (gn2 <= rtol2)
        steps = torch.zeros_like(gn)
        for _ in range(cg_max):
            ncg.add_((~done).to(torch.int32))
            q = bhvp(X, P * freem) * freem
            pq = dot(P, q)
            pp = dot(P, P)
            negc = pq <= eps * pp
            first = steps == 0.0
            D = torch.where((~done & negc & first)[:, None], -gF, D)
            newly_done = ~done & negc
            step = ~done & ~negc
            alpha = torch.where(step, rr / torch.where(negc, 1.0, pq), 0.0)
            D = D + alpha[:, None] * P
            R = R + alpha[:, None] * q
            rr_new = dot(R, R)
            hit_tol = step & (rr_new <= rtol2)
            beta = torch.where(step, rr_new / torch.clamp(rr, min=eps), 0.0)
            P = torch.where(step[:, None], -R + beta[:, None] * P, P)
            rr = torch.where(step, rr_new, rr)
            done = done | newly_done | hit_tol
            steps = steps + step.to(dt)
            if bool(done.all()):
                break
        D = torch.where(freem > 0, D, -g)
        return torch.where((dot(D, D) > 0.0)[:, None], D, -g)

    def line_search(active, D):
        """``pallas_newton_cg.py:204-234``."""
        t = torch.ones((B,), dtype=dt, device=dev)
        done = ~active
        for _ in range(max_iter_ls):
            xt = clip(X + t[:, None] * D)
            ft = bval(xt)
            nfev.add_((~done).to(torch.int32))
            ok = (ft <= F + c1 * dot(G, xt - X)) & torch.isfinite(ft)
            keep = done | ok
            t = torch.where(keep, t, t * 0.5)
            done = keep
            if bool(done.all()):
                break
        return t

    for _ in range(max_iter):
        active = torch.isfinite(F) & ~converged()
        if not bool(active.any()):
            break
        D = cg_direction(active)
        t = line_search(active, D)
        X_new = clip(X + t[:, None] * D)
        f_new, g_new = bvg(X_new)
        upd = active & torch.isfinite(f_new) & torch.isfinite(X_new).all(-1)
        Fprev = torch.where(upd, F, Fprev)
        X = torch.where(upd[:, None], X_new, X)
        F = torch.where(upd, f_new, F)
        G = torch.where(upd[:, None], g_new, G)
        iters = iters + active.to(torch.int32)

    finite = torch.isfinite(F)
    status = torch.where(
        converged() & finite, int(Status.CONVERGED),
        torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                    int(Status.MAX_ITER_REACHED)))
    return X, F, iters, status.to(torch.int32), ncg, nfev


def _check_bounds(x0, lower, upper):
    n = x0.shape[-1]
    for name, v in (("lower", lower), ("upper", upper)):
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be a ({n},) tensor, got "
                             f"{getattr(v, 'shape', type(v))}")
        if v.device != x0.device:
            raise ValueError(f"{name} lies on {v.device}, x0 on {x0.device}")


def _launch_cuda(f, x0, lower, upper, consts, *, pgtol, factr, max_iter,
                 cg_max, max_iter_ls, c1):
    """Check the operands, launch ``csrc/newton_cg.cu`` on the current
    stream and return ``(x, f, iterations, status, ncg, nfev)``."""
    from . import _build

    if x0.dim() != 2 or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x0 must be a (B, n) float32/float64 tensor, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    B, n = x0.shape
    code, arrays = kernel_operands(f, consts, x0, kernel=KERNEL,
                                   lockstep=LOCKSTEP)
    name = next(k for k, v in KERNEL_OBJECTIVES.items() if v == code)
    if name not in K4_OBJECTIVES:
        raise NotImplementedError(
            f"{KERNEL} compiles the functors {K4_OBJECTIVES}, not {name}")
    rows = arrays[0].shape[0] if name == "LOG_SUM_EXP" else 0
    if not fits(n, x0.element_size(), rows):
        raise NotImplementedError(
            f"n={n}" + (f" with {rows} rows" if rows else "") + " needs "
            f"{smem_per_instance(n, x0.element_size(), rows)} bytes of "
            f"shared memory per instance in {KERNEL}, more than a block's "
            f"{SMEM_PER_BLOCK}; such a batch runs on the lockstep Newton-CG "
            f"loop ({LOCKSTEP})")
    x0 = x0.contiguous()
    lo, up = (v.to(x0.dtype).contiguous() for v in (lower, upper))
    lib = _build.load()
    x = torch.empty_like(x0)
    fv = torch.empty((B,), dtype=x0.dtype, device=x0.device)
    it, st, ncg, nfev = (torch.empty((B,), dtype=torch.int32,
                                     device=x0.device) for _ in range(4))
    eps = float(torch.finfo(x0.dtype).eps)

    def ptr(i):
        return arrays[i].data_ptr() if len(arrays) > i else None

    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.newton_cg_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
            lo.data_ptr(), up.data_ptr(), ptr(0), ptr(1), rows, B, n,
            float(pgtol), float(factr) * eps, eps, int(max_iter), int(cg_max),
            int(max_iter_ls), float(c1), x.data_ptr(), fv.data_ptr(),
            it.data_ptr(), st.data_ptr(), ncg.data_ptr(), nfev.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"newton_cg_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    newton_cg_solve_fused.launches += 1
    return x, fv, it, st, ncg, nfev


def newton_cg_solve_fused(f, x0, lower, upper, consts=(), *, pgtol=1e-5,
                          factr=1e7, max_iter=200, cg_max=32, max_iter_ls=25,
                          c1=1e-4) -> SolveResult:
    """Batched box-constrained truncated Newton-CG whole solves.

    ``f(x, *consts)`` is the objective (on CUDA an objective of
    :mod:`..core.problems` with a K4 functor: ``rosenbrock``,
    ``weighted_squares``, ``quadratic``, ``log_sum_exp`` and those built on
    them); ``x0`` is
    ``(B, n)``; ``lower``/``upper`` are ``(n,)`` tensors on x0's device
    (``+-inf`` for a free coordinate).  ``cg_max`` bounds the CG steps per
    Newton step, each one Hessian-vector product.  A CPU ``x0`` runs
    :func:`newton_cg_solve_plain`, a CUDA ``x0`` the kernel.  The final
    ``g`` comes from one batched value-and-gradient and ``pg_norm`` is the
    masked-box ``batched_pg_inf_norm``, as in the JAX wrapper's epilogue
    (``pallas_newton_cg.py:378-383``).  The TPU kernel's ``tile``,
    ``interpret`` and ``vmem_limit_bytes`` have no counterpart."""
    _check_bounds(x0, lower, upper)
    consts = tuple(consts)
    kw = dict(pgtol=pgtol, factr=factr, max_iter=max_iter, cg_max=cg_max,
              max_iter_ls=max_iter_ls, c1=c1)
    if x0.device.type == "cpu":
        x, fv, it, st, _, _ = newton_cg_solve_plain(f, x0, lower, upper,
                                                    consts, **kw)
    elif x0.device.type == "cuda":
        x, fv, it, st, _, _ = _launch_cuda(f, x0, lower, upper, consts, **kw)
    else:
        raise ValueError(f"no K4 route for device {x0.device}")
    _, g = batched_value_and_grad(f, consts)(x)
    lo, up = lower.to(x.dtype), upper.to(x.dtype)
    return SolveResult(x, fv, g, it, st,
                       pg_norm=batched_pg_inf_norm(x, g, lo, up))


newton_cg_solve_fused.launches = 0
