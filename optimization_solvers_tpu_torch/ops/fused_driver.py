"""The generic whole-solve driver K3, first-order form: one CUDA kernel on
the GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_driver.py``
(``fused_minimize``, kernel body ``_make_kernel``) for the method specs GD,
CD, Pnorm, PGD, SPG and NCG and the search specs NoSearch, BackTracking,
BackTrackingB and GLLQuadratic.  The quasi-Newton, L-BFGS and Newton
method specs and the Wolfe-family searches are the next slice (ROADMAP.md
Queue 2 item 3).  Both versions here run the TPU kernel's algorithm:

* x0 is clipped into the box for the bounded methods (PGD, SPG), and so is
  every accepted point;
* each iteration takes a direction, runs the search's trial loop with
  value-only evaluations until a trial is accepted or ``max_iter_ls``
  trials are spent (then the last, untested update of ``t`` is taken), and
  re-evaluates value and gradient at the new point;
* status: CONVERGED where converged and finite, else MAX_ITER_REACHED at
  the budget, else OUT_OF_DOMAIN where f is not finite.

Like the TPU kernel, and unlike the JAX lockstep driver, a lane that
converges exactly at the budget reports CONVERGED, and an out-of-domain
trial shrinks ``t`` within the one trial budget
(``pallas_driver.py:38-43``).

:func:`fused_minimize` takes the plain version for a CPU ``x0`` and
launches ``csrc/driver.cu`` for a CUDA ``x0``; it never falls back from one
to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import linesearch as ls
from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult, Status
# the method configs only; solvers.driver imports this module
from ..solvers import nonlinear_cg, steepest
from .batched_oracle import (KERNEL_OBJECTIVES, batched_value,
                             batched_value_and_grad, kernel_operands)

# method and search codes of csrc/driver.cu
GD, CD, PNORM, PGD, SPG, NCG = range(6)
NOSEARCH, BT, BTB, GLL = range(4)
NCG_VARIANTS = {"fr": 0, "pr+": 1, "hs": 2, "dy": 3}
# kSmemPerBlock of csrc/common.cuh, and the functors csrc/driver.cu compiles
SMEM_PER_BLOCK = 232448
K3_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES")
KERNEL = "the CUDA driver kernel K3"
LOCKSTEP = "ROADMAP.md Queue 1 item 7"


@dataclasses.dataclass(frozen=True, eq=False)
class K3Spec:
    """A (method, line search) pair as K3's integer codes and parameters."""

    method: int
    search: int
    bounded: bool
    tol: float
    lam_min: float = 0.0
    lam_max: float = 0.0
    alternate: bool = False
    ncg_variant: int = 0
    restart_every: int = 0
    pinv: Optional[torch.Tensor] = None
    c1: float = 0.0
    beta: float = 0.5
    ring: int = 0
    sigma1: float = 0.0
    sigma2: float = 0.0


def build_spec(method, line_search) -> Optional[K3Spec]:
    """K3's spec for ``(method, line_search)``, or ``None`` where this slice
    has no fused form: another method or search, PnormDescent without
    ``inverse_p``, or BackTrackingB with an unbounded method (the rule of
    ``pallas_driver.py:1683-1684``)."""
    if isinstance(method, steepest.SpectralProjectedGradient):
        m = dict(method=SPG, lam_min=float(method.lambda_min),
                 lam_max=float(method.lambda_max),
                 alternate=method.bb_variant == "alternate")
    elif isinstance(method, steepest.ProjectedGradientDescent):
        m = dict(method=PGD)
    elif isinstance(method, steepest.GradientDescent):
        m = dict(method=GD)
    elif isinstance(method, steepest.CoordinateDescent):
        m = dict(method=CD)
    elif isinstance(method, steepest.PnormDescent):
        if method.inverse_p is None:
            return None
        m = dict(method=PNORM, pinv=torch.as_tensor(method.inverse_p))
    elif isinstance(method, nonlinear_cg.NonlinearCG):
        m = dict(method=NCG, ncg_variant=NCG_VARIANTS[method.variant],
                 restart_every=int(method.restart_every))
    else:
        return None
    bounded = m["method"] in (PGD, SPG)

    if isinstance(line_search, ls.BackTrackingB):
        if not bounded:
            return None
        s = dict(search=BTB, c1=float(line_search.c1),
                 beta=float(line_search.beta))
    elif isinstance(line_search, ls.BackTracking):
        s = dict(search=BT, c1=float(line_search.c1),
                 beta=float(line_search.beta))
    elif isinstance(line_search, ls.GLLQuadratic):
        s = dict(search=GLL, c1=float(line_search.c1),
                 ring=int(line_search.m), sigma1=float(line_search.sigma1),
                 sigma2=float(line_search.sigma2))
    elif isinstance(line_search, ls.NoSearch):
        s = dict(search=NOSEARCH)
    else:
        return None
    return K3Spec(bounded=bounded, tol=float(method.grad_tol), **m, **s)


def fused_supported(method, line_search) -> bool:
    """True if (method, line_search) has a form in this slice of K3."""
    return build_spec(method, line_search) is not None


def smem_per_instance(n: int, ring: int, itemsize: int) -> int:
    """Shared memory one instance takes in the CUDA kernel: ``work_elems``
    of ``csrc/driver.cu`` (7 n + the GLL history) times the element size,
    mirrored here so that the route can decide without the library."""
    return (7 * n + ring) * itemsize


def fits(n: int, ring: int, itemsize: int) -> bool:
    """Whether an instance of width ``n`` fits a block's shared memory."""
    return smem_per_instance(n, ring, itemsize) <= SMEM_PER_BLOCK


def _check_fits(n, ring, itemsize):
    if not fits(n, ring, itemsize):
        raise NotImplementedError(
            f"n={n} needs {smem_per_instance(n, ring, itemsize)} bytes of "
            f"shared memory per instance in {KERNEL}, more than a block's "
            f"{SMEM_PER_BLOCK}; such a batch waits for the lockstep driver "
            f"({LOCKSTEP})")


def _spec_for(method, line_search) -> K3Spec:
    spec = build_spec(method, line_search)
    if spec is None:
        raise ValueError(
            f"no fused kernel for ({type(method).__name__}, "
            f"{type(line_search).__name__})")
    return spec


def _check_bounds(spec, method, lower, upper):
    if spec.bounded and (lower is None or upper is None):
        raise ValueError(f"{type(method).__name__} requires bounds")


def _sign(v):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    return torch.where(torch.isnan(v), v, torch.sign(v))


def _solve_plain(spec: K3Spec, f, x0, lower, upper, consts, max_iter,
                 max_iter_ls):
    B, n = x0.shape
    dt = x0.dtype
    dev = x0.device
    bvg = batched_value_and_grad(f, consts)
    bval = batched_value(f, consts)
    method, search = spec.method, spec.search
    lo = lower.to(dt) if spec.bounded else None
    up = upper.to(dt) if spec.bounded else None

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    X = clip(x0) if spec.bounded else x0.clone()
    Fv, G = bvg(X)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    nfev = torch.zeros((B,), dtype=torch.int32, device=dev)
    if method == SPG:
        mx = torch.amax(torch.abs(clip(X - G) - X), dim=-1)
        lam = torch.clamp(torch.ones_like(mx) / mx, spec.lam_min,
                          spec.lam_max)
        par = torch.zeros_like(mx)
    if method == NCG:
        Gp, Dp = G.clone(), -G
        ks = torch.zeros((B,), dtype=torch.int32, device=dev)
    if method == PNORM:
        pinv_t = spec.pinv.to(device=dev, dtype=dt).T
    if search == GLL:
        fhist = torch.full((B, spec.ring), float("-inf"), dtype=dt,
                           device=dev)

    def converged():
        pg = G
        if spec.bounded:
            pushing = ((X == lo) & (G > 0.0)) | ((X == up) & (G < 0.0))
            pg = torch.where(pushing, 0.0, G)
        return torch.amax(torch.abs(pg), dim=-1) < spec.tol

    def direction(active):
        nonlocal ks
        if method == CD:
            a = torch.abs(G)
            amax = torch.amax(a, dim=-1, keepdim=True)
            ii = torch.arange(n, device=dev)
            idx = torch.amin(torch.where(a == amax, ii, n), dim=-1,
                             keepdim=True)
            return -_sign(G) * (ii == idx).to(dt)
        if method == PNORM:
            # rounded to float32 first, as the TPU kernel's float32 matmul
            # output (preferred_element_type) is
            return -(G @ pinv_t).to(torch.float32).to(dt)
        if method == PGD:
            return clip(X - G) - X
        if method == SPG:
            return clip(X - lam[:, None] * G) - X
        if method == NCG:
            y = G - Gp
            gg = torch.sum(G * G, dim=-1)
            if spec.ncg_variant == 0:
                beta = gg / torch.sum(Gp * Gp, dim=-1)
            elif spec.ncg_variant == 1:
                beta = torch.maximum(
                    torch.sum(G * y, dim=-1) / torch.sum(Gp * Gp, dim=-1),
                    torch.zeros_like(gg))
            elif spec.ncg_variant == 2:
                beta = torch.sum(G * y, dim=-1) / torch.sum(Dp * y, dim=-1)
            else:
                beta = gg / torch.sum(Dp * y, dim=-1)
            beta = torch.where(torch.isfinite(beta), beta, 0.0)
            period = spec.restart_every if spec.restart_every > 0 else n
            periodic = ks >= period
            d = -G + torch.where(periodic, 0.0, beta)[:, None] * Dp
            descent = torch.sum(G * d, dim=-1) < 0.0
            d = torch.where(descent[:, None], d, -G)
            ks = torch.where(active & (periodic | ~descent), 0, ks)
            return d
        return -G

    def step_length(d, active):
        nonlocal fhist
        t = torch.ones((B,), dtype=dt, device=dev)
        if search == NOSEARCH:
            return t
        g0d = torch.sum(G * d, dim=-1)
        f_ref = Fv
        if search == GLL:
            fhist = torch.cat([fhist[:, 1:], Fv[:, None]], dim=1)
            f_ref = torch.amax(fhist, dim=-1)
        done = ~active
        for _ in range(max_iter_ls):
            if bool(done.all()):
                break
            xt = X + t[:, None] * d
            if search == BTB:
                xt = clip(xt)
            ft = bval(xt)
            nfev.add_((~done).to(torch.int32))
            if search == BTB:
                diff = xt - X
                ok = ft - Fv <= (-spec.c1 / t) * torch.sum(diff * diff, -1)
            else:
                ok = ft - f_ref <= spec.c1 * t * g0d
            keep = done | (ok & torch.isfinite(ft))
            if search == GLL:
                t_half = t * 0.5
                t_tmp = -0.5 * t * t * g0d / (ft - Fv - t * g0d)
                t_quad = torch.where(
                    (t_tmp > spec.sigma1) & (t_tmp < spec.sigma2 * t),
                    t_tmp, t_tmp * 0.5)
                t_next = torch.where(t <= 0.1, t_half, t_quad)
                t_next = torch.where(torch.isfinite(t_next) & (t_next > 0.0),
                                     t_next, t_half)
            else:
                t_next = t * spec.beta
            t = torch.where(keep, t, t_next)
            done = keep
        return t

    active = torch.isfinite(Fv) & ~converged()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        d = direction(active)
        t = step_length(d, active)
        X_new = X + t[:, None] * d
        if spec.bounded:
            X_new = clip(X_new)
        f_new, g_new = bvg(X_new)
        am = active[:, None]
        X_old, G_old = X, G
        X = torch.where(am, X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(am, g_new, G)
        if method == SPG:
            s = X - X_old
            y = G - G_old
            sy = torch.sum(s * y, dim=-1)
            raw = torch.sum(s * s, dim=-1) / sy
            if spec.alternate:
                raw = torch.where(par > 0.5, sy / torch.sum(y * y, dim=-1),
                                  raw)
                par = torch.where(active, 1.0 - par, par)
            lam_new = torch.where(
                sy <= 0.0, spec.lam_max,
                torch.clamp(raw, spec.lam_min, spec.lam_max))
            lam = torch.where(active, lam_new, lam)
        if method == NCG:
            Gp = torch.where(am, G_old, Gp)
            Dp = torch.where(am, d, Dp)
            ks = ks + active.to(torch.int32)
        iters = iters + active.to(torch.int32)
        active = torch.isfinite(Fv) & ~converged()

    finite = torch.isfinite(Fv)
    status = torch.where(
        converged() & finite, int(Status.CONVERGED),
        torch.where(iters >= max_iter, int(Status.MAX_ITER_REACHED),
                    torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                                int(Status.MAX_ITER_REACHED))))
    return X, Fv, iters, status.to(torch.int32), nfev


def fused_minimize_plain(method, line_search, f, x0, lower=None, upper=None,
                         consts=(), *, max_iter=1000, max_iter_ls=32):
    """K3's algorithm in plain batched PyTorch, on x0's device.

    Arguments as :func:`fused_minimize`.  Returns ``(x, f, iterations,
    status, nfev)`` without the epilogue; ``nfev`` counts each instance's
    value-only trial evaluations."""
    spec = _spec_for(method, line_search)
    _check_bounds(spec, method, lower, upper)
    return _solve_plain(spec, f, x0, lower, upper, tuple(consts), max_iter,
                        max_iter_ls)


def _launch_cuda(spec: K3Spec, f, x0, lower, upper, consts, max_iter,
                 max_iter_ls):
    """Check the operands, launch ``csrc/driver.cu`` on the current stream
    and return ``(x, f, iterations, status, nfev)``."""
    from . import _build

    if x0.dim() != 2 or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x0 must be a (B, n) float32/float64 tensor, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    B, n = x0.shape
    lo = up = None
    bstride = 0
    if spec.bounded:
        bounds = []
        for name, v in (("lower", lower), ("upper", upper)):
            if v.device != x0.device:
                raise ValueError(f"{name} lies on {v.device}, x0 on "
                                 f"{x0.device}")
            if tuple(v.shape) not in ((n,), (B, n)):
                raise ValueError(f"{name} must be ({n},) or ({B}, {n}), got "
                                 f"{tuple(v.shape)}")
            bounds.append(v.to(x0.dtype).contiguous())
        lo, up = bounds
        if lo.shape != up.shape:
            raise ValueError("lower and upper must have the same shape")
        bstride = n if lo.dim() == 2 else 0
    code, arrays = kernel_operands(f, consts, x0, kernel=KERNEL,
                                   lockstep=LOCKSTEP)
    name = next(k for k, v in KERNEL_OBJECTIVES.items() if v == code)
    if name not in K3_OBJECTIVES:
        raise NotImplementedError(
            f"{KERNEL} compiles the functors {K3_OBJECTIVES}, not {name}; "
            f"other objectives wait for the lockstep driver ({LOCKSTEP})")
    pinv = None
    if spec.method == PNORM:
        pinv = spec.pinv.to(device=x0.device, dtype=x0.dtype).contiguous()
        if tuple(pinv.shape) != (n, n):
            raise ValueError(f"inverse_p must be ({n}, {n}), got "
                             f"{tuple(pinv.shape)}")
    _check_fits(n, spec.ring, x0.element_size())
    x0 = x0.contiguous()
    lib = _build.load()
    x = torch.empty_like(x0)
    fv = torch.empty((B,), dtype=x0.dtype, device=x0.device)
    it, st, nfev = (torch.empty((B,), dtype=torch.int32, device=x0.device)
                    for _ in range(3))

    def ptr(v):
        return None if v is None else v.data_ptr()

    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.driver_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
            ptr(lo), ptr(up), bstride,
            ptr(arrays[0] if arrays else None),
            ptr(arrays[1] if len(arrays) > 1 else None), ptr(pinv), B, n,
            spec.method, spec.search, spec.tol, spec.lam_min, spec.lam_max,
            int(spec.alternate), spec.ncg_variant, spec.restart_every,
            spec.c1, spec.beta, spec.sigma1, spec.sigma2, spec.ring,
            int(max_iter), int(max_iter_ls), x.data_ptr(), fv.data_ptr(),
            it.data_ptr(), st.data_ptr(), nfev.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"driver_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    fused_minimize.launches += 1
    return x, fv, it, st, nfev


def apply_stall_status(status, method, x, f, g, pg_norm, bounds):
    """Re-label CONVERGED lanes as :data:`Status.STALLED` where the method's
    ``stall_status`` hook says the exit was a stall at a non-KKT point (the
    quasi-Newton family, next slice).  Methods without the hook are
    untouched; only CONVERGED is ever re-labelled."""
    hook = getattr(method, "stall_status", None)
    if hook is None:
        return status
    stall = hook(x, f, g, pg_norm, bounds)
    return torch.where((status == Status.CONVERGED) & stall,
                       int(Status.STALLED), status).to(torch.int32)


def exit_pg_norm(x, g, bounds):
    """Exit-time ``pg_norm``: projected-gradient infinity norm (plain
    ``||g||_inf`` unbounded)."""
    if bounds is None:
        return batched_pg_inf_norm(x, g)
    return batched_pg_inf_norm(x, g, bounds[0], bounds[1])


def solve_spec(spec: K3Spec, method, f, x0, lower, upper, consts, *,
               max_iter, max_iter_ls) -> SolveResult:
    """:func:`fused_minimize` for a spec already built from ``method``:
    the plain version for a CPU ``x0``, the kernel for a CUDA ``x0``, then
    the epilogue of the JAX kernel's wrapper."""
    _check_bounds(spec, method, lower, upper)
    consts = tuple(consts)
    if x0.device.type == "cpu":
        x, fv, it, st, _ = _solve_plain(spec, f, x0, lower, upper, consts,
                                        max_iter, max_iter_ls)
    elif x0.device.type == "cuda":
        x, fv, it, st, _ = _launch_cuda(spec, f, x0, lower, upper, consts,
                                        max_iter, max_iter_ls)
    else:
        raise ValueError(f"no K3 route for device {x0.device}")
    _, g = batched_value_and_grad(f, consts)(x)
    bounds = None if lower is None else (lower.to(x.dtype), upper.to(x.dtype))
    pg = exit_pg_norm(x, g, bounds)
    st = apply_stall_status(st, method, x, fv, g, pg, bounds)
    return SolveResult(x, fv, g, it, st, pg_norm=pg)


def fused_minimize(method, line_search, f, x0, lower=None, upper=None,
                   consts=(), *, max_iter=1000, max_iter_ls=32) -> SolveResult:
    """Batched whole solves of ``(method, line_search)``.

    ``method`` and ``line_search`` are the configs of :mod:`..solvers` and
    :mod:`..linesearch`; ``x0`` is ``(B, n)``; ``lower``/``upper`` are
    ``(n,)`` shared or ``(B, n)`` per instance, needed by the bounded
    methods; ``consts`` is the objective's problem data, ``f(x, *consts)``.
    A CPU ``x0`` runs :func:`fused_minimize_plain`; a CUDA ``x0`` launches
    the kernel (the objective needs a ``kernel_form`` with a K3 functor) or
    raises.  An unsupported combination raises ``ValueError``
    (:func:`fused_supported` tells).  The final ``g`` and ``pg_norm`` come
    from one batched value-and-gradient, as in the JAX epilogue."""
    return solve_spec(_spec_for(method, line_search), method, f, x0, lower,
                      upper, consts, max_iter=max_iter,
                      max_iter_ls=max_iter_ls)


fused_minimize.launches = 0
