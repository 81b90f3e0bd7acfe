"""Whole batched box-constrained SPG solves: one CUDA kernel (K8) on the
GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_spg.py``
(``spg_solve_fused``, kernel body ``_make_kernel``, ``pl.pallas_call`` at
:195), the reference SPG of Birgin, Martinez and Raydan without the
``policy`` overlays of K3's SPG spec.  Both versions here run its
algorithm, instance by instance:

* x0 is clipped into the box; ``lam0 = clip(1 / ||P(x0 - g0) - x0||_inf,
  lam_min, lam_max)`` (a zero projected step gives ``lam_max``);
* the direction is the projected BB step ``d = P(x - lam g) - x``;
* the GLL non-monotone Armijo search: a history of the last ``gll_m``
  values, starting at ``-inf``, takes f every iteration (the oldest value
  drops out), and its max is the Armijo reference; trials are value-only,
  t halves from 1 up to ``max_iter_ls`` times, a non-finite trial counts
  as a rejection and the last halved step is taken all the same;
* the safeguarded BB scalar: ``lam_max`` where ``s.y <= 0``, else
  ``clip(s.s / s.y, lam_min, lam_max)``;
* stop on the projected step ``||x - P(x - g)||_inf < tol``; a non-finite
  f ends an instance ``OUT_OF_DOMAIN``.

The bounds are shared ``(n,)`` and may be infinite.
:func:`spg_solve_fused` takes the plain version for a CPU ``x0`` and
launches ``csrc/spg_fused.cu`` for a CUDA ``x0``; it never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult
from .batched_oracle import batched_value, batched_value_and_grad
from .fused_lbfgs import (SMEM_PER_BLOCK, armijo_steps, as_device_batch,
                          check_launch, exit_status, kernel_call_operands)

# the functors csrc/spg_fused.cu compiles (config 3's objective is
# WEIGHTED_SQUARES)
K8_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES")
KERNEL = "the CUDA SPG kernel K8"


def smem_per_instance(n: int, gll_m: int, itemsize: int) -> int:
    """Shared memory one instance takes in the CUDA kernel (``work_elems``
    of ``csrc/spg_fused.cu``): x, g, d, the trial point, the new gradient,
    the two bounds and the GLL history."""
    return (7 * n + gll_m) * itemsize


def kernel_info(dtype, B, n, gll_m=10):
    """The CUDA kernel's launch for a ``(B, n)`` batch of ``dtype`` with a
    GLL history of ``gll_m`` (the weighted-squares functor's kernel, in the
    layout n takes) and its compiled resources: warps per block, resident
    blocks and warps per SM (the card's occupancy calculator), registers
    and local (spill) bytes per thread, dynamic shared memory per block,
    and the coordinates a lane holds in registers (0: the shared-memory
    layout)."""
    from . import _build

    out = (ctypes.c_int * 6)()
    rc = _build.load().spg_fused_info(
        1 if dtype == torch.float64 else 0, B, n, gll_m, out)
    if rc != 0:
        raise RuntimeError(f"spg_fused_info failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    wpb, blocks, regs, local, smem, lanes = list(out)
    return dict(warps_per_block=wpb, blocks_per_sm=blocks,
                warps_per_sm=wpb * blocks, registers=regs, local_bytes=local,
                smem_per_block=smem, lane_coordinates=lanes)


def spg_solve_plain(obj, x0, lower, upper, data=(), *, tol=1e-5,
                    lam_min=1e-3, lam_max=1e3, gll_m=10, c1=1e-4,
                    max_iter=1000, max_iter_ls=24, nfev=None, ties=None):
    """Plain batched PyTorch SPG + GLL, the algorithm of the CUDA kernel.
    ``lower``/``upper`` are ``(n,)``.  Returns ``(x, f, iterations,
    status)``; the caller adds the epilogue.  Each instance's trials (the
    kernel's count) are added to the int32 (B,) tensor ``nfev`` where one
    is given.  ``ties``, where given, is filled as
    ``fused_driver.fused_minimize_plain``'s is: the iterations completed
    before the first GLL test that the order of a sum could flip."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    lo = lower.to(dt)
    up = upper.to(dt)
    bvg = batched_value_and_grad(obj, data)
    bval = batched_value(obj, data)

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    def clip_scalar(v):
        return torch.clamp(v, lam_min, lam_max)

    X = clip(x0)
    Fv, G = bvg(X)
    d0 = clip(X - G) - X
    lam = clip_scalar(1.0 / torch.amax(torch.abs(d0), dim=-1))
    fhist = torch.full((B, gll_m), -float("inf"), dtype=dt, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    def converged():
        return torch.amax(torch.abs(X - clip(X - G)), dim=-1) < tol

    active = torch.isfinite(Fv) & ~converged()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        d = clip(X - lam[:, None] * G) - X
        fhist = torch.cat([fhist[:, 1:], Fv[:, None]], dim=1)
        f_max = torch.amax(fhist, dim=-1)
        g0d = torch.sum(G * d, dim=-1)
        t = armijo_steps(bval, X, d, f_max, g0d, active, c1, max_iter_ls,
                         nfev, ties, iters)
        X_new = X + t[:, None] * d
        f_new, g_new = bvg(X_new)

        s = X_new - X
        y = g_new - G
        sy = torch.sum(s * y, dim=-1)
        ss = torch.sum(s * s, dim=-1)
        lam_new = torch.where(sy <= 0.0, lam_max, clip_scalar(ss / sy))
        lam = torch.where(active, lam_new, lam)

        X = torch.where(active[:, None], X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(active[:, None], g_new, G)
        iters = iters + active.to(torch.int32)
        active = torch.isfinite(Fv) & ~converged()
    return X, Fv, iters, exit_status(converged(), Fv)


def _launch_cuda(obj, x0, lower, upper, data, *, tol, lam_min, lam_max,
                 gll_m, c1, max_iter, max_iter_ls):
    """Check the operands, launch ``csrc/spg_fused.cu`` on the current
    stream and return ``(x, f, iterations, status, trials)``."""
    from . import _build

    B, n = x0.shape
    if gll_m < 1:
        raise ValueError(f"gll_m must be at least 1, got {gll_m}")
    bounds = []
    for name, v in (("lower", lower), ("upper", upper)):
        if v.device != x0.device:
            raise ValueError(f"{name} lies on {v.device}, x0 on {x0.device}")
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
        bounds.append(v.to(x0.dtype).contiguous())
    lo, up = bounds
    code, _arrays, (d0, d1), outs = kernel_call_operands(
        obj, data, x0, KERNEL, K8_OBJECTIVES)
    lib = _build.load()
    per_warp = lib.spg_fused_smem_per_warp(n, gll_m, x0.element_size())
    if per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"n={n}, gll_m={gll_m} needs {per_warp} bytes of shared memory "
            f"per instance in {KERNEL}, more than a block's {SMEM_PER_BLOCK}")
    x0 = x0.contiguous()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.spg_fused_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
            lo.data_ptr(), up.data_ptr(), d0, d1, B, n, float(tol),
            float(lam_min), float(lam_max), int(gll_m), float(c1),
            int(max_iter), int(max_iter_ls), *(t.data_ptr() for t in outs),
            ctypes.c_void_p(stream))
    check_launch(rc, "spg_fused_launch")
    spg_solve_fused.launches += 1
    return outs


def spg_solve_fused(f, x0, lower, upper, data=(), *, tol=1e-5, lam_min=1e-3,
                    lam_max=1e3, gll_m=10, c1=1e-4, max_iter=1000,
                    max_iter_ls=24):
    """Batched box-constrained SPG solves, one instance per CUDA warp.

    ``x0`` is ``(B, n)`` (any B); ``lower``/``upper`` are ``(n,)``, shared
    by every instance, and may hold infinities; ``data`` is the objective's
    problem data.  A CPU ``x0`` runs :func:`spg_solve_plain`; a CUDA ``x0``
    (or a non-tensor one, which goes to the card) launches the kernel (the
    objective needs a ``ROSENBROCK`` or ``WEIGHTED_SQUARES`` kernel form) or
    raises.  The final ``g`` comes from the objective's batched
    value-and-gradient and ``pg_norm`` is the box's, as in the JAX
    epilogue."""
    x0 = as_device_batch(x0)
    lower, upper = (torch.as_tensor(v, dtype=x0.dtype, device=x0.device)
                    for v in (lower, upper))
    kw = dict(tol=tol, lam_min=lam_min, lam_max=lam_max, gll_m=gll_m, c1=c1,
              max_iter=max_iter, max_iter_ls=max_iter_ls)
    if x0.device.type == "cpu":
        x, fv, it, st = spg_solve_plain(f, x0, lower, upper, data, **kw)
    elif x0.device.type == "cuda":
        x, fv, it, st, _ = _launch_cuda(f, x0, lower, upper, data, **kw)
    else:
        raise ValueError(f"no SPG route for device {x0.device}")
    _, g = batched_value_and_grad(f, data)(x)
    return SolveResult(x, fv, g, it, st,
                       pg_norm=batched_pg_inf_norm(x, g, lower, upper))


spg_solve_fused.launches = 0
