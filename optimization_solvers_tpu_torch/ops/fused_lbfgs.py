"""Whole batched unconstrained L-BFGS solves: one CUDA kernel (K7) on the
GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_lbfgs.py``
(``lbfgs_solve_fused``, kernel body ``_make_kernel``, ``pl.pallas_call`` at
:312).  Both versions here run its algorithm, instance by instance:

* the two-loop recursion over a ring of ``m`` (s, y) slots, newest to
  oldest then oldest to newest over ``(head - 1 - j) % m``, an invalid slot
  contributing 0; ``gamma`` starts at 1 and changes only on an accepted
  pair;
* a value-only Armijo search from ``t = 1``, halving up to
  ``max_iter_ls`` times; a non-finite trial counts as a rejection, and
  after ``max_iter_ls`` rejections the step ``0.5**max_iter_ls`` is taken
  all the same;
* one value-and-gradient at the new point; the pair is accepted where
  ``s.y > eps y.y`` (``eps`` the JAX kernel's literal, 1.2e-7 in float32
  and 2.2e-16 in float64);
* the ring slot is the instance's own iteration count mod ``m``, and a
  rejected pair writes a zeroed, invalid slot, so the instance loses its
  oldest pair.  The JAX kernel's head is a tile-wide counter; it equals
  the own count because an instance is active from its first iteration
  until it stops and never again (x and g freeze once it stops);
* stop on ``max|g| < tol``; a non-finite f ends an instance
  ``OUT_OF_DOMAIN``.

:func:`lbfgs_solve_fused` takes the plain version for a CPU ``x0`` and
launches ``csrc/lbfgs_fused.cu`` for a CUDA ``x0``; it never falls back
from one to the other.  The helpers of the whole-solve kernels K8
(:mod:`.fused_spg`) and K9 (:mod:`.fused_bfgs`) live here too, as the JAX
kernels share ``pallas_lbfgs``'s.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult, Status
from .batched_oracle import (KERNEL_OBJECTIVES, batched_value,
                             batched_value_and_grad, kernel_operands)
from .fused_lbfgsb import EPS_MACH, MAX_M, SMEM_PER_BLOCK

# the functors csrc/lbfgs_fused.cu and csrc/bfgs_fused.cu compile
K7_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC")
KERNEL = "the CUDA L-BFGS kernel K7"


def smem_per_instance(n: int, m: int, itemsize: int) -> int:
    """Shared memory one instance takes in the CUDA kernel (``work_elems``
    of ``csrc/lbfgs_fused.cu``): x, g, d, the trial point and the new
    gradient, the S and Y rings, the tables S^T Y and Y^T Y (m x m each),
    and S^T g, Y^T g, u, p and valid by slot."""
    return ((2 * m + 5) * n + 2 * m * m + 5 * m) * itemsize


def fits(n: int, m: int, itemsize: int) -> bool:
    """Whether an instance of width ``n`` and history ``m`` fits a block."""
    return smem_per_instance(n, m, itemsize) <= SMEM_PER_BLOCK


def kernel_info(dtype, B, n, m):
    """The CUDA kernel's launch for a ``(B, n)`` batch of ``dtype`` at
    history ``m`` (the Rosenbrock functor's kernel) and its compiled
    resources: warps per block, resident blocks and warps per SM (the
    card's occupancy calculator), registers and local (spill) bytes per
    thread, dynamic shared memory per block."""
    from . import _build

    out = (ctypes.c_int * 5)()
    rc = _build.load().lbfgs_fused_kernel_info(
        1 if dtype == torch.float64 else 0, B, n, m, out)
    check_launch(rc, "lbfgs_fused_kernel_info")
    wpb, blocks, regs, local, smem = list(out)
    return dict(warps_per_block=wpb, blocks_per_sm=blocks,
                warps_per_sm=wpb * blocks, registers=regs, local_bytes=local,
                smem_per_block=smem)


def as_device_batch(x0):
    """``x0`` as a ``(B, n)`` tensor: a tensor keeps its device, anything
    else goes to the card (``solvers.driver.as_batch``)."""
    # solvers.driver imports ops at load time, so this import waits for a call
    from ..solvers.driver import as_batch

    return as_batch(x0)


def armijo_steps(bval, X, d, fref, g0d, active, c1, max_iter_ls, nfev=None,
                 ties=None, iters=None):
    """Value-only Armijo backtracking: per instance t halves from 1 until
    ``f(X + t d) <= fref + c1 t g0d`` with a finite trial value, for at most
    ``max_iter_ls`` trials; a rejected last trial leaves the halved t.
    Instances not ``active`` keep ``t = 1`` and take no trial.  Each
    instance's trials are added to the int32 tensor ``nfev`` where one is
    given.  Where ``ties`` (int32, -1 where unset) is given, an instance
    whose test's two sides lie within (n + 2) eps (|f_t| + |fref| + c1 t
    |g0d|) gets ``iters`` there, as ``fused_driver.fused_minimize_plain``'s
    ``ties`` does (|g0d| is the sum of the magnitudes of its terms where
    they share one sign, as they do for a projected gradient step)."""
    t = torch.ones_like(fref)
    done = ~active
    tie_eps = (X.shape[-1] + 2) * torch.finfo(X.dtype).eps
    for _ in range(max_iter_ls):
        if bool(done.all()):
            break
        if nfev is not None:
            nfev.add_((~done).to(torch.int32))
        fv_t = bval(X + t[:, None] * d)
        ok = (fv_t <= fref + c1 * t * g0d) & torch.isfinite(fv_t)
        if ties is not None:
            scale = fv_t.abs() + fref.abs() + c1 * t * g0d.abs()
            near = (~done & torch.isfinite(fv_t) & (ties < 0)
                    & ((fv_t - fref - c1 * t * g0d).abs() <= tie_eps * scale))
            ties.copy_(torch.where(near, iters, ties))
        keep = done | ok
        t = torch.where(keep, t, t * 0.5)
        done = keep
    return t


def exit_status(conv, Fv):
    """CONVERGED where the test passes at a finite f, OUT_OF_DOMAIN where f
    is not finite, else MAX_ITER_REACHED."""
    finite = torch.isfinite(Fv)
    return torch.where(
        conv & finite, int(Status.CONVERGED),
        torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                    int(Status.MAX_ITER_REACHED))).to(torch.int32)


def lbfgs_solve_plain(obj, x0, data=(), *, m=10, tol=1e-5, max_iter=500,
                      max_iter_ls=16, c1=1e-4, c2=0.9):
    """Plain batched PyTorch L-BFGS, the algorithm of the CUDA kernel.
    ``c2`` is accepted and unused, as in the JAX kernel.  Returns ``(x, f,
    iterations, status)``; the caller adds the epilogue."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    eps = EPS_MACH[dt]
    bvg = batched_value_and_grad(obj, data)
    bval = batched_value(obj, data)
    rows = torch.arange(B, device=dev)
    X = x0.clone()
    Fv, G = bvg(X)
    S = torch.zeros((B, m, n), dtype=dt, device=dev)
    Y = torch.zeros((B, m, n), dtype=dt, device=dev)
    rho = torch.zeros((B, m), dtype=dt, device=dev)
    valid = torch.zeros((B, m), dtype=dt, device=dev)
    gamma = torch.ones((B,), dtype=dt, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    def converged():
        return torch.amax(torch.abs(G), dim=-1) < tol

    active = torch.isfinite(Fv) & ~converged()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        head = iters.long()
        q = G
        alphas = [None] * m
        for j in range(m):                       # newest -> oldest
            idx = (head - 1 - j) % m
            a = (rho[rows, idx] * torch.sum(S[rows, idx] * q, dim=-1)
                 * valid[rows, idx])
            q = q - a[:, None] * Y[rows, idx]
            alphas[j] = a
        r = gamma[:, None] * q
        for j in range(m - 1, -1, -1):           # oldest -> newest
            idx = (head - 1 - j) % m
            b = (rho[rows, idx] * torch.sum(Y[rows, idx] * r, dim=-1)
                 * valid[rows, idx])
            r = r + (alphas[j] - b)[:, None] * S[rows, idx]
        d = -r

        g0d = torch.sum(G * d, dim=-1)
        t = armijo_steps(bval, X, d, Fv, g0d, active, c1, max_iter_ls)
        X_new = X + t[:, None] * d
        f_new, g_new = bvg(X_new)
        s = X_new - X
        y = g_new - G
        sy = torch.sum(s * y, dim=-1)
        yy = torch.sum(y * y, dim=-1)
        accept = active & (sy > eps * yy)

        # ring write at the instance's own slot; a rejected pair writes a
        # zeroed, invalid slot
        ar, slot, acc = rows[active], (head % m)[active], accept[active]
        S[ar, slot] = torch.where(acc[:, None], s[active], 0.0)
        Y[ar, slot] = torch.where(acc[:, None], y[active], 0.0)
        rho[ar, slot] = torch.where(acc, 1.0 / sy[active], 0.0)
        valid[ar, slot] = acc.to(dt)
        gamma = torch.where(accept, sy / yy, gamma)

        X = torch.where(active[:, None], X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(active[:, None], g_new, G)
        iters = iters + active.to(torch.int32)
        active = torch.isfinite(Fv) & ~converged()
    return X, Fv, iters, exit_status(converged(), Fv)


def kernel_call_operands(obj, data, x0, kernel, objectives):
    """Check ``x0`` and the objective for a whole-solve kernel; returns the
    functor code, its data arrays (kept alive by the caller), their
    pointers and the output tensors ``(x, f, iterations, status, trials)``
    (``trials``: the value-only search trials of each instance)."""
    if x0.dim() != 2 or x0.dtype not in EPS_MACH:
        raise ValueError(f"x0 must be a (B, n) float32/float64 tensor, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    code, arrays = kernel_operands(obj, data, x0, kernel=kernel)
    name = next(k for k, v in KERNEL_OBJECTIVES.items() if v == code)
    if name not in objectives:
        raise NotImplementedError(
            f"{kernel} compiles the functors {objectives}, not {name}; the "
            "plain version takes this objective on a CPU tensor")
    ptrs = [a.data_ptr() for a in arrays] + [None] * (2 - len(arrays))
    B = x0.shape[0]
    outs = (torch.empty(tuple(x0.shape), dtype=x0.dtype, device=x0.device),
            torch.empty((B,), dtype=x0.dtype, device=x0.device),
            *(torch.empty((B,), dtype=torch.int32, device=x0.device)
              for _ in range(3)))
    return code, arrays, ptrs, outs


def check_launch(rc, what):
    from . import _build

    if rc != 0:
        raise RuntimeError(f"{what} failed: {_build.error_string(rc)} "
                           f"(code {rc})")


def _launch_cuda(obj, x0, data, *, m, tol, max_iter, max_iter_ls, c1):
    """Check the operands, launch ``csrc/lbfgs_fused.cu`` on the current
    stream and return ``(x, f, iterations, status, trials)``."""
    from . import _build

    if not 1 <= m <= MAX_M:
        raise ValueError(f"m must lie in [1, {MAX_M}], got {m}")
    code, _arrays, (d0, d1), outs = kernel_call_operands(
        obj, data, x0, KERNEL, K7_OBJECTIVES)
    B, n = x0.shape
    lib = _build.load()
    per_warp = lib.lbfgs_fused_smem_per_warp(n, m, x0.element_size())
    if per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"n={n}, m={m} needs {per_warp} bytes of shared memory per "
            f"instance in {KERNEL}, more than a block's {SMEM_PER_BLOCK}")
    x0 = x0.contiguous()
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.lbfgs_fused_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(), d0,
            d1, B, n, m, float(tol), int(max_iter), int(max_iter_ls),
            float(c1), *(t.data_ptr() for t in outs),
            ctypes.c_void_p(stream))
    check_launch(rc, "lbfgs_fused_launch")
    lbfgs_solve_fused.launches += 1
    return outs


def lbfgs_solve_fused(f, x0, data=(), *, m=10, tol=1e-5, max_iter=500,
                      max_iter_ls=16, c1=1e-4, c2=0.9):
    """Batched unconstrained L-BFGS solves, one instance per CUDA warp.

    ``x0`` is ``(B, n)`` (any B); ``data`` is the objective's problem data,
    shared across instances; ``c2`` is accepted and unused, as in the JAX
    kernel.  A CPU ``x0`` runs :func:`lbfgs_solve_plain`; a CUDA ``x0`` (or
    a non-tensor one, which goes to the card) launches the kernel (the
    objective needs a ``ROSENBROCK``, ``WEIGHTED_SQUARES`` or ``QUADRATIC``
    kernel form) or raises.  The final ``g`` and ``pg_norm`` (``max|g|``)
    come from the objective's batched value-and-gradient, as in the JAX
    epilogue."""
    x0 = as_device_batch(x0)
    kw = dict(m=m, tol=tol, max_iter=max_iter, max_iter_ls=max_iter_ls,
              c1=c1)
    if x0.device.type == "cpu":
        x, fv, it, st = lbfgs_solve_plain(f, x0, data, **kw)
    elif x0.device.type == "cuda":
        x, fv, it, st, _ = _launch_cuda(f, x0, data, **kw)
    else:
        raise ValueError(f"no L-BFGS route for device {x0.device}")
    _, g = batched_value_and_grad(f, data)(x)
    return SolveResult(x, fv, g, it, st, pg_norm=batched_pg_inf_norm(x, g))


lbfgs_solve_fused.launches = 0
