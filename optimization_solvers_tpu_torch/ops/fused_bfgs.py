"""Whole batched dense BFGS solves: one CUDA kernel (K9) on the GPU, and its
plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_bfgs.py``
(``bfgs_solve_fused``, kernel body ``_make_kernel``, ``pl.pallas_call`` at
:221).  Both versions here run its algorithm, instance by instance:

* each instance keeps a dense ``(n, n)`` inverse-Hessian approximation B,
  starting at the identity; the direction is ``d = -B g``;
* a value-only Armijo search from ``t = 1``, halving up to
  ``max_iter_ls`` times; a non-finite trial counts as a rejection, and
  the last halved step is taken all the same;
* the expanded rank-2 update ``B - rho (s (By)^T + (By) s^T) + (rho^2 yBy
  + rho) s s^T`` with ``rho = 1 / s.y``, applied only where ``||s|| >=
  tol``, ``||y|| >= tol`` and ``s.y > eps`` (``eps`` the JAX kernel's
  literal, 1.2e-7 in float32 and 2.2e-16 in float64); no scaling of B0
  and no restart;
* stop on the 2-norm ``||g|| < tol``; a non-finite f ends an instance
  ``OUT_OF_DOMAIN``.

In the CUDA kernel each instance runs on one block; B is kept as its
packed upper triangle (``csrc/dense_slab.cuh``), in the block's shared
memory where it fits beside the vectors, else in a device-memory workspace
of one triangle per instance (:func:`slab_in_shared`, a route by shape;
``bfgs_solve_fused.placements`` counts the launches of each).  The
matrix-vector products and the update are split over the block's threads,
the objective runs on the first warp.  :func:`bfgs_solve_fused` takes the
plain version for a CPU ``x0`` and launches ``csrc/bfgs_fused.cu`` for a
CUDA ``x0``; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import batched_pg_inf_norm
from ..core.types import SolveResult
from .batched_oracle import (KERNEL_OBJECTIVES, batched_value,
                             batched_value_and_grad)
from .fused_lbfgs import (EPS_MACH, SMEM_PER_BLOCK, armijo_steps,
                          as_device_batch, check_launch, exit_status,
                          kernel_call_operands)

KERNEL = "the CUDA dense BFGS kernel K9"
# the objective functors csrc/bfgs_fused.cu compiles (K7's three and the
# log-sum-exp)
K9_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC", "LOG_SUM_EXP")


def slab_elems(n: int) -> int:
    """Elements of one instance's inverse Hessian: its packed upper
    triangle (``csrc/dense_slab.cuh`` ``slab_elems``)."""
    return n * (n + 1) // 2


def slab_in_shared(n: int, itemsize: int, rows: int = 0) -> bool:
    """Whether the kernel keeps the triangle in the block's shared memory
    beside the vectors and a log-sum-exp's z of ``rows`` elements
    (``csrc/bfgs_fused.cu`` ``in_shared``), else in the device-memory
    workspace."""
    return (8 * n + 4 + rows + slab_elems(n)) * itemsize <= SMEM_PER_BLOCK


def workspace_elems(B: int, n: int, itemsize: int, rows: int = 0) -> int:
    """Device-memory workspace of the CUDA kernel, in elements: one
    triangle per instance where it does not fit shared memory, else none
    (``csrc/bfgs_fused.cu`` ``workspace_elems``)."""
    return 0 if slab_in_shared(n, itemsize, rows) else B * slab_elems(n)


def smem_per_instance(n: int, itemsize: int, rows: int = 0) -> int:
    """Shared memory of one instance's block (``smem_elems`` of
    ``csrc/bfgs_fused.cu``): x, g, d, the trial point, the new gradient, s,
    y and B y, four scalar slots and a log-sum-exp's z of ``rows`` elements
    (0 for the other objectives), then the triangle where it fits."""
    vecs = 8 * n + 4 + rows
    return (vecs + (slab_elems(n) if slab_in_shared(n, itemsize, rows)
                    else 0)) * itemsize


def bfgs_solve_plain(obj, x0, data=(), *, tol=1e-5, max_iter=500,
                     max_iter_ls=24, c1=1e-4):
    """Plain batched PyTorch dense BFGS, the algorithm of the CUDA kernel.
    Returns ``(x, f, iterations, status)``; the caller adds the
    epilogue."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    eps = EPS_MACH[dt]
    bvg = batched_value_and_grad(obj, data)
    bval = batched_value(obj, data)
    X = x0.clone()
    Fv, G = bvg(X)
    Bm = torch.eye(n, dtype=dt, device=dev).expand(B, n, n).clone()
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    def converged():
        return torch.sqrt(torch.sum(G * G, dim=-1)) < tol

    active = torch.isfinite(Fv) & ~converged()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        d = -torch.sum(Bm * G[:, None, :], dim=-1)
        g0d = torch.sum(G * d, dim=-1)
        t = armijo_steps(bval, X, d, Fv, g0d, active, c1, max_iter_ls)
        X_new = X + t[:, None] * d
        f_new, g_new = bvg(X_new)

        s = X_new - X
        y = g_new - G
        sy = torch.sum(s * y, dim=-1)
        s_norm = torch.sqrt(torch.sum(s * s, dim=-1))
        y_norm = torch.sqrt(torch.sum(y * y, dim=-1))
        upd = active & (s_norm >= tol) & (y_norm >= tol) & (sy > eps)
        if bool(upd.any()):
            By = torch.sum(Bm * y[:, None, :], dim=-1)
            yBy = torch.sum(y * By, dim=-1)
            rho = 1.0 / sy
            coeff = rho * rho * yBy + rho
            si, byi = s[:, :, None], By[:, :, None]
            sj, byj = s[:, None, :], By[:, None, :]
            Bn = (Bm - rho[:, None, None] * (si * byj + byi * sj)
                  + coeff[:, None, None] * (si * sj))
            Bm = torch.where(upd[:, None, None], Bn, Bm)

        X = torch.where(active[:, None], X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(active[:, None], g_new, G)
        iters = iters + active.to(torch.int32)
        active = torch.isfinite(Fv) & ~converged()
    return X, Fv, iters, exit_status(converged(), Fv)


def _launch_cuda(obj, x0, data, *, tol, max_iter, max_iter_ls, c1):
    """Check the operands, allocate the workspace, launch
    ``csrc/bfgs_fused.cu`` on the current stream and return ``(x, f,
    iterations, status, trials, updates)`` (``updates``: how many times
    each instance's B was updated)."""
    from . import _build

    code, arrays, (d0, d1), outs = kernel_call_operands(
        obj, data, x0, KERNEL, K9_OBJECTIVES)
    B, n = x0.shape
    rows = arrays[0].shape[0] if code == KERNEL_OBJECTIVES["LOG_SUM_EXP"] else 0
    itemsize = x0.element_size()
    if smem_per_instance(n, itemsize, rows) > SMEM_PER_BLOCK:
        raise ValueError(
            f"n={n} needs {smem_per_instance(n, itemsize, rows)} bytes of "
            f"shared memory per instance in {KERNEL}, more than a block's "
            f"{SMEM_PER_BLOCK}")
    lib = _build.load()
    elems = workspace_elems(B, n, itemsize, rows)
    work = None
    if elems:
        free, _ = torch.cuda.mem_get_info(x0.device)
        if elems * itemsize > free:
            raise ValueError(
                f"B={B}, n={n} needs {elems * itemsize} bytes of device "
                f"memory for the inverse Hessians of {KERNEL}, more than the "
                f"{free} free: use a smaller batch")
        work = torch.empty((elems,), dtype=x0.dtype, device=x0.device)
    x0 = x0.contiguous()
    outs = outs + (torch.empty_like(outs[4]),)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.bfgs_fused_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(), d0,
            d1, rows, B, n, float(tol), int(max_iter), int(max_iter_ls),
            float(c1),
            None if work is None else work.data_ptr(),
            *(t.data_ptr() for t in outs), ctypes.c_void_p(stream))
    check_launch(rc, "bfgs_fused_launch")
    bfgs_solve_fused.launches += 1
    bfgs_solve_fused.placements["workspace" if elems else "shared"] += 1
    return outs


def bfgs_solve_fused(f, x0, data=(), *, tol=1e-5, max_iter=500,
                     max_iter_ls=24, c1=1e-4):
    """Batched dense BFGS solves, one block per instance.

    ``x0`` is ``(B, n)`` (any B); ``data`` is the objective's problem data,
    shared across instances.  A CPU ``x0`` runs :func:`bfgs_solve_plain`; a
    CUDA ``x0`` (or a non-tensor one, which goes to the card) launches the
    kernel (the objective needs a kernel form of ``K9_OBJECTIVES``) or
    raises.  The final ``g`` and ``pg_norm``
    (``max|g|``) come from the objective's batched value-and-gradient, as
    in the JAX epilogue."""
    x0 = as_device_batch(x0)
    kw = dict(tol=tol, max_iter=max_iter, max_iter_ls=max_iter_ls, c1=c1)
    if x0.device.type == "cpu":
        x, fv, it, st = bfgs_solve_plain(f, x0, data, **kw)
    elif x0.device.type == "cuda":
        x, fv, it, st = _launch_cuda(f, x0, data, **kw)[:4]
    else:
        raise ValueError(f"no BFGS route for device {x0.device}")
    _, g = batched_value_and_grad(f, data)(x)
    return SolveResult(x, fv, g, it, st, pg_norm=batched_pg_inf_norm(x, g))


bfgs_solve_fused.launches = 0
# launches by where the inverse Hessians lay (slab_in_shared)
bfgs_solve_fused.placements = {"shared": 0, "workspace": 0}
