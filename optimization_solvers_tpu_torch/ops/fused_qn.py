"""The fused dense quasi-Newton update K5: ``(B, s, y, g) -> (B', B' g)``
for a batch, one CUDA kernel on the GPU, and its plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_qn.py``
(``qn_update_direction_pallas``; its plain-XLA reference is
``qn_update_direction_ref``).  ``B`` is ``(b, n, n)``, the vectors
``(b, n)``, float32 or float64; ``kind`` is one of ``bfgs``, ``dfp``,
``broyden`` and ``sr1`` (the formulas in ``csrc/qn_update.cu``).  A
degenerate pair, ``sqrt(s.s) < tol`` or ``sqrt(y.y) < tol``, keeps ``B``
and still returns ``B g``.

:func:`qn_update_direction_fused` takes the plain version for CPU tensors
and launches ``csrc/qn_update.cu`` for CUDA tensors; it never falls back
from one to the other.  The kernel stages each instance's ``B`` in its
block's shared memory where ``B`` and the vectors fit (:func:`in_shared`,
the ``"shared"`` placement), else reads it from device memory twice (the
``"workspace"`` placement); ``qn_update_direction_fused.placements``
counts the launches of each.  The lockstep ``QuasiNewton(fused=True)``
post-step calls it once per iteration (:mod:`..solvers.quasi_newton`).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.numerics import dot, matvec, outer

KINDS = ("bfgs", "dfp", "broyden", "sr1")
# kSmemPerBlock of csrc/common.cuh
SMEM_PER_BLOCK = 232448
# threads per block of csrc/qn_update.cu (kK5Threads)
THREADS = 256


def smem_elems(n: int) -> int:
    """Shared memory the workspace placement takes per block, in elements
    (``k5_vec_elems``): s, y, g, B y, B^T s and the reduction slots."""
    return 5 * n + 3 * (THREADS // 32)


def in_shared(n: int, itemsize: int) -> bool:
    """Whether an instance of width ``n`` takes the shared placement
    (``k5_in_shared``): the vectors (rounded up to 16 bytes), 16 bytes for
    the copy's barrier, B's staged copy and 16 bytes of alignment within
    a block's shared memory."""
    vec = (smem_elems(n) * itemsize + 15) // 16 * 16
    return vec + 32 + n * n * itemsize <= SMEM_PER_BLOCK


def _scale(v, M):
    """A per-instance scalar ``(b,)`` times a ``(b, n, n)`` batch."""
    return v[..., None, None] * M


def qn_update_direction_plain(B, s, y, g, skip, *, kind: str = "bfgs"):
    """``(B', B' g)`` in batched PyTorch, the update skipped where ``skip``
    (``(b,)`` bool) holds: the formulas of JAX ``_update_math``
    (``pallas_qn.py:25-52``).  Takes one instance (``B`` ``(n, n)``) too."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    By = matvec(B, y)
    sy = dot(s, y)
    if kind == "bfgs":
        rho = 1.0 / sy
        yBy = dot(y, By)
        Bn = (B - _scale(rho, outer(s, By) + outer(By, s))
              + _scale(rho * rho * yBy + rho, outer(s, s)))
    elif kind == "dfp":
        yBy = dot(y, By)
        Bn = (B + outer(s, s) / sy[..., None, None]
              - outer(By, By) / yBy[..., None, None])
    elif kind == "broyden":
        Bts = matvec(B.transpose(-1, -2), s)
        Bn = B + outer(s - By, Bts) / sy[..., None, None]
    else:
        shy = s - By
        Bn = B + outer(shy, shy) / dot(shy, y)[..., None, None]
    Bn = torch.where(torch.as_tensor(skip)[..., None, None], B, Bn)
    return Bn, matvec(Bn, g)


def skip_mask(s, y, tol):
    """The degenerate-pair skip the kernel decides:
    ``sqrt(s.s) < tol | sqrt(y.y) < tol``."""
    return (torch.sqrt(dot(s, s)) < tol) | (torch.sqrt(dot(y, y)) < tol)


def _launch_cuda(B, s, y, g, tol, kind):
    from . import _build

    if B.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K5 takes float32 or float64, got {B.dtype}")
    b, n, _ = B.shape
    for name, v in (("s", s), ("y", y), ("g", g)):
        if tuple(v.shape) != (b, n) or v.dtype != B.dtype or (
                v.device != B.device):
            raise ValueError(f"{name} must be a ({b}, {n}) {B.dtype} tensor "
                             f"on {B.device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    lib = _build.load()
    need = lib.qn_update_smem_elems(n) * B.element_size()
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"n={n} needs {need} bytes of shared memory per instance in the "
            f"CUDA kernel K5, more than a block's {SMEM_PER_BLOCK}")
    B, s, y, g = (v.contiguous() for v in (B, s, y, g))
    Bn = torch.empty_like(B)
    Bg = torch.empty_like(g)
    stream = torch.cuda.current_stream(B.device).cuda_stream
    with torch.cuda.device(B.device):
        rc = lib.qn_update_launch(
            1 if B.dtype == torch.float64 else 0, B.data_ptr(), s.data_ptr(),
            y.data_ptr(), g.data_ptr(), Bn.data_ptr(), Bg.data_ptr(), b, n,
            KINDS.index(kind), float(tol), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"qn_update_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    qn_update_direction_fused.launches += 1
    placement = "shared" if in_shared(n, B.element_size()) else "workspace"
    qn_update_direction_fused.placements[placement] += 1
    return Bn, Bg


def qn_update_direction_fused(B, s, y, g, *, tol: float = 1e-8,
                              kind: str = "bfgs"):
    """Batched fused quasi-Newton step ``(B, s, y, g) -> (B', B' g)``, the
    counterpart of JAX ``qn_update_direction_pallas``: the skip is decided
    from ``tol`` as the kernel decides it.  CPU tensors run
    :func:`qn_update_direction_plain`, CUDA tensors the kernel (a build or
    launch failure raises).  One instance (``B`` ``(n, n)``) is promoted."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    squeeze = B.dim() == 2
    if squeeze:
        B, s, y, g = B[None], s[None], y[None], g[None]
    if B.device.type == "cpu":
        Bn, Bg = qn_update_direction_plain(B, s, y, g, skip_mask(s, y, tol),
                                           kind=kind)
    elif B.device.type == "cuda":
        Bn, Bg = _launch_cuda(B, s, y, g, tol, kind)
    else:
        raise ValueError(f"no K5 route for device {B.device}")
    return (Bn[0], Bg[0]) if squeeze else (Bn, Bg)


qn_update_direction_fused.launches = 0
qn_update_direction_fused.placements = {"shared": 0, "workspace": 0}
