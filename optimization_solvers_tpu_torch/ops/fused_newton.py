"""The batched Cholesky solve K6: ``H^{-1} g`` for a batch of symmetric
positive definite ``H``, one CUDA kernel on the GPU, and its plain PyTorch
version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_newton.py``
(``cholesky_solve_pallas``; its plain-XLA twin is
``cholesky_solve_masked``).  ``H`` is ``(B, n, n)`` and ``g`` ``(B, n)``,
float32 or float64; only ``H``'s lower triangle is read, and ``H`` is never
written.  A pivot that is not positive makes that instance's solution all
NaN, as the TPU kernel's masked algorithm does; the other instances are
untouched.

Both versions factor right-looking by panels of columns and substitute
panel by panel (``csrc/chol_blocked.cuh`` says why; the routine is shared
with K3's Newton form); the plain version does the trailing update of a
panel as one batched matrix product, the kernel one multiply-add per panel
column and element, so the two round differently.
:func:`cholesky_solve_fused` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other.  The lockstep Newton methods reach it through
:func:`..ops.linalg.cholesky_solve` when ``ops.linalg.config.use_kernel``
asks for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# the kernel's panel widths (csrc/cholesky_solve.cu K6Panel): 64 columns in
# float32, 32 in float64
PANEL = {torch.float32: 64, torch.float64: 32}
SMEM_PER_BLOCK = 232448
_TILE = {4: 64, 8: 32}           # csrc/chol_blocked.cuh CholTile::kTile


def scratch_elems(itemsize: int, nb: int) -> int:
    """Shared memory of the blocked factorization in elements,
    ``chol_scratch_elems`` of ``csrc/chol_blocked.cuh``: two staged row
    blocks and three staged column blocks, or the TRSM's diagonal block,
    its transpose and 256 columns, or two buffers of the transposing
    copies' tiles, rounded up to 4."""
    t = _TILE[itemsize]
    need = max(5 * nb * t, 2 * nb * nb + nb * 256,
               2 * (t * (t + 1) + t * t))
    return (need + 3) // 4 * 4


def panel_width(n: int, itemsize: int) -> int:
    """The panel width the kernel takes for width ``n`` (0: ``n`` does not
    fit a block's shared memory), mirroring ``cholesky_solve_panel``: the
    factorization's scratch plus the n-vector."""
    nb = PANEL[torch.float32 if itemsize == 4 else torch.float64]
    fits = n >= 1 and (scratch_elems(itemsize, nb) + n) * itemsize <= (
        SMEM_PER_BLOCK)
    return nb if fits else 0


def cholesky_solve_plain(h: torch.Tensor, g: torch.Tensor,
                         panel: Optional[int] = None) -> torch.Tensor:
    """``H^{-1} g`` by a right-looking blocked Cholesky of the lower
    triangle of ``h`` and two blocked substitutions, in batched PyTorch,
    by panels of ``panel`` columns (the kernel's width for the dtype by
    default).  Takes ``(B, n, n)`` and ``(B, n)``, or one instance."""
    if panel is None:
        panel = PANEL.get(h.dtype, PANEL[torch.float32])
    squeeze = h.dim() == 2
    if squeeze:
        h, g = h[None], g[None]
    A = h.clone()
    x = g.clone()
    n = A.shape[-1]
    starts = range(0, n, panel)
    for k in starts:
        e = min(k + panel, n)
        for j in range(k, e):
            piv = torch.sqrt(A[:, j, j])
            A[:, j + 1:, j] /= piv[:, None]
            A[:, j, j] = piv
            col = A[:, j + 1:, j]
            A[:, j + 1:, j + 1:e] -= col[:, :, None] * col[:, None, :e - j - 1]
        # forward substitution for the panel's unknowns, then the rows below
        for j in range(k, e):
            x[:, j] /= A[:, j, j]
            x[:, j + 1:e] -= A[:, j + 1:e, j] * x[:, j:j + 1]
        L21 = A[:, e:, k:e]
        x[:, e:] -= torch.einsum("bic,bc->bi", L21, x[:, k:e])
        A[:, e:, e:] -= L21 @ L21.transpose(-1, -2)
    for k in reversed(starts):
        e = min(k + panel, n)
        x[:, k:e] -= torch.einsum("bic,bi->bc", A[:, e:, k:e], x[:, e:])
        for j in reversed(range(k, e)):
            x[:, j] /= A[:, j, j]
            x[:, k:j] -= A[:, j, k:j] * x[:, j:j + 1]
    return x[0] if squeeze else x


def _launch_cuda(h, g):
    from . import _build

    if h.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K6 takes float32 or float64, got {h.dtype}")
    if h.dim() != 3 or h.shape[-1] != h.shape[-2]:
        raise ValueError(f"H must be (B, n, n), got {tuple(h.shape)}")
    B, n, _ = h.shape
    if tuple(g.shape) != (B, n) or g.dtype != h.dtype or (
            g.device != h.device):
        raise ValueError(f"g must be a ({B}, {n}) {h.dtype} tensor on "
                         f"{h.device}, got {tuple(g.shape)} {g.dtype} on "
                         f"{g.device}")
    lib = _build.load()
    if lib.cholesky_solve_panel(n, h.element_size()) == 0:
        raise ValueError(f"n={n} is too wide for the CUDA kernel K6: its "
                         "right-hand side and the factorization's scratch do "
                         "not fit a block's shared memory")
    h, g = h.contiguous(), g.contiguous()
    work = torch.empty_like(h)
    x = torch.empty_like(g)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = lib.cholesky_solve_launch(
            1 if h.dtype == torch.float64 else 0, h.data_ptr(), g.data_ptr(),
            work.data_ptr(), x.data_ptr(), B, n, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cholesky_solve_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    cholesky_solve_fused.launches += 1
    return x


def cholesky_solve_fused(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched ``H^{-1} g``, the counterpart of JAX
    ``cholesky_solve_pallas``: CPU tensors run
    :func:`cholesky_solve_plain`, CUDA tensors the kernel (a build or
    launch failure raises).  One instance (``h`` ``(n, n)``) is promoted."""
    squeeze = h.dim() == 2
    if squeeze:
        h, g = h[None], g[None]
    if h.device.type == "cpu":
        x = cholesky_solve_plain(h, g)
    elif h.device.type == "cuda":
        x = _launch_cuda(h, g)
    else:
        raise ValueError(f"no K6 route for device {h.device}")
    return x[0] if squeeze else x


cholesky_solve_fused.launches = 0
