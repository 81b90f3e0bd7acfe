"""Dense linear-algebra seam of the Newton family: ``cholesky_solve`` and
``solve_spd``, and the switch between the library factorization and the
Cholesky kernel K6.

Counterpart of :mod:`optimization_solvers_tpu.ops.linalg`.  As there, the
kernel is opt-in: :data:`config.use_kernel` is ``False`` by default (the
library path), ``True`` asks for K6 (:mod:`.fused_newton`: the CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor), and ``None`` takes K6
on a CUDA tensor of width ``n <= config.max_kernel_n`` and the library
elsewhere, as JAX's ``use_pallas=None`` takes its kernel on a TPU.

The library path is ``torch.linalg.cholesky_ex`` and
``torch.cholesky_solve``; an instance whose factorization fails (a matrix
that is not positive definite) comes back all NaN, as XLA's factorization
gives it in the JAX package, and nothing raises.
"""

from __future__ import annotations

import dataclasses

import torch

from . import fused_newton


@dataclasses.dataclass
class _Config:
    use_kernel: bool | None = False
    max_kernel_n: int = 512


config = _Config()


def _want_kernel(h: torch.Tensor) -> bool:
    if config.use_kernel is not None:
        return config.use_kernel
    return h.device.type == "cuda" and h.shape[-1] <= config.max_kernel_n


def cholesky_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H s = g`` for symmetric positive definite ``H`` by Cholesky
    (the reference's ``hessian.cholesky().unwrap().solve(g)``); ``h`` is
    ``(..., n, n)`` and ``g`` ``(..., n)``.  A non-PD ``H`` gives NaN where
    the reference panics."""
    if _want_kernel(h) and h.dim() <= 3:
        return fused_newton.cholesky_solve_fused(h, g)
    L, info = torch.linalg.cholesky_ex(h)
    x = torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info != 0)[..., None],
                       torch.full_like(x, float("nan")), x)


def solve_spd(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Alias used by Newton-family solvers."""
    return cholesky_solve(h, g)
