"""Small-matrix Cholesky and triangular solves, unrolled over the matrix
dimension.

PyTorch counterpart of :mod:`optimization_solvers_tpu.ops.smallchol`, with
the same order of operations: column by column (Cholesky-Crout), each
entry's sum over the columns before it, no pivot floor (a non-positive
pivot gives NaN, as the JAX functions do).  The lockstep L-BFGS-B's middle
matrix is 2m x 2m with m in [3, 20]; a few tensor ops per column over the
batch beat a batched LAPACK call at that size and keep the JAX package's
arithmetic.

Every function broadcasts over leading batch axes.  Solves take matrix
right-hand sides of shape ``(..., m, k)``; :func:`spd_solve_small` takes a
vector ``(..., m)``.
"""

from __future__ import annotations

import torch


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a small SPD matrix (last dims m x m)."""
    m = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(m):
        if j == 0:
            s = A[..., j, j]
        else:
            s = A[..., j, j] - torch.sum(L[..., j, :j] * L[..., j, :j], dim=-1)
        ljj = torch.sqrt(s)
        L[..., j, j] = ljj
        if j + 1 < m:
            if j == 0:
                col = A[..., j + 1:, j]
            else:
                col = A[..., j + 1:, j] - torch.sum(
                    L[..., j + 1:, :j] * L[..., None, j, :j], dim=-1)
            L[..., j + 1:, j] = col / ljj[..., None]
    return L


def solve_lower_small_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L Y = B`` (lower triangular), ``B`` of shape (..., m, k)."""
    m = L.shape[-1]
    Y = torch.zeros_like(B)
    for i in range(m):
        if i == 0:
            s = B[..., i, :]
        else:
            s = B[..., i, :] - torch.sum(L[..., i, :i, None] * Y[..., :i, :],
                                         dim=-2)
        Y[..., i, :] = s / L[..., i, i, None]
    return Y


def solve_upper_small_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L^T X = B`` given lower ``L``, ``B`` of shape (..., m, k)."""
    m = L.shape[-1]
    X = torch.zeros_like(B)
    for i in range(m - 1, -1, -1):
        if i == m - 1:
            s = B[..., i, :]
        else:
            s = B[..., i, :] - torch.sum(
                L[..., i + 1:, i, None] * X[..., i + 1:, :], dim=-2)
        X[..., i, :] = s / L[..., i, i, None]
    return X


def spd_solve_small_mat(Lch: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` given ``Lch = cholesky_small(A)``; ``B`` (..., m, k)."""
    return solve_upper_small_mat(Lch, solve_lower_small_mat(Lch, B))


def spd_solve_small(Lch: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^{-1} b`` for a vector right-hand side (..., m)."""
    return spd_solve_small_mat(Lch, b[..., None])[..., 0]
