"""Torch models of the small algebra of the CUDA kernel K1
(``optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu``), lane by lane
where the kernel spreads a computation over the lanes of a warp, and the
plain version's forms they replace (``ops/fused_lbfgsb.py``:
``lbfgsb_solve_plain``'s ``two_loop``, ``middle`` and ``mid_solve``).  The
kernel cannot run on the CPU; these models repeat its order of operations
so that the tests can hold each reformulation against the plain form.

Histories are chronological (row 0 oldest); the oldest ``m - nvalid`` rows
of S and Y are zero, as the kernel keeps them after a restart.
"""

import numpy as np
import torch

from optimization_solvers_tpu_torch.ops.fused_lbfgsb import _chol

WARP = 32
LANES = torch.arange(WARP)


def warp_sums(v):
    """``warp_sums<K>``: ``v`` is ``(32, K)``, lane l's K partial sums;
    returns ``(32,)`` with sum number ``l // (32 // K)`` on lane l."""
    v = v.clone()
    K = v.shape[1]
    w, o = K, 16
    while w > 1:
        h = w // 2
        hi = ((LANES & o) != 0)[:, None]
        send = torch.where(hi, v[:, :h], v[:, h:w])
        keep = torch.where(hi, v[:, h:w], v[:, :h])
        v[:, :h] = keep + send[LANES ^ o]
        w, o = h, o // 2
    r = v[:, 0].clone()
    o = 16 // K
    while o > 0:
        r = r + r[LANES ^ o]
        o //= 2
    return r


def warp_sum(v):
    """``warp_sum`` of ``common.cuh``: the five-shuffle butterfly of one
    value per lane; every lane gets the sum."""
    r = v.clone()
    for o in (16, 8, 4, 2, 1):
        r = r + r[LANES ^ o]
    return r


def lane_partials(x, y):
    """Lane l's partial dot products of the rows of ``x`` (k, n) with ``y``
    (n,): coordinate i on lane i % 32, summed in increasing i: ``(32, k)``."""
    k, n = x.shape
    out = torch.zeros((WARP, k), dtype=x.dtype)
    for i in range(n):
        out[i % WARP] = out[i % WARP] + x[:, i] * y[i]
    return out


def history(m, n, nvalid, seed, dtype=torch.float64):
    """Random valid L-BFGS history: S, Y (m, n) with s.y > 0 on the newest
    ``nvalid`` rows and zeros before, the chronological tables S.Y, S.S, Y.Y,
    D-hat (1 on invalid slots), theta and a gradient g."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T / n + np.eye(n)
    S = np.zeros((m, n))
    Y = np.zeros((m, n))
    for q in range(m - nvalid, m):
        s = rng.standard_normal(n)
        S[q] = s
        Y[q] = A @ s + 0.1 * rng.standard_normal(n) * np.linalg.norm(s) / np.sqrt(n)
    S, Y = (torch.tensor(a, dtype=dtype) for a in (S, Y))
    valid = torch.arange(m) >= m - nvalid
    SY, SS, YY = S @ Y.T, S @ S.T, Y @ Y.T
    DH = torch.where(valid, torch.diagonal(SY), torch.ones(m, dtype=dtype))
    theta = float(Y[-1] @ Y[-1] / (S[-1] @ Y[-1])) if nvalid else 1.0
    g = torch.tensor(rng.standard_normal(n), dtype=dtype)
    return S, Y, SY, SS, YY, DH, valid, theta, g


# ---- the plain version's forms (lbfgsb_solve_plain) --------------------------

def two_loop_plain(g, S, Y, DH, valid, theta):
    """``two_loop`` of ``lbfgsb_solve_plain`` for one instance: r = H g."""
    m = S.shape[0]
    coef = valid.to(g.dtype) / DH
    q = g.clone()
    alphas = [None] * m
    for j in range(m - 1, -1, -1):
        a = coef[j] * torch.sum(S[j] * q)
        q = q - a * Y[j]
        alphas[j] = a
    r = q / theta
    for j in range(m):
        b = coef[j] * torch.sum(Y[j] * r)
        r = r + (alphas[j] - b) * S[j]
    return r


def middle_plain(SY, SS, DH, valid, theta, eps):
    """``middle`` of ``lbfgsb_solve_plain``: strictly lower L and the
    Cholesky factor of the Schur complement."""
    Lc = torch.tril(SY, -1)
    Sch = theta * SS + (Lc / DH[None, :]) @ Lc.T
    diag = torch.diagonal(Sch)
    diag.copy_(torch.where(valid, diag, torch.ones_like(diag)))
    return Lc, Sch, _chol(Sch[None], eps)[0]


def mid_solve_plain(ab, DH, Lc, Lsch):
    """``mid_solve`` of ``lbfgsb_solve_plain``: M^{-1} [a; b]."""
    m = DH.shape[0]
    a, b = ab[:m, None], ab[m:, None]
    v = torch.cholesky_solve(b + Lc @ (a / DH[:, None]), Lsch)
    u = (-a + Lc.T @ v) / DH[:, None]
    return torch.cat([u, v])[:, 0]


# ---- the kernel's forms -----------------------------------------------------

def schur_kernel(SY, SS, DH, valid, theta):
    """The kernel's Schur complement, entry by entry (``schur``):
    theta S.S_rq + sum_k SY_rk SY_qk / DH_k, the division as a product with
    the reciprocal, the diagonal of invalid slots patched to 1."""
    m = DH.shape[0]
    DHI = 1.0 / DH
    K = torch.zeros((m, m), dtype=SY.dtype)
    for r in range(m):
        for q in range(r + 1):
            v = theta * SS[r, q]
            for k in range(q):
                v = v + SY[r, k] * SY[q, k] * DHI[k]
            K[r, q] = K[q, r] = 1.0 if (r == q and not valid[r]) else v
    return K


def chol_registers(A, eps):
    """The kernel's Cholesky of the Schur complement for m <= 7: one lower
    entry per lane, right-looking, each entry taking its updates in the
    order the left-looking ``chol`` does."""
    m = A.shape[0]
    a = torch.tril(A).clone()
    for j in range(m):
        a[j, j] = torch.sqrt(torch.clamp(a[j, j], min=eps))
        a[j + 1:, j] = a[j + 1:, j] / a[j, j]
        for q in range(j + 1, m):
            a[q:, q] = a[q:, q] - a[q:, j] * a[q, j]
    return a


def mid_solve_lanes(ab, SY, L, DH):
    """``mid_solve_lanes``: lane i < m holds row i; the triangular solves
    sweep columns (one shuffle each) and multiply by the reciprocals of the
    pivots and of D-hat.  Returns M^{-1} [a; b]."""
    m = DH.shape[0]
    DHI = 1.0 / DH
    li = 1.0 / torch.diagonal(L)
    a, b = ab[:m], ab[m:]
    rows = torch.arange(m)
    v = b.clone()
    for j in range(m):
        below = rows > j
        v[below] = v[below] + SY[below, j] * (a[j] * DHI[j])
    for j in range(m):
        zj = v[j] * li[j]
        below = rows > j
        v[below] = v[below] - L[below, j] * zj
        v[j] = zj
    for j in range(m - 1, -1, -1):
        wj = v[j] * li[j]
        above = rows < j
        v[above] = v[above] - L[j, above] * wj
        v[j] = wj
    u = -a.clone()
    for j in range(m):
        above = rows < j
        u[above] = u[above] + SY[j, above] * v[j]
    return torch.cat([u * DHI, v])


def hg_compact(g, S, Y, SY, YY, DH, theta):
    """``small_solves``' H g: the compact form of Byrd, Nocedal and
    Schnabel (1994) from a = S^T g and b = Y^T g, with R the upper triangle
    of S.Y (diagonal D-hat); u by back substitution, p by forward
    substitution, both as column sweeps, then H g = g / theta + S p -
    Y u / theta in one pass."""
    m = DH.shape[0]
    gamma = 1.0 / theta
    DHI = 1.0 / DH
    rows = torch.arange(m)
    a = S @ g
    b = Y @ g
    for k in range(m - 1, -1, -1):
        uk = a[k] * DHI[k]
        above = rows < k
        a[above] = a[above] - SY[above, k] * uk
        a[k] = uk
    u = a
    w = DH * u + gamma * (YY @ u) - gamma * b
    for k in range(m):
        pk = w[k] * DHI[k]
        below = rows > k
        w[below] = w[below] - SY[k, below] * pk
        w[k] = pk
    return gamma * g + w @ S - gamma * (u @ Y)
