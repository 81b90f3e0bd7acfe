"""Torch models of L-BFGS's direction in K3's quasi-Newton form
(``optimization_solvers_tpu_torch/ops/csrc/driver.cuh``): the compact form
of H g on K3's ring of m slots, lane by lane in the kernel's order of
operations, and the two-loop recursion it replaces, as the plain version
``fused_minimize_plain`` (``ops/fused_driver.py``) runs it.  The kernel
cannot run on the CPU at speed; these models let the tests hold the
reformulation against the two-loop on every ring K3 can hold.

K3's ring is not K7's (``tests/_torch_k7_algebra.py``).  ``head`` is the
slot the next accepted pair is written to and moves only when a pair is
accepted, so the oldest pair lies at ``head`` and chronological row q at
slot ``(head + q) % m``.  A reset (the descent safeguard, the
zero-progress repair) zeroes every slot's rho and ``valid`` but leaves S
and Y as they were: an invalid slot holds a stale, non-zero pair, so the
compact form masks its sums by multiplying them by ``valid``.
"""

import numpy as np
import torch


def two_loop(S, Y, rho, valid, gamma, g, head):
    """``d = -H g`` by the two-loop recursion of ``fused_minimize_plain``
    (its shift's slot j is chronological row j), newest to oldest and
    back; an invalid slot contributes ``rho * dot * valid = 0``, or NaN
    where its dot overflowed."""
    m = S.shape[0]
    q = g
    alphas = [None] * m
    for j in range(m - 1, -1, -1):
        k = (head + j) % m
        a = rho[k] * torch.sum(S[k] * q) * valid[k]
        q = q - a * Y[k]
        alphas[j] = a
    r = gamma * q
    for j in range(m):
        k = (head + j) % m
        b = rho[k] * torch.sum(Y[k] * r) * valid[k]
        r = r + (alphas[j] - b) * S[k]
    return -r


def compact(S, Y, valid, gamma, g, head):
    """``d = -H g`` as the kernel forms it: the tables ``SY[k, h] = s_k .
    y_h`` and ``YY`` and the sums ``S^T g``, ``Y^T g`` by slot; on lane q
    (chronological row q, slot sq, v its valid) ``R_qq = s_q . y_q`` (1 on
    an invalid slot), ``u = R^-1 (v S^T g)`` by a column sweep from the
    newest row, the row's table entries multiplied by v; ``p = R^-T (D u +
    gamma v (Y^T Y u - Y^T g))`` by a sweep from the oldest; then per
    coordinate ``d = -(gamma (g - sum_k Y_k u_k) + sum_k S_k p_k)`` over
    the slots in order.  Returns d and u, p by slot.  The m x m algebra
    runs on Python floats: IEEE doubles, as the lanes' float64."""
    m = S.shape[0]
    SY, YY = (S @ Y.T).tolist(), (Y @ Y.T).tolist()
    SG, YG = (S @ g).tolist(), (Y @ g).tolist()
    slot = [(head + q) % m for q in range(m)]
    v = [float(valid[s]) for s in slot]
    dq = [SY[s][s] if valid[s] != 0 else 1.0 for s in slot]
    rinv = [1.0 / d for d in dq]
    u = [v[q] * SG[slot[q]] for q in range(m)]
    for c in range(m - 1, -1, -1):
        uc = u[c] * rinv[c]
        for q in range(m):
            if q == c:
                u[q] = uc
            elif q < c:
                u[q] = u[q] - v[q] * SY[slot[q]][slot[c]] * uc
    p = []
    for q in range(m):
        yu = 0.0
        for r in range(m):
            yu = yu + YY[slot[q]][slot[r]] * u[r]
        p.append(dq[q] * u[q] + gamma * (v[q] * (yu - YG[slot[q]])))
    for c in range(m):
        pc = p[c] * rinv[c]
        for q in range(m):
            if q == c:
                p[q] = pc
            elif q > c:
                p[q] = p[q] - v[q] * SY[slot[c]][slot[q]] * pc
    U = torch.zeros(m, dtype=g.dtype)
    P = torch.zeros(m, dtype=g.dtype)
    for q in range(m):
        U[slot[q]] = u[q]
        P[slot[q]] = p[q]
    yu = torch.zeros_like(g)
    sp = torch.zeros_like(g)
    for k in range(m):
        yu = yu + Y[k] * U[k]
        sp = sp + S[k] * P[k]
    return -(gamma * (g - yu) + sp), U, P


def ring(m, n, stale, head, seed, dtype=torch.float64, huge=None,
         g_scale=1.0):
    """A full ring of m slots holding pairs of a convex quadratic (y = A s,
    so s.y > 0), chronological row q at slot ``(head + q) % m``; the slots
    in ``stale`` invalid (rho and valid 0, their pairs kept).  ``huge``: a
    slot whose stale pair is replaced by 1e308 in every entry, so that its
    sums with the gradient overflow.  Returns ``(S, Y, rho, valid, gamma,
    g)``, gamma the newest valid pair's s.y / y.y (1 if none), g scaled by
    ``g_scale``."""
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.eye(n)
    S = np.zeros((m, n))
    Y = np.zeros((m, n))
    rho = np.zeros(m)
    valid = np.zeros(m)
    gamma = 1.0
    for q in range(m):
        k = (head + q) % m
        S[k] = rng.standard_normal(n)
        Y[k] = A @ S[k]
        if k in stale:
            continue
        rho[k] = 1.0 / (S[k] @ Y[k])
        valid[k] = 1.0
        gamma = float(S[k] @ Y[k] / (Y[k] @ Y[k]))
    if huge is not None:
        S[huge] = Y[huge] = 1e308
    g = g_scale * rng.standard_normal(n)
    return tuple(torch.tensor(a, dtype=dtype) for a in (S, Y, rho, valid)) + (
        gamma, torch.tensor(g, dtype=dtype))
