"""Torch models of the direction of the CUDA kernel K7
(``optimization_solvers_tpu_torch/ops/csrc/lbfgs_fused.cu``): the compact
form of H g on the ring of m slots, lane by lane in the kernel's order of
operations, and the two-loop recursion it replaces, as the plain version
``lbfgs_solve_plain`` (``ops/fused_lbfgs.py``) runs it.  The kernel cannot
run on the CPU at speed; these models let the tests hold the
reformulation against the two-loop on rings with rejected (zeroed) slots.

A ring is ``S``, ``Y`` (m, n) by slot, ``valid`` (m,) 0/1 by slot (a
rejected pair's slot is zeroed and invalid) and ``head``, the slot the
next pair is written to: chronological row q (0 oldest) lies at slot
``(head + q) % m``.
"""

import numpy as np
import torch


def two_loop(S, Y, valid, gamma, g, head):
    """``d = -H g`` by the two-loop recursion of ``lbfgs_solve_plain``,
    newest to oldest over ``(head - 1 - j) % m`` and back; an invalid slot
    contributes 0."""
    m = S.shape[0]
    rho = torch.where(valid > 0, 1.0 / (S * Y).sum(-1), torch.zeros(()))
    q = g
    alphas = [None] * m
    for j in range(m):
        idx = (head - 1 - j) % m
        a = rho[idx] * torch.sum(S[idx] * q) * valid[idx]
        q = q - a * Y[idx]
        alphas[j] = a
    r = gamma * q
    for j in range(m - 1, -1, -1):
        idx = (head - 1 - j) % m
        b = rho[idx] * torch.sum(Y[idx] * r) * valid[idx]
        r = r + (alphas[j] - b) * S[idx]
    return -r


def compact(S, Y, valid, gamma, g, head):
    """``d = -H g`` as the kernel forms it: the tables ``SY[k, h] = s_k .
    y_h`` and ``YY`` and the sums ``S^T g``, ``Y^T g`` by slot; on lane q
    (chronological row q, slot sq) ``R_qq = s_q . y_q`` (1 on an invalid
    slot) and its reciprocal, ``u = R^-1 S^T g`` by a column sweep from the
    newest row, ``p = R^-T (D u + gamma (Y^T Y u - Y^T g))`` by a sweep from
    the oldest; then per coordinate ``d = -(gamma (g - sum_k Y_k u_k) +
    sum_k S_k p_k)`` over the slots in order.  Returns d and u, p by
    slot."""
    m = S.shape[0]
    SY, YY = S @ Y.T, Y @ Y.T
    SG, YG = S @ g, Y @ g
    slot = [(head + q) % m for q in range(m)]
    dq = [SY[s, s] if valid[s] != 0 else torch.ones((), dtype=g.dtype)
          for s in slot]
    rinv = [1.0 / d for d in dq]
    u = [SG[s].clone() for s in slot]
    for c in range(m - 1, -1, -1):
        uc = u[c] * rinv[c]
        for q in range(m):
            if q == c:
                u[q] = uc
            elif q < c:
                u[q] = u[q] - SY[slot[q], slot[c]] * uc
    p = []
    for q in range(m):
        yu = torch.zeros((), dtype=g.dtype)
        for r in range(m):
            yu = yu + YY[slot[q], slot[r]] * u[r]
        p.append(dq[q] * u[q] + gamma * (yu - YG[slot[q]]))
    for c in range(m):
        pc = p[c] * rinv[c]
        for q in range(m):
            if q == c:
                p[q] = pc
            elif q > c:
                p[q] = p[q] - SY[slot[c], slot[q]] * pc
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


def ring(m, n, rejected, head, seed, dtype=torch.float64):
    """A ring of m slots written by ``m`` accepted-or-rejected steps of a
    convex quadratic's pairs (y = A s, so s.y > 0): the slots in
    ``rejected`` zeroed and invalid; returns ``(S, Y, valid, gamma, g)``
    with gamma the newest accepted pair's s.y / y.y (1 if none)."""
    rng = np.random.RandomState(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T / n + np.eye(n)
    S = np.zeros((m, n))
    Y = np.zeros((m, n))
    valid = np.zeros(m)
    gamma = 1.0
    for q in range(m):          # chronological: slot (head + q) % m
        s_ = rng.standard_normal(n)
        k = (head + q) % m
        if k in rejected:
            continue
        S[k], Y[k], valid[k] = s_, A @ s_, 1.0
        gamma = float(S[k] @ Y[k] / (Y[k] @ Y[k]))
    g = rng.standard_normal(n)
    return tuple(torch.tensor(a, dtype=dtype) for a in (S, Y, valid)) + (
        gamma, torch.tensor(g, dtype=dtype))
