"""Torch models of the algebra the Newton-CG kernel K4
(``optimization_solvers_tpu_torch/ops/csrc/newton_cg.cu``) reformulates,
held bit for bit against the earlier form, NaN and infinite inputs
included:

* the Rosenbrock Hessian's coefficients, computed once per Newton step
  (the diagonal ``hess_diag``, ``-400 x_i`` toward coordinate i + 1 and
  ``-400 x_{i-1}`` toward i - 1) and applied to each CG direction, against
  ``hvp`` recomputing them from x for every product (``objectives.cuh``);
* the product of the CG direction p itself against the masked operand
  ``p * fr``: over whole truncated CG solves (the kernel's loop: the
  Steihaug exit, the restart, the Eisenstat-Walker stop), every iterate of
  both forms is the same, because R, P and the masked products stay +-0 or
  NaN on the bound-active coordinates (fr = 0), where ``p * 0`` is p.

Both forms are written with the kernel's operations in the kernel's
order; the sums are ``torch.sum`` in both, so only the reformulation
differs."""

import numpy as np
import pytest
import torch

DTYPES = (torch.float32, torch.float64)


def hess_diag(x):
    """``Rosenbrock::hess_diag`` for every coordinate of x (B, n)."""
    n = x.shape[-1]
    h = torch.zeros_like(x)
    a = x[:, 1:] - x[:, :-1] * x[:, :-1]
    h[:, :-1] = 800.0 * x[:, :-1] * x[:, :-1] - 400.0 * a + 2.0
    if n > 1:
        h[:, 1:] = h[:, 1:] + 200.0
    return h


def hvp_recomputed(x, v):
    """``Rosenbrock::hvp``: ``o = H_ii v_i``, then ``+ (-400 x_i) v_{i+1}``,
    then ``+ (-400 x_{i-1}) v_{i-1}``."""
    o = hess_diag(x) * v
    o[:, :-1] = o[:, :-1] + (-400.0 * x[:, :-1]) * v[:, 1:]
    o[:, 1:] = o[:, 1:] + (-400.0 * x[:, :-1]) * v[:, :-1]
    return o


def coefficients(x):
    """The kernel's per-Newton-step coefficients (``prepare``)."""
    up = torch.zeros_like(x)
    dn = torch.zeros_like(x)
    up[:, :-1] = -400.0 * x[:, :-1]
    dn[:, 1:] = -400.0 * x[:, :-1]
    return hess_diag(x), up, dn


def hvp_hoisted(coef, v):
    """The kernel's product on the coefficients (``product``)."""
    diag, up, dn = coef
    o = diag * v
    o[:, :-1] = o[:, :-1] + up[:, :-1] * v[:, 1:]
    o[:, 1:] = o[:, 1:] + dn[:, 1:] * v[:, :-1]
    return o


def same_bits(a, b):
    """NaN at the same places, and the same bits everywhere else (signed
    zeros and infinities included)."""
    nan = torch.isnan(a)
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(bits), b[~nan].view(bits)))


def inputs(dtype, B=64, n=9, seed=0, special=True):
    """x, v, g and a free mask with bound-active coordinates; with
    ``special`` some entries of x, v and g are NaN, +-inf, +-0 or near the
    type's overflow."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, (B, n))
    v = rng.standard_normal((B, n))
    g = rng.standard_normal((B, n)) * 10.0 ** rng.randint(-3, 4, (B, n))
    fr = (rng.uniform(size=(B, n)) > 0.3).astype(np.float64)
    if special:
        big = 1e19 if dtype == torch.float32 else 1e150
        pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, big, -big])
        for arr in (x, v, g):
            hit = rng.uniform(size=arr.shape) < 0.08
            arr[hit] = rng.choice(pool, hit.sum())
    return tuple(torch.tensor(a, dtype=dtype) for a in (x, v, g, fr))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("special", [False, True])
def test_hoisted_coefficients_equal_hvp(dtype, special):
    x, v, _, _ = inputs(dtype, special=special)
    coef = coefficients(x)
    for k in range(4):       # one Newton step's coefficients, many products
        vk = v.roll(k, dims=0) * (1.0 + k)
        assert same_bits(hvp_hoisted(coef, vk), hvp_recomputed(x, vk))


def cg(x, g, fr, eps, cg_max, masked):
    """The kernel's truncated CG on the free subspace (``newton_cg.cu``),
    every instance masked by its own done flag; ``masked``: the product of
    ``p * fr`` with the recomputed coefficients (the earlier form), else of
    p with the hoisted ones.  Returns every iterate."""
    gF = g * fr
    gn2 = (gF * gF).sum(-1)
    gn = torch.sqrt(gn2)
    eta = torch.minimum(torch.sqrt(torch.maximum(gn, torch.zeros_like(gn))),
                        torch.full_like(gn, 0.5))
    e = eta * gn
    rtol2 = e * e
    D = torch.zeros_like(g)
    R = gF.clone()
    P = -gF
    rr = gn2.clone()
    done = gn2 <= rtol2
    steps = torch.zeros_like(gn2)
    coef = coefficients(x)
    trace = []
    for _ in range(cg_max):
        q = (hvp_recomputed(x, P * fr) if masked else hvp_hoisted(coef, P)) * fr
        pq = (P * q).sum(-1)
        pp = (P * P).sum(-1)
        negc = pq <= eps * pp
        restart = negc & (steps == 0)
        alpha = torch.where(negc, torch.zeros_like(pq), rr / pq)
        dv = torch.where(restart[:, None], -(g * fr), D)
        Dn = dv + alpha[:, None] * P
        Rn = R + alpha[:, None] * q
        rr_new = (Rn * Rn).sum(-1)
        beta = rr_new / torch.maximum(rr, torch.full_like(rr, eps))
        step = ~done & ~negc
        Pn = torch.where(step[:, None], -Rn + beta[:, None] * P, P)
        live = ~done[:, None]
        D = torch.where(live, Dn, D)
        R = torch.where(live, Rn, R)
        P = torch.where(live, Pn, P)
        rr = torch.where(step, rr_new, rr)
        steps = steps + step.to(steps.dtype)
        done = done | negc | (rr_new <= rtol2)
        trace.append((q, pq, pp, D, R, P, rr))
    return trace


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(4))
def test_unmasked_operand_equals_masked(dtype, seed):
    x, _, g, fr = inputs(dtype, B=256, n=12, seed=seed)
    eps = float(torch.finfo(dtype).eps)
    old = cg(x, g, fr, eps, 12, masked=True)
    new = cg(x, g, fr, eps, 12, masked=False)
    for a, b in zip(old, new):
        for u, v in zip(a, b):
            assert same_bits(u, v)
    # the invariant behind it: on the bound-active coordinates R and P are
    # +-0 or NaN after every step
    for _, _, _, _, R, P, _ in new:
        for V in (R, P):
            off = V[fr == 0]
            assert bool(((off == 0) | torch.isnan(off)).all())
