"""The dense slabs of K3's dense form and K9 (``ops/csrc/dense_slab.cuh``),
modelled in PyTorch on the CPU and held against the plain versions.

The symmetric kinds (BFGS, DFP, SR1; K9's BFGS) keep the packed upper
triangle of an instance's matrix; Broyden keeps the full matrix, rows of
the odd stride ``n | 1``.  The model here follows the header: its index
maps, its product (thread k sums output k over m = 0 .. n-1 in order,
element (m, k) read from row m for m < k and from row k after) and its
element-wise update (the pending reset, gamma I of ``scale_b0``, the
kind's term where the update is taken, I where the restart resets).  Held
bit for bit, in float32 and float64, against the plain versions' full
updates (copied below from ``fused_driver._solve_plain`` and
``fused_bfgs.bfgs_solve_plain``, so that the references and these
expected values never change together): an element of the triangle gets
the value that both (i, j) and (j, i) of the full update get.  The model runs without fused
multiply-adds, as the plain versions do; on the card the kernels' sums
contract, which moves rounding only.
"""

import numpy as np
import pytest
import torch

from optimization_solvers_tpu_torch.ops import fused_bfgs, fused_driver

DTYPES = [torch.float32, torch.float64]
SYMMETRIC = {"bfgs": 0, "dfp": 1, "sr1": 3}
BROYDEN = 2


def full_slab_update(upd, Bc, s, By, *, rho=None, coeff=None, sy=None,
                     yBy=None, Bts=None, denom=None):
    """The rank-one or rank-two term of the dense update kind ``upd`` added
    to the full slabs ``Bc``, ``(B, n, n)``: the expressions of
    ``fused_driver._solve_plain``'s ``new_slab`` (``By`` is B y, B^T y for
    the symmetric kinds; ``Bts`` Broyden's B^T s)."""
    col = (slice(None), None, slice(None))       # v_j along a row
    row = (slice(None), slice(None), None)       # v_i down a column
    if upd == 0:                                 # bfgs
        return (Bc - rho[:, None, None] * (s[row] * By[col]
                                           + By[row] * s[col])
                + coeff[:, None, None] * (s[row] * s[col]))
    if upd == 1:                                 # dfp
        return (Bc + (s[row] * s[col]) / sy[:, None, None]
                - (By[row] * By[col]) / yBy[:, None, None])
    if upd == 2:                                 # broyden
        return Bc + ((s - By)[row] * Bts[col]) / sy[:, None, None]
    shy = s - By                                 # sr1
    return Bc + (shy[row] * shy[col]) / denom[:, None, None]


def bfgs_update_full(Bm, s, By, rho, coeff):
    """K9's update of the full matrices: the expressions of
    ``fused_bfgs.bfgs_solve_plain``."""
    si, byi = s[:, :, None], By[:, :, None]
    sj, byj = s[:, None, :], By[:, None, :]
    return (Bm - rho[:, None, None] * (si * byj + byi * sj)
            + coeff[:, None, None] * (si * sj))


def packed_row(i, n):
    """The first element of packed row i (``packed_row``)."""
    return i * n - i * (i - 1) // 2


def packed_index(n):
    """(n, n): the packed element that holds (i, j) and (j, i)."""
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    return lo * n - lo * (lo - 1) // 2 + hi - lo


def pack(full):
    """The upper triangle of ``(n, n)`` matrices, row by row."""
    n = full.shape[-1]
    iu = torch.triu_indices(n, n)
    return full[..., iu[0], iu[1]]


def packed_mv(P, v):
    """``slab_mv`` on the packed layout: output k sums P(m, k) v[m] over m
    = 0 .. n-1, one multiply and one add at a time."""
    n = v.shape[-1]
    idx = packed_index(n)
    acc = torch.zeros_like(v)
    for m in range(n):
        acc = acc + P[..., idx[m]] * v[..., m:m + 1]
    return acc


def columns_mv(full, v):
    """The same sums over the full matrix by columns, in the same order."""
    acc = torch.zeros_like(v)
    for m in range(v.shape[-1]):
        acc = acc + full[..., m, :] * v[..., m:m + 1]
    return acc


def slab_update(kind, P, coords, s, by, bts, *, ok, reset, pending,
                scale_cond, gamma, rho, coeff, sy, yBy, shy_y):
    """``slab_update`` element by element: P holds the elements at
    ``coords`` = (i, j); the flags and scalars are per instance."""
    i, j = coords
    eye = (i == j).to(P.dtype)
    b = P
    b = torch.where(pending[:, None], eye, b)
    b = torch.where(scale_cond[:, None], gamma[:, None] * eye, b)
    si, sj, byi, byj = s[:, i], s[:, j], by[:, i], by[:, j]
    if kind == 0:
        cross = si * byj + byi * sj
        new = b - rho[:, None] * cross + coeff[:, None] * (si * sj)
    elif kind == 1:
        new = b + (si * sj) / sy[:, None] - (byi * byj) / yBy[:, None]
    elif kind == BROYDEN:
        new = b + ((si - byi) * bts[:, j]) / sy[:, None]
    else:
        new = b + ((si - byi) * (sj - byj)) / shy_y[:, None]
    out = torch.where(ok[:, None], new, b)
    return torch.where(reset[:, None], eye, out)


def random_pair(n, B, dtype, seed):
    """A symmetric positive B from a previous BFGS update of I, and a pair
    s, y with s.y > 0 for most instances."""
    rng = np.random.RandomState(seed)
    s0, y0 = (torch.tensor(rng.standard_normal((B, n)), dtype=dtype)
              for _ in range(2))
    y0 = y0 + 2.0 * s0
    eye = torch.eye(n, dtype=dtype).expand(B, n, n)
    sy0 = torch.sum(s0 * y0, -1)
    rho0 = 1.0 / sy0
    By0 = y0
    coeff0 = rho0 * rho0 * torch.sum(y0 * By0, -1) + rho0
    Bm = full_slab_update(0, eye, s0, By0, rho=rho0, coeff=coeff0)
    s, y = (torch.tensor(rng.standard_normal((B, n)), dtype=dtype)
            for _ in range(2))
    return Bm, s, y + s


@pytest.mark.parametrize("n", [1, 2, 7, 33, 100])
def test_packed_index_maps(n):
    """Row i starts at packed_row(i); the triangle's n (n + 1) / 2 elements
    are each taken once; the product's address recursion (col += n - m - 1
    from col = k) and row walk reach (m, k); Broyden's stride is odd and
    at least n."""
    idx = packed_index(n)
    iu = torch.triu_indices(n, n)
    assert torch.equal(idx[iu[0], iu[1]], torch.arange(n * (n + 1) // 2))
    assert torch.equal(idx, idx.T)
    for i in range(n):
        assert idx[i, i].item() == packed_row(i, n)
    for k in range(n):
        col = k
        for m in range(n):
            addr = col if m < k else packed_row(k, n) - k + m
            assert addr == idx[m, k].item()
            col += n - m - 1
    assert fused_driver.dense_slab_elems(n, 0) == n * (n + 1) // 2
    assert fused_driver.dense_slab_elems(n, BROYDEN) == n * (n | 1)
    assert (n | 1) % 2 == 1 and (n | 1) >= n
    assert fused_bfgs.slab_elems(n) == n * (n + 1) // 2


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n", [5, 33])
def test_packed_product_in_kernel_order(n, dtype):
    """B v from the triangle equals the full matrix's column sums in the
    same order bit for bit, and the library product to rounding."""
    Bm, s, y = random_pair(n, 3, dtype, n)
    assert torch.equal(Bm, Bm.transpose(1, 2))
    out = packed_mv(pack(Bm), y)
    assert torch.equal(out, columns_mv(Bm, y))
    torch.testing.assert_close(out, torch.matmul(Bm, y[:, :, None])[:, :, 0])


FORMS = ["plain", "pending", "scale_b0", "reset"]


def _full_update(kind, Bm, s, y, form):
    """The plain version's update of the full slabs (``qn_post_step``),
    with the flags of ``form``; returns the result and the per-instance
    inputs of the header's update."""
    B, n = s.shape
    dt = s.dtype
    eye = torch.eye(n, dtype=dt).expand(B, n, n)
    sy = torch.sum(s * y, -1)
    true = torch.ones(B, dtype=torch.bool)
    false = torch.zeros(B, dtype=torch.bool)
    pending = true if form == "pending" else false
    scale_cond = true if form == "scale_b0" else false
    gamma = sy / torch.sum(y * y, -1)
    ok = false if form == "reset" else true
    reset = true if form == "reset" else false
    By = fused_driver._matvec(Bm, y, transpose=kind != BROYDEN)
    By = torch.where(scale_cond[:, None], gamma[:, None] * y, By)
    By = torch.where(pending[:, None], y, By)
    Bts = fused_driver._matvec(Bm, s, transpose=True)
    Bts = torch.where(scale_cond[:, None], gamma[:, None] * s, Bts)
    Bts = torch.where(pending[:, None], s, Bts)
    rho = 1.0 / sy
    yBy = torch.sum(y * By, -1)
    coeff = rho * rho * yBy + rho
    shy_y = torch.sum((s - By) * y, -1)
    terms = {0: dict(rho=rho, coeff=coeff), 1: dict(sy=sy, yBy=yBy),
             2: dict(sy=sy, Bts=Bts), 3: dict(denom=shy_y)}[kind]
    Bc = torch.where(pending[:, None, None], eye, Bm)
    Bc = torch.where(scale_cond[:, None, None], gamma[:, None, None] * eye,
                     Bc)
    out = torch.where(ok[:, None, None],
                      full_slab_update(kind, Bc, s, By, **terms), Bc)
    out = torch.where(reset[:, None, None], eye, out)
    flags = dict(ok=ok, reset=reset, pending=pending, scale_cond=scale_cond,
                 gamma=gamma, rho=rho, coeff=coeff, sy=sy, yBy=yBy,
                 shy_y=shy_y)
    return out, By, Bts, flags


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", sorted(SYMMETRIC))
def test_triangle_update_matches_the_full_update(kind, form, dtype):
    """BFGS, DFP and SR1 on the packed triangle, with the pending reset,
    scale_b0's gamma I and the restart's reset: bit for bit the plain
    version's full update, which stays exactly symmetric."""
    code = SYMMETRIC[kind]
    n = 9
    Bm, s, y = random_pair(n, 4, dtype, 7 + code)
    full, By, Bts, flags = _full_update(code, Bm, s, y, form)
    assert torch.equal(full, full.transpose(1, 2))
    iu = torch.triu_indices(n, n)
    tri = slab_update(code, pack(Bm), (iu[0], iu[1]), s, By, Bts, **flags)
    assert torch.equal(tri, pack(full))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("form", FORMS)
def test_broyden_full_slab_update_matches(form, dtype):
    """Broyden on the full slab of stride n | 1: every element of the rows,
    bit for bit the plain version's update; the padding column is never
    touched."""
    n = 8
    ld = n | 1
    Bm, s, y = random_pair(n, 3, dtype, 5)
    Bm = Bm + 0.1 * torch.triu(torch.ones(n, n, dtype=dtype), 1)  # not symmetric
    full, By, Bts, flags = _full_update(BROYDEN, Bm, s, y, form)
    P = torch.full((3, n * ld), -7.0, dtype=dtype)
    e = (torch.arange(n)[:, None] * ld + torch.arange(n)[None, :]).flatten()
    P[:, e] = Bm.reshape(3, -1)
    i, j = e // ld, e % ld
    P[:, e] = slab_update(BROYDEN, P[:, e], (i, j), s, By, Bts, **flags)
    assert torch.equal(P[:, e].reshape(3, n, n), full)
    pad = torch.ones(n * ld, dtype=torch.bool)
    pad[e] = False
    assert bool((P[:, pad] == -7.0).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_k9_triangle_update_matches_the_plain_update(dtype):
    """K9's update (the BFGS kind, taken) on the triangle: bit for bit the
    plain version's full update of ``bfgs_solve_plain``."""
    n = 12
    Bm, s, y = random_pair(n, 4, dtype, 3)
    By = torch.sum(Bm * y[:, None, :], dim=-1)
    rho = 1.0 / torch.sum(s * y, -1)
    coeff = rho * rho * torch.sum(y * By, -1) + rho
    full = bfgs_update_full(Bm, s, By, rho, coeff)
    assert torch.equal(full, full.transpose(1, 2))
    iu = torch.triu_indices(n, n)
    true = torch.ones(4, dtype=torch.bool)
    tri = slab_update(0, pack(Bm), (iu[0], iu[1]), s, By, None, ok=true,
                      reset=~true, pending=~true, scale_cond=~true,
                      gamma=torch.ones_like(rho), rho=rho, coeff=coeff,
                      sy=None, yBy=None, shy_y=None)
    assert torch.equal(tri, pack(full))


def test_fit_rules():
    """The placements the wrappers mirror (``dense_in_shared``,
    ``slab_in_shared``): config 2's width in float32 lies in shared memory
    for every kind; past the fit the workspace holds one slab per
    instance."""
    for kind in range(4):
        assert fused_driver.dense_in_shared(100, 0, 4, kind)
        assert not fused_driver.dense_in_shared(400, 0, 4, kind)
        assert fused_driver.workspace_elems(8, 400, fused_driver.QN, 0, 4,
                                            kind) == (
            8 * fused_driver.dense_slab_elems(400, kind))
    assert fused_bfgs.slab_in_shared(100, 4)
    assert fused_bfgs.workspace_elems(8, 100, 4) == 0
    assert not fused_bfgs.slab_in_shared(400, 4)
    # the widest float64 width the triangle fits beside the vectors
    assert fused_driver.dense_in_shared(233, 0, 8, 0)
    assert not fused_driver.dense_in_shared(234, 0, 8, 0)
    assert fused_bfgs.slab_in_shared(232, 8)
    assert not fused_bfgs.slab_in_shared(233, 8)
