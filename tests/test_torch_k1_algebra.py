"""The reformulated small algebra of the CUDA kernel K1 against the plain
version's forms, on the CPU (``tests/_torch_k1_algebra.py`` models the
kernel lane by lane), and K1's shared-memory fit.

Each model is held to the plain form at 1e-12 relative in float64, on
random valid histories with m 1, 5 and 20 and some slots invalid: the
transposed butterfly against per-sum reductions, the lane-parallel M^{-1}
(reciprocals of the pivots and of D-hat) and the register Cholesky against
``mid_solve`` and ``_chol``, and the compact form of H g against the
two-loop recursion.
"""

import numpy as np
import pytest
import torch

from _torch_geometries import k1_geometries
from _torch_k1_algebra import (chol_registers, hg_compact, history,
                               lane_partials, mid_solve_lanes,
                               mid_solve_plain, middle_plain, schur_kernel,
                               two_loop_plain, warp_sum, warp_sums)
from optimization_solvers_tpu_torch.ops import fused_lbfgsb

RTOL = 1e-12
EPS = fused_lbfgsb.EPS_MACH[torch.float64]
# (m, valid slots): a full ring, a ring after a restart, one pair
HISTORIES = [(1, 1), (5, 5), (5, 3), (20, 20), (20, 7)]


def close(a, b, rtol=RTOL):
    return (a - b).abs().max().item() <= rtol * max(b.abs().max().item(), 1.0)


@pytest.mark.parametrize("K", [4, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_transposed_butterfly_matches_per_sum_reductions(K, seed):
    """Sum j of ``warp_sums<K>`` (on lanes j * 32 / K ..) equals the plain
    reduction over the lanes and the one-butterfly-per-sum ``warp_sum``,
    and every lane holding it holds the same bits."""
    v = torch.tensor(np.random.RandomState(seed).standard_normal((32, K)))
    r = warp_sums(v)
    per = 32 // K
    for j in range(K):
        held = r[j * per:(j + 1) * per]
        assert torch.equal(held, held[:1].expand(per))
        assert close(held[:1], v[:, j].sum()[None])
        assert close(held[:1], warp_sum(v[:, j])[:1])


def test_transposed_butterfly_pairs_alike_at_every_width():
    """The pairing tree is the same for every K, so a sum gets the same bits
    in a 16-wide and a 32-wide butterfly: the kernel's step pass computes the
    next gate's W^T g in the latter, the gate's own pass in the former."""
    rng = np.random.RandomState(3)
    cols = torch.tensor(rng.standard_normal((32, 11)))
    v16 = torch.zeros((32, 16), dtype=cols.dtype)
    v32 = torch.tensor(rng.standard_normal((32, 32)))
    v16[:, :11] = cols
    off = 17                     # other positions, among other sums
    v32[:, off:off + 11] = cols
    r16, r32 = warp_sums(v16), warp_sums(v32)
    for j in range(11):
        assert torch.equal(r16[2 * j], r32[off + j])


@pytest.mark.parametrize("m,nvalid", HISTORIES)
def test_lane_dot_products_reduce_to_w_transpose_v(m, nvalid):
    """W^T g as the kernel's pass forms it (per-lane partials over the
    lane's coordinates, then one transposed butterfly) against S g, Y g."""
    n = 70
    S, Y, *_, g = history(m, n, nvalid, seed=m)
    rows = torch.cat([Y, S])
    K = 16 if 2 * m <= 16 else 32
    for c0 in range(0, 2 * m, K):
        block = rows[c0:c0 + K]
        v = torch.zeros((32, K), dtype=g.dtype)
        v[:, :block.shape[0]] = lane_partials(block, g)
        r = warp_sums(v)[::32 // K][:block.shape[0]]
        assert close(r, block @ g)


@pytest.mark.parametrize("m,nvalid", HISTORIES)
def test_register_cholesky_matches_the_plain_factor(m, nvalid):
    *_, SY, SS, YY, DH, valid, theta, g = history(m, 30, nvalid, seed=10 + m)
    _, Sch, Lsch = middle_plain(SY, SS, DH, valid, theta, EPS)
    K = schur_kernel(SY, SS, DH, valid, theta)
    assert close(K, Sch)
    assert close(chol_registers(K, EPS), Lsch)


@pytest.mark.parametrize("m,nvalid", HISTORIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_mid_solve_on_lanes_matches_the_plain_form(m, nvalid, seed):
    """M^{-1} [a; b] from the kernel's lane-parallel sweeps (reciprocals
    taken once) against the plain version's mid_solve, for the gate's p =
    -[Y^T g; theta S^T g] and for a random right-hand side."""
    S, Y, SY, SS, YY, DH, valid, theta, g = history(m, 40, nvalid,
                                                    seed=20 + m + seed)
    Lc, Sch, Lsch = middle_plain(SY, SS, DH, valid, theta, EPS)
    L = chol_registers(schur_kernel(SY, SS, DH, valid, theta), EPS)
    p = -torch.cat([Y @ g, theta * (S @ g)])
    rhs = torch.tensor(np.random.RandomState(seed).standard_normal(2 * m))
    for ab in (p, rhs):
        assert close(mid_solve_lanes(ab, SY, L, DH),
                     mid_solve_plain(ab, DH, Lc, Lsch))


@pytest.mark.parametrize("m,nvalid", HISTORIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_hg_matches_the_two_loop_recursion(m, nvalid, seed):
    S, Y, SY, SS, YY, DH, valid, theta, g = history(m, 50, nvalid,
                                                    seed=40 + m + seed)
    assert close(hg_compact(g, S, Y, SY, YY, DH, theta),
                 two_loop_plain(g, S, Y, DH, valid, theta))


def test_compact_hg_without_pairs_is_the_scaled_gradient():
    S, Y, SY, SS, YY, DH, valid, theta, g = history(5, 12, 0, seed=7)
    assert torch.equal(hg_compact(g, S, Y, SY, YY, DH, theta), g)


# ---- the shared-memory fit ---------------------------------------------------

# the largest n the kernel took before its redesign ((2m+7) n + 6 m^2 + 17 m
# elements per instance), by (itemsize, m)
FIT_BEFORE = {(4, 5): 3404, (4, 10): 2123, (4, 20): 1178,
              (8, 5): 1695, (8, 10): 1047, (8, 20): 559}


@pytest.mark.parametrize("itemsize,m", sorted(FIT_BEFORE))
def test_largest_width_that_fits_is_not_lower(itemsize, m):
    n = FIT_BEFORE[itemsize, m]
    assert fused_lbfgsb.fits(n, m, itemsize)
    while fused_lbfgsb.fits(n + 1, m, itemsize):
        n += 1
    assert n >= FIT_BEFORE[itemsize, m]
    assert fused_lbfgsb.smem_per_instance(n + 1, m, itemsize) > (
        fused_lbfgsb.SMEM_PER_BLOCK)


def test_headline_and_geometries_fit():
    assert fused_lbfgsb.fits(100, 5, 4)
    assert fused_lbfgsb.smem_per_instance(100, 5, 4) == 7088
    for name, (_, x0, *_rest) in k1_geometries().items():
        n = np.asarray(x0).shape[-1]
        for itemsize in (4, 8):
            assert fused_lbfgsb.fits(n, 5, itemsize), (name, itemsize)
