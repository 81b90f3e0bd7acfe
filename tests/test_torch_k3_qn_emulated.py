"""K3's quasi-Newton form on the CPU: its own source
(``ops/csrc/driver_qn.cu`` on ``driver.cuh``: L-BFGS, and the first-order
methods with a Wolfe-family search, one warp per instance) built with the
host compiler against the warp emulator (``tests/_torch_warp_emulator.py``)
and held against the plain version ``fused_minimize_plain`` in float64:
status, iterations and trials (``nfev``) equal, x within 1e-9.  Each case
runs twice, the warps of a block taking turns lowest first and then
highest first, and must give the same bits both times.

The cases: every entry of ``k3_qn_geometries()`` that this form runs (its
first rows, 20 iterations); L-BFGS + Hager-Zhang on Rosenbrock at n = 100,
m = 10, long enough that the ring of pairs wraps; Rosenbrock-8 starts
whose More-Thuente search leaves x where it was (the zero-progress repair
drops the model: the pairs' slots keep their stale s and y, and the next
accepted pairs refill the ring over them); m = 1 and 32 under every
search family; and m = 33, where the two-loop recursion runs.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k3_qn_geometries
from optimization_solvers_tpu_torch import linesearch as ls, problems, solvers
from optimization_solvers_tpu_torch.ops import fused_driver

ROWS, ITERS, SEEDS, X_ATOL = 4, 20, (1, 2), 1e-9
CASES = sorted(
    name for name, g in k3_qn_geometries().items()
    if fused_driver.build_spec(g["method"], g["search"]).method
    not in fused_driver.DENSE_METHODS)
# RandomState(5) uniform(-2, 2) Rosenbrock-8 starts (rows of a draw of 64)
# whose L-BFGS + More-Thuente step leaves x unchanged at iteration 14 (m =
# 10, after the ring has wrapped) or 9 and 13 (m = 2), after which every
# pair of the next 12 iterations is accepted; the iterations each case
# runs (past 22 the m = 10 start is chaotic: x moves by more than X_ATOL
# under rounding)
REPAIRED = {10: ([3], 22), 2: ([44, 61], 30)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k3(tmp_path_factory):
    return emulator.build_k3(str(tmp_path_factory.mktemp("k3_qn_emulated")))


def tensors(*arrays):
    return tuple(None if a is None else torch.as_tensor(
        np.asarray(a, np.float64)) for a in arrays)


def held(k3, method, search, obj, x0, lo, up, data, kw):
    spec = fused_driver.build_spec(method, search)
    assert spec.method not in fused_driver.DENSE_METHODS
    runs = [emulator.driver_solve(k3, method, search, obj, x0, lo, up, data,
                                  seed=seed, **kw) for seed in SEEDS]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    x, _, it, st, nfev = runs[0]
    xp, _, itp, stp, nfevp = fused_driver._solve_plain(
        spec, obj, x0, lo, up, data, kw["max_iter"], kw["max_iter_ls"])
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    finite = torch.isfinite(x).all(-1)
    assert (x - xp)[finite].abs().max().item() <= X_ATOL
    return it


@pytest.mark.parametrize("name", CASES)
def test_emulated_qn_form_matches_plain(name, k3):
    g = k3_qn_geometries()[name]
    lo, up = g["lower"], g["upper"]
    if lo is not None and np.ndim(lo) == 2:
        lo, up = lo[:ROWS], up[:ROWS]
    x0, lo, up = tensors(g["x0"][:ROWS], lo, up)
    held(k3, g["method"], g["search"], g["objective"], x0, lo, up,
         tensors(*g["data"]),
         dict(max_iter=min(g["max_iter"], ITERS),
              max_iter_ls=g["max_iter_ls"]))


def test_emulated_lbfgs_ring_wraps_at_width(k3):
    """L-BFGS (m = 10) + Hager-Zhang on Rosenbrock-100, the starts of
    chip_smoke.py's phase 16, 16 iterations: every pair is accepted, so
    the ring of 10 slots wraps."""
    (x0,) = tensors(np.random.RandomState(42).uniform(-2, 2, (2, 100)))
    it = held(k3, solvers.LBFGS(tol=1e-4, m=10), ls.HagerZhang(),
              problems.rosenbrock(), x0, None, None, (),
              dict(max_iter=16, max_iter_ls=40))
    assert (it == 16).all()


@pytest.mark.parametrize("m", sorted(REPAIRED))
def test_emulated_lbfgs_refills_over_stale_slots(m, k3):
    rows, iters = REPAIRED[m]
    x0 = np.random.RandomState(5).uniform(-2, 2, (64, 8))[rows]
    held(k3, solvers.LBFGS(tol=1e-10, m=m), ls.MoreThuente(),
         problems.rosenbrock(), *tensors(x0, None, None), (),
         dict(max_iter=iters, max_iter_ls=40))


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("search", ["HagerZhang", "MoreThuente",
                                    "StrongWolfe", "BackTracking"])
def test_emulated_lbfgs_memory_edges(m, search, k3):
    """The compact form at one pair and at a warp's 32 (every lane a row
    of the algebra), under each search family (BackTracking: value-only
    trials, so the step is evaluated), Rosenbrock-8, 15 iterations."""
    x0 = np.random.RandomState(m).uniform(-2, 2, (4, 8))
    held(k3, solvers.LBFGS(tol=1e-10, m=m), getattr(ls, search)(),
         problems.rosenbrock(), *tensors(x0, None, None), (),
         dict(max_iter=15, max_iter_ls=40))


def test_emulated_lbfgs_two_loop_past_the_lanes(k3):
    """m = 33 pairs are more than a warp's lanes hold: the two-loop
    recursion runs (Rosenbrock-8, Hager-Zhang, 40 iterations: the ring
    fills)."""
    x0 = np.random.RandomState(1).uniform(-2, 2, (3, 8))
    held(k3, solvers.LBFGS(tol=1e-10, m=33), ls.HagerZhang(),
         problems.rosenbrock(), *tensors(x0, None, None), (),
         dict(max_iter=40, max_iter_ls=40))


def test_shared_memory_mirror_matches_the_source(k3):
    """The route's fit (``fused_driver.smem_per_instance``) is the
    source's ``work_elems``: the compact form's tables where they fit
    beside the two-loop layout and m <= 32, else that layout alone, so
    every width the form took keeps fitting."""
    for n in (1, 31, 100, 1000, 1066, 1067, 1075, 1076, 2152, 2153, 4150):
        for ring in (0, 10):
            for m in (0, 1, 10, 20, 32, 33):
                for itemsize in (4, 8):
                    for rows in (0, 40, 512):
                        assert fused_driver.smem_per_instance(
                            n, ring, itemsize, m, rows=rows) == (
                                k3.driver_smem_per_warp(n, ring, m, rows,
                                                        itemsize)), (
                            n, ring, m, itemsize, rows)
    # float64, m = 10: the tables fit up to n = 1,066, the two-loop layout
    # up to 1,075
    assert fused_driver.compact_fits(1066, 0, 8, 10)
    assert not fused_driver.compact_fits(1067, 0, 8, 10)
    assert fused_driver.fits(1075, 0, 8, 10)
    assert not fused_driver.fits(1076, 0, 8, 10)
