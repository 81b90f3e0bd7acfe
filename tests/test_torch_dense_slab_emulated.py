"""The dense kernels' own sources on the CPU: K3's dense form
(``ops/csrc/driver_dense.cu``, one block of several warps per instance,
warp 0 posting block commands) and K9 (``ops/csrc/bfgs_fused.cu``), built
with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``: the warps of a block meet at block
barriers and take turns between them in a seeded order) and held against
their plain versions in float64: status and iteration counts equal, x
within 1e-9, on small geometries (n <= 12, B <= 4, 20 iterations; there
the products' outputs all fall to warp 0, the update's rows to every
warp), at config 2's width (every warp owns outputs of the products) and
at one width past the shared-memory fit (the slab in the workspace).
Each case runs twice, the warps taking turns between barriers lowest
first and then highest first, and must give the same bits both times: a
warp that read what another writes between the same two barriers shows
there (dropping the barrier after K9's direction pass fails the config-2
width case).  The fit rules the wrappers mirror are held against the
sources' own functions.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k3_qn_geometries, k9_geometries
from optimization_solvers_tpu_torch import linesearch as ls, problems, solvers
from optimization_solvers_tpu_torch.ops import fused_bfgs, fused_driver

ROWS, ITERS, SEEDS = 4, 20, (1, 2)
K3_CASES = sorted(
    name for name, g in k3_qn_geometries().items()
    if fused_driver.build_spec(g["method"], g["search"]).method
    in fused_driver.DENSE_METHODS and g["x0"].shape[1] <= 12)
K9_CASES = sorted(name for name, g in k9_geometries().items()
                  if g["kernel"] and g["x0"].shape[1] <= 12)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k3(tmp_path_factory):
    return emulator.build_k3(str(tmp_path_factory.mktemp("k3_emulated")))


@pytest.fixture(scope="module")
def k9(tmp_path_factory):
    return emulator.build_k9(str(tmp_path_factory.mktemp("k9_emulated")))


def tensors(*arrays):
    return tuple(None if a is None else torch.as_tensor(
        np.asarray(a, np.float64)) for a in arrays)


def same_bits(runs):
    return all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))


def held_k3(k3, method, search, obj, x0, lo, up, data, kw):
    runs = [emulator.driver_solve(k3, method, search, obj, x0, lo, up, data,
                                  seed=seed, **kw) for seed in SEEDS]
    assert same_bits(runs)
    x, _, it, st, nfev = runs[0]
    spec = fused_driver.build_spec(method, search)
    xp, _, itp, stp, nfevp = fused_driver._solve_plain(
        spec, obj, x0, lo, up, data, kw["max_iter"], kw["max_iter_ls"])
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    finite = torch.isfinite(x).all(-1)
    assert (x - xp)[finite].abs().max().item() <= 1e-9


@pytest.mark.parametrize("name", K3_CASES)
def test_emulated_dense_form_matches_plain(name, k3):
    g = k3_qn_geometries()[name]
    lo, up = g["lower"], g["upper"]
    if lo is not None and np.ndim(lo) == 2:
        lo, up = lo[:ROWS], up[:ROWS]
    x0, lo, up = tensors(g["x0"][:ROWS], lo, up)
    held_k3(k3, g["method"], g["search"], g["objective"], x0, lo, up,
            tensors(*g["data"]),
            dict(max_iter=min(g["max_iter"], ITERS),
                 max_iter_ls=g["max_iter_ls"]))


@pytest.mark.parametrize("n", [100, 240])
def test_emulated_dense_form_at_width(n, k3):
    """Config 2's method and search at its width (n = 100: every warp of
    the block owns outputs of the products) and past the shared-memory fit
    (n = 240 in float64: the triangle in the workspace), 4 iterations."""
    method = solvers.QuasiNewton(tol=1e-8, update="bfgs", scale_b0=True,
                                 restart_on_degeneracy=True)
    spec = fused_driver.build_spec(method, ls.MoreThuente())
    assert fused_driver.dense_in_shared(n, spec.ring, 8, spec.qn_update) == (
        n == 100)
    (x0,) = tensors(np.random.RandomState(2).uniform(-2, 2, (2, n)))
    held_k3(k3, method, ls.MoreThuente(), problems.rosenbrock(), x0, None,
            None, (), dict(max_iter=4, max_iter_ls=20))


def held_k9(k9, obj, x0, data, kw):
    runs = [emulator.bfgs_solve(k9, obj, x0, data, seed=seed, **kw)
            for seed in SEEDS]
    assert same_bits(runs)
    x, _, it, st, _, _ = runs[0]
    xp, _, itp, stp = fused_bfgs.bfgs_solve_plain(obj, x0, data, **kw)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert (x - xp).abs().max().item() <= 1e-9


@pytest.mark.parametrize("name", K9_CASES + ["rosenbrock_12"])
def test_emulated_k9_matches_plain(name, k9):
    if name == "rosenbrock_12":
        obj, data = problems.rosenbrock(), ()
        x0 = np.random.RandomState(0).uniform(-2, 2, (ROWS, 12))
        tol = 1e-5
    else:
        g = k9_geometries()[name]
        obj, data = g["kernel"]
        x0, tol = g["x0"][:ROWS], g["opts"]["tol"]
    held_k9(k9, obj, *tensors(x0), tensors(*data),
            dict(tol=tol, max_iter=ITERS, max_iter_ls=24, c1=1e-4))


@pytest.mark.parametrize("n", [100, 240])
def test_emulated_k9_at_width(n, k9):
    """Config 2's width and n = 240 (float64: the triangle in the
    workspace), 4 iterations."""
    assert fused_bfgs.slab_in_shared(n, 8) == (n == 100)
    (x0,) = tensors(np.random.RandomState(3).uniform(-2, 2, (2, n)))
    held_k9(k9, problems.rosenbrock(), x0, (),
            dict(tol=1e-5, max_iter=4, max_iter_ls=24, c1=1e-4))


def test_fit_rules_match_the_sources(k3, k9):
    """The wrappers' shared-memory and workspace mirrors equal the
    functions of ``driver.cu`` and ``bfgs_fused.cu`` compiled from the same
    sources, across both sides of each fit, with a log-sum-exp's z of
    ``rows`` elements (0: the other objectives; 40 and 512 move the
    fits)."""
    for n in (1, 31, 100, 166, 167, 233, 234, 237, 238, 333, 334, 1000):
        for itemsize in (4, 8):
            for rows in (0, 40, 512):
                for ring in (0, 10):
                    for kind in range(4):
                        assert fused_driver.smem_per_instance(
                            n, ring, itemsize, method=fused_driver.QN,
                            qn_update=kind, rows=rows) == k3.driver_smem_dense(
                                n, ring, kind, rows, itemsize)
                        for method in (fused_driver.QN, fused_driver.QNB,
                                       fused_driver.LBFGS, fused_driver.GD):
                            assert fused_driver.workspace_elems(
                                64, n, method, ring, itemsize, kind,
                                rows) == k3.driver_workspace_elems(
                                    64, n, method, ring, kind, rows,
                                    itemsize)
                assert fused_bfgs.smem_per_instance(n, itemsize, rows) == (
                    k9.bfgs_fused_smem(n, rows, itemsize))
                assert fused_bfgs.workspace_elems(64, n, itemsize, rows) == (
                    k9.bfgs_fused_workspace_elems(64, n, rows, itemsize))
