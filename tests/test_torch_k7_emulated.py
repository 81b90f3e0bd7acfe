"""The CUDA kernel K7's own source on the CPU: ``ops/csrc/lbfgs_fused.cu``
built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``: 32 threads a warp, every collective a
barrier) and held against the plain version ``lbfgs_solve_plain`` in
float64 over the first iterations, as the card's check holds it
(``chip_smoke.py``, ``WHOLE_K7_CAPPED``): status equal, x within the plain
version's own spread under three changes of x0 by 1e-15 relative
(``perturbed_starts``), floored at 1e-10.  On every ``k7_geometries()``
entry, at the headline's width, and on Rosenbrock starts whose first
iterations reject curvature pairs (zeroed ring slots, which the compact
form's small algebra must drop exactly).  A block's warps run lowest first
and then highest first, and both must give the same bits.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k7_geometries, perturbed_starts
from optimization_solvers_tpu_torch import problems
from optimization_solvers_tpu_torch.ops import fused_lbfgs

ITERS, FLOOR, SEEDS = 10, 1e-10, (1, 2)
CASES = sorted(name for name, g in k7_geometries().items() if g["kernel"])
# Rosenbrock-4 starts (RandomState(7) uniform(-2, 2), rows 53, 59, 61, 66)
# whose first 12 iterations at m = 3 reject a pair (s.y <= eps y.y)
REJECTING_ROWS = [53, 59, 61, 66]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k7(tmp_path_factory):
    return emulator.build_k7(str(tmp_path_factory.mktemp("k7_emulated")))


def tensors(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays)


def held(k7, obj, x0, data, kw):
    runs = [emulator.lbfgs_solve(k7, obj, *tensors(x0), tensors(*data),
                                 seed=seed, **kw) for seed in SEEDS]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    x, _, it, st, _ = runs[0]

    def plain(v):
        return fused_lbfgs.lbfgs_solve_plain(obj, *tensors(v), tensors(*data),
                                             **kw)

    xp, _, itp, stp = plain(x0)
    spread = max((plain(v)[0] - xp).abs().max().item()
                 for v in perturbed_starts(x0)[1:])
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    err = (x - xp).abs().max().item()
    assert err <= max(spread, FLOOR), (err, spread)


@pytest.mark.parametrize("name", CASES)
def test_emulated_k7_matches_plain(name, k7):
    g = k7_geometries()[name]
    obj, data = g["kernel"]
    held(k7, obj, g["x0"][:4], data, dict(g["opts"], max_iter=ITERS))


def test_emulated_k7_headline_width(k7):
    x0 = np.random.RandomState(42).uniform(-2, 2, (4, 100))
    held(k7, problems.rosenbrock(), x0, (),
         dict(m=5, tol=1e-3, max_iter=ITERS, max_iter_ls=16, c1=1e-4))


def test_emulated_k7_rejected_pairs(k7):
    x0 = np.random.RandomState(7).uniform(-2, 2, (256, 4))[REJECTING_ROWS]
    held(k7, problems.rosenbrock(), x0, (),
         dict(m=3, tol=1e-10, max_iter=12, max_iter_ls=20, c1=1e-4))


def test_shared_memory_mirror_matches_the_source(k7):
    for n in (1, 31, 100, 1000):
        for m in (1, 5, 20):
            for itemsize in (4, 8):
                assert fused_lbfgs.smem_per_instance(n, m, itemsize) == (
                    k7.lbfgs_fused_smem_per_warp(n, m, itemsize))
