"""The CUDA kernel K4's own source on the CPU: ``ops/csrc/newton_cg.cu``
built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``: 32 threads a warp, every collective a
barrier) and held against the plain version ``newton_cg_solve_plain`` in
float64: status, iterations, Hessian-vector products and trials equal, x
within the geometry's ``x_atol``.  On every ``k4_geometries()`` entry (the
chaotic Rosenbrock ones over their first ITERS iterations, where a 1e-15
change of x0 moves x by far less than 1e-6), in both of the kernel's
layouts: as built (Rosenbrock and weighted squares in registers up to n =
128, the quadratic in shared memory) and with ``-DK4_REG_N=0`` (every
instance in shared memory); at the headline's width; past the register
layout's width; and on starts that overflow (non-finite values and
gradients).  A block's warps share nothing, and lowest first and highest
first must give the same bits.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k4_geometries
from optimization_solvers_tpu_torch import problems
from optimization_solvers_tpu_torch.ops import fused_newton_cg

ITERS, SEEDS = 8, (1, 2)
HEADLINE = dict(pgtol=1e-3, factr=100.0, max_iter=ITERS, cg_max=12,
                max_iter_ls=25, c1=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    return {"regs": emulator.build_k4(str(tmp_path_factory.mktemp("k4"))),
            "shared": emulator.build_k4(
                str(tmp_path_factory.mktemp("k4_shared")), ["-DK4_REG_N=0"])}


def tensors(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays)


def held(lib, obj, x0, lo, up, data, kw, x_atol):
    x0, lo, up = tensors(x0, lo, up)
    data = tensors(*data)
    runs = [emulator.newton_cg_solve(lib, obj, x0, lo, up, data, seed=seed,
                                     **kw) for seed in SEEDS]
    for a, b in zip(*runs):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])
    x, _, it, st, ncg, nfev = runs[0]
    xp, _, itp, stp, ncgp, nfevp = fused_newton_cg.newton_cg_solve_plain(
        obj, x0, lo, up, data, **kw)
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    assert torch.equal(ncg, ncgp)
    assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=0, atol=x_atol, equal_nan=True)


@pytest.mark.parametrize("layout", ["regs", "shared"])
@pytest.mark.parametrize("name", sorted(k4_geometries()))
def test_emulated_k4_matches_plain(name, layout, k4):
    g = k4_geometries()[name]
    kw = dict(g["opts"])
    if g["chaotic"]:
        kw["max_iter"] = ITERS
    held(k4[layout], g["objective"], g["x0"], g["lower"], g["upper"],
         g["data"], kw, g["x_atol"])


@pytest.mark.parametrize("n", [100, 128, 129, 160])
def test_emulated_k4_headline_and_past_the_register_width(n, k4):
    """The headline's problem at its width (registers), at the register
    layout's edge and past it (shared memory)."""
    x0 = np.random.RandomState(42).uniform(-2, 2, (3, n))
    held(k4["regs"], problems.rosenbrock(), x0, np.full(n, -5.0),
         np.full(n, 5.0), (), HEADLINE, 1e-9)


@pytest.mark.parametrize("layout", ["regs", "shared"])
def test_emulated_k4_overflow(layout, k4):
    """Unbounded starts near float64's overflow: the gradient's norm is
    infinite (no CG step), trials overflow and are refused until the search
    is exhausted, and the instances end at the budget, converged or out of
    domain exactly as the plain version's do."""
    n = 6
    x0 = np.random.RandomState(5).uniform(-2, 2, (8, n))
    x0[0, 2], x0[2, 0], x0[3, 3], x0[4, 1] = 3e76, -2e76, 5e75, 1e38
    x0[6, 5], x0[7, 0] = -3e76, 1e77
    x0[1, :], x0[5, :] = 1e76, 1e51
    held(k4[layout], problems.rosenbrock(), x0, np.full(n, -np.inf),
         np.full(n, np.inf), (), dict(HEADLINE, pgtol=1e-8, factr=0.0),
         1e-9)


def test_shared_memory_mirror_matches_the_source(k4):
    for n in (1, 31, 100, 128, 129, 3632, 3633, 7264, 7265):
        for itemsize in (4, 8):
            for rows in (0, 1, 512):
                assert fused_newton_cg.smem_per_instance(
                    n, itemsize, rows) == (
                        k4["regs"].newton_cg_smem_per_warp(n, rows,
                                                           itemsize))
