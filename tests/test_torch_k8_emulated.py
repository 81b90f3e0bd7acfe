"""The CUDA kernel K8's own source on the CPU: ``ops/csrc/spg_fused.cu`` (on
``lanes.cuh``) built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``) and held against the plain version
``spg_solve_plain`` in float64: status, iterations and trials equal, x
within 1e-10.  Each case runs twice, the warps of a block taking turns
lowest first and then highest first, and must give the same bits both
times.

Each layout: as built (every vector in registers, two coordinates a lane
up to n = 64 and four up to 128; wider instances in the warp's shared
memory), with ``-DK8_PAIR_N=0`` (four coordinates a lane from n = 1) and
with ``-DK8_REG_N=0`` (every instance in shared memory).  The cases: every
``k8_geometries()`` entry that has a kernel functor; config 3's inputs
(the box quadratic at n = 64, d = logspace(0, 3)) over ITERS iterations;
Rosenbrock past the register layout's width (n = 160); and searches whose
trials overflow or whose budget runs out (K8 takes the last halved step
untested).
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k8_geometries
from optimization_solvers_tpu_torch import problems
from optimization_solvers_tpu_torch.ops import fused_spg

ITERS, SEEDS, X_ATOL = 40, (1, 2), 1e-10
LAYOUTS = {"as_built": (), "four": ("-DK8_PAIR_N=0",),
           "shared": ("-DK8_REG_N=0",)}
CASES = sorted(name for name, g in k8_geometries().items()
               if g["kernel"] is not None)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k8(tmp_path_factory):
    return {name: emulator.build_k8(
        str(tmp_path_factory.mktemp(f"k8_{name}")), flags)
        for name, flags in LAYOUTS.items()}


def tensors(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays)


def held(lib, obj, x0, lo, up, data, kw):
    x0, lo, up = tensors(x0, lo, up)
    data = tensors(*data)
    runs = [emulator.spg_solve(lib, obj, x0, lo, up, data, seed=seed, **kw)
            for seed in SEEDS]
    for a, b in zip(*runs):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])
    x, _, it, st, nfev = runs[0]
    nfevp = torch.zeros_like(nfev)
    xp, _, itp, stp = fused_spg.spg_solve_plain(obj, x0, lo, up, data,
                                                nfev=nfevp, **kw)
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=0, atol=X_ATOL, equal_nan=True)
    return it, st, nfev


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", CASES)
def test_emulated_k8_matches_plain(name, layout, k8):
    g = k8_geometries()[name]
    obj, data = g["kernel"]
    held(k8[layout], obj, g["x0"], g["lower"], g["upper"], data, g["opts"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_emulated_k8_at_config3(layout, k8):
    n = 64
    held(k8[layout], problems.weighted_squares(),
         np.random.RandomState(3).uniform(-2.0, 2.0, (4, n)),
         np.full(n, -2.0), np.full(n, 2.0),
         (np.logspace(0, 3, n), np.zeros(n)),
         dict(tol=1e-4, max_iter=ITERS, max_iter_ls=30))


def test_emulated_k8_past_the_register_width(k8):
    n = 160
    held(k8["as_built"], problems.rosenbrock(),
         np.random.RandomState(8).uniform(-2.0, 2.0, (2, n)),
         np.full(n, -1.5), np.full(n, 1.5), (),
         dict(tol=1e-8, max_iter=20))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_emulated_k8_overflow_and_exhaust(layout, k8):
    """Rosenbrock-10 in an unbounded box, one start in [-3, 3] and three
    near 1e25 whose trials overflow: with a budget of 3 trials (and of 6)
    iterations end with t untested and the step is evaluated."""
    rng = np.random.RandomState(7)
    x0 = rng.uniform(1e25, 3e25, (4, 10)) * rng.choice([-1.0, 1.0], (4, 10))
    x0[0] = rng.uniform(-3.0, 3.0, 10)
    for budget in (3, 6):
        it, st, nfev = held(k8[layout], problems.rosenbrock(), x0,
                            np.full(10, -np.inf), np.full(10, np.inf), (),
                            dict(tol=1e-8, max_iter=12, max_iter_ls=budget))
        assert (st[1:] == 3).all()
