"""The log-sum-exp's second-order forms in the port's Newton-CG kernel K4
and in K3's Newton form: their plain versions against JAX's TPU kernels
(``ops.pallas_newton_cg.newton_cg_solve_fused`` and
``ops.pallas_driver.fused_minimize`` in interpret mode with ``tile=B``, as
the JAX package's own tests run them on the CPU), and K4's own source
(``ops/csrc/newton_cg.cu`` with the ``LogSumExp`` functor of
``objectives.cuh``, its ``InShared`` layout) through the warp emulator.

``f = log sum_r exp(a_r . x + b_r)`` with ``A, b`` of
``_torch_geometries.lse_arrays``, box [-1, 1], float64, n <= 20, B <= 8:
n < rows (a full-rank Hessian) and n > rows (the Hessian ``A^T (diag(p) -
p p^T) A`` has rank <= rows - 1, so it is singular: K3's factor collapses
and takes the steepest-descent fallback, K4's CG meets zero curvature on
A's null space).  JAX differentiates its objective (``jax.hessian``,
forward-over-reverse HVPs); the port takes the analytic forms of
``core/problems.py``, so the two round differently.  Tolerances: status and
iteration counts equal per instance, x within 1e-9 and f within 1e-12
relative; the emulated kernel against the plain version: status, iterations,
HVPs and trials equal, x within 1e-12, the same bits in both warp orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
from _torch_geometries import lse_arrays
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu.ops.pallas_newton_cg import (
    newton_cg_solve_fused as jk4)
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_driver, fused_newton_cg

torch.set_num_threads(1)

SHAPES = {"tall": (6, 16), "wide_singular": (20, 8)}
K4_OPTS = dict(pgtol=1e-8, factr=0.0, max_iter=60, cg_max=20, max_iter_ls=25,
               c1=1e-4)


def _lse_jax(x, A, b):
    return jax.nn.logsumexp(A @ x + b)


def case(shape, B=8, seed=3):
    n, rows = SHAPES[shape]
    A, b = lse_arrays(n, rows)
    x0 = np.random.RandomState(seed).uniform(-1, 1, (B, n))
    return A, b, x0, np.full(n, -1.0), np.full(n, 1.0)


def assert_matches(r, ref, x_atol=1e-9):
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=x_atol)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12, atol=0)


# ---- K4 ------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k4_plain_matches_jax_kernel(shape):
    A, b, x0, lo, up = case(shape)
    ref = jk4(_lse_jax, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(up),
              consts=(jnp.asarray(A), jnp.asarray(b)), tile=x0.shape[0],
              interpret=True, **K4_OPTS)
    tx0, tlo, tup, tA, tb = interop.tensors_from_numpy(x0, lo, up, A, b)
    r = interop.result_to_numpy(fused_newton_cg.newton_cg_solve_fused(
        problems.log_sum_exp(tA, tb), tx0, tlo, tup, **K4_OPTS))
    assert_matches(r, ref)
    assert (r.status == Status.CONVERGED).all()


@pytest.fixture(scope="module")
def k4_emulated(tmp_path_factory):
    return emulator.build_k4(str(tmp_path_factory.mktemp("k4_lse")))


@pytest.mark.parametrize("shape", sorted(SHAPES) + ["rows_past_a_warp"])
def test_k4_source_matches_plain(shape, k4_emulated):
    """The kernel's own source, its InShared layout (the only one the
    log-sum-exp takes), lowest warp first and highest first; a case with
    rows past one chunk of 32 and not a multiple of it."""
    if shape == "rows_past_a_warp":
        n, rows = 40, 70
        A, b = lse_arrays(n, rows)
        x0 = np.random.RandomState(1).uniform(-1, 1, (4, n))
        lo, up = np.full(n, -1.0), np.full(n, 1.0)
    else:
        A, b, x0, lo, up = case(shape, B=4)
    tx0, tlo, tup, tA, tb = interop.tensors_from_numpy(x0, lo, up, A, b)
    lse = problems.log_sum_exp(tA, tb)
    opts = dict(K4_OPTS, max_iter=30)
    runs = [emulator.newton_cg_solve(k4_emulated, lse, tx0, tlo, tup, (),
                                     seed=seed, **opts) for seed in (1, 2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    x, _, it, st, ncg, nfev = runs[0]
    xp, _, itp, stp, ncgp, nfevp = fused_newton_cg.newton_cg_solve_plain(
        lse, tx0, tlo, tup, (), **opts)
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    assert torch.equal(ncg, ncgp)
    assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-12)


# ---- K3's Newton form ----------------------------------------------------

def _k3_cases():
    return {
        "pn_btb": (solvers.ProjectedNewton(grad_tol=1e-9), ls.BackTrackingB()),
        "spn_precond_btb": (solvers.SpectralProjectedNewton(
            grad_tol=1e-9, precond_bb=True), ls.BackTrackingB()),
        "pn_mtb": (solvers.ProjectedNewton(grad_tol=1e-9), ls.MoreThuenteB()),
    }


def _to_jax(cfg):
    cls = getattr(jsolvers, type(cfg).__name__, None) or getattr(
        jls, type(cfg).__name__)
    return cls(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(_k3_cases()))
def test_k3_newton_plain_matches_jax_kernel(name, shape):
    method, search = _k3_cases()[name]
    A, b, x0, lo, up = case(shape)
    kw = dict(max_iter=40, max_iter_ls=40)
    ref = jk3.fused_minimize(
        _to_jax(method), _to_jax(search), _lse_jax, jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(up),
        consts=(jnp.asarray(A), jnp.asarray(b)), tile=x0.shape[0],
        interpret=True, **kw)
    tx0, tlo, tup, tA, tb = interop.tensors_from_numpy(x0, lo, up, A, b)
    r = interop.result_to_numpy(fused_driver.fused_minimize(
        method, search, problems.log_sum_exp(tA, tb), tx0, tlo, tup, **kw))
    assert_matches(r, ref)


def test_k3_singular_hessian_takes_the_fallback():
    """n > rows: the Hessian's rank is at most rows, every factor collapses
    (a pivot under eps max(max|diag H|, 1)), and PN's steps along its
    fallback direction still decrease f."""
    A, b, x0, lo, up = case("wide_singular")
    tx0, tlo, tup, tA, tb = interop.tensors_from_numpy(x0, lo, up, A, b)
    lse = problems.log_sum_exp(tA, tb)
    H = lse.hessian(tx0)
    assert int(torch.linalg.matrix_rank(H[0])) <= SHAPES["wide_singular"][1]
    L, bad = fused_driver._cholesky_plain(H, fused_driver.QN_EPS[
        torch.float64])
    assert bool(bad.all())
    kw = dict(max_iter=5, max_iter_ls=40)
    pn = fused_driver.fused_minimize(solvers.ProjectedNewton(grad_tol=1e-9),
                                     ls.BackTrackingB(), lse, tx0, tlo, tup,
                                     **kw)
    assert bool(torch.isfinite(pn.f).all())
    assert bool((pn.f < lse.value(tx0)).all())


@pytest.fixture(scope="module")
def k3_newton_emulated(tmp_path_factory):
    return emulator.build_k3(str(tmp_path_factory.mktemp("k3_newton")),
                             newton=True)


@pytest.mark.parametrize("n,rows", [(16, 40), (40, 8)])
def test_k3_newton_source_matches_plain(n, rows, k3_newton_emulated):
    """K3's Newton form from its own source (``driver_newton.cu``: one block
    of 256 threads, the block-level log-sum-exp Hessian and the blocked
    Cholesky), lowest warp first and highest first, against the plain
    version, PN + BackTrackingB, 10 iterations: status, iterations and
    trials equal, x within 1e-12; n = 40 past 8 rows is singular (every
    factor collapses: the fallback direction)."""
    A, b = lse_arrays(n, rows)
    x0 = np.random.RandomState(3).uniform(-1, 1, (2, n))
    tx0, tlo, tup, tA, tb = interop.tensors_from_numpy(
        x0, np.full(n, -1.0), np.full(n, 1.0), A, b)
    lse = problems.log_sum_exp(tA, tb)
    pn = solvers.ProjectedNewton(grad_tol=1e-9)
    kw = dict(max_iter=10, max_iter_ls=40)
    runs = [emulator.driver_solve(k3_newton_emulated, pn, ls.BackTrackingB(),
                                  lse, tx0, tlo, tup, seed=seed, **kw)
            for seed in (1, 2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    x, _, it, st, nfev = runs[0]
    xp, _, itp, stp, nfevp = fused_driver.fused_minimize_plain(
        pn, ls.BackTrackingB(), lse, tx0, tlo, tup, **kw)
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-12)
