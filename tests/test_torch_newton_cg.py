"""The port's Newton-CG kernel K4 (its plain version) against the JAX Pallas
kernel ``ops.pallas_newton_cg.newton_cg_solve_fused`` and the JAX XLA twin
``solvers.newton_cg.newton_cg_batch_minimize``, and the ``newton_cg`` row
of ``minimize`` against JAX's.

The JAX kernel runs in interpret mode with ``tile=B`` and traces
forward-over-reverse AD for its Hessian-vector products; the port takes
the objective's analytic HVP.  Geometries are
``tests/_torch_geometries.py:k4_geometries``.

Tolerances (float64): status equal per instance; on the quadratic
geometries iteration counts equal and x within 1e-9; the Rosenbrock entries
are chaotic (the rounding of the HVP alone moves a truncated-CG decision),
so their counts are held to ``max(2, spread)`` with ``spread`` the port's
own range under 6 changes of x0 by 1e-15 relative, x within 1e-6 and f
within 1e-9 relative or 1e-12 abs.  ``pg_norm`` is JAX's masked-box
``batched_pg_inf_norm`` on both sides.  The CUDA kernel is held against the
plain version on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu as ost
from _torch_geometries import k4_geometries, lse_arrays, perturbation_spread
from optimization_solvers_tpu.core import problems as jproblems
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
from optimization_solvers_tpu.ops.pallas_newton_cg import (
    newton_cg_solve_fused as jk4)
from optimization_solvers_tpu.solvers import newton_cg as jnewton_cg
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu_torch import interop, problems, solvers
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_newton_cg
from test_torch_fused_driver import _rosen_jax, _ws_jax

torch.set_num_threads(1)

GEOMETRIES = k4_geometries()


def _quad_jax(x, Q):
    return 0.5 * jnp.sum(x * (Q @ x))


JAX_OBJECTIVES = {"rosenbrock": _rosen_jax, "weighted_squares": _ws_jax,
                  "quadratic": _quad_jax}


def run_jax(g, dtype=np.float64):
    def arr(a):
        return jnp.asarray(np.asarray(a, dtype))

    return jk4(JAX_OBJECTIVES[g["jax_objective"]], arr(g["x0"]),
               arr(g["lower"]), arr(g["upper"]),
               consts=tuple(arr(c) for c in g["jax_data"]),
               tile=g["x0"].shape[0], interpret=True, **g["opts"])


def run_port(g, x0=None, dtype=torch.float64):
    x0 = g["x0"] if x0 is None else x0
    tx0, lo, up, *data = interop.tensors_from_numpy(
        x0, g["lower"], g["upper"], *g["data"], dtype=dtype)
    return interop.result_to_numpy(fused_newton_cg.newton_cg_solve_fused(
        g["objective"], tx0, lo, up, tuple(data), **g["opts"]))


@pytest.fixture(scope="module")
def jax_reference():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_jax(GEOMETRIES[name])
        return cache[name]

    return get


def assert_matches(r, ref, g, x0=None):
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    dit = np.abs(r.iterations.astype(np.int64)
                 - np.asarray(ref.iterations)).max()
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda v: run_port(g, v).iterations,
            g["x0"] if x0 is None else x0, runs=6)
        assert dit <= max(2, spread), (dit, spread)
        np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-9,
                                   atol=1e-12)
    else:
        assert dit == 0
        np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12,
                                   atol=1e-15)
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0,
                               atol=g["x_atol"])
    np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm), rtol=0,
                               atol=max(1e-9, g["x_atol"]))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_kernel(name, jax_reference):
    g = GEOMETRIES[name]
    r = run_port(g)
    assert_matches(r, jax_reference(name), g)
    assert (r.status == Status.CONVERGED).all()


def test_geometries_end_as_in_the_jax_tests(jax_reference):
    """tests/test_fused_newton_cg.py's own checks hold for the port."""
    r = run_port(GEOMETRIES["rosenbrock_interior"])
    assert np.all((r.f < 1e-12) | (np.abs(r.f - 3.9866) < 1e-2))
    assert float(np.median(r.iterations)) < 150
    np.testing.assert_allclose(
        run_port(GEOMETRIES["active_bounds_quadratic"]).x, 1.0, atol=1e-7)
    mixed = run_port(GEOMETRIES["mixed_active_set"])
    np.testing.assert_allclose(mixed.x[:, 1], 47.0, atol=1e-9)
    np.testing.assert_allclose(mixed.x[:, 0], 0.0, atol=1e-7)
    # the factr test ends these solves before pg reaches 1e-12
    factr = run_port(GEOMETRIES["rosenbrock_factr_stop"])
    assert (factr.pg_norm > 1e-12).all()


@pytest.mark.parametrize("name", ["rosenbrock_xla_twin",
                                  "rosenbrock_upper_active",
                                  "active_bounds_quadratic"])
def test_plain_matches_jax_xla_twin(name):
    """The JAX front end's newton_cg runs the XLA twin: the port's K4 holds
    against it as against the TPU kernel."""
    g = GEOMETRIES[name]
    fj = JAX_OBJECTIVES[g["jax_objective"]]
    data = tuple(jnp.asarray(c) for c in g["jax_data"])
    ref = jnewton_cg.newton_cg_batch_minimize(
        jmake_oracle(fj, data=data), jnp.asarray(g["x0"]),
        jnp.asarray(g["lower"]), jnp.asarray(g["upper"]),
        jnewton_cg.NewtonCGConfig(**g["opts"]))
    assert_matches(run_port(g), ref, g)


def test_float32_matches_jax_by_status_and_median_f(jax_reference):
    g = GEOMETRIES["rosenbrock_interior"]
    g = dict(g, opts=dict(g["opts"], pgtol=1e-3, factr=100.0))
    ref = run_jax(g, np.float32)
    r = run_port(g, dtype=torch.float32)
    assert r.x.dtype == np.float32
    np.testing.assert_array_equal(np.bincount(r.status, minlength=7),
                                  np.bincount(np.asarray(ref.status),
                                              minlength=7))
    assert abs(float(np.median(np.asarray(ref.f)))
               - float(np.median(r.f))) <= 1e-4


# ---- minimize(method="newton_cg") ----------------------------------------

X0 = np.random.RandomState(8).uniform(-2, 2, (4, 8))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bounds=(-2.0, 0.5), tol=1e-7, cg_max=6),
    dict(bounds=(np.full(8, -2.0), np.full(8, 2.0)), max_iter_ls=5,
         factr=1e3, c1=1e-3, pgtol=1e-9),
], ids=["defaults", "bounds-tol-cg_max", "vector-bounds-options"])
def test_minimize_newton_cg_matches_jax(kw):
    """minimize(method="newton_cg") against JAX's minimize (its XLA twin),
    float64: defaults (factr 1e7, pgtol = tol = 1e-6, unbounded) and
    options."""
    ref = ost.minimize(jproblems.rosenbrock(), jnp.asarray(X0),
                       method="newton_cg", max_iter=300, **kw)
    (tx0,) = interop.tensors_from_numpy(X0)
    r = interop.result_to_numpy(ostt.minimize(
        problems.rosenbrock(), tx0, method="newton_cg", max_iter=300, **kw))
    g = dict(chaotic=True, x_atol=1e-6, x0=X0)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    assert np.abs(r.iterations - np.asarray(ref.iterations)).max() <= 2
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0,
                               atol=g["x_atol"])


def test_minimize_newton_cg_float32_defaults_match_jax():
    """factr defaults to 100 in float32 (1e7 would stop at once)."""
    x0 = X0.astype(np.float32)
    ref = ost.minimize(jproblems.rosenbrock(), jnp.asarray(x0),
                       method="newton_cg", bounds=(-5.0, 5.0), tol=1e-3,
                       max_iter=600, cg_max=12)
    (tx0,) = interop.tensors_from_numpy(x0, dtype=torch.float32)
    r = ostt.minimize(problems.rosenbrock(), tx0, method="newton_cg",
                      bounds=(-5.0, 5.0), tol=1e-3, max_iter=600, cg_max=12)
    assert r.x.dtype == torch.float32
    np.testing.assert_array_equal(np.bincount(r.status.numpy(), minlength=7),
                                  np.bincount(np.asarray(ref.status),
                                              minlength=7))
    assert (r.iterations > 1).all()


def test_minimize_newton_cg_errors_match_jax():
    (tx0,) = interop.tensors_from_numpy(X0)
    with pytest.raises(TypeError) as jerr:
        ost.minimize(jproblems.rosenbrock(), jnp.asarray(X0),
                     method="newton_cg", no_such=1, m=3)
    with pytest.raises(TypeError) as terr:
        ostt.minimize(problems.rosenbrock(), tx0, method="newton_cg",
                      no_such=1, m=3)
    assert str(terr.value) == str(jerr.value)
    # per-instance (B, n) boxes: JAX's branch cannot broadcast them either
    per = (np.full((4, 8), -1.0), np.full((4, 8), 1.0))
    with pytest.raises(ValueError):
        ost.minimize(jproblems.rosenbrock(), jnp.asarray(X0),
                     method="newton_cg", bounds=per)
    with pytest.raises(ValueError, match="per-instance"):
        ostt.minimize(problems.rosenbrock(), tx0, method="newton_cg",
                      bounds=per)
    with pytest.raises(ValueError, match="its own line search"):
        ostt.minimize(problems.rosenbrock(), tx0, method="newton_cg",
                      search=ostt.linesearch.BackTracking())
    # a single instance runs the lockstep loop (newton_cg_minimize), as
    # JAX's does
    ref = ost.minimize(jproblems.rosenbrock(), jnp.asarray(X0[0]),
                       method="newton_cg", bounds=(-2.0, 2.0))
    r = ostt.minimize(problems.rosenbrock(), tx0[0], method="newton_cg",
                      bounds=(-2.0, 2.0))
    assert r.x.shape == (8,) and r.status.dim() == 0
    assert int(r.status) == int(ref.status)
    assert int(r.iterations) == int(ref.iterations)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)


def test_solver_surface_matches_jax():
    assert dataclasses.asdict(solvers.NewtonCGConfig()) == dataclasses.asdict(
        jnewton_cg.NewtonCGConfig())
    (tx0,) = interop.tensors_from_numpy(X0)
    lo, up = interop.tensors_from_numpy(np.full(8, -2.0), np.full(8, 2.0))
    cfg = solvers.NewtonCGConfig(pgtol=1e-8, factr=0.0, max_iter=200)
    oracle = make_oracle(problems.rosenbrock())
    r = solvers.newton_cg_batch_minimize(oracle, tx0, lo, up, cfg)
    ref = jnewton_cg.newton_cg_batch_minimize(
        jmake_oracle(jproblems.rosenbrock()), jnp.asarray(X0),
        jnp.full(8, -2.0), jnp.full(8, 2.0),
        jnewton_cg.NewtonCGConfig(pgtol=1e-8, factr=0.0, max_iter=200))
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(r.x.numpy(), np.asarray(ref.x), atol=1e-6)
    # one instance: the lockstep loop, JAX's while loop per instance
    jcfg = jnewton_cg.NewtonCGConfig(pgtol=1e-8, factr=0.0, max_iter=200)
    one = solvers.newton_cg_minimize(oracle, tx0[0], lo, up, cfg)
    jone = jnewton_cg.newton_cg_minimize(
        jmake_oracle(jproblems.rosenbrock()), jnp.asarray(X0[0]),
        jnp.full(8, -2.0), jnp.full(8, 2.0), jcfg)
    assert int(one.status) == int(jone.status)
    assert int(one.iterations) == int(jone.iterations)
    np.testing.assert_allclose(one.x.numpy(), np.asarray(jone.x), rtol=0,
                               atol=1e-9)
    # an oracle without a raw objective runs the lockstep loop where it has
    # an hvp, and raises ValueError without one, as JAX's does
    bare = ostt.Oracle(oracle)
    with pytest.raises(ValueError, match="Hessian-vector products"):
        solvers.newton_cg_batch_minimize(bare, tx0, lo, up)
    bare.hvp = oracle.hvp
    lock = solvers.newton_cg_batch_minimize(bare, tx0, lo, up, cfg)
    np.testing.assert_array_equal(lock.status.numpy(),
                                  np.asarray(ref.status))
    np.testing.assert_array_equal(lock.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(lock.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    # the oracle's hvp: analytic for a library objective
    (v,) = interop.tensors_from_numpy(np.ones((4, 8)))
    torch.testing.assert_close(oracle.hvp(tx0, v),
                               problems.rosenbrock().hvp(tx0, v))
    torch.testing.assert_close(oracle.hvp(tx0[0], v[0]),
                               problems.rosenbrock().hvp(tx0, v)[0])


def test_wrapper_refusals():
    (tx0,) = interop.tensors_from_numpy(X0)
    lo, up = interop.tensors_from_numpy(np.full(8, -2.0), np.full(8, 2.0))
    with pytest.raises(ValueError, match=r"must be a \(8,\) tensor"):
        fused_newton_cg.newton_cg_solve_fused(
            problems.rosenbrock(), tx0, lo[None].expand(4, 8), up)
    # the LOG_SUM_EXP functor's rows count in the fit: past it, refused
    # before anything is built
    A, b = lse_arrays(8, 3)
    wide = problems.log_sum_exp(*lse_arrays(8, 20000))
    with pytest.raises(NotImplementedError, match="20000 rows"):
        fused_newton_cg._launch_cuda(
            wide, tx0, lo, up, (), pgtol=1e-5, factr=1e7, max_iter=5,
            cg_max=5, max_iter_ls=5, c1=1e-4)
    # the plain version takes it, with its analytic HVP
    r = fused_newton_cg.newton_cg_solve_fused(
        problems.log_sum_exp(A, b), tx0 * 0.1, lo, up, pgtol=1e-9, factr=0.0)
    assert (r.status == Status.CONVERGED).all()
    assert fused_newton_cg.smem_per_instance(100, 4) == 3200
    assert fused_newton_cg.smem_per_instance(1000, 4, 512) == 36096
    assert fused_newton_cg.fits(7000, 4) and not fused_newton_cg.fits(
        7000, 8)
    assert fused_newton_cg.fits(7000, 4, 1000) and not fused_newton_cg.fits(
        7000, 4, 2000)
