"""``minimize`` rows ``newton``, ``pn`` (``projected_newton``) and ``spn``
against the JAX package's ``minimize``, and config 5 at a reduced width.

JAX's ``minimize`` runs the lockstep driver on the CPU (its K3 only on a
TPU); the port runs K3's Newton form, its plain version for a CPU tensor.
The two agree where the problem is positive definite: the lockstep
Newton inverts H where K3 factors it, and the lockstep driver reports
MAX_ITER_REACHED for a lane that converges exactly at the budget
(``pallas_driver.py:38-43``), neither of which these geometries reach.

Tolerances (float64): status and iteration counts equal, x within 1e-9,
f within 1e-12 relative or 1e-15 abs.  Config 5 (``bench.py:687-741``):
``ProjectedNewton(grad_tol=1e-4)`` + ``BackTrackingB`` through
``solvers.batch_minimize`` on ``quadratic(Q)``, ``Q = diag(linspace(1, 10,
n)) + (0.2 / n) 1 1^T``, box [-2, 2], max_iter 50, starts uniform(-2, 2)
from ``RandomState(5)``, here at n = 64 and B = 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu as ost
from _torch_geometries import config5_hessian
from optimization_solvers_tpu.core import problems as jproblems
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.ops import fused_driver
from test_torch_fused_driver import _ws_jax

torch.set_num_threads(1)

N = 8
D = np.linspace(1.0, 50.0, N)
T = np.linspace(-2.5, 3.5, N)
X0 = np.random.RandomState(0).uniform(-2, 2, (6, N))


def assert_same(r, ref):
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12,
                               atol=1e-15)


ROWS = [("newton", None), ("pn", (-1.5, 2.5)), ("projected_newton",
                                                 (-1.5, 2.5)),
        ("spn", (-1.5, 2.5))]


@pytest.mark.parametrize("policy", ["fast", "reference"])
@pytest.mark.parametrize("method,bounds", ROWS, ids=[r[0] for r in ROWS])
def test_rows_match_jax_minimize(method, bounds, policy):
    """The row's config, default search and policy overlay (``spn``:
    ``precond_bb`` under ``"fast"``) on weighted squares with a target
    partly outside the box."""
    kw = dict(method=method, bounds=bounds, tol=1e-8, max_iter=60,
              policy=policy)
    ref = ost.minimize(_ws_jax, jnp.asarray(X0), data=(D, T), **kw)
    (tx0,) = interop.tensors_from_numpy(X0)
    before = fused_driver.fused_minimize.launches
    r = interop.result_to_numpy(ostt.minimize(
        problems.weighted_squares(), tx0, data=(D, T), **kw))
    assert fused_driver.fused_minimize.launches == before
    assert_same(r, ref)
    if method == "spn":
        # the BB scalar freezes on a Newton direction at the reference
        # update; with precond_bb all but instance 1 end in 2 iterations
        # (JAX's minimize too)
        assert (r.iterations == 60).sum() == (1 if policy == "fast" else 6)
    else:
        assert (r.status == 1).all() and r.iterations.max() <= 3


def test_newton_default_search_in_float32_gains_approx_wolfe(monkeypatch):
    """policy="fast" in float32: newton's default More-Thuente search takes
    the approximate-Wolfe acceptance, as JAX's front end does."""
    seen = {}

    def spy(method, search, *a, **kw):
        seen["search"] = search
        raise RuntimeError("stop")

    monkeypatch.setattr("optimization_solvers_tpu_torch.frontend."
                        "batch_minimize", spy)
    for dtype, policy, expect in ((torch.float32, "fast", True),
                                  (torch.float32, "reference", False),
                                  (torch.float64, "fast", False)):
        with pytest.raises(RuntimeError, match="stop"):
            ostt.minimize(problems.rosenbrock(), torch.zeros((2, 4),
                                                             dtype=dtype),
                          method="newton", policy=policy)
        assert isinstance(seen["search"], ls.MoreThuente)
        assert seen["search"].approx_wolfe is expect


ERRORS = [
    dict(method="pn"),
    dict(method="spn"),
    dict(method="newton", bounds=(-1.0, 1.0)),
    dict(method="newton", grad_tol=1e-3),
    dict(method="spn", bounds=(-1.0, 1.0), bb_variant="alternate"),
    dict(method="projected-newton"),
]


@pytest.mark.parametrize("kw", ERRORS, ids=lambda kw: "-".join(
    f"{k}" for k in kw if k != "method") or kw["method"])
def test_validation_errors_match_jax(kw):
    with pytest.raises((TypeError, ValueError)) as jerr:
        ost.minimize(_ws_jax, jnp.asarray(X0[:2]), data=(D, T), **kw)
    (tx0,) = interop.tensors_from_numpy(X0[:2])
    with pytest.raises((TypeError, ValueError)) as terr:
        ostt.minimize(problems.weighted_squares(), tx0, data=(D, T), **kw)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


# ---- config 5 at n = 64, B = 4, float64 --------------------------------

N5, B5 = 64, 4
Q5 = config5_hessian(N5)
X5 = np.random.RandomState(5).uniform(-2, 2, (B5, N5))


def test_config5_batch_minimize_matches_jax():
    """bench.py's call: ProjectedNewton(grad_tol=1e-4) + BackTrackingB,
    max_iter 50, through batch_minimize."""
    box = (np.full(N5, -2.0), np.full(N5, 2.0))
    ref = ost.solvers.batch_minimize(
        ost.solvers.ProjectedNewton(grad_tol=1e-4), ost.linesearch
        .BackTrackingB(), jmake_oracle(jproblems.quadratic(jnp.asarray(Q5)),
                                       with_hessian=True),
        jnp.asarray(X5), bounds=tuple(jnp.asarray(b) for b in box),
        max_iter=50)
    tx0, lo, up = interop.tensors_from_numpy(X5, *box)
    r = interop.result_to_numpy(solvers.batch_minimize(
        solvers.ProjectedNewton(grad_tol=1e-4), ls.BackTrackingB(),
        make_oracle(problems.quadratic(Q5), with_hessian=True), tx0,
        bounds=(lo, up), max_iter=50))
    assert_same(r, ref)
    # one Newton step lands on x* = 0 (the box is inactive there)
    assert (r.status == 1).all() and (r.iterations == 1).all()
    assert np.abs(r.x).max() <= 1e-12


@pytest.mark.parametrize("method,policy", [("pn", "fast"), ("spn", "fast"),
                                           ("spn", "reference"),
                                           ("newton", "fast")])
def test_config5_rows_match_jax_minimize(method, policy):
    bounds = None if method == "newton" else (-2.0, 2.0)
    kw = dict(method=method, bounds=bounds, tol=1e-4, max_iter=50,
              policy=policy)
    ref = ost.minimize(jproblems.quadratic(jnp.asarray(Q5)), jnp.asarray(X5),
                       **kw)
    (tx0,) = interop.tensors_from_numpy(X5)
    r = interop.result_to_numpy(ostt.minimize(problems.quadratic(Q5), tx0,
                                              **kw))
    assert_same(r, ref)
    expect = {("pn", "fast"): 1, ("spn", "fast"): 2, ("newton", "fast"): 2}
    if (method, policy) in expect:
        assert (r.status == 1).all()
        assert (r.iterations == expect[method, policy]).all()
    else:
        # the reference BB update: a geometric rate, not a Newton step
        assert (r.iterations > 2).all()
