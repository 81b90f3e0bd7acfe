"""The port's single-instance and lockstep surface on the CPU against the
JAX package: ``minimize(f, x0_1d, method=...)`` for every template row,
``solvers.minimize`` and ``minimize_recorded`` on a 1-D x0, ``callback``,
``unroll``, ``batched_bounds=True``, a hand-written oracle without a raw
objective, ``make_solver`` and the routing refusals.

Geometry: the weighted squares ``0.5 sum d (x - t)^2`` with ``d =
linspace(1, 50, 8)`` and ``t = linspace(-2.5, 3.5, 8)`` (the
``test_torch_driver_frontend.py`` objective), float64.  The bounded rows
take the box ``[-3, 4]``, which the steps hit and the minimizer does not:
in ``[-1.5, 2.5]`` PGD and the quasi-Newton rows end at the box on f's
rounding floor (f ~ 26, where the two packages' objectives round
differently and the accepted steps are decided by the last bit), so their
end points are not reproducible to 1e-10.  Tolerances: status and
iteration counts equal, x within 1e-10, f within 1e-12 relative (or 1e-15
abs, as f reaches 0); a trajectory row by row within the same; ``unroll``
bit for bit against ``unroll=1``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu as ost
import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu.core.oracle import Oracle as JOracle
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
from optimization_solvers_tpu.core.types import FuncEval as JFuncEval
from optimization_solvers_tpu_torch import interop, linesearch as ls, solvers
from optimization_solvers_tpu_torch.core.oracle import Oracle, make_oracle
from optimization_solvers_tpu_torch.core.types import FuncEval
from optimization_solvers_tpu_torch.ops import fused_driver

torch.set_num_threads(1)

N = 8
D = np.linspace(1.0, 50.0, N)
T = np.linspace(-2.5, 3.5, N)
X0 = np.random.RandomState(0).uniform(-2, 2, (4, N))
LO, UP = np.full(N, -1.5), np.full(N, 2.5)
BOUNDED = {"pgd", "spg", "bfgsb", "dfpb", "broydenb", "sr1b", "pn", "spn"}
ROWS = ["gd", "cd", "pgd", "pnorm", "spg", "ncg", "bfgs", "dfp", "broyden",
        "bfgsb", "dfpb", "broydenb", "sr1b", "lbfgs", "newton", "pn", "spn"]


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


def jax_oracle(hessian=False):
    return jmake_oracle(lambda x: _ws_jax(x, jnp.asarray(D), jnp.asarray(T)),
                        with_hessian=hessian)


def port_oracle(hessian=False):
    return make_oracle(ostt.problems.weighted_squares(), with_hessian=hessian,
                       data=interop.tensors_from_numpy(D, T))


def assert_same(r, ref, x_atol=1e-10):
    r = interop.result_to_numpy(r)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=x_atol)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("row", ROWS)
def test_frontend_single_instance_matches_jax(row, monkeypatch):
    """``minimize(f, x0 (n,), method=row)`` runs ``solvers.minimize``, as
    JAX's front end does (``frontend.py:503``)."""
    monkeypatch.setattr(fused_driver, "solve_spec", None)
    bounds = (-3.0, 4.0) if row in BOUNDED else None
    opts = {"inverse_p": np.diag(1.0 / D)} if row == "pnorm" else {}
    jopts = {k: jnp.asarray(v) for k, v in opts.items()}
    ref = ost.minimize(_ws_jax, jnp.asarray(X0[1]), method=row,
                       bounds=bounds, data=(jnp.asarray(D), jnp.asarray(T)),
                       tol=1e-8, max_iter=300, **jopts)
    tx0, d, t = interop.tensors_from_numpy(X0[1], D, T)
    r = ostt.minimize(ostt.problems.weighted_squares(), tx0, method=row,
                      bounds=bounds, data=(d, t), tol=1e-8, max_iter=300,
                      **opts)
    assert r.x.shape == (N,) and r.status.dim() == 0
    assert_same(r, ref)


def test_minimize_recorded_matches_jax():
    method, jmethod = (solvers.SpectralProjectedGradient(grad_tol=1e-8),
                       jsolvers.SpectralProjectedGradient(grad_tol=1e-8))
    lo, up, tx0 = interop.tensors_from_numpy(LO, UP, X0[2])
    ref, jxs, jfs = jsolvers.minimize_recorded(
        jmethod, jls.GLLQuadratic(), jax_oracle(), jnp.asarray(X0[2]),
        bounds=(jnp.asarray(LO), jnp.asarray(UP)), max_iter=80)
    r, xs, fs = solvers.minimize_recorded(
        method, ls.GLLQuadratic(), port_oracle(), tx0, bounds=(lo, up),
        max_iter=80)
    assert xs.shape == (81, N) and fs.shape == (81,)
    assert_same(r, ref)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=1e-12,
                               atol=1e-15)
    # a batch records (max_iter + 1, B, n)
    (tx,) = interop.tensors_from_numpy(X0)
    rb, xsb, fsb = solvers.minimize_recorded(
        method, ls.GLLQuadratic(), port_oracle(), tx, bounds=(lo, up),
        max_iter=80)
    assert xsb.shape == (81, 4, N) and fsb.shape == (81, 4)
    np.testing.assert_allclose(xsb[:, 2].numpy(), xs.numpy(), rtol=0,
                               atol=1e-14)


def test_callback_matches_jax():
    """Single instance: the same ``(k, x, f)`` per iteration as JAX's
    callback.  Batch: one call per lockstep step with batched tensors; each
    instance's entries while it is active are its own solve's."""
    def jrun(i):
        seen = []
        jsolvers.minimize(
            jsolvers.BFGS(tol=1e-10), jls.MoreThuente(), jax_oracle(),
            jnp.asarray(X0[i]), max_iter=100,
            callback=lambda k, x, f: seen.append(
                (int(k), np.asarray(x), float(f))))
        jax.effects_barrier()
        return seen

    one = []
    tx0, txb = interop.tensors_from_numpy(X0[0], X0)
    solvers.minimize(solvers.BFGS(tol=1e-10), ls.MoreThuente(), port_oracle(),
                     tx0, max_iter=100,
                     callback=lambda k, x, f: one.append((int(k), x.numpy(),
                                                          float(f))))
    ref = jrun(0)
    assert [k for k, _, _ in one] == [k for k, _, _ in ref]
    for (_, x, f), (_, jx, jf) in zip(one, ref):
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)
        np.testing.assert_allclose(f, jf, rtol=1e-12, atol=1e-15)

    steps = []
    r = solvers.batch_minimize(
        solvers.BFGS(tol=1e-10), ls.MoreThuente(), port_oracle(), txb,
        max_iter=100, callback=lambda k, x, f: steps.append(
            (k.clone(), x.clone())))
    assert len(steps) == int(r.iterations.max())
    for i in range(X0.shape[0]):
        ref = jrun(i)
        assert len(ref) == int(r.iterations[i])
        for s, (k, jx, _) in enumerate(ref):
            assert int(steps[s][0][i]) == k == s + 1
            np.testing.assert_allclose(steps[s][1][i].numpy(), jx, rtol=0,
                                       atol=1e-10)


def test_unroll_is_exact_and_matches_jax():
    (tx,) = interop.tensors_from_numpy(X0)
    run = [solvers.batch_minimize(solvers.GradientDescent(grad_tol=1e-7),
                                  ls.BackTracking(), port_oracle(), tx,
                                  max_iter=33, unroll=u, fused=False)
           for u in (1, 4)]
    assert torch.equal(run[0].x, run[1].x)
    assert torch.equal(run[0].iterations, run[1].iterations)
    assert torch.equal(run[0].status, run[1].status)
    ref = jsolvers.batch_minimize(
        jsolvers.GradientDescent(grad_tol=1e-7), jls.BackTracking(),
        jax_oracle(), jnp.asarray(X0), fused=False, max_iter=33, unroll=4)
    assert_same(run[1], ref)


def test_batched_bounds_match_jax():
    """Per-instance boxes with ``batched_bounds=True``: JAX vmaps its
    single-instance loop over them; the port runs them in its lockstep
    loop."""
    rng = np.random.RandomState(4)
    lo = -rng.uniform(2.6, 4.0, (4, N))
    up = rng.uniform(3.6, 5.0, (4, N))
    ref = jsolvers.batch_minimize(
        jsolvers.BFGSB(tol=1e-9), jls.MoreThuenteB(), jax_oracle(),
        jnp.asarray(X0), bounds=(jnp.asarray(lo), jnp.asarray(up)),
        batched_bounds=True, max_iter=200)
    tx, tlo, tup = interop.tensors_from_numpy(X0, lo, up)
    r = solvers.batch_minimize(solvers.BFGSB(tol=1e-9), ls.MoreThuenteB(),
                               port_oracle(), tx, bounds=(tlo, tup),
                               batched_bounds=True, max_iter=200)
    assert_same(r, ref)
    with pytest.raises(ValueError, match="batched_bounds=True needs"):
        solvers.batch_minimize(solvers.BFGSB(), ls.MoreThuenteB(),
                               port_oracle(), tx, bounds=(tlo[0], tup[0]),
                               batched_bounds=True)


def test_hand_written_oracle_matches_jax():
    """An oracle without a raw objective takes the lockstep loop under
    ``fused="auto"``; JAX's takes it on the CPU."""
    d, t = (jnp.asarray(a) for a in (D, T))
    jo = JOracle(lambda x: JFuncEval(_ws_jax(x, d, t), d * (x - t)))
    ref = jsolvers.batch_minimize(jsolvers.NonlinearCG(grad_tol=1e-8),
                                  jls.MoreThuente(), jo, jnp.asarray(X0),
                                  max_iter=200)
    td, tt, tx = interop.tensors_from_numpy(D, T, X0)
    po = Oracle(lambda x: FuncEval(0.5 * torch.sum(td * (x - tt) ** 2, -1),
                                   td * (x - tt)))
    r = solvers.batch_minimize(solvers.NonlinearCG(grad_tol=1e-8),
                               ls.MoreThuente(), po, tx, max_iter=200)
    assert_same(r, ref)
    with pytest.raises(ValueError, match="fused=True but no fused kernel"):
        solvers.batch_minimize(solvers.NonlinearCG(), ls.MoreThuente(), po,
                               tx, fused=True)


def test_make_solver_and_refusals():
    tx, tx1 = interop.tensors_from_numpy(X0, X0[0])
    batched = solvers.make_solver(solvers.GradientDescent(grad_tol=1e-7),
                                  ls.BackTracking(), port_oracle(),
                                  batched=True, max_iter=300, fused=False)
    single = solvers.make_solver(solvers.GradientDescent(grad_tol=1e-7),
                                 ls.BackTracking(), port_oracle(),
                                 max_iter=300)
    rb, r1 = batched(tx), single(tx1)
    assert torch.equal(rb.x[0], r1.x) and int(rb.iterations[0]) == int(
        r1.iterations)
    with pytest.raises(TypeError, match="linesearch"):
        solvers.minimize(solvers.GradientDescent(), jls.BackTracking(),
                         port_oracle(), tx1)
    with pytest.raises(TypeError, match="method config"):
        solvers.minimize(jsolvers.GradientDescent(), ls.BackTracking(),
                         port_oracle(), tx1)
    with pytest.raises(ValueError, match="requires bounds"):
        solvers.minimize(solvers.BFGSB(), ls.MoreThuenteB(), port_oracle(),
                         tx1)
    with pytest.raises(ValueError, match="with_hessian=True"):
        solvers.minimize(solvers.Newton(), ls.NoSearch(), port_oracle(), tx1)
