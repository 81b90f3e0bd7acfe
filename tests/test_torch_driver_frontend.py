"""The port's ``minimize`` for the first-order template methods, and
``solvers.batch_minimize``, on the CPU against the JAX package.

The reference is JAX K3 (``ops.pallas_driver.fused_minimize``) in
interpret mode with ``tile=B``, given the method and search configs that
the JAX front end builds for the same call (``frontend._method_and_search``
plus its ``policy`` overlay): on a CPU the JAX front end runs its lockstep
loop instead, which the port does not have yet.

Tolerances (float64): status and iteration counts equal, x within 1e-9.
At the config-3 shape (n = 64, two coordinates per warp lane in the CUDA
kernel) SPG + GLL is chaotic: a 1e-15 relative change of x0 moves the
iteration counts of nearly every instance of a full solve.  So the shape
is held per instance in float64 over the first 30 iterations, where such
a change moves x by under 1e-10 (checked below; GLL's history of 10 has
wrapped three times).  A full float32 solve is held by converged
fraction (within 2%), median iterations (within 5%) and median f (within
a factor 2): at B = 256 a last-bit change of x0 moves JAX's own median f
by tens of percent and its median iterations by a few percent, while the
two policies differ by about half in median iterations.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu as ost
import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu import frontend as jfront
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu_torch import interop, linesearch as ls, solvers
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.ops import fused_driver

torch.set_num_threads(1)

N, B = 8, 16
D = np.linspace(1.0, 50.0, N)
T = np.linspace(-2.5, 3.5, N)
X0 = np.random.RandomState(0).uniform(-2, 2, (B, N))


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


def jax_k3(method, x0, bounds, tol, options, *, search=None, policy="fast",
           data=(D, T), max_iter=500, max_iter_ls=40):
    """JAX K3 with the configs JAX's front end builds for this call."""
    canon, make_m, default_search, _ = jfront._method_and_search(
        method, tol, dict(options))
    m = make_m()
    overlay = {k: v for k, v in jfront._FAST_METHOD_OVERLAY.get(
        canon, {}).items() if k not in options}
    if policy == "fast" and overlay:
        m = dataclasses.replace(m, **overlay)
    lo, up = (None, None) if bounds is None else (
        jnp.full(x0.shape[1], bounds[0]), jnp.full(x0.shape[1], bounds[1]))
    return jk3.fused_minimize(
        m, search or default_search, _ws_jax, jnp.asarray(x0), lo, up,
        consts=tuple(jnp.asarray(c) for c in data), max_iter=max_iter,
        max_iter_ls=max_iter_ls, tile=x0.shape[0], interpret=True)


def port(method, x0, bounds, tol, options, *, search=None, policy="fast",
         data=(D, T), max_iter=500, dtype=torch.float64):
    tx0, *tdata = interop.tensors_from_numpy(x0, *data, dtype=dtype)
    return interop.result_to_numpy(ostt.minimize(
        ostt.problems.weighted_squares(), tx0, method=method, bounds=bounds,
        data=tuple(tdata), tol=tol, max_iter=max_iter, search=search,
        policy=policy, **options))


CASES = {
    # name: (method, bounds, options, port search, JAX search, policy)
    "gd": ("gd", None, {}, None, None, "fast"),
    "cd": ("coordinate_descent", None, {}, None, None, "fast"),
    "pgd": ("pgd", (-1.5, 2.5), {}, None, None, "fast"),
    "pnorm": ("pnorm", None, {"inverse_p": np.diag(1.0 / D)}, None, None,
              "fast"),
    "spg_fast": ("spg", (-1.5, 2.5), {}, None, None, "fast"),
    "spg_reference": ("spg", (-1.5, 2.5), {}, None, None, "reference"),
    "ncg": ("nonlinear_cg", None, {"variant": "hs"}, None, None, "fast"),
    "gd_gll": ("gd", None, {}, ls.GLLQuadratic(m=5), jls.GLLQuadratic(m=5),
               "fast"),
    "spg_btb": ("spg", (-1.5, 2.5), {"bb_variant": "bb1"},
                ls.BackTrackingB(c1=1e-3), jls.BackTrackingB(c1=1e-3),
                "fast"),
    "ncg_nosearch": ("ncg", None, {"variant": "fr"}, ls.NoSearch(),
                     jls.NoSearch(), "fast"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_minimize_matches_jax_kernel(name):
    method, bounds, options, search, jsearch, policy = CASES[name]
    x0 = X0
    if options.get("inverse_p") is not None:
        jopts = dict(options, inverse_p=jnp.asarray(options["inverse_p"]))
    else:
        jopts = options
    ref = jax_k3(method, x0, bounds, 1e-6, jopts, search=jsearch,
                 policy=policy)
    r = port(method, x0, bounds, 1e-6, options, search=search, policy=policy)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm), rtol=0,
                               atol=1e-9)


def test_spg_policy_picks_the_bb_variant(monkeypatch):
    seen = []
    orig = fused_driver.solve_spec

    def spy(spec, method, *a, **kw):
        seen.append((method, spec, kw["max_iter_ls"]))
        return orig(spec, method, *a, **kw)

    monkeypatch.setattr(fused_driver, "solve_spec", spy)
    for policy, options in (("fast", {}), ("reference", {}),
                            ("fast", {"bb_variant": "bb1"})):
        port("spg", X0[:2], (-1.5, 2.5), 1e-6, options, policy=policy,
             max_iter=3)
    assert [m.bb_variant for m, _, _ in seen] == ["alternate", "bb1", "bb1"]
    assert [s.alternate for _, s, _ in seen] == [True, False, False]
    assert all(s.search == fused_driver.GLL and k == 40 for _, s, k in seen)


# ---- the config-3 shape: 256 x 64, float32, both policies ----------------

@pytest.fixture(scope="module")
def config3_inputs():
    d = np.logspace(0, 3, 64)
    x0 = np.random.RandomState(3).uniform(-2, 2, (256, 64))
    return d, x0


def _config3_port(x0, data, policy, max_iter, dtype):
    tx0, *tdata = interop.tensors_from_numpy(x0, *data, dtype=dtype)
    return interop.result_to_numpy(ostt.minimize(
        ostt.problems.weighted_squares(), tx0, method="spg",
        bounds=(-2.0, 2.0), data=tuple(tdata), tol=1e-4, max_iter=max_iter,
        max_iter_ls=30, policy=policy))


@pytest.mark.parametrize("policy", ["fast", "reference"])
def test_config3_shape_matches_jax_kernel(config3_inputs, policy):
    d, x0 = config3_inputs
    x0 = x0.astype(np.float32)
    data = (d.astype(np.float32), np.zeros(64, np.float32))
    ref = jax_k3("spg", x0, (-2.0, 2.0), 1e-4, {}, policy=policy, data=data,
                 max_iter=1000, max_iter_ls=30)
    r = _config3_port(x0, data, policy, 1000, torch.float32)
    conv = (r.status == 1).mean()
    conv_ref = (np.asarray(ref.status) == 1).mean()
    assert abs(conv - conv_ref) <= 0.02, (conv, conv_ref)
    assert conv >= 0.9
    f_ratio = np.median(r.f) / float(np.median(np.asarray(ref.f)))
    assert 0.5 <= f_ratio <= 2.0, f_ratio
    it_ref = float(np.median(np.asarray(ref.iterations)))
    assert abs(np.median(r.iterations) - it_ref) <= 0.05 * it_ref, (
        np.median(r.iterations), it_ref)
    assert r.x.dtype == np.float32


@pytest.mark.parametrize("policy", ["fast", "reference"])
def test_config3_shape_first_iterations_match_jax_kernel(config3_inputs,
                                                         policy):
    d, x0 = config3_inputs
    x0 = x0[:64]
    data = (d, np.zeros(64))
    ref = jax_k3("spg", x0, (-2.0, 2.0), 1e-4, {}, policy=policy, data=data,
                 max_iter=30, max_iter_ls=30)
    r = _config3_port(x0, data, policy, 30, torch.float64)
    nudge = np.random.RandomState(100).standard_normal(x0.shape)
    moved = _config3_port(x0 * (1 + 1e-15 * nudge), data, policy, 30,
                          torch.float64)
    assert np.abs(moved.x - r.x).max() <= 1e-10  # not yet chaotic
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-9, atol=0)


# ---- validation: the JAX front end's errors, with the same text -----------

VALIDATION = [
    dict(method="no_such_method"),
    dict(method="gd", bounds=(-1.0, 1.0)),
    dict(method="ncg", bounds=(-1.0, 1.0)),
    dict(method="pgd"),
    dict(method="spg"),
    dict(method="pnorm"),
    dict(method="gd", no_such_option=1),
    dict(method="spg", bounds=(-1.0, 1.0), variant="fr"),
    dict(method="bfgsb"),
    dict(method="sr1b"),
    dict(method="bfgs", bounds=(-1.0, 1.0)),
    dict(method="lbfgs", bounds=(-1.0, 1.0)),
    dict(method="bfgs", not_an_option=1),
    dict(method="lbfgs", update="dfp"),
    dict(method="bfgs", fused=True, scale_b0=True),
]


@pytest.mark.parametrize("kw", VALIDATION, ids=lambda kw: "-".join(
    f"{k}" for k in kw if k != "method") or kw["method"])
def test_validation_errors_match_jax(kw):
    x0 = X0[:2]
    with pytest.raises((TypeError, ValueError)) as jerr:
        ost.minimize(_ws_jax, jnp.asarray(x0), data=(D, T), **kw)
    (tx0,) = interop.tensors_from_numpy(x0)
    with pytest.raises((TypeError, ValueError)) as terr:
        ostt.minimize(ostt.problems.weighted_squares(), tx0, data=(D, T),
                      **kw)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("method", sorted(
    ["newton", "pn", "spn", "bfgs", "dfp", "broyden", "bfgsb", "dfpb",
     "broydenb", "sr1b", "lbfgs", "l-bfgs", "projected_newton",
     "newton_cg"]))
def test_methods_outside_the_slice_name_the_roadmap(method):
    """Every row of the JAX front end's table runs: the dense quasi-Newton,
    L-BFGS and Newton rows on K3 (its plain version for a CPU x0), newton_cg
    on K4.  Each ends in the success class, and its CONVERGED instances at
    the minimizer of the weighted squares; SPN's BB scalar exhausts the
    budget on instance 1 (JAX's minimize ends it MAX_ITER_REACHED too)."""
    (tx0,) = interop.tensors_from_numpy(X0[:2])
    f = ostt.problems.weighted_squares()
    name = method.replace("-", "_")
    bounded = name.endswith("b") or name in ("pn", "spn", "projected_newton",
                                             "newton_cg")
    bounds = (-1.5, 2.5) if bounded else None
    r = ostt.minimize(f, tx0, method=method, data=(D, T), bounds=bounds,
                      tol=1e-8)
    assert r.x.shape == tx0.shape
    st = r.status.numpy()
    if name == "spn":
        assert st.tolist() == [1, 2]
    else:
        assert np.isin(st, (1, 6)).all()
    target = np.clip(T, *bounds) if bounded else T
    conv = st == 1
    np.testing.assert_allclose(r.x.numpy()[conv],
                               np.broadcast_to(target, r.x.shape)[conv],
                               atol=1e-5)


def test_unported_paths_raise(monkeypatch):
    """What K3 has no form for runs the lockstep loop now; what neither
    route takes raises."""
    (tx0,) = interop.tensors_from_numpy(X0[:2])
    f = ostt.problems.weighted_squares()
    # the base class has no search body; JAX's configs are not the port's
    with pytest.raises(NotImplementedError, match="has no step_len"):
        ostt.minimize(f, tx0, method="gd", data=(D, T),
                      search=ls.LineSearch())
    for search in (jls.MoreThuente(), jls.HagerZhang()):
        with pytest.raises(TypeError, match="linesearch"):
            ostt.minimize(f, tx0, method="gd", data=(D, T), search=search)
    k3 = []
    orig = fused_driver.solve_spec
    monkeypatch.setattr(fused_driver, "solve_spec",
                        lambda *a, **kw: k3.append(1) or orig(*a, **kw))
    r = ostt.minimize(f, tx0, method="bfgs", data=(D, T),
                      search=ls.MoreThuente(reference_quirks=True))
    assert (r.status == 1).all()
    r = ostt.minimize(f, tx0[0], method="gd", data=(D, T))
    assert r.x.shape == (N,) and int(r.status) == 1
    oracle = make_oracle(f, data=interop.tensors_from_numpy(D, T))
    gd, bt = solvers.GradientDescent(), ls.BackTracking()
    for lockstep in (dict(fused=False), dict(batched_bounds=True),
                     dict(unroll=4), dict(callback=lambda *a: None)):
        r = solvers.batch_minimize(gd, bt, oracle, tx0, max_iter=5,
                                   **lockstep)
        assert r.iterations.tolist() == [5, 5]
    with pytest.raises(ValueError, match="incompatible with callback"):
        solvers.batch_minimize(gd, bt, oracle, tx0, fused=True,
                               callback=lambda *a: None)
    r = solvers.batch_minimize(gd, bt, ostt.Oracle(oracle), tx0, max_iter=5)
    assert r.iterations.tolist() == [5, 5]
    # an instance too wide for K3's shared memory takes the lockstep loop
    wide = torch.zeros((2, 5000), dtype=torch.float64)
    r = solvers.batch_minimize(gd, bt, make_oracle(lambda x: x.sum()), wide,
                               max_iter=3)
    assert r.iterations.tolist() == [3, 3]
    assert k3 == []
    solvers.batch_minimize(gd, bt, oracle, tx0, max_iter=5)
    assert k3 == [1]
    # the Hessians the Newton family takes: analytic for a library
    # objective, torch.func for any other callable
    d, t = interop.tensors_from_numpy(D, T)
    hess = make_oracle(f, with_hessian=True, data=(d, t))(tx0).hessian
    torch.testing.assert_close(hess, torch.diag_embed(d.expand(2, N)))
    raw = make_oracle(lambda z, dd, tt: 0.5 * torch.sum(dd * (z - tt) ** 2),
                      with_hessian=True, data=(d, t))
    torch.testing.assert_close(raw(tx0).hessian, hess)


def test_batch_minimize_kwargs_match_jax():
    (tx0,) = interop.tensors_from_numpy(X0[:2])
    oracle = make_oracle(ostt.problems.weighted_squares(),
                         data=interop.tensors_from_numpy(D, T))
    with pytest.raises(TypeError) as terr:
        solvers.batch_minimize(solvers.GradientDescent(), ls.BackTracking(),
                               oracle, tx0, max_iters=5)
    with pytest.raises(TypeError) as jerr:
        ost.solvers.batch_minimize(
            ost.solvers.GradientDescent(), jls.BackTracking(),
            jmake_oracle(lambda x: jnp.sum(x)),
            jnp.asarray(X0[:2]), max_iters=5)
    assert str(terr.value) == str(jerr.value)
    # the lockstep knobs at their defaults are accepted; per-instance
    # boxes pass through to K3 without batched_bounds
    lo = torch.full((2, N), -1.5, dtype=torch.float64)
    r = solvers.batch_minimize(
        solvers.ProjectedGradientDescent(grad_tol=1e-6), ls.BackTrackingB(),
        oracle, tx0, bounds=(lo, -lo), batched_bounds=False, max_iter=500,
        unroll=1, callback=None)
    assert (r.status == 1).all()
    assert (r.x >= -1.5).all() and (r.x <= 1.5).all()


def test_oracle_evaluates_a_batch_and_a_point():
    f = ostt.problems.weighted_squares()
    d, t = interop.tensors_from_numpy(D, T)
    oracle = make_oracle(f, data=(d, t))
    assert oracle.raw_f is f and len(oracle.data) == 2
    (x,) = interop.tensors_from_numpy(X0[:3])
    ev = oracle(x)
    v, g = f.value_and_grad(x, d, t)
    torch.testing.assert_close(ev.f, v)
    torch.testing.assert_close(ev.g, g)
    torch.testing.assert_close(oracle.value(x), f.value(x, d, t))
    one = oracle(x[0])
    assert one.f.shape == () and one.g.shape == (N,)
    torch.testing.assert_close(oracle.value(x[0]), v[0])
    # any torch callable, through torch.func
    raw = make_oracle(lambda z, dd, tt: 0.5 * torch.sum(dd * (z - tt) ** 2),
                      data=(d, t))
    torch.testing.assert_close(raw(x).g, g)


# ---- where x0 runs -------------------------------------------------------

def test_numpy_x0_goes_to_the_gpu(monkeypatch):
    """A numpy (or list) x0 takes the CUDA route; without a card that is a
    clear error, not a quiet CPU solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = ostt.problems.weighted_squares()
    for method, bounds in (("gd", None), ("spg", (-1.0, 1.0)),
                           ("lbfgsb", (-1.0, 1.0))):
        for x0 in (X0[:2], X0[:2].tolist()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ostt.minimize(f, x0, method=method, bounds=bounds,
                              data=(D, T))
    oracle = make_oracle(f, data=(D, T))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solvers.batch_minimize(solvers.GradientDescent(), ls.BackTracking(),
                               oracle, X0[:2])


def test_cpu_tensor_runs_the_plain_version():
    (tx0,) = interop.tensors_from_numpy(X0[:2])
    before = fused_driver.fused_minimize.launches
    r = ostt.minimize(ostt.problems.weighted_squares(), tx0, method="gd",
                      data=(D, T), max_iter=3000)
    assert fused_driver.fused_minimize.launches == before
    assert r.x.device.type == "cpu" and (r.status == 1).all()


def test_bounded_method_hooks_match_jax():
    """prepare_x0 clips into the box and projected_gradient_norm masks the
    components pushing against an active bound, as the JAX methods do."""
    rng = np.random.RandomState(7)
    x = np.clip(rng.uniform(-2, 2, (5, N)), -1.0, 1.0)
    g = rng.uniform(-1, 1, (5, N))
    lo, up = np.full(N, -1.0), np.full(N, 1.0)
    jm = ost.solvers.ProjectedGradientDescent()
    tm = solvers.ProjectedGradientDescent()
    tx, tg, tlo, tup = interop.tensors_from_numpy(x, g, lo, up)
    ref = jm.projected_gradient_norm(
        jnp.asarray(x), ost.core.types.FuncEval(jnp.zeros(5), jnp.asarray(g)),
        (jnp.asarray(lo), jnp.asarray(up)))
    got = tm.projected_gradient_norm(tx, ostt.FuncEval(tx[:, 0], tg),
                                     (tlo, tup))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() < np.abs(g).max(-1)).any()  # some bound is active
    x0 = rng.uniform(-3, 3, (5, N))
    (tx0,) = interop.tensors_from_numpy(x0)
    jbounds = (jnp.asarray(lo), jnp.asarray(up))
    np.testing.assert_array_equal(
        tm.prepare_x0(tx0, (tlo, tup)).numpy(),
        np.asarray(jm.prepare_x0(jnp.asarray(x0), jbounds)))
    with pytest.raises(ValueError, match="requires bounds"):
        tm.prepare_x0(tx0, None)
    assert solvers.GradientDescent().prepare_x0(tx0, None) is tx0
