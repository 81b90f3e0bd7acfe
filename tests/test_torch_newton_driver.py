"""The port's generic driver K3, Newton form (Newton, ProjectedNewton,
SpectralProjectedNewton with every search), against the JAX Pallas kernel
``ops.pallas_driver.fused_minimize``, and the Hessian and HVP forms of the
problem library against automatic differentiation.

The JAX reference runs in interpret mode with ``tile=B`` and traces
``jax.hessian`` into its kernel; the port's plain version takes the
objective's analytic Hessian (library objectives) or ``torch.func``'s (any
other torch callable) and runs ``fused_minimize`` on a CPU tensor.
Geometries are ``tests/_torch_geometries.py:k3_newton_geometries`` plus the
torch-callable objectives of ``tests/test_fused_driver.py:95-157`` (the
coupled dense-Hessian objective and the non-positive-definite
``cosh - 2 exp(-x^2)``), which only the CPU runs.

Tolerances (float64): status equal per instance; iteration counts equal,
x within 1e-9 abs and f within 1e-12 relative or 1e-15 abs.  The
Rosenbrock entries are held to ``max(2, spread)`` iterations, with
``spread`` the port's own range under 6 changes of x0 by 1e-15 relative,
and x to the entry's ``x_atol``.  Hessians and HVPs agree with both
autodiffs within 1e-12 relative (plus 1e-9 abs for Rosenbrock's ~1e3
entries).  The CUDA kernel is held against the plain version on the card
in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
from _torch_geometries import (k3_newton_geometries, lse_arrays, spd_arrays,
                               perturbation_spread)
from optimization_solvers_tpu.core import problems as jproblems
from optimization_solvers_tpu.core import types as jtypes
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.types import FuncEval, Status
from optimization_solvers_tpu_torch.ops import fused_driver
from test_torch_fused_driver import _rosen_jax, _ws_jax, to_jax

torch.set_num_threads(1)

F_RTOL, F_ATOL = 1e-12, 1e-15
GEOMETRIES = k3_newton_geometries()


def _quad_jax(x, Q):
    return 0.5 * jnp.sum(x * (Q @ x))


JAX_OBJECTIVES = {"rosenbrock": _rosen_jax, "weighted_squares": _ws_jax,
                  "quadratic": _quad_jax}


def run_jax(g, dtype=np.float64):
    def arr(a):
        return None if a is None else jnp.asarray(np.asarray(a, dtype))

    return jk3.fused_minimize(
        to_jax(g["method"]), to_jax(g["search"]),
        JAX_OBJECTIVES[g["jax_objective"]], arr(g["x0"]), arr(g["lower"]),
        arr(g["upper"]), consts=tuple(arr(c) for c in g["jax_data"]),
        max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"],
        tile=g["x0"].shape[0], interpret=True)


def run_port(g, x0=None, dtype=torch.float64):
    """The port's ``fused_minimize`` (plain version and epilogue)."""
    x0 = g["x0"] if x0 is None else x0
    tx0, *tdata = interop.tensors_from_numpy(x0, *g["data"], dtype=dtype)
    lo, up = (None if b is None else interop.tensors_from_numpy(
        b, dtype=dtype)[0] for b in (g["lower"], g["upper"]))
    return interop.result_to_numpy(fused_driver.fused_minimize(
        g["method"], g["search"], g["objective"], tx0, lo, up, tuple(tdata),
        max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"]))


@pytest.fixture(scope="module")
def jax_reference():
    """JAX K3 results per geometry, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_jax(GEOMETRIES[name])
        return cache[name]

    return get


def assert_matches(r, ref, g):
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    dit = np.abs(r.iterations.astype(np.int64)
                 - np.asarray(ref.iterations)).max()
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda v: run_port(g, v).iterations, g["x0"], runs=6)
        assert dit <= max(2, spread), (dit, spread)
    else:
        assert dit == 0
        np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=g["f_rtol"],
                                   atol=F_ATOL)
    finite = np.isfinite(r.f)
    np.testing.assert_allclose(r.x[finite], np.asarray(ref.x)[finite],
                               rtol=1e-12, atol=g["x_atol"])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_kernel(name, jax_reference):
    g = GEOMETRIES[name]
    assert_matches(run_port(g), jax_reference(name), g)


def test_geometries_exercise_what_they_are_named_for(jax_reference):
    """The fallback, the BB freeze, the out-of-domain start and the
    active bounds happen, on both sides."""
    # Rosenbrock-8 Hessians are indefinite at many starts: the factor
    # fails there and Newton takes -g; every lane still converges
    r = run_port(GEOMETRIES["newton_bt_rosenbrock"])
    assert (r.status == Status.CONVERGED).all()
    # the reference BB update freezes on the Newton direction; precond_bb
    # ends in a couple of iterations
    ref = run_port(GEOMETRIES["spn_btb_config5"])
    fast = run_port(GEOMETRIES["spn_precond_btb_config5"])
    assert (ref.iterations == 50).all() and (fast.status == 1).all()
    assert fast.iterations.max() <= 3
    pn5 = run_port(GEOMETRIES["pn_btb_config5"])
    assert (pn5.status == 1).all() and pn5.iterations.max() <= 2
    ood = run_port(GEOMETRIES["newton_nosearch_out_of_domain"])
    jood = jax_reference("newton_nosearch_out_of_domain")
    for st, it in ((ood.status, ood.iterations),
                   (np.asarray(jood.status), np.asarray(jood.iterations))):
        assert st[0] == Status.CONVERGED and it[0] == 1
        assert st[1] == Status.OUT_OF_DOMAIN and it[1] == 0
    g = GEOMETRIES["pn_btb_active_bound"]
    np.testing.assert_allclose(run_port(g).x, 1.0, atol=1e-6)


# ---- objectives that only the CPU runs: torch callables -----------------

def _coupled(x, d):
    s = torch.sum(x)
    return 0.5 * torch.sum(d * x * x) + 0.25 * s ** 4 / x.shape[-1]


def _coupled_jax(x, d):
    s = jnp.sum(x)
    return 0.5 * jnp.sum(d * x * x) + 0.25 * s ** 4 / x.shape[-1]


def _nonpd(x):
    return torch.sum(torch.cosh(x) - 2.0 * torch.exp(-x * x))


def _nonpd_jax(x):
    return jnp.sum(jnp.cosh(x) - 2.0 * jnp.exp(-x * x))


N, B = 8, 16
_X0 = np.random.RandomState(0).uniform(-2, 2, (B, N))
_D = np.linspace(1.0, 50.0, N)
CALLABLE_CASES = {
    # name: (method, search, objective, JAX objective, x0, bounded, data,
    #        max_iter)
    "newton_bt_coupled": (solvers.Newton(tol=1e-12), ls.BackTracking(),
                          _coupled, _coupled_jax, _X0, False, (_D,), 200),
    "pn_btb_coupled": (solvers.ProjectedNewton(grad_tol=1e-8),
                       ls.BackTrackingB(), _coupled, _coupled_jax, _X0, True,
                       (_D,), 200),
    "spn_btb_coupled": (solvers.SpectralProjectedNewton(grad_tol=1e-8),
                        ls.BackTrackingB(), _coupled, _coupled_jax, _X0, True,
                        (_D,), 200),
    "spn_precond_btb_coupled": (
        solvers.SpectralProjectedNewton(grad_tol=1e-8, precond_bb=True),
        ls.BackTrackingB(), _coupled, _coupled_jax, _X0, True, (_D,), 200),
    # tests/test_fused_driver.py:175: starts where H is not positive
    # definite; the fallback direction must not emit NaN
    "newton_bt_nonpd": (solvers.Newton(tol=1e-12), ls.BackTracking(), _nonpd,
                        _nonpd_jax,
                        np.random.RandomState(3).uniform(-0.4, 0.4, (8, 4)),
                        False, (), 300),
}


@pytest.mark.parametrize("name", sorted(CALLABLE_CASES))
def test_plain_with_torch_func_hessians_matches_jax_kernel(name):
    method, search, f, fj, x0, bounded, data, max_iter = CALLABLE_CASES[name]
    n = x0.shape[1]
    lo, up = (np.full(n, -1.5), np.full(n, 2.5)) if bounded else (None, None)
    ref = jk3.fused_minimize(
        to_jax(method), to_jax(search), fj, jnp.asarray(x0),
        None if lo is None else jnp.asarray(lo),
        None if up is None else jnp.asarray(up),
        consts=tuple(jnp.asarray(c) for c in data), max_iter=max_iter,
        max_iter_ls=40, tile=x0.shape[0], interpret=True)
    tx0, *tdata = interop.tensors_from_numpy(x0, *data)
    tlo, tup = (None, None) if lo is None else interop.tensors_from_numpy(
        lo, up)
    r = interop.result_to_numpy(fused_driver.fused_minimize(
        method, search, f, tx0, tlo, tup, tuple(tdata), max_iter=max_iter,
        max_iter_ls=40))
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=F_RTOL,
                               atol=F_ATOL)
    assert np.isfinite(r.f).all()
    if name == "newton_bt_nonpd":
        assert (r.status == Status.CONVERGED).all()


def test_log_sum_exp_hessian_on_the_cpu_matches_jax_kernel():
    """The plain version takes log_sum_exp's analytic Hessian (the CUDA
    kernel has no functor for it yet)."""
    A, b = lse_arrays(12, 6)
    x0 = np.random.RandomState(2).uniform(-0.5, 0.5, (4, 12))
    lo, up = np.full(12, -1.0), np.full(12, 1.0)
    method, search = solvers.ProjectedNewton(grad_tol=1e-9), ls.BackTrackingB()
    ref = jk3.fused_minimize(
        to_jax(method), to_jax(search),
        lambda x, A_, b_: jproblems.log_sum_exp(A_, b_)(x), jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(up), consts=(jnp.asarray(A),
                                                  jnp.asarray(b)),
        max_iter=100, max_iter_ls=40, tile=4, interpret=True)
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    r = interop.result_to_numpy(fused_driver.fused_minimize(
        method, search, problems.log_sum_exp(A, b), tx0, tlo, tup,
        max_iter=100, max_iter_ls=40))
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)


# ---- the Hessian and HVP forms ------------------------------------------

def _forms():
    """name -> (port objective, port data, JAX objective f(x)), float64."""
    rng = np.random.RandomState(12)
    n = 7
    d, t = rng.uniform(1, 5, n), rng.uniform(-1, 1, n)
    Q, bq = rng.standard_normal((n, n)), rng.standard_normal(n)
    A, b = lse_arrays(n, 5)
    return {
        "rosenbrock": (problems.rosenbrock(), (), jproblems.rosenbrock()),
        "weighted_squares": (problems.weighted_squares(), (d, t),
                             lambda x: _ws_jax(x, d, t)),
        "diag_quadratic": (problems.diag_quadratic(d), (),
                           jproblems.diag_quadratic(jnp.asarray(d))),
        # not symmetric: the Hessian is 0.5 (Q + Q^T), as autodiff says
        "quadratic": (problems.quadratic(Q, bq), (),
                      jproblems.quadratic(jnp.asarray(Q), jnp.asarray(bq))),
        "log_sum_exp": (problems.log_sum_exp(A, b), (),
                        jproblems.log_sum_exp(jnp.asarray(A),
                                              jnp.asarray(b))),
    }


@pytest.mark.parametrize("name", sorted(_forms()))
def test_hessian_and_hvp_forms_match_autodiff(name):
    obj, data, fj = _forms()[name]
    rng = np.random.RandomState(13)
    X = rng.uniform(-1.5, 1.5, (5, 7))
    V = rng.standard_normal((5, 7))
    tX, tV, *tdata = interop.tensors_from_numpy(X, V, *data)
    H = obj.hessian(tX, *tdata)
    Hv = obj.hvp(tX, tV, *tdata)
    assert H.shape == (5, 7, 7) and Hv.shape == (5, 7)
    torch_h = torch.func.vmap(torch.func.hessian(obj),
                              in_dims=(0,) + (None,) * len(tdata))(tX, *tdata)
    jax_h = np.asarray(jax.vmap(jax.hessian(fj))(jnp.asarray(X)))
    jax_hv = np.asarray(jax.vmap(
        lambda x, v: jax.jvp(jax.grad(fj), (x,), (v,))[1])(
            jnp.asarray(X), jnp.asarray(V)))
    atol = 1e-9 if name == "rosenbrock" else 1e-13
    for ref_h in (torch_h.numpy(), jax_h):
        np.testing.assert_allclose(H.numpy(), ref_h, rtol=1e-12, atol=atol)
    np.testing.assert_allclose(Hv.numpy(), jax_hv, rtol=1e-12, atol=atol)
    np.testing.assert_allclose(Hv.numpy(),
                               np.einsum("bij,bj->bi", jax_h, V),
                               rtol=1e-12, atol=atol)
    if name != "quadratic":
        return
    # exactly symmetric, which K3's upper-triangle factorization needs
    assert torch.equal(H, H.transpose(1, 2))


# ---- float32 -------------------------------------------------------------

@pytest.mark.parametrize("name", ["pn_btb", "newton_mt",
                                  "spn_precond_btb_config5"])
def test_float32_matches_jax_by_status_and_median_f(name):
    g = GEOMETRIES[name]
    field = "grad_tol" if hasattr(g["method"], "grad_tol") else "tol"
    g = dict(g, method=dataclasses.replace(g["method"], **{field: 1e-4}))
    ref = run_jax(g, np.float32)
    r = run_port(g, dtype=torch.float32)
    assert r.x.dtype == np.float32
    np.testing.assert_array_equal(np.bincount(r.status, minlength=7),
                                  np.bincount(np.asarray(ref.status),
                                              minlength=7))
    assert abs(float(np.median(np.asarray(ref.f)))
               - float(np.median(r.f))) <= 1e-5


# ---- configs, specs and refusals ----------------------------------------

def _newton_methods():
    return [solvers.Newton(), solvers.ProjectedNewton(),
            solvers.SpectralProjectedNewton(),
            solvers.SpectralProjectedNewton(precond_bb=True)]


def _searches():
    return [ls.BackTracking(), ls.BackTrackingB(), ls.GLLQuadratic(),
            ls.NoSearch(), ls.MoreThuente(), ls.MoreThuenteB(),
            ls.MoreThuente(reference_quirks=True), ls.HagerZhang(),
            ls.HagerZhangB(), ls.StrongWolfe(), ls.StrongWolfe(bounded=True)]


def test_spec_builder_matches_jax_fused_supported():
    for m in _newton_methods():
        for s in _searches():
            assert fused_driver.fused_supported(m, s) == jk3.fused_supported(
                to_jax(m), to_jax(s)), (m, s)
    spec = fused_driver.build_spec(
        solvers.SpectralProjectedNewton(grad_tol=1e-5, lambda_min=0.1,
                                        precond_bb=True), ls.BackTrackingB())
    assert (spec.method, spec.bounded, spec.precond_bb) == (
        fused_driver.SPN, True, True)
    assert (spec.tol, spec.lam_min, spec.lam_max) == (1e-5, 0.1, 1e3)
    assert fused_driver.build_spec(solvers.Newton(tol=3e-9),
                                   ls.MoreThuente()).tol == 3e-9


def test_configs_match_jax():
    for name in ("Newton", "ProjectedNewton", "SpectralProjectedNewton"):
        port, ref = getattr(solvers, name)(), getattr(jsolvers, name)()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert port.needs_hessian and ref.needs_hessian
    # the lockstep direction bodies: per instance, JAX's vmapped
    H, g = spd_arrays(3, 6, seed=7)
    x = np.random.RandomState(7).uniform(-1.0, 1.0, (3, 6))
    lo, up = np.full(6, -0.8), np.full(6, 0.9)
    tH, tg, tx, tlo, tup = interop.tensors_from_numpy(H, g, x, lo, up)
    for name in ("Newton", "ProjectedNewton", "SpectralProjectedNewton"):
        port, ref = getattr(solvers, name)(), getattr(jsolvers, name)()
        bounds = None if name == "Newton" else (tlo, tup)
        jb = None if name == "Newton" else (jnp.asarray(lo), jnp.asarray(up))
        ev = FuncEval(torch.zeros(3, dtype=torch.float64), tg, tH)
        d, _ = port.direction(port.init(tx, ev, bounds), tx, ev, bounds)

        def jdir(xi, gi, hi, ref=ref, jb=jb):
            jev = jtypes.FuncEval(jnp.zeros(()), gi, hi)
            return ref.direction(ref.init(xi, jev, jb), xi, jev, jb)[0]

        jd = jax.vmap(jdir)(jnp.asarray(x), jnp.asarray(g), jnp.asarray(H))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-12, err_msg=name)
    with pytest.raises(ValueError, match="requires bounds"):
        solvers.SpectralProjectedNewton().prepare_x0(torch.zeros(3), None)


def test_slabs_and_refusals():
    """One (n, n) slab per instance in device memory, 7 n elements of
    shared memory; a log-sum-exp's rows count in the Newton form's fit, and
    the wrapper refuses one past it before anything is built."""
    for method in (fused_driver.NEWTON, fused_driver.PN, fused_driver.SPN):
        assert fused_driver.workspace_elems(256, 1024, method) == (
            256 * 1024 * 1024)
    assert fused_driver.smem_per_instance(1024, 0, 4) == 7 * 1024 * 4
    assert fused_driver.fits(1024, 0, 8)
    A, b = lse_arrays(6, 30000)
    spec = fused_driver.build_spec(solvers.Newton(), ls.BackTracking())
    (x0,) = interop.tensors_from_numpy(np.zeros((2, 6)))
    with pytest.raises(NotImplementedError, match="shared memory"):
        fused_driver._launch_cuda(spec, problems.log_sum_exp(A, b), x0, None,
                                  None, (), 5, 5)
    newton = fused_driver.NEWTON
    assert fused_driver.smem_per_instance(
        256, 0, 4, method=newton, rows=512) == fused_driver.smem_per_instance(
            256, 0, 4, method=newton) + 512 * 4
    assert fused_driver.fits(6, 0, 8, 0, newton, 18000)
    assert not fused_driver.fits(6, 0, 8, 0, newton, 30000)
    # the one-warp forms hold a log-sum-exp's z too: it runs there since
    # the quasi-Newton and Wolfe forms compile it
    assert fused_driver.smem_per_instance(256, 0, 4, rows=512) == (
        fused_driver.smem_per_instance(256, 0, 4) + 512 * 4)
    with pytest.raises(ValueError, match="requires bounds"):
        fused_driver.fused_minimize(solvers.ProjectedNewton(),
                                    ls.BackTrackingB(),
                                    problems.rosenbrock(), x0)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_newton_form_fits_every_width_it_fitted(itemsize):
    """The Newton form's block (the factorization's scratch over D, GN and
    XT, then X, G, the command words and the GLL history) takes every width
    the one-warp form took (7 n + ring elements), at GLL histories of 0 to
    1,000, and still routes config 5 (n = 1,024) to K3."""
    for ring in (0, 1, 10, 100, 1000):
        took = [n for n in range(1, 9000)
                if (7 * n + ring) * itemsize <= fused_driver.SMEM_PER_BLOCK]
        assert took and all(fused_driver.fits(n, ring, itemsize, 0, method)
                            for n in took
                            for method in fused_driver.NEWTON_METHODS)
    assert fused_driver.fits(1024, 0, itemsize, 0, fused_driver.PN)
    # two blocks share an SM at config 5's width in float32
    if itemsize == 4:
        assert 2 * fused_driver.smem_per_instance(
            1024, 0, 4, method=fused_driver.PN) <= 228 * 1024 - 2048
