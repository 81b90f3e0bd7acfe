"""The port's ``minimize(..., method="lbfgsb")`` on the CPU against the JAX
package: against the JAX kernel K1 (interpret mode, ``tile=1``) on the two
problem-data geometries of ``tests/test_fused_lbfgsb.py``, and against JAX
``ost.minimize`` (the lockstep dcsrch solver) on the slice as a whole.

Tolerances (float64): status equal, x within 1e-6 and iterations within
+-2 against K1; against the lockstep solver, which pairs L-BFGS-B with
another line search, the minimizers within 1e-4 with every instance
CONVERGED on both sides (the standard of
``test_fused_lbfgsb_matches_unfused_quality``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu as ost
from _torch_geometries import k1_geometries
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.ops import pallas_lbfgsb as jk1
from optimization_solvers_tpu_torch import frontend, interop
from optimization_solvers_tpu_torch.ops import fused_lbfgsb

torch.set_num_threads(1)

def _ws_jax(x, dd, tt):
    return 0.5 * jnp.sum(dd * (x - tt) ** 2)


DATA_GEOMETRIES = ("mixed_infinite_bounds", "per_lane_boxes")


def _data_geometry(name):
    """(x0, lower, upper, data (d, t), minimize options); the objective is
    0.5 sum d (x - t)^2 on both sides."""
    _, x0, lo, up, data, opts = k1_geometries()[name]
    opts = dict(opts)
    opts["tol"] = opts.pop("pgtol")
    return x0, lo, up, data, opts


@pytest.fixture(scope="module")
def jax_k1():
    cache = {}

    def get(name):
        if name not in cache:
            x0, lo, up, data, opts = _data_geometry(name)
            cache[name] = jk1.lbfgsb_solve_fused(
                _ws_jax, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(up),
                consts=tuple(jnp.asarray(c) for c in data), m=5, tile=1,
                interpret=True, pgtol=opts["tol"], factr=opts["factr"],
                max_iter=opts["max_iter"])
        return cache[name]

    return get


@pytest.mark.parametrize("name", DATA_GEOMETRIES)
def test_minimize_matches_jax_kernel_with_data(name, jax_k1):
    x0, lo, up, data, opts = _data_geometry(name)
    tx0, tlo, tup, *tdata = interop.tensors_from_numpy(x0, lo, up, *data)
    r = interop.result_to_numpy(ostt.minimize(
        ostt.problems.weighted_squares(), tx0, method="lbfgsb",
        bounds=(tlo, tup), data=tuple(tdata), **opts))
    ref = jax_k1(name)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    assert np.abs(r.iterations.astype(np.int64)
                  - np.asarray(ref.iterations)).max() <= 2
    assert (r.status == ostt.Status.CONVERGED).all()


@pytest.fixture(scope="module")
def slice_inputs():
    n = 12
    x0 = np.random.RandomState(2).uniform(-1.4, 1.4, (8, n))
    opts = dict(tol=1e-7, factr=10.0, max_iter=1000)
    ref = ost.minimize(jprob.rosenbrock(), jnp.asarray(x0), method="lbfgsb",
                       bounds=(-1.5, 1.5), **opts)
    return x0, opts, ref


def test_slice_matches_jax_minimize(slice_inputs):
    x0, opts, ref = slice_inputs
    (tx0,) = interop.tensors_from_numpy(x0)
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    r = interop.result_to_numpy(ostt.minimize(
        ostt.problems.rosenbrock(), tx0, method="lbfgsb",
        bounds=(-1.5, 1.5), **opts))
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before
    assert (np.asarray(ref.status) == 1).all()
    assert (r.status == 1).all()
    np.testing.assert_allclose(r.x, np.asarray(ref.x), atol=1e-4)


def test_slice_with_raw_torch_callable_matches_objective(slice_inputs):
    """Any torch callable runs on the CPU through torch.func autodiff."""
    x0, opts, _ = slice_inputs
    (tx0,) = interop.tensors_from_numpy(x0[:3])
    obj = ostt.problems.rosenbrock()
    r1 = ostt.minimize(obj, tx0, method="lbfgsb", bounds=(-1.5, 1.5), **opts)
    r2 = ostt.minimize(lambda x: obj(x), tx0, method="lbfgsb",
                       bounds=(-1.5, 1.5), **opts)
    assert (r1.status == 1).all() and (r2.status == 1).all()
    torch.testing.assert_close(r1.x, r2.x, rtol=0, atol=1e-6)


# ---- option handling -----------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    seen = {}

    def fake(f, x0, lower, upper, data, **kw):
        seen.update(x0=x0, lower=lower, upper=upper, data=data, **kw)
        return "result"

    monkeypatch.setattr(frontend, "lbfgsb_solve_fused", fake)
    return seen


@pytest.mark.parametrize("dtype,tol,factr", [(torch.float64, 1e-6, 1e7),
                                             (torch.float32, 1e-4, 100.0)])
def test_dtype_aware_defaults(spy, dtype, tol, factr):
    x0 = torch.zeros((3, 4), dtype=dtype)
    assert ostt.minimize(ostt.problems.rosenbrock(), x0,
                         method="lbfgsb") == "result"
    assert spy["pgtol"] == tol and spy["factr"] == factr
    assert spy["max_iter"] == 1000 and spy["max_iter_ls"] == 20
    assert spy["m"] == 5 and spy["c1"] == 1e-3
    # bounds=None means +-inf, shared (n,)
    assert spy["lower"].shape == (4,) and torch.isneginf(spy["lower"]).all()
    assert torch.isposinf(spy["upper"]).all()


def test_bounds_and_data_forms(spy):
    x0 = torch.zeros((3, 4), dtype=torch.float64)
    ostt.minimize(ostt.problems.rosenbrock(), x0, method="l-bfgs-b",
                  bounds=(-2.0, np.full(4, 3.0)), data=(np.ones(4, np.float32),
                                                       np.arange(4)),
                  m=7, ls_c1=1e-4, max_iter_ls=30, pgtol=1e-3)
    assert spy["lower"].tolist() == [-2.0] * 4
    assert spy["upper"].tolist() == [3.0] * 4
    assert spy["data"][0].dtype == torch.float64        # cast to x0's dtype
    assert spy["data"][1].dtype == torch.int64          # left as it is
    assert (spy["m"], spy["c1"], spy["max_iter_ls"], spy["pgtol"]) == (
        7, 1e-4, 30, 1e-3)
    per_lane = np.tile(np.arange(4.0), (3, 1))
    ostt.minimize(ostt.problems.rosenbrock(), x0, method="lbfgsb",
                  bounds=(-per_lane, per_lane))
    assert spy["lower"].shape == (3, 4) and spy["upper"].shape == (3, 4)


def test_unknown_and_unported_options_raise(spy):
    x0 = torch.zeros((3, 4), dtype=torch.float64)
    f = ostt.problems.rosenbrock()
    with pytest.raises(TypeError, match="unknown lbfgsb option"):
        ostt.minimize(f, x0, method="lbfgsb", no_such_option=1)
    for opt in (dict(ls_c2=0.5), dict(rel_pg_stop=True), dict(verbose=1),
                dict(curvature_eps=1e-8)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ostt.minimize(f, x0, method="lbfgsb", **opt)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ostt.minimize(f, x0, method="bfgs")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ostt.minimize(f, x0)                   # default method: lbfgs
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ostt.minimize(f, x0[0], method="lbfgsb")
    for opt in (dict(precision="f32x2"), dict(policy="reference"),
                dict(search=None), dict(polish_max_iter=10)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ostt.minimize(f, x0, method="lbfgsb", **opt)
    assert spy == {}
    # config fields the fused route ignores in JAX too are accepted
    ostt.minimize(f, x0, method="lbfgsb", gcp_chunk=64,
                  tall_line_search="dcsrch")
    assert spy["m"] == 5
