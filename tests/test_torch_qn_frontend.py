"""The port's ``minimize`` for the dense quasi-Newton and L-BFGS rows, on
the CPU against the JAX package.

The reference is JAX K3 (``ops.pallas_driver.fused_minimize``) in
interpret mode with ``tile=B``, given the method and search configs that
the JAX front end builds for the same call (``frontend._method_and_search``,
as ``test_torch_driver_frontend.py`` does for the first-order rows).
Tolerances (float64): status and iteration counts equal, x and pg_norm
within 1e-9, f within 1e-12 relative or 1e-15 abs.  The routing tests spy
on the spec that reaches K3: the row's method and default search, ``tol``
in the quasi-Newton ``tol`` field, and the float32 ``approx_wolfe`` overlay
of ``policy="fast"`` (JAX ``frontend.py:479-484``).  JAX's validation
errors for these rows are cases of ``test_validation_errors_match_jax`` in
``test_torch_driver_frontend.py``.
"""

import numpy as np
import pytest
import torch

import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu import frontend as jfront
from optimization_solvers_tpu_torch import interop, linesearch as ls
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_driver
from test_torch_driver_frontend import D, T, X0, jax_k3, port

torch.set_num_threads(1)

BOX = (-1.5, 2.5)
# the bounded rows' target lies inside the box (x0 does not): with the
# target outside, the raw 2-norm test cannot pass and the solves end in
# the s/y stall, whose end point moves by ~1e-8 under a 1e-15 change of x0
T_IN = np.linspace(-1.2, 2.2, 8)
CASES = {
    # name: (method, bounds, options, port search, JAX search)
    "bfgs": ("bfgs", None, {}, None, None),
    "dfp": ("dfp", None, {}, None, None),
    "broyden": ("broyden", None, {}, None, None),
    "bfgsb": ("bfgsb", BOX, {}, None, None),
    "dfpb": ("dfpb", BOX, {}, None, None),
    "broydenb": ("broydenb", BOX, {}, None, None),
    "sr1b": ("sr1b", BOX, {}, None, None),
    "lbfgs": ("lbfgs", None, {"m": 4}, None, None),
    "l_bfgs_alias": ("l-bfgs", None, {}, None, None),
    "bfgs_robust": ("bfgs", None, {"scale_b0": True,
                                   "restart_on_degeneracy": True}, None,
                    None),
    "bfgs_hz": ("bfgs", None, {}, ls.HagerZhang(), jls.HagerZhang()),
    "lbfgs_sw": ("lbfgs", None, {}, ls.StrongWolfe(), jls.StrongWolfe()),
    "lbfgs_mt": ("lbfgs", None, {}, ls.MoreThuente(), jls.MoreThuente()),
    "bfgsb_sw_bounded": ("bfgsb", BOX, {}, ls.StrongWolfe(bounded=True),
                         jls.StrongWolfe(bounded=True)),
    "sr1b_hzb": ("sr1b", BOX, {}, ls.HagerZhangB(), jls.HagerZhangB()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_minimize_matches_jax_kernel(name):
    method, bounds, options, search, jsearch = CASES[name]
    data = (D, T) if bounds is None else (D, T_IN)
    ref = jax_k3(method, X0, bounds, 1e-8, options, search=jsearch,
                 data=data)
    r = port(method, X0, bounds, 1e-8, options, search=search, data=data)
    assert np.isin(r.status, (Status.CONVERGED, Status.STALLED)).all()
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm), rtol=0,
                               atol=1e-9)


@pytest.fixture
def seen(monkeypatch):
    """The (method, spec) pairs that reach K3."""
    calls = []
    orig = fused_driver.solve_spec

    def spy(spec, method, *a, **kw):
        calls.append((method, spec))
        return orig(spec, method, *a, **kw)

    monkeypatch.setattr(fused_driver, "solve_spec", spy)
    return calls


@pytest.mark.parametrize("method, cls, search, bounded", [
    ("bfgs", "QuasiNewton", fused_driver.MT, False),
    ("dfp", "QuasiNewton", fused_driver.MT, False),
    ("broyden", "QuasiNewton", fused_driver.MT, False),
    ("bfgsb", "QuasiNewtonB", fused_driver.MTB, True),
    ("dfpb", "QuasiNewtonB", fused_driver.MTB, True),
    ("broydenb", "QuasiNewtonB", fused_driver.MTB, True),
    ("sr1b", "QuasiNewtonB", fused_driver.MTB, True),
    ("lbfgs", "LBFGS", fused_driver.HZ, False),
])
def test_table_rows_and_tol_field(seen, method, cls, search, bounded):
    """Each row builds JAX's config (class, update rule, default search),
    and ``tol`` fills the quasi-Newton ``tol`` field."""
    port(method, X0[:2], BOX if bounded else None, 3e-5, {}, max_iter=3)
    (m, spec), = seen
    make_jm, jsearch = jfront._method_and_search(method, 3e-5, {})[1:3]
    jm = make_jm()
    assert type(m).__name__ == cls == type(jm).__name__
    assert m.tol == jm.tol == 3e-5 and spec.tol == 3e-5
    assert getattr(m, "update", None) == getattr(jm, "update", None)
    assert type(jsearch).__name__ == ("HagerZhang" if method == "lbfgs"
                                      else "MoreThuente" + "B" * bounded)
    assert spec.search == search and spec.bounded == bounded


@pytest.mark.parametrize("dtype, policy, search, expected", [
    (torch.float32, "fast", None, True),
    (torch.float32, "reference", None, False),
    (torch.float64, "fast", None, False),
    (torch.float32, "fast", ls.MoreThuente(), False),
])
def test_fast_policy_approx_wolfe_overlay(seen, dtype, policy, search,
                                          expected):
    """float32 + ``policy="fast"`` + the default More-Thuente search gains
    ``approx_wolfe``; the reference policy, float64 and a given search do
    not; a Hager-Zhang default has no such field and is left alone."""
    for method, bounds in (("bfgs", None), ("sr1b", BOX)):
        port(method, X0[:2], bounds, 1e-6, {}, search=search, policy=policy,
             max_iter=3, dtype=dtype)
    port("lbfgs", X0[:2], None, 1e-6, {}, policy=policy, max_iter=3,
         dtype=dtype)
    assert [s.approx_wolfe for _, s in seen] == [expected, expected, False]
    assert seen[-1][1].search == fused_driver.HZ


def test_default_method_is_lbfgs_and_stalled_is_success():
    """``minimize`` without a method runs L-BFGS + Hager-Zhang; a dense
    quasi-Newton solve that stalls at the box reports STALLED (6)."""
    (tx0,) = interop.tensors_from_numpy(X0[:4])
    r = ostt.minimize(ostt.problems.weighted_squares(), tx0, data=(D, T),
                      tol=1e-8)
    assert (r.status == Status.CONVERGED).all()
    np.testing.assert_allclose(r.x.numpy(), np.broadcast_to(T, (4, 8)),
                               atol=1e-8)
    r = ostt.minimize(ostt.problems.weighted_squares(), tx0, data=(D, T),
                      method="bfgsb", bounds=BOX, tol=1e-6)
    assert (r.status == Status.STALLED).all()
