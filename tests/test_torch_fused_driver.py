"""The port's generic driver K3 (first-order slice) against the JAX Pallas
kernel ``ops.pallas_driver.fused_minimize``.

The JAX reference runs in interpret mode with ``tile=B``: K3's lanes are
independent (every state write is masked by its own lane), so the tile
does not change what a lane computes, and the port runs one instance at a
time.  Geometries are ``tests/_torch_geometries.py:k3_geometries``.

Tolerances (float64):
* status equal per instance;
* iteration counts equal, x within 1e-9 abs (1e-12 relative where the
  out-of-domain lanes have overflowed to ~1e100), f within 1e-12 relative
  or 1e-15 abs (f tends to 0 at these minimizers);
* on the chaotic entries (Rosenbrock, GD + GLL on the stiff quadratic) a
  1e-15 relative change of x0 alone moves the counts, so they are held to
  ``max(2, spread)`` with ``spread`` the port's own range over 6 such
  changes, and x to the entry's ``x_atol``.

float32 is held by status counts and median f (a one-ulp change moves
individual instances).  The CUDA kernel is held against the plain version
on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
from _torch_geometries import k3_geometries, perturbation_spread
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu_torch import interop, linesearch as ls, solvers
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_driver

torch.set_num_threads(1)

F_RTOL, F_ATOL = 1e-12, 1e-15
GEOMETRIES = k3_geometries()


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def to_jax(cfg):
    """The JAX package's config of the same class name and fields."""
    cls = getattr(jsolvers, type(cfg).__name__, None) or getattr(
        jls, type(cfg).__name__)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if kw.get("inverse_p") is not None:
        kw["inverse_p"] = jnp.asarray(np.asarray(kw["inverse_p"]))
    return cls(**kw)


def jax_objective(g):
    return _rosen_jax if g["objective"].functor == "ROSENBROCK" else _ws_jax


def run_jax(g, dtype=np.float64, method=None):
    def arr(a):
        return None if a is None else jnp.asarray(np.asarray(a, dtype))

    return jk3.fused_minimize(
        to_jax(method or g["method"]), to_jax(g["search"]), jax_objective(g),
        arr(g["x0"]), arr(g["lower"]), arr(g["upper"]),
        consts=tuple(arr(c) for c in g["data"]), max_iter=g["max_iter"],
        max_iter_ls=g["max_iter_ls"], tile=g["x0"].shape[0], interpret=True)


def run_plain(g, x0=None, dtype=torch.float64, method=None):
    """(x, f, iterations, status, nfev) of the port's plain version."""
    x0 = g["x0"] if x0 is None else x0
    tx0, *tdata = interop.tensors_from_numpy(x0, *g["data"], dtype=dtype)
    lo, up = (None if b is None else interop.tensors_from_numpy(
        b, dtype=dtype)[0] for b in (g["lower"], g["upper"]))
    return fused_driver.fused_minimize_plain(
        method or g["method"], g["search"], g["objective"], tx0, lo, up,
        tuple(tdata), max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])


@pytest.fixture(scope="module")
def jax_reference():
    """JAX K3 results per geometry, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_jax(GEOMETRIES[name])
        return cache[name]

    return get


def assert_matches(port, ref, g, spread):
    x, f, it, st = (v.numpy() for v in port[:4])
    np.testing.assert_array_equal(st, np.asarray(ref.status))
    dit = np.abs(it.astype(np.int64) - np.asarray(ref.iterations)).max()
    if g["chaotic"]:
        assert dit <= max(2, spread), (dit, spread)
    else:
        assert dit == 0
        np.testing.assert_allclose(f, np.asarray(ref.f), rtol=F_RTOL,
                                   atol=F_ATOL)
    np.testing.assert_allclose(x, np.asarray(ref.x), rtol=1e-12,
                               atol=g["x_atol"])


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_kernel(name, jax_reference):
    g = GEOMETRIES[name]
    spread = 0
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda v: run_plain(g, v)[2].numpy(), g["x0"], runs=6)
    assert_matches(run_plain(g), jax_reference(name), g, spread)


def test_edge_geometries_end_as_designed(jax_reference):
    """The edge entries exercise what they are named for, on both sides."""
    st = jax_reference("gd_bt_converge_at_budget").status
    it = jax_reference("gd_bt_converge_at_budget").iterations
    budget = GEOMETRIES["gd_bt_converge_at_budget"]["max_iter"]
    at_budget = np.asarray(it) == budget
    assert at_budget.all()
    assert (np.asarray(st) == Status.CONVERGED).sum() == 1
    assert set(np.asarray(st).tolist()) == {Status.CONVERGED,
                                            Status.MAX_ITER_REACHED}
    ood = np.asarray(jax_reference("out_of_domain").status)
    assert ood.tolist() == [Status.CONVERGED] + [Status.OUT_OF_DOMAIN] * 3
    # per-instance boxes: each lane lands on its own box's clip of the target
    g = GEOMETRIES["spg_gll_per_instance_boxes"]
    x = run_plain(g)[0].numpy()
    np.testing.assert_allclose(x, np.clip(1.2, g["lower"], g["upper"]),
                               atol=1e-6)
    stiff = run_plain(GEOMETRIES["gll_stiff_quadratic"])[3].numpy()
    assert (stiff == Status.CONVERGED).mean() >= 0.95


F32_CASES = ("gd_bt", "gd_gll", "pgd_btb", "spg_gll_bb1", "spg_gll_alternate",
             "ncg_pr+_bt")


@pytest.mark.parametrize("name", F32_CASES)
def test_float32_matches_jax_by_status_and_median_f(name):
    """float32 at grad_tol 1e-4 (1e-6 is below float32's gradient noise
    on these scales): the same number of CONVERGED instances and median
    f within 1e-6 of each other (f starts at 10-100)."""
    g = GEOMETRIES[name]
    method = dataclasses.replace(g["method"], grad_tol=1e-4)
    ref = run_jax(g, np.float32, method)
    x, f, it, st, _ = run_plain(g, dtype=torch.float32, method=method)
    assert x.dtype == torch.float32 and f.dtype == torch.float32
    n_ref = int((np.asarray(ref.status) == Status.CONVERGED).sum())
    assert int((st == Status.CONVERGED).sum()) == n_ref
    assert abs(float(np.median(np.asarray(ref.f)))
               - float(f.median())) <= 1e-6


def test_spec_builder_matches_jax_fused_supported():
    """Every method x search pair of the slice has a form exactly where JAX
    K3 has one (BackTrackingB only with a bounded method; PnormDescent
    only with inverse_p)."""
    methods = [solvers.GradientDescent(), solvers.CoordinateDescent(),
               solvers.PnormDescent(inverse_p=np.eye(3)),
               solvers.PnormDescent(), solvers.ProjectedGradientDescent(),
               solvers.SpectralProjectedGradient(),
               solvers.SpectralProjectedGradient(bb_variant="alternate"),
               *(solvers.NonlinearCG(variant=v) for v in ("fr", "pr+", "hs",
                                                          "dy"))]
    searches = [ls.BackTracking(), ls.BackTrackingB(), ls.GLLQuadratic(),
                ls.NoSearch()]
    for m in methods:
        for s in searches:
            assert fused_driver.fused_supported(m, s) == jk3.fused_supported(
                to_jax(m), to_jax(s)), (m, s)
    assert not fused_driver.fused_supported(solvers.GradientDescent(),
                                            ls.LineSearch())
    assert not fused_driver.fused_supported(object(), ls.BackTracking())


def test_epilogue_and_result_fields():
    g = GEOMETRIES["spg_gll_bb1"]
    tx0, lo, up, *tdata = interop.tensors_from_numpy(
        g["x0"], g["lower"], g["upper"], *g["data"])
    r = fused_driver.fused_minimize(g["method"], g["search"], g["objective"],
                                    tx0, lo, up, tuple(tdata),
                                    max_iter=g["max_iter"],
                                    max_iter_ls=g["max_iter_ls"])
    v, grad = g["objective"].value_and_grad(r.x, *tdata)
    torch.testing.assert_close(r.g, grad, rtol=0, atol=0)
    torch.testing.assert_close(r.f, v, rtol=1e-12, atol=1e-15)
    assert r.iterations.dtype == torch.int32 and r.status.dtype == torch.int32
    pg = (r.x - torch.clamp(r.x - r.g, lo, up)).abs().amax(-1)
    torch.testing.assert_close(r.pg_norm, pg, rtol=0, atol=0)
    assert r.x_lo is None and r.gcp_multimodal is None
    # unbounded: pg_norm is ||g||_inf
    g = GEOMETRIES["gd_bt"]
    tx0, *tdata = interop.tensors_from_numpy(g["x0"], *g["data"])
    r = fused_driver.fused_minimize(g["method"], g["search"], g["objective"],
                                    tx0, consts=tuple(tdata), max_iter=20)
    torch.testing.assert_close(r.pg_norm, r.g.abs().amax(-1), rtol=0, atol=0)
    assert (r.status == Status.MAX_ITER_REACHED).all()


def test_nfev_counts_the_trials():
    """NoSearch evaluates no trial; BackTracking at least one per
    iteration, and no more than max_iter_ls per iteration."""
    g = GEOMETRIES["gd_nosearch"]
    assert (run_plain(g)[4] == 0).all()
    g = GEOMETRIES["gd_bt"]
    _, _, it, _, nfev = run_plain(g)
    assert (nfev >= it).all() and (nfev <= it * g["max_iter_ls"]).all()


def test_routes_and_refusals(monkeypatch):
    g = GEOMETRIES["gd_bt"]
    tx0, *tdata = interop.tensors_from_numpy(g["x0"], *g["data"])
    before = fused_driver.fused_minimize.launches
    calls = []
    orig = fused_driver._solve_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(fused_driver, "_solve_plain", spy)
    fused_driver.fused_minimize(g["method"], g["search"], g["objective"],
                                tx0, consts=tuple(tdata), max_iter=5)
    assert calls == [1] and fused_driver.fused_minimize.launches == before
    with pytest.raises(ValueError, match="no K3 route"):
        fused_driver.fused_minimize(g["method"], g["search"], g["objective"],
                                    tx0.to("meta"), consts=tuple(tdata))
    with pytest.raises(ValueError, match="no fused kernel"):
        fused_driver.fused_minimize(g["method"], ls.BackTrackingB(),
                                    g["objective"], tx0, consts=tuple(tdata))
    with pytest.raises(ValueError, match="requires bounds"):
        fused_driver.fused_minimize(solvers.SpectralProjectedGradient(),
                                    ls.GLLQuadratic(), g["objective"], tx0,
                                    consts=tuple(tdata))


def test_shared_memory_rule():
    """7 n + m elements per instance (csrc/driver.cu work_elems); the
    largest float64 config-3-class instance fits, a 5,000-wide one does
    not."""
    assert fused_driver.smem_per_instance(64, 10, 4) == (7 * 64 + 10) * 4
    assert fused_driver.fits(4150, 0, 8)
    assert not fused_driver.fits(4151, 0, 8)
    assert fused_driver.fits(100, 0, 4)
    with pytest.raises(NotImplementedError, match="lockstep loop"):
        fused_driver._check_fits(5000, 10, 8)

