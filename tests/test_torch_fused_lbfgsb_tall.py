"""The port's tall kernel K2 (its plain PyTorch version) against the JAX
Pallas kernel K2.

The JAX reference is ``ops.pallas_lbfgsb_tall.lbfgsb_solve_fused_tall`` in
interpret mode with ``tile = B``: every loop of that kernel runs until no
lane of the tile is open and every write is masked per lane, so a tile
computes what each of its instances computes alone, which is what the port
does.  Geometries are ``k2_geometries`` of ``tests/_torch_geometries.py``
(those of ``tests/test_fused_lbfgsb_tall.py``; the config-4 class draws A
with numpy).  Each JAX call costs 10-40 s here, so each is made once per
module: nine in this file.

Tolerances (float64, Armijo):
* status equal per instance, x within 1e-6;
* f within rtol 1e-10, atol 1e-10 on the quadratic and log-sum-exp
  geometries (Rosenbrock ends near f = 0, where only x is meaningful);
* iteration counts equal, except on Rosenbrock: within ``max(2, spread)``,
  ``spread`` being the port's own range under a 1e-15 change of x0.

The GCP guard flag is compared on its own geometry in float32, as the JAX
test runs it.  The flag is decided by rounding: the port sums in another
order than XLA, and where the flags differ the test shows that JAX's own
flag flips under a one-ulp nudge of x0.  The dcsrch mode is held in
``tests/test_torch_tall_frontend.py``; the CUDA kernel against this plain
version in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_geometries import (guard_arrays, k2_geometries, lse_arrays,
                               mixed_quadratic_arrays, perturbation_spread)
from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.ops import pallas_lbfgsb_tall as jk2
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.core import problems as tprob
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_lbfgsb_tall

torch.set_num_threads(1)

X_ATOL = 1e-6
F_TOL = 1e-10
ROSENBROCK = ("bounded_rosenbrock", "max_iter_1")


def _jax_quadratic(x, Q):
    return 0.5 * jnp.sum(x * (Q @ x))


def _jax_lse(x, A, b):
    z = A @ x + b
    mx = jnp.max(z)
    return mx + jnp.log(jnp.sum(jnp.exp(z - mx)))


def _jax_per_lane(x, d):
    return 0.5 * jnp.sum(d * (x - 1.5) ** 2)


def _jax_guard(x, A, b):
    return 0.5 * jnp.sum(x * (A @ x)) - jnp.sum(b * x)


def _jax_objectives():
    """name -> (JAX objective, its consts) for the geometries held here."""
    return {
        "bounded_rosenbrock": (jprob.rosenbrock(), ()),
        "active_bounds": (jprob.shifted_quadratic_2d(), ()),
        "infeasible_start": (jprob.example_gd(), ()),
        "mixed_infinite_bounds": (_jax_quadratic,
                                  (mixed_quadratic_arrays()[0],)),
        "lse_config4_class": (_jax_lse, lse_arrays()),
        "per_lane_boxes": (_jax_per_lane, (np.linspace(1.0, 9.0, 24),)),
        "gcp_guard": (_jax_guard, guard_arrays()[:2]),
        "max_iter_1": (jprob.rosenbrock(), ()),
    }


F64_GEOMETRIES = sorted(set(_jax_objectives()) - {"gcp_guard"})


def _dtype(x0):
    return torch.float32 if x0.dtype == np.float32 else torch.float64


def _run_plain(name, x0=None):
    obj, x0_g, lo, up, data, opts = k2_geometries()[name]
    x0 = x0_g if x0 is None else x0
    tx0, tlo, tup, *tdata = interop.tensors_from_numpy(
        x0, lo, up, *data, dtype=_dtype(x0_g))
    return interop.result_to_numpy(fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        obj, tx0, tlo, tup, tuple(tdata), **opts))


def _run_jax(name, x0=None):
    _, x0_g, lo, up, _, opts = k2_geometries()[name]
    x0 = x0_g if x0 is None else x0
    f, consts = _jax_objectives()[name]
    dt = jnp.float32 if x0_g.dtype == np.float32 else jnp.float64
    return jk2.lbfgsb_solve_fused_tall(
        f, jnp.asarray(x0, dt), jnp.asarray(lo, dt), jnp.asarray(up, dt),
        consts=tuple(jnp.asarray(c, dt) for c in consts),
        tile=x0.shape[0], interpret=True, **opts)


@pytest.fixture(scope="module")
def jax_reference():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_jax(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", F64_GEOMETRIES)
def test_plain_matches_jax_kernel(name, jax_reference):
    port = _run_plain(name)
    ref = jax_reference(name)
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0,
                               atol=X_ATOL)
    dit = np.abs(port.iterations.astype(np.int64)
                 - np.asarray(ref.iterations).astype(np.int64)).max()
    if name in ROSENBROCK:
        _, x0, *_ = k2_geometries()[name]
        spread = perturbation_spread(
            lambda x: _run_plain(name, x).iterations, x0)
        assert dit <= max(2, spread), (dit, spread)
    else:
        assert dit == 0
        np.testing.assert_allclose(port.f, np.asarray(ref.f), rtol=F_TOL,
                                   atol=F_TOL)
    expect = Status.MAX_ITER_REACHED if name == "max_iter_1" else (
        Status.CONVERGED)
    assert (port.status == expect).all()


def test_gcp_guard_flags_match_jax_kernel(jax_reference):
    """Float32, as the JAX test: status and iteration counts equal, f
    within 1e-4 relative (30 iterations of an unconverged ill-conditioned
    solve in float32; 2.1e-5 measured), and the guard flags lane for lane,
    unless JAX's own flags flip under a one-ulp nudge of x0."""
    port = _run_plain("gcp_guard")
    ref = jax_reference("gcp_guard")
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.iterations,
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(port.f, np.asarray(ref.f), rtol=1e-4)
    flags, ref_flags = port.gcp_multimodal, np.asarray(ref.gcp_multimodal)
    if not np.array_equal(flags, ref_flags):
        x0 = k2_geometries()["gcp_guard"][1]
        nudged = np.asarray(_run_jax(
            "gcp_guard", np.nextafter(x0, np.float32(np.inf))).gcp_multimodal)
        assert not np.array_equal(nudged, ref_flags), (flags, ref_flags)


def test_gcp_guard_fires_and_control_stays_quiet():
    """The guard fires on its geometry (float64 here) and never on the
    separable, well-conditioned control of the JAX test in float32, that
    test's dtype.  (In float64 JAX K2 flags both control lanes too: each
    converges in one iteration through an exhausted bisection.)"""
    obj, x0, lo, up, _, opts = k2_geometries()["gcp_guard"]
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    r = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(obj, tx0, tlo, tup, **opts)
    assert bool(r.gcp_multimodal.any())
    d = torch.linspace(1.0, 3.0, x0.shape[1], dtype=torch.float32)
    clo, cup = interop.tensors_from_numpy(lo, up, dtype=torch.float32)
    rc = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        tprob.weighted_squares(), torch.zeros((2, x0.shape[1])), clo, cup,
        (d, torch.full_like(d, 2.0)), **opts)
    assert not bool(rc.gcp_multimodal.any())
    assert (rc.status == Status.CONVERGED).all()


def test_result_fields_and_epilogue():
    obj, x0, lo, up, _, opts = k2_geometries()["lse_config4_class"]
    tx0, tlo, tup = interop.tensors_from_numpy(x0[:2], lo, up)
    r = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(obj, tx0, tlo, tup, **opts)
    assert r.x.shape == (2, 400) and r.f.shape == (2,)
    assert r.iterations.dtype == torch.int32 and r.status.dtype == torch.int32
    assert r.gcp_multimodal.dtype == torch.bool
    v, g = obj.value_and_grad(r.x)
    torch.testing.assert_close(r.g, g, rtol=0, atol=0)
    torch.testing.assert_close(r.f, v, rtol=1e-12, atol=0)
    assert (r.pg_norm <= 1e-7).all() and r.x_lo is None
    r0 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        obj, tx0, tlo, tup, gcp_guard_maxseg=0, **opts)
    assert r0.gcp_multimodal is None
    torch.testing.assert_close(r0.x, r.x, rtol=0, atol=0)


def test_cpu_runs_plain_and_counts_no_launch(monkeypatch):
    before = fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches
    calls = []
    orig = fused_lbfgsb_tall.lbfgsb_solve_tall_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(fused_lbfgsb_tall, "lbfgsb_solve_tall_plain", spy)
    x0 = torch.zeros((2, 2), dtype=torch.float64)
    fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        tprob.example_gd(), x0 + 1.0, x0[0] - 3.0, x0[0] + 3.0)
    assert calls == [1]
    assert fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches == before


def test_refuses_other_devices_and_line_searches():
    x0 = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="no L-BFGS-B route"):
        fused_lbfgsb_tall.lbfgsb_solve_fused_tall(tprob.example_gd(), x0,
                                                  x0[0], x0[0])
    x0 = torch.zeros((2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="line_search"):
        fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
            tprob.example_gd(), x0, x0[0] - 1, x0[0] + 1, line_search="hz")
