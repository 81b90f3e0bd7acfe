"""K1's scaled form: the port's ``ops.lbfgsb_solve_fused_scaled`` on the CPU
(the plain version on :class:`ScaledObjective`) against JAX's
``lbfgsb_solve_fused_scaled`` (``pallas_lbfgsb.py:993``) in interpret mode
with ``tile=1``, float64, on the K1 geometries of
``tests/test_torch_fused_lbfgsb.py`` with ``diag`` drawn from a seed.

Tolerances: status and iteration counts equal, x within 1e-9.  Rosenbrock
under a random diagonal scale is chaotic: a 1e-15 change of x0 moves the
port's own full-solve counts by up to ~100 and x by ~5e-7, so on the two
Rosenbrock geometries the full solve is held by status and by each side's
distance to x* = 1 (both within 2e-6), and per instance over the first
25 iterations, where the two agree to ~2e-13.

The CUDA kernel is held against this plain version on the card in
``tests/test_torch_cuda.py`` and in ``chip_smoke.py`` phase 35.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_geometries import k1_geometries
from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.ops import pallas_lbfgsb as jk1
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.core import problems as tprob
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_lbfgsb

torch.set_num_threads(1)

X_ATOL = 1e-9
CHAOTIC = ("bounded_rosenbrock", "unbounded_body")
CAPPED = 25
XSTAR_ATOL = 2e-6


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


JAX_OBJECTIVES = {
    "bounded_rosenbrock": jprob.rosenbrock(),
    "active_bounds": jprob.shifted_quadratic_2d(),
    "infeasible_start": jprob.example_gd(),
    "unbounded_body": jprob.rosenbrock(),
    "mixed_infinite_bounds": _ws_jax,
    "per_lane_boxes": _ws_jax,
}


def diag_for(n):
    return np.random.RandomState(11).uniform(0.25, 4.0, n)


def both(name, **override):
    obj, x0, lo, up, data, opts = k1_geometries()[name]
    opts = dict(opts, **override)
    diag = diag_for(x0.shape[-1])
    ref = jk1.lbfgsb_solve_fused_scaled(
        JAX_OBJECTIVES[name], jnp.asarray(x0), jnp.asarray(lo),
        jnp.asarray(up), jnp.asarray(diag),
        consts=tuple(jnp.asarray(c) for c in data), m=5, tile=1,
        interpret=True, **opts)
    tx0, tlo, tup, tdiag, *tdata = interop.tensors_from_numpy(
        x0, lo, up, diag, *data)
    port = interop.result_to_numpy(fused_lbfgsb.lbfgsb_solve_fused_scaled(
        obj, tx0, tlo, tup, tdiag, tuple(tdata), m=5, **opts))
    return port, ref


def held(port, ref):
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.iterations,
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0,
                               atol=X_ATOL)


@pytest.mark.parametrize("name", sorted(JAX_OBJECTIVES))
def test_plain_scaled_matches_jax_kernel(name):
    port, ref = both(name)
    assert (port.status == Status.CONVERGED).all()
    if name in CHAOTIC:
        np.testing.assert_array_equal(port.status, np.asarray(ref.status))
        assert np.abs(port.x - 1.0).max() <= XSTAR_ATOL
        assert np.abs(np.asarray(ref.x) - 1.0).max() <= XSTAR_ATOL
        port, ref = both(name, max_iter=CAPPED)
        assert (port.iterations == CAPPED).all()
    held(port, ref)
    # g and pg_norm of the epilogue: g in x, pg_norm in the scaled metric
    np.testing.assert_allclose(port.g, np.asarray(ref.g), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(port.pg_norm, np.asarray(ref.pg_norm),
                               rtol=1e-9, atol=1e-9)


def test_unit_diag_is_the_unscaled_solve_bit_for_bit():
    """``diag = 1``: z = x, every evaluation the objective's own, so the
    plain scaled solve is the unscaled plain K1's bit for bit."""
    for name in ("bounded_rosenbrock", "mixed_infinite_bounds"):
        obj, x0, lo, up, data, opts = k1_geometries()[name]
        tx0, tlo, tup, *tdata = interop.tensors_from_numpy(x0, lo, up, *data)
        one = torch.ones(x0.shape[-1], dtype=torch.float64)
        a = fused_lbfgsb.lbfgsb_solve_fused_scaled(
            obj, tx0, tlo, tup, one, tuple(tdata), m=5, **opts)
        b = fused_lbfgsb.lbfgsb_solve_fused(obj, tx0, tlo, tup, tuple(tdata),
                                            m=5, **opts)
        for u, v in zip(a[:5], b[:5]):
            assert torch.equal(u, v)


def test_jacobi_case_matches_jax():
    """JAX's Jacobi case (``tests/test_fused_lbfgsb.py:69``): the cond-1e6
    diagonal quadratic becomes a one- to three-iteration problem."""
    n, B = 16, 8
    h = np.logspace(0, 6, n)
    x0 = np.random.RandomState(0).uniform(-2, 2, (B, n))
    lo, up = np.full(n, -3.0), np.full(n, 3.0)
    opts = dict(m=5, pgtol=1e-6, factr=0.0, max_iter=50)
    ref = jk1.lbfgsb_solve_fused_scaled(
        lambda x, hh: 0.5 * jnp.sum(hh * x * x), jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(up), jnp.asarray(h),
        consts=(jnp.asarray(h),), tile=1, interpret=True, **opts)
    tx0, tlo, tup, th, tt = interop.tensors_from_numpy(x0, lo, up, h,
                                                       np.zeros(n))
    port = interop.result_to_numpy(fused_lbfgsb.lbfgsb_solve_fused_scaled(
        tprob.weighted_squares(), tx0, tlo, tup, th, (th, tt), **opts))
    held(port, ref)
    assert (port.status == Status.CONVERGED).all()
    assert port.iterations.max() <= 3 and port.f.max() < 1e-12
    assert np.abs(port.x).max() < 1e-6


def test_scaled_counts_no_launch_on_the_cpu_and_checks_diag():
    obj, x0, lo, up, data, opts = k1_geometries()["active_bounds"]
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    before = (fused_lbfgsb.lbfgsb_solve_fused.launches,
              fused_lbfgsb.lbfgsb_solve_fused_scaled.launches)
    fused_lbfgsb.lbfgsb_solve_fused_scaled(obj, tx0, tlo, tup,
                                           torch.full((2,), 3.0), **opts)
    assert (fused_lbfgsb.lbfgsb_solve_fused.launches,
            fused_lbfgsb.lbfgsb_solve_fused_scaled.launches) == before
    with pytest.raises(ValueError, match="diag must be"):
        fused_lbfgsb.lbfgsb_solve_fused_scaled(obj, tx0, tlo, tup,
                                               torch.ones(3), **opts)
    with pytest.raises(TypeError, match="unexpected keyword"):
        fused_lbfgsb.lbfgsb_solve_fused_scaled(obj, tx0, tlo, tup,
                                               torch.ones(2), gcp_chunk=4)
    with pytest.raises(ValueError, match="no L-BFGS-B route"):
        fused_lbfgsb.lbfgsb_solve_fused_scaled(
            obj, tx0.to("meta"), tlo.to("meta"), tup.to("meta"),
            torch.ones(2, device="meta"))
