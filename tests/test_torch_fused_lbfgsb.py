"""The port's fused L-BFGS-B against the JAX Pallas kernel K1.

The JAX reference is ``ops.pallas_lbfgsb.lbfgsb_solve_fused`` in interpret
mode with ``tile=1``: the port decides the interior fast-path gate per
instance, the TPU kernel per tile, so a tile of one instance is the same
algorithm.  Geometries are those of ``tests/test_fused_lbfgsb.py``.

Tolerances (float64):
* status equal per instance and x within 1e-6;
* iteration counts within ``max(2, spread)``, where ``spread`` is the range
  of the port's own counts when x0 moves by 1e-15 relative.  The port sums
  in another order than XLA, and on Rosenbrock such a change alone moves
  the count by up to a dozen iterations (the trajectory through the valley
  is chaotic); the short geometries have spread 0 and are held to +-2.

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_geometries import k1_geometries, perturbation_spread
from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.ops import pallas_lbfgsb as jk1
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.core import problems as tprob
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import _build, fused_lbfgsb

torch.set_num_threads(1)

X_ATOL = 1e-6
# the geometries this file holds against JAX, with their JAX objectives
JAX_OBJECTIVES = {
    "bounded_rosenbrock": jprob.rosenbrock(),
    "active_bounds": jprob.shifted_quadratic_2d(),
    "infeasible_start": jprob.example_gd(),
    "unbounded_body": jprob.rosenbrock(),
}


def _geometry(name):
    return k1_geometries()[name]


def _run_plain(obj, x0, lo, up, data, opts):
    tx0, tlo, tup, *tdata = interop.tensors_from_numpy(x0, lo, up, *data)
    r = fused_lbfgsb.lbfgsb_solve_fused(obj, tx0, tlo, tup, tuple(tdata),
                                        m=5, **opts)
    return interop.result_to_numpy(r)


def _spread(name):
    obj, x0, lo, up, data, opts = _geometry(name)
    return perturbation_spread(
        lambda x: _run_plain(obj, x, lo, up, data, opts).iterations, x0)


def assert_matches_reference(port, ref, spread):
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0,
                               atol=X_ATOL)
    dit = np.abs(port.iterations.astype(np.int64)
                 - np.asarray(ref.iterations).astype(np.int64))
    assert dit.max() <= max(2, spread), (dit, spread)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX K1 results per geometry, computed once per module (interpret
    mode takes ~15 s a call)."""
    cache = {}

    def get(name):
        if name not in cache:
            _, x0, lo, up, data, opts = _geometry(name)
            cache[name] = jk1.lbfgsb_solve_fused(
                JAX_OBJECTIVES[name], jnp.asarray(x0), jnp.asarray(lo),
                jnp.asarray(up), consts=tuple(jnp.asarray(c) for c in data),
                m=5, tile=1, interpret=True, **opts)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(JAX_OBJECTIVES))
def test_plain_matches_jax_kernel(name, jax_reference):
    obj, x0, lo, up, data, opts = _geometry(name)
    port = _run_plain(obj, x0, lo, up, data, opts)
    assert_matches_reference(port, jax_reference(name), _spread(name))
    assert (port.status == Status.CONVERGED).all()


# ---- failure semantics: a gradient that turns wrong near the minimum ------
# Once max|x| <= R the gradient's sign flips, so the search direction is
# uphill: the first failed step (with history) restarts the model, the next
# (without history) ends ABNORMAL at the restored iterate.

_D = np.array([1.0, 10.0, 100.0, 3.0])
_R = 0.05


@jax.custom_vjp
def _flipping_quadratic(x, d):
    return 0.5 * jnp.sum(d * x * x)


def _flipping_fwd(x, d):
    return _flipping_quadratic(x, d), (x, d)


def _flipping_bwd(res, ct):
    x, d = res
    g = d * x
    return ct * jnp.where(jnp.max(jnp.abs(x)) > _R, g, -g), jnp.zeros_like(d)


_flipping_quadratic.defvjp(_flipping_fwd, _flipping_bwd)


class _FlippingQuadratic:
    """The port's side: batched analytic forms with the same flip."""

    def value(self, X, d):
        return 0.5 * torch.sum(d * X * X, dim=-1)

    def value_and_grad(self, X, d):
        g = d * X
        keep = X.abs().amax(-1, keepdim=True) > _R
        return self.value(X, d), torch.where(keep, g, -g)


def test_restart_then_abnormal_matches_jax_kernel():
    x0 = np.random.RandomState(3).uniform(-1, 1, (3, 4))
    lo, up = np.full(4, -2.0), np.full(4, 2.0)
    opts = dict(m=5, pgtol=1e-8, factr=10.0, max_iter=50)
    ref = jk1.lbfgsb_solve_fused(
        _flipping_quadratic, jnp.asarray(x0), jnp.asarray(lo),
        jnp.asarray(up), consts=(jnp.asarray(_D),), tile=1, interpret=True,
        **opts)
    tx0, tlo, tup, td = interop.tensors_from_numpy(x0, lo, up, _D)
    port = interop.result_to_numpy(fused_lbfgsb.lbfgsb_solve_fused(
        _FlippingQuadratic(), tx0, tlo, tup, (td,), **opts))
    assert (port.status == Status.ABNORMAL).all()
    assert (port.iterations > 1).all()         # a restart came first
    assert_matches_reference(port, ref, spread=0)


def test_short_geometries_have_no_spread():
    """The +-2 budget is widened only where the problem itself is chaotic:
    the geometries that converge in a few iterations reproduce exactly."""
    for name in ("active_bounds", "infeasible_start"):
        assert _spread(name) == 0


def test_result_fields_and_epilogue():
    obj, x0, lo, up, data, opts = _geometry("bounded_rosenbrock")
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    r = fused_lbfgsb.lbfgsb_solve_fused(obj, tx0, tlo, tup, m=5, **opts)
    assert r.x.shape == (4, 20) and r.f.shape == (4,)
    assert r.iterations.dtype == torch.int32 and r.status.dtype == torch.int32
    v, g = obj.value_and_grad(r.x)
    torch.testing.assert_close(r.g, g, rtol=0, atol=0)
    torch.testing.assert_close(r.f, v, rtol=1e-12, atol=0)
    assert (r.pg_norm <= 1e-6).all()
    assert r.x_lo is None and r.gcp_multimodal is None


def test_out_of_domain_and_max_iter_status():
    """A NaN objective at x0 ends OUT_OF_DOMAIN; a tiny budget ends
    MAX_ITER_REACHED (status precedence of the kernel epilogue)."""
    def nan_at_start(x):
        return torch.sum(x * x) * torch.nan

    x0 = torch.ones((2, 3), dtype=torch.float64)
    lo, up = torch.full((3,), -2.0, dtype=torch.float64), torch.full(
        (3,), 2.0, dtype=torch.float64)
    r = fused_lbfgsb.lbfgsb_solve_fused(nan_at_start, x0, lo, up)
    assert (r.status == Status.OUT_OF_DOMAIN).all()
    assert (r.iterations == 0).all()
    r = fused_lbfgsb.lbfgsb_solve_fused(
        tprob.rosenbrock(), -x0, lo, up, max_iter=2)
    assert (r.status == Status.MAX_ITER_REACHED).all()
    assert (r.iterations == 2).all()


def test_cpu_runs_plain_and_counts_no_launch(monkeypatch):
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    calls = []
    orig = fused_lbfgsb.lbfgsb_solve_plain

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(fused_lbfgsb, "lbfgsb_solve_plain", spy)
    x0 = torch.zeros((2, 2), dtype=torch.float64)
    fused_lbfgsb.lbfgsb_solve_fused(
        tprob.example_gd(), x0 + 1.0, x0[0] - 3.0, x0[0] + 3.0)
    assert calls == [1]
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before


def test_no_route_for_other_devices():
    x0 = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="no L-BFGS-B route"):
        fused_lbfgsb.lbfgsb_solve_fused(tprob.example_gd(), x0, x0[0], x0[0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "LIB", str(tmp_path / "libmissing.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_exists = _build.os.path.exists
    monkeypatch.setattr(
        _build.os.path, "exists",
        lambda p: False if p.endswith("nvcc") else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
