"""The port's whole-solve SPG + GLL K8 (``ops.spg_solve_fused``) against the
JAX Pallas kernel ``ops.pallas_spg.spg_solve_fused``.

The JAX kernel runs in interpret mode with the tile of
``tests/test_fused_spg.py``; the port's plain version runs on CPU tensors
with the same float64 inputs.  Geometries: ``k8_geometries`` in
``tests/_torch_geometries.py`` (every SPG geometry of
``tests/test_fused_spg.py``: the active bound, ``exp_bowl`` as a plain torch
callable, the box quadratic with its diagonal as problem data; plus
Rosenbrock in a box over 30 iterations) and a start whose search lands
outside the domain.

Tolerances (float64): status and iteration counts equal per instance, x
within 1e-10 (1.2e-11 measured on Rosenbrock, 3e-21 elsewhere), and the
active bound x[:, 1] = 47 exactly, as the JAX test holds it.

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _torch_geometries import k8_geometries
from _torch_whole_solve_reference import (assert_same_solve, jax_solve,
                                          out_of_domain, port_solve)
from optimization_solvers_tpu_torch.core import problems
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_spg

torch.set_num_threads(1)

X_ATOL = 1e-10


@pytest.mark.parametrize("name", sorted(k8_geometries()))
def test_plain_matches_jax_kernel(name):
    g = k8_geometries()[name]
    port = port_solve("k8", g)
    assert_same_solve(port, jax_solve("k8", g), X_ATOL)
    # the epilogue's projected-gradient norm is the box's
    pg = np.abs(port.x - np.clip(port.x - port.g, g["lower"], g["upper"]))
    np.testing.assert_allclose(port.pg_norm, pg.max(-1))
    want = Status.MAX_ITER_REACHED if name == "rosenbrock_capped" else (
        Status.CONVERGED)
    assert (port.status == want).all()


def test_active_bound_is_exact():
    """``test_fused_spg_active_bound_geometry``: the lower bound 47 on x2 is
    active at the optimum (0, 47) and is met exactly."""
    port = port_solve("k8", k8_geometries()["active_bound"])
    np.testing.assert_array_equal(port.x[:, 1], np.full(8, 47.0))
    np.testing.assert_allclose(port.x[:, 0], np.zeros(8), atol=1e-8)


@pytest.mark.parametrize("form", ["library", "callable"])
def test_exp_bowl_forms(form):
    """``exp_bowl`` as the library objective (analytic forms) and as a plain
    torch callable (``torch.func``): both reach f = 1 in the box, as the JAX
    kernel does."""
    g = k8_geometries()["exp_bowl"]
    obj = problems.exp_bowl() if form == "library" else g["objective"]
    port = port_solve("k8", g, objective=obj)
    assert_same_solve(port, jax_solve("k8", g), X_ATOL)
    np.testing.assert_allclose(port.f, np.ones(8), atol=1e-10)


def test_out_of_domain_matches_jax_kernel():
    jf, tf, x0 = out_of_domain()
    g = dict(k8_geometries()["exp_bowl"], x0=x0, tile=4,
             lower=np.full(3, -10.0), upper=np.full(3, 10.0))
    kw = dict(max_iter_ls=1, max_iter=50)
    port = port_solve("k8", g, objective=tf, **kw)
    ref = jax_solve("k8", g, objective=jf, **kw)
    assert (port.status == Status.OUT_OF_DOMAIN).all()
    assert_same_solve(port, ref, X_ATOL)


def test_infinite_bounds_start_and_lam_max():
    """Unbounded coordinates and a start at a stationary point: the
    projected step is 0, so lambda_0 would be 1 / 0 and is clipped to
    lam_max, and the instance stops before its first iteration."""
    g = dict(k8_geometries()["box_quadratic_data"],
             lower=np.full(16, -np.inf), upper=np.full(16, np.inf))
    x0 = g["x0"].copy()
    x0[0] = 0.0
    port = port_solve("k8", g, x0=x0)
    assert_same_solve(port, jax_solve("k8", g, x0=x0), X_ATOL)
    assert port.iterations[0] == 0 and port.status[0] == Status.CONVERGED


def test_cpu_route_takes_the_plain_version():
    g = k8_geometries()["box_quadratic_data"]
    before = fused_spg.spg_solve_fused.launches
    r = fused_spg.spg_solve_fused(
        g["objective"], torch.from_numpy(g["x0"]), g["lower"], g["upper"],
        (torch.from_numpy(g["data"][0]),), tol=1e-8)
    assert fused_spg.spg_solve_fused.launches == before
    assert r.x.device.type == "cpu" and (r.status == 1).all()


def test_shared_memory_mirror():
    """7n + gll_m elements per instance: config 3's width (n = 64, gll_m =
    10) takes 1,832 bytes in float32."""
    assert fused_spg.smem_per_instance(64, 10, 4) == 1832
