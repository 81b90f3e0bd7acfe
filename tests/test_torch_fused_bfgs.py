"""The port's whole-solve dense BFGS K9 (``ops.bfgs_solve_fused``) against
the JAX Pallas kernel ``ops.pallas_bfgs.bfgs_solve_fused``.

The JAX kernel runs in interpret mode with the tile of
``tests/test_fused_spg.py``'s BFGS tests; the port's plain version runs on
CPU tensors with the same float64 inputs.  Geometries: ``k9_geometries`` in
``tests/_torch_geometries.py`` (both BFGS geometries of
``tests/test_fused_spg.py``, plus weighted squares with problem data) and a
start whose search lands outside the domain.

Tolerances (float64):
* the quadratics: status and iteration counts equal per instance, x within
  1e-10 (1.6e-22 measured);
* Rosenbrock (``chaotic``): the port and JAX end as far apart as the port
  and itself with x0 moved by 1e-15 relative, so the full solve is held to
  status equal, iteration counts within ``max(2, spread)`` (``spread`` is
  the port's own range under that change: 14 on ``rosenbrock_20``) and x
  within 1e-5 (both stop at ||g|| < 1e-5; 1.1e-7 apart measured); and per
  instance over the first ``CAPPED`` iterations, x within 1e-10 (1.7e-11
  measured).

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _torch_geometries import k9_geometries, perturbation_spread
from _torch_whole_solve_reference import (assert_same_solve, jax_solve,
                                          out_of_domain, port_solve)
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_bfgs

torch.set_num_threads(1)

X_ATOL = 1e-10
CHAOTIC_X_ATOL = 1e-5
CAPPED = 20


@pytest.mark.parametrize("name", sorted(k9_geometries()))
def test_plain_matches_jax_kernel(name):
    g = k9_geometries()[name]
    port = port_solve("k9", g)
    ref = jax_solve("k9", g)
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda x: port_solve("k9", g, x0=x).iterations, g["x0"])
        assert_same_solve(port, ref, CHAOTIC_X_ATOL, max(2, spread))
    else:
        assert_same_solve(port, ref, X_ATOL)
    assert (port.status == Status.CONVERGED).all()


def test_capped_rosenbrock_matches_jax_kernel():
    g = k9_geometries()["rosenbrock_20"]
    assert_same_solve(port_solve("k9", g, max_iter=CAPPED),
                      jax_solve("k9", g, max_iter=CAPPED), X_ATOL)


def test_rosenbrock_reaches_stationary_points():
    """``test_fused_bfgs_rosenbrock``: every instance ends at the global
    minimum (f = 0, x = 1) or at Rosenbrock's local minimum near x1 = -1
    (f ~ 3.99)."""
    port = port_solve("k9", k9_geometries()["rosenbrock_20"])
    f = port.f
    assert np.all((f < 1e-8) | (np.abs(f - 3.9866) < 1e-2))
    np.testing.assert_allclose(port.x[f < 1e-8], 1.0, atol=1e-4)


def test_quadratic_exact():
    """``test_fused_bfgs_quadratic_exact``: the 3-D quadratic to 1e-14."""
    port = port_solve("k9", k9_geometries()["example_bfgs"])
    assert (port.status == Status.CONVERGED).all()
    assert port.f.max() < 1e-14


def test_out_of_domain_matches_jax_kernel():
    jf, tf, x0 = out_of_domain()
    g = dict(k9_geometries()["example_bfgs"], x0=x0, tile=4)
    kw = dict(max_iter_ls=1)
    port = port_solve("k9", g, objective=tf, **kw)
    ref = jax_solve("k9", g, objective=jf, **kw)
    assert (port.status == Status.OUT_OF_DOMAIN).all()
    assert_same_solve(port, ref, X_ATOL)


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_short_solves_match_jax_kernel(max_iter):
    """The first iterations: B = I (steepest descent), then the first
    updates, and no iteration at all."""
    g = k9_geometries()["weighted_squares_data"]
    assert_same_solve(port_solve("k9", g, max_iter=max_iter),
                      jax_solve("k9", g, max_iter=max_iter), X_ATOL)


def test_cpu_route_takes_the_plain_version():
    g = k9_geometries()["example_bfgs"]
    before = fused_bfgs.bfgs_solve_fused.launches
    r = fused_bfgs.bfgs_solve_fused(g["objective"], torch.from_numpy(g["x0"]),
                                    tol=1e-8)
    assert fused_bfgs.bfgs_solve_fused.launches == before
    assert r.x.device.type == "cpu" and (r.status == 1).all()


def test_workspace_mirror():
    """One packed inverse Hessian per instance: at config 2's 1,024 x 100 in
    float32 it lies in the block's shared memory (23,416 bytes a block, no
    workspace); past the fit (n = 400) 1,024 triangles, 328,499,200 bytes,
    in device memory."""
    assert fused_bfgs.workspace_elems(1024, 100, 4) == 0
    assert fused_bfgs.smem_per_instance(100, 4) == (804 + 5050) * 4 == 23_416
    assert fused_bfgs.workspace_elems(1024, 400, 4) * 4 == 328_499_200
    assert fused_bfgs.smem_per_instance(400, 4) == 3204 * 4
