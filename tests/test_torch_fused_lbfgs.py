"""The port's whole-solve L-BFGS K7 (``ops.lbfgs_solve_fused``) against the
JAX Pallas kernel ``ops.pallas_lbfgs.lbfgs_solve_fused``.

The JAX kernel runs in interpret mode with the tile of
``tests/test_fused_lbfgs.py``; the port's plain version runs on CPU tensors
with the same float64 inputs.  Geometries: ``k7_geometries`` in
``tests/_torch_geometries.py`` (every geometry of
``tests/test_fused_lbfgs.py``, plus weighted squares with problem data),
``exp_bowl`` and a start whose search lands outside the domain.

Tolerances (float64):
* the quadratics: status and iteration counts equal per instance, x within
  1e-10 (the two sum in other orders; 7e-18 measured);
* Rosenbrock (``chaotic``): a full solve's path through the valley is
  chaotic.  The port and JAX end as far apart as the port and itself with
  x0 moved by 1e-15 relative, so full solves are held to status equal,
  iteration counts within ``max(2, spread)`` (``spread`` is that range of
  the port's own counts: 8 on ``rosenbrock_20``) and x within 1e-5 (both
  stop at max|g| < 1e-5; JAX's own tile spread is 5.5e-7, port and JAX end
  4.7e-6 apart); and per instance over their first ``CAPPED`` iterations,
  x within 1e-10 (2.1e-13 measured).

The CUDA kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _torch_geometries import k7_geometries, perturbation_spread
from _torch_whole_solve_reference import (assert_same_solve, jax_solve,
                                          out_of_domain, port_solve)
from optimization_solvers_tpu_torch import linesearch as ls, solvers
from optimization_solvers_tpu_torch.core import problems
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_lbfgs

torch.set_num_threads(1)

X_ATOL = 1e-10
CHAOTIC_X_ATOL = 1e-5
CAPPED = 20


@pytest.mark.parametrize("name", sorted(k7_geometries()))
def test_plain_matches_jax_kernel(name):
    g = k7_geometries()[name]
    port = port_solve("k7", g)
    ref = jax_solve("k7", g)
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda x: port_solve("k7", g, x0=x).iterations, g["x0"])
        assert_same_solve(port, ref, CHAOTIC_X_ATOL, max(2, spread))
    else:
        assert_same_solve(port, ref, X_ATOL)
    assert (port.status == Status.CONVERGED).all()
    np.testing.assert_allclose(port.pg_norm, np.abs(port.g).max(-1))


@pytest.mark.parametrize("name", ["driver_quality", "rosenbrock_20"])
def test_capped_rosenbrock_matches_jax_kernel(name):
    g = k7_geometries()[name]
    assert_same_solve(port_solve("k7", g, max_iter=CAPPED),
                      jax_solve("k7", g, max_iter=CAPPED), X_ATOL)


def test_objective_without_functor_runs_plain():
    """``exp_bowl`` has PyTorch forms only; on a CPU tensor the plain
    version takes it (as a library objective and as a plain callable)."""
    g = dict(k7_geometries()["example_bfgs"], jax_objective="exp_bowl",
             x0=np.random.RandomState(1).uniform(-1, 1, (8, 2)), tile=8)
    ref = jax_solve("k7", g)
    for obj in (problems.exp_bowl(), lambda x: torch.sum(x ** 2)
                + torch.exp(torch.sum(x ** 2))):
        port = port_solve("k7", g, objective=obj)
        assert_same_solve(port, ref, X_ATOL)
    np.testing.assert_allclose(port.f, np.ones(8), atol=1e-12)


def test_out_of_domain_matches_jax_kernel():
    jf, tf, x0 = out_of_domain()
    g = dict(k7_geometries()["example_bfgs"], x0=x0, tile=4)
    kw = dict(max_iter_ls=1)
    port = port_solve("k7", g, objective=tf, **kw)
    ref = jax_solve("k7", g, objective=jf, **kw)
    assert (port.status == Status.OUT_OF_DOMAIN).all()
    assert_same_solve(port, ref, X_ATOL)


def test_fused_matches_driver_quality():
    """``tests/test_fused_lbfgs.py::test_fused_matches_driver_quality``: the
    whole-solve kernel's plain version and the port's lockstep L-BFGS +
    StrongWolfe reach the same minimizers."""
    g = k7_geometries()["driver_quality"]
    fused = port_solve("k7", g)
    driver = solvers.batch_minimize(
        solvers.LBFGS(tol=1e-5, m=10), ls.StrongWolfe(c1=1e-4, c2=0.9),
        make_oracle(g["objective"]), torch.from_numpy(g["x0"]),
        max_iter=800, fused=False)
    assert int((fused.status == 1).sum()) == 4
    assert int((driver.status == 1).sum()) == 4
    np.testing.assert_allclose(fused.x, driver.x.numpy(), atol=1e-3)


def test_cpu_route_takes_the_plain_version():
    g = k7_geometries()["example_bfgs"]
    before = fused_lbfgs.lbfgs_solve_fused.launches
    r = fused_lbfgs.lbfgs_solve_fused(
        g["objective"], torch.from_numpy(g["x0"]), m=5, tol=1e-8)
    assert fused_lbfgs.lbfgs_solve_fused.launches == before
    assert r.x.device.type == "cpu" and r.x.dtype == torch.float64
    if not torch.cuda.is_available():
        # a non-tensor x0 goes to the card, and there is none here
        with pytest.raises(RuntimeError, match="CUDA"):
            fused_lbfgs.lbfgs_solve_fused(g["objective"], g["x0"])


def test_shared_memory_mirror():
    """The Python mirror of the kernel's shared memory per instance: the
    headline width (n = 100, m = 5) takes 6,300 bytes in float32 (the
    vectors, the rings, and the compact form's tables and sums by slot),
    and an instance too wide for a block does not fit."""
    assert fused_lbfgs.smem_per_instance(100, 5, 4) == 6300
    assert fused_lbfgs.fits(100, 5, 4) and fused_lbfgs.fits(1000, 10, 8)
    assert not fused_lbfgs.fits(5000, 10, 8)
