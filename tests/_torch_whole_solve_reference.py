"""Both sides of the whole-solve kernels K7 (L-BFGS), K8 (SPG + GLL) and K9
(dense BFGS) on one geometry of ``tests/_torch_geometries.py``: the JAX
Pallas kernel in interpret mode with the JAX test's tile, and the port's
entry on CPU tensors (its plain version), from the same float64 numpy
inputs.  Shared by ``test_torch_fused_lbfgs.py``, ``test_torch_fused_spg.py``
and ``test_torch_fused_bfgs.py``."""

import jax.numpy as jnp
import numpy as np
import torch

from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.ops import pallas_bfgs, pallas_lbfgs, pallas_spg
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.core.types import SolveResult
from optimization_solvers_tpu_torch.ops import (fused_bfgs, fused_lbfgs,
                                                fused_spg)

# the JAX objectives the geometries name (``jax_objective``)
JAX_OBJECTIVES = {
    "rosenbrock": jprob.rosenbrock(),
    "example_bfgs": jprob.example_bfgs(),
    "quadratic_2d_90": jprob.quadratic_2d(90.0),
    "exp_bowl": jprob.exp_bowl(),
    "diag_consts": lambda x, d: 0.5 * jnp.sum(d * x * x),
    "weighted_squares": lambda x, d, t: 0.5 * jnp.sum(d * (x - t) ** 2),
}

JAX_KERNELS = {"k7": pallas_lbfgs.lbfgs_solve_fused,
               "k8": pallas_spg.spg_solve_fused,
               "k9": pallas_bfgs.bfgs_solve_fused}
PORT_ENTRIES = {"k7": fused_lbfgs.lbfgs_solve_fused,
                "k8": fused_spg.spg_solve_fused,
                "k9": fused_bfgs.bfgs_solve_fused}


def _box(kind, g, as_array):
    return (as_array(g["lower"]), as_array(g["upper"])) if kind == "k8" else ()


def jax_solve(kind, g, objective=None, x0=None, **overrides):
    """The JAX kernel's result (numpy fields) on geometry ``g``."""
    f = JAX_OBJECTIVES[g["jax_objective"]] if objective is None else objective
    x0 = g["x0"] if x0 is None else x0
    opts = dict(g["opts"], **overrides)
    r = JAX_KERNELS[kind](
        f, jnp.asarray(x0), *_box(kind, g, jnp.asarray),
        tuple(jnp.asarray(c) for c in g["jax_data"]), tile=g["tile"],
        interpret=True, **opts)
    return SolveResult(*(None if v is None else np.asarray(v) for v in r))


def port_solve(kind, g, objective=None, x0=None, **overrides):
    """The port's entry on CPU tensors (the plain version), numpy fields."""
    f = g["objective"] if objective is None else objective
    x0 = g["x0"] if x0 is None else x0
    opts = dict(g["opts"], **overrides)
    tx0, *tdata = interop.tensors_from_numpy(x0, *g["data"])
    box = _box(kind, g, lambda a: interop.tensors_from_numpy(a)[0])
    r = PORT_ENTRIES[kind](f, tx0, *box, tuple(tdata), **opts)
    assert r.x.device.type == "cpu"
    return interop.result_to_numpy(r)


def out_of_domain():
    """``0.5 ||x - 5||^2 + log(1 - x_1)`` (JAX and torch): the minimum lies
    outside the domain ``x_1 < 1``, so a non-finite trial is rejected, and
    with ``max_iter_ls=1`` the halved step is taken anyway and lands where f
    is NaN (status OUT_OF_DOMAIN)."""

    def jf(x):
        return 0.5 * jnp.sum((x - 5.0) ** 2) + jnp.log(1.0 - x[0])

    def tf(x):
        return 0.5 * torch.sum((x - 5.0) ** 2) + torch.log(1.0 - x[0])

    x0 = np.random.RandomState(9).uniform(-1.0, 0.0, (4, 3))
    return jf, tf, x0


def assert_same_solve(port, ref, x_atol, it_budget=0):
    """Status equal per instance, iteration counts within ``it_budget``, x
    within ``x_atol`` and f within ``x_atol`` relative to max(|f|, 1)."""
    np.testing.assert_array_equal(port.status, ref.status)
    dit = np.abs(port.iterations.astype(np.int64)
                 - ref.iterations.astype(np.int64))
    assert dit.max() <= it_budget, (port.iterations, ref.iterations)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=x_atol)
    np.testing.assert_allclose(
        port.f, ref.f, rtol=0,
        atol=x_atol * max(1.0, float(np.abs(ref.f).max())))
