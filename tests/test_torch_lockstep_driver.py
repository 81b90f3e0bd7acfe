"""The port's lockstep driver, ``solvers.batch_minimize(fused=False)``,
against the JAX package's lockstep driver on the CPU.

Every combination of ``tests/test_lockstep_parity.py`` and more
(``_torch_geometries.lockstep_combos``: CD + GLL, Pnorm, SR1B, the
bug-for-bug More-Thuente, Hager-Zhang (B), bounded StrongWolfe, SPN with
``precond_bb``, the fused dense update of K5's path for all four rules,
the robust quasi-Newton variants) on the geometry of that test (the cond-40
diagonal quadratic, 5 starts of mixed difficulty, box ``[-1.5, 2.5]`` for
the bounded methods), float64.  Both sides get the same numpy inputs.

Tolerances: status and iteration count equal per instance, x within 1e-10
abs, f within 1e-12 relative (or 1e-15 abs: f reaches 0 at the
minimizer, as in ``test_torch_qn_driver.py``).  The two sum their dot
products in other orders, so a few ulps separate their iterates; the
geometry's counts do not move under that (the SR1B entries end 4.5e-11
apart, the rest under 1e-13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
from _torch_geometries import lockstep_combos, lockstep_quadratic
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.ops import fused_driver, fused_qn

torch.set_num_threads(1)

D, X0, LO, UP = lockstep_quadratic()
PORT = lockstep_combos(solvers, ls)
JAX = lockstep_combos(jsolvers, jls)


def _jax_config(m):
    """Pnorm's ``inverse_p`` as a JAX array."""
    if getattr(m, "inverse_p", None) is not None:
        import dataclasses
        return dataclasses.replace(m, inverse_p=jnp.asarray(m.inverse_p))
    return m


def run_both(name, x0=X0, max_iter=400, **kw):
    method, search, bounded, needs_h = PORT[name]
    jmethod, jsearch, _, _ = JAX[name]
    jo = jmake_oracle(lambda x: 0.5 * jnp.sum(jnp.asarray(D) * x * x),
                      with_hessian=needs_h)
    ref = jsolvers.batch_minimize(
        _jax_config(jmethod), jsearch, jo, jnp.asarray(x0),
        bounds=(jnp.asarray(LO), jnp.asarray(UP)) if bounded else None,
        max_iter=max_iter, fused=False, **kw)
    d, t, tx0, lo, up = interop.tensors_from_numpy(D, np.zeros_like(D), x0,
                                                   LO, UP)
    oracle = make_oracle(problems.weighted_squares(), with_hessian=needs_h,
                         data=(d, t))
    r = solvers.batch_minimize(method, search, oracle, tx0,
                               bounds=(lo, up) if bounded else None,
                               max_iter=max_iter, fused=False, **kw)
    return interop.result_to_numpy(r), ref


def assert_same(r, ref, x_atol=1e-10):
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=x_atol)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm), rtol=0,
                               atol=x_atol * 40)


@pytest.mark.parametrize("name", sorted(PORT))
def test_lockstep_matches_jax(name, monkeypatch):
    def no_k3(*a, **kw):
        raise AssertionError("fused=False ran K3")

    monkeypatch.setattr(fused_driver, "solve_spec", no_k3)
    r, ref = run_both(name)
    assert_same(r, ref)
    assert fused_qn.qn_update_direction_fused.launches == 0


def test_frozen_instances_keep_their_exit_state():
    """An instance that stops keeps its state bit for bit while the others
    go on: its result equals a solve of that instance alone."""
    method, search, bounded, _ = PORT["bfgs_mt"]
    d, t, tx0 = interop.tensors_from_numpy(D, np.zeros_like(D), X0)
    oracle = make_oracle(problems.weighted_squares(), data=(d, t))
    r = solvers.batch_minimize(method, search, oracle, tx0, fused=False,
                               max_iter=400)
    for i in range(X0.shape[0]):
        one = solvers.batch_minimize(method, search, oracle, tx0[i:i + 1],
                                     fused=False, max_iter=400)
        assert torch.equal(one.x[0], r.x[i]) and torch.equal(
            one.iterations[0], r.iterations[i])
