"""The port's core types, numerics and interop against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
numerics are elementwise or single reductions, so they must agree exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_solvers_tpu.core import numerics as jnum
from optimization_solvers_tpu.core import types as jtypes
from optimization_solvers_tpu.solvers.lbfgsb import LbfgsbConfig as JaxConfig
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.core import numerics as tnum
from optimization_solvers_tpu_torch.core import types as ttypes
from optimization_solvers_tpu_torch.solvers.lbfgsb import LbfgsbConfig

torch.set_num_threads(1)


def _inputs(seed=0, shape=(6, 9)):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-3, 3, shape)
    g = rng.uniform(-3, 3, shape)
    lo = rng.uniform(-2, 0, shape[-1])
    up = rng.uniform(0, 2, shape[-1])
    lo[0], up[1] = -np.inf, np.inf
    x[0, 2], x[1, 3] = lo[2], up[3]          # points on their bounds
    g[0, 2], g[1, 3] = 1.0, -1.0             # pushing outward
    return x, g, lo, up


def _t(*arrays):
    return interop.tensors_from_numpy(*arrays)


def test_status_values_equal_jax():
    assert {s.name: int(s) for s in ttypes.Status} == {
        s.name: int(s) for s in jtypes.Status}


def test_solve_result_fields_equal_jax():
    assert ttypes.SolveResult._fields == jtypes.SolveResult._fields
    assert ttypes.FuncEval._fields == jtypes.FuncEval._fields


def test_solve_result_properties():
    g = np.array([[3.0, 4.0], [0.0, 1.0]])
    r = ttypes.SolveResult(*_t(np.zeros((2, 2)), np.zeros(2), g),
                           torch.tensor([5, 7], dtype=torch.int32),
                           torch.tensor([1, 6], dtype=torch.int32),
                           pg_norm=torch.tensor([1e-7, 1e-3]))
    assert r.converged.tolist() == [True, False]
    assert r.stalled.tolist() == [False, True]
    np.testing.assert_allclose(r.g_norm.numpy(), [5.0, 1.0])
    assert r.stationary(1e-6).tolist() == [True, False]
    with pytest.raises(ValueError):
        r._replace(pg_norm=None).stationary(1e-6)
    fe = ttypes.FuncEval(*_t(np.array([1.0, np.nan]), g))
    assert fe.in_domain.tolist() == [True, False]
    assert fe.with_hessian(torch.eye(2)).hessian is not None


@pytest.mark.parametrize("name", ["box_projection", "projected_gradient",
                                  "infinity_norm", "dot"])
def test_numerics_equal_jax(name):
    x, g, lo, up = _inputs()
    tx, tg, tlo, tup = _t(x, g, lo, up)
    if name == "box_projection":
        want, got = jnum.box_projection(x, lo, up), tnum.box_projection(
            tx, tlo, tup)
    elif name == "projected_gradient":
        want = jnum.projected_gradient(g, x, lo, up)
        got = tnum.projected_gradient(tg, tx, tlo, tup)
    elif name == "infinity_norm":
        want, got = jnum.infinity_norm(g), tnum.infinity_norm(tg)
    else:
        # a 9-term sum: XLA and torch associate it differently (1 ulp)
        np.testing.assert_allclose(tnum.dot(tx, tg).numpy(),
                                   np.asarray(jnum.dot(x, g)), rtol=1e-15)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bounded", [True, False])
def test_batched_pg_inf_norm_equal_jax(bounded):
    x, g, lo, up = _inputs(1)
    tx, tg, tlo, tup = _t(x, g, lo, up)
    if bounded:
        want = jnum.batched_pg_inf_norm(x, g, lo, up)
        got = tnum.batched_pg_inf_norm(tx, tg, tlo, tup)
    else:
        want = jnum.batched_pg_inf_norm(x, g)
        got = tnum.batched_pg_inf_norm(tx, tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["rust_min", "rust_max", "rust_clamp"])
def test_rust_nan_semantics_equal_jax(name):
    a = np.array([1.0, np.nan, 3.0, np.nan, -2.0, np.inf])
    b = np.array([2.0, 5.0, np.nan, np.nan, -np.inf, 1.0])
    ta, tb = _t(a, b)
    if name == "rust_clamp":
        want = jnum.rust_clamp(a, -1.0, 2.5)
        got = tnum.rust_clamp(ta, -1.0, 2.5)
    else:
        want = getattr(jnum, name)(a, b)
        got = getattr(tnum, name)(ta, tb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_round_trip_from_jax_fields():
    jcfg = JaxConfig(m=7, pgtol=1e-3, factr=100.0, ls_c1=1e-4)
    cfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(LbfgsbConfig()) == dataclasses.asdict(
        JaxConfig())
    with pytest.raises(TypeError):
        interop.config_from_fields({"m": 5, "no_such_field": 1})


def test_tensors_from_numpy_and_back():
    x = np.arange(6.0).reshape(2, 3)
    it = np.array([3, 4], dtype=np.int32)
    tx, tit = interop.tensors_from_numpy(x, it, dtype=torch.float32)
    assert tx.dtype == torch.float32 and tit.dtype == torch.int32
    r = ttypes.SolveResult(tx, tx[:, 0], tx, tit, tit)
    back = interop.result_to_numpy(r)
    np.testing.assert_array_equal(back.x, x.astype(np.float32))
    assert back.pg_norm is None and isinstance(back.status, np.ndarray)
    # the JAX result type takes the same numpy fields
    assert jtypes.SolveResult(*back).iterations.tolist() == [3, 4]
    assert jnp.asarray(back.x).shape == (2, 3)
