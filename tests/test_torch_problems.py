"""The port's problem library and batched oracle against the JAX package:
values and analytic gradients against JAX's value and ``jax.grad``
(rtol 1e-12 in float64: the analytic gradient and autodiff round at other
places), and the kernel forms each objective maps to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu_torch.core import problems as tprob
from optimization_solvers_tpu_torch.ops import batched_oracle

torch.set_num_threads(1)

RTOL = 1e-12


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


def _cases():
    rng = np.random.RandomState(3)
    d8 = rng.uniform(0.5, 4.0, 8)
    t8 = rng.uniform(-1.0, 1.0, 8)
    return {
        "rosenbrock": (tprob.rosenbrock(), jprob.rosenbrock(), 12, ()),
        "diag_quadratic": (tprob.diag_quadratic(torch.from_numpy(d8)),
                           jprob.diag_quadratic(jnp.asarray(d8)), 8, ()),
        "example_gd": (tprob.example_gd(), jprob.example_gd(), 2, ()),
        "shifted_quadratic_2d": (tprob.shifted_quadratic_2d(),
                                 jprob.shifted_quadratic_2d(), 2, ()),
        "weighted_squares": (tprob.weighted_squares(), _ws_jax, 8, (d8, t8)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_values_and_gradients_match_jax(name):
    tobj, jf, n, data = _cases()[name]
    X = np.random.RandomState(11).uniform(-2.0, 2.0, (7, n))
    jv, jg = jax.vmap(jax.value_and_grad(jf), in_axes=(0,) + (None,) * len(
        data))(jnp.asarray(X), *(jnp.asarray(c) for c in data))
    tdata = tuple(torch.from_numpy(c) for c in data)
    tX = torch.from_numpy(X)
    v, g = tobj.value_and_grad(tX, *tdata)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tobj.value(tX, *tdata).numpy(),
                               np.asarray(jv), rtol=RTOL)
    per_instance = torch.stack([tobj(x, *tdata) for x in tX])
    np.testing.assert_allclose(per_instance.numpy(), np.asarray(jv),
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_autodiff_fallback_matches_analytic(name):
    """A plain torch callable (no analytic form) is batched with
    torch.func; it must agree with the objective's analytic forms."""
    tobj, _, n, data = _cases()[name]
    tdata = tuple(torch.from_numpy(c) for c in data)
    tX = torch.from_numpy(np.random.RandomState(12).uniform(-2, 2, (5, n)))

    def raw(x, *d):
        return tobj(x, *d)

    v, g = batched_oracle.batched_value_and_grad(raw, tdata)(tX)
    va, ga = batched_oracle.batched_value_and_grad(tobj, tdata)(tX)
    np.testing.assert_allclose(v.numpy(), va.numpy(), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), ga.numpy(), rtol=RTOL,
                               atol=RTOL * ga.abs().max().item())
    np.testing.assert_allclose(
        batched_oracle.batched_value(raw, tdata)(tX).numpy(), va.numpy(),
        rtol=RTOL)


def test_kernel_forms():
    x0 = torch.zeros((3, 2), dtype=torch.float64)
    code, arrays = batched_oracle.kernel_operands(tprob.rosenbrock(), (), x0)
    assert code == batched_oracle.KERNEL_OBJECTIVES["ROSENBROCK"]
    assert arrays == ()
    expect = {"example_gd": ([2.0, 4.0], [0.0, 0.0]),
              "shifted_quadratic_2d": ([2.0, 2.0], [2.0, 3.0])}
    for name, (d, t) in expect.items():
        code, (dd, tt) = batched_oracle.kernel_operands(
            getattr(tprob, name)(), (), x0)
        assert code == batched_oracle.KERNEL_OBJECTIVES["WEIGHTED_SQUARES"]
        assert dd.dtype == torch.float64 and dd.tolist() == d
        assert tt.tolist() == t
    d = torch.tensor([1.0, 3.0], dtype=torch.float32)
    code, (dd, tt) = batched_oracle.kernel_operands(
        tprob.diag_quadratic(d), (), x0)
    assert dd.tolist() == [1.0, 3.0] and tt.tolist() == [0.0, 0.0]
    code, (dd, tt) = batched_oracle.kernel_operands(
        tprob.weighted_squares(), (d, -d), x0)
    assert dd.dtype == torch.float64 and tt.tolist() == [-1.0, -3.0]


def test_kernel_operands_refuse():
    x0 = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="kernel_form"):
        batched_oracle.kernel_operands(lambda x: x.sum(), (), x0)
    with pytest.raises(ValueError, match="length 4"):
        batched_oracle.kernel_operands(
            tprob.weighted_squares(), (torch.ones(3), torch.ones(3)), x0)
