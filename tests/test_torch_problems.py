"""The port's problem library and batched oracle against the JAX package:
values and analytic gradients against JAX's value and ``jax.grad``
(rtol 1e-12 in float64: the analytic gradient and autodiff round at other
places), the second derivatives of the K7-K9 objectives against
``jax.hessian`` (the rest are held in ``test_torch_newton_driver.py``), and
the kernel forms each objective maps to."""

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
    # not exactly symmetric, as the tall kernel's test matrix: the gradient
    # must be autodiff's 0.5 (Q + Q^T) x + b
    Q6 = rng.standard_normal((6, 6))
    Q6 = Q6 @ Q6.T + 0.1 * rng.standard_normal((6, 6))
    b6 = rng.standard_normal(6)
    A = rng.standard_normal((5, 8)) * 3.0
    bA = np.linspace(-1.0, 1.0, 5)
    return {
        "rosenbrock": (tprob.rosenbrock(), jprob.rosenbrock(), 12, ()),
        "diag_quadratic": (tprob.diag_quadratic(torch.from_numpy(d8)),
                           jprob.diag_quadratic(jnp.asarray(d8)), 8, ()),
        "example_gd": (tprob.example_gd(), jprob.example_gd(), 2, ()),
        "shifted_quadratic_2d": (tprob.shifted_quadratic_2d(),
                                 jprob.shifted_quadratic_2d(), 2, ()),
        "weighted_squares": (tprob.weighted_squares(), _ws_jax, 8, (d8, t8)),
        "quadratic": (tprob.quadratic(Q6, b6),
                      jprob.quadratic(jnp.asarray(Q6), jnp.asarray(b6)), 6,
                      ()),
        "log_sum_exp": (tprob.log_sum_exp(A, bA),
                        jprob.log_sum_exp(jnp.asarray(A), jnp.asarray(bA)),
                        8, ()),
        # the objectives of the whole-solve kernels' tests (K7-K9)
        "quadratic_2d": (tprob.quadratic_2d(90.0), jprob.quadratic_2d(90.0),
                         2, ()),
        "example_bfgs": (tprob.example_bfgs(), jprob.example_bfgs(), 3, ()),
        "exp_bowl": (tprob.exp_bowl(), jprob.exp_bowl(), 2, ()),
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
    # the tall kernel's functors carry 2-D data
    Q = np.arange(4.0).reshape(2, 2)
    code, (qq, bb) = batched_oracle.kernel_operands(tprob.quadratic(Q), (),
                                                     x0)
    assert code == batched_oracle.KERNEL_OBJECTIVES["QUADRATIC"]
    assert qq.tolist() == Q.tolist() and bb.tolist() == [0.0, 0.0]
    A = np.ones((3, 2), np.float32)
    code, (aa, ba) = batched_oracle.kernel_operands(
        tprob.log_sum_exp(A, np.zeros(3)), (), x0)
    assert code == batched_oracle.KERNEL_OBJECTIVES["LOG_SUM_EXP"]
    assert aa.shape == (3, 2) and aa.dtype == torch.float64
    assert ba.shape == (3,) and aa.is_contiguous()


def test_kernel_operands_refuse():
    x0 = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="kernel_form"):
        batched_oracle.kernel_operands(lambda x: x.sum(), (), x0)
    with pytest.raises(ValueError, match="length 4"):
        batched_oracle.kernel_operands(
            tprob.weighted_squares(), (torch.ones(3), torch.ones(3)), x0)
    with pytest.raises(ValueError, match=r"shape \(4, 4\)"):
        batched_oracle.kernel_operands(tprob.quadratic(np.eye(3)), (), x0)
    with pytest.raises(ValueError, match=r"shape \(2,\)"):
        batched_oracle.kernel_operands(
            tprob.log_sum_exp(np.ones((2, 4)), np.ones(3)), (), x0)


@pytest.mark.parametrize("name", ["quadratic_2d", "example_bfgs", "exp_bowl"])
def test_hessian_and_hvp_match_jax(name):
    """The second-derivative forms of the K7-K9 objectives against
    ``jax.hessian`` and JAX's forward-over-reverse HVP (1e-12 relative)."""
    tobj, jf, n, _ = _cases()[name]
    rng = np.random.RandomState(14)
    X = rng.uniform(-1.0, 1.0, (6, n))
    V = rng.standard_normal((6, n))
    jh = np.asarray(jax.vmap(jax.hessian(jf))(jnp.asarray(X)))
    jhv = np.asarray(jax.vmap(
        lambda x, v: jax.jvp(jax.grad(jf), (x,), (v,))[1])(
            jnp.asarray(X), jnp.asarray(V)))
    H = tobj.hessian(torch.from_numpy(X))
    Hv = tobj.hvp(torch.from_numpy(X), torch.from_numpy(V))
    atol = RTOL * np.abs(jh).max()
    np.testing.assert_allclose(H.numpy(), jh, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(Hv.numpy(), jhv, rtol=RTOL, atol=atol)


def test_exp_bowl_has_no_functor():
    """A CUDA-bound call with ``exp_bowl`` raises and names the functor no
    kernel compiles; ``quadratic_2d`` and ``example_bfgs`` map to the
    weighted-squares and quadratic functors."""
    x0 = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="EXP_BOWL"):
        batched_oracle.kernel_operands(tprob.exp_bowl(), (), x0)
    code, (d, t) = batched_oracle.kernel_operands(tprob.quadratic_2d(90.0),
                                                  (), x0)
    assert code == batched_oracle.KERNEL_OBJECTIVES["WEIGHTED_SQUARES"]
    assert d.tolist() == [1.0, 90.0] and t.tolist() == [0.0, 0.0]
    code, (Q, b) = batched_oracle.kernel_operands(
        tprob.example_bfgs(), (), torch.zeros((3, 3), dtype=torch.float64))
    assert code == batched_oracle.KERNEL_OBJECTIVES["QUADRATIC"]
    assert Q.tolist() == [[2.0, 1.0, 0.0], [1.0, 4.0, 1.0], [0.0, 1.0, 6.0]]
    assert b.tolist() == [0.0, 0.0, 0.0]
