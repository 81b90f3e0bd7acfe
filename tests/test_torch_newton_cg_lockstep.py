"""The port's lockstep Newton-CG (``solvers/newton_cg.py``: ``make_newton_cg_step``,
``newton_cg_minimize``, the lockstep batch of ``newton_cg_batch_minimize``)
against JAX's XLA solver (``solvers/newton_cg.py``: ``newton_cg_minimize``
and ``newton_cg_batch_minimize``), and the routes to it.

Geometries (float64, n <= 20, B <= 8, starts from numpy seeds): Rosenbrock
bounded and unbounded, a quadratic whose optimum lies on its lower bounds, a
log-sum-exp with more rows than columns (n < rows, full-rank Hessian) and
with fewer (n > rows: the Hessian is singular and CG meets zero curvature
on A's null space), and a torch callable without analytic forms (its HVP is
``torch.func``'s jvp of the gradient, JAX's forward-over-reverse).  The
library objectives' HVPs are analytic on the port's side and AD on JAX's,
so the two round differently.  Tolerances: status and iteration counts
equal per instance, x and f within 1e-9.  The log-sum-exp with n > rows
exits CG on curvature that rounding decides; over these geometries' solves
both sides still agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_geometries import lse_arrays
from optimization_solvers_tpu.core.oracle import make_oracle as jmake_oracle
from optimization_solvers_tpu.solvers import newton_cg as jnewton_cg
import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu_torch import interop, problems, solvers
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import fused_newton_cg
from optimization_solvers_tpu_torch.solvers import driver

torch.set_num_threads(1)

ATOL = 1e-9
INF = np.inf


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _ws_jax(x, d, t):
    return 0.5 * jnp.sum(d * (x - t) ** 2)


def _lse_jax(x, A, b):
    return jax.nn.logsumexp(A @ x + b)


def _coupled_jax(x):
    return jnp.sum(jnp.cosh(x)) + 0.5 * (jnp.sum(x) - 1.0) ** 2


def rosen_fn(x):
    """Rosenbrock as a plain torch callable (no analytic forms)."""
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2)


def coupled_fn(x):
    """``sum cosh(x) + 0.5 (sum x - 1)^2``: a dense Hessian, torch only."""
    return torch.sum(torch.cosh(x)) + 0.5 * (torch.sum(x) - 1.0) ** 2


def geometries():
    """name -> (port objective, JAX objective, data, x0 (B, n), lower,
    upper, config)."""
    rng = np.random.RandomState
    x_r = rng(0).uniform(-2, 2, (6, 10))
    d = rng(1).uniform(1.0, 5.0, 8)
    A1, b1 = lse_arrays(6, 16)
    A2, b2 = lse_arrays(20, 8)
    cfg = dict(pgtol=1e-8, factr=0.0, max_iter=200, cg_max=20)
    return {
        "rosenbrock_bounded": (problems.rosenbrock(), _rosen_jax, (), x_r,
                               np.full(10, -2.0), np.full(10, 2.0), cfg),
        "rosenbrock_unbounded": (problems.rosenbrock(), _rosen_jax, (), x_r,
                                 np.full(10, -INF), np.full(10, INF), cfg),
        "active_bounds_quadratic": (
            problems.weighted_squares(), _ws_jax, (d, np.zeros(8)),
            rng(2).uniform(1.0, 2.0, (8, 8)), np.full(8, 1.0),
            np.full(8, 2.0), dict(cfg, max_iter=100)),
        "lse_tall": (problems.log_sum_exp(A1, b1), _lse_jax, (),
                     rng(3).uniform(-1, 1, (8, 6)), np.full(6, -1.0),
                     np.full(6, 1.0), cfg),
        "lse_wide_singular": (problems.log_sum_exp(A2, b2), _lse_jax, (),
                              rng(4).uniform(-1, 1, (8, 20)),
                              np.full(20, -1.0), np.full(20, 1.0),
                              dict(cfg, max_iter=60)),
        "torch_callable": (rosen_fn, _rosen_jax, (), x_r, np.full(10, -2.0),
                           np.full(10, 2.0), cfg),
        "torch_callable_coupled": (coupled_fn, _coupled_jax, (),
                                   rng(5).uniform(-2, 2, (6, 12)),
                                   np.full(12, -INF), np.full(12, INF),
                                   dict(cfg, factr=1e7)),
    }


GEOMETRIES = geometries()


def jax_data(name):
    f, jf, data, *_ = GEOMETRIES[name]
    if jf is _lse_jax:
        A, b = f.kernel_form()[1]
        data = (np.asarray(A), np.asarray(b))
    return tuple(jnp.asarray(np.asarray(c, np.float64)) for c in data)


_JAX_ORACLES = {}


def jax_oracle(name):
    """One JAX oracle per objective and data, so that the geometries that
    share them share one compile of JAX's jitted batch solver."""
    jf = GEOMETRIES[name][1]
    data = jax_data(name)
    key = (jf, tuple(np.asarray(c).tobytes() for c in data))
    if key not in _JAX_ORACLES:
        _JAX_ORACLES[key] = jmake_oracle(jf, data=data)
    return _JAX_ORACLES[key]


def port_oracle(name):
    f, _, data, *_ = GEOMETRIES[name]
    return make_oracle(f, data=interop.tensors_from_numpy(*data))


def port_lockstep(name, x0=None):
    """The lockstep loop itself: make_newton_cg_step under lockstep_loop."""
    _, _, _, xs, lo, up, cfg = GEOMETRIES[name]
    xs = xs if x0 is None else x0
    tx0, tlo, tup = interop.tensors_from_numpy(xs, lo, up)
    config = solvers.NewtonCGConfig(**cfg)
    init_fn, keep_going_fn, step_fn, result_fn = solvers.make_newton_cg_step(
        port_oracle(name), tlo, tup, config)
    final = driver.lockstep_loop(init_fn, keep_going_fn, step_fn, tx0,
                                 config.max_iter)
    return result_fn(final)


def assert_matches(r, ref):
    r = interop.result_to_numpy(r)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(r.f, np.asarray(ref.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_lockstep_batch_matches_jax(name):
    _, _, _, x0, lo, up, cfg = GEOMETRIES[name]
    ref = jnewton_cg.newton_cg_batch_minimize(
        jax_oracle(name), jnp.asarray(x0),
        jnp.asarray(lo), jnp.asarray(up), jnewton_cg.NewtonCGConfig(**cfg))
    r = port_lockstep(name)
    assert_matches(r, ref)
    assert (r.status == Status.CONVERGED).all()


@pytest.mark.parametrize("name", ["rosenbrock_bounded", "lse_wide_singular",
                                  "torch_callable_coupled"])
def test_single_instance_matches_jax(name):
    """``newton_cg_minimize`` on one instance (the result without a batch
    axis) against JAX's while loop, and the same instance of the batch."""
    _, _, _, x0, lo, up, cfg = GEOMETRIES[name]
    ref = jnewton_cg.newton_cg_minimize(
        jax_oracle(name), jnp.asarray(x0[1]),
        jnp.asarray(lo), jnp.asarray(up), jnewton_cg.NewtonCGConfig(**cfg))
    tx1, tlo, tup = interop.tensors_from_numpy(x0[1], lo, up)
    r = solvers.newton_cg_minimize(port_oracle(name), tx1, tlo, tup,
                                   solvers.NewtonCGConfig(**cfg))
    assert r.x.shape == x0[1].shape and r.f.dim() == 0
    assert int(r.status) == int(ref.status)
    assert int(r.iterations) == int(ref.iterations)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=ATOL)
    # the batch's products round another way (BLAS blocks by batch size)
    batch = port_lockstep(name)
    assert int(batch.iterations[1]) == int(r.iterations)
    torch.testing.assert_close(batch.x[1], r.x, rtol=0, atol=ATOL)


def test_batch_minimize_routes_the_callables_to_the_lockstep_loop():
    """``newton_cg_batch_minimize``: a torch callable and an oracle without
    a raw objective run the lockstep loop; a library objective runs K4's
    plain version on the CPU."""
    before = fused_newton_cg.newton_cg_solve_fused.launches
    _, _, _, x0, lo, up, cfg = GEOMETRIES["torch_callable"]
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    config = solvers.NewtonCGConfig(**cfg)
    r = solvers.newton_cg_batch_minimize(port_oracle("torch_callable"), tx0,
                                         tlo, tup, config)
    ref = port_lockstep("torch_callable")
    torch.testing.assert_close(r.x, ref.x, rtol=0, atol=0)
    assert torch.equal(r.iterations, ref.iterations)
    # the same objective with its analytic forms takes K4 (the plain version
    # here): the same algorithm, so the same results within rounding
    k4 = solvers.newton_cg_batch_minimize(
        make_oracle(problems.rosenbrock()), tx0, tlo, tup, config)
    assert torch.equal(k4.status, ref.status)
    torch.testing.assert_close(k4.x, ref.x, rtol=0, atol=1e-6)
    assert fused_newton_cg.newton_cg_solve_fused.launches == before
    # through minimize: an oracle without a raw objective and a callable
    # both run the lockstep loop
    made = port_oracle("torch_callable")
    oracle = ostt.Oracle(made.first_order, value_fn=made.value)
    oracle.hvp = made.hvp
    for f in (oracle, rosen_fn):
        m = ostt.minimize(f, tx0, method="newton_cg", bounds=(tlo, tup),
                          **cfg)
        torch.testing.assert_close(m.x, ref.x, rtol=0, atol=0)


class CudaBatch:
    """What the routes read of a CUDA x0 (its device, shape and element
    size), so that they are decided here without a card."""

    def __init__(self, B, n, itemsize=4):
        self.device = torch.device("cuda")
        self.shape = (B, n)
        self._itemsize = itemsize

    def element_size(self):
        return self._itemsize

    def dim(self):
        return 2


def test_routes_for_a_cuda_x0(monkeypatch):
    """K4 takes a batch whose objective has a K4 functor and fits; the
    lockstep loop every other.  ``batch_minimize`` sends a batch on the card
    to K3 only where the chosen form compiles the objective's functor (its
    two entries spied on, the CUDA x0 passed through as it is)."""
    A, b = lse_arrays(1000, 512)
    lse = problems.log_sum_exp(A, b)
    takes = fused_newton_cg.takes
    assert takes(lse, (), CudaBatch(512, 1000))
    # config 4's width: past K4's shared memory
    assert not takes(problems.log_sum_exp(*lse_arrays(10000, 512)), (),
                     CudaBatch(512, 10000))
    assert not takes(rosen_fn, (), CudaBatch(512, 100))
    assert takes(problems.rosenbrock(), (), CudaBatch(10240, 100))
    assert not takes(problems.rosenbrock(), (), CudaBatch(2, 8000, 8))
    assert not takes(problems.exp_bowl(), (), CudaBatch(4, 2))

    monkeypatch.setattr(driver, "as_batch", lambda x0: x0)
    monkeypatch.setattr(driver, "_lockstep", lambda *a, **k: "lockstep")
    monkeypatch.setattr(driver.fused_driver, "solve_spec",
                        lambda *a, **k: "K3")

    def route(method, search, oracle, x0, **kw):
        return driver.batch_minimize(method, search, oracle, x0, **kw)

    ls = ostt.linesearch
    gd, bt = solvers.GradientDescent(), ls.BackTracking()
    pn, btb = solvers.ProjectedNewton(), ls.BackTrackingB()
    rosen = make_oracle(problems.rosenbrock())
    quad = make_oracle(problems.quadratic(np.eye(64)))
    lse256 = make_oracle(problems.log_sum_exp(*lse_arrays(256, 512)))
    callable_oracle = make_oracle(rosen_fn)
    cuda = CudaBatch(256, 64)
    assert route(gd, bt, rosen, cuda) == "K3"
    # the first-order form (a first-order method, an Armijo-family search)
    # compiles Rosenbrock and weighted squares; the quasi-Newton, Wolfe and
    # dense forms all four functors
    assert route(gd, bt, quad, cuda) == "lockstep"
    assert route(gd, bt, lse256, CudaBatch(256, 256)) == "lockstep"
    assert route(gd, bt, callable_oracle, cuda) == "lockstep"
    assert route(solvers.LBFGS(), ls.HagerZhang(), lse256,
                 CudaBatch(256, 256)) == "K3"
    assert route(solvers.LBFGS(), ls.BackTracking(), quad, cuda) == "K3"
    assert route(solvers.NonlinearCG(), ls.MoreThuente(), quad, cuda) == "K3"
    assert route(solvers.BFGS(), ls.MoreThuente(), lse256,
                 CudaBatch(256, 256)) == "K3"
    assert route(pn, btb, quad, cuda) == "K3"
    assert route(pn, btb, lse256, CudaBatch(256, 256)) == "K3"
    assert route(pn, btb, callable_oracle, cuda) == "lockstep"
    # a callback, per-instance bounds or unroll > 1 keep the lockstep loop;
    # fused=True goes to K3, whose CUDA wrapper raises on a functor the form
    # lacks, and fused=False never does
    assert route(gd, bt, rosen, cuda, callback=print) == "lockstep"
    assert route(gd, bt, rosen, cuda, unroll=2) == "lockstep"
    assert route(gd, bt, quad, cuda, fused=True) == "K3"
    assert route(gd, bt, rosen, cuda, fused=False) == "lockstep"
    # the CPU's plain version takes any callable
    (x,) = interop.tensors_from_numpy(np.zeros((4, 64)))
    assert route(gd, bt, callable_oracle, x) == "K3"
    assert route(gd, bt, quad, x) == "K3"
    # a log-sum-exp's rows count in the Newton form's fit
    many = make_oracle(problems.log_sum_exp(*lse_arrays(64, 60000)))
    assert route(pn, btb, many, CudaBatch(2, 64)) == "lockstep"
    with pytest.raises(ValueError, match="no fused kernel applies"):
        route(pn, btb, many, CudaBatch(2, 64), fused=True)


def test_oracle_without_hvp_raises_as_in_jax():
    tlo, tup = interop.tensors_from_numpy(np.full(4, -1.0), np.full(4, 1.0))
    bare = ostt.Oracle(lambda x: make_oracle(problems.rosenbrock())(x))
    with pytest.raises(ValueError, match="Hessian-vector products"):
        solvers.make_newton_cg_step(bare, tlo, tup)
    with pytest.raises(ValueError, match=r"x0 must be \(n,\)"):
        solvers.newton_cg_minimize(make_oracle(problems.rosenbrock()),
                                   torch.zeros((2, 4), dtype=torch.float64),
                                   tlo, tup)
