"""The port's lockstep L-BFGS-B (``solvers/lbfgsb.py``) against the JAX
package's on the CPU in float64: ``lbfgsb_minimize``,
``lbfgsb_batch_minimize`` and ``lbfgsb_minimize_scaled`` on the geometries
of ``tests/test_lbfgs.py`` and ``tests/test_abnormal.py``, and the small
Choleskys (``ops/smallchol.py``).

Each geometry is held per instance: status and iteration count equal, x
and f within 1e-9.  The two run the same algorithm in the same order of
operations; their sums may round in another order, which these geometries
carry through their solves by far less than 1e-9.  Each JAX reference is
computed by the test that uses it (a JAX solve compiles in a few
seconds).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu_torch as ostt
from optimization_solvers_tpu.core import problems as jprob
from optimization_solvers_tpu.core.oracle import Oracle as JOracle
from optimization_solvers_tpu.core.oracle import make_oracle as jmake
from optimization_solvers_tpu.core.types import FuncEval as JFuncEval
from optimization_solvers_tpu.ops import smallchol as jchol
from optimization_solvers_tpu.solvers import lbfgsb as jl
from optimization_solvers_tpu_torch.core import problems as tprob
from optimization_solvers_tpu_torch.core.oracle import Oracle, make_oracle
from optimization_solvers_tpu_torch.core.types import FuncEval, Status
from optimization_solvers_tpu_torch.ops import fused_lbfgsb, smallchol
from optimization_solvers_tpu_torch.solvers import lbfgsb as tl

torch.set_num_threads(1)

ATOL = 1e-9
INF = np.inf


def held(port, ref):
    """Per instance: status and iterations equal, x and f within ATOL."""
    np.testing.assert_array_equal(np.asarray(port.status),
                                  np.asarray(ref.status))
    np.testing.assert_array_equal(np.asarray(port.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(port.f.numpy(), np.asarray(ref.f), rtol=0,
                               atol=ATOL)


def t(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays)


# ---- the geometries of tests/test_lbfgs.py ---------------------------------

def _dust_problem():
    n, seed = 5, 1209
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(n, n))
    Q = (q * np.logspace(0, 2.0, n)) @ q.T
    x0 = rng.uniform(-5, 5, n)
    rng2 = np.random.RandomState(seed + 2)
    lo = np.sort(rng2.uniform(-3, 0, n))
    hi = np.sort(rng2.uniform(0.5, 3, n))
    Qj, Qt = jnp.asarray(Q), torch.as_tensor(Q)
    return ((lambda x: 0.5 * x @ Qj @ x), (lambda x: 0.5 * x @ Qt @ x),
            x0, lo, hi)


def _target_problem(d, target):
    dj, tj = jnp.asarray(d), jnp.asarray(target)
    dt, tt = t(d, target)
    return ((lambda x: 0.5 * jnp.sum(dj * (x - tj) ** 2)),
            (lambda x: 0.5 * torch.sum(dt * (x - tt) ** 2)))


def single_geometries():
    """name -> (JAX objective, port objective, x0, lower, upper, config)."""
    rng = np.random.RandomState(0)
    x_scipy = rng.uniform(-2, 2, 12)
    dust_j, dust_t, dust_x0, dust_lo, dust_hi = _dust_problem()
    mixed = _target_problem([3.0, 10.0, 1.0, 5.0, 2.0],
                            [4.0, -7.0, 9.0, -3.0, 6.0])
    return {
        "unbounded_rosenbrock": (
            jprob.rosenbrock(), tprob.rosenbrock(), np.full(25, -1.2),
            np.full(25, -INF), np.full(25, INF),
            dict(m=10, pgtol=1e-7, factr=10.0, max_iter=1000)),
        "active_bounds_quadratic": (
            jprob.shifted_quadratic_2d(), tprob.shifted_quadratic_2d(),
            np.zeros(2), np.array([-INF, -INF]), np.ones(2),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)),
        "bound_active_at_gamma1e9": (
            jprob.quadratic_2d(1e9), tprob.quadratic_2d(1e9),
            np.array([40.0, 30.0]), np.full(2, -1.0), np.full(2, 47.0),
            dict(m=5, pgtol=1e-7, factr=10.0, max_iter=500)),
        "starts_outside_box": (
            jprob.example_gd(), tprob.example_gd(), np.array([-10.0, 10.0]),
            np.full(2, 2.0), np.full(2, 5.0),
            dict(m=5, pgtol=1e-8, max_iter=200)),
        "rosenbrock_against_scipy": (
            jprob.rosenbrock(), tprob.rosenbrock(), x_scipy,
            np.full(12, -1.5), np.full(12, 1.5),
            dict(m=10, pgtol=1e-9, factr=10.0, max_iter=2000)),
        "no_stall_on_bound_dust": (
            dust_j, dust_t, dust_x0, dust_lo, dust_hi,
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=500)),
        "mixed_infinite_bounds": (
            *mixed, np.zeros(5), np.array([-1.0, -1, -1, -INF, -INF]),
            np.array([1.0, 1, 1, INF, INF]),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)),
        "rosenbrock_plus_1e6": (
            lambda x: jprob.rosenbrock()(x) + 1e6,
            lambda x: tprob.rosenbrock()(x) + 1e6, x_scipy,
            np.full(12, -1.5), np.full(12, 1.5),
            dict(m=10, pgtol=1e-9, factr=10.0, max_iter=2000)),
        # six breakpoints tie at t = 1/6 (equal weights, targets outside
        # the box on both sides): the walk takes them in index order
        "tied_breakpoints": (
            *_target_problem(np.full(6, 2.0), [3.0, 3, 3, -3, -3, -3]),
            np.zeros(6), np.full(6, -1.0), np.full(6, 1.0),
            dict(m=5, pgtol=1e-10, factr=10.0, max_iter=50)),
        # two tied groups whose weights differ, and a free coordinate
        "tied_groups": (
            *_target_problem([1.0, 1.0, 4.0, 4.0, 0.5],
                             [2.5, -2.5, 1.75, -1.75, 0.2]),
            np.zeros(5), np.full(5, -1.5), np.full(5, 1.5),
            dict(m=5, pgtol=1e-10, factr=10.0, max_iter=50)),
    }


def run_single(name, **extra):
    jf, tf, x0, lo, up, cfg = single_geometries()[name]
    cfg = dict(cfg, **extra)
    ref = jl.lbfgsb_minimize(jmake(jf), jnp.asarray(x0), jnp.asarray(lo),
                             jnp.asarray(up), jl.LbfgsbConfig(**cfg))
    port = tl.lbfgsb_minimize(make_oracle(tf), *t(x0, lo, up),
                              tl.LbfgsbConfig(**cfg))
    return port, ref


# rosenbrock_plus_1e6 serves the rel_pg_stop case only: at f ~ 1e6 the
# gradient's last bits, and so pg_norm, round by ~1e-9
@pytest.mark.parametrize("name", sorted(set(single_geometries())
                                        - {"rosenbrock_plus_1e6"}))
def test_single_matches_jax(name):
    port, ref = run_single(name)
    held(port, ref)
    assert port.x.shape == ref.x.shape and port.status.dim() == 0
    assert int(port.status) == Status.CONVERGED
    # at gamma = 1e9 the gradient magnifies x's last bits a billion times
    scale = 1e9 if name == "bound_active_at_gamma1e9" else 1.0
    np.testing.assert_allclose(port.pg_norm.numpy(), np.asarray(ref.pg_norm),
                               rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("option", [dict(ls_c2=0.5), dict(rel_pg_stop=True),
                                    dict(curvature_eps=1e-3)])
def test_options_match_jax(option):
    """The options only the lockstep solver honours, each changing the
    solve.  ``rel_pg_stop`` runs on Rosenbrock + 1e6 with pgtol and factr
    0, where ``pg <= 1e-10 f`` stops it first."""
    name, extra = "rosenbrock_against_scipy", {}
    if "rel_pg_stop" in option:
        name, extra = "rosenbrock_plus_1e6", dict(pgtol=0.0, factr=0.0,
                                                  max_iter=300)
    port, ref = run_single(name, **extra, **option)
    held(port, ref)
    plain, _ = run_single(name, **extra)
    assert (int(port.iterations), int(port.status)) != (
        int(plain.iterations), int(plain.status))


def test_gcp_chunk_invariance():
    """JAX's invariance test over chunks (1, 7, 64, 256) on a bound-rich
    quadratic, and the port against JAX at chunk 7."""
    n = 60
    rng = np.random.RandomState(0)
    d = rng.uniform(0.5, 50.0, n)
    target = rng.uniform(2.0, 4.0, n) * np.sign(rng.randn(n))
    jf, tf = _target_problem(d, target)
    lo, up = np.full(n, -1.0), np.full(n, 1.0)
    x0 = rng.uniform(-0.5, 0.5, n)
    cfg = dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)
    results = [tl.lbfgsb_minimize(make_oracle(tf), *t(x0, lo, up),
                                  tl.LbfgsbConfig(gcp_chunk=k, **cfg))
               for k in (1, 7, 64, 256)]
    ref = results[0]
    assert int(ref.status) == Status.CONVERGED
    assert int(torch.sum((ref.x.abs() - 1.0).abs() < 1e-9)) > n // 2
    for r in results[1:]:
        torch.testing.assert_close(r.x, ref.x, rtol=0, atol=1e-12)
        assert int(r.iterations) == int(ref.iterations)
        assert int(r.status) == int(ref.status)
    jref = jl.lbfgsb_minimize(jmake(jf), jnp.asarray(x0), jnp.asarray(lo),
                              jnp.asarray(up),
                              jl.LbfgsbConfig(gcp_chunk=7, **cfg))
    held(results[1], jref)


def test_tied_cauchy_point_matches_jax():
    """The Cauchy point of a tied geometry with a history, against JAX's
    ``_cauchy_point``: the port's stable sort takes tied breakpoints in
    index order (JAX sorts with ``lax.sort``); a tie group is processed
    whole, so only the sums' rounding could differ."""
    rng = np.random.RandomState(6)
    n, m = 8, 3
    x = np.zeros(n)
    g = np.array([-6.0, -6, -6, 6, 6, 6, -2.0, 0.5])
    lo, up = np.full(n, -1.0), np.full(n, 1.0)
    S, Y = rng.randn(m, n), rng.randn(m, n)
    Y = Y + 3.0 * S                     # s.y > 0
    valid = np.array([False, True, True])
    S[~valid] = 0.0
    Y[~valid] = 0.0
    theta = 1.7
    jh = jl._History(jnp.asarray(S), jnp.asarray(Y), jnp.asarray(valid),
                     jnp.asarray(theta))
    Wt, M = jl._build_middle(jh, jl._grams(jh))
    jx, jc, jfree = jl._cauchy_point(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(lo), jnp.asarray(up), Wt, M,
                                     jh.theta, chunk=4)
    th = tl._History(*t(S[None], Y[None]), torch.as_tensor(valid[None]),
                     torch.tensor([theta], dtype=torch.float64))
    tWt, tM = tl._build_middle(th, tl._grams(th))
    px, pc, pfree = tl._cauchy_point(*t(x[None], g[None], lo, up), tWt, tM,
                                     th.theta, chunk=4)
    np.testing.assert_array_equal(pfree[0].numpy(), np.asarray(jfree))
    np.testing.assert_allclose(px[0].numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc), rtol=0,
                               atol=1e-12)


# ---- batches ---------------------------------------------------------------

def test_batch_matches_jax_and_singles():
    """The lockstep batch against JAX's lockstep batch and against the
    port's own single solves (tests/test_lbfgs.py:265)."""
    n = 10
    lo, up = np.full(n, -2.0), np.full(n, 2.0)
    cfg = dict(m=5, pgtol=1e-6, factr=10.0, max_iter=500)
    x0s = np.stack([np.full(n, -1.2), np.zeros(n), np.full(n, 1.5)])
    ref = jl.lbfgsb_batch_minimize(jmake(jprob.rosenbrock()),
                                   jnp.asarray(x0s), jnp.asarray(lo),
                                   jnp.asarray(up), jl.LbfgsbConfig(**cfg))
    oracle = make_oracle(tprob.rosenbrock())
    port = tl.lbfgsb_batch_minimize(oracle, *t(x0s, lo, up),
                                    tl.LbfgsbConfig(**cfg))
    held(port, ref)
    for i in range(3):
        single = tl.lbfgsb_minimize(oracle, *t(x0s[i], lo, up),
                                    tl.LbfgsbConfig(**cfg))
        torch.testing.assert_close(port.x[i], single.x, rtol=0, atol=0)
        assert int(port.iterations[i]) == int(single.iterations)
        assert int(port.status[i]) == int(single.status)


def test_per_lane_boxes_match_jax_vmap():
    """(B, n) boxes broadcast in the port's step; JAX's front end vmaps the
    single solver over them (frontend.py:425-431)."""
    B, n = 4, 8
    rng = np.random.RandomState(3)
    lo = -rng.uniform(0.3, 1.5, (B, n))
    up = rng.uniform(0.3, 1.5, (B, n))
    x0 = rng.uniform(-0.3, 0.3, (B, n))
    cfg = dict(m=5, pgtol=1e-8, factr=10.0, max_iter=300)
    oracle = jmake(jprob.rosenbrock())
    ref = jax.vmap(lambda xi, li, ui: jl.lbfgsb_minimize(
        oracle, xi, li, ui, jl.LbfgsbConfig(**cfg)))(
            jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(up))
    port = tl.lbfgsb_batch_minimize(make_oracle(tprob.rosenbrock()),
                                    *t(x0, lo, up), tl.LbfgsbConfig(**cfg))
    held(port, ref)
    assert bool((port.x >= torch.as_tensor(lo)).all()
                and (port.x <= torch.as_tensor(up)).all())
    # the front end takes them to the same solver with a lockstep option
    r = ostt.minimize(tprob.rosenbrock(), t(x0)[0], method="lbfgsb",
                      bounds=t(lo, up), tol=1e-8, factr=10.0, max_iter=300,
                      verbose=0)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-6)


# ---- the scaled solver -----------------------------------------------------

def scaled_geometries():
    """name -> (JAX objective, port objective, x0, lower, upper, diag,
    config): the geometries of tests/test_lbfgs.py:179-238."""
    h50 = np.logspace(0, 6, 50)
    h20 = np.logspace(0, 4, 20)
    hj50, ht50 = jnp.asarray(h50), torch.as_tensor(h50)
    hj20, ht20 = jnp.asarray(h20), torch.as_tensor(h20)
    return {
        "jacobi": (
            lambda x: 0.5 * jnp.sum(hj50 * x * x),
            lambda x: 0.5 * torch.sum(ht50 * x * x),
            np.random.RandomState(0).uniform(-2, 2, 50), np.full(50, -3.0),
            np.full(50, 3.0), h50,
            dict(m=5, pgtol=1e-6, factr=0.0, max_iter=200)),
        "active_bounds": (
            lambda x: 0.5 * jnp.sum(hj20 * (x - 2.0) ** 2),
            lambda x: 0.5 * torch.sum(ht20 * (x - 2.0) ** 2),
            np.zeros(20), np.full(20, -1.0), np.full(20, 1.0), h20,
            dict(m=5, pgtol=1e-8, factr=0.0, max_iter=200)),
        "identity_diag": (
            jprob.rosenbrock(), tprob.rosenbrock(),
            np.random.RandomState(1).uniform(-2, 2, 8), np.full(8, -5.0),
            np.full(8, 5.0), np.ones(8),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=500)),
    }


@pytest.mark.parametrize("name", sorted(scaled_geometries()))
def test_scaled_matches_jax(name):
    jf, tf, x0, lo, up, diag, cfg = scaled_geometries()[name]
    ref = jl.lbfgsb_minimize_scaled(jmake(jf), jnp.asarray(x0),
                                    jnp.asarray(lo), jnp.asarray(up),
                                    jnp.asarray(diag), jl.LbfgsbConfig(**cfg))
    port = tl.lbfgsb_minimize_scaled(make_oracle(tf), *t(x0, lo, up, diag),
                                     tl.LbfgsbConfig(**cfg))
    held(port, ref)
    np.testing.assert_allclose(port.g.numpy(), np.asarray(ref.g), rtol=1e-9,
                               atol=ATOL)
    assert int(port.status) == Status.CONVERGED
    if name == "jacobi":
        assert int(port.iterations) <= 3 and float(port.f) < 1e-12
        assert bool((port.x.abs() < 1e-6).all())
    if name == "identity_diag":
        plain = tl.lbfgsb_minimize(make_oracle(tf), *t(x0, lo, up),
                                   tl.LbfgsbConfig(**cfg))
        torch.testing.assert_close(port.x, plain.x, rtol=0, atol=0)
        assert int(port.iterations) == int(plain.iterations)


# ---- failure semantics: tests/test_abnormal.py ------------------------------

def _inconsistent():
    """f = ||x||^2 reported with g = -2x: every direction is uphill."""
    jo = JOracle(lambda x: JFuncEval(jnp.sum(x * x), -2.0 * x),
                 lambda x: jnp.sum(x * x))
    to = Oracle(lambda X: FuncEval(torch.sum(X * X, -1), -2.0 * X),
                lambda X: torch.sum(X * X, -1))
    return jo, to


def _nan_wall(delta=1e-9):
    def fj(x):
        inside = jnp.max(jnp.abs(x)) < delta
        return jnp.where(inside, jnp.sum((x - 1.0) ** 2),
                         jnp.asarray(jnp.nan, x.dtype))

    def ft(x):
        inside = torch.amax(torch.abs(x)) < delta
        return torch.where(inside, torch.sum((x - 1.0) ** 2),
                           torch.full((), torch.nan, dtype=x.dtype))

    return jmake(fj), make_oracle(ft)


def test_inconsistent_oracle_ends_abnormal():
    jo, to = _inconsistent()
    x0 = np.array([1.5, -2.0])
    cfg = dict(pgtol=1e-8, factr=10.0, max_iter=100)
    ref = jl.lbfgsb_minimize(jo, jnp.asarray(x0), jnp.full(2, -jnp.inf),
                             jnp.full(2, jnp.inf), jl.LbfgsbConfig(**cfg))
    port = tl.lbfgsb_minimize(to, *t(x0, np.full(2, -INF), np.full(2, INF)),
                              tl.LbfgsbConfig(**cfg))
    held(port, ref)
    assert int(port.status) == Status.ABNORMAL
    np.testing.assert_array_equal(port.x.numpy(), x0)     # restored


def test_nan_wall_ends_abnormal():
    jo, to = _nan_wall()
    cfg = dict(pgtol=1e-8, factr=10.0, max_iter=50)
    ref = jl.lbfgsb_minimize(jo, jnp.zeros(3), jnp.full(3, -10.0),
                             jnp.full(3, 10.0), jl.LbfgsbConfig(**cfg))
    port = tl.lbfgsb_minimize(to, *t(np.zeros(3), np.full(3, -10.0),
                                     np.full(3, 10.0)),
                              tl.LbfgsbConfig(**cfg))
    held(port, ref)
    assert int(port.status) == Status.ABNORMAL and float(port.f) == 3.0


def test_restart_then_abnormal():
    """With history, a failed search restarts (the model zeroed, the
    iterate kept, the stall exit off); from the empty model the next
    failure ends ABNORMAL (test_abnormal.py:80-112)."""
    _, to = _inconsistent()
    x0 = torch.tensor([[1.5, -2.0]], dtype=torch.float64)
    inf = torch.full((2,), INF, dtype=torch.float64)
    init_fn, keep_going_fn, step_fn = tl.make_lbfgsb_step(
        to, -inf, inf, tl.LbfgsbConfig(pgtol=1e-8, factr=10.0,
                                       max_iter=100))
    c = init_fn(x0)
    S, Y, valid = c.hist.S.clone(), c.hist.Y.clone(), c.hist.valid.clone()
    S[:, -1] = torch.tensor([0.1, 0.1])
    Y[:, -1] = torch.tensor([0.2, 0.2])
    valid[:, -1] = True
    c = c._replace(hist=c.hist._replace(S=S, Y=Y, valid=valid))
    c1 = step_fn(c)
    assert not bool(c1.abnormal.any())
    torch.testing.assert_close(c1.x, x0, rtol=0, atol=0)
    assert not bool(c1.hist.valid.any())
    assert bool((c1.hist.S == 0.0).all() and (c1.hist.Y == 0.0).all())
    assert not bool(torch.isfinite(c1.f_prev).any())
    assert bool(keep_going_fn(c1).all())
    c2 = step_fn(c1)
    assert bool(c2.abnormal.all()) and not bool(keep_going_fn(c2).any())


def test_batched_abnormal_isolated_lane():
    """One walled lane ends ABNORMAL, the others converge
    (test_abnormal.py:115-146)."""
    def fj(x):
        q = (x[0] - 1.0) ** 2 + 4.0 * (x[1] - 1.0) ** 2
        keep = (jnp.max(jnp.abs(x)) < 1e-9) | (jnp.max(jnp.abs(x - 1.0)) < 0.5)
        return jnp.where(keep, q, jnp.asarray(jnp.nan, x.dtype))

    def ft(x):
        q = (x[0] - 1.0) ** 2 + 4.0 * (x[1] - 1.0) ** 2
        keep = ((torch.amax(torch.abs(x)) < 1e-9)
                | (torch.amax(torch.abs(x - 1.0)) < 0.5))
        return torch.where(keep, q, torch.full((), torch.nan,
                                               dtype=x.dtype))

    x0 = np.array([[0.0, 0.0], [1.2, 0.9], [0.8, 1.3]])
    cfg = dict(pgtol=1e-6, factr=10.0, max_iter=200)
    ref = jl.lbfgsb_batch_minimize(jmake(fj), jnp.asarray(x0),
                                   jnp.full(2, -100.0), jnp.full(2, 100.0),
                                   jl.LbfgsbConfig(**cfg))
    port = tl.lbfgsb_batch_minimize(make_oracle(ft), *t(x0, np.full(2, -100.0),
                                                        np.full(2, 100.0)),
                                    tl.LbfgsbConfig(**cfg))
    held(port, ref)
    assert port.status.tolist() == [Status.ABNORMAL, Status.CONVERGED,
                                    Status.CONVERGED]


# ---- the tracer ------------------------------------------------------------

def test_verbose_lines_match_jax(caplog):
    """``verbose=1`` logs one line per iteration at INFO, the JAX package's
    line under the port's logger name."""
    caplog.set_level(logging.INFO)
    port, ref = run_single("mixed_infinite_bounds", verbose=1)
    jax.block_until_ready(ref)
    jax.effects_barrier()
    held(port, ref)

    def lines(prefix):
        return [r.getMessage() for r in caplog.records
                if r.name == f"{prefix}.solver.Lbfgsb"]

    jax_lines = lines("optimization_solvers_tpu")
    port_lines = lines("optimization_solvers_tpu_torch")
    assert len(port_lines) == int(port.iterations) >= 2
    assert port_lines == jax_lines
    caplog.clear()
    x0 = np.zeros((3, 5))
    jf, tf, _, lo, up, cfg = single_geometries()["mixed_infinite_bounds"]
    tl.lbfgsb_batch_minimize(make_oracle(tf), *t(x0, lo, up),
                             tl.LbfgsbConfig(verbose=1, **cfg))
    batch = lines("optimization_solvers_tpu_torch")
    assert batch and all(m.startswith("k<=") and "batch=3" in m
                         for m in batch)


def test_front_end_runs_lockstep_on_cpu():
    """A 1-D x0 and the lockstep-only options run the lockstep solver from
    minimize, and K1 stays out of it."""
    jf, tf, x0, lo, up, cfg = single_geometries()["rosenbrock_against_scipy"]
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    (tx0,) = t(x0)
    r = ostt.minimize(tf, tx0, method="lbfgsb", bounds=t(lo, up),
                      tol=cfg["pgtol"], factr=cfg["factr"], m=cfg["m"],
                      max_iter=cfg["max_iter"])
    port, ref = run_single("rosenbrock_against_scipy")
    torch.testing.assert_close(r.x, port.x, rtol=0, atol=0)
    assert int(r.iterations) == int(port.iterations)
    rb = ostt.minimize(tf, tx0[None].repeat(2, 1), method="lbfgsb",
                       bounds=t(lo, up), tol=cfg["pgtol"], factr=cfg["factr"],
                       m=cfg["m"], max_iter=cfg["max_iter"], verbose=0)
    assert rb.x.shape == (2, 12) and (rb.status == Status.CONVERGED).all()
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before


# ---- the small Choleskys ---------------------------------------------------

def test_smallchol_matches_jax():
    rng = np.random.RandomState(4)
    A = rng.randn(3, 7, 7)
    A = A @ A.transpose(0, 2, 1) + 7.0 * np.eye(7)
    Bm = rng.randn(3, 7, 4)
    b = rng.randn(3, 7)
    Lj = jchol.cholesky_small(jnp.asarray(A))
    (Lt,) = t(A)
    Lt = smallchol.cholesky_small(Lt)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0,
                               atol=1e-13)
    pairs = [
        (smallchol.solve_lower_small_mat(Lt, t(Bm)[0]),
         jchol.solve_lower_small_mat(Lj, jnp.asarray(Bm))),
        (smallchol.solve_upper_small_mat(Lt, t(Bm)[0]),
         jchol.solve_upper_small_mat(Lj, jnp.asarray(Bm))),
        (smallchol.spd_solve_small_mat(Lt, t(Bm)[0]),
         jchol.spd_solve_small_mat(Lj, jnp.asarray(Bm))),
        (smallchol.spd_solve_small(Lt, t(b)[0]),
         jchol.spd_solve_small(Lj, jnp.asarray(b))),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(
        (smallchol.spd_solve_small(Lt, t(b)[0])[..., None]).numpy(),
        np.linalg.solve(A, b[..., None]), rtol=0, atol=1e-12)
    # no pivot floor: a matrix that is not positive definite gives NaN
    bad = smallchol.cholesky_small(-torch.eye(3, dtype=torch.float64))
    assert bool(torch.isnan(bad).any())
