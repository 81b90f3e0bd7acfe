"""The large-n slice of the port's ``minimize(..., method="lbfgsb")``: the
route by fit between K1 and the tall kernel K2, ``policy``, K2's dcsrch
mode against the JAX Pallas kernel K2, and the MINPACK ``dcstep`` update.

The JAX reference is ``ops.pallas_lbfgsb_tall.lbfgsb_solve_fused_tall``
with ``line_search="dcsrch"`` in interpret mode (``tile = B``; one call per
module, ~40 s here) on the config-4 class geometry of
``tests/_torch_geometries.py``.  Tolerances (float64): iteration counts and
status equal, x within 1e-6, f within rtol 1e-10 (atol 1e-10); ``_dcstep``
within 1e-14 of JAX's on seeded inputs of all four cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu_torch as ostt
from _torch_geometries import k2_geometries, lse_arrays
from optimization_solvers_tpu.linesearch import dcsrch as jdcsrch
from optimization_solvers_tpu.ops import pallas_lbfgsb_tall as jk2
from optimization_solvers_tpu_torch import frontend, interop
from optimization_solvers_tpu_torch.linesearch import dcsrch as tdcsrch
from optimization_solvers_tpu_torch.ops import fused_lbfgsb, fused_lbfgsb_tall

torch.set_num_threads(1)

NAME = "lse_config4_class"


def _jax_lse(x, A, b):
    z = A @ x + b
    mx = jnp.max(z)
    return mx + jnp.log(jnp.sum(jnp.exp(z - mx)))


@pytest.fixture(scope="module")
def jax_dcsrch():
    _, x0, lo, up, _, opts = k2_geometries()[NAME]
    return jk2.lbfgsb_solve_fused_tall(
        _jax_lse, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(up),
        consts=tuple(jnp.asarray(c) for c in lse_arrays()),
        tile=x0.shape[0], interpret=True, line_search="dcsrch", **opts)


def _assert_matches(port, ref):
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.iterations,
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.f, np.asarray(ref.f), rtol=1e-10,
                               atol=1e-10)
    assert (port.status == ostt.Status.CONVERGED).all()


def test_plain_dcsrch_matches_jax_kernel(jax_dcsrch):
    obj, x0, lo, up, _, opts = k2_geometries()[NAME]
    tx0, tlo, tup = interop.tensors_from_numpy(x0, lo, up)
    port = interop.result_to_numpy(fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        obj, tx0, tlo, tup, line_search="dcsrch", **opts))
    _assert_matches(port, jax_dcsrch)


def test_slice_through_minimize_matches_jax_kernel(jax_dcsrch, monkeypatch):
    """policy="reference" on the config-4 class past K1's fit: the route
    takes K2 in dcsrch mode, on the CPU its plain version, and lands where
    JAX K2 lands.  The class's n = 400 fits K1's block (K1 compiles the
    log-sum-exp too), so the test shrinks the block's shared memory to one
    byte less than an instance takes, as a card with less of it would."""
    obj, x0, lo, up, _, opts = k2_geometries()[NAME]
    rows = obj.kernel_form()[1][0].shape[0]
    need = fused_lbfgsb.smem_per_instance(x0.shape[1], opts["m"], 8, rows)
    monkeypatch.setattr(fused_lbfgsb, "SMEM_PER_BLOCK", need - 1)
    calls = []
    orig = fused_lbfgsb_tall.lbfgsb_solve_tall_plain

    def spy(*a, **kw):
        calls.append(kw["line_search"])
        return orig(*a, **kw)

    monkeypatch.setattr(fused_lbfgsb_tall, "lbfgsb_solve_tall_plain", spy)
    (tx0,) = interop.tensors_from_numpy(x0)
    before = (fused_lbfgsb.lbfgsb_solve_fused.launches,
              fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches)
    port = interop.result_to_numpy(ostt.minimize(
        obj, tx0, method="lbfgsb", bounds=(-0.1, 0.1), m=opts["m"],
        tol=opts["pgtol"], factr=opts["factr"], max_iter=opts["max_iter"],
        policy="reference"))
    assert calls == ["dcsrch"]
    assert before == (fused_lbfgsb.lbfgsb_solve_fused.launches,
                      fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches)
    _assert_matches(port, jax_dcsrch)
    assert port.gcp_multimodal.shape == (x0.shape[0],)


# ---- the route ------------------------------------------------------------

@pytest.fixture
def route(monkeypatch):
    """Records which kernel ``minimize`` calls, with its keywords."""
    seen = []

    def fake(kernel):
        def call(f, x0, lower, upper, data, **kw):
            seen.append((kernel, kw))
            return kernel
        return call

    monkeypatch.setattr(frontend, "lbfgsb_solve_fused", fake("K1"))
    monkeypatch.setattr(frontend, "lbfgsb_solve_fused_tall", fake("K2"))
    return seen


def test_route_by_fit(route):
    """K1 takes every functor within its shared-memory fit, as JAX's route
    takes the lane-last kernel by its footprint; K2 every batch past it."""
    rosen = ostt.problems.rosenbrock()
    headline = torch.zeros((4, 100), dtype=torch.float32)
    assert ostt.minimize(rosen, headline, method="lbfgsb") == "K1"
    wide = torch.zeros((2, 10_000), dtype=torch.float32)
    A, b = lse_arrays(10_000, 8)
    lse = ostt.problems.log_sum_exp(A, b)
    assert ostt.minimize(lse, wide, method="lbfgsb", m=10) == "K2"
    # a K1 functor past K1's shared-memory fit, and a raw callable there
    assert ostt.minimize(rosen, wide, method="lbfgsb") == "K2"
    assert ostt.minimize(lambda x: (x * x).sum(), wide, method="lbfgsb") == "K2"
    assert ostt.minimize(lambda x: (x * x).sum(), headline,
                         method="lbfgsb") == "K1"
    # the quadratic and the log-sum-exp: K1 within its fit, K2 past it
    # (float64, m = 20: (2m+5) n + 7 m^2 + 13 m elements fit up to n = 577)
    q = ostt.problems.quadratic(np.eye(3))
    assert ostt.minimize(q, torch.zeros((2, 3)), method="lbfgsb") == "K1"
    small = ostt.problems.log_sum_exp(*lse_arrays(8, 5))
    assert ostt.minimize(small, torch.zeros((2, 8)), method="lbfgsb") == "K1"
    wide_q = ostt.problems.quadratic(np.eye(600))
    assert ostt.minimize(wide_q, torch.zeros((2, 600), dtype=torch.float64),
                         method="lbfgsb", m=20) == "K2"
    # a log-sum-exp's z (rows elements) counts: at n = 570 the last row
    # that fits, and one more
    n, m = 570, 20
    room = (fused_lbfgsb.SMEM_PER_BLOCK
            - fused_lbfgsb.smem_per_instance(n, m, 8)) // 8
    x570 = torch.zeros((2, n), dtype=torch.float64)
    for rows, expect in ((room, "K1"), (room + 1, "K2")):
        lse_r = ostt.problems.log_sum_exp(*lse_arrays(n, rows))
        assert ostt.minimize(lse_r, x570, method="lbfgsb", m=m) == expect
    assert fused_lbfgsb.fits(n, m, 8, room)
    assert not fused_lbfgsb.fits(n, m, 8, room + 1)
    # the fit boundary follows the kernel's shared memory formula
    # ((2m+5) n + 7 m^2 + 13 m elements and 32 mask words per 1,024
    # coordinates; m = 5, float32: n <= 3,849)
    assert ostt.minimize(rosen, torch.zeros((1, 3849)), method="lbfgsb",
                         max_iter=1) == "K1"
    assert ostt.minimize(rosen, torch.zeros((1, 3850)), method="lbfgsb",
                         max_iter=1) == "K2"
    assert fused_lbfgsb.smem_per_instance(3849, 5, 4) <= (
        fused_lbfgsb.SMEM_PER_BLOCK) < fused_lbfgsb.smem_per_instance(
            3850, 5, 4)


def test_policy_selects_the_line_search(route):
    """K2's line search by policy, on a quadratic past K1's fit (n = 600,
    float64, m = 20)."""
    q = ostt.problems.quadratic(np.eye(600))
    x0 = torch.zeros((2, 600), dtype=torch.float64)
    for kw, expect in ((dict(), "armijo"), (dict(policy="fast"), "armijo"),
                       (dict(policy="reference"), "dcsrch"),
                       (dict(policy="reference", tall_line_search="armijo"),
                        "armijo"),
                       (dict(tall_line_search="dcsrch"), "dcsrch")):
        ostt.minimize(q, x0, method="lbfgsb", m=20, **kw)
        assert route[-1] == ("K2", dict(
            m=20, pgtol=1e-6, factr=1e7, max_iter=1000, max_iter_ls=20,
            c1=1e-3, line_search=expect)), kw


def test_config4_shape_runs_k2_plain_on_the_cpu(monkeypatch):
    """A config-4-shaped call (n = 10,000, m = 10, box +-1; two instances,
    64 rows, two iterations) takes K2's plain version, not K1's."""
    calls = []
    for mod, name in ((fused_lbfgsb, "lbfgsb_solve_plain"),
                      (fused_lbfgsb_tall, "lbfgsb_solve_tall_plain")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    obj = ostt.problems.log_sum_exp(*lse_arrays(10_000, 64))
    x0 = np.random.RandomState(4).uniform(-0.5, 0.5, (2, 10_000))
    (tx0,) = interop.tensors_from_numpy(x0, dtype=torch.float32)
    r = ostt.minimize(obj, tx0, method="lbfgsb", bounds=(-1.0, 1.0), m=10,
                      tol=1e-5, factr=1e3, max_iter=2)
    assert calls == ["lbfgsb_solve_tall_plain"]
    assert (r.iterations == 2).all()
    assert r.x.shape == (2, 10_000) and r.x.dtype == torch.float32
    assert bool(torch.isfinite(r.f).all())
    assert (r.f < obj.value(tx0)).all()


# ---- MINPACK dcstep ---------------------------------------------------------

def _dcstep_inputs(case, brackt, size=64, seed=0):
    """Seeded operands of one of dcstep's four cases."""
    rng = np.random.RandomState(seed + 10 * case + int(brackt))
    stx = rng.uniform(0.0, 1.0, size)
    stp = stx + rng.choice([-1.0, 1.0], size) * rng.uniform(0.05, 1.0, size)
    sty = stx - (stp - stx) * rng.uniform(0.5, 2.0, size)
    fx = rng.uniform(-1.0, 1.0, size)
    fy = fx + rng.uniform(0.0, 1.0, size)
    dx = -rng.uniform(0.1, 2.0, size)
    dy = rng.uniform(-2.0, 2.0, size)
    if case == 1:                      # higher value
        fp, dp = fx + rng.uniform(0.01, 1.0, size), rng.uniform(-2, 2, size)
    elif case == 2:                    # lower value, opposite derivative
        fp, dp = fx - rng.uniform(0.01, 1.0, size), rng.uniform(0.1, 2, size)
    elif case == 3:                    # lower value, smaller |derivative|
        fp, dp = fx - rng.uniform(0.01, 1.0, size), dx * rng.uniform(0.1, 0.9,
                                                                     size)
    else:                              # lower value, larger |derivative|
        fp, dp = fx - rng.uniform(0.01, 1.0, size), dx * rng.uniform(1.1, 3.0,
                                                                     size)
    stmin = np.minimum(stx, sty) if brackt else np.zeros(size)
    stmax = np.maximum(stx, sty) if brackt else 5.0 * np.maximum(stp, stx)
    return (stx, fx, dx, sty, fy, dy, stp, fp, dp,
            np.full(size, brackt), stmin, stmax)


@pytest.mark.parametrize("brackt", [False, True])
@pytest.mark.parametrize("case", [1, 2, 3, 4])
def test_dcstep_matches_jax(case, brackt):
    args = _dcstep_inputs(case, brackt)
    stx, fx, dx, _, _, _, stp, fp, dp = args[:9]
    # the inputs land in the case they are drawn for
    sgnd = dp * np.sign(dx)
    in_case = {1: fp > fx, 2: (fp <= fx) & (sgnd < 0),
               3: (fp <= fx) & (sgnd >= 0) & (np.abs(dp) < np.abs(dx)),
               4: (fp <= fx) & (sgnd >= 0) & (np.abs(dp) >= np.abs(dx))}
    assert in_case[case].all()
    ref = jdcsrch._dcstep(*(jnp.asarray(a) for a in args))
    got = tdcsrch._dcstep(*(torch.from_numpy(np.asarray(a)) for a in args))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14,
                                   atol=1e-14)


def test_dcstep_nan_trial():
    """A NaN trial value counts as higher and the NaN trial polynomial
    bisects the bracket, as in JAX."""
    args = list(_dcstep_inputs(1, True, size=8))
    args[7] = np.full(8, np.nan)
    ref = jdcsrch._dcstep(*(jnp.asarray(a) for a in args))
    got = tdcsrch._dcstep(*(torch.from_numpy(np.asarray(a)) for a in args))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14,
                                   atol=1e-14)
