"""The quadratic and log-sum-exp functors (``ops/csrc/objectives.cuh``) in
K1, K3's quasi-Newton, Wolfe and dense forms and K9: the port's plain
versions against the JAX package's TPU kernels in interpret mode, the
route of ``minimize(method="lbfgsb")`` to K1, and the kernels' own sources
through the warp emulator (``tests/_torch_warp_emulator.py``).

Inputs, float64 from numpy seeds: the log-sum-exp at config 4's recipe
(``_torch_geometries.lse_arrays``: A standard normal / sqrt(n), b =
linspace(-1, 1)) with 40 rows and n = 24 (one chunk of 32 rows and a
partial one) and with 20 rows and n = 40 (n > rows, as in config 4), box
[-1, 1], starts uniform(-0.5, 0.5); both are unbounded below without the
box, so the unconstrained methods (L-BFGS, NCG, BFGS, K9) take 40 rows and
n = 16, which is bounded below.  The quadratic at config 5's recipe (Q =
diag(linspace(1, 10, n)) + (0.2 / n) 1 1^T, b = 0) at n = 16, and a
non-symmetric Q (symmetric part positive definite) with b != 0 whose
minimizer lies outside the box [-2, 2], so that bounds are active; starts
uniform(-2, 2).

Tolerances.  K1 (``pallas_lbfgsb.lbfgsb_solve_fused(..., tile=1,
interpret=True)``), as ``test_torch_fused_lbfgsb.py``: status equal, x
within 1e-6, iteration counts within max(2, spread), ``spread`` the plain
version's own range under a 1e-15 relative change of x0.  K3
(``pallas_driver.fused_minimize(..., tile=B, interpret=True)``) and K9
(``pallas_bfgs.bfgs_solve_fused(..., interpret=True)``), as
``test_torch_qn_driver.py``: per instance over the first 15 iterations
(past them the bounded log-sum-exp and the dense QNB on the active box do
not converge and a 1e-15 change of x0 moves x by up to 0.1), status and
iteration counts equal, x within 1e-9 or, where larger, ten times the
port's own spread under that change (NCG + More-Thuente on the
log-sum-exp: 1.6e-8), f within 1e-11 of max(|f|, 1); K9's bounded-below
log-sum-exp also as a full solve.  The emulated kernels against the plain
versions: the same bits under both warp orders (seeds 1 and 2), status and
counts equal, x within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import (data_functor_case, perturbation_spread,
                               x_spread)
from optimization_solvers_tpu.ops import pallas_bfgs as jk9
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu.ops import pallas_lbfgsb as jk1
from optimization_solvers_tpu_torch import (frontend, interop, linesearch as ls,
                                            minimize, problems, solvers)
from optimization_solvers_tpu_torch.core.types import Status
from optimization_solvers_tpu_torch.ops import (fused_bfgs, fused_driver,
                                                fused_lbfgsb,
                                                fused_lbfgsb_tall)
from test_torch_fused_driver import to_jax

torch.set_num_threads(1)

B = 4
K1_B = 2                 # JAX K1 in interpret mode takes ~5 s an instance
HORIZON = 15
EMULATED_HORIZON = 8
K1_OPTS = dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200, max_iter_ls=20,
               c1=1e-3)


def _lse_jax(x, A, b):
    z = A @ x + b
    mx = jnp.max(z)
    return mx + jnp.log(jnp.sum(jnp.exp(z - mx)))


def _quad_jax(x, Q, b):
    return 0.5 * jnp.sum(x * (Q @ x)) + jnp.sum(b * x)


BOXED = ["lse_rows40_n24", "lse_rows20_n40", "quad_config5_n16",
         "quad_nonsymmetric"]
UNBOXED = ["lse_rows40_n16", "quad_config5_n16", "quad_nonsymmetric"]


def case(name, batch=B):
    """(port objective, JAX objective, data, x0, lower, upper)."""
    obj, data, x0, lo, up = data_functor_case(name, batch)
    jf = _lse_jax if obj.functor == "LOG_SUM_EXP" else _quad_jax
    return obj, jf, data, x0, lo, up


def jax_arrays(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def tensors(*arrays):
    return interop.tensors_from_numpy(*arrays)


# ---- K1 ------------------------------------------------------------------

def k1_plain(obj, x0, lo, up):
    return interop.result_to_numpy(fused_lbfgsb.lbfgsb_solve_fused(
        obj, *tensors(x0, lo, up), **K1_OPTS))


@pytest.mark.parametrize("name", BOXED)
def test_k1_plain_matches_jax_kernel(name):
    obj, jf, data, x0, lo, up = case(name, batch=K1_B)
    ref = jk1.lbfgsb_solve_fused(jf, *jax_arrays(x0, lo, up),
                                 consts=jax_arrays(*data), tile=1,
                                 interpret=True, **K1_OPTS)
    port = k1_plain(obj, x0, lo, up)
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0, atol=1e-6)
    spread = perturbation_spread(lambda v: k1_plain(obj, v, lo, up).iterations,
                                 x0)
    dit = np.abs(port.iterations.astype(np.int64)
                 - np.asarray(ref.iterations).astype(np.int64))
    assert dit.max() <= max(2, spread), (dit, spread)
    assert (port.status == Status.CONVERGED).all()
    if name == "quad_nonsymmetric":
        # the box is active at the solution
        assert (np.abs(port.x) == 2.0).any(axis=1).all()


@pytest.mark.parametrize("name", BOXED)
def test_minimize_routes_to_k1(name, monkeypatch):
    """``minimize(method="lbfgsb")`` on CPU tensors takes K1's plain
    version for both functors, as JAX's route takes K1 within its fit, and
    returns what ``lbfgsb_solve_fused`` returns."""
    calls = []
    for mod, fn in ((fused_lbfgsb, "lbfgsb_solve_plain"),
                    (fused_lbfgsb_tall, "lbfgsb_solve_tall_plain")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            calls.append(_fn)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    obj, _, _, x0, lo, up = case(name)
    tx0 = tensors(x0)[0]
    assert frontend.takes_k1(obj, tx0, K1_OPTS["m"])
    r = interop.result_to_numpy(minimize(
        obj, tx0, method="lbfgsb", bounds=tuple(tensors(lo, up)),
        m=K1_OPTS["m"], tol=K1_OPTS["pgtol"], factr=K1_OPTS["factr"],
        max_iter=K1_OPTS["max_iter"], ls_c1=K1_OPTS["c1"]))
    assert calls == ["lbfgsb_solve_plain"]
    direct = k1_plain(obj, x0, lo, up)
    for field in ("x", "f", "iterations", "status"):
        np.testing.assert_array_equal(getattr(r, field),
                                      getattr(direct, field))


# ---- K3: the quasi-Newton (L-BFGS), Wolfe (NCG) and dense forms ----------

K3_METHODS = {
    "lbfgs_hz": (lambda: solvers.LBFGS(tol=1e-8), ls.HagerZhang, False),
    "ncg_mt": (lambda: solvers.NonlinearCG(grad_tol=1e-8), ls.MoreThuente,
               False),
    "bfgs_mt": (lambda: solvers.BFGS(tol=1e-8), ls.MoreThuente, False),
    "bfgsb_mtb": (lambda: solvers.BFGSB(tol=1e-8), ls.MoreThuenteB, True),
}
K3_CASES = [(m, c) for m in sorted(K3_METHODS)
            for c in (BOXED if K3_METHODS[m][2] else UNBOXED)]


def k3_case(method_name, name):
    make, search, bounded = K3_METHODS[method_name]
    obj, jf, data, x0, lo, up = case(name)
    return make(), search(), bounded, obj, jf, data, x0, lo, up


def k3_plain(method, search, obj, x0, lo, up, bounded, max_iter=HORIZON):
    tlo, tup = tensors(lo, up) if bounded else (None, None)
    return interop.result_to_numpy(fused_driver.fused_minimize(
        method, search, obj, tensors(x0)[0], tlo, tup, (),
        max_iter=max_iter, max_iter_ls=20))


def assert_held(port, ref, spread):
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=0,
                               atol=max(1e-9, 10 * spread))
    f = np.asarray(ref.f)
    np.testing.assert_allclose(port.f, f, rtol=0,
                               atol=1e-11 * max(1.0, float(np.abs(f).max())))


@pytest.mark.parametrize("method_name,name", K3_CASES)
def test_k3_plain_matches_jax_kernel(method_name, name):
    method, search, bounded, obj, jf, data, x0, lo, up = k3_case(
        method_name, name)
    box = jax_arrays(lo, up) if bounded else (None, None)
    ref = jk3.fused_minimize(to_jax(method), to_jax(search), jf,
                             jnp.asarray(x0), *box, consts=jax_arrays(*data),
                             max_iter=HORIZON, max_iter_ls=20, tile=B,
                             interpret=True)
    port = k3_plain(method, search, obj, x0, lo, up, bounded)
    spread = x_spread(lambda v: k3_plain(method, search, obj, v, lo, up,
                                         bounded).x, x0)
    assert_held(port, ref, spread)


def test_k3_functors_by_form():
    """The first-order form compiles two functors; the quasi-Newton, Wolfe
    and dense forms (and the Newton form) all four."""
    spec = fused_driver.build_spec
    first = spec(solvers.GradientDescent(), ls.BackTracking())
    assert fused_driver.first_order_form(first)
    assert "QUADRATIC" not in fused_driver.compiled_functors(first)
    for method, search in ((solvers.LBFGS(), ls.HagerZhang()),
                           (solvers.LBFGS(), ls.BackTracking()),
                           (solvers.NonlinearCG(), ls.MoreThuente()),
                           (solvers.GradientDescent(), ls.StrongWolfe()),
                           (solvers.BFGS(), ls.MoreThuente()),
                           (solvers.BFGSB(), ls.BackTrackingB()),
                           (solvers.ProjectedNewton(), ls.BackTrackingB())):
        s = spec(method, search)
        assert not fused_driver.first_order_form(s)
        assert set(fused_driver.compiled_functors(s)) == {
            "ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC", "LOG_SUM_EXP"}
        # a log-sum-exp's z counts in these forms' fit, not in the
        # first-order form's
        assert fused_driver.k3_rows(s, "LOG_SUM_EXP", 512) == 512
    assert fused_driver.k3_rows(first, "LOG_SUM_EXP", 512) == 0


# ---- K9 ------------------------------------------------------------------

# K9 is unconstrained: the bounded-below log-sum-exp as a full solve, and
# the weakly unbounded one (rows 40, n 24: some d has A d <= -0.038) over
# the first 15 iterations; 20 rows and n = 40 run off to f ~ -1e9 there
K9_CASES = {"lse_rows40_n16": None, "lse_rows40_n24": HORIZON}


@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_k9_plain_matches_jax_kernel(name):
    """K9 on the log-sum-exp."""
    obj, jf, data, x0, _, _ = case(name)
    kw = dict(tol=1e-8, max_iter=K9_CASES[name] or 200, max_iter_ls=24,
              c1=1e-4)
    ref = jk9.bfgs_solve_fused(jf, jnp.asarray(x0), jax_arrays(*data),
                               tile=B, interpret=True, **kw)

    def plain(v):
        return interop.result_to_numpy(fused_bfgs.bfgs_solve_fused(
            obj, tensors(v)[0], (), **kw))

    port = plain(x0)
    assert_held(port, ref, x_spread(lambda v: plain(v).x, x0))
    if K9_CASES[name] is None:
        assert (port.status == Status.CONVERGED).all()


# ---- the kernels' own sources through the warp emulator -------------------

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cache = {}

    def get(kind):
        if kind not in cache:
            out = str(tmp_path_factory.mktemp(f"{kind}_data"))
            cache[kind] = {"k1": emulator.build, "k3": emulator.build_k3,
                           "k9": emulator.build_k9}[kind](out)
        return cache[kind]

    return get


def both_orders(run):
    """The run under seeds 1 and 2 (lowest warp first, highest first):
    the same bits."""
    a, b = run(1), run(2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    return a


def assert_emulated(got, plain):
    x, _, it, st = got[:4]
    xp, _, itp, stp = plain[:4]
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-10)


def test_emulated_k1_matches_plain(built):
    """Both functors over the first 10 iterations (one test: one build):
    at the non-symmetric quadratic's last step (its 13th or 14th) the
    kernel's sums and the plain version's matrix products, both right, put
    x 8e-9 apart at the same f."""
    for name in ("lse_rows40_n24", "quad_nonsymmetric"):
        obj, _, _, x0, lo, up = case(name, batch=2)
        args = (obj, *tensors(x0, lo, up), ())
        kw = dict(K1_OPTS, max_iter=10)
        got = both_orders(lambda seed: emulator.solve(built("k1"), *args,
                                                      seed=seed, **kw))
        assert_emulated(got, fused_lbfgsb.lbfgsb_solve_plain(*args, **kw))


# More-Thuente amplifies the rounding of the log-sum-exp (NCG's x moves by
# 5e-10 after 5 iterations under a 1e-15 change of x0), so the Wolfe form
# takes Hager-Zhang there (4e-16)
EMULATED_METHODS = dict(K3_METHODS, ncg_hz=(
    lambda: solvers.NonlinearCG(grad_tol=1e-8), ls.HagerZhang, False))
# form: its (method, objective) cases, one test (one build) each
EMULATED_K3 = {
    "quasi_newton": [("lbfgs_hz", "lse_rows40_n16"),
                     ("lbfgs_hz", "quad_config5_n16")],
    "wolfe": [("ncg_hz", "lse_rows40_n16"), ("ncg_mt", "quad_nonsymmetric")],
    "dense": [("bfgs_mt", "lse_rows40_n16"), ("bfgs_mt", "quad_config5_n16"),
              ("bfgsb_mtb", "lse_rows20_n40"),
              ("bfgsb_mtb", "quad_nonsymmetric")],
}


@pytest.mark.parametrize("form", sorted(EMULATED_K3))
def test_emulated_k3_forms_match_plain(form, built):
    """L-BFGS (the quasi-Newton form), NCG (the Wolfe form), BFGS and BFGSB
    (the dense form, a block of 4 warps), over the first 8 iterations."""
    for method_name, name in EMULATED_K3[form]:
        make, search, bounded = EMULATED_METHODS[method_name]
        method, search = make(), search()
        obj, _, _, x0, lo, up = case(name, batch=2)
        tx0, tlo, tup = tensors(x0, lo, up)
        box = (tlo, tup) if bounded else (None, None)
        kw = dict(max_iter=EMULATED_HORIZON, max_iter_ls=20)
        got = both_orders(lambda seed: emulator.driver_solve(
            built("k3"), method, search, obj, tx0, *box, seed=seed, **kw))
        plain = fused_driver.fused_minimize_plain(method, search, obj, tx0,
                                                  *box, (), **kw)
        assert_emulated(got, plain)
        assert torch.equal(got[4], plain[4])      # trials


def test_emulated_k9_matches_plain(built):
    """The log-sum-exp's two unconstrained cases, the first 15 iterations."""
    for name in ("lse_rows40_n16", "lse_rows40_n24"):
        obj, _, _, x0, _, _ = case(name, batch=2)
        tx0 = tensors(x0)[0]
        kw = dict(tol=1e-8, max_iter=HORIZON, max_iter_ls=24, c1=1e-4)
        got = both_orders(lambda seed: emulator.bfgs_solve(
            built("k9"), obj, tx0, seed=seed, **kw))
        assert_emulated(got, fused_bfgs.bfgs_solve_plain(obj, tx0, (), **kw))
