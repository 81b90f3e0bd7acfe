"""The port's generic driver K3, quasi-Newton slice (dense QN/QNB, L-BFGS
and the Wolfe searches), against the JAX Pallas kernel
``ops.pallas_driver.fused_minimize``.

The JAX reference runs in interpret mode with ``tile=B``, as in
``test_torch_fused_driver.py``; the port runs ``fused_minimize`` on a CPU
tensor (its plain version plus the epilogue, so the STALLED relabel is
compared too).  Geometries are ``tests/_torch_geometries.py:
k3_qn_geometries``.

Tolerances (float64): status equal per instance; iteration counts equal,
x within 1e-9 abs and f within 1e-12 relative or 1e-15 abs (f tends to 0
at these minimizers), pg_norm within 1e-9.  The one stall-exit entry
(BFGSB + MoreThuenteB with active bounds) ends at no minimizer: a 1e-15
relative change of x0 moves its end point by up to 1.4e-8, so it is held
to its own ``x_atol`` and ``f_rtol``.  On the chaotic entries (the
Rosenbrock starts) such a change alone moves the counts, so they are held
to ``max(2, spread)`` with ``spread`` the port's own range over 6 such
changes, and x to the entry's ``x_atol``.  At config 2's shape (64 x
Rosenbrock-100, float64) both versions are held per instance over the
first 30 iterations, where such a change moves x by under 1e-9 (2.2e-10
for L-BFGS + Hager-Zhang).  float32 is held by status counts and by the
property the JAX test checks.  The CUDA kernel is held against the plain
version on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimization_solvers_tpu.linesearch as jls
import optimization_solvers_tpu.solvers as jsolvers
from _torch_geometries import k3_qn_geometries, perturbation_spread
from optimization_solvers_tpu.core import types as jtypes
from optimization_solvers_tpu.ops import pallas_driver as jk3
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.core.types import FuncEval, Status
from optimization_solvers_tpu_torch.ops import fused_driver
from test_torch_fused_driver import _rosen_jax, run_jax, run_plain, to_jax

torch.set_num_threads(1)

F_RTOL, F_ATOL = 1e-12, 1e-15
GEOMETRIES = k3_qn_geometries()


def run_port(g, dtype=torch.float64):
    """The port's ``fused_minimize`` (plain version and epilogue)."""
    tx0, *tdata = interop.tensors_from_numpy(g["x0"], *g["data"], dtype=dtype)
    lo, up = (None if b is None else interop.tensors_from_numpy(
        b, dtype=dtype)[0] for b in (g["lower"], g["upper"]))
    return interop.result_to_numpy(fused_driver.fused_minimize(
        g["method"], g["search"], g["objective"], tx0, lo, up, tuple(tdata),
        max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"]))


@pytest.fixture(scope="module")
def jax_reference():
    """JAX K3 results per geometry, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_jax(GEOMETRIES[name])
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_kernel(name, jax_reference):
    g = GEOMETRIES[name]
    ref = jax_reference(name)
    r = run_port(g)
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    dit = np.abs(r.iterations.astype(np.int64)
                 - np.asarray(ref.iterations)).max()
    if g["chaotic"]:
        spread = perturbation_spread(
            lambda v: run_plain(g, v)[2].numpy(), g["x0"], runs=6)
        assert dit <= max(2, spread), (dit, spread)
    else:
        assert dit == 0
        np.testing.assert_allclose(r.f, np.asarray(ref.f),
                                   rtol=g["f_rtol"], atol=F_ATOL)
        np.testing.assert_allclose(r.pg_norm, np.asarray(ref.pg_norm),
                                   rtol=0, atol=max(1e-9, g["x_atol"]))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=1e-12,
                               atol=g["x_atol"])


def test_edge_geometries_end_as_designed(jax_reference):
    """The edge entries exercise what they are named for, on both sides."""
    ood = run_port(GEOMETRIES["lbfgs_hz_out_of_domain"])
    jood = jax_reference("lbfgs_hz_out_of_domain")
    for st, it in ((ood.status, ood.iterations),
                   (np.asarray(jood.status), np.asarray(jood.iterations))):
        # instance 0 starts at the minimizer, instance 1 where f overflows
        assert st[0] == Status.CONVERGED and it[0] == 0
        assert st[1] == Status.OUT_OF_DOMAIN and it[1] == 0
        assert (st[2:] == Status.CONVERGED).all()
    # the s/y-stall exit at active bounds is relabelled STALLED, with a
    # projected gradient above tol
    pinned = run_port(GEOMETRIES["bfgsb_mtb_pinned"])
    assert (pinned.status == Status.STALLED).all()
    assert (pinned.pg_norm > 1e-8).all()
    robust = run_port(GEOMETRIES["qn_robust_rosenbrock"])
    assert np.isin(robust.status, (Status.CONVERGED, Status.STALLED)).all()
    assert (robust.status == Status.STALLED).any()
    assert (robust.pg_norm[robust.status == Status.STALLED] > 1e-6).all()
    assert float(np.median(robust.f)) < 1e-10
    # per-instance boxes: each lane lands on its own box's clip of the
    # target
    g = GEOMETRIES["bfgsb_mtb_per_instance_boxes"]
    np.testing.assert_allclose(run_port(g).x,
                               np.clip(1.2, g["lower"], g["upper"]),
                               atol=1e-6)


def test_nfev_counts_the_wolfe_trials():
    """Each iteration of a Wolfe search evaluates at least one trial;
    More-Thuente at most three per trip, the others one per trip."""
    for name, per_trip in (("bfgs_mt", 3), ("lbfgs_hz", 1), ("lbfgs_sw", 1)):
        g = GEOMETRIES[name]
        _, _, it, _, nfev = run_plain(g)
        assert (nfev >= it).all(), name
        assert (nfev <= it * g["max_iter_ls"] * per_trip).all(), name


# ---- config 2's shape: 64 x Rosenbrock-100, float64, 30 iterations -----

CONFIG2_CASES = {
    # name: (port method, port search), built as config 2 and method="lbfgs"
    "bfgs_mt": (solvers.QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
                                    restart_on_degeneracy=True),
                ls.MoreThuente()),
    "bfgs_mt_approx_wolfe": (
        solvers.QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
                            restart_on_degeneracy=True),
        ls.MoreThuente(approx_wolfe=True)),
    "lbfgs_hz": (solvers.LBFGS(tol=1e-4), ls.HagerZhang()),
}


@pytest.mark.parametrize("name", sorted(CONFIG2_CASES))
def test_config2_shape_first_iterations_match_jax_kernel(name):
    method, search = CONFIG2_CASES[name]
    x0 = np.random.RandomState(42).uniform(-2, 2, (64, 100))
    kw = dict(max_iter=30, max_iter_ls=40)
    ref = jk3.fused_minimize(to_jax(method), to_jax(search), _rosen_jax,
                             jnp.asarray(x0), tile=64, interpret=True, **kw)

    def port(v):
        (tx0,) = interop.tensors_from_numpy(v)
        return interop.result_to_numpy(fused_driver.fused_minimize(
            method, search, problems.rosenbrock(), tx0, **kw))

    r = port(x0)
    nudge = np.random.RandomState(100).standard_normal(x0.shape)
    nudged = port(x0 * (1 + 1e-15 * nudge))
    # not yet chaotic: the port's own spread stays inside the tolerance
    assert np.abs(nudged.x - r.x).max() <= 1e-9
    # f moves with x by |g| |dx| (|g| ~ 10-100 at iteration 30): hold it to
    # 1e-12 relative or to ten times the nudge's own move, whichever is more
    f_spread = float((np.abs(nudged.f - r.f) / np.abs(r.f)).max())
    np.testing.assert_array_equal(r.status, np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations, np.asarray(ref.iterations))
    np.testing.assert_allclose(r.x, np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(r.f, np.asarray(ref.f),
                               rtol=max(1e-12, 10 * f_spread), atol=0)


# ---- float32 -------------------------------------------------------------

F32_CASES = ("bfgs_mt", "lbfgs_hz", "bfgsb_hzb", "dfp_bt", "gd_sw")


@pytest.mark.parametrize("name", F32_CASES)
def test_float32_matches_jax_by_status_and_median_f(name):
    """float32 at tol 1e-4 (1e-8 is below float32's gradient noise): the
    same status counts, and median f within 1e-6 (f starts at 10-100)."""
    g = GEOMETRIES[name]
    field = "grad_tol" if hasattr(g["method"], "grad_tol") else "tol"
    g = dict(g, method=dataclasses.replace(g["method"], **{field: 1e-4}))
    ref = run_jax(g, np.float32)
    r = run_port(g, torch.float32)
    assert r.x.dtype == np.float32 and r.f.dtype == np.float32
    np.testing.assert_array_equal(np.bincount(r.status, minlength=7),
                                  np.bincount(np.asarray(ref.status),
                                              minlength=7))
    assert abs(float(np.median(np.asarray(ref.f)))
               - float(np.median(r.f))) <= 1e-6


@pytest.mark.parametrize("approx_wolfe", [False, True])
def test_lbfgs_zero_progress_repair_float32(approx_wolfe):
    """tests/test_fused_driver.py:439 and :472 (float32 Rosenbrock-100, 32
    starts, L-BFGS m=5 + More-Thuente): no instance ends wedged far from
    stationarity, in JAX K3 and in the port alike, and with
    ``approx_wolfe`` every instance converges."""
    x0 = np.random.RandomState(7).uniform(-2, 2, (32, 100)).astype(np.float32)
    method = solvers.LBFGS(tol=1e-4, m=5)
    search = ls.MoreThuente(approx_wolfe=approx_wolfe)
    kw = dict(max_iter=600, max_iter_ls=30)
    ref = jk3.fused_minimize(to_jax(method), to_jax(search), _rosen_jax,
                             jnp.asarray(x0), tile=32, interpret=True, **kw)
    (tx0,) = interop.tensors_from_numpy(x0, dtype=torch.float32)
    r = interop.result_to_numpy(fused_driver.fused_minimize(
        method, search, problems.rosenbrock(), tx0, **kw))
    for st, pg in ((r.status, r.pg_norm),
                   (np.asarray(ref.status), np.asarray(ref.pg_norm))):
        assert pg[st != Status.CONVERGED].max(initial=0.0) < 0.05
        if approx_wolfe:
            assert (st == Status.CONVERGED).all()
    conv, conv_ref = ((s == Status.CONVERGED).sum()
                      for s in (r.status, np.asarray(ref.status)))
    assert abs(int(conv) - int(conv_ref)) <= 2


# ---- configs, specs and refusals ----------------------------------------

def _methods():
    return [solvers.GradientDescent(), solvers.ProjectedGradientDescent(),
            solvers.SpectralProjectedGradient(), solvers.NonlinearCG(),
            solvers.LBFGS(m=4), *(solvers.QuasiNewton(update=u) for u in
                                  ("bfgs", "dfp", "broyden", "sr1")),
            *(solvers.QuasiNewtonB(update=u) for u in
              ("bfgs", "dfp", "broyden", "sr1")),
            solvers.QuasiNewton(scale_b0=True, restart_on_degeneracy=True)]


def _searches():
    return [ls.BackTracking(), ls.BackTrackingB(), ls.GLLQuadratic(),
            ls.NoSearch(), ls.MoreThuente(), ls.MoreThuenteB(),
            ls.MoreThuente(approx_wolfe=True),
            ls.MoreThuente(reference_quirks=True),
            ls.MoreThuenteB(reference_quirks=True), ls.HagerZhang(),
            ls.HagerZhangB(), ls.StrongWolfe(), ls.StrongWolfe(bounded=True)]


def test_spec_builder_matches_jax_fused_supported():
    """Every method x search pair has a form exactly where JAX K3 has one:
    no reference_quirks, and a bounded search only with a bounded
    method."""
    for m in _methods():
        for s in _searches():
            assert fused_driver.fused_supported(m, s) == jk3.fused_supported(
                to_jax(m), to_jax(s)), (m, s)


def test_spec_fields():
    spec = fused_driver.build_spec(
        solvers.BFGSB(tol=1e-5, scale_b0=True), ls.MoreThuenteB(c2=0.8))
    assert (spec.method, spec.search, spec.bounded) == (
        fused_driver.QNB, fused_driver.MTB, True)
    assert spec.tol == 1e-5 and spec.scale_b0 and not spec.restart
    assert spec.c2 == 0.8 and spec.t_max == float("inf")
    spec = fused_driver.build_spec(solvers.QuasiNewton(update="other"),
                                   ls.HagerZhang(rho=4.0))
    assert spec.qn_update == 3 and spec.rho == 4.0   # any other name is SR1
    spec = fused_driver.build_spec(solvers.LBFGS(m=7, curvature_eps=1e-9),
                                   ls.StrongWolfe(xtol=0.2))
    assert (spec.lbfgs_m, spec.curv_eps, spec.xtol) == (7, 1e-9, 0.2)
    assert not spec.bounded and not spec.search_bounded


def test_configs_match_jax():
    """Same fields and defaults, the factories, the __post_init__ checks
    with JAX's text, and the STALLED hook."""
    for name in ("MoreThuente", "MoreThuenteB", "HagerZhang", "HagerZhangB",
                 "StrongWolfe"):
        port, ref = getattr(ls, name)(), getattr(jls, name)()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
    for name in ("BFGS", "DFP", "Broyden", "BFGSB", "DFPB", "BroydenB",
                 "SR1B"):
        port, ref = getattr(solvers, name)(), getattr(jsolvers, name)()
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
    assert dataclasses.asdict(solvers.LBFGS()) == dataclasses.asdict(
        jsolvers.LBFGS())
    with pytest.raises(ValueError) as terr:
        solvers.QuasiNewton(fused=True, scale_b0=True)
    with pytest.raises(ValueError) as jerr:
        jsolvers.QuasiNewton(fused=True, scale_b0=True)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(AssertionError, match="0 < c1 < c2 < 1"):
        ls.MoreThuente(c1=0.95)
    # the lockstep bodies: one post-step from B0 = I, then the direction,
    # per instance as JAX's vmapped ones
    rng = np.random.RandomState(12)
    x, xn, g, gn = (rng.uniform(-1, 1, (3, 5)) for _ in range(4))
    tx, txn, tg, tgn = interop.tensors_from_numpy(x, xn, g, gn)
    for kind in ("bfgs", "dfp", "broyden", "sr1"):
        port = solvers.QuasiNewton(update=kind)
        ref = jsolvers.QuasiNewton(update=kind)
        ev, evn = FuncEval(tg[:, 0], tg), FuncEval(tgn[:, 0], tgn)
        st = port.post_step(port.init(tx, ev, None), tx, ev, None, None,
                            txn, evn, None)
        d, _ = port.direction(st, txn, evn, None)

        def jstep(xi, xni, gi, gni, ref=ref):
            jev, jevn = jtypes.FuncEval(gi[0], gi), jtypes.FuncEval(gni[0],
                                                                   gni)
            jst = ref.post_step(ref.init(xi, jev, None), xi, jev, None, None,
                                xni, jevn, None)
            return ref.direction(jst, xni, jevn, None)[0]

        jd = jax.vmap(jstep)(*(jnp.asarray(a) for a in (x, xn, g, gn)))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-12, err_msg=kind)


def test_wolfe_predicates_match_jax():
    """The shared Wolfe-condition predicates of ``linesearch/base.py``,
    elementwise, on the same inputs as JAX's."""
    rng = np.random.RandomState(11)
    f_k, f_kp1, gd, gd1, t = rng.uniform(-1, 1, (5, 200))
    t = np.abs(t)
    targs = [torch.from_numpy(a) for a in (f_k, f_kp1, gd, gd1, t)]
    jargs = [jnp.asarray(a) for a in (f_k, f_kp1, gd, gd1, t)]
    for port, ref, pick in (
            (ls.sufficient_decrease, jls.sufficient_decrease, (0, 1, 2, 4)),
            (ls.curvature_condition, jls.curvature_condition, (2, 3)),
            (ls.strong_curvature_condition, jls.strong_curvature_condition,
             (2, 3))):
        c = 1e-4 if port is ls.sufficient_decrease else 0.9
        got = port(c, *(targs[i] for i in pick)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            ref(c, *(jargs[i] for i in pick))))
        assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(
        ls.strong_wolfe(1e-4, 0.9, *targs).numpy(),
        np.asarray(jls.strong_wolfe(1e-4, 0.9, *jargs)))


def test_stall_status_matches_jax():
    rng = np.random.RandomState(5)
    g = rng.uniform(-1e-4, 1e-4, (40, 6)) * rng.choice([1e-3, 1.0, 30.0],
                                                       (40, 1))
    pg = np.abs(g).max(-1) * rng.choice([0.1, 1.0], 40)
    for tol in (1e-6, 1e-4):
        port = solvers.QuasiNewtonB(tol=tol).stall_status(
            None, None, torch.from_numpy(g), torch.from_numpy(pg), None)
        ref = jsolvers.QuasiNewtonB(tol=tol).stall_status(
            None, None, jnp.asarray(g), jnp.asarray(pg), None)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        assert 0 < port.sum() < 40


def test_refusals_name_the_roadmap():
    (tx0,) = interop.tensors_from_numpy(
        np.random.RandomState(0).uniform(-1, 1, (4, 6)))
    oracle = make_oracle(problems.rosenbrock())
    # what K3 has no form for runs the lockstep loop, which still needs the
    # bounds a bounded search reads
    r = solvers.batch_minimize(solvers.BFGS(),
                               ls.MoreThuente(reference_quirks=True), oracle,
                               tx0, max_iter=5)
    assert r.iterations.max().item() <= 5
    with pytest.raises(ValueError, match="HagerZhangB requires bounds"):
        solvers.batch_minimize(solvers.BFGS(), ls.HagerZhangB(), oracle, tx0)
    with pytest.raises(ValueError, match="no fused kernel"):
        fused_driver.fused_minimize(solvers.LBFGS(),
                                    ls.MoreThuente(reference_quirks=True),
                                    problems.rosenbrock(), tx0)
    with pytest.raises(ValueError, match="requires bounds"):
        fused_driver.fused_minimize(solvers.BFGSB(), ls.MoreThuenteB(),
                                    problems.rosenbrock(), tx0)
    # an L-BFGS history too wide for a block's shared memory: the lockstep
    # loop under "auto", a refusal under fused=True
    wide = torch.zeros((2, 1200), dtype=torch.float64)
    r = solvers.batch_minimize(solvers.LBFGS(m=10), ls.HagerZhang(), oracle,
                               wide, max_iter=2)
    assert r.x.shape == (2, 1200)
    with pytest.raises(ValueError, match="too wide"):
        solvers.batch_minimize(solvers.LBFGS(m=10), ls.HagerZhang(), oracle,
                               wide, fused=True)


def test_shared_memory_and_workspace_rules():
    """7 n + ring + 2 m n + 3 m elements of shared memory per instance of
    the one-warp forms, and L-BFGS's compact form of H g 2 m^2 + 2 m more
    where it runs (m <= 32 and the total fits); the dense form's block (QN,
    QNB): 7 n + ring + 8 elements and the slab where it fits (config 2's
    1,024 x 100 in float32: the packed triangle in the block's 23,032
    bytes, no workspace), else one slab per instance in device memory."""
    assert fused_driver.smem_per_instance(100, 0, 4, 10) == (
        7 * 100 + 2 * 10 * 100 + 30 + 2 * 10 * 10 + 2 * 10) * 4
    assert fused_driver.smem_per_instance(100, 0, 4, 33) == (
        7 * 100 + 2 * 33 * 100 + 3 * 33) * 4
    assert fused_driver.smem_per_instance(64, 10, 4) == (7 * 64 + 10) * 4
    assert fused_driver.fits(100, 0, 8, 10)
    assert not fused_driver.fits(1200, 0, 8, 10)
    for method in (fused_driver.QN, fused_driver.QNB):
        assert fused_driver.smem_per_instance(100, 0, 4, method=method) == (
            7 * 100 + 8 + 100 * 101 // 2) * 4 == 23_032
        assert fused_driver.workspace_elems(1024, 100, method, 0, 4, 0) == 0
        assert fused_driver.workspace_elems(1024, 400, method, 0, 4, 0) == (
            1024 * 400 * 401 // 2)
        assert fused_driver.workspace_elems(1024, 400, method, 0, 4, 2) == (
            1024 * 400 * 401)
        assert fused_driver.smem_per_instance(400, 0, 4, method=method) == (
            7 * 400 + 8) * 4
    for method in (fused_driver.LBFGS, fused_driver.GD, fused_driver.SPG):
        assert fused_driver.workspace_elems(1024, 100, method) == 0
