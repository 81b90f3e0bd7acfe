"""Geometries shared by the port's tests and ``chip_smoke.py``.

They are the geometries of ``tests/test_fused_lbfgsb.py`` (K1),
``tests/test_fused_lbfgsb_tall.py`` (K2), ``tests/test_fused_driver.py``
(K3), ``tests/test_fused_newton_cg.py`` (K4), ``tests/test_fused_lbfgs.py``
(K7, K9) and ``tests/test_fused_spg.py`` (K8, K9), with the port's
objectives.  This module imports no JAX, so it also runs where only the
port is installed.
"""

import numpy as np
import torch

from optimization_solvers_tpu_torch.core import problems

INF = np.inf


def k1_geometries():
    """name -> (port objective, x0, lower, upper, data, solver options)."""
    x_mixed = np.random.RandomState(2).uniform(-0.5, 0.5, (4, 5))
    # instance 0 starts on its optimal bounds, so only +inf breakpoints
    # remain for it while the others walk finite ones
    x_mixed[0] = [1.0, -1.0, 1.0, 0.3, -0.2]
    rng = np.random.RandomState(8)
    lo_pl = np.sort(rng.uniform(-2.0, -0.5, (4, 6)), axis=0)
    hi_pl = rng.uniform(0.3, 1.8, (4, 6))
    x_pl = rng.uniform(-0.4, 0.2, (4, 6))
    return {
        "bounded_rosenbrock": (
            problems.rosenbrock(),
            np.random.RandomState(0).uniform(-2, 2, (4, 20)),
            np.full(20, -2.0), np.full(20, 2.0), (),
            dict(pgtol=1e-6, factr=10.0, max_iter=500)),
        "active_bounds": (
            problems.shifted_quadratic_2d(),
            np.random.RandomState(1).uniform(-0.5, 0.5, (4, 2)),
            np.array([-10.0, -10.0]), np.array([1.0, 1.0]), (),
            dict(pgtol=1e-8, factr=10.0, max_iter=200)),
        "infeasible_start": (
            problems.example_gd(), np.array([[-10.0, 10.0], [7.0, -3.0]]),
            np.array([2.0, 2.0]), np.array([5.0, 5.0]), (),
            dict(pgtol=1e-8, factr=10.0, max_iter=200)),
        "mixed_infinite_bounds": (
            problems.weighted_squares(), x_mixed,
            np.array([-1.0, -1, -1, -INF, -INF]),
            np.array([1.0, 1, 1, INF, INF]),
            (np.array([3.0, 10, 1, 5, 2]), np.array([4.0, -7, 9, -3, 6])),
            dict(pgtol=1e-6, factr=10.0, max_iter=300)),
        "per_lane_boxes": (
            problems.weighted_squares(), x_pl, lo_pl, hi_pl,
            (np.linspace(1.0, 20.0, 6), np.full(6, 2.0)),
            dict(pgtol=1e-8, factr=10.0, max_iter=200)),
        "unbounded_body": (
            problems.rosenbrock(),
            np.random.RandomState(5).uniform(-2, 2, (4, 16)),
            np.full(16, -INF), np.full(16, INF), (),
            dict(pgtol=1e-7, factr=10.0, max_iter=800)),
    }


def k1_edges():
    """name -> (B, n, m, box) of the CUDA kernel K1's edges: ``box`` is
    "shared" (half-width 2), "per_instance" or "none".  The edges of the
    launch (one instance, a block of 8 warps left ragged), of the lanes
    (n < 32; one and two coordinate blocks per lane, n 128 and 129; one and
    two mask words, n 1,024 and 1,025), of the small algebra (m 1 and 20;
    the Schur factor in registers at m 7, in shared memory at m 8) and of
    the bodies (per-instance boxes, no box).  ``k1_edge_arrays`` makes the
    inputs."""
    return {
        "one_instance": (1, 20, 5, "shared"),
        "ragged_block": (13, 20, 5, "shared"),
        "narrow": (5, 7, 5, "shared"),
        "m1": (9, 40, 1, "shared"),
        "m20": (9, 40, 20, "shared"),
        "m7_registers": (9, 30, 7, "shared"),
        "m8_shared_memory": (9, 30, 8, "shared"),
        "n128": (9, 128, 5, "shared"),
        "n129": (9, 129, 5, "shared"),
        "n1024": (3, 1024, 5, "shared"),
        "n1025": (3, 1025, 5, "shared"),
        "per_instance_boxes": (9, 20, 5, "per_instance"),
        "unbounded": (9, 20, 5, "none"),
    }


def k1_edge_arrays(B, n, box, seed=0):
    """x0, lower, upper and the weighted-squares data (weights
    logspace(0, 2), targets linspace(-3, 3), past the box of half-width 2,
    so bounds bind and the Cauchy walk and the subspace step run)."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-2.0, 2.0, (B, n))
    if box == "per_instance":
        lo = -rng.uniform(0.5, 2.5, (B, n))
        up = rng.uniform(0.5, 2.5, (B, n))
    else:
        half = 2.0 if box == "shared" else INF
        lo, up = np.full(n, -half), np.full(n, half)
    return x0, lo, up, np.logspace(0.0, 2.0, n), np.linspace(-3.0, 3.0, n)


def mixed_quadratic_arrays():
    """Q, lower, upper, x0 of K2's mixed-infinite-bounds geometry: a
    rotated SPD quadratic (condition 1e2) with some bounds infinite."""
    n = 16
    rng = np.random.RandomState(5)
    q, _ = np.linalg.qr(rng.randn(n, n))
    Q = (q * np.logspace(0, 2, n)) @ q.T
    lo = np.where(rng.rand(n) < 0.3, -INF, np.sort(rng.uniform(-2, 0, n)))
    hi = np.where(rng.rand(n) < 0.3, INF, np.sort(rng.uniform(0.3, 2, n)))
    return Q, lo, hi, rng.uniform(-2, 2, (8, n))


def lse_arrays(n=400, rows=64):
    """A, b of the bounded log-sum-exp (config 4 at n=10,000, rows=512):
    A = standard normal / sqrt(n) from ``RandomState(0)``, b = linspace(-1,
    1).  The JAX bench draws A from ``jax.random.PRNGKey(0)`` instead."""
    A = np.random.RandomState(0).standard_normal((rows, n)) / np.sqrt(n)
    return A, np.linspace(-1.0, 1.0, rows)


def guard_arrays():
    """Matrix, b, lower, upper, x0 (float32) of the GCP guard geometry: an
    ill-conditioned, strongly coupled, bound-active quadratic
    ``0.5 x^T A x - b^T x`` on which the bisection's path derivative
    crosses zero more than once."""
    rng = np.random.RandomState(0)
    n = 8
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T + 0.05 * np.eye(n)).astype(np.float32)
    scale = np.diag(np.exp(rng.uniform(0, 3, n))).astype(np.float32)
    A = scale @ A @ scale
    b = rng.normal(size=n).astype(np.float32) * 10
    lo = rng.uniform(-1.5, -0.1, n).astype(np.float32)
    hi = rng.uniform(0.1, 1.5, n).astype(np.float32)
    return A, b, lo, hi, rng.uniform(lo, hi, (2, n)).astype(np.float32)


def k2_geometries():
    """name -> (port objective, x0, lower, upper, data, solver options) of
    the tall kernel K2; every entry sets ``m``.  ``gcp_guard`` is float32
    data, as in the JAX test; the rest are float64."""
    Qm, lo_m, hi_m, x_m = mixed_quadratic_arrays()
    A, b = lse_arrays()
    Ag, bg, lo_g, hi_g, x_g = guard_arrays()
    rng = np.random.RandomState(11)
    lo_pl = rng.uniform(-2.0, -1.0, (4, 24))
    hi_pl = rng.uniform(0.2, 3.0, (4, 24))
    x_pl = rng.uniform(-0.5, 0.1, (4, 24))
    return {
        "bounded_rosenbrock": (
            problems.rosenbrock(),
            np.random.RandomState(0).uniform(-2, 2, (4, 20)),
            np.full(20, -2.0), np.full(20, 2.0), (),
            dict(m=5, pgtol=1e-6, factr=10.0, max_iter=500)),
        "active_bounds": (
            problems.shifted_quadratic_2d(),
            np.random.RandomState(1).uniform(-0.5, 0.5, (4, 2)),
            np.array([-10.0, -10.0]), np.array([1.0, 1.0]), (),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)),
        "infeasible_start": (
            problems.example_gd(), np.array([[-10.0, 10.0], [7.0, -3.0]]),
            np.array([2.0, 2.0]), np.array([5.0, 5.0]), (),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)),
        "mixed_infinite_bounds": (
            problems.quadratic(Qm), x_m, lo_m, hi_m, (),
            dict(m=5, pgtol=1e-7, factr=10.0, max_iter=500)),
        "lse_config4_class": (
            problems.log_sum_exp(A, b),
            np.random.RandomState(4).uniform(-0.05, 0.05, (8, 400)),
            np.full(400, -0.1), np.full(400, 0.1), (),
            dict(m=10, pgtol=1e-7, factr=10.0, max_iter=300)),
        "per_lane_boxes": (
            problems.weighted_squares(), x_pl, lo_pl, hi_pl,
            (np.linspace(1.0, 9.0, 24), np.full(24, 1.5)),
            dict(m=5, pgtol=1e-8, factr=10.0, max_iter=300)),
        "gcp_guard": (
            problems.quadratic(Ag, -bg), x_g, lo_g, hi_g, (),
            dict(m=3, pgtol=1e-6, factr=0.0, max_iter=30)),
        "max_iter_1": (
            problems.rosenbrock(),
            np.random.RandomState(2).uniform(-2, 2, (2, 8)),
            np.full(8, -2.0), np.full(8, 2.0), (),
            dict(m=5, pgtol=1e-12, factr=0.0, max_iter=1)),
    }


def k3_geometries():
    """name -> geometry of the generic driver K3's first-order slice: the
    combinations of ``tests/test_fused_driver.py`` that the slice covers,
    with the port's objectives, plus the edge cases of its status rules.

    Each entry is a dict: ``method`` and ``search`` (port configs),
    ``objective``, ``x0`` (B, n), ``lower``/``upper`` (None, (n,) or
    (B, n)), ``data``, ``max_iter``, ``max_iter_ls`` and ``chaotic``.  On a
    chaotic entry a 1e-15 relative change of x0 moves the iteration counts
    (Rosenbrock, and gradient descent under the non-monotone GLL search),
    so counts are held to the measured spread and x to ``x_atol``; the
    others are held to equal counts and x within 1e-9."""
    from optimization_solvers_tpu_torch import linesearch as ls, solvers

    n, B = 8, 16
    quad = problems.weighted_squares()
    d = np.linspace(1.0, 50.0, n)
    x0 = np.random.RandomState(0).uniform(-2, 2, (B, n))
    lo, up = np.full(n, -1.5), np.full(n, 2.5)
    interior = (d, np.full(n, 0.3))
    # a target outside the box for half the coordinates: active bounds
    pinned = (d, np.linspace(-2.5, 3.5, n))
    rng = np.random.RandomState(3)
    lo_pl = rng.uniform(-2.0, -1.0, (B, n))
    hi_pl = rng.uniform(0.1, 1.0, (B, n))
    x_pl = rng.uniform(-0.9, 0.0, (B, n))
    gd, bt = solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking()

    def entry(method, search, x, lower=None, upper=None, data=interior,
              objective=quad, max_iter=500, max_iter_ls=40, chaotic=False,
              x_atol=1e-9, f_rtol=1e-12):
        return dict(method=method, search=search, objective=objective, x0=x,
                    lower=lower, upper=upper, data=data, max_iter=max_iter,
                    max_iter_ls=max_iter_ls, chaotic=chaotic, x_atol=x_atol,
                    f_rtol=f_rtol)

    geoms = {
        "gd_bt": entry(gd, bt, x0),
        "gd_gll": entry(gd, ls.GLLQuadratic(), x0,
                        data=(np.linspace(1.0, 2.5, n), np.full(n, 0.3))),
        "cd_bt": entry(solvers.CoordinateDescent(grad_tol=1e-6), bt, x0),
        "pgd_btb": entry(solvers.ProjectedGradientDescent(grad_tol=1e-6),
                         ls.BackTrackingB(), x0, lo, up, data=pinned),
        "spg_gll_bb1": entry(solvers.SpectralProjectedGradient(grad_tol=1e-6),
                             ls.GLLQuadratic(), x0, lo, up, data=pinned),
        "spg_gll_alternate": entry(
            solvers.SpectralProjectedGradient(grad_tol=1e-6,
                                              bb_variant="alternate"),
            ls.GLLQuadratic(), x0, lo, up, data=pinned),
        "pnorm_bt": entry(
            solvers.PnormDescent(grad_tol=1e-6,
                                 inverse_p=np.diag(1.0 / d) + 1e-3),
            bt, x0),
        "gd_nosearch": entry(gd, ls.NoSearch(), x0,
                             data=(np.linspace(0.2, 1.8, n), np.full(n, 0.3))),
        "spg_gll_per_instance_boxes": entry(
            solvers.SpectralProjectedGradient(grad_tol=1e-8),
            ls.GLLQuadratic(), x_pl, lo_pl, hi_pl,
            data=(np.linspace(1.0, 12.0, n), np.full(n, 1.2))),
        # one lane converges at its 191st iteration, exactly the budget: the
        # kernel reports CONVERGED there (the lockstep driver would say
        # MAX_ITER_REACHED); the other lanes end MAX_ITER_REACHED
        "gd_bt_converge_at_budget": entry(gd, bt, x0, max_iter=191),
        # one lane starts at the minimizer (converged at once); gradient
        # steps of length 1 throw the others out of the domain (f overflows)
        "out_of_domain": entry(
            gd, ls.NoSearch(),
            np.vstack([np.ones((1, 4)),
                       np.random.RandomState(6).uniform(-2, 2, (3, 4))]),
            data=(), objective=problems.rosenbrock(), max_iter=50),
        # tests/test_fused_driver.py:410: GD + GLL on a cond-40 quadratic,
        # which a relative-clip trial update would limit-cycle on
        "gll_stiff_quadratic": entry(
            solvers.GradientDescent(grad_tol=1e-4), ls.GLLQuadratic(),
            np.random.RandomState(0).uniform(-1.4, 2.4, (64, 16)),
            data=(np.linspace(1.0, 40.0, 16), np.zeros(16)), max_iter=300,
            max_iter_ls=30, chaotic=True, x_atol=2e-4),
        "ncg_rosenbrock": entry(
            solvers.NonlinearCG(grad_tol=1e-10, variant="pr+"), bt,
            np.random.RandomState(4).uniform(0.8, 1.2, (4, 8)), data=(),
            objective=problems.rosenbrock(), max_iter=3000, chaotic=True,
            x_atol=1e-6),
    }
    for variant in ("fr", "pr+", "hs", "dy"):
        geoms[f"ncg_{variant}_bt"] = entry(
            solvers.NonlinearCG(grad_tol=1e-6, variant=variant), bt, x0)
    return geoms


def k3_qn_geometries():
    """name -> geometry of K3's quasi-Newton slice, in the form of
    :func:`k3_geometries`: every quasi-Newton, L-BFGS and Wolfe-search
    combination of ``tests/test_fused_driver.py`` (its COMBOS, the
    StrongWolfe pair, the robustness knobs, ``approx_wolfe``), with the
    port's objectives, plus per-instance boxes and an out-of-domain
    start.  Rosenbrock entries are chaotic (held to the measured
    spread); ``f_rtol`` is the entry's relative tolerance on f."""
    from optimization_solvers_tpu_torch import linesearch as ls, solvers

    n, B = 8, 16
    quad = problems.weighted_squares()
    rosen = problems.rosenbrock()
    d = np.linspace(1.0, 50.0, n)
    x0 = np.random.RandomState(0).uniform(-2, 2, (B, n))
    lo, up = np.full(n, -1.5), np.full(n, 2.5)
    interior = (d, np.full(n, 0.3))
    pinned = (d, np.linspace(-2.5, 3.5, n))
    rng = np.random.RandomState(3)
    lo_pl = rng.uniform(-2.0, -1.0, (B, n))
    hi_pl = rng.uniform(0.1, 1.0, (B, n))
    x_pl = rng.uniform(-0.9, 0.0, (B, n))
    gd = solvers.GradientDescent(grad_tol=1e-6)
    bfgs, bfgsb = solvers.BFGS(tol=1e-8), solvers.BFGSB(tol=1e-8)
    # the StrongWolfe geometries of tests/test_fused_driver.py:498
    d16 = np.linspace(1.0, 40.0, 16)
    x16 = np.random.RandomState(0).uniform(-1.4, 2.4, (B, 16))
    # Rosenbrock-8 starts; instance 0 starts at the minimizer, instance 1
    # where f overflows (out of the domain at once)
    xr = np.random.RandomState(1).uniform(-2, 2, (B, n))
    x_ood = xr.copy()
    x_ood[0] = 1.0
    x_ood[1] = 1e80

    def entry(method, search, x, lower=None, upper=None, data=interior,
              objective=quad, max_iter=500, max_iter_ls=40, chaotic=False,
              x_atol=1e-9, f_rtol=1e-12):
        return dict(method=method, search=search, objective=objective, x0=x,
                    lower=lower, upper=upper, data=data, max_iter=max_iter,
                    max_iter_ls=max_iter_ls, chaotic=chaotic, x_atol=x_atol,
                    f_rtol=f_rtol)

    return {
        "bfgs_bt": entry(bfgs, ls.BackTracking(), x0),
        "bfgs_mt": entry(bfgs, ls.MoreThuente(), x0),
        "lbfgs_hz": entry(solvers.LBFGS(tol=1e-8, m=4), ls.HagerZhang(), x0),
        "gd_hz": entry(gd, ls.HagerZhang(), x0),
        "bfgsb_hzb": entry(bfgsb, ls.HagerZhangB(), x0, lo, up),
        "gd_mt": entry(gd, ls.MoreThuente(), x0),
        "bfgsb_mtb": entry(bfgsb, ls.MoreThuenteB(), x0, lo, up),
        "dfp_bt": entry(solvers.DFP(tol=1e-8), ls.BackTracking(), x0),
        "broyden_bt": entry(solvers.Broyden(tol=1e-8), ls.BackTracking(), x0),
        "bfgsb_btb": entry(bfgsb, ls.BackTrackingB(), x0, lo, up),
        "sr1b_btb": entry(solvers.SR1B(tol=1e-8), ls.BackTrackingB(), x0, lo,
                          up),
        "dfpb_mtb": entry(solvers.DFPB(tol=1e-8), ls.MoreThuenteB(), x0, lo,
                          up),
        "broydenb_hzb": entry(solvers.BroydenB(tol=1e-8), ls.HagerZhangB(),
                              x0, lo, up),
        # a target outside the box: the raw 2-norm test cannot pass at the
        # active bounds, so the instances exit through the s/y stall (and
        # are relabelled STALLED where the projected gradient is large).
        # At tol 1e-6 the stall fires while the steps still shrink
        # steadily, and the exit iteration does not move under a 1e-15
        # relative change of x0 (at 1e-8 it waits for steps at rounding
        # level, and moves by up to 7).  The stall point is no minimizer,
        # though: such a change moves it by up to 1.4e-8 and f by 1e-9
        # relative
        "bfgsb_mtb_pinned": entry(solvers.BFGSB(tol=1e-6), ls.MoreThuenteB(),
                                  x0, lo, up, pinned, x_atol=1e-7,
                                  f_rtol=1e-8),
        "lbfgs_sw": entry(solvers.LBFGS(tol=1e-6, m=5), ls.StrongWolfe(),
                          x16, data=(d16, np.zeros(16)), max_iter=200,
                          max_iter_ls=30),
        "bfgsb_sw_bounded": entry(
            solvers.BFGSB(tol=1e-6), ls.StrongWolfe(bounded=True), x16,
            np.full(16, -1.5), np.full(16, 2.5),
            data=(d16, np.linspace(-2.0, 3.0, 16)), max_iter=300,
            max_iter_ls=30),
        "gd_sw": entry(gd, ls.StrongWolfe(), x0),
        "bfgsb_mtb_per_instance_boxes": entry(
            bfgsb, ls.MoreThuenteB(), x_pl, lo_pl, hi_pl,
            data=(np.linspace(1.0, 12.0, n), np.full(n, 1.2))),
        # tests/test_fused_driver.py:231: scale_b0 + restart_on_degeneracy
        "qn_robust_rosenbrock": entry(
            solvers.QuasiNewton(tol=1e-6, update="bfgs", scale_b0=True,
                                restart_on_degeneracy=True),
            ls.BackTracking(), xr, data=(), objective=rosen, max_iter=2000,
            chaotic=True, x_atol=1e-6),
        "qn_robust_mt_rosenbrock": entry(
            solvers.QuasiNewton(tol=1e-6, update="bfgs", scale_b0=True,
                                restart_on_degeneracy=True),
            ls.MoreThuente(), xr, data=(), objective=rosen, max_iter=2000,
            chaotic=True, x_atol=1e-6),
        # tests/test_fused_driver.py:472: the approx-Wolfe acceptance
        "lbfgs_mt_approx_wolfe": entry(
            solvers.LBFGS(tol=1e-6, m=5), ls.MoreThuente(approx_wolfe=True),
            xr, data=(), objective=rosen, max_iter=600, max_iter_ls=30,
            chaotic=True, x_atol=1e-6),
        "lbfgs_hz_out_of_domain": entry(
            solvers.LBFGS(tol=1e-6, m=5), ls.HagerZhang(), x_ood, data=(),
            objective=rosen, max_iter=600, chaotic=True, x_atol=1e-6),
    }


def config5_hessian(n):
    """Config 5's Hessian (``bench.py:687-741``): its objective ``0.5 sum d
    x^2 + 0.1 (sum x)^2 / n`` with ``d = linspace(1, 10, n)`` is
    ``quadratic(Q)`` with ``Q = diag(d) + (0.2 / n) 1 1^T``: dense, SPD."""
    return np.diag(np.linspace(1.0, 10.0, n)) + 0.2 / n


def k3_newton_geometries():
    """name -> geometry of K3's Newton form, in the form of
    :func:`k3_geometries`: Newton, ProjectedNewton and
    SpectralProjectedNewton (with and without ``precond_bb``) with every
    search family, on library objectives (so the kernel runs them too):
    weighted squares (diagonal Hessian), Rosenbrock-8 (tridiagonal, and
    indefinite at many starts, where the factor fails and the fallback
    direction is taken) and config 5's dense quadratic at n = 32.  Each
    entry adds ``jax_objective`` (``"rosenbrock"``, ``"weighted_squares"``
    or ``"quadratic"``) and ``jax_data``, the JAX objective's problem data
    (``Q`` for the quadratic, whose port objective holds it)."""
    from optimization_solvers_tpu_torch import linesearch as ls, solvers

    n, B = 8, 16
    quad = problems.weighted_squares()
    rosen = problems.rosenbrock()
    d = np.linspace(1.0, 50.0, n)
    x0 = np.random.RandomState(0).uniform(-2, 2, (B, n))
    lo, up = np.full(n, -1.5), np.full(n, 2.5)
    interior = (d, np.full(n, 0.3))
    pinned = (d, np.linspace(-2.5, 3.5, n))
    rng = np.random.RandomState(3)
    lo_pl = rng.uniform(-2.0, -1.0, (B, n))
    hi_pl = rng.uniform(0.1, 1.0, (B, n))
    x_pl = rng.uniform(-0.9, 0.0, (B, n))
    xr = np.random.RandomState(1).uniform(-2, 2, (B, n))
    # instance 0 at the minimizer, instance 1 where f overflows
    x_ood = xr.copy()
    x_ood[0] = 1.0
    x_ood[1] = 1e80
    n5 = 32
    Q5 = config5_hessian(n5)
    x5 = np.random.RandomState(5).uniform(-2, 2, (4, n5))
    newton = solvers.Newton(tol=1e-12)
    pn = solvers.ProjectedNewton(grad_tol=1e-8)
    spn = solvers.SpectralProjectedNewton(grad_tol=1e-8)
    spn_bb = solvers.SpectralProjectedNewton(grad_tol=1e-8, precond_bb=True)

    def entry(method, search, x, lower=None, upper=None, data=interior,
              objective=quad, max_iter=200, max_iter_ls=40, chaotic=False,
              x_atol=1e-9, f_rtol=1e-12, jax_data=None, trials_exact=True,
              far_rtol=1e-12):
        jax_objective = {"ROSENBROCK": "rosenbrock",
                         "WEIGHTED_SQUARES": "weighted_squares",
                         "QUADRATIC": "quadratic"}[objective.functor]
        return dict(method=method, search=search, objective=objective, x0=x,
                    lower=lower, upper=upper, data=data, max_iter=max_iter,
                    max_iter_ls=max_iter_ls, chaotic=chaotic, x_atol=x_atol,
                    f_rtol=f_rtol, jax_objective=jax_objective,
                    jax_data=data if jax_data is None else jax_data,
                    trials_exact=trials_exact, far_rtol=far_rtol)

    box5 = (np.full(n5, -2.0), np.full(n5, 2.0))
    q5 = problems.quadratic(Q5)
    return {
        "newton_bt": entry(newton, ls.BackTracking(), x0),
        "newton_nosearch": entry(newton, ls.NoSearch(), x0),
        "newton_mt": entry(newton, ls.MoreThuente(), x0),
        "newton_hz": entry(newton, ls.HagerZhang(), x0),
        "newton_sw": entry(newton, ls.StrongWolfe(), x0),
        "newton_gll": entry(newton, ls.GLLQuadratic(), x0),
        "pn_btb": entry(pn, ls.BackTrackingB(), x0, lo, up, pinned),
        "pn_mtb": entry(pn, ls.MoreThuenteB(), x0, lo, up, pinned),
        "pn_sw_bounded": entry(pn, ls.StrongWolfe(bounded=True), x0, lo, up,
                               pinned),
        # the reference BB update freezes on a Newton direction: most
        # lanes run to the budget (pallas_driver.py:948, PARITY.md)
        "spn_btb": entry(spn, ls.BackTrackingB(), x0, lo, up, pinned),
        "spn_precond_btb": entry(spn_bb, ls.BackTrackingB(), x0, lo, up,
                                 pinned),
        "spn_precond_hzb": entry(spn_bb, ls.HagerZhangB(), x0, lo, up,
                                 pinned),
        # tests/test_fused_driver.py:158: the optimum pinned at the upper
        # bound of [-1, 1]
        "pn_btb_active_bound": entry(
            pn, ls.BackTrackingB(),
            np.random.RandomState(2).uniform(-1, 1, (B, n)), np.full(n, -1.0),
            np.full(n, 1.0), (np.linspace(1.0, 5.0, n), np.full(n, 2.0)),
            max_iter=100),
        # the first step lands on the upper bounds only to the last bit
        # (x + (up - x) rounds either way), and the second iteration's
        # trials compare f values equal to rounding: its iteration counts
        # are exact, its trial counts are not (a 1e-15 relative change of
        # x0 moves them)
        "pn_btb_per_instance_boxes": entry(
            pn, ls.BackTrackingB(), x_pl, lo_pl, hi_pl,
            data=(np.linspace(1.0, 12.0, n), np.full(n, 1.2)),
            trials_exact=False),
        "newton_bt_rosenbrock": entry(newton, ls.BackTracking(), xr, data=(),
                                      objective=rosen, chaotic=True,
                                      x_atol=1e-6),
        "pn_btb_rosenbrock": entry(pn, ls.BackTrackingB(), xr,
                                   np.full(n, -2.0), np.full(n, 2.0),
                                   data=(), objective=rosen, chaotic=True,
                                   x_atol=1e-6),
        # the lanes that leave the domain reach |x| ~ 1e110 in a few
        # undamped steps, and a 1e-15 relative change of x0 moves the plain
        # version's x there by up to ~6x relative: their x is not held
        # (``far_rtol`` None), their status and iterations are
        "newton_nosearch_out_of_domain": entry(
            newton, ls.NoSearch(), x_ood, data=(), objective=rosen,
            max_iter=50, chaotic=True, x_atol=1e-6, far_rtol=None),
        # config 5's dense SPD Hessian at n = 32
        "pn_btb_config5": entry(solvers.ProjectedNewton(grad_tol=1e-10),
                                ls.BackTrackingB(), x5, *box5, data=(),
                                objective=q5, jax_data=(Q5,)),
        "spn_btb_config5": entry(spn, ls.BackTrackingB(), x5, *box5, data=(),
                                 objective=q5, max_iter=50, jax_data=(Q5,)),
        "spn_precond_btb_config5": entry(spn_bb, ls.BackTrackingB(), x5,
                                         *box5, data=(), objective=q5,
                                         jax_data=(Q5,)),
        "newton_mt_config5": entry(newton, ls.MoreThuente(), x5, data=(),
                                   objective=q5, jax_data=(Q5,)),
    }


def k4_geometries():
    """name -> geometry of the Newton-CG kernel K4: the geometries of
    ``tests/test_fused_newton_cg.py`` with the port's objectives, and a
    factr stop.  Each entry is a dict: ``objective``, ``x0`` (B, n),
    ``lower``/``upper`` ((n,)), ``data``, ``opts`` (the solver's options),
    ``jax_objective``, ``jax_data`` and ``chaotic`` (Rosenbrock: a 1e-15
    relative change of x0 moves the counts, so they are held to the
    measured spread and x to ``x_atol``)."""
    rosen = problems.rosenbrock()

    def entry(objective, x0, lower, upper, data=(), jax_objective="rosenbrock",
              jax_data=None, chaotic=False, x_atol=1e-9, **opts):
        return dict(objective=objective, x0=x0, lower=lower, upper=upper,
                    data=data, opts=opts, jax_objective=jax_objective,
                    jax_data=data if jax_data is None else jax_data,
                    chaotic=chaotic, x_atol=x_atol)

    d1 = np.random.RandomState(1).uniform(1.0, 5.0, 8)
    Q2 = np.diag([1.0, 90.0])
    return {
        "rosenbrock_interior": entry(
            rosen, np.random.RandomState(0).uniform(-2, 2, (8, 16)),
            np.full(16, -5.0), np.full(16, 5.0), chaotic=True, x_atol=1e-6,
            pgtol=1e-8, factr=0.0, max_iter=300, cg_max=40),
        "active_bounds_quadratic": entry(
            problems.weighted_squares(),
            np.random.RandomState(2).uniform(1.0, 2.0, (8, 8)),
            np.full(8, 1.0), np.full(8, 2.0), (d1, np.zeros(8)),
            jax_objective="weighted_squares", pgtol=1e-8, factr=0.0,
            max_iter=100),
        # the reference SPG geometry (spg.rs:147-205): optimum (0, 47), one
        # coordinate at its bound
        "mixed_active_set": entry(
            problems.quadratic(Q2),
            np.random.RandomState(3).uniform(0, 40, (8, 2)),
            np.array([-1.0, 47.0]), np.array([1e6, 1e6]),
            jax_objective="quadratic", jax_data=(Q2,), pgtol=1e-10,
            factr=0.0, max_iter=500),
        "rosenbrock_upper_active": entry(
            rosen, np.random.RandomState(4).uniform(-2, 0.5, (8, 12)),
            np.full(12, -2.0), np.full(12, 0.5), chaotic=True, x_atol=1e-6,
            pgtol=1e-7, factr=0.0, max_iter=300, cg_max=40),
        "rosenbrock_xla_twin": entry(
            rosen, np.random.RandomState(7).uniform(-2, 0.5, (8, 12)),
            np.full(12, -2.0), np.full(12, 0.5), chaotic=True, x_atol=1e-6,
            pgtol=1e-7, factr=0.0, max_iter=300, cg_max=40, max_iter_ls=25),
        "rosenbrock_factr_stop": entry(
            rosen, np.random.RandomState(9).uniform(-2, 2, (8, 8)),
            np.full(8, -2.0), np.full(8, 2.0), chaotic=True, x_atol=1e-6,
            pgtol=1e-12, factr=1e7, max_iter=200, cg_max=8),
    }


def tiled(x0, lo, up, rows):
    """x0 (and per-instance boxes) repeated to ``rows`` instances."""
    reps = -(-rows // x0.shape[0])
    x0 = np.tile(x0, (reps, 1))[:rows]
    if lo.ndim == 2:
        lo = np.tile(lo, (reps, 1))[:rows]
        up = np.tile(up, (reps, 1))[:rows]
    return x0, lo, up


def perturbed_starts(x0, runs=3):
    """x0 and ``runs`` copies of x0 moved by 1e-15 relative, the noise of
    copy k from ``RandomState(100 + k)``: the starts every spread of
    chaotic iteration counts is sampled on."""
    starts = [x0]
    for k in range(runs):
        noise = np.random.RandomState(100 + k).standard_normal(x0.shape)
        starts.append(x0 * (1 + 1e-15 * noise))
    return starts


def iteration_ranges(iterations_at, x0, runs=3):
    """Per instance, the least and the largest iteration count
    ``iterations_at(x)`` returns over :func:`perturbed_starts`: two int64
    arrays."""
    c = np.stack([np.asarray(iterations_at(x))
                  for x in perturbed_starts(x0, runs)]).astype(np.int64)
    return c.min(0), c.max(0)


def perturbation_spread(iterations_at, x0, runs=3):
    """Range of the iteration counts ``iterations_at(x)`` returns over x0
    and ``runs`` copies of x0 moved by 1e-15 relative
    (:func:`perturbed_starts`).

    A solve's iteration count reproduces only to within this spread: a
    summation order other than the reference's changes the iterates by
    about as much.  On Rosenbrock it reaches a dozen iterations; on the
    short geometries it is 0."""
    lo, hi = iteration_ranges(iterations_at, x0, runs)
    return int((hi - lo).max())


def x_spread(x_at, x0, runs=3):
    """The largest move of ``x_at(x)`` (a numpy array) from its value at
    x0 over the ``runs`` copies of x0 moved by 1e-15 relative
    (:func:`perturbed_starts`): a solve's own spread in x."""
    x = x_at(x0)
    return max(float(np.abs(x_at(v) - x).max())
               for v in perturbed_starts(x0, runs)[1:])


def range_distance(a, b):
    """Per instance, the gap between two ranges of counts ``a = (lo, hi)``
    and ``b``: 0 where they overlap."""
    return np.maximum(0, np.maximum(a[0] - b[1], b[0] - a[1]))


# ---- the lockstep driver and its kernels K5 and K6

def lockstep_quadratic():
    """The geometry of ``tests/test_lockstep_parity.py``: ``0.5 sum d x^2``
    with ``d = linspace(1, 40, 6)`` (the port's ``weighted_squares`` with
    ``t = 0``), the box ``[-1.5, 2.5]``, and 5 starts of mixed difficulty
    (near the optimum, mid-range, far corners), so the instances converge
    at different iterations.  Returns ``(d, x0, lower, upper)``."""
    n = 6
    rng = np.random.RandomState(3)
    x0 = np.vstack([0.01 * rng.randn(1, n), rng.uniform(-0.5, 0.5, (2, n)),
                    rng.uniform(-2, 2.5, (2, n))])
    return np.linspace(1.0, 40.0, n), x0, np.full(n, -1.5), np.full(n, 2.5)


def lockstep_combos(solvers, ls):
    """id -> ``(method, search, bounded, needs_hessian)``, built from either
    package's ``solvers`` and ``linesearch`` modules (their names and
    fields agree): every combination of ``tests/test_lockstep_parity.py``,
    then CD + GLL, Pnorm, SR1B, the bug-for-bug More-Thuente, Hager-Zhang
    (B), bounded StrongWolfe, SPN with ``precond_bb``, the fused dense
    update (K5's path) for all four rules, unbounded and bounded, and the
    ``scale_b0`` / ``restart_on_degeneracy`` variants."""
    d = np.linspace(1.0, 40.0, 6)
    combos = {
        "gd_bt": (solvers.GradientDescent(grad_tol=1e-7), ls.BackTracking()),
        "cd_gll": (solvers.CoordinateDescent(grad_tol=1e-7),
                   ls.GLLQuadratic()),
        "spg_gll": (solvers.SpectralProjectedGradient(grad_tol=1e-7),
                    ls.GLLQuadratic()),
        "pgd_btb": (solvers.ProjectedGradientDescent(grad_tol=1e-7),
                    ls.BackTrackingB()),
        "ncg_fr_bt": (solvers.NonlinearCG(grad_tol=1e-7, variant="fr"),
                      ls.BackTracking()),
        "ncg_prp_mt": (solvers.NonlinearCG(grad_tol=1e-7), ls.MoreThuente()),
        "pnorm_bt": (solvers.PnormDescent(grad_tol=1e-7,
                                          inverse_p=np.diag(2.0 / d)),
                     ls.BackTracking()),
        "bfgs_mt": (solvers.BFGS(tol=1e-8), ls.MoreThuente()),
        "bfgs_mt_quirks": (solvers.BFGS(tol=1e-8),
                           ls.MoreThuente(reference_quirks=True)),
        "dfp_bt": (solvers.DFP(tol=1e-8), ls.BackTracking()),
        "bfgsb_btb": (solvers.BFGSB(tol=1e-8), ls.BackTrackingB()),
        "bfgsb_hzb": (solvers.BFGSB(tol=1e-8), ls.HagerZhangB()),
        "bfgsb_swb": (solvers.BFGSB(tol=1e-8), ls.StrongWolfe(bounded=True)),
        "sr1b_mtb": (solvers.SR1B(tol=1e-8), ls.MoreThuenteB()),
        "bfgs_robust_mt_aw": (solvers.BFGS(tol=1e-8, scale_b0=True,
                                           restart_on_degeneracy=True),
                              ls.MoreThuente(approx_wolfe=True)),
        "newton_nosearch": (solvers.Newton(tol=1e-10), ls.NoSearch()),
        "pn_btb": (solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB()),
        "spn_btb": (solvers.SpectralProjectedNewton(grad_tol=1e-8),
                    ls.BackTrackingB()),
        "spn_precond_btb": (solvers.SpectralProjectedNewton(
            grad_tol=1e-8, precond_bb=True), ls.BackTrackingB()),
        "lbfgs_sw": (solvers.LBFGS(tol=1e-8, m=4), ls.StrongWolfe()),
        "lbfgs_hz": (solvers.LBFGS(tol=1e-8, m=4), ls.HagerZhang()),
    }
    for kind in ("bfgs", "dfp", "broyden", "sr1"):
        combos[f"{kind}_fused_mt"] = (
            solvers.QuasiNewton(tol=1e-8, update=kind, fused=True),
            ls.MoreThuente())
        combos[f"{kind}b_fused_mtb"] = (
            solvers.QuasiNewtonB(tol=1e-8, update=kind, fused=True),
            ls.MoreThuenteB())
    return {k: (m, s, isinstance(m, solvers.BoundedMethod),
                bool(m.needs_hessian)) for k, (m, s) in combos.items()}


def qn_update_arrays(b, n, seed=2, curvature=False):
    """K5's inputs (the geometry of ``tests/test_ops.py:60-78``): SPD
    ``B = A A^T + 3 I`` (b, n, n) and s, y, g (b, n) from ``RandomState
    (seed)``; instance 1's pair is scaled by 1e-12, so the degenerate-pair
    skip fires there.  With ``curvature`` y is ``C s`` for one SPD ``C =
    M M^T / n + I``, so ``s.y > 0`` as in the pairs a Wolfe search feeds
    the update; the random pairs' ``s.y`` of either sign make the
    updates cancel (``tests/_torch_lockstep_reference.py --geometry`` prints
    how far float32 then falls from float64)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(b, n, n)
    Bm = A @ np.transpose(A, (0, 2, 1)) + 3.0 * np.eye(n)
    s, y, g = (rng.randn(b, n) for _ in range(3))
    if curvature:
        M = rng.randn(n, n)
        y = s @ (M @ M.T / n + np.eye(n))
    s[1] *= 1e-12
    y[1] *= 1e-12
    return Bm, s, y, g


def spd_arrays(b, n, seed=0, shift=5.0, non_pd=None):
    """K6's inputs (the geometry of ``tests/test_ops.py:33-41``): SPD
    ``H = A A^T + shift I`` (b, n, n) and g (b, n) from ``RandomState
    (seed)``; instance ``non_pd``, if given, is negated (not positive
    definite: its first pivot is negative)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(b, n, n)
    H = A @ np.transpose(A, (0, 2, 1)) + shift * np.eye(n)
    if non_pd is not None:
        H[non_pd] = -H[non_pd]
    return H, rng.randn(b, n)


# ---- the whole-solve kernels K7 (L-BFGS), K8 (SPG + GLL), K9 (dense BFGS)

def exp_bowl_fn(x):
    """``exp_bowl`` as a plain torch callable (no analytic forms, no kernel
    form): the plain versions batch it with ``torch.func``."""
    r2 = torch.sum(x ** 2)
    return r2 + torch.exp(r2)


def diag_quadratic_fn(x, diag):
    """``0.5 sum diag x^2`` with the diagonal as problem data, a plain torch
    callable (the JAX test's consts objective)."""
    return 0.5 * torch.sum(diag * x * x)


def _whole_solve(objective, x0, data=(), jax_objective="rosenbrock",
                 jax_data=None, tile=None, lower=None, upper=None,
                 kernel=True, chaotic=False, **opts):
    """A geometry of K7-K9: ``objective`` and ``data`` for the port,
    ``jax_objective`` (a name the JAX tests map to a function) with
    ``jax_data`` and the JAX ``tile`` (B unless given), the box of K8,
    ``kernel`` the ``(objective, data)`` a CUDA call takes (the same unless
    given; ``None`` where the objective has no functor) and ``chaotic``
    (Rosenbrock: iteration counts held to the measured spread)."""
    if kernel is True:
        kernel = (objective, data)
    return dict(objective=objective, x0=x0, data=data, opts=opts,
                jax_objective=jax_objective,
                jax_data=data if jax_data is None else jax_data,
                tile=x0.shape[0] if tile is None else tile, lower=lower,
                upper=upper, kernel=kernel, chaotic=chaotic)


def _ws_data():
    return (np.linspace(1.0, 50.0, 6),
            np.random.RandomState(5).uniform(-1.0, 1.0, 6))


def k7_geometries():
    """name -> geometry of the L-BFGS kernel K7: ``tests/test_fused_lbfgs.py``
    (its ``test_fused_matches_driver_quality`` start is
    ``driver_quality``) plus weighted squares with problem data."""
    rosen = problems.rosenbrock()
    return {
        "rosenbrock_20": _whole_solve(
            rosen, np.random.RandomState(0).uniform(-2, 2, (8, 20)),
            chaotic=True, m=10, tol=1e-5, max_iter=800, max_iter_ls=20),
        "example_bfgs": _whole_solve(
            problems.example_bfgs(),
            np.random.RandomState(1).uniform(-5, 5, (16, 3)),
            jax_objective="example_bfgs", m=5, tol=1e-8, max_iter=200,
            max_iter_ls=20),
        "quadratic_2d_multi_tile": _whole_solve(
            problems.quadratic_2d(90.0),
            np.random.RandomState(2).uniform(-5, 5, (16, 2)),
            jax_objective="quadratic_2d_90", tile=8, m=5, tol=1e-8,
            max_iter=300, max_iter_ls=20),
        "driver_quality": _whole_solve(
            rosen, np.random.RandomState(3).uniform(-2, 2, (4, 12)),
            chaotic=True, m=10, tol=1e-5, max_iter=800, max_iter_ls=20),
        "weighted_squares_data": _whole_solve(
            problems.weighted_squares(),
            np.random.RandomState(4).uniform(-3, 3, (8, 6)), _ws_data(),
            jax_objective="weighted_squares", m=5, tol=1e-8, max_iter=300,
            max_iter_ls=20),
    }


def k8_geometries():
    """name -> geometry of the SPG kernel K8: ``tests/test_fused_spg.py``'s
    SPG tests (the active bound x[:, 1] = 47, ``exp_bowl`` as a plain torch
    callable, the box quadratic with its diagonal as problem data) plus
    Rosenbrock in a box over 30 iterations."""
    inf = np.inf
    d = np.random.RandomState(2).uniform(1.0, 10.0, 16)
    return {
        "active_bound": _whole_solve(
            problems.quadratic_2d(90.0),
            np.random.RandomState(0).uniform(0, 40, (8, 2)),
            jax_objective="quadratic_2d_90", lower=np.array([-1.0, 47.0]),
            upper=np.array([inf, inf]), tol=1e-10, max_iter=2000),
        "exp_bowl": _whole_solve(
            exp_bowl_fn, np.random.RandomState(1).uniform(-1, 1, (8, 2)),
            jax_objective="exp_bowl", lower=np.full(2, -1.0),
            upper=np.full(2, 1.0), kernel=None, tol=1e-8, max_iter=500),
        "box_quadratic_data": _whole_solve(
            diag_quadratic_fn,
            np.random.RandomState(3).uniform(-3, 3, (16, 16)), (d,),
            jax_objective="diag_consts", lower=np.full(16, -2.0),
            upper=np.full(16, 2.0),
            kernel=(problems.weighted_squares(), (d, np.zeros(16))),
            tol=1e-8, max_iter=1000),
        "rosenbrock_capped": _whole_solve(
            problems.rosenbrock(),
            np.random.RandomState(6).uniform(-2, 2, (8, 10)),
            lower=np.full(10, -1.5), upper=np.full(10, 1.5), tol=1e-8,
            max_iter=30),
    }


def k9_geometries():
    """name -> geometry of the dense BFGS kernel K9: the BFGS tests of
    ``tests/test_fused_spg.py`` plus weighted squares with problem data."""
    return {
        "rosenbrock_20": _whole_solve(
            problems.rosenbrock(),
            np.random.RandomState(0).uniform(-2, 2, (8, 20)), tile=4,
            chaotic=True, tol=1e-5, max_iter=800),
        "example_bfgs": _whole_solve(
            problems.example_bfgs(),
            np.random.RandomState(1).uniform(-5, 5, (8, 3)),
            jax_objective="example_bfgs", tile=4, tol=1e-8, max_iter=200),
        "weighted_squares_data": _whole_solve(
            problems.weighted_squares(),
            np.random.RandomState(4).uniform(-3, 3, (8, 6)), _ws_data(),
            jax_objective="weighted_squares", tol=1e-8, max_iter=200),
    }


# ---- the quadratic and log-sum-exp functors of K1, K3's quasi-Newton, Wolfe
# and dense forms and K9

def nonsymmetric_quadratic(n=12, seed=7):
    """Q = M M^T / n + I + 0.3 (K - K^T), b = 3 N(0, 1): the symmetric part
    is positive definite, and the minimizer has max|x*| 4.9, outside
    [-2, 2]."""
    rng = np.random.RandomState(seed)
    M, K = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    return (M @ M.T / n + np.eye(n) + 0.3 * (K - K.T),
            3.0 * rng.standard_normal(n))


def data_functor_cases():
    """name -> (functor, data arrays, box half-width, starts' half-width):
    the log-sum-exp at config 4's recipe (:func:`lse_arrays`) with 40 rows
    and n = 24 (a chunk of 32 rows and a partial one) and with 20 rows and
    n = 40 (n > rows, as in config 4), both unbounded below without their
    box, and with 40 rows and n = 16, bounded below (the unconstrained
    methods' case); config 5's quadratic at n = 16 and
    :func:`nonsymmetric_quadratic`, whose box is active at the solution."""
    return {
        "lse_rows40_n24": ("LOG_SUM_EXP", lse_arrays(24, 40), 1.0, 0.5),
        "lse_rows20_n40": ("LOG_SUM_EXP", lse_arrays(40, 20), 1.0, 0.5),
        "lse_rows40_n16": ("LOG_SUM_EXP", lse_arrays(16, 40), 1.0, 0.5),
        "quad_config5_n16": ("QUADRATIC", (config5_hessian(16), np.zeros(16)),
                             2.0, 2.0),
        "quad_nonsymmetric": ("QUADRATIC", nonsymmetric_quadratic(), 2.0,
                              2.0),
    }


def data_functor_case(name, batch=4):
    """(port objective, data, x0, lower, upper) of
    :func:`data_functor_cases`' entry ``name``, ``batch`` starts from
    ``RandomState(3)``."""
    functor, data, box, half = data_functor_cases()[name]
    n = data[0].shape[1]
    x0 = np.random.RandomState(3).uniform(-half, half, (batch, n))
    obj = (problems.log_sum_exp(*data) if functor == "LOG_SUM_EXP"
           else problems.quadratic(*data))
    return obj, data, x0, np.full(n, -box), np.full(n, box)
