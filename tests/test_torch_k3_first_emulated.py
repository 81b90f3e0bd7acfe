"""K3's first-order form on the CPU: its own source (``ops/csrc/driver.cu``
on ``driver_first.cuh`` and ``lanes.cuh``: GD, CD, Pnorm, PGD, SPG and NCG
with NoSearch, BackTracking, BackTrackingB and GLL, one warp per instance)
built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``) and held against the plain version
``fused_minimize_plain`` in float64: status, iterations and trials
(``nfev``) equal, x within 1e-10.  Each case runs twice, the warps of a
block taking turns lowest first and then highest first, and must give the
same bits both times.

Each of the form's layouts: as built (every vector in registers, two
coordinates a lane up to n = 64 and four up to 128; wider instances in the
warp's shared memory) and with ``-DK3_REG_N=0`` (every instance in shared
memory).  The cases: every entry of ``k3_geometries()`` in both builds
(its first rows, at most ITERS iterations: the chaotic entries stay
within 1e-10 of the plain version that long; n <= 16, two coordinates a
lane as built); every method with a main search at n = 64, 100 and
160 as built (two coordinates a lane, four, shared memory), SPG under
both BB policies and with BackTrackingB; and GD + BackTracking whose trials overflow (f
non-finite at long steps) or whose budget runs out before any trial
passes.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import k3_geometries
from optimization_solvers_tpu_torch import linesearch as ls, problems, solvers
from optimization_solvers_tpu_torch.ops import fused_driver

ROWS, ITERS, SEEDS, X_ATOL = 4, 40, (1, 2), 1e-10
LAYOUTS = {"as_built": (), "shared": ("-DK3_REG_N=0",)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k3(tmp_path_factory):
    return {name: emulator.build_k3(
        str(tmp_path_factory.mktemp(f"k3_first_{name}")), flags)
        for name, flags in LAYOUTS.items()}


def tensors(*arrays):
    return tuple(None if a is None else torch.as_tensor(
        np.asarray(a, np.float64)) for a in arrays)


def held(lib, method, search, obj, x0, lo, up, data, kw):
    spec = fused_driver.build_spec(method, search)
    assert spec.method < fused_driver.QN and spec.search <= fused_driver.GLL
    runs = [emulator.driver_solve(lib, method, search, obj, x0, lo, up, data,
                                  seed=seed, **kw) for seed in SEEDS]
    for a, b in zip(*runs):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])
    x, _, it, st, nfev = runs[0]
    xp, _, itp, stp, nfevp = fused_driver._solve_plain(
        spec, obj, x0, lo, up, data, kw["max_iter"], kw["max_iter_ls"])
    assert torch.equal(st, stp)
    assert torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=0, atol=X_ATOL, equal_nan=True)
    return it, st, nfev


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(k3_geometries()))
def test_emulated_first_order_form_matches_plain(name, layout, k3):
    g = k3_geometries()[name]
    lo, up = g["lower"], g["upper"]
    if lo is not None and np.ndim(lo) == 2:
        lo, up = lo[:ROWS], up[:ROWS]
    x0, lo, up = tensors(g["x0"][:ROWS], lo, up)
    held(k3[layout], g["method"], g["search"], g["objective"], x0, lo, up,
         tensors(*g["data"]),
         dict(max_iter=min(g["max_iter"], ITERS),
              max_iter_ls=g["max_iter_ls"]))


def _main_path_cases():
    gd, bt = solvers.GradientDescent(grad_tol=1e-6), ls.BackTracking()
    return {
        # config 6: GD + BackTracking on the diagonal quadratic
        "gd_bt": (gd, bt, None),
        "pnorm_bt": ("pnorm", bt, None),
        # config 3: SPG + GLL in the box, both BB policies
        "spg_gll_alternate": (solvers.SpectralProjectedGradient(
            grad_tol=1e-6, bb_variant="alternate"), ls.GLLQuadratic(), 2.0),
        "spg_gll_bb1": (solvers.SpectralProjectedGradient(grad_tol=1e-6),
                        ls.GLLQuadratic(), 2.0),
        "pgd_btb": (solvers.ProjectedGradientDescent(grad_tol=1e-6),
                    ls.BackTrackingB(), 1.0),
        "spg_btb": (solvers.SpectralProjectedGradient(grad_tol=1e-6),
                    ls.BackTrackingB(), 1.0),
        "ncg_bt": (solvers.NonlinearCG(grad_tol=1e-6, variant="pr+"), bt,
                   None),
        "cd_bt": (solvers.CoordinateDescent(grad_tol=1e-6), bt, None),
    }


@pytest.mark.parametrize("n", [64, 100, 160])
@pytest.mark.parametrize("case", sorted(_main_path_cases()))
def test_emulated_first_order_form_at_width(case, n, k3):
    """Every method at config 3's and config 6's widths (as built: two
    coordinates a lane at 64, four at 100, ending inside a lane) and past
    them (160: the shared layout), on the weighted squares with d =
    logspace(0, 3), ITERS iterations.  (GD + GLL on this stiff quadratic
    is chaotic, as ``k3_geometries``' ``gll_stiff_quadratic`` is: its
    counts hold, x drifts past 1e-10.)"""
    method, search, box = _main_path_cases()[case]
    rng = np.random.RandomState(n)
    x0 = rng.uniform(-2.0, 2.0, (2, n))
    data = (np.logspace(0, 3, n), rng.uniform(-1.0, 1.0, n))
    if method == "pnorm":
        method = solvers.PnormDescent(
            grad_tol=1e-6, inverse_p=np.diag(1.0 / data[0]) + 1e-3)
    lo = up = None
    if box is not None:
        lo, up = np.full(n, -box), np.full(n, box)
    held(k3["as_built"], method, search, problems.weighted_squares(),
         *tensors(x0, lo, up), tensors(*data),
         dict(max_iter=ITERS, max_iter_ls=40))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_emulated_joint_trials_overflow_and_exhaust(layout, k3):
    """GD + BackTracking(beta = 0.5) on Rosenbrock-10, one start in
    [-3, 3] and three near 1e25, whose trials' values overflow (inf and
    NaN: rejected).  With a budget of 3 trials every iteration ends with t
    untested (the step is evaluated, nfev counts the 3) and every instance
    leaves the domain; with 11 (a pass of 8, then 3) the start in [-3, 3]
    runs its 12 iterations."""
    rng = np.random.RandomState(7)
    x0 = rng.uniform(1e25, 3e25, (4, 10)) * rng.choice([-1.0, 1.0], (4, 10))
    x0[0] = rng.uniform(-3.0, 3.0, 10)
    for budget, status in ((3, [3, 3, 3, 3]), (11, [2, 3, 3, 3])):
        it, st, nfev = held(
            k3[layout], solvers.GradientDescent(grad_tol=1e-6),
            ls.BackTracking(), problems.rosenbrock(), *tensors(x0, None, None),
            (), dict(max_iter=12, max_iter_ls=budget))
        assert st.tolist() == status
        assert bool((nfev == budget * it).all()) == (budget == 3)


def test_emulated_tie_taken_the_other_way(k3):
    """SPG + BackTrackingB on the weighted squares at n = 64 (d =
    linspace(1, 10), t = linspace(-1, 1), box [-0.5, 0.5]; the fourth
    start of RandomState(64)): at its 13th iteration BackTrackingB's test
    compares f(x_t) - f(x) with -c1 |x_t - x|^2 = -1.4e-17 where f ~ 7.9.
    The plain version's torch.sum loses the one term that changed and
    rejects t = 1; the kernel's lanes keep it and accept.  The plain
    version's ``ties`` marks that decision (12 iterations before it), and
    the two agree step for step up to there."""
    n = 64
    x0 = np.random.RandomState(n).uniform(-2.0, 2.0, (4, n))
    x0, lo, up = tensors(x0, np.full(n, -0.5), np.full(n, 0.5))
    data = tensors(np.linspace(1.0, 10.0, n), np.linspace(-1.0, 1.0, n))
    method = solvers.SpectralProjectedGradient(grad_tol=1e-6)
    obj = problems.weighted_squares()

    def runs(iters, ties=None):
        kernel = emulator.driver_solve(
            k3["as_built"], method, ls.BackTrackingB(), obj, x0, lo, up,
            data, max_iter=iters, max_iter_ls=40)
        plain = fused_driver.fused_minimize_plain(
            method, ls.BackTrackingB(), obj, x0, lo, up, data,
            max_iter=iters, max_iter_ls=40, ties=ties)
        return kernel, plain

    ties = torch.full((4,), -1, dtype=torch.int32)
    (x, _, it, st, nfev), (xp, _, itp, stp, nfevp) = runs(40, ties)
    assert ties[3].item() == 12
    assert (it[3].item(), nfev[3].item()) != (itp[3].item(), nfevp[3].item())
    assert torch.equal(st, stp)
    free = ties < 0
    assert torch.equal(nfev[free], nfevp[free])
    torch.testing.assert_close(x[free], xp[free], rtol=0, atol=X_ATOL)
    for k in sorted(set(ties[~free].tolist())):
        rows = ties == k
        (xk, _, itk, _, nfk), (xq, _, itq, _, nfq) = runs(k)
        assert torch.equal(itk[rows], itq[rows])
        assert torch.equal(nfk[rows], nfq[rows])
        assert torch.equal(xk[rows], xq[rows])
