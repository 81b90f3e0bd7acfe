"""A torch model of the joint-trial schedule of K3's first-order form and
K8 (``ops/csrc/lanes.cuh`` ``joint_trials``) against the serial Armijo
search the plain versions run.

BackTracking, BackTrackingB and K8's halving know their trial steps before
any value (t = 1, beta, beta^2, ..., each the last times beta): the kernels
evaluate K trials in one pass and take the first in order that passes with
a finite value.  The model does that batched, pass by pass, and must give
the serial search's accepted flag, step t (bit for bit) and trial count
for every K the kernels may take, with budgets that end inside a pass, on
values that are not finite (inf, -inf, which the Armijo test alone would
pass, and NaN), on searches that exhaust their budget (t is then the update
after the last trial, untested), and with BackTrackingB's clip into the
box (its test reads |x_t - x|^2).  The serial model is held to the plain
versions themselves: one iteration of ``fused_minimize_plain`` (GD +
BackTracking, PGD + BackTrackingB) takes its step and its count.
"""

import numpy as np
import pytest
import torch

from optimization_solvers_tpu_torch import linesearch as ls, problems, solvers
from optimization_solvers_tpu_torch.ops import fused_driver

torch.set_num_threads(1)

B, N = 64, 12
KS = (1, 2, 4, 8)
BUDGETS = (0, 1, 3, 7, 8, 9, 16, 40)


def serial(phi, accept, t0, beta, budget):
    """The plain versions' search: trials one at a time until one passes
    with a finite value or the budget is spent.  Returns (accepted, t,
    nfev, f) per instance."""
    t = t0.clone()
    done = torch.zeros_like(t, dtype=torch.bool)
    taken = torch.zeros_like(done)
    nfev = torch.zeros(t.shape, dtype=torch.int32)
    f = torch.zeros_like(t)
    for _ in range(budget):
        if bool(done.all()):
            break
        ft, dd = phi(t)
        nfev += (~done).to(torch.int32)
        ok = accept(ft, t, dd) & torch.isfinite(ft)
        hit = ~done & ok
        taken |= hit
        f = torch.where(hit, ft, f)
        t = torch.where(done | ok, t, t * beta)
        done |= ok
    return taken, t, nfev, f


def joint(phi, accept, t0, beta, budget, k):
    """lanes.cuh's joint_trials: passes of k trials (t, t beta, ..., by
    repeated multiplication), the first in order that passes with a finite
    value taken; trials past the budget are formed and ignored."""
    t = t0.clone()
    taken = torch.zeros_like(t, dtype=torch.bool)
    nfev = torch.zeros(t.shape, dtype=torch.int32)
    f = torch.zeros_like(t)
    done = 0
    while done < budget:
        kk = min(k, budget - done)
        ts = [t]
        for _ in range(1, k):
            ts.append(ts[-1] * beta)
        vals = [phi(tk) for tk in ts]
        hit = torch.full(t.shape, -1)
        for j, (ft, dd) in enumerate(vals):
            ok = accept(ft, ts[j], dd) & torch.isfinite(ft) & (j < kk)
            hit = torch.where((hit < 0) & ok, j, hit)
        live = ~taken
        for j, (ft, _) in enumerate(vals):
            sel = live & (hit == j)
            t = torch.where(sel, ts[j], t)
            f = torch.where(sel, ft, f)
        miss = live & (hit < 0)
        t = torch.where(miss, ts[kk - 1] * beta, t)
        nfev += torch.where(live, torch.where(hit >= 0, hit + 1, kk),
                            0).to(torch.int32)
        taken |= live & (hit >= 0)
        done += k
        if bool(taken.all()):
            break
    return taken, t, nfev, f


def problem(seed, clip=False):
    """x, d and phi(t) -> (f(x_t), |x_t - x|^2) for a weighted quadratic
    whose value is inf, -inf or NaN past a per-instance step, so that the
    long trials of some instances are not finite; x_t is clipped into [-1,
    1] with ``clip``."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.uniform(-1, 1, (B, N)))
    d = torch.tensor(rng.uniform(-4, 4, (B, N)))
    w = torch.tensor(rng.uniform(1, 50, N))
    wall = torch.tensor(rng.choice([np.inf, 0.3, 0.05, 1e-3], B))
    bad = torch.tensor(rng.choice([np.inf, -np.inf, np.nan], B))

    def phi(t):
        xt = x + t[:, None] * d
        if clip:
            xt = xt.clamp(-1.0, 1.0)
        ft = 0.5 * (w * xt * xt).sum(-1)
        ft = torch.where(t > wall, bad, ft)
        return ft, ((xt - x) ** 2).sum(-1)

    f0 = 0.5 * (w * x * x).sum(-1)
    g0d = (w * x * d).sum(-1)
    return phi, f0, g0d


def searches(seed):
    phi, f0, g0d = problem(seed)
    phib, f0b, _ = problem(seed, clip=True)
    c1 = 1e-4
    # BackTracking: f(x_t) - f0 <= c1 t g.d; BackTrackingB: f(x_t) - f0 <=
    # -(c1 / t) |x_t - x|^2; K8: f(x_t) <= f_max + c1 t g.d with f_max >= f0
    fmax = f0 + torch.tensor(np.random.RandomState(seed).uniform(0, 5, B))
    return {
        "bt": (phi, lambda ft, t, dd: ft - f0 <= c1 * t * g0d, 0.5),
        "bt_beta_0.3": (phi, lambda ft, t, dd: ft - f0 <= c1 * t * g0d, 0.3),
        "btb": (phib, lambda ft, t, dd: ft - f0b <= (-c1 / t) * dd, 0.5),
        "k8_halving": (phi, lambda ft, t, dd: ft <= fmax + c1 * t * g0d, 0.5),
    }


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("search", sorted(searches(0)))
def test_joint_trials_match_the_serial_search(search, k, budget):
    for seed in range(3):
        phi, accept, beta = searches(seed)[search]
        t0 = torch.ones(B, dtype=torch.float64)
        a = serial(phi, accept, t0, beta, budget)
        b = joint(phi, accept, t0, beta, budget, k)
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1], b[1])           # bit for bit
        assert torch.equal(a[2], b[2])
        assert torch.equal(a[3][a[0]], b[3][b[0]])


def test_the_cases_occur():
    """The problems above do exercise what the kernels must get right:
    non-finite trials before an accepted one, exhaustion, and BTB's clip
    moving coordinates."""
    phi, accept, beta = searches(0)["bt"]
    t0 = torch.ones(B, dtype=torch.float64)
    taken, t, nfev, _ = serial(phi, accept, t0, beta, 40)
    ft, _ = phi(t0)
    assert bool((~torch.isfinite(ft) & taken).any())
    taken3, *_ = serial(phi, accept, t0, beta, 3)
    assert bool((~taken3).any()) and bool(taken3.any())
    phib, acceptb, _ = searches(0)["btb"]
    _, dd = phib(t0)
    raw = problem(0)[0](t0)[1]
    assert bool((dd < raw).any())


@pytest.mark.parametrize("budget", [1, 5, 40])
@pytest.mark.parametrize("bounded", [False, True])
def test_serial_model_is_the_plain_search(bounded, budget):
    """One iteration of the plain version: GD + BackTracking, or PGD +
    BackTrackingB in the box [-1, 1], on weighted squares; the model's
    serial search gives its trial count and its step."""
    rng = np.random.RandomState(budget)
    n = 8
    x0 = torch.tensor(rng.uniform(-1, 1, (B, n)))
    d_, t_ = torch.tensor(np.linspace(1, 40, n)), torch.tensor(
        rng.uniform(-3, 3, n))
    obj = problems.weighted_squares()
    lo = up = None
    if bounded:
        method = solvers.ProjectedGradientDescent(grad_tol=1e-12)
        search = ls.BackTrackingB()
        lo, up = torch.full((n,), -1.0, dtype=torch.float64), torch.full(
            (n,), 1.0, dtype=torch.float64)
    else:
        method = solvers.GradientDescent(grad_tol=1e-12)
        search = ls.BackTracking()
    spec = fused_driver.build_spec(method, search)
    x1, _, _, _, nfev = fused_driver._solve_plain(
        spec, obj, x0, lo, up, (d_, t_), 1, budget)

    def f(x):
        return 0.5 * (d_ * (x - t_) ** 2).sum(-1)

    g = d_ * (x0 - t_)
    d = (x0 - g).clamp(-1, 1) - x0 if bounded else -g
    f0, g0d = f(x0), (g * d).sum(-1)

    def phi(t):
        xt = x0 + t[:, None] * d
        if bounded:
            xt = xt.clamp(-1.0, 1.0)
        return f(xt), ((xt - x0) ** 2).sum(-1)

    if bounded:
        def accept(ft, t, dd):
            return ft - f0 <= (-spec.c1 / t) * dd
    else:
        def accept(ft, t, dd):
            return ft - f0 <= spec.c1 * t * g0d
    _, t, nf, _ = serial(phi, accept, torch.ones(B, dtype=torch.float64),
                         spec.beta, budget)
    assert torch.equal(nf, nfev)
    step = x0 + t[:, None] * d
    if bounded:
        step = step.clamp(-1.0, 1.0)
    assert torch.equal(step, x1)
