"""L-BFGS-B geometries shared by the port's tests and ``chip_smoke.py``.

They are the geometries of ``tests/test_fused_lbfgsb.py``, with the port's
objectives.  This module imports no JAX, so it also runs where only the
port is installed.
"""

import numpy as np

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


def tiled(x0, lo, up, rows):
    """x0 (and per-instance boxes) repeated to ``rows`` instances."""
    reps = -(-rows // x0.shape[0])
    x0 = np.tile(x0, (reps, 1))[:rows]
    if lo.ndim == 2:
        lo = np.tile(lo, (reps, 1))[:rows]
        up = np.tile(up, (reps, 1))[:rows]
    return x0, lo, up


def perturbation_spread(iterations_at, x0, runs=3):
    """Range of the iteration counts ``iterations_at(x)`` returns over x0
    and ``runs`` copies of x0 moved by 1e-15 relative (seeded).

    A solve's iteration count reproduces only to within this spread: a
    summation order other than the reference's changes the iterates by
    about as much.  On Rosenbrock it reaches a dozen iterations; on the
    short geometries it is 0."""
    counts = [np.asarray(iterations_at(x0))]
    for k in range(runs):
        noise = np.random.RandomState(100 + k).standard_normal(x0.shape)
        counts.append(np.asarray(iterations_at(x0 * (1 + 1e-15 * noise))))
    c = np.stack(counts).astype(np.int64)
    return int((c.max(0) - c.min(0)).max())
