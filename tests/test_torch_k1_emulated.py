"""The CUDA kernel K1's own source on the CPU: ``ops/csrc/lbfgsb_fused.cu``
built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``: 32 threads a warp, every collective a
barrier) and held against the plain version in float64, with the
tolerances of the card's tests (``test_torch_cuda.py``): status equal, x
within 1e-6, iteration counts within max(2, spread), ``spread`` the plain
version's own range under a 1e-15 relative change of x0.  The emulator
runs the kernel's order of operations, so these tests see its indexing,
its lane layout and its control flow; the card's timing, memory model and
fused multiply-adds they do not.
"""

import numpy as np
import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import (k1_edge_arrays, k1_edges, k1_geometries,
                               perturbation_spread, tiled)
from optimization_solvers_tpu_torch import problems
from optimization_solvers_tpu_torch.ops import fused_lbfgsb

ROWS = 4
# the edges run here with at most 3 instances (an emulated warp takes 64
# lane switches a collective), the ragged block with one block of 8 warps
# and one more; the widest (n 1,024 and more) are left to the card's tests
EDGES = [name for name, (B, n, m, box) in sorted(k1_edges().items())
         if n < 1024]
EDGE_B = {"ragged_block": 9}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version's small ops on one thread: the thread pools of
    several test workers would otherwise spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k1(tmp_path_factory):
    return emulator.build(str(tmp_path_factory.mktemp("k1_emulated")))


def tensors(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in arrays)


def held(k1, obj, x0, lo, up, data, kw, diag=None, seed=1):
    """The emulated kernel against the plain version; with ``diag``, the
    scaled form (``Scaled<Obj>``) against the plain version on
    ``ScaledObjective``, x0 and the box taken to z = sqrt(diag) x."""
    plain_obj, plain_data, scale = obj, tensors(*data), None
    if diag is not None:
        (scale,) = tensors(np.sqrt(diag))
        plain_obj = fused_lbfgsb.ScaledObjective(obj, tensors(*data), scale)
        plain_data = ()
        x0, lo, up = (np.asarray(v) * np.sqrt(diag) for v in (x0, lo, up))
    x, _, it, st = emulator.solve(k1, obj, *tensors(x0, lo, up),
                                  tensors(*data), scale=scale, seed=seed,
                                  **kw)

    def plain(v):
        return fused_lbfgsb.lbfgsb_solve_plain(
            plain_obj, *tensors(v, lo, up), plain_data, **kw)

    xp, _, itp, stp = plain(x0)
    spread = perturbation_spread(lambda v: plain(v)[2].numpy(), x0)
    assert torch.equal(st, stp)
    assert (x - xp).abs().max().item() <= 1e-6
    dit = (it.long() - itp.long()).abs().max().item()
    assert dit <= max(2, spread), (dit, spread)


@pytest.mark.parametrize("name", sorted(k1_geometries()))
def test_emulated_kernel_matches_plain(name, k1):
    obj, x0, lo, up, data, opts = k1_geometries()[name]
    x0, lo, up = tiled(x0, lo, up, ROWS)
    held(k1, obj, x0, lo, up, data, dict(m=5, **opts))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(k1_geometries()))
def test_emulated_scaled_kernel_matches_plain(name, seed, k1):
    """The ``Scaled<Rosenbrock>`` and ``Scaled<WeightedSquares>`` instances,
    bounded and unbounded, with the block's warps taking turns lowest
    first (seed 1) and highest first (seed 2)."""
    obj, x0, lo, up, data, opts = k1_geometries()[name]
    x0, lo, up = tiled(x0, lo, up, ROWS)
    diag = np.random.RandomState(11).uniform(0.25, 4.0, x0.shape[-1])
    held(k1, obj, x0, lo, up, data, dict(m=5, **opts), diag=diag, seed=seed)


def test_emulated_scaled_unit_diag_is_unscaled_bit_for_bit(k1):
    for name in ("bounded_rosenbrock", "per_lane_boxes", "unbounded_body"):
        obj, x0, lo, up, data, opts = k1_geometries()[name]
        args = (*tensors(x0, lo, up), tensors(*data))
        one = torch.ones(x0.shape[-1], dtype=torch.float64)
        a = emulator.solve(k1, obj, *args, scale=one, m=5, **opts)
        b = emulator.solve(k1, obj, *args, m=5, **opts)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("name", EDGES)
def test_emulated_kernel_edges_match_plain(name, k1):
    B, n, m, box = k1_edges()[name]
    x0, lo, up, d, t = k1_edge_arrays(EDGE_B.get(name, min(B, 3)), n, box)
    held(k1, problems.weighted_squares(), x0, lo, up, (d, t),
         dict(m=m, pgtol=1e-8, factr=10.0, max_iter=300))


def test_emulated_headline_shape_first_iterations(k1):
    """Ten iterations at the headline's width in float64, where a 1e-15
    change of x0 moves no instance: status, counts and x agree."""
    x0 = np.random.RandomState(42).uniform(-2, 2, (8, 100))
    lo = np.full(100, -5.0)
    held(k1, problems.rosenbrock(), x0, lo, -lo, (),
         dict(m=5, pgtol=1e-3, factr=100.0, max_iter=10))


def test_shared_memory_mirror_matches_the_kernel(k1):
    """The route's fit (``smem_per_instance``) is the kernel's own
    ``work_bytes``, built from the same source here as on the card, with a
    log-sum-exp's z of ``rows`` elements (0 for the other objectives)."""
    for n in (1, 31, 100, 1024, 1025, 3849, 3850):
        for m in (1, 5, 20):
            for itemsize in (4, 8):
                for rows in (0, 40, 512):
                    assert fused_lbfgsb.smem_per_instance(
                        n, m, itemsize, rows) == (
                            k1.lbfgsb_fused_smem_per_warp(n, m, itemsize,
                                                          rows))
