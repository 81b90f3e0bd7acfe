"""The port's CUDA kernels against their plain PyTorch versions, and the
route between them, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one.  The file imports no JAX, so it runs where only the port
is installed; without the repository's JAX conftest and the xdist default:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances (float64): status equal per instance, x within 1e-6, iteration
counts within ``max(2, spread)`` with ``spread`` the plain version's own
range under a 1e-15 relative change of x0 (see ``_torch_geometries``; K1's
edges, ``k1_edges``, in float32 by converged fraction within 0.01); on
the tall kernel's quadratic and log-sum-exp geometries iteration counts
equal and f within 1e-10 relative.  The tall kernel's tile (several
instances per block, in lockstep) is held at its edges with the same
float64 tolerances (a ragged last tile, B = 1, instances that finish far
apart, per-instance boxes, each functor, both searches), and in float32
bit for bit against the same batch at tile 1, and at one group of threads
per block against four.  The driver kernel K3 is held to the
tolerances of its geometries (``k3_geometries``): counts within the
plain version's spread (0 on all but the chaotic entries), x within the
entry's ``x_atol`` (1e-9 on all but the chaotic entries).  The whole-solve
kernels K7-K9 (``k7_geometries`` .. ``k9_geometries``): status and counts
equal and x within 1e-10; on the chaotic Rosenbrock entries x within 1e-5
over the full solve and, per instance, the kernel's range of counts over
x0 and three starts moved by 1e-15 relative within 2 of the plain
version's range over the same starts (``perturbed_starts``), and status,
counts and x within 1e-10 over the first 20 iterations.
"""

import math
import os

import numpy as np
import pytest
import torch

from _torch_geometries import (config5_hessian, data_functor_case,
                               k1_edge_arrays, k1_edges,
                               k1_geometries, k2_geometries,
                               k3_geometries, k3_newton_geometries,
                               k3_qn_geometries, k4_geometries, k7_geometries,
                               k8_geometries, k9_geometries,
                               iteration_ranges, lse_arrays,
                               perturbation_spread, qn_update_arrays,
                               range_distance, spd_arrays, tiled,
                               x_spread)
from optimization_solvers_tpu_torch import (interop, linesearch as ls,
                                            minimize, problems, solvers)
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.ops import (_build, fused_bfgs,
                                                fused_driver, fused_lbfgs,
                                                fused_lbfgsb,
                                                fused_lbfgsb_tall,
                                                fused_newton,
                                                fused_newton_cg, fused_qn,
                                                fused_spg, linalg)

pytestmark = pytest.mark.cuda

ROWS = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(k1_geometries()))
def test_kernel_matches_plain(name, cuda):
    obj, x0, lo, up, data, opts = k1_geometries()[name]
    x0, lo, up = tiled(x0, lo, up, ROWS)
    lo_t, up_t, *data_t = interop.tensors_from_numpy(lo, up, *data,
                                                     device=cuda)

    def plain(x):
        (xt,) = interop.tensors_from_numpy(x, device=cuda)
        return fused_lbfgsb.lbfgsb_solve_plain(obj, xt, lo_t, up_t,
                                               tuple(data_t), m=5, **opts)

    (x0_t,) = interop.tensors_from_numpy(x0, device=cuda)
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    r = fused_lbfgsb.lbfgsb_solve_fused(obj, x0_t, lo_t, up_t, tuple(data_t),
                                        m=5, **opts)
    torch.cuda.synchronize()
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before + 1
    x, _, it, st = plain(x0)
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(), x0)
    assert torch.equal(r.status, st)
    assert (r.x - x).abs().max().item() <= 1e-6
    dit = (r.iterations.long() - it.long()).abs().max().item()
    assert dit <= max(2, spread), (dit, spread)
    assert r.x.device.type == "cuda"


def test_headline_shape_float64_matches_plain(cuda):
    """Ten iterations of the headline problem in float64, where a 1e-15
    change of x0 moves no instance: kernel and plain agree per instance."""
    f = problems.rosenbrock()
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (1024, 100)),
                      device=cuda)
    lo = torch.full((100,), -5.0, dtype=torch.float64, device=cuda)
    kw = dict(m=5, pgtol=1e-3, factr=100.0, max_iter=10)
    r = fused_lbfgsb.lbfgsb_solve_fused(f, x0, lo, -lo, **kw)
    x, _, it, st = fused_lbfgsb.lbfgsb_solve_plain(f, x0, lo, -lo, **kw)
    assert torch.equal(r.status, st) and torch.equal(r.iterations, it)
    assert (r.x - x).abs().max().item() <= 1e-6


def test_headline_float32_quality(cuda):
    f = problems.rosenbrock()
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (1024, 100)),
                      dtype=torch.float32, device=cuda)
    r = minimize(f, x0, method="lbfgsb", bounds=(-5.0, 5.0), tol=1e-3,
                 factr=100.0, max_iter=600)
    assert (r.status == 1).float().mean().item() >= 0.99
    assert r.f.median().item() <= 1e-4
    assert bool(torch.isfinite(r.x).all())


def test_route_launches_the_kernel(cuda):
    """A CUDA x0 runs the kernel, and an objective without a kernel form
    takes the lockstep solver on the card, with no launch of K1."""
    x0 = torch.zeros((8, 12), dtype=torch.float64, device=cuda)
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    r = minimize(problems.rosenbrock(), x0, method="lbfgsb",
                 bounds=(-1.5, 1.5), tol=1e-7, factr=10.0)
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before + 1
    assert r.x.device.type == "cuda" and (r.status == 1).all()
    r = minimize(lambda x: ((x - 0.5) ** 2).sum(), x0, method="lbfgsb",
                 bounds=(-1.0, 1.0))
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before + 1
    assert r.x.device.type == "cuda" and (r.status == 1).all()
    torch.testing.assert_close(r.x, torch.full_like(x0, 0.5), rtol=0,
                               atol=1e-6)


def test_refuses_what_does_not_fit(cuda):
    x0 = torch.zeros((2, 4000), device=cuda)
    lo = torch.full((4000,), -1.0, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_lbfgsb.lbfgsb_solve_fused(problems.rosenbrock(), x0, lo, -lo,
                                        m=20)
    with pytest.raises(ValueError, match="m must lie"):
        fused_lbfgsb.lbfgsb_solve_fused(problems.rosenbrock(), x0[:, :4],
                                        lo[:4], -lo[:4], m=21)
    with pytest.raises(ValueError, match="lies on"):
        fused_lbfgsb.lbfgsb_solve_fused(problems.rosenbrock(), x0[:, :4],
                                        lo[:4].cpu(), -lo[:4])


# ---- K1's edges ---------------------------------------------------------------

def k1_against_plain(x0, lo, up, data, obj, kw, dtype):
    """K1 against its plain version on the card: in float64 status equal,
    x within 1e-6 and iterations within max(2, spread) (the plain version's
    own spread under a 1e-15 change of x0), as test_kernel_matches_plain;
    in float32 the converged fractions within 0.01, as phase 3 of
    chip_smoke.py holds them."""
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    r = fused_lbfgsb.lbfgsb_solve_fused(obj, x0, lo, up, data, **kw)
    torch.cuda.synchronize()
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before + 1
    x, _, it, st = fused_lbfgsb.lbfgsb_solve_plain(obj, x0, lo, up, data, **kw)
    assert bool(torch.isfinite(r.x).all())
    if dtype == torch.float32:
        ck, cp = ((v == 1).float().mean().item() for v in (r.status, st))
        assert abs(ck - cp) <= 0.01, (ck, cp)
        return
    spread = perturbation_spread(
        lambda v: fused_lbfgsb.lbfgsb_solve_plain(
            obj, torch.tensor(v, device=x0.device), lo, up, data, **kw)[2]
        .cpu().numpy(), x0.cpu().numpy())
    assert torch.equal(r.status, st)
    assert (r.x - x).abs().max().item() <= 1e-6
    dit = (r.iterations.long() - it.long()).abs().max().item()
    assert dit <= max(2, spread), (dit, spread)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(k1_edges()))
def test_kernel_edges_match_plain(name, dtype, cuda):
    B, n, m, box = k1_edges()[name]
    x0, lo, up, d, t = interop.tensors_from_numpy(
        *k1_edge_arrays(B, n, box), device=cuda, dtype=dtype)
    pgtol = 1e-8 if dtype == torch.float64 else 1e-3
    k1_against_plain(x0, lo, up, (d, t), problems.weighted_squares(),
                     dict(m=m, pgtol=pgtol, factr=10.0, max_iter=300), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_widest_fit_matches_plain(dtype, cuda):
    """The largest n that fits a block at m 5 (Python's mirror of the
    kernel's shared memory decides it), on Rosenbrock over 3 iterations."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    n = 1
    while fused_lbfgsb.fits(n + 1, 5, itemsize):
        n += 1
    x0, lo, up, *_ = interop.tensors_from_numpy(
        *k1_edge_arrays(2, n, "shared"), device=cuda, dtype=dtype)
    k1_against_plain(x0, lo, up, (), problems.rosenbrock(),
                     dict(m=5, pgtol=1e-8, factr=10.0, max_iter=3), dtype)
    info = fused_lbfgsb.kernel_info(dtype, 2, n, 5)
    assert info["warps_per_block"] == 1 and info["blocks_per_sm"] >= 1


def test_kernel_launch_keeps_warps_resident(cuda):
    """The headline's launch: blocks of 8 warps, at least 16 resident warps
    per SM."""
    info = fused_lbfgsb.kernel_info(torch.float32, 10_240, 100, 5)
    assert info["warps_per_block"] == 8 and info["warps_per_sm"] >= 16
    assert info["smem_per_block"] == 8 * fused_lbfgsb.smem_per_instance(
        100, 5, 4)


# ---- K1's scaled form and the lockstep L-BFGS-B ------------------------------

@pytest.mark.parametrize("name", sorted(k1_geometries()))
def test_scaled_kernel_matches_plain(name, cuda):
    """The ``Scaled<Obj>`` kernels against the plain version on
    ``ScaledObjective``, K1's tolerances.  Rosenbrock under the random
    scale is chaotic (on the CPU a 1e-15 change of x0 moves the plain
    version's counts by up to ~100 and x by ~5e-7): there the full solve is
    held by status and each side's distance to x* = 1 (2e-6), and per
    instance over its first 25 iterations (counts equal, x within 1e-9)."""
    obj, x0, lo, up, data, opts = k1_geometries()[name]
    x0, lo, up = tiled(x0, lo, up, ROWS)
    diag = np.random.RandomState(11).uniform(0.25, 4.0, x0.shape[-1])
    lo_t, up_t, d_t, *data_t = interop.tensors_from_numpy(
        lo, up, diag, *data, device=cuda)
    s = torch.sqrt(d_t)
    scaled = fused_lbfgsb.ScaledObjective(obj, tuple(data_t), s)

    def plain(x, **kw):
        (xt,) = interop.tensors_from_numpy(x, device=cuda)
        return fused_lbfgsb.lbfgsb_solve_plain(scaled, xt * s, lo_t * s,
                                               up_t * s, (), m=5,
                                               **dict(opts, **kw))

    def kernel(**kw):
        return fused_lbfgsb.lbfgsb_solve_fused_scaled(
            obj, x0_t, lo_t, up_t, d_t, tuple(data_t), m=5,
            **dict(opts, **kw))

    (x0_t,) = interop.tensors_from_numpy(x0, device=cuda)
    before = (fused_lbfgsb.lbfgsb_solve_fused.launches,
              fused_lbfgsb.lbfgsb_solve_fused_scaled.launches)
    r = kernel()
    torch.cuda.synchronize()
    assert (fused_lbfgsb.lbfgsb_solve_fused.launches,
            fused_lbfgsb.lbfgsb_solve_fused_scaled.launches) == (
                before[0], before[1] + 1)
    z, _, it, st = plain(x0)
    assert torch.equal(r.status, st)
    if "rosenbrock" in name or name == "unbounded_body":
        assert (r.x - 1.0).abs().max().item() <= 2e-6
        assert (z / s - 1.0).abs().max().item() <= 2e-6
        r = kernel(max_iter=25)
        z, _, it, st = plain(x0, max_iter=25)
        assert torch.equal(r.status, st) and torch.equal(r.iterations, it)
        assert (r.x - z / s).abs().max().item() <= 1e-9
        return
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(), x0)
    assert (r.x - z / s).abs().max().item() <= 1e-6
    dit = (r.iterations.long() - it.long()).abs().max().item()
    assert dit <= max(2, spread), (dit, spread)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_scaled_kernel_unit_diag_is_unscaled_bit_for_bit(dtype, cuda):
    f = problems.rosenbrock()
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (256, 100)),
                      dtype=dtype, device=cuda)
    lo = torch.full((100,), -5.0, dtype=dtype, device=cuda)
    kw = dict(m=5, pgtol=1e-3, factr=100.0, max_iter=600)
    a = fused_lbfgsb.lbfgsb_solve_fused_scaled(f, x0, lo, -lo,
                                               torch.ones_like(lo), **kw)
    b = fused_lbfgsb.lbfgsb_solve_fused(f, x0, lo, -lo, **kw)
    for u, v in zip(a[:5], b[:5]):
        assert torch.equal(u, v)
    info = fused_lbfgsb.kernel_info(dtype, 256, 100, 5, scaled=True)
    assert info["warps_per_block"] == 8 and info["registers"] > 0


def test_lockstep_lbfgsb_on_the_card_matches_the_cpu(cuda):
    """The lockstep solver runs on x0's device: a 1-D float64 x0 of the
    active-bounds quadratic, and a batch with a raw callable, on the card
    as on the CPU, with no kernel launch."""
    n = 100
    d = torch.linspace(1.0, 10.0, n, dtype=torch.float64)

    def f(x):
        return torch.sum(d.to(x.device) * (x - 2.0) ** 2)

    x0 = torch.zeros(n, dtype=torch.float64)
    kw = dict(bounds=(-1.0, 1.0), tol=1e-10, factr=10.0)
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    on_card = minimize(f, x0.to(cuda), method="lbfgsb", **kw)
    on_cpu = minimize(f, x0, method="lbfgsb", **kw)
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before
    assert on_card.x.device.type == "cuda"
    assert int(on_card.status) == int(on_cpu.status) == 1
    assert (on_card.x.cpu() - on_cpu.x).abs().max().item() <= 1e-8


# ---- the tall kernel K2 and the route by fit ---------------------------------

@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
@pytest.mark.parametrize("name", ["lse_config4_class", "mixed_infinite_bounds"])
def test_tall_kernel_matches_plain(name, line_search, cuda):
    obj, x0, lo, up, data, opts = k2_geometries()[name]
    x0, lo, up = tiled(x0, lo, up, ROWS)
    x0_t, lo_t, up_t, *data_t = interop.tensors_from_numpy(
        x0, lo, up, *data, device=cuda)
    kw = dict(opts, line_search=line_search)
    before = fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches
    r = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(obj, x0_t, lo_t, up_t,
                                                  tuple(data_t), **kw)
    torch.cuda.synchronize()
    assert fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches == before + 1
    x, f, it, st, flag = fused_lbfgsb_tall.lbfgsb_solve_tall_plain(
        obj, x0_t, lo_t, up_t, tuple(data_t), **kw)
    assert torch.equal(r.status, st) and torch.equal(r.iterations, it)
    assert (r.status == 1).all()
    assert (r.x - x).abs().max().item() <= 1e-6
    torch.testing.assert_close(r.f, f, rtol=1e-10, atol=1e-10)
    assert r.gcp_multimodal.shape == flag.shape
    assert r.x.device.type == "cuda"


# K2 runs a tile of instances per block; each functor, with per-instance
# boxes (per_lane_boxes) and both searches, at a batch of 7 in tiles of 3
# (the last tile ragged)
TILE_EDGES = ["bounded_rosenbrock", "per_lane_boxes", "mixed_infinite_bounds",
              "lse_config4_class"]


def _k2_on_card(name, rows, tile, device, monkeypatch, dtype=torch.float64,
                x0=None, groups=None, **extra):
    """K2 at a given tile (and, where given, groups of 128 threads per
    block; by default as many as fit) on ``rows`` instances of a geometry,
    and a function running the plain version on the card at any x0."""
    monkeypatch.setattr(fused_lbfgsb_tall, "tile_for", lambda B, sms: tile)
    if groups is not None:
        monkeypatch.setattr(_build.load(), "lbfgsb_tall_fit_groups",
                            lambda *args: groups)
    obj, x0_g, lo, up, data, opts = k2_geometries()[name]
    x0, lo, up = tiled(x0_g if x0 is None else x0, lo, up, rows)
    lo_t, up_t, *data_t = interop.tensors_from_numpy(
        lo, up, *data, device=device, dtype=dtype)
    kw = dict(opts, **extra)

    def plain(x):
        (xt,) = interop.tensors_from_numpy(x, device=device, dtype=dtype)
        return fused_lbfgsb_tall.lbfgsb_solve_tall_plain(
            obj, xt, lo_t, up_t, tuple(data_t), **kw)

    (x0_t,) = interop.tensors_from_numpy(x0, device=device, dtype=dtype)
    k2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    before = k2.launches
    r = k2(obj, x0_t, lo_t, up_t, tuple(data_t), **kw)
    torch.cuda.synchronize()
    assert k2.launches == before + 1 and k2.last_tile == tile
    assert k2.last_groups >= tile and groups in (None, k2.last_groups)
    return r, x0, plain


def _against_plain(r, x0, plain):
    """status equal, x within 1e-6 and iteration counts within max(2,
    spread) of the plain version (float64)."""
    x, _, it, st, _ = plain(x0)
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(), x0)
    assert torch.equal(r.status, st)
    assert (r.x - x).abs().max().item() <= 1e-6
    dit = (r.iterations.long() - it.long()).abs().max().item()
    assert dit <= max(2, spread), (dit, spread)


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
@pytest.mark.parametrize("name", TILE_EDGES)
def test_tall_tile_matches_plain(name, line_search, cuda, monkeypatch):
    r, x0, plain = _k2_on_card(name, 7, 3, cuda, monkeypatch,
                               line_search=line_search)
    _against_plain(r, x0, plain)


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
@pytest.mark.parametrize("name", TILE_EDGES)
def test_tall_tile_changes_no_instance_f32(name, line_search, cuda,
                                           monkeypatch):
    """float32, tile 3 against tile 1 on the same inputs: bit for bit, as
    every sum of an instance is taken in the same order at any tile (the
    quadratic's Q^T x too: by sub-blocks of 128 rows, in row order)."""
    r3, _, _ = _k2_on_card(name, 7, 3, cuda, monkeypatch,
                           dtype=torch.float32, line_search=line_search)
    r1, _, _ = _k2_on_card(name, 7, 1, cuda, monkeypatch,
                           dtype=torch.float32, line_search=line_search)
    assert torch.equal(r3.status, r1.status)
    assert torch.equal(r3.iterations, r1.iterations)
    assert torch.equal(r3.x, r1.x) and torch.equal(r3.f, r1.f)


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
@pytest.mark.parametrize("name", TILE_EDGES)
def test_tall_groups_change_no_instance_f32(name, line_search, cuda,
                                            monkeypatch):
    """float32, tile 1 in blocks of 4 groups (the extra three join only
    the objective's passes) against blocks of 1 group: bit for bit."""
    r4, _, _ = _k2_on_card(name, 7, 1, cuda, monkeypatch, groups=4,
                           dtype=torch.float32, line_search=line_search)
    r1, _, _ = _k2_on_card(name, 7, 1, cuda, monkeypatch, groups=1,
                           dtype=torch.float32, line_search=line_search)
    assert torch.equal(r4.status, r1.status)
    assert torch.equal(r4.iterations, r1.iterations)
    assert torch.equal(r4.x, r1.x) and torch.equal(r4.f, r1.f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
def test_tall_single_instance(line_search, dtype, cuda, monkeypatch):
    """B = 1: one block of one instance."""
    r, x0, plain = _k2_on_card("lse_config4_class", 1, 1, cuda, monkeypatch,
                               dtype=dtype, line_search=line_search)
    if dtype == torch.float64:
        _against_plain(r, x0, plain)
    else:
        _, f, _, st, _ = plain(x0)
        assert torch.equal(r.status, st)
        assert ((r.f - f).abs() / f.abs()).max().item() <= 1e-3


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
def test_tall_tile_finishes_apart(line_search, cuda, monkeypatch):
    """One tile whose first instance starts at the minimum (0 iterations)
    and whose others take over a hundred: the finished instance stays
    frozen while the tile runs on."""
    x0 = k2_geometries()["bounded_rosenbrock"][1][:3].copy()
    x0[0] = 1.0
    r, x0, plain = _k2_on_card("bounded_rosenbrock", 3, 3, cuda,
                               monkeypatch, x0=x0, line_search=line_search)
    assert r.iterations[0].item() == 0 and r.iterations[1:].min() > 100
    _against_plain(r, x0, plain)


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
def test_tall_unaligned_log_sum_exp(line_search, cuda, monkeypatch):
    """Rows of A that are not 16-byte aligned (n = 397) and a row count
    that is not a multiple of 4 (37): the passes over A take their 4- and
    8-byte copies; float64 against the plain version, tile 2 over B = 5."""
    monkeypatch.setattr(fused_lbfgsb_tall, "tile_for", lambda B, sms: 2)
    n, rows = 397, 37
    A, b = lse_arrays(n, rows)
    x0 = np.random.RandomState(8).uniform(-0.05, 0.05, (5, n))
    lo, up = np.full(n, -0.1), np.full(n, 0.1)
    x0_t, lo_t, up_t, A_t, b_t = interop.tensors_from_numpy(
        x0, lo, up, A, b, device=cuda)
    obj = problems.log_sum_exp(A_t, b_t)
    kw = dict(m=10, pgtol=1e-7, factr=10.0, max_iter=300,
              line_search=line_search)
    k2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    before = k2.launches
    r = k2(obj, x0_t, lo_t, up_t, **kw)
    torch.cuda.synchronize()
    assert k2.launches == before + 1 and k2.last_tile == 2

    def plain(x):
        (xt,) = interop.tensors_from_numpy(x, device=cuda)
        return fused_lbfgsb_tall.lbfgsb_solve_tall_plain(obj, xt, lo_t, up_t,
                                                         **kw)

    _against_plain(r, x0, plain)
    assert (r.status == 1).all()


def test_tall_tile_fits_shared_memory(cuda):
    """The tile shrinks where the block's shared memory would not hold it:
    log-sum-exp's rows x tile softmax in float64 near MAX_ROWS."""
    lib = _build.load()
    lse, rosen = 3, 0
    assert lib.lbfgsb_tall_fit_tile(0, lse, 10, 512, 4) == 4
    assert lib.lbfgsb_tall_fit_tile(1, rosen, 20, 0, 4) >= 1
    t = lib.lbfgsb_tall_fit_tile(1, lse, 20, fused_lbfgsb_tall.MAX_ROWS, 4)
    assert 1 <= t < 4
    assert lib.lbfgsb_tall_fit_tile(1, lse, 10, 64, 8) == 4
    # a smaller tile keeps the groups that fit: at config 4's shape all 4
    assert lib.lbfgsb_tall_fit_groups(0, lse, 10, 512, 1) == 4
    assert t <= lib.lbfgsb_tall_fit_groups(
        1, lse, 20, fused_lbfgsb_tall.MAX_ROWS, t) <= 4


def test_route_on_cuda_by_fit(cuda):
    """A config-4-shaped batch (n = 10,000, log-sum-exp) launches K2 and
    not K1; the headline shape launches K1 and not K2."""
    k1 = fused_lbfgsb.lbfgsb_solve_fused
    k2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    before = (k1.launches, k2.launches)
    lse = problems.log_sum_exp(*lse_arrays(10_000, 64))
    x0 = torch.tensor(np.random.RandomState(4).uniform(-0.5, 0.5, (2, 10_000)),
                      dtype=torch.float32, device=cuda)
    r = minimize(lse, x0, method="lbfgsb", bounds=(-1.0, 1.0), m=10, tol=1e-5,
                 factr=1e3, max_iter=2)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (before[0], before[1] + 1)
    assert (r.iterations == 2).all() and r.x.device.type == "cuda"
    assert bool((r.f < lse.value(x0)).all())
    headline = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (64, 100)),
                            dtype=torch.float32, device=cuda)
    minimize(problems.rosenbrock(), headline, method="lbfgsb",
             bounds=(-5.0, 5.0), tol=1e-3, factr=100.0, max_iter=5)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
    # within K1's fit the log-sum-exp and the quadratic launch K1 too
    for f in (problems.log_sum_exp(np.ones((3, 8)), np.zeros(3)),
              problems.quadratic(np.eye(8))):
        minimize(f, x0[:, :8], method="lbfgsb", bounds=(-1.0, 1.0),
                 max_iter=5)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (before[0] + 3, before[1] + 1)
    with pytest.raises(ValueError, match="tall kernel"):
        k1(problems.log_sum_exp(np.ones((60_000, 8)), np.zeros(60_000)),
           x0[:, :8], x0[0, :8] - 1.0, x0[0, :8] + 1.0)


def test_shared_memory_mirror_matches_the_library(cuda):
    """The route decides K1's fit in Python (``smem_per_instance``); it
    must equal the kernel's own ``work_elems`` formula."""
    lib = _build.load()
    for n in (1, 2, 31, 100, 1000, 1024, 1025, 3404, 3849, 3850, 10_000):
        for m in (1, 5, 10, 20):
            for itemsize in (4, 8):
                for rows in (0, 40, 512):
                    assert fused_lbfgsb.smem_per_instance(
                        n, m, itemsize, rows) == (
                            lib.lbfgsb_fused_smem_per_warp(
                                n, m, itemsize, rows)), (n, m, itemsize, rows)


def test_broken_build_raises(cuda, tmp_path, monkeypatch):
    """A kernel source that does not compile makes the wrapper raise; the
    plain version does not run in its place and no launch is counted."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("#error this source does not compile\n")
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "_SRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "LIB", str(build / "lib.so"))
    monkeypatch.setattr(_build, "LOG", str(build / "build.log"))
    monkeypatch.setattr(_build, "_lib", None)

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_lbfgsb_tall, "lbfgsb_solve_tall_plain", plain)
    monkeypatch.setattr(fused_lbfgsb, "lbfgsb_solve_plain", plain)
    before = (fused_lbfgsb.lbfgsb_solve_fused.launches,
              fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches)
    x0 = torch.zeros((2, 8), dtype=torch.float64, device=cuda)
    for bounds in ((-1.0, 1.0), None):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            minimize(problems.log_sum_exp(np.ones((3, 8)), np.zeros(3)), x0,
                     method="lbfgsb", bounds=bounds)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            minimize(problems.rosenbrock(), x0, method="lbfgsb", bounds=bounds)
    assert not os.path.exists(build / "lib.so")
    assert before == (fused_lbfgsb.lbfgsb_solve_fused.launches,
                      fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches)


# ---- the generic driver K3, first-order slice -----------------------------

def _k3_operands(g, device, dtype=torch.float64):
    x0, *data = interop.tensors_from_numpy(g["x0"], *g["data"],
                                           device=device, dtype=dtype)
    lo, up = (None if b is None else interop.tensors_from_numpy(
        b, device=device, dtype=dtype)[0] for b in (g["lower"], g["upper"]))
    return x0, lo, up, tuple(data)


@pytest.mark.parametrize("name", sorted(k3_geometries()))
def test_driver_kernel_matches_plain(name, cuda):
    """float64: status and iteration counts equal (chaotic entries within
    max(2, spread)), x within the entry's tolerance, and the same number of
    trial evaluations."""
    g = k3_geometries()[name]
    x0, lo, up, data = _k3_operands(g, cuda)
    kw = dict(max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])
    spec = fused_driver.build_spec(g["method"], g["search"])
    before = fused_driver.fused_minimize.launches
    x, f, it, st, nfev = fused_driver._launch_cuda(spec, g["objective"], x0,
                                                   lo, up, data, **kw)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 1

    def plain(v):
        (xt,) = interop.tensors_from_numpy(v, device=cuda)
        return fused_driver.fused_minimize_plain(
            g["method"], g["search"], g["objective"], xt, lo, up, data, **kw)

    xp, fp, itp, stp, nfevp = plain(g["x0"])
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(),
                                 g["x0"], runs=6)
    assert torch.equal(st, stp)
    dit = (it.long() - itp.long()).abs().max().item()
    assert dit <= (max(2, spread) if g["chaotic"] else spread), (dit, spread)
    if not g["chaotic"] and spread == 0:
        assert torch.equal(nfev, nfevp)
    torch.testing.assert_close(x, xp, rtol=1e-12, atol=g["x_atol"],
                               equal_nan=True)


def test_driver_route_launches_the_kernel(cuda):
    """minimize with every slice method, its default search and each slice
    search that may override it, launches the kernel once per call."""
    f = problems.weighted_squares()
    d, t = np.linspace(1.0, 20.0, 12), np.linspace(-2.0, 2.0, 12)
    x0 = torch.tensor(np.random.RandomState(1).uniform(-1, 1, (64, 12)),
                      device=cuda)
    searches = [None, ls.BackTracking(), ls.GLLQuadratic(), ls.NoSearch()]
    for method, extra in (("gd", {}), ("cd", {}), ("ncg", {}),
                          ("pnorm", {"inverse_p": np.diag(1.0 / d)}),
                          ("pgd", {"bounds": (-1.0, 1.0)}),
                          ("spg", {"bounds": (-1.0, 1.0)})):
        bounded = "bounds" in extra
        for search in searches + ([ls.BackTrackingB()] if bounded else []):
            before = fused_driver.fused_minimize.launches
            r = minimize(f, x0, method=method, data=(d, t), search=search,
                         max_iter=200, **extra)
            torch.cuda.synchronize()
            assert fused_driver.fused_minimize.launches == before + 1, (
                method, search)
            assert r.x.device.type == "cuda" and r.status.shape == (64,)


def test_driver_refuses_rather_than_falls_back(cuda, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_driver, "_solve_plain", plain)
    before = fused_driver.fused_minimize.launches
    x0 = torch.zeros((4, 6), dtype=torch.float64, device=cuda)
    # an objective the chosen form does not compile runs the lockstep loop
    # on the card (a static route: nothing is launched), and fused=True
    # still refuses it
    for f in (lambda x: (x * x).sum(), problems.quadratic(np.eye(6))):
        r = minimize(f, x0 + 1.0, method="gd", max_iter=50)
        assert r.x.device.type == "cuda" and bool((r.status == 1).all())
    assert fused_driver.fused_minimize.launches == before
    with pytest.raises(NotImplementedError, match="compiles the functors"):
        solvers.batch_minimize(
            solvers.GradientDescent(), ls.BackTracking(),
            make_oracle(problems.quadratic(np.eye(6))), x0, fused=True)
    # what K3 has no form for runs the lockstep loop on the card
    with pytest.raises(NotImplementedError, match="has no step_len"):
        minimize(problems.rosenbrock(), x0, method="gd",
                 search=ls.LineSearch())
    r = minimize(problems.rosenbrock(), x0, method="bfgs", max_iter=5,
                 search=ls.MoreThuente(reference_quirks=True))
    assert r.x.device.type == "cuda" and r.iterations.max().item() <= 5
    assert fused_driver.fused_minimize.launches == before
    # the Newton rows launch K3's Newton form, a log-sum-exp too
    r = minimize(problems.rosenbrock(), x0, method="newton", max_iter=5)
    assert fused_driver.fused_minimize.launches == before + 1
    assert r.x.device.type == "cuda"
    lse = problems.log_sum_exp(np.ones((3, 6)), np.zeros(3))
    r = minimize(lse, x0, method="pn", bounds=(-1.0, 1.0), max_iter=5)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 2
    assert bool(torch.isfinite(r.f).all())


def test_driver_shared_memory_mirror_matches_the_library(cuda):
    lib = _build.load()
    for n in (1, 31, 64, 100, 1000, 4150, 4151):
        for ring in (0, 1, 10):
            for m in (0, 4, 10):
                for itemsize in (4, 8):
                    for rows in (0, 40, 512):
                        mirror = fused_driver.smem_per_instance(
                            n, ring, itemsize, m, rows=rows)
                        assert mirror == lib.driver_smem_per_warp(
                            n, ring, m, rows, itemsize)
    # the dense form's block (one per instance): the slab where it fits
    for n in (1, 31, 100, 166, 167, 233, 234, 237, 238, 333, 334, 4000):
        for ring in (0, 10):
            for kind in range(4):
                for itemsize in (4, 8):
                    for rows in (0, 40, 512):
                        assert fused_driver.smem_per_instance(
                            n, ring, itemsize, method=fused_driver.QN,
                            qn_update=kind, rows=rows) == lib.driver_smem_dense(
                                n, ring, kind, rows, itemsize), (
                            n, ring, kind, rows)
    # the Newton form's block (one per instance)
    for n in (1, 31, 64, 100, 1000, 1024, 4150, 8301):
        for ring in (0, 1, 10):
            for itemsize in (4, 8):
                for rows in (0, 512):
                    assert fused_driver.smem_per_instance(
                        n, ring, itemsize, method=fused_driver.PN,
                        rows=rows) == (lib.driver_smem_newton(
                            n, ring, rows, itemsize)), (n, ring, rows)


def test_config6_shape_float32_quality(cuda):
    """GD + BackTracking on the 100-dim diagonal quadratic in float32, as
    config 6 runs it (B = 512 here)."""
    f = problems.diag_quadratic(np.linspace(1.0, 100.0, 100))
    x0 = torch.tensor(np.random.RandomState(0).uniform(-5, 5, (512, 100)),
                      dtype=torch.float32, device=cuda)
    r = minimize(f, x0, method="gd", tol=1e-6, max_iter=3000)
    assert (r.status == 1).float().mean().item() >= 0.99
    assert bool(torch.isfinite(r.x).all())


def _first_order_cases():
    spg = solvers.SpectralProjectedGradient
    return {
        "gd_bt": (solvers.GradientDescent, ls.BackTracking, {}),
        "gd_gll": (solvers.GradientDescent, ls.GLLQuadratic, {}),
        "cd_bt": (solvers.CoordinateDescent, ls.BackTracking, {}),
        "pnorm_bt": (solvers.PnormDescent, ls.BackTracking, {}),
        "pgd_btb": (solvers.ProjectedGradientDescent, ls.BackTrackingB, {}),
        "spg_gll": (spg, ls.GLLQuadratic, {"bb_variant": "alternate"}),
        "spg_btb": (spg, ls.BackTrackingB, {}),
        "ncg_bt": (solvers.NonlinearCG, ls.BackTracking, {"variant": "pr+"}),
    }


def _held_through_ties(kernel, plain, max_iter):
    """float64, kernel against plain version, each a function of the
    iteration budget returning ``(x, f, iterations, status, trials)``:
    status equal; counts equal and x within 1e-9 on every instance whose
    plain run takes no decision that the order of a sum could flip (the
    plain version's ``ties``), and on the others through the iterations
    before the first such decision."""
    x, _, it, st, nfev = kernel(max_iter)
    torch.cuda.synchronize()
    ties = torch.full_like(it, -1)
    xp, _, itp, stp, nfevp = plain(max_iter, ties)
    free = ties < 0
    assert torch.equal(st, stp)
    assert torch.equal(it[free], itp[free])
    assert torch.equal(nfev[free], nfevp[free])
    torch.testing.assert_close(x[free], xp[free], rtol=0, atol=1e-9)
    for k in sorted(set(ties[~free].tolist()) - {0}):
        rows = ties == k
        xk, _, itk, _, nfk = kernel(k)
        torch.cuda.synchronize()
        xq, _, itq, _, nfq = plain(k)
        assert torch.equal(itk[rows], itq[rows])
        assert torch.equal(nfk[rows], nfq[rows])
        torch.testing.assert_close(xk[rows], xq[rows], rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("n", [64, 100, 160])
@pytest.mark.parametrize("case", sorted(_first_order_cases()))
def test_first_order_layouts_match_plain(case, n, dtype, cuda):
    """K3's first-order form in each layout (two coordinates a lane at n =
    64, four at 100, the warp's shared memory at 160) on 64 instances of
    the weighted squares (d = linspace(1, 10)), box [-0.5, 0.5] for the
    bounded methods: float64 over 40 iterations, status equal, iterations
    and trials equal and x within 1e-9 (where the plain version takes a
    decision that the order of a sum could flip, through the iterations
    before it); float32 full solves at tol 1e-2, converged fractions at
    least 0.99 and within 0.01."""
    make, search, extra = _first_order_cases()[case]
    d = np.linspace(1.0, 10.0, n)
    if make is solvers.PnormDescent:
        extra = {"inverse_p": np.diag(1.0 / d) + 1e-3}
    f64 = dtype == torch.float64
    method = make(grad_tol=1e-6 if f64 else 1e-2, **extra)
    spec = fused_driver.build_spec(method, search())
    x0, lo, up, dd, t = interop.tensors_from_numpy(
        np.random.RandomState(n).uniform(-2, 2, (64, n)), np.full(n, -0.5),
        np.full(n, 0.5), d, np.linspace(-1.0, 1.0, n), device=cuda,
        dtype=dtype)
    box = (lo, up) if spec.bounded else (None, None)
    obj = problems.weighted_squares()

    def kernel(iters):
        return fused_driver._launch_cuda(spec, obj, x0, *box, (dd, t),
                                         max_iter=iters, max_iter_ls=40)

    def plain(iters, ties=None):
        return fused_driver.fused_minimize_plain(
            method, search(), obj, x0, *box, (dd, t), max_iter=iters,
            max_iter_ls=40, ties=ties)

    info = fused_driver.first_order_info(dtype, 64, n, spec.method, spec.ring)
    assert info["lane_coordinates"] == (2 if n <= 64 else 4 if n <= 128
                                        else 0), info
    if f64:
        _held_through_ties(kernel, plain, 40)
    else:
        st, stp = kernel(1500)[3], plain(1500)[3]
        conv, cp = ((v == 1).float().mean().item() for v in (st, stp))
        assert min(conv, cp) >= 0.99 and abs(conv - cp) <= 0.01, (conv, cp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("n", [64, 100, 160])
def test_k8_layouts_match_plain(n, dtype, cuda):
    """K8 in each layout on the inputs of the test above: float64 over 40
    iterations, status, iterations and trials equal and x within 1e-9;
    float32 full solves, converged fractions within 0.01."""
    f64 = dtype == torch.float64
    x0, lo, up, dd, t = interop.tensors_from_numpy(
        np.random.RandomState(n).uniform(-2, 2, (64, n)), np.full(n, -0.5),
        np.full(n, 0.5), np.linspace(1.0, 10.0, n), np.linspace(-1.0, 1.0, n),
        device=cuda, dtype=dtype)
    kw = dict(tol=1e-6 if f64 else 1e-4, max_iter=40 if f64 else 1000,
              max_iter_ls=30)
    obj = problems.weighted_squares()
    x, _, it, st, nfev = fused_spg._launch_cuda(
        obj, x0, lo, up, (dd, t), lam_min=1e-3, lam_max=1e3, gll_m=10,
        c1=1e-4, **kw)
    torch.cuda.synchronize()
    nfevp = torch.zeros_like(nfev)
    xp, _, itp, stp = fused_spg.spg_solve_plain(obj, x0, lo, up, (dd, t),
                                                nfev=nfevp, **kw)
    assert fused_spg.kernel_info(dtype, 64, n)["lane_coordinates"] == (
        2 if n <= 64 else 4 if n <= 128 else 0)
    if f64:
        assert torch.equal(st, stp) and torch.equal(it, itp)
        assert torch.equal(nfev, nfevp)
        torch.testing.assert_close(x, xp, rtol=0, atol=1e-9)
    else:
        conv, cp = ((v == 1).float().mean().item() for v in (st, stp))
        assert abs(conv - cp) <= 0.01, (conv, cp)


def test_first_order_and_k8_resources_by_width(cuda):
    """The layout each kernel takes by width, and its shared memory: the
    register layouts hold the GLL ring alone (and Pnorm's stage of g), the
    shared layout 7 n + ring elements a warp.  Registers and residency are
    the compiler's and the profiler's to report (tools/k3_phase_profile.py
    --first-order), not held here."""
    for dtype in (torch.float32, torch.float64):
        size = torch.finfo(dtype).bits // 8
        for n, lanes in ((64, 2), (100, 4), (160, 0)):
            for method, ring in ((fused_driver.GD, 0), (fused_driver.SPG, 10),
                                 (fused_driver.PNORM, 0)):
                info = fused_driver.first_order_info(dtype, 4096, n, method,
                                                     ring)
                per_warp = (7 * n + ring if not lanes else ring + (
                    n if method == fused_driver.PNORM else 0)) * size
                assert info["lane_coordinates"] == lanes, (n, info)
                assert info["smem_per_block"] == (
                    info["warps_per_block"] * per_warp), (n, method, info)
            info = fused_spg.kernel_info(dtype, 4096, n)
            assert info["lane_coordinates"] == lanes, (n, info)
            assert info["smem_per_block"] == info["warps_per_block"] * (
                (7 * n if not lanes else 0) + 10) * size, (n, info)


# ---- the generic driver K3, quasi-Newton slice ----------------------------

@pytest.mark.parametrize("name", sorted(k3_qn_geometries()))
def test_driver_qn_kernel_matches_plain(name, cuda):
    """Dense QN/QNB, L-BFGS and the Wolfe searches, float64: status equal,
    iteration counts within the plain version's spread (max(2, spread) on
    the chaotic entries), the same trial counts where the counts agree,
    and x within the entry's tolerance."""
    g = k3_qn_geometries()[name]
    x0, lo, up, data = _k3_operands(g, cuda)
    kw = dict(max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])
    spec = fused_driver.build_spec(g["method"], g["search"])
    before = fused_driver.fused_minimize.launches
    x, f, it, st, nfev = fused_driver._launch_cuda(spec, g["objective"], x0,
                                                   lo, up, data, **kw)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 1

    def plain(v):
        (xt,) = interop.tensors_from_numpy(v, device=cuda)
        return fused_driver.fused_minimize_plain(
            g["method"], g["search"], g["objective"], xt, lo, up, data, **kw)

    xp, fp, itp, stp, nfevp = plain(g["x0"])
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(),
                                 g["x0"], runs=6)
    assert torch.equal(st, stp)
    dit = (it.long() - itp.long()).abs().max().item()
    assert dit <= (max(2, spread) if g["chaotic"] else spread), (dit, spread)
    if not g["chaotic"] and spread == 0:
        assert torch.equal(nfev, nfevp)
    finite = torch.isfinite(f)
    torch.testing.assert_close(x[finite], xp[finite], rtol=1e-12,
                               atol=g["x_atol"])


@pytest.mark.parametrize("n,m,compact", [(40, 10, True), (40, 33, False),
                                          (1070, 10, False)])
def test_driver_qn_lbfgs_directions_match_plain(n, m, compact, cuda):
    """L-BFGS + Hager-Zhang on a weighted-squares quadratic, float64: the
    compact form of H g (m = 10), and the two-loop recursion where m
    exceeds a warp's lanes (m = 33) or the compact form's tables do not fit
    beside the vectors (n = 1,070), over the first 40 iterations (none
    converges by then): status, iterations and trials equal, x within
    1e-9."""
    assert fused_driver.compact_fits(n, 0, 8, m) == compact
    f = problems.weighted_squares()
    d = torch.tensor(np.logspace(0, 2, n), device=cuda)
    t = torch.tensor(np.linspace(-1.0, 1.0, n), device=cuda)
    x0 = torch.tensor(np.random.RandomState(4).uniform(-2, 2, (8, n)),
                      device=cuda)
    method, search = solvers.LBFGS(tol=1e-8, m=m), ls.HagerZhang()
    kw = dict(max_iter=40, max_iter_ls=40)
    x, _, it, st, nfev = fused_driver._launch_cuda(
        fused_driver.build_spec(method, search), f, x0, None, None, (d, t),
        **kw)
    xp, _, itp, stp, nfevp = fused_driver.fused_minimize_plain(
        method, search, f, x0, consts=(d, t), **kw)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert torch.equal(nfev, nfevp)
    assert (x - xp).abs().max().item() <= 1e-9


def test_driver_qn_route_launches_the_kernel(cuda):
    """minimize with every quasi-Newton row, its default search and every
    search that may replace it, launches K3 once per call; so does
    batch_minimize with config 2's configs."""
    f = problems.weighted_squares()
    d, t = np.linspace(1.0, 20.0, 12), np.linspace(-2.0, 2.0, 12)
    x0 = torch.tensor(np.random.RandomState(1).uniform(-1, 1, (64, 12)),
                      device=cuda)
    free = [None, ls.BackTracking(), ls.GLLQuadratic(), ls.NoSearch(),
            ls.MoreThuente(), ls.MoreThuente(approx_wolfe=True),
            ls.HagerZhang(), ls.StrongWolfe()]
    boxed = [ls.BackTrackingB(), ls.MoreThuenteB(), ls.HagerZhangB(),
             ls.StrongWolfe(bounded=True)]
    for method in ("bfgs", "dfp", "broyden", "lbfgs", "gd", "bfgsb", "dfpb",
                   "broydenb", "sr1b", "spg"):
        bounded = method.endswith("b") or method == "spg"
        extra = {"bounds": (-1.0, 1.0)} if bounded else {}
        for search in free + (boxed if bounded else []):
            before = fused_driver.fused_minimize.launches
            r = minimize(f, x0, method=method, data=(d, t), search=search,
                         tol=1e-6, max_iter=200, **extra)
            torch.cuda.synchronize()
            assert fused_driver.fused_minimize.launches == before + 1, (
                method, search)
            assert r.x.device.type == "cuda" and r.status.shape == (64,)
    rosen = problems.rosenbrock()
    xr = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (32, 100)),
                      dtype=torch.float32, device=cuda)
    before = fused_driver.fused_minimize.launches
    r = solvers.batch_minimize(
        solvers.QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
                            restart_on_degeneracy=True),
        ls.MoreThuente(), make_oracle(rosen), xr, max_iter=1500,
        max_iter_ls=40)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 1
    assert float(torch.isin(r.status, torch.tensor(
        [1, 6], device=cuda)).float().mean()) >= 0.9


def test_driver_qn_refuses_rather_than_falls_back(cuda, monkeypatch):
    """reference_quirks runs the lockstep loop on the card; a slab batch
    beyond the device's free memory raises NotImplementedError; K3's plain
    version never runs on a CUDA tensor."""
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_driver, "_solve_plain", plain)
    before = fused_driver.fused_minimize.launches
    x0 = torch.zeros((4, 6), dtype=torch.float64, device=cuda)
    oracle = make_oracle(problems.rosenbrock())
    r = solvers.batch_minimize(solvers.BFGS(),
                               ls.MoreThuente(reference_quirks=True), oracle,
                               x0, max_iter=5)
    assert r.x.device.type == "cuda"
    free, _ = torch.cuda.mem_get_info()
    n = 4000
    # one packed slab more than fits
    B = int(free // (fused_driver.dense_slab_elems(n, 0) * 8)) + 1
    wide = torch.zeros((1, n), dtype=torch.float64, device=cuda).expand(B, n)
    with pytest.raises(NotImplementedError, match="device memory"):
        solvers.batch_minimize(solvers.BFGS(), ls.MoreThuente(), oracle, wide)
    assert fused_driver.fused_minimize.launches == before


def test_driver_workspace_mirror_matches_the_library(cuda):
    """The slab workspace is sized in Python (``workspace_elems``: the
    Newton form's (n, n) slabs, the dense form's slabs past the shared
    memory fit); it must equal the kernel's own formula."""
    lib = _build.load()
    for B in (1, 64, 1024):
        for n in (1, 33, 100, 166, 167, 233, 234, 237, 238, 333, 334, 4150):
            for method in range(12):
                for ring, kind, itemsize in ((0, 0, 8), (10, 2, 8), (0, 3, 4),
                                             (0, 2, 4)):
                    for rows in (0, 512):
                        assert fused_driver.workspace_elems(
                            B, n, method, ring, itemsize, kind, rows) == (
                                lib.driver_workspace_elems(
                                    B, n, method, ring, kind, rows,
                                    itemsize)), (
                            B, n, method, ring, kind, itemsize, rows)


def test_config2_shape_float32_quality(cuda):
    """Config 2's call at B = 256: dense BFGS + More-Thuente on
    Rosenbrock-100 in float32; success class (CONVERGED or STALLED) for
    nearly every instance, as in the JAX bench."""
    f = problems.rosenbrock()
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (256, 100)),
                      dtype=torch.float32, device=cuda)
    r = minimize(f, x0, method="bfgs", tol=2e-4, max_iter=1500,
                 scale_b0=True, restart_on_degeneracy=True,
                 policy="reference")
    ok = torch.isin(r.status, torch.tensor([1, 6], device=cuda))
    assert ok.float().mean().item() >= 0.99
    assert bool(torch.isfinite(r.x).all())


# ---- the generic driver K3, Newton form -----------------------------------

@pytest.mark.parametrize("name", sorted(k3_newton_geometries()))
def test_driver_newton_kernel_matches_plain(name, cuda):
    """Newton, PN and SPN with every search family, float64: status equal,
    iteration counts within the plain version's spread (max(2, spread) on
    the Rosenbrock entries), the same trial counts where the counts agree,
    and x within the entry's tolerance."""
    g = k3_newton_geometries()[name]
    x0, lo, up, data = _k3_operands(g, cuda)
    kw = dict(max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])
    spec = fused_driver.build_spec(g["method"], g["search"])
    before = fused_driver.fused_minimize.launches
    x, f, it, st, nfev = fused_driver._launch_cuda(spec, g["objective"], x0,
                                                   lo, up, data, **kw)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 1

    def plain(v):
        (xt,) = interop.tensors_from_numpy(v, device=cuda)
        return fused_driver.fused_minimize_plain(
            g["method"], g["search"], g["objective"], xt, lo, up, data, **kw)

    xp, fp, itp, stp, nfevp = plain(g["x0"])
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(),
                                 g["x0"], runs=6)
    assert torch.equal(st, stp)
    dit = (it.long() - itp.long()).abs().max().item()
    assert dit <= (max(2, spread) if g["chaotic"] else spread), (dit, spread)
    if not g["chaotic"] and spread == 0 and g["trials_exact"]:
        assert torch.equal(nfev, nfevp)
    finite = torch.isfinite(f)
    torch.testing.assert_close(x[finite], xp[finite], rtol=1e-12,
                               atol=g["x_atol"])


def test_driver_newton_route_launches_the_kernel(cuda):
    """minimize's newton, pn and spn rows with their default and other
    searches launch K3 once per call, and so does batch_minimize with
    config 5's call (B = 8, n = 256, float32)."""
    f = problems.weighted_squares()
    d, t = np.linspace(1.0, 20.0, 12), np.linspace(-2.0, 2.0, 12)
    x0 = torch.tensor(np.random.RandomState(1).uniform(-1, 1, (64, 12)),
                      device=cuda)
    for method, searches in (
            ("newton", [None, ls.BackTracking(), ls.HagerZhang(),
                        ls.StrongWolfe()]),
            ("pn", [None, ls.MoreThuenteB(), ls.HagerZhangB()]),
            ("spn", [None, ls.StrongWolfe(bounded=True)])):
        extra = {} if method == "newton" else {"bounds": (-1.0, 1.0)}
        for policy in ("fast", "reference"):
            for search in searches:
                before = fused_driver.fused_minimize.launches
                r = minimize(f, x0, method=method, data=(d, t), search=search,
                             tol=1e-6, max_iter=200, policy=policy, **extra)
                torch.cuda.synchronize()
                assert fused_driver.fused_minimize.launches == before + 1, (
                    method, search)
                assert r.x.device.type == "cuda" and r.status.shape == (64,)
    n = 256
    q = problems.quadratic(torch.tensor(config5_hessian(n),
                                        dtype=torch.float32, device=cuda))
    x5 = torch.tensor(np.random.RandomState(5).uniform(-2, 2, (8, n)),
                      dtype=torch.float32, device=cuda)
    box = torch.full((n,), 2.0, device=cuda)
    before = fused_driver.fused_minimize.launches
    r = solvers.batch_minimize(solvers.ProjectedNewton(grad_tol=1e-4),
                               ls.BackTrackingB(), make_oracle(q), x5,
                               bounds=(-box, box), max_iter=50)
    torch.cuda.synchronize()
    assert fused_driver.fused_minimize.launches == before + 1
    assert (r.status == 1).all() and (r.iterations == 1).all()
    assert r.x.abs().max().item() <= 1e-4


# ---- the Newton-CG kernel K4 ------------------------------------------------

@pytest.mark.parametrize("name", sorted(k4_geometries()))
def test_newton_cg_kernel_matches_plain(name, cuda):
    """float64: status equal, iteration counts within the plain version's
    spread (max(2, spread) on the Rosenbrock entries), x within the entry's
    tolerance."""
    g = k4_geometries()[name]
    lo, up, *data = interop.tensors_from_numpy(g["lower"], g["upper"],
                                               *g["data"], device=cuda)
    (x0,) = interop.tensors_from_numpy(g["x0"], device=cuda)
    before = fused_newton_cg.newton_cg_solve_fused.launches
    r = fused_newton_cg.newton_cg_solve_fused(g["objective"], x0, lo, up,
                                              tuple(data), **g["opts"])
    torch.cuda.synchronize()
    assert fused_newton_cg.newton_cg_solve_fused.launches == before + 1

    def plain(v):
        (xt,) = interop.tensors_from_numpy(v, device=cuda)
        return fused_newton_cg.newton_cg_solve_plain(
            g["objective"], xt, lo, up, tuple(data), **g["opts"])

    xp, fp, itp, stp, _, _ = plain(g["x0"])
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(),
                                 g["x0"], runs=6)
    assert torch.equal(r.status, stp)
    dit = (r.iterations.long() - itp.long()).abs().max().item()
    assert dit <= (max(2, spread) if g["chaotic"] else spread), (dit, spread)
    torch.testing.assert_close(r.x, xp, rtol=0, atol=g["x_atol"])
    assert r.x.device.type == "cuda" and r.pg_norm.shape == r.f.shape


def test_newton_cg_route_and_refusals(cuda, monkeypatch):
    """minimize(method="newton_cg") launches K4 once per batch K4 takes (a
    log-sum-exp too); an instance too wide for shared memory runs the
    lockstep loop on the card, K4 refuses it when called directly, and the
    plain version never runs on a CUDA tensor."""
    x0 = torch.tensor(np.random.RandomState(42).uniform(-2, 2, (64, 100)),
                      dtype=torch.float32, device=cuda)
    before = fused_newton_cg.newton_cg_solve_fused.launches
    r = minimize(problems.rosenbrock(), x0, method="newton_cg",
                 bounds=(-5.0, 5.0), tol=1e-3, max_iter=600, cg_max=12)
    torch.cuda.synchronize()
    assert fused_newton_cg.newton_cg_solve_fused.launches == before + 1
    assert (r.status == 1).float().mean().item() >= 0.95

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_newton_cg, "newton_cg_solve_plain", plain)
    lse = problems.log_sum_exp(np.ones((3, 100)), np.zeros(3))
    r = minimize(lse, x0, method="newton_cg", bounds=(-1.0, 1.0))
    torch.cuda.synchronize()
    assert fused_newton_cg.newton_cg_solve_fused.launches == before + 2
    assert bool(torch.isfinite(r.f).all())
    wide = torch.zeros((2, 8000), dtype=torch.float64, device=cuda)
    r = minimize(problems.rosenbrock(), wide, method="newton_cg", max_iter=5)
    assert r.x.device.type == "cuda" and r.iterations.max().item() == 5
    lo8 = torch.full((8000,), -5.0, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="shared memory"):
        fused_newton_cg.newton_cg_solve_fused(problems.rosenbrock(), wide,
                                              lo8, -lo8)
    assert fused_newton_cg.newton_cg_solve_fused.launches == before + 2


@pytest.mark.parametrize("n", [100, 128, 129, 300])
def test_newton_cg_layouts_match_plain(n, cuda):
    """Rosenbrock at the register layout's widths (n <= 128) and past them
    (the shared-memory layout), float64, the first 8 iterations: status and
    iterations equal, x within 1e-6 (past ~10 iterations a 1e-15 change of
    x0 moves x by more than 1e-9)."""
    rng = np.random.RandomState(n)
    x0, lo, up = interop.tensors_from_numpy(
        rng.uniform(-2, 2, (64, n)), np.full(n, -5.0), np.full(n, 5.0),
        device=cuda)
    kw = dict(pgtol=1e-3, factr=100.0, max_iter=8, cg_max=12,
              max_iter_ls=25, c1=1e-4)
    x, _, it, st, _, _ = fused_newton_cg._launch_cuda(
        problems.rosenbrock(), x0, lo, up, (), **kw)
    xp, _, itp, stp, _, _ = fused_newton_cg.newton_cg_solve_plain(
        problems.rosenbrock(), x0, lo, up, **kw)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,rows", [(40, 8), (20, 70), (300, 100)])
def test_newton_cg_log_sum_exp_matches_plain(n, rows, cuda):
    """K4's log-sum-exp functor (the shared-memory layout, A's rows in
    chunks of 32 and a ragged last chunk), float64, box [-1, 1]: status and
    every count equal, x within 1e-9, over 30 iterations where n < rows or
    rows is small (CG ends far from rounding).  At n = 300 past 100 rows 32
    CG steps a Newton step on the singular Hessian amplify rounding (the
    plain version's own f after 2 iterations moves from 3.7748 to 3.7496
    when its instance is solved in a batch of two equal rows, on the CPU),
    so there the full solves are held: status equal, f within 1e-6
    relative (the plain version alone against its batch: 6.8e-9)."""
    A, b = lse_arrays(n, rows)
    x0, lo, up, tA, tb = interop.tensors_from_numpy(
        np.random.RandomState(4).uniform(-0.5, 0.5, (64, n)),
        np.full(n, -1.0), np.full(n, 1.0), A, b, device=cuda)
    lse = problems.log_sum_exp(tA, tb)
    kw = dict(pgtol=1e-8, factr=0.0, max_iter=30, cg_max=32,
              max_iter_ls=25, c1=1e-4)
    if n > 100:
        kw.update(pgtol=1e-5, factr=1e3, max_iter=200)
    x, f, it, st, ncg, nfev = fused_newton_cg._launch_cuda(
        lse, x0, lo, up, (), **kw)
    xp, fp, itp, stp, ncgp, nfevp = fused_newton_cg.newton_cg_solve_plain(
        lse, x0, lo, up, **kw)
    assert torch.equal(st, stp)
    if n > 100:
        assert bool((st == 1).all())
        torch.testing.assert_close(f, fp, rtol=1e-6, atol=0)
    else:
        assert torch.equal(it, itp) and torch.equal(nfev, nfevp)
        assert torch.equal(ncg, ncgp)
        torch.testing.assert_close(x, xp, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,rows", [(16, 32), (64, 300), (128, 64)])
def test_newton_form_log_sum_exp_matches_plain(n, rows, cuda):
    """K3's Newton form on the log-sum-exp (the block-level Hessian, A's
    rows staged 32 at a time; the tiles' ragged edges at n = 16 and 64 in
    float64), PN + BackTrackingB, box [-1, 1], float64, 10 iterations:
    status and iterations equal, x within 1e-9; n = 128 past 64 rows is
    singular, every factor collapses and both versions take the fallback
    direction."""
    A, b = lse_arrays(n, rows)
    x0, lo, up, tA, tb = interop.tensors_from_numpy(
        np.random.RandomState(5).uniform(-0.5, 0.5, (32, n)),
        np.full(n, -1.0), np.full(n, 1.0), A, b, device=cuda)
    lse = problems.log_sum_exp(tA, tb)
    pn = solvers.ProjectedNewton(grad_tol=1e-9)
    spec = fused_driver.build_spec(pn, ls.BackTrackingB())
    x, _, it, st, _ = fused_driver._launch_cuda(spec, lse, x0, lo, up, (),
                                                10, 40)
    xp, _, itp, stp, _ = fused_driver.fused_minimize_plain(
        pn, ls.BackTrackingB(), lse, x0, lo, up, (), max_iter=10,
        max_iter_ls=40)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-9)


def test_newton_cg_resources_at_the_headline(cuda):
    """The layout K4 takes by width: at the Newton-CG headline's shape (n =
    100, both types) the register layout, blocks of 8 warps and no shared
    memory; past n = 128 the shared-memory layout, 8 n elements a warp.
    Registers and residency are the compiler's and the profiler's to report
    (tools/k4_phase_profile.py), not held here."""
    for dtype in (torch.float32, torch.float64):
        info = fused_newton_cg.kernel_info(dtype, 10240, 100)
        assert info["warps_per_block"] == 8, info
        assert info["smem_per_block"] == 0 and info["blocks_per_sm"] >= 1, info
        wide = fused_newton_cg.kernel_info(dtype, 10240, 129)
        size = torch.finfo(dtype).bits // 8
        assert wide["smem_per_block"] == (
            wide["warps_per_block"] * fused_newton_cg.smem_per_instance(
                129, size)) > 0, wide


def test_newton_cg_shared_memory_mirror_matches_the_library(cuda):
    lib = _build.load()
    for n in (1, 31, 100, 7264, 7265):
        for itemsize in (4, 8):
            for rows in (0, 512):
                assert fused_newton_cg.smem_per_instance(
                    n, itemsize, rows) == (
                        lib.newton_cg_smem_per_warp(n, rows, itemsize))


# ---- the lockstep loop's kernels K5 (fused QN update) and K6 (Cholesky) ----

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [5, 37, 300])
def test_qn_update_kernel_matches_plain(n, dtype, cuda):
    """B staged in shared memory where it fits (float32 n <= 238, float64
    n <= 167), else read from device memory (the workspace placement, n =
    300 in both types)."""
    Bm, s, y, g = interop.tensors_from_numpy(*qn_update_arrays(6, n),
                                             device=cuda, dtype=dtype)
    skip = fused_qn.skip_mask(s, y, 1e-8)
    assert skip.tolist() == [False, True, False, False, False, False]
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    where = ("shared" if n <= (167 if dtype == torch.float64 else 238)
             else "workspace")
    assert fused_qn.in_shared(n, Bm.element_size()) == (where == "shared")
    for kind in fused_qn.KINDS:
        before = fused_qn.qn_update_direction_fused.launches
        fused_qn.qn_update_direction_fused.placements = {"shared": 0,
                                                         "workspace": 0}
        Bn, Bg = fused_qn.qn_update_direction_fused(Bm, s, y, g, tol=1e-8,
                                                    kind=kind)
        torch.cuda.synchronize()
        assert fused_qn.qn_update_direction_fused.launches == before + 1
        assert fused_qn.qn_update_direction_fused.placements == {
            "shared": int(where == "shared"),
            "workspace": int(where == "workspace")}
        Pn, Pg = fused_qn.qn_update_direction_plain(Bm, s, y, g, skip,
                                                    kind=kind)
        assert (Bn - Pn).abs().max() <= rtol * Pn.abs().max(), kind
        assert (Bg - Pg).abs().max() <= rtol * Pg.abs().max(), kind
        assert torch.equal(Bn[1], Bm[1]), kind


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [167, 168, 238, 239])
def test_qn_update_kernel_placements_at_the_fit(n, dtype, cuda):
    """Both sides of each type's shared-memory fit (float64: 167 shared,
    168 in the workspace; float32: 238 shared, 239 in the workspace), on
    the curvature pairs (s.y > 0) the path's Wolfe search feeds K5: every
    rule within the tolerances of ``test_qn_update_kernel_matches_plain``,
    the skipped instance unchanged, the launch counted in its placement.
    (The random pairs of that test cancel, and at these widths float32's
    rounding of the plain version alone moves B' by ~1e-5 of its largest
    entry.)"""
    Bm, s, y, g = interop.tensors_from_numpy(
        *qn_update_arrays(4, n, curvature=True), device=cuda, dtype=dtype)
    skip = fused_qn.skip_mask(s, y, 1e-8)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    shared = n <= (167 if dtype == torch.float64 else 238)
    assert fused_qn.in_shared(n, Bm.element_size()) == shared
    for kind in fused_qn.KINDS:
        fused_qn.qn_update_direction_fused.placements = {"shared": 0,
                                                         "workspace": 0}
        Bn, Bg = fused_qn.qn_update_direction_fused(Bm, s, y, g, tol=1e-8,
                                                    kind=kind)
        torch.cuda.synchronize()
        assert fused_qn.qn_update_direction_fused.placements == {
            "shared": int(shared), "workspace": int(not shared)}
        Pn, Pg = fused_qn.qn_update_direction_plain(Bm, s, y, g, skip,
                                                    kind=kind)
        assert (Bn - Pn).abs().max() <= rtol * Pn.abs().max(), kind
        assert (Bg - Pg).abs().max() <= rtol * Pg.abs().max(), kind
        assert torch.equal(Bn[1], Bm[1]), kind


def test_qn_update_kernel_refusals(cuda):
    Bm, s, y, g = interop.tensors_from_numpy(*qn_update_arrays(3, 4),
                                             device=cuda)
    before = fused_qn.qn_update_direction_fused.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        fused_qn.qn_update_direction_fused(Bm.half(), s.half(), y.half(),
                                           g.half())
    with pytest.raises(ValueError, match=r"must be a \(3, 4\)"):
        fused_qn.qn_update_direction_fused(Bm, s[:2], y, g)
    n = 6000                     # 5 n float64 elements exceed a block's
    wide = torch.zeros((1, 1, 1), dtype=torch.float64,
                       device=cuda).expand(1, n, n)
    v = torch.zeros((1, n), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_qn.qn_update_direction_fused(wide, v, v, v)
    assert fused_qn.qn_update_direction_fused.launches == before


def test_qn_update_launch_failure_raises_rather_than_falls_back(
        cuda, monkeypatch):
    """A launch the kernel refuses (a rule it does not know) raises
    RuntimeError: no plain version, no other placement, no count."""
    def plain(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_qn, "qn_update_direction_plain", plain)
    monkeypatch.setattr(fused_qn, "KINDS", fused_qn.KINDS + ("unknown",))
    Bm, s, y, g = interop.tensors_from_numpy(*qn_update_arrays(3, 8),
                                             device=cuda)
    before = (fused_qn.qn_update_direction_fused.launches,
              dict(fused_qn.qn_update_direction_fused.placements))
    with pytest.raises(RuntimeError, match="qn_update_launch failed"):
        fused_qn.qn_update_direction_fused(Bm, s, y, g, kind="unknown")
    assert (fused_qn.qn_update_direction_fused.launches,
            fused_qn.qn_update_direction_fused.placements) == before


@pytest.mark.parametrize("n", [1, 24, 33, 100, 301])
def test_cholesky_kernel_matches_plain(n, cuda):
    H, g = interop.tensors_from_numpy(*spd_arrays(5, n, non_pd=3),
                                      device=cuda)
    before = fused_newton.cholesky_solve_fused.launches
    H0 = H.clone()
    x = fused_newton.cholesky_solve_fused(H, g)
    torch.cuda.synchronize()
    assert fused_newton.cholesky_solve_fused.launches == before + 1
    assert torch.equal(H, H0)
    ref = fused_newton.cholesky_solve_plain(H, g)
    ok = [0, 1, 2, 4]
    assert (x[ok] - ref[ok]).abs().max().item() <= 1e-10
    assert torch.isnan(x[3]).all() and torch.isnan(ref[3]).all()
    # an expanded (shared) Hessian is taken as it is and not written
    Hs = H[:1].expand(4, n, n)
    xs = fused_newton.cholesky_solve_fused(Hs, g[:4])
    refs = fused_newton.cholesky_solve_plain(Hs.contiguous(), g[:4])
    assert (xs - refs).abs().max().item() <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [31, 65, 129, 1024])
def test_cholesky_kernel_panels_match_plain(n, dtype, cuda):
    """K6 over one panel, several, and a ragged last one (its panels are 64
    wide in float32, 32 in float64), up to n = 1,024: in float64 x within
    1e-10 of the plain version, in float32 the relative residual within
    1e-4 (chip_smoke's K6_RES); the non-PD instance all NaN; H not
    written."""
    H, g = interop.tensors_from_numpy(*spd_arrays(3, n, non_pd=1),
                                      device=cuda, dtype=dtype)
    H0 = H.clone()
    ref = fused_newton.cholesky_solve_plain(H, g)
    before = fused_newton.cholesky_solve_fused.launches
    x = fused_newton.cholesky_solve_fused(H, g)
    torch.cuda.synchronize()
    assert fused_newton.cholesky_solve_fused.launches == before + 1
    assert torch.isnan(x[1]).all()
    ok = [0, 2]
    if dtype == torch.float64:
        assert (x[ok] - ref[ok]).abs().max().item() <= 1e-10
    else:
        r = torch.einsum("bij,bj->bi", H[ok], x[ok]) - g[ok]
        res = (r.norm(dim=-1) / g[ok].norm(dim=-1)).max().item()
        assert res <= 1e-4, res
    assert torch.equal(H, H0)
    assert fused_newton.panel_width(n, H.element_size()) > 0


def test_cholesky_panel_mirror_matches_the_library(cuda):
    lib = _build.load()
    for n in (1, 31, 1024, 14527, 20608, 20609, 29055, 33536, 33537):
        for itemsize in (4, 8):
            assert fused_newton.panel_width(n, itemsize) == (
                lib.cholesky_solve_panel(n, itemsize)), (n, itemsize)


@pytest.mark.parametrize("n", [32, 33, 100, 257])
def test_driver_newton_wide_quadratic_matches_plain(n, cuda):
    """K3's Newton form on config 5's quadratic in float64 at widths of one
    panel and tile (32) and of several (the blocked factorization's panels
    and tiles are 32 wide in float64), PN, Newton and SPN with precond_bb,
    and the Armijo searches bounded and unbounded: status, iterations and
    trials equal, x within 1e-9."""
    dtype = torch.float64
    Q = config5_hessian(n)
    # a symmetric Q and one with an antisymmetric part (the same objective;
    # the gradient and the Hessian take Q's symmetric part)
    A = np.random.RandomState(n).standard_normal((n, n)) / n
    for Qm in (Q, Q + (A - A.T)):
        _newton_quadratic_cases(Qm, n, dtype, cuda)


def _newton_quadratic_cases(Qm, n, dtype, cuda):
    q = problems.quadratic(torch.tensor(Qm, dtype=dtype, device=cuda))
    x0 = torch.tensor(np.random.RandomState(5).uniform(-2, 2, (4, n)),
                      dtype=dtype, device=cuda)
    box = torch.full((n,), 2.0, dtype=dtype, device=cuda)
    kw = dict(max_iter=20, max_iter_ls=20)
    for method, search, bounds in (
            (solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTrackingB(), True),
            (solvers.Newton(tol=1e-12), ls.MoreThuente(), False),
            (solvers.SpectralProjectedNewton(grad_tol=1e-8, precond_bb=True),
             ls.BackTrackingB(), True),
            # value-only Armijo trials, then the step's value and gradient
            (solvers.Newton(tol=1e-12), ls.BackTracking(), False),
            (solvers.ProjectedNewton(grad_tol=1e-8), ls.BackTracking(), True)):
        lo, up = (-box, box) if bounds else (None, None)
        spec = fused_driver.build_spec(method, search)
        x, f, it, st, nfev = fused_driver._launch_cuda(spec, q, x0, lo, up,
                                                       (), **kw)
        torch.cuda.synchronize()
        xp, fp, itp, stp, nfevp = fused_driver.fused_minimize_plain(
            method, search, q, x0, lo, up, (), **kw)
        name = type(method).__name__
        assert torch.equal(st, stp), name
        assert torch.equal(it, itp), name
        assert torch.equal(nfev, nfevp), name
        assert (x - xp).abs().max().item() <= 1e-9, name


def test_cholesky_kernel_float32_residual(cuda):
    n = 256
    H = torch.tensor(config5_hessian(n), dtype=torch.float32,
                     device=cuda).expand(16, n, n).contiguous()
    g = torch.tensor(np.random.RandomState(5).uniform(-2, 2, (16, n)),
                     dtype=torch.float32, device=cuda)
    x = fused_newton.cholesky_solve_fused(H, g)
    res = (torch.einsum("bij,bj->bi", H, x) - g).norm(dim=-1) / g.norm(dim=-1)
    assert res.max().item() <= 1e-4
    lib = linalg.cholesky_solve(H, g)
    assert (x - lib).abs().max().item() <= 1e-4 * lib.abs().max().item()


def test_lockstep_kernels_on_the_path(cuda, monkeypatch):
    """The lockstep QuasiNewton(fused=True) step launches K5 once per
    iteration, PN through ops.linalg with use_kernel=True K6 once and SPN
    with precond_bb twice; in float64 each solve equals the one through
    the plain versions (status and iterations, x within 1e-10)."""
    f = problems.weighted_squares()
    d, t = np.linspace(1.0, 40.0, 6), np.zeros(6)
    oracle = make_oracle(f, data=interop.tensors_from_numpy(d, t,
                                                            device=cuda))
    x0 = torch.tensor(np.random.RandomState(3).uniform(-2, 2, (5, 6)),
                      device=cuda)
    box = torch.full((6,), 2.5, device=cuda, dtype=torch.float64)
    for kind in fused_qn.KINDS:
        method = solvers.QuasiNewton(tol=1e-8, update=kind, fused=True)
        before = fused_qn.qn_update_direction_fused.launches
        r = solvers.batch_minimize(method, ls.MoreThuente(), oracle, x0,
                                   fused=False, max_iter=100)
        torch.cuda.synchronize()
        assert fused_qn.qn_update_direction_fused.launches - before == int(
            r.iterations.max())
        p = solvers.batch_minimize(method, ls.MoreThuente(), oracle,
                                   x0.cpu(), fused=False, max_iter=100)
        assert torch.equal(r.status.cpu(), p.status)
        assert torch.equal(r.iterations.cpu(), p.iterations)
        assert (r.x.cpu() - p.x).abs().max().item() <= 1e-10
    hess = make_oracle(f, with_hessian=True,
                       data=interop.tensors_from_numpy(d, t, device=cuda))
    for method, per_iter in (
            (solvers.ProjectedNewton(grad_tol=1e-8), 1),
            (solvers.SpectralProjectedNewton(grad_tol=1e-8, precond_bb=True),
             2)):
        runs = []
        for use_kernel in (True, False):
            monkeypatch.setattr(linalg.config, "use_kernel", use_kernel)
            before = fused_newton.cholesky_solve_fused.launches
            runs.append(solvers.batch_minimize(
                method, ls.BackTrackingB(), hess, x0, bounds=(-box, box),
                fused=False, max_iter=50))
            torch.cuda.synchronize()
            launched = fused_newton.cholesky_solve_fused.launches - before
            assert launched == (per_iter * int(runs[-1].iterations.max())
                                if use_kernel else 0)
        assert torch.equal(runs[0].status, runs[1].status)
        assert torch.equal(runs[0].iterations, runs[1].iterations)
        assert (runs[0].x - runs[1].x).abs().max().item() <= 1e-10


# ---- the whole-solve kernels K7 (L-BFGS), K8 (SPG + GLL), K9 (dense BFGS)

WHOLE = {
    "k7": (k7_geometries, fused_lbfgs.lbfgs_solve_fused,
           fused_lbfgs.lbfgs_solve_plain),
    "k8": (k8_geometries, fused_spg.spg_solve_fused,
           fused_spg.spg_solve_plain),
    "k9": (k9_geometries, fused_bfgs.bfgs_solve_fused,
           fused_bfgs.bfgs_solve_plain),
}
WHOLE_CASES = [(kind, name) for kind, (geos, _, _) in sorted(WHOLE.items())
               for name, g in sorted(geos().items()) if g["kernel"]]


def _whole_operands(kind, g, device, dtype=torch.float64, rows=ROWS):
    """``(objective, box, data)`` of a geometry's kernel form on the card,
    and its x0 repeated to ``rows`` instances."""
    obj, data = g["kernel"]
    n = g["x0"].shape[1]
    x0, _, _ = tiled(g["x0"], np.zeros(n), np.zeros(n), rows)
    box = ()
    if kind == "k8":
        box = interop.tensors_from_numpy(g["lower"], g["upper"],
                                         device=device, dtype=dtype)
    data_t = interop.tensors_from_numpy(*data, device=device, dtype=dtype)
    return obj, x0, box, data_t


@pytest.mark.parametrize("kind,name", WHOLE_CASES)
def test_whole_solve_kernel_matches_plain(kind, name, cuda):
    geos, entry, plain_fn = WHOLE[kind]
    g = geos()[name]
    obj, x0, box, data_t = _whole_operands(kind, g, cuda)

    def plain(x, **kw):
        (xt,) = interop.tensors_from_numpy(x, device=cuda)
        return plain_fn(obj, xt, *box, data_t, **dict(g["opts"], **kw))

    def kernel(x, **kw):
        (xt,) = interop.tensors_from_numpy(x, device=cuda)
        before = entry.launches
        r = entry(obj, xt, *box, data_t, **dict(g["opts"], **kw))
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert r.x.device.type == "cuda"
        return r

    r = kernel(x0)
    x, _, it, st = plain(x0)
    assert torch.equal(r.status, st)
    dit = (r.iterations.long() - it.long()).abs().max().item()
    dx = (r.x - x).abs().max().item()
    if g["chaotic"]:
        # four draws against four: per instance, the kernel's range of
        # counts from x0 and the three starts moved by 1e-15 relative that
        # the plain version's spread is sampled on, against the plain
        # version's range from the same starts, at most 2 apart
        zeros = np.zeros(g["x0"].shape[1])
        ranges = [iteration_ranges(lambda v: kernel(
            tiled(v, zeros, zeros, ROWS)[0]).iterations.cpu().numpy(),
            g["x0"]), iteration_ranges(
            lambda v: plain(v)[2].cpu().numpy(), g["x0"])]
        ranges[1] = tuple(np.resize(a, ROWS) for a in ranges[1])
        gap = int(range_distance(*ranges).max())
        assert gap <= 2, (gap, dit)
        assert dx <= 1e-5
        rc = kernel(x0, max_iter=20)
        xc, _, itc, stc = plain(x0, max_iter=20)
        assert torch.equal(rc.status, stc) and torch.equal(rc.iterations, itc)
        assert (rc.x - xc).abs().max().item() <= 1e-10
    else:
        assert dit == 0 and dx <= 1e-10


def test_k7_resources_at_the_headline(cuda):
    """K7 at its headline shape in float32: 4 blocks of 8 warps per SM (32
    warps, the shared memory's limit) at 64 registers, nothing spilled."""
    info = fused_lbfgs.kernel_info(torch.float32, 10240, 100, 5)
    assert info["warps_per_sm"] == 32, info
    assert info["registers"] <= 64 and info["local_bytes"] == 0, info


@pytest.mark.parametrize("kind", sorted(WHOLE))
def test_whole_solve_float32_quality(kind, cuda):
    """256 x Rosenbrock-100 in float32 (K8: config 3's box quadratic at B =
    256): kernel and plain converge the same fraction, within 0.01 or, for
    K9, the binomial spread."""
    _, entry, plain_fn = WHOLE[kind]
    rng = np.random.RandomState(42)
    if kind == "k8":
        n = 64
        obj = problems.weighted_squares()
        data = interop.tensors_from_numpy(np.logspace(0, 3, n), np.zeros(n),
                                          device=cuda, dtype=torch.float32)
        box = (torch.full((n,), -2.0, device=cuda),
               torch.full((n,), 2.0, device=cuda))
        kw = dict(tol=1e-4, max_iter=1000, max_iter_ls=30)
    elif kind == "k7":
        n, obj, data, box = 100, problems.rosenbrock(), (), ()
        kw = dict(m=5, tol=1e-3, max_iter=600, max_iter_ls=16)
    else:
        n, obj, data, box = 100, problems.rosenbrock(), (), ()
        kw = dict(tol=1e-5, max_iter=600, max_iter_ls=24)
    x0 = torch.tensor(rng.uniform(-2, 2, (256, n)), dtype=torch.float32,
                      device=cuda)
    r = entry(obj, x0, *box, data, **kw)
    _, _, _, st = plain_fn(obj, x0, *box, data, **kw)
    ck = (r.status == 1).float().mean().item()
    cp = (st == 1).float().mean().item()
    # K9's 2-norm test at 1e-5 sits at float32's gradient noise near x* = 1
    # (it converges ~0.47): whether an instance passes is decided by its
    # rounding, independently in kernel and plain, so the fractions are
    # held to three standard deviations of their difference (0.01 where
    # nearly every instance converges)
    atol = max(0.01, 3.0 * math.sqrt(2.0 * cp * (1.0 - cp) / x0.shape[0]))
    assert abs(ck - cp) <= atol, (ck, cp, atol)
    assert bool(torch.isfinite(r.f).all())


def test_whole_solve_routes_launch_the_kernels(cuda):
    """A CUDA x0, and a non-tensor x0 (which goes to the card), launch the
    kernel once per call."""
    g7, g8, g9 = (k7_geometries()["example_bfgs"],
                  k8_geometries()["active_bound"],
                  k9_geometries()["example_bfgs"])
    calls = [
        (fused_lbfgs.lbfgs_solve_fused, g7["objective"], (), dict(m=5)),
        (fused_spg.spg_solve_fused, g8["objective"],
         (g8["lower"], g8["upper"]), {}),
        (fused_bfgs.bfgs_solve_fused, g9["objective"], (), {}),
    ]
    for (entry, obj, box, kw), g in zip(calls, (g7, g8, g9)):
        for x0 in (torch.tensor(g["x0"], device=cuda), g["x0"]):
            before = entry.launches
            r = entry(obj, x0, *box, **kw)
            torch.cuda.synchronize()
            assert entry.launches == before + 1
            assert r.x.device.type == "cuda" and (r.status == 1).all()


def test_whole_solve_kernels_refuse_rather_than_fall_back(cuda, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for mod, fn in ((fused_lbfgs, "lbfgs_solve_plain"),
                    (fused_spg, "spg_solve_plain"),
                    (fused_bfgs, "bfgs_solve_plain")):
        monkeypatch.setattr(mod, fn, plain)
    x0 = torch.zeros((4, 2), dtype=torch.float64, device=cuda)
    box = (torch.full((2,), -1.0, device=cuda),
           torch.full((2,), 1.0, device=cuda))
    entries = [(fused_lbfgs.lbfgs_solve_fused, ()),
               (fused_spg.spg_solve_fused, box),
               (fused_bfgs.bfgs_solve_fused, ())]
    for entry, b in entries:
        before = entry.launches
        with pytest.raises(NotImplementedError, match="EXP_BOWL"):
            entry(problems.exp_bowl(), x0, *b)
        with pytest.raises(NotImplementedError, match="kernel_form"):
            entry(lambda x: (x * x).sum(), x0, *b)
        assert entry.launches == before
    with pytest.raises(NotImplementedError, match="compiles the functors"):
        fused_spg.spg_solve_fused(problems.quadratic(np.eye(2)), x0, *box)
    with pytest.raises(ValueError, match="shared memory"):
        fused_lbfgs.lbfgs_solve_fused(
            problems.rosenbrock(),
            torch.zeros((2, 3000), dtype=torch.float64, device=cuda), m=20)
    with pytest.raises(ValueError, match="m must lie"):
        fused_lbfgs.lbfgs_solve_fused(problems.rosenbrock(), x0, m=21)


def test_whole_solve_size_mirrors_match_the_library(cuda):
    """K7's and K8's shared memory per instance and K9's shared memory and
    workspace are sized in Python; they must equal the kernels' own
    formulas."""
    lib = _build.load()
    for n in (1, 2, 31, 100, 1000, 4000):
        for itemsize in (4, 8):
            for m in (1, 5, 10, 20):
                assert fused_lbfgs.smem_per_instance(n, m, itemsize) == (
                    lib.lbfgs_fused_smem_per_warp(n, m, itemsize))
            for gll_m in (1, 10, 33):
                assert fused_spg.smem_per_instance(n, gll_m, itemsize) == (
                    lib.spg_fused_smem_per_warp(n, gll_m, itemsize))
    for n in (1, 100, 232, 233, 332, 333, 1000):
        for itemsize in (4, 8):
            for rows in (0, 40, 512):
                assert fused_bfgs.smem_per_instance(n, itemsize, rows) == (
                    lib.bfgs_fused_smem(n, rows, itemsize))
                for B in (1, 1024, 10240):
                    assert fused_bfgs.workspace_elems(B, n, itemsize, rows) == (
                        lib.bfgs_fused_workspace_elems(B, n, rows, itemsize))


# ---- the dense slabs of K3's dense form and K9: both placements ----------

# every update kind, QN and QNB, with the restart and scale_b0 forms; on a
# weighted-squares quadratic (whose counts do not move under rounding; the
# starts and the minimizer inside the box, so every case converges) at a
# width whose slab lies in shared memory (24) and one past the fit (240,
# float64: the slab in the workspace).  BFGSB + MoreThuenteB is left to
# the geometries (n = 8): its running step cap, the smallest feasible step
# of every iteration so far, stalls it at these widths (400 iterations,
# not converged, in the plain version too)
DENSE_CASES = {
    "bfgs_mt": (lambda: solvers.BFGS(tol=1e-8), ls.MoreThuente, False),
    "dfp_bt": (lambda: solvers.DFP(tol=1e-8), ls.BackTracking, False),
    "broyden_bt": (lambda: solvers.Broyden(tol=1e-8), ls.BackTracking, False),
    "sr1_hz": (lambda: solvers.QuasiNewton(tol=1e-8, update="sr1"),
               ls.HagerZhang, False),
    "bfgs_robust_mt": (lambda: solvers.QuasiNewton(
        tol=1e-8, update="bfgs", scale_b0=True, restart_on_degeneracy=True),
        ls.MoreThuente, False),
    "bfgsb_hzb": (lambda: solvers.BFGSB(tol=1e-8), ls.HagerZhangB, True),
    "dfpb_btb": (lambda: solvers.DFPB(tol=1e-8), ls.BackTrackingB, True),
    "broydenb_hzb": (lambda: solvers.BroydenB(tol=1e-8), ls.HagerZhangB,
                     True),
    "sr1b_btb": (lambda: solvers.SR1B(tol=1e-8), ls.BackTrackingB, True),
}
DENSE_WIDTHS = {24: "shared", 240: "workspace"}


def _dense_operands(n, device, seed):
    d = np.linspace(1.0, 50.0, n)
    t = np.linspace(-0.5, 2.0, n)
    x0 = np.random.RandomState(seed).uniform(-2.0, 2.0, (8, n))
    return (x0, *interop.tensors_from_numpy(d, t, device=device))


@pytest.mark.parametrize("n", sorted(DENSE_WIDTHS))
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_form_matches_plain_in_both_placements(name, n, cuda):
    """K3's dense form against its plain version in float64 with the slab
    in shared memory and in the workspace: status equal, iterations within
    max(1, the plain version's spread) (the kernel's sums round otherwise,
    and the 2-norm test at 1e-8 may pass one iteration apart), x within
    2e-8 (each run within ||g|| / min d = 1e-8 of the minimizer); the
    placement counter of the placement the fit rule names moves by one."""
    make_method, make_search, bounded = DENSE_CASES[name]
    method, search = make_method(), make_search()
    spec = fused_driver.build_spec(method, search)
    x0_np, d, t = _dense_operands(n, cuda, n)
    (x0,) = interop.tensors_from_numpy(x0_np, device=cuda)
    lo = up = None
    if bounded:
        lo, up = interop.tensors_from_numpy(np.full(n, -2.5), np.full(n, 2.5),
                                            device=cuda)
    obj = problems.weighted_squares()
    kw = dict(max_iter=400, max_iter_ls=40)
    where = DENSE_WIDTHS[n]
    assert fused_driver.dense_in_shared(n, spec.ring, 8, spec.qn_update) == (
        where == "shared")
    before = dict(fused_driver.fused_minimize.placements)
    x, f, it, st, nfev = fused_driver._launch_cuda(spec, obj, x0, lo, up,
                                                   (d, t), **kw)
    torch.cuda.synchronize()
    after = fused_driver.fused_minimize.placements
    assert after[where] == before[where] + 1
    assert sum(after.values()) == sum(before.values()) + 1

    def plain(v):
        (xt,) = interop.tensors_from_numpy(v, device=cuda)
        return fused_driver.fused_minimize_plain(method, search, obj, xt, lo,
                                                 up, (d, t), **kw)

    xp, fp, itp, stp, _ = plain(x0_np)
    spread = perturbation_spread(lambda v: plain(v)[2].cpu().numpy(), x0_np,
                                 runs=3)
    assert torch.equal(st, stp) and bool((st == 1).all())
    dit = (it.long() - itp.long()).abs().max().item()
    assert dit <= max(1, spread), (dit, spread)
    torch.testing.assert_close(x, xp, rtol=0, atol=2e-8)


@pytest.mark.parametrize("n", sorted(DENSE_WIDTHS))
def test_k9_matches_plain_in_both_placements(n, cuda):
    """K9 against its plain version in float64 with the triangle in shared
    memory and in the workspace, with the tolerances of the dense form's
    test above; the placement counter moves."""
    x0_np, d, t = _dense_operands(n, cuda, 9 * n)
    (x0,) = interop.tensors_from_numpy(x0_np, device=cuda)
    obj = problems.weighted_squares()
    kw = dict(tol=1e-8, max_iter=400, max_iter_ls=24, c1=1e-4)
    where = DENSE_WIDTHS[n]
    assert fused_bfgs.slab_in_shared(n, 8) == (where == "shared")
    before = dict(fused_bfgs.bfgs_solve_fused.placements)
    x, f, it, st, _, upd = fused_bfgs._launch_cuda(obj, x0, (d, t), **kw)
    torch.cuda.synchronize()
    assert fused_bfgs.bfgs_solve_fused.placements[where] == before[where] + 1
    xp, fp, itp, stp = fused_bfgs.bfgs_solve_plain(obj, x0, (d, t), **kw)
    assert torch.equal(st, stp) and bool((st == 1).all())
    assert (it.long() - itp.long()).abs().max().item() <= 1
    assert bool((upd > 0).all())
    torch.testing.assert_close(x, xp, rtol=0, atol=2e-8)


def test_dense_launch_failures_raise_rather_than_fall_back(cuda,
                                                           monkeypatch):
    """A launch the kernel refuses raises RuntimeError: no plain version,
    no other placement, no count."""
    import dataclasses

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(fused_driver, "_solve_plain", plain)
    monkeypatch.setattr(fused_bfgs, "bfgs_solve_plain", plain)
    x0 = torch.zeros((2, 240), dtype=torch.float64, device=cuda)
    rosen = problems.rosenbrock()
    k3_before = (fused_driver.fused_minimize.launches,
                 dict(fused_driver.fused_minimize.placements))
    k9_before = (fused_bfgs.bfgs_solve_fused.launches,
                 dict(fused_bfgs.bfgs_solve_fused.placements))
    # an update kind the kernel does not know
    spec = dataclasses.replace(
        fused_driver.build_spec(solvers.BFGS(), ls.MoreThuente()),
        qn_update=7)
    with pytest.raises(RuntimeError, match="driver_launch failed"):
        fused_driver._launch_cuda(spec, rosen, x0[:, :24], None, None, (),
                                  5, 5)
    # no workspace where the triangle does not fit shared memory
    monkeypatch.setattr(fused_bfgs, "workspace_elems",
                        lambda B, n, i, rows=0: 0)
    with pytest.raises(RuntimeError, match="bfgs_fused_launch failed"):
        fused_bfgs.bfgs_solve_fused(rosen, x0, max_iter=5)
    assert (fused_driver.fused_minimize.launches,
            fused_driver.fused_minimize.placements) == k3_before
    assert (fused_bfgs.bfgs_solve_fused.launches,
            fused_bfgs.bfgs_solve_fused.placements) == k9_before


# ---- the quadratic and log-sum-exp functors of K1, K3's quasi-Newton,
# Wolfe and dense forms and K9, float64, against their plain versions with
# the tolerances of test_torch_data_functors.py (there against the JAX
# kernels): K1 status equal, x within 1e-6, counts within max(2, spread);
# K3 and K9 per instance over their first 15 iterations, status and counts
# equal, x within 1e-9 or ten times the plain version's own spread.  K3's
# methods take tol 1e-13 here, so that no stopping test is decided inside
# the horizon

DATA_K1_OPTS = dict(m=5, pgtol=1e-8, factr=10.0, max_iter=200)
DATA_BOXED = ["lse_rows40_n24", "lse_rows20_n40", "quad_config5_n16",
              "quad_nonsymmetric"]
DATA_UNBOXED = ["lse_rows40_n16", "quad_config5_n16", "quad_nonsymmetric"]
DATA_K3_METHODS = {
    "lbfgs_hz": (lambda: solvers.LBFGS(tol=1e-13), ls.HagerZhang, False),
    "ncg_mt": (lambda: solvers.NonlinearCG(grad_tol=1e-13), ls.MoreThuente,
               False),
    "bfgs_mt": (lambda: solvers.BFGS(tol=1e-13), ls.MoreThuente, False),
    "bfgsb_mtb": (lambda: solvers.BFGSB(tol=1e-13), ls.MoreThuenteB, True),
}


def _data_case(name, cuda, batch=ROWS):
    obj, _, x0, lo, up = data_functor_case(name, batch)
    return (obj, x0, *interop.tensors_from_numpy(x0, lo, up, device=cuda))


def _x_at(solve, cuda):
    """``solve``'s x at a numpy start, on the card, as a numpy array."""
    return lambda v: solve(interop.tensors_from_numpy(
        v, device=cuda)[0])[0].cpu().numpy()


@pytest.mark.parametrize("name", DATA_BOXED)
def test_data_functor_k1_matches_plain(name, cuda):
    obj, x0, tx0, tlo, tup = _data_case(name, cuda)
    r = fused_lbfgsb.lbfgsb_solve_fused(obj, tx0, tlo, tup, **DATA_K1_OPTS)
    xp, _, itp, stp = fused_lbfgsb.lbfgsb_solve_plain(obj, tx0, tlo, tup,
                                                      **DATA_K1_OPTS)
    spread = perturbation_spread(
        lambda v: fused_lbfgsb.lbfgsb_solve_plain(
            obj, interop.tensors_from_numpy(v, device=cuda)[0], tlo, tup,
            **DATA_K1_OPTS)[2].cpu().numpy(), x0)
    assert torch.equal(r.status, stp)
    assert (r.x - xp).abs().max().item() <= 1e-6
    assert (r.iterations.long() - itp.long()).abs().max().item() <= max(
        2, spread)


# BFGS + More-Thuente on the non-symmetric quadratic is left to the CPU
# tests (against JAX's K3 and through the emulator): on the card the plain
# version, whose sums cuBLAS orders, ended 2 of 64 searches with ||s|| <
# 1e-13 within 15 iterations, where the kernel and the plain version on
# the CPU go on (max|g| > 1e-8 there)
@pytest.mark.parametrize("method_name,name", [
    (m, c) for m in sorted(DATA_K3_METHODS)
    for c in (DATA_BOXED if DATA_K3_METHODS[m][2] else DATA_UNBOXED)
    if (m, c) != ("bfgs_mt", "quad_nonsymmetric")])
def test_data_functor_k3_forms_match_plain(method_name, name, cuda):
    make, search, bounded = DATA_K3_METHODS[method_name]
    method, search = make(), search()
    obj, x0, tx0, tlo, tup = _data_case(name, cuda)
    box = (tlo, tup) if bounded else (None, None)
    spec = fused_driver.build_spec(method, search)
    x, f, it, st, nfev = fused_driver._launch_cuda(spec, obj, tx0, *box, (),
                                                   15, 20)

    def plain(v):
        return fused_driver.fused_minimize_plain(method, search, obj, v, *box,
                                                 (), max_iter=15,
                                                 max_iter_ls=20)

    xp, fp, itp, stp, _ = plain(tx0)
    spread = x_spread(_x_at(plain, cuda), x0)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert (x - xp).abs().max().item() <= max(1e-9, 10 * spread)


@pytest.mark.parametrize("name,max_iter", [("lse_rows40_n16", 200),
                                           ("lse_rows40_n24", 15)])
def test_data_functor_k9_matches_plain(name, max_iter, cuda):
    """K9 on the log-sum-exp: the bounded-below case as a full solve, the
    weakly unbounded one over 15 iterations."""
    obj, x0, tx0, _, _ = _data_case(name, cuda)
    kw = dict(tol=1e-8, max_iter=max_iter, max_iter_ls=24, c1=1e-4)
    x, _, it, st, _, _ = fused_bfgs._launch_cuda(obj, tx0, (), **kw)

    def plain(v):
        return fused_bfgs.bfgs_solve_plain(obj, v, (), **kw)

    xp, _, itp, stp = plain(tx0)
    spread = x_spread(_x_at(plain, cuda), x0)
    assert torch.equal(st, stp) and torch.equal(it, itp)
    assert (x - xp).abs().max().item() <= max(1e-9, 10 * spread)


def test_data_functor_routes_launch_the_kernels(cuda):
    """On a CUDA x0: minimize(method="lbfgsb") sends the quadratic and the
    log-sum-exp to K1 within its fit, batch_minimize sends them to K3's
    quasi-Newton, Wolfe and dense forms, and an Armijo first-order method on
    them runs the lockstep loop (no launch)."""
    k1 = fused_lbfgsb.lbfgsb_solve_fused
    k2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    k3 = fused_driver.fused_minimize
    for name in ("lse_rows40_n24", "quad_config5_n16"):
        obj, _, tx0, tlo, tup = _data_case(name, cuda, batch=8)
        before = (k1.launches, k2.launches, k3.launches)
        minimize(obj, tx0, method="lbfgsb", bounds=(tlo, tup), max_iter=5)
        for method, search in ((solvers.LBFGS(), ls.HagerZhang()),
                               (solvers.NonlinearCG(), ls.MoreThuente()),
                               (solvers.BFGS(), ls.MoreThuente())):
            solvers.batch_minimize(method, search, make_oracle(obj), tx0,
                                   max_iter=5)
        torch.cuda.synchronize()
        assert (k1.launches, k2.launches, k3.launches) == (
            before[0] + 1, before[1], before[2] + 3)
        r = minimize(obj, tx0, method="gd", max_iter=5)
        assert k3.launches == before[2] + 3 and r.x.device.type == "cuda"
    # K9 takes the log-sum-exp
    obj, _, tx0, _, _ = _data_case("lse_rows40_n16", cuda, batch=8)
    before = fused_bfgs.bfgs_solve_fused.launches
    fused_bfgs.bfgs_solve_fused(obj, tx0, max_iter=5)
    assert fused_bfgs.bfgs_solve_fused.launches == before + 1
