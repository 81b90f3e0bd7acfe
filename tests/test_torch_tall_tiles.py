"""The premises of the tall kernel K2's design on Hopper, on the CPU.

* The bisection of the Cauchy point reads only its bracket: the emulation
  in ``tests/_torch_bracket.py`` (the kernel's bookkeeping of carried sums
  and a compacted coordinate list) is held against the plain version's
  full-pass probes (``fused_lbfgsb_tall._cauchy_bisection``) at every call
  the plain solver makes on every ``k2_geometries()`` entry: the same
  segment at every probe, f1 and f2 within 1e-12 relative (only the order
  of summation differs), and the same Cauchy point (``t_lo`` equal, ``dtm``
  within 1e-12 relative) and guard flag.
* A tile of instances runs in lockstep without changing any instance's
  result: JAX's K2 in interpret mode at ``tile=1`` and ``tile=8`` on a
  bounded geometry with per-instance boxes gives the same status and
  iteration counts and x within 1e-12.
* The wrapper's choice of the tile from the batch and the SM count.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bracket import bracket_bisection
from _torch_geometries import k2_geometries, tiled
from optimization_solvers_tpu.ops import pallas_lbfgsb_tall as jk2
from optimization_solvers_tpu_torch import interop
from optimization_solvers_tpu_torch.ops import fused_lbfgsb_tall

REL = 1e-12


def _close(a, b):
    return a == b or abs(a - b) <= REL * abs(b)


@pytest.mark.parametrize("line_search", ["armijo", "dcsrch"])
@pytest.mark.parametrize("name", sorted(k2_geometries()))
def test_bracket_bisection_matches_full_pass(name, line_search,
                                             monkeypatch):
    full = fused_lbfgsb_tall._cauchy_bisection
    seen = dict(instances=0, probes=0, reads=0, full_reads=0)

    def both(tb, g, z, Y, S, th, M, active, **kw):
        trace = []
        t_lo_fin, dtm, flag = full(tb, g, z, Y, S, th, M, active,
                                   trace=trace, **kw)
        for b in range(tb.shape[0]):
            if not bool(active[b]):
                continue
            probes, t_fin, dt, multimodal, reads = bracket_bisection(
                tb[b], g[b], z[b], Y[b], S[b], float(th[b]), M[b],
                eps=kw["eps"], bisect_iters=kw["bisect_iters"],
                gcp_guard_maxseg=kw["gcp_guard_maxseg"])
            ref = [tuple(float(v[b]) for v in p[1:]) for p in trace
                   if bool(p[0][b])]
            assert len(probes) == len(ref), (b, probes, ref)
            for (t_lo, t_hi, f1, f2), (r_lo, r_hi, r1, r2) in zip(probes,
                                                                  ref):
                assert (t_lo, t_hi) == (r_lo, r_hi)
                assert _close(f1, r1) and _close(f2, r2), (f1, r1, f2, r2)
            assert t_fin == float(t_lo_fin[b])
            assert _close(dt, float(dtm[b]))
            if flag is not None:
                assert multimodal == bool(flag[b])
            seen["instances"] += 1
            seen["probes"] += len(probes)
            seen["reads"] += sum(reads)
            seen["full_reads"] += len(probes) * int((tb[b] > 0).sum())
        return t_lo_fin, dtm, flag

    monkeypatch.setattr(fused_lbfgsb_tall, "_cauchy_bisection", both)
    obj, x0, lo, up, data, opts = k2_geometries()[name]
    tx0, tlo, tup, *tdata = interop.tensors_from_numpy(x0, lo, up, *data)
    fused_lbfgsb_tall.lbfgsb_solve_tall_plain(
        obj, tx0, tlo, tup, tuple(tdata), line_search=line_search, **opts)
    assert seen["instances"] > 0
    if name == "lse_config4_class":
        # the config-4 class bisects every iteration; its probes read well
        # under half the moving coordinates
        assert seen["probes"] > 100
        assert seen["reads"] <= 0.5 * seen["full_reads"], seen


def test_lockstep_tile_changes_no_instance():
    """JAX's K2 (interpret mode) at tile 1 and tile 8: every loop of a tile
    runs while any lane is open and every write is masked per lane, so
    each instance computes what it computes alone."""
    _, x0, lo, up, data, opts = k2_geometries()["per_lane_boxes"]
    x0, lo, up = tiled(x0, lo, up, 8)

    def f(x, d):
        return 0.5 * jnp.sum(d * (x - 1.5) ** 2)

    def solve(tile):
        return jk2.lbfgsb_solve_fused_tall(
            f, jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(up),
            consts=(jnp.asarray(data[0]),), tile=tile, interpret=True,
            **opts)

    one, eight = solve(1), solve(8)
    np.testing.assert_array_equal(np.asarray(one.status),
                                  np.asarray(eight.status))
    np.testing.assert_array_equal(np.asarray(one.iterations),
                                  np.asarray(eight.iterations))
    np.testing.assert_allclose(np.asarray(one.x), np.asarray(eight.x),
                               rtol=0, atol=1e-12)
    assert (np.asarray(one.status) == 1).all()
    # the tile's instances finish apart: lockstep waits, nothing else
    assert len(set(np.asarray(one.iterations).tolist())) > 1


@pytest.mark.parametrize("B, sms, tile", [
    (512, 132, 4), (1, 132, 1), (132, 132, 1), (133, 132, 2),
    (10_240, 132, 4), (7, 2, 4), (64, 114, 1)])
def test_tile_fills_the_card(B, sms, tile):
    t = fused_lbfgsb_tall.tile_for(B, sms)
    assert t == tile
    assert 1 <= t <= fused_lbfgsb_tall.MAX_TILE
    if t < fused_lbfgsb_tall.MAX_TILE:
        assert math.ceil(B / t) <= sms


def test_cpu_takes_the_plain_version_at_any_batch():
    """The tile is a property of the CUDA launch only: a CPU call runs the
    plain version and records no tile."""
    obj, x0, lo, up, data, opts = k2_geometries()["per_lane_boxes"]
    before = (fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches,
              fused_lbfgsb_tall.lbfgsb_solve_fused_tall.last_tile)
    tx0, tlo, tup, *tdata = interop.tensors_from_numpy(
        x0[:3], lo[:3], up[:3], *data)
    r = fused_lbfgsb_tall.lbfgsb_solve_fused_tall(obj, tx0, tlo, tup,
                                                  tuple(tdata), **opts)
    assert (r.status == 1).all() and r.x.shape == (3, 24)
    assert before == (fused_lbfgsb_tall.lbfgsb_solve_fused_tall.launches,
                      fused_lbfgsb_tall.lbfgsb_solve_fused_tall.last_tile)
    assert isinstance(r.x, torch.Tensor) and r.x.device.type == "cpu"
