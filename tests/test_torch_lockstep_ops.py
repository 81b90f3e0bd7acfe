"""The port's kernels of the lockstep loop, K5 (fused dense quasi-Newton
update) and K6 (batched Cholesky solve), and the ``ops.linalg`` seam, on
the CPU against the JAX package.

The references are JAX's Pallas kernels in interpret mode
(``qn_update_direction_pallas``, ``cholesky_solve_pallas``), as
``tests/test_ops.py`` runs them; the port's plain versions run on CPU
tensors (the CUDA kernels are held against them on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances (float64): B' and B' g within 1e-10 abs (entries of size ~30;
the two sum in other orders), and the skipped instance's B exactly
unchanged; the solves within 1e-10 abs, and a non-positive-definite
instance all NaN.  The fused lockstep quasi-Newton step equals the unfused
one (``tests/test_ops.py:79-105``): iterations and status equal, x within
1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_geometries import qn_update_arrays, spd_arrays
from optimization_solvers_tpu.ops.pallas_newton import cholesky_solve_pallas
from optimization_solvers_tpu.ops.pallas_qn import qn_update_direction_pallas
from optimization_solvers_tpu_torch import (interop, linesearch as ls, ops,
                                            problems, solvers)
from optimization_solvers_tpu_torch.core.oracle import make_oracle
from optimization_solvers_tpu_torch.ops import fused_newton, fused_qn, linalg

torch.set_num_threads(1)

KINDS = ("bfgs", "dfp", "broyden", "sr1")


@pytest.mark.parametrize("kind", KINDS)
def test_qn_update_plain_matches_jax_kernel(kind):
    Bm, s, y, g = qn_update_arrays(3, 16)
    jBn, jBg = qn_update_direction_pallas(
        *(jnp.asarray(a) for a in (Bm, s, y, g)), tol=1e-8, kind=kind,
        interpret=True)
    tB, ts, ty, tg = interop.tensors_from_numpy(Bm, s, y, g)
    skip = fused_qn.skip_mask(ts, ty, 1e-8)
    assert skip.tolist() == [False, True, False]
    Bn, Bg = fused_qn.qn_update_direction_plain(tB, ts, ty, tg, skip,
                                                kind=kind)
    np.testing.assert_allclose(Bn.numpy(), np.asarray(jBn), rtol=0,
                               atol=1e-10, err_msg=kind)
    np.testing.assert_allclose(Bg.numpy(), np.asarray(jBg), rtol=0,
                               atol=1e-10, err_msg=kind)
    np.testing.assert_array_equal(Bn[1].numpy(), Bm[1])
    # the wrapper decides the skip from tol, on CPU tensors by the plain
    # version, and takes one instance too
    Bf, Bgf = fused_qn.qn_update_direction_fused(tB, ts, ty, tg, tol=1e-8,
                                                 kind=kind)
    assert torch.equal(Bf, Bn) and torch.equal(Bgf, Bg)
    B0, Bg0 = fused_qn.qn_update_direction_fused(tB[0], ts[0], ty[0], tg[0],
                                                 tol=1e-8, kind=kind)
    torch.testing.assert_close(B0, Bn[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(Bg0, Bg[0], rtol=0, atol=1e-12)


def test_qn_update_refusals():
    tB, ts, ty, tg = interop.tensors_from_numpy(*qn_update_arrays(3, 4))
    with pytest.raises(ValueError, match="kind must be one of"):
        fused_qn.qn_update_direction_fused(tB, ts, ty, tg, kind="lbfgs")
    assert fused_qn.qn_update_direction_fused.launches == 0
    assert ops.qn_update_direction_fused is fused_qn.qn_update_direction_fused


def test_cholesky_plain_matches_jax_kernel():
    H, g = spd_arrays(4, 24)
    ref = np.asarray(cholesky_solve_pallas(jnp.asarray(H), jnp.asarray(g),
                                           interpret=True))
    tH, tg = interop.tensors_from_numpy(H, g)
    x = fused_newton.cholesky_solve_plain(tH, tg)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=1e-10)
    # several panels, a ragged last one, and a single instance
    x4 = fused_newton.cholesky_solve_plain(tH, tg, panel=5)
    np.testing.assert_allclose(x4.numpy(), ref, rtol=0, atol=1e-10)
    x1 = fused_newton.cholesky_solve_fused(tH[2], tg[2])
    np.testing.assert_allclose(x1.numpy(), ref[2], rtol=0, atol=1e-10)
    # only the lower triangle is read, and H is not written
    upper = tH.clone()
    upper.triu_(1).mul_(7.0)
    tH_mixed = torch.tril(tH) + upper
    before = tH_mixed.clone()
    np.testing.assert_allclose(
        fused_newton.cholesky_solve_plain(tH_mixed, tg).numpy(), ref,
        rtol=0, atol=1e-10)
    assert torch.equal(tH_mixed, before)


@pytest.mark.parametrize("panel", [32, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 65, 100])
def test_cholesky_plain_panels_match_jax_kernel(n, panel):
    """The plain version at the kernel's panel widths (64 in float32, 32 in
    float64; ``fused_newton.PANEL``), ragged widths, one instance not
    positive definite: within 1e-10 of JAX's K6, that instance all NaN."""
    H, g = spd_arrays(3, n, seed=n, non_pd=1)
    ref = np.asarray(cholesky_solve_pallas(jnp.asarray(H), jnp.asarray(g),
                                           interpret=True))
    tH, tg = interop.tensors_from_numpy(H, g)
    x = fused_newton.cholesky_solve_plain(tH, tg, panel=panel).numpy()
    assert np.isnan(ref[1]).all() and np.isnan(x[1]).all()
    np.testing.assert_allclose(x[[0, 2]], ref[[0, 2]], rtol=0, atol=1e-10)
    assert panel in fused_newton.PANEL.values()


def test_cholesky_kernel_takes_every_width_it_took():
    """The blocked kernel's shared memory does not grow with the panel: it
    takes every width the panel-in-shared-memory kernel took (nb n + n + nb
    elements for some nb in 32, 16, ..., 1), up to 29,055 in float32 and
    14,527 in float64."""
    for itemsize, last in ((4, 29055), (8, 14527)):
        took = [n for n in range(1, 40000) if any(
            (nb * n + n + nb) * itemsize <= fused_newton.SMEM_PER_BLOCK
            for nb in (32, 16, 8, 4, 2, 1))]
        assert took[-1] == last
        assert all(fused_newton.panel_width(n, itemsize) for n in took)
    assert fused_newton.panel_width(1024, 4) == 64
    assert fused_newton.panel_width(1024, 8) == 32


def test_cholesky_non_pd_instance_is_nan_everywhere():
    H, g = spd_arrays(4, 24, non_pd=2)
    ref = np.asarray(cholesky_solve_pallas(jnp.asarray(H), jnp.asarray(g),
                                           interpret=True))
    tH, tg = interop.tensors_from_numpy(H, g)
    x = fused_newton.cholesky_solve_plain(tH, tg).numpy()
    assert np.isnan(ref[2]).all() and np.isnan(x[2]).all()
    np.testing.assert_allclose(x[[0, 1, 3]], ref[[0, 1, 3]], rtol=0,
                               atol=1e-10)
    # the library path gives NaN for that instance too, without raising
    lib = linalg.cholesky_solve(tH, tg).numpy()
    assert np.isnan(lib[2]).all()
    np.testing.assert_allclose(lib[[0, 1, 3]], ref[[0, 1, 3]], rtol=0,
                               atol=1e-10)


def test_linalg_switch(monkeypatch):
    H, g = spd_arrays(3, 10, seed=4)
    tH, tg = interop.tensors_from_numpy(H, g)
    calls = []
    orig = fused_newton.cholesky_solve_fused

    def spy(h, v):
        calls.append(h.shape)
        return orig(h, v)

    monkeypatch.setattr(fused_newton, "cholesky_solve_fused", spy)
    assert linalg.config.use_kernel is False and (
        linalg.config.max_kernel_n == 512)
    lib = linalg.cholesky_solve(tH, tg)
    assert calls == []
    # None: the kernel on CUDA tensors only, so the library here
    monkeypatch.setattr(linalg.config, "use_kernel", None)
    torch.testing.assert_close(linalg.solve_spd(tH, tg), lib, rtol=0,
                               atol=0)
    assert calls == []
    monkeypatch.setattr(linalg.config, "use_kernel", True)
    kern = linalg.cholesky_solve(tH, tg)
    assert calls == [(3, 10, 10)]
    torch.testing.assert_close(kern, lib, rtol=0, atol=1e-12)
    assert ops.config is linalg.config


@pytest.mark.parametrize("bounded", [False, True], ids=["qn", "qnb"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_qn_solver_matches_unfused(kind, bounded):
    """``QuasiNewton(fused=True)`` takes the same steps as ``fused=False``
    (``tests/test_ops.py:79-105``), here on Rosenbrock-6 in a batch of 4."""
    x0 = np.random.RandomState(6).uniform(-1.5, 1.5, (4, 6))
    (tx0,) = interop.tensors_from_numpy(x0)
    oracle = make_oracle(problems.rosenbrock())
    cls = solvers.QuasiNewtonB if bounded else solvers.QuasiNewton
    search = ls.MoreThuenteB() if bounded else ls.MoreThuente()
    bounds = (torch.full((6,), -1.2, dtype=torch.float64),
              torch.full((6,), 2.0, dtype=torch.float64)) if bounded else None
    r = [solvers.batch_minimize(cls(tol=1e-8, update=kind, fused=fused),
                                search, oracle, tx0, bounds=bounds,
                                fused=False, max_iter=60)
         for fused in (False, True)]
    np.testing.assert_array_equal(r[0].iterations.numpy(),
                                  r[1].iterations.numpy())
    np.testing.assert_array_equal(r[0].status.numpy(), r[1].status.numpy())
    np.testing.assert_allclose(r[1].x.numpy(), r[0].x.numpy(), rtol=0,
                               atol=1e-12)
    assert fused_qn.qn_update_direction_fused.launches == 0
