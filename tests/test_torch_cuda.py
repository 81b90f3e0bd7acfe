"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one.  The file imports no JAX, so it runs where only the port
is installed; without the repository's JAX conftest and the xdist default:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances (float64): status equal per instance, x within 1e-6, iteration
counts within ``max(2, spread)`` with ``spread`` the plain version's own
range under a 1e-15 relative change of x0 (see ``_torch_geometries``).
"""

import numpy as np
import pytest
import torch

from _torch_geometries import k1_geometries, perturbation_spread, tiled
from optimization_solvers_tpu_torch import interop, minimize, problems
from optimization_solvers_tpu_torch.ops import fused_lbfgsb

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
    is refused rather than run elsewhere."""
    x0 = torch.zeros((8, 12), dtype=torch.float64, device=cuda)
    before = fused_lbfgsb.lbfgsb_solve_fused.launches
    r = minimize(problems.rosenbrock(), x0, method="lbfgsb",
                 bounds=(-1.5, 1.5), tol=1e-7, factr=10.0)
    assert fused_lbfgsb.lbfgsb_solve_fused.launches == before + 1
    assert r.x.device.type == "cuda" and (r.status == 1).all()
    with pytest.raises(NotImplementedError, match="kernel_form"):
        minimize(lambda x: x.sum(), x0, method="lbfgsb", bounds=(-1.0, 1.0))


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
