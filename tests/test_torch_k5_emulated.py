"""The CUDA kernel K5's own source on the CPU: ``ops/csrc/qn_update.cu``
built with the host compiler against the warp emulator
(``tests/_torch_warp_emulator.py``: the 8 warps of a block meet at block
barriers and take turns between them in a seeded order; the asynchronous
copy of B into shared memory is a plain copy there) and held against the
plain version ``qn_update_direction_plain``: all four rules, an instance
whose pair is skipped and instances whose pairs are not, float64 and
float32, with the card's tolerances (``K5_RTOL`` of ``chip_smoke.py``:
max |d| over the largest entry 1e-12 in float64, 1e-5 in float32).  Each
case runs twice, the warps taking turns lowest first and then highest
first, and both must give the same bits: a warp that read what another
writes between the same two barriers shows there.  The shared placement
(n = 5, 33, 100; B staged in shared memory), the workspace placement past
the fit, a B that is not 16-byte aligned (the copy's and the stores' ends),
and the fit rule the wrapper mirrors.
"""

import pytest
import torch

import _torch_warp_emulator as emulator
from _torch_geometries import qn_update_arrays
from optimization_solvers_tpu_torch.ops import fused_qn

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
SEEDS = (1, 2)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    return emulator.build_k5(str(tmp_path_factory.mktemp("k5_emulated")))


def held(k5, Bm, s, y, g, B_ref=None):
    """Every rule through the emulated kernel under both warp orders,
    against the plain version on the same inputs (``B_ref``: ``Bm``'s
    values where ``Bm`` is a view the plain version need not see)."""
    B_ref = Bm if B_ref is None else B_ref
    skip = fused_qn.skip_mask(s, y, 1e-8)
    for kind in fused_qn.KINDS:
        runs = [emulator.qn_update(k5, Bm, s, y, g, kind=kind, seed=seed)
                for seed in SEEDS]
        assert all(torch.equal(a, b) for a, b in zip(*runs)), kind
        Bn, Bg = runs[0]
        Pn, Pg = fused_qn.qn_update_direction_plain(B_ref, s, y, g, skip,
                                                    kind=kind)
        rtol = RTOL[Bm.dtype]
        assert (Bn - Pn).abs().max() <= rtol * Pn.abs().max(), kind
        assert (Bg - Pg).abs().max() <= rtol * Pg.abs().max(), kind
        for i in torch.nonzero(skip).flatten().tolist():
            assert torch.equal(Bn[i], B_ref[i]), kind


def inputs(b, n, dtype, curvature=True):
    return tuple(torch.tensor(a, dtype=dtype)
                 for a in qn_update_arrays(b, n, curvature=curvature))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [5, 33, 100])
def test_emulated_k5_matches_plain(n, dtype, k5):
    """The shared placement; instance 1's pair is skipped."""
    assert fused_qn.in_shared(n, torch.tensor([], dtype=dtype).element_size())
    Bm, s, y, g = inputs(3, n, dtype)
    assert fused_qn.skip_mask(s, y, 1e-8).tolist() == [False, True, False]
    held(k5, Bm, s, y, g)


@pytest.mark.parametrize("n,dtype", [(240, torch.float32),
                                     (170, torch.float64)])
def test_emulated_k5_past_the_fit(n, dtype, k5):
    """The workspace placement: B read from device memory."""
    assert not fused_qn.in_shared(n, 4 if dtype == torch.float32 else 8)
    held(k5, *inputs(2, n, dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_emulated_k5_unaligned_batch(dtype, k5):
    """B one element into its storage (its staged copy and B' out of step
    modulo 16 bytes), at a width whose n^2 elements are no whole number of
    16-byte groups."""
    Bm, s, y, g = inputs(3, 7, dtype, curvature=False)
    storage = torch.empty(Bm.numel() + 1, dtype=dtype)
    storage[1:] = Bm.reshape(-1)
    held(k5, storage[1:].view(Bm.shape), s, y, g, B_ref=Bm)


def test_fit_rules_match_the_source(k5):
    """The wrapper's mirrors (``in_shared``, ``smem_elems``) equal the
    source's functions across the shared placement's fit: n <= 238 in
    float32, n <= 167 in float64."""
    for n in (1, 5, 100, 166, 167, 168, 237, 238, 239, 400, 6000):
        assert fused_qn.smem_elems(n) == k5.qn_update_smem_elems(n)
        for itemsize in (4, 8):
            assert fused_qn.in_shared(n, itemsize) == bool(
                k5.qn_update_in_shared(n, itemsize))
    assert fused_qn.in_shared(238, 4) and not fused_qn.in_shared(239, 4)
    assert fused_qn.in_shared(167, 8) and not fused_qn.in_shared(168, 8)
