"""The CUDA kernel K7's direction (``ops/csrc/lbfgs_fused.cu``: the compact
form of H g with the tables by slot and the small algebra on lanes),
modelled in torch (``tests/_torch_k7_algebra.py``), against the two-loop
recursion the plain version runs, in float64 on rings with rejected
(zeroed, invalid) slots at every position and with every head: the two
agree to 1e-12 of the direction's largest entry, and an invalid slot's u
and p are exact zeros, so it drops out as it contributes 0 to the
two-loop.  An empty ring gives d = -gamma g bit for bit in both forms.
"""

import pytest
import torch

from _torch_k7_algebra import compact, ring, two_loop

CASES = [
    (5, (), 0), (5, (), 3), (5, (2,), 3), (5, (0, 3), 1), (5, (4,), 4),
    (5, (1, 2, 3), 2), (1, (), 0), (3, (1,), 2), (10, (0, 5, 9), 7),
    (20, (3, 4, 11, 19), 13),
]


@pytest.mark.parametrize("m,rejected,head", CASES)
def test_compact_form_matches_two_loop(m, rejected, head):
    for seed in range(3):
        S, Y, valid, gamma, g = ring(m, 12, rejected, head, seed)
        d_two = two_loop(S, Y, valid, gamma, g, head)
        d_cmp, U, P = compact(S, Y, valid, gamma, g, head)
        scale = d_two.abs().max().item()
        assert (d_cmp - d_two).abs().max().item() <= 1e-12 * scale
        for k in rejected:
            assert U[k].item() == 0.0 and P[k].item() == 0.0


def test_empty_ring_is_the_scaled_gradient():
    S, Y, valid, gamma, g = ring(5, 12, tuple(range(5)), 2, 0)
    assert gamma == 1.0 and valid.sum().item() == 0
    assert torch.equal(compact(S, Y, valid, gamma, g, 2)[0], -g)
    assert torch.equal(two_loop(S, Y, valid, gamma, g, 2), -g)
