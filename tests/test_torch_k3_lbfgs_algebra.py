"""L-BFGS's direction in K3's quasi-Newton form (``ops/csrc/driver.cuh``:
the compact form of H g, the tables by slot, the small algebra on lanes,
invalid slots masked by multiplying by their ``valid``), modelled in torch
(``tests/_torch_k3_lbfgs_algebra.py``), against the two-loop recursion the
plain version runs, in float64 on K3's ring: every head, and invalid slots
that keep their stale pairs, both as a reset leaves them (the oldest rows,
before the pairs accepted since) and one at each position.  The two agree
to 1e-12 of the direction's largest entry, and an invalid slot's u and p
are exact zeros; a ring with no valid pair gives d = -gamma g bit for bit
in both forms; a stale pair whose sums with the gradient overflow gives a
non-finite direction in both forms (which takes the kernel's reset).
"""

import pytest
import torch

from _torch_k3_lbfgs_algebra import compact, ring, two_loop

N = 12


def stale_sets(m):
    """Invalid slots as K3 reaches them (after a reset, the oldest k rows,
    k = 0 .. m) and one invalid slot at each position; by chronological
    row, mapped to slots by the caller."""
    return ([tuple(range(k)) for k in range(m + 1)]
            + [(q,) for q in range(1, m)])


@pytest.mark.parametrize("m", [1, 4, 5, 10, 20])
def test_compact_form_matches_two_loop(m):
    for head in range(m):
        for k, rows in enumerate(stale_sets(m)):
            stale = {(head + q) % m for q in rows}
            S, Y, rho, valid, gamma, g = ring(m, N, stale, head,
                                              seed=100 * m + k)
            d_two = two_loop(S, Y, rho, valid, gamma, g, head)
            d_cmp, U, P = compact(S, Y, valid, gamma, g, head)
            scale = d_two.abs().max().item()
            err = (d_cmp - d_two).abs().max().item()
            assert err <= 1e-12 * scale, (head, rows, err, scale)
            for s in stale:
                assert U[s].item() == 0.0 and P[s].item() == 0.0
            if len(stale) == m:
                assert gamma == 1.0
                assert torch.equal(d_cmp, -g) and torch.equal(d_two, -g)


@pytest.mark.parametrize("m", [1, 4, 5, 10, 20])
def test_overflowing_stale_pair_poisons_both_forms(m):
    for head in range(m):
        for rows in ((0,), tuple(range(m))):
            stale = {(head + q) % m for q in rows}
            S, Y, rho, valid, gamma, g = ring(m, N, stale, head, seed=m,
                                              huge=head, g_scale=1e3)
            assert not torch.isfinite(
                two_loop(S, Y, rho, valid, gamma, g, head)).all()
            assert not torch.isfinite(
                compact(S, Y, valid, gamma, g, head)[0]).all()
