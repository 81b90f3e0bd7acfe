"""Batched template-method driver: the route of ``batch_minimize`` to the
whole-solve kernel K3.

Counterpart of the batched half of
:mod:`optimization_solvers_tpu.solvers.driver` (``batch_minimize``;
``apply_stall_status`` and the exit ``pg_norm`` run in K3's wrapper,
:func:`..ops.fused_driver.solve_spec`).  A (method, line search) pair that
:func:`..ops.fused_driver.fused_supported` accepts, with an oracle that
keeps its raw objective (:func:`..core.oracle.make_oracle`), runs K3: the
plain PyTorch version for a CPU ``x0``, the CUDA kernel for a CUDA ``x0``.
Everything else raises ``NotImplementedError`` naming the ROADMAP item
that brings it; nothing goes elsewhere in silence.

The JAX package takes its kernel only on a TPU and runs the lockstep XLA
loop on a CPU.  The port has no lockstep loop yet, so a CPU ``x0`` runs
K3's plain version, which differs from the lockstep loop where
``pallas_driver.py:38-43`` says: a lane that converges exactly at the
budget reports CONVERGED, and an out-of-domain shrink is folded into the
trial budget.  The JAX compile probe and failure memo have no counterpart:
a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from ..core.types import SolveResult
from ..linesearch.base import Bounds
from ..ops import fused_driver
# JAX keeps this hook here; the port runs it in K3's wrapper
from ..ops.fused_driver import apply_stall_status  # noqa: F401

_KWARGS = {"max_iter", "max_iter_ls", "callback", "unroll"}
_LOCKSTEP = "ROADMAP.md Queue 1 item 7"


def as_batch(x0) -> torch.Tensor:
    """``x0`` as a tensor: a tensor keeps its device; anything else (an
    array, a list, a scalar) goes to the GPU, and raises on a machine
    without one.  The entry points run on the card unless the caller hands
    them a CPU tensor."""
    if isinstance(x0, torch.Tensor):
        return x0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "x0 is not a torch tensor, so it goes to torch.device('cuda'), "
            "and no CUDA device is available; pass a CPU tensor to run the "
            "plain PyTorch version on the CPU")
    return torch.as_tensor(x0, device="cuda")


def batch_minimize(method, line_search, oracle, x0, *, bounds: Bounds = None,
                   batched_bounds: bool = False, fused="auto",
                   **kwargs) -> SolveResult:
    """Batched solves of ``oracle`` from ``x0`` (B, n) with ``method`` and
    ``line_search``, through K3.

    ``bounds`` is ``(lower, upper)``, each ``(n,)`` or per-instance
    ``(B, n)``: K3 takes either as it is.  Keyword arguments: ``max_iter``
    (1000), ``max_iter_ls`` (100), and JAX's lockstep knobs ``callback``
    and ``unroll``; any other raises ``TypeError``.  The lockstep and
    vmapped paths are not ported: ``fused=False``, ``batched_bounds=True``,
    a ``callback``, an ``unroll`` other than 1, a combination K3 has no
    form for, an oracle without a raw objective, or an instance too wide
    for a block's shared memory raise ``NotImplementedError``; so does, on
    a CUDA ``x0``, a batch of dense quasi-Newton or Newton slabs (``B n^2``
    elements) larger than the device's free memory."""
    unknown = set(kwargs) - _KWARGS
    if unknown:
        raise TypeError(
            f"batch_minimize got unexpected keyword argument(s) "
            f"{sorted(unknown)}")
    if fused is True and kwargs.get("callback") is not None:
        raise ValueError(
            "fused=True is incompatible with callback (the whole-solve "
            "kernels have no per-iteration host hooks)")
    if (fused is False or batched_bounds or kwargs.get("unroll", 1) != 1
            or kwargs.get("callback") is not None):
        raise NotImplementedError(
            "the lockstep batched driver (fused=False, batched_bounds, "
            f"callback, unroll) is not ported yet ({_LOCKSTEP})")
    raw_f = getattr(oracle, "raw_f", None)
    if raw_f is None:
        raise NotImplementedError(
            "the oracle has no raw objective (make_oracle keeps one); a "
            f"hand-written oracle needs the lockstep driver ({_LOCKSTEP})")
    spec = fused_driver.build_spec(method, line_search)
    if spec is None:
        if getattr(line_search, "reference_quirks", False):
            raise NotImplementedError(
                "MoreThuente(reference_quirks=True) has no fused form (as in "
                "JAX K3, pallas_driver.py:1666); its bug-for-bug interval "
                f"update waits for the lockstep search ({_LOCKSTEP})")
        raise NotImplementedError(
            f"({type(method).__name__}, {type(line_search).__name__}) has no "
            "form in K3 (its methods are the first-order, dense "
            "quasi-Newton, L-BFGS and Newton configs of this package, its "
            "searches the Armijo and Wolfe configs of its linesearch; a "
            "bounded search needs a bounded method); anything else needs "
            f"the lockstep driver ({_LOCKSTEP})")
    x0 = as_batch(x0)
    if x0.dim() != 2:
        raise ValueError(f"x0 must be (B, n), got {tuple(x0.shape)}")
    fused_driver._check_fits(x0.shape[-1], spec.ring, x0.element_size(),
                             spec.lbfgs_m)
    lower, upper = bounds if bounds is not None else (None, None)
    if lower is not None:
        lower, upper = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                        for b in (lower, upper))
    consts = tuple(torch.as_tensor(c, device=x0.device)
                   for c in getattr(oracle, "data", ()))
    return fused_driver.solve_spec(
        spec, method, raw_f, x0, lower, upper, consts,
        max_iter=kwargs.get("max_iter", 1000),
        max_iter_ls=kwargs.get("max_iter_ls", 100))
