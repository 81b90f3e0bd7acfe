"""Truncated Newton-CG: the config and the batched solver.

Counterpart of :mod:`optimization_solvers_tpu.solvers.newton_cg`
(``NewtonCGConfig`` with the same fields and defaults,
``newton_cg_batch_minimize``, ``newton_cg_minimize``).  The JAX package
runs this algorithm twice: as an XLA lockstep loop here and as the fused
TPU kernel ``ops/pallas_newton_cg.py``; its own tests hold the two
together.  The port runs the batched solve through the Newton-CG kernel
K4 (:mod:`..ops.fused_newton_cg`): its plain PyTorch version for a CPU
``x0``, the CUDA kernel for a CUDA ``x0``.  The single-instance lockstep
loop is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import SolveResult
from ..ops.fused_newton_cg import newton_cg_solve_fused
from .driver import as_batch

_LOCKSTEP = "ROADMAP.md Queue 1 item 7a"


@dataclasses.dataclass(frozen=True)
class NewtonCGConfig:
    pgtol: float = 1e-5
    factr: float = 1e7
    max_iter: int = 200
    cg_max: int = 32
    max_iter_ls: int = 25
    c1: float = 1e-4


def newton_cg_batch_minimize(oracle, x0, lower, upper,
                             config: NewtonCGConfig = NewtonCGConfig()
                             ) -> SolveResult:
    """Batched box-constrained Newton-CG from ``x0`` (B, n) in the box
    ``[lower, upper]`` (each ``(n,)``; ``+-inf`` for a free coordinate).

    ``oracle`` comes from :func:`..core.oracle.make_oracle`, which keeps
    the raw objective and its data for the kernel; an oracle without them
    needs the lockstep loop and raises ``NotImplementedError``.  A
    non-tensor ``x0`` goes to the GPU."""
    raw_f = getattr(oracle, "raw_f", None)
    if raw_f is None:
        raise NotImplementedError(
            "the oracle has no raw objective (make_oracle keeps one); a "
            f"hand-written oracle needs the lockstep Newton-CG loop "
            f"({_LOCKSTEP})")
    x0 = as_batch(x0)
    lower, upper = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                    for b in (lower, upper))
    consts = tuple(torch.as_tensor(c, device=x0.device)
                   for c in getattr(oracle, "data", ()))
    return newton_cg_solve_fused(raw_f, x0, lower, upper, consts,
                                 **dataclasses.asdict(config))


def newton_cg_minimize(oracle, x0, lower, upper,
                       config: NewtonCGConfig = NewtonCGConfig()
                       ) -> SolveResult:
    """The single-instance Newton-CG loop: not ported yet; pass ``x0`` as
    ``(1, n)`` to :func:`newton_cg_batch_minimize`."""
    raise NotImplementedError(
        "single-instance newton_cg_minimize runs the lockstep Newton-CG "
        f"loop, not ported yet ({_LOCKSTEP}); pass x0 as (1, n) to "
        "newton_cg_batch_minimize")
