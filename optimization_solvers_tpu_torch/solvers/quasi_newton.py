"""Dense quasi-Newton family: the configs of BFGS, DFP, Broyden ("bad"
rank-1 on the inverse), their box-constrained twins BFGSB/DFPB/BroydenB,
and the bounded-only SR1B.

Counterpart of :mod:`optimization_solvers_tpu.solvers.quasi_newton`, with
the same fields, defaults, factories and ``__post_init__`` check.  The
whole-solve kernel K3 (:mod:`..ops.fused_driver`) runs them: a dense
approximate inverse Hessian ``B`` per instance, seeded at the identity,
direction ``-B g`` (bounded: ``P_box(x - B g) - x``), convergence on the
gradient 2-norm or on ``||s||, ||y|| < tol``, and the update skipped on a
degenerate pair.  ``scale_b0`` rescales ``B0 = (s.y / y.y) I`` before the
first update; ``restart_on_degeneracy`` resets ``B`` to the identity on a
degenerate pair and exits only after a restarted step stalls again.  A
CONVERGED exit whose gradient test did not pass is relabelled STALLED (6)
by :meth:`stall_status`, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import BoundedMethod, Method


@dataclasses.dataclass(frozen=True)
class _QuasiNewtonCommon:
    """Shared quasi-Newton fields; ``update`` picks the B-update rule
    (``"bfgs"``, ``"dfp"``, ``"broyden"``, ``"sr1"``)."""

    tol: float = 1e-8
    update: str = "bfgs"
    # the per-iteration fused update of the JAX lockstep driver (the TPU
    # kernel K5); batch_minimize sends any QN config to K3
    fused: bool = False
    scale_b0: bool = False
    restart_on_degeneracy: bool = False

    def __post_init__(self):
        if self.fused and (self.scale_b0 or self.restart_on_degeneracy):
            raise ValueError(
                "fused per-iteration QN mode does not implement "
                "scale_b0/restart_on_degeneracy; use the whole-solve fused "
                "kernel (ops.fused_minimize) or fused=False")

    def stall_status(self, x, f, g, pg_norm, bounds):
        """Per-instance "the exit was the s/y-stall at a non-KKT point"
        mask: a CONVERGED exit with ``||g||_2 >= tol`` (the gradient test
        did not fire) and a projected-gradient norm above ``tol``.  Exits
        at a certified stationary point keep CONVERGED."""
        g_small = torch.sqrt(torch.sum(g * g, dim=-1)) < self.tol
        return ~g_small & (pg_norm > self.tol)


@dataclasses.dataclass(frozen=True)
class QuasiNewton(_QuasiNewtonCommon, Method):
    """Unconstrained quasi-Newton: direction ``-B g`` (``bfgs.rs:42-49``)."""


@dataclasses.dataclass(frozen=True)
class QuasiNewtonB(_QuasiNewtonCommon, BoundedMethod):
    """Box-constrained quasi-Newton: ``d = P_box(x - B g) - x``
    (``bfgs_b.rs:66-77``); convergence still tests the raw gradient
    2-norm, as the reference does (``bfgs_b.rs:92-104``)."""


def BFGS(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="bfgs", **kw)


def DFP(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="dfp", **kw)


def Broyden(tol: float = 1e-8, **kw) -> QuasiNewton:
    return QuasiNewton(tol=tol, update="broyden", **kw)


def BFGSB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="bfgs", **kw)


def DFPB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="dfp", **kw)


def BroydenB(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    return QuasiNewtonB(tol=tol, update="broyden", **kw)


def SR1B(tol: float = 1e-8, **kw) -> QuasiNewtonB:
    """SR1 exists only in bounded form in the reference (``lib.rs:60-61``)."""
    return QuasiNewtonB(tol=tol, update="sr1", **kw)
