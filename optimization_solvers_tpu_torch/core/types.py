"""Core result types: oracle evaluations, solve results, status codes.

PyTorch counterpart of :mod:`optimization_solvers_tpu.core.types`.  The
status codes keep the JAX package's integer values, so a status tensor from
either package compares equal lane for lane.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch


class Status(enum.IntEnum):
    """Solve status, one int32 per instance.  Mirrors the reference
    ``SolverError`` taxonomy plus an explicit success code."""

    RUNNING = 0
    CONVERGED = 1
    MAX_ITER_REACHED = 2
    OUT_OF_DOMAIN = 3
    ERROR_INPUT_PARAMS = 4
    ABNORMAL = 5             # line search failed with an empty history
    # the quasi-Newton s/y-stall exit fired at a point whose projected
    # gradient still exceeds the tolerance (success-class, made visible)
    STALLED = 6


class FuncEval(NamedTuple):
    """Value + gradient (+ optional Hessian) of the objective at a point."""

    f: torch.Tensor
    g: torch.Tensor
    hessian: Optional[torch.Tensor] = None

    def with_hessian(self, hessian: torch.Tensor) -> "FuncEval":
        return self._replace(hessian=hessian)

    @property
    def in_domain(self) -> torch.Tensor:
        """False where f is NaN/Inf (the reference's domain check)."""
        return torch.isfinite(self.f)


class SolveResult(NamedTuple):
    """Structured result of a solve; batched solves carry a leading batch
    axis on every field.

    ``pg_norm`` is the per-instance projected-gradient infinity norm
    ``||x - P_box(x - g)||_inf`` at exit.  ``x_lo`` is the low word of a
    double-float iterate and ``gcp_multimodal`` the tall kernel's GCP guard
    flag; both are ``None`` on the paths ported so far.
    """

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    iterations: torch.Tensor   # int32 completed solver iterations
    status: torch.Tensor       # int32 Status code
    pg_norm: Optional[torch.Tensor] = None
    x_lo: Optional[torch.Tensor] = None
    gcp_multimodal: Optional[torch.Tensor] = None

    @property
    def converged(self) -> torch.Tensor:
        return self.status == Status.CONVERGED

    @property
    def stalled(self) -> torch.Tensor:
        return self.status == Status.STALLED

    @property
    def g_norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.g, dim=-1)

    def stationary(self, tol: float) -> torch.Tensor:
        """Per-instance KKT check: ``pg_norm <= tol`` (raises without
        ``pg_norm``)."""
        if self.pg_norm is None:
            raise ValueError("this SolveResult carries no pg_norm")
        return self.pg_norm <= tol
