"""Vector substrate: box projection, norms, NaN-discarding clamps.

PyTorch counterpart of :mod:`optimization_solvers_tpu.core.numerics`.
``torch.minimum``/``torch.maximum`` propagate NaN like ``jnp.minimum``, so
every function keeps the JAX package's NaN semantics.
"""

from __future__ import annotations

import torch


def box_projection(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Clamp ``x`` into ``[lower, upper]`` elementwise (bounds may hold
    ``+/-inf``)."""
    lo = torch.as_tensor(lower, dtype=x.dtype, device=x.device)
    up = torch.as_tensor(upper, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), up)


def infinity_norm(v: torch.Tensor) -> torch.Tensor:
    """``max_i |v_i|`` along the last axis."""
    return torch.amax(torch.abs(v), dim=-1)


def projected_gradient(g: torch.Tensor, x: torch.Tensor, lower,
                       upper) -> torch.Tensor:
    """Zero the gradient components that push against an active bound."""
    at_lower = (x == lower) & (g > 0)
    at_upper = (x == upper) & (g < 0)
    return torch.where(at_lower | at_upper, torch.zeros_like(g), g)


def rust_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.min(b)`` with Rust semantics: a NaN operand is discarded."""
    return torch.where(torch.isnan(a), b,
                       torch.where(torch.isnan(b), a, torch.minimum(a, b)))


def rust_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.max(b)`` with Rust semantics: a NaN operand is discarded."""
    return torch.where(torch.isnan(a), b,
                       torch.where(torch.isnan(b), a, torch.maximum(a, b)))


def rust_clamp(t: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """``t.max(t_min).min(t_max)`` with Rust semantics: a NaN ``t``
    collapses to ``t_min``."""
    t_min = torch.as_tensor(t_min, dtype=t.dtype, device=t.device)
    t_max = torch.as_tensor(t_max, dtype=t.dtype, device=t.device)
    t1 = torch.where(torch.isnan(t), t_min, torch.maximum(t, t_min))
    return torch.minimum(t1, t_max)


def sign(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0)."""
    return torch.where(torch.isnan(v), v, torch.sign(v))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Last-axis inner product as an elementwise multiply-reduce."""
    return torch.sum(a * b, dim=-1)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the last two axes of ``A`` and the last of ``x``,
    batch axes broadcast (an ``(n, n)`` matrix against a ``(B, n)``
    batch, or one matrix per instance)."""
    return torch.einsum("...ij,...j->...i", A, x)


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-instance outer product ``a b^T`` of two ``(..., n)`` batches."""
    return a[..., :, None] * b[..., None, :]


def batched_pg_inf_norm(x, g, lower=None, upper=None):
    """Per-row ``||x - P_box(x - g)||_inf`` over the trailing axis (plain
    ``||g||_inf`` when unbounded): the Fortran's ``sbgnrm``."""
    if lower is None:
        return torch.amax(torch.abs(g), dim=-1)
    return torch.amax(torch.abs(x - box_projection(x - g, lower, upper)),
                      dim=-1)
