"""Line-search protocol.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.base`.  A line
search is a frozen config; the whole-solve kernel K3 reads its fields
(:mod:`..ops.fused_driver`).  The shared Wolfe-condition predicates
(``mod.rs:25-86``) are elementwise tensor functions here.  The lockstep bodies (``init_state``,
``step_len``, ``step_len_ev``), which the JAX package runs in its XLA loop,
are not ported yet (ROADMAP.md Queue 1 item 7): they raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Bounds = Optional[Tuple[torch.Tensor, torch.Tensor]]

_LOCKSTEP = ("the lockstep line-search bodies are not ported yet; the "
             "searches run inside the whole-solve kernel K3 "
             "(ROADMAP.md Queue 1 item 7)")


def sufficient_decrease(c1, f_k, f_kp1, g_dot_d, t) -> torch.Tensor:
    """Armijo: ``f_{k+1} - f_k <= c1 * t * g_k . d`` (``mod.rs:27-37``)."""
    return f_kp1 - f_k <= c1 * t * g_dot_d


def curvature_condition(c2, g_dot_d, g_kp1_dot_d) -> torch.Tensor:
    """``g_{k+1} . d >= c2 * g_k . d`` (``mod.rs:41-47``)."""
    return g_kp1_dot_d >= c2 * g_dot_d


def strong_curvature_condition(c2, g_dot_d, g_kp1_dot_d) -> torch.Tensor:
    """``|g_{k+1} . d| <= c2 |g_k . d|`` (``mod.rs:49-56``)."""
    return torch.abs(g_kp1_dot_d) <= c2 * torch.abs(g_dot_d)


def strong_wolfe(c1, c2, f_k, f_kp1, g_dot_d, g_kp1_dot_d, t) -> torch.Tensor:
    """Strong Wolfe conditions (``mod.rs:73-85``)."""
    return (sufficient_decrease(c1, f_k, f_kp1, g_dot_d, t)
            & strong_curvature_condition(c2, g_dot_d, g_kp1_dot_d))


class LineSearch:
    """Base class; concrete searches are frozen dataclasses subclassing
    this."""

    def init_state(self, ev0):
        raise NotImplementedError(_LOCKSTEP)

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int):
        raise NotImplementedError(_LOCKSTEP)
