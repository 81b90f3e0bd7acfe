"""Line-search protocol.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.base`.  A line
search is a frozen config; the whole-solve kernel K3 reads its fields
(:mod:`..ops.fused_driver`).  The lockstep bodies (``init_state``,
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


class LineSearch:
    """Base class; concrete searches are frozen dataclasses subclassing
    this."""

    def init_state(self, ev0):
        raise NotImplementedError(_LOCKSTEP)

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int):
        raise NotImplementedError(_LOCKSTEP)
