"""Oracle layer: batched function evaluation with a value-only fast path.

PyTorch counterpart of :mod:`optimization_solvers_tpu.core.oracle`
(``Oracle``, ``make_oracle``), built on :mod:`..ops.batched_oracle`: an
objective of :mod:`.problems` brings its analytic batched forms, any other
torch callable ``f(x, *data)`` is batched with ``torch.func``.  The oracle
keeps the raw objective and its problem data (``raw_f``, ``data``), which is
what the whole-solve kernels take: :func:`..solvers.driver.batch_minimize`
reads them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.batched_oracle import (batched_hessian, batched_hvp, batched_value,
                                  batched_value_and_grad)
from .types import FuncEval


class Oracle:
    """A function-evaluation oracle ``x -> FuncEval``.

    ``x`` is a ``(B, n)`` batch (the port's solvers are batched) or one
    ``(n,)`` point.  ``value(x)`` is the value-only path the Armijo-family
    searches use; without a value function it falls back to the full
    evaluation.  ``first_order(x)`` is the value and gradient without a
    Hessian and ``hessian(x)`` the Hessian alone: the lockstep driver
    evaluates the Hessian once per iteration, at the iterate, and nowhere
    else (XLA drops the unused Hessians of JAX's full evaluations; eager
    PyTorch would compute them).  Both fall back to the full
    evaluation."""

    def __init__(self, full_fn: Callable[[torch.Tensor], FuncEval],
                 value_fn: Optional[Callable] = None,
                 first_order_fn: Optional[Callable] = None,
                 hessian_fn: Optional[Callable] = None):
        self._full = full_fn
        self._value = value_fn
        self._first = first_order_fn
        self._hessian = hessian_fn

    def __call__(self, x: torch.Tensor) -> FuncEval:
        ev = self._full(x)
        if not isinstance(ev, FuncEval):
            ev = FuncEval(*ev)
        return ev

    def value(self, x: torch.Tensor) -> torch.Tensor:
        if self._value is not None:
            return self._value(x)
        return self(x).f

    def first_order(self, x: torch.Tensor) -> FuncEval:
        if self._first is not None:
            return FuncEval(*self._first(x))
        ev = self(x)
        return FuncEval(ev.f, ev.g)

    def hessian(self, x: torch.Tensor) -> torch.Tensor:
        h = self._hessian(x) if self._hessian is not None else self(x).hessian
        if h is None:
            raise ValueError(
                "the method needs Hessians and the oracle gives none; build "
                "it with make_oracle(f, with_hessian=True)")
        return h


def ensure_oracle(oracle) -> Oracle:
    """Coerce a plain callable ``x -> FuncEval`` (the reference seam) to
    :class:`Oracle`."""
    if isinstance(oracle, Oracle):
        return oracle
    return Oracle(oracle)


def _one_or_batch(fn):
    """Apply a ``(B, n)`` batched function to a ``(B, n)`` batch or to one
    ``(n,)`` point."""
    def wrapped(x):
        if x.dim() == 1:
            out = fn(x[None])
            return tuple(o[0] for o in out) if isinstance(out, tuple) else (
                out[0])
        return fn(x)
    return wrapped


def make_oracle(f: Callable, *, with_hessian: bool = False,
                data: tuple = ()) -> Oracle:
    """An oracle from a scalar objective ``f(x, *data)``.

    ``data`` carries the problem-data arrays explicitly, as in the JAX
    package, so that a whole-solve kernel can take them as operands.  With
    ``with_hessian`` each evaluation carries the Hessian too.  The oracle
    always has ``hvp(x, v)``, the Hessian-vector product.  An objective of
    :mod:`.problems` brings its analytic Hessian and HVP; any other torch
    callable gets them from ``torch.func`` (``hessian``; ``jvp`` over
    ``grad``, forward-over-reverse as in JAX).  These batched forms run on
    the CPU; the CUDA kernels compile the analytic functors instead."""
    data = tuple(torch.as_tensor(c) for c in data)
    vg = _one_or_batch(batched_value_and_grad(f, data))
    hess = _one_or_batch(batched_hessian(f, data)) if with_hessian else None

    def full(x):
        fv, g = vg(x)
        return FuncEval(fv, g, None if hess is None else hess(x))

    oracle = Oracle(full, value_fn=_one_or_batch(batched_value(f, data)),
                    first_order_fn=vg, hessian_fn=hess)
    oracle.raw_f = f
    oracle.data = data
    bhvp = batched_hvp(f, data)

    def hvp(x, v):
        if x.dim() == 1:
            return bhvp(x[None], v[None])[0]
        return bhvp(x, v)

    oracle.hvp = hvp
    return oracle
