"""Batched objective evaluation over a ``(B, n)`` batch, and the packing of
an objective's problem data for the CUDA kernels.

Counterpart of the helpers in ``optimization_solvers_tpu/ops/pallas_lbfgs.py``
(``_batched_value_and_grad``, ``_batched_value``, ``_pack_consts``,
``_load_consts``).  An objective from :mod:`..core.problems` brings its own
analytic batched forms; any other torch callable ``f(x, *data)`` is batched
with ``torch.func.vmap(torch.func.grad_and_value(f))``.  Problem data is
shared across instances, as the JAX kernels share 1-D consts.
"""

from __future__ import annotations

from typing import Callable

import torch

# objective functors compiled into ops/csrc/lbfgsb_fused.cu (enum Objective)
KERNEL_OBJECTIVES = {"ROSENBROCK": 0, "WEIGHTED_SQUARES": 1}


def batched_value_and_grad(f: Callable, data=()):
    """``(B, n) -> ((B,), (B, n))`` value and gradient."""
    if hasattr(f, "value_and_grad"):
        return lambda X: f.value_and_grad(X, *data)
    vg = torch.func.vmap(torch.func.grad_and_value(f),
                         in_dims=(0,) + (None,) * len(data))

    def wrapped(X):
        g, v = vg(X, *data)
        return v, g

    return wrapped


def batched_value(f: Callable, data=()):
    """``(B, n) -> (B,)`` value only (line-search trials)."""
    if hasattr(f, "value"):
        return lambda X: f.value(X, *data)
    bf = torch.func.vmap(f, in_dims=(0,) + (None,) * len(data))
    return lambda X: bf(X, *data)


def kernel_operands(f, data, x0: torch.Tensor):
    """The kernel form of ``f``: its functor code and its data arrays as
    contiguous ``(n,)`` tensors of x0's dtype on x0's device.  Raises
    ``NotImplementedError`` for an objective without a kernel form."""
    form = getattr(f, "kernel_form", None)
    if form is None:
        raise NotImplementedError(
            "the CUDA L-BFGS-B kernel needs an objective with a kernel_form "
            "(optimization_solvers_tpu_torch.core.problems); arbitrary torch "
            "callables on CUDA wait for the lockstep solver "
            "(ROADMAP.md Queue 1 item 3)")
    name, arrays = form(*data)
    n = x0.shape[-1]
    packed = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(
                f"{name} data must be 1-D of length {n}, got {tuple(t.shape)}")
        if t.device.type != "cpu" and t.device != x0.device:
            raise ValueError(f"{name} data lies on {t.device}, x0 on "
                             f"{x0.device}")
        packed.append(t.to(device=x0.device, dtype=x0.dtype).contiguous())
    return KERNEL_OBJECTIVES[name], tuple(packed)
