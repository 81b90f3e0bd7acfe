"""Batched objective evaluation over a ``(B, n)`` batch, and the packing of
an objective's problem data for the CUDA kernels.

Counterpart of the helpers in ``optimization_solvers_tpu/ops/pallas_lbfgs.py``
(``_batched_value_and_grad``, ``_batched_value``, ``_pack_consts``,
``_load_consts``), ``pallas_driver.py`` (``_batched_hessian``) and
``pallas_newton_cg.py`` (``_batched_hvp``).  An objective from
:mod:`..core.problems` brings its own analytic batched forms; any other
torch callable ``f(x, *data)`` is batched with ``torch.func``:
``vmap(grad_and_value(f))``, ``vmap(hessian(f))`` and ``vmap`` of ``jvp``
over ``grad`` (forward-over-reverse, as JAX's).  Problem data is shared
across instances, as the JAX kernels share 1-D consts.
"""

from __future__ import annotations

from typing import Callable

import torch

# objective functors of the CUDA kernels (enum ObjectiveCode in ops/csrc);
# K8 (spg_fused.cu) and K3's first-order form (driver.cu) compile the first
# two, K7 (lbfgs_fused.cu) the first three, K1 (lbfgsb_fused.cu; its scaled
# form the first two), K2 (lbfgsb_tall.cu), K3's quasi-Newton, Wolfe,
# dense and Newton forms (driver_qn.cu and driver_qn_data.cu,
# driver_dense.cu, driver_newton.cu), K4 (newton_cg.cu) and K9
# (bfgs_fused.cu) all four
KERNEL_OBJECTIVES = {"ROSENBROCK": 0, "WEIGHTED_SQUARES": 1, "QUADRATIC": 2,
                     "LOG_SUM_EXP": 3}


def _data_shapes(name, arrays, n):
    """The shapes a functor's data arrays must have; ``rows`` is taken from
    the first array of ``LOG_SUM_EXP``."""
    if name == "QUADRATIC":
        return [(n, n), (n,)]
    if name == "LOG_SUM_EXP":
        rows = tuple(torch.as_tensor(arrays[0]).shape)[:1] if arrays else (0,)
        return [rows + (n,), rows]
    return [(n,)] * len(arrays)


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


def batched_hessian(f: Callable, data=()):
    """``(B, n) -> (B, n, n)`` Hessians."""
    if hasattr(f, "hessian"):
        return lambda X: f.hessian(X, *data)
    bh = torch.func.vmap(torch.func.hessian(f),
                         in_dims=(0,) + (None,) * len(data))
    return lambda X: bh(X, *data)


def batched_hvp(f: Callable, data=()):
    """``((B, n), (B, n)) -> (B, n)`` Hessian-vector products."""
    if hasattr(f, "hvp"):
        return lambda X, V: f.hvp(X, V, *data)

    def hvp(x, v, *cs):
        return torch.func.jvp(lambda xx: torch.func.grad(f)(xx, *cs), (x,),
                              (v,))[1]

    bh = torch.func.vmap(hvp, in_dims=(0, 0) + (None,) * len(data))
    return lambda X, V: bh(X, V, *data)


def kernel_functor(f, data=()):
    """``(name, rows)``: the functor ``f``'s kernel form names (``None``
    for a callable without one) and, for ``LOG_SUM_EXP``, the rows of its
    ``A`` (0 otherwise).  What the routes decide on before a launch."""
    form = getattr(f, "kernel_form", None)
    if form is None:
        return None, 0
    name, arrays = form(*data)
    rows = 0
    if name == "LOG_SUM_EXP" and arrays:
        shape = tuple(torch.as_tensor(arrays[0]).shape)
        rows = shape[0] if shape else 0
    return name, rows


def kernel_operands(f, data, x0: torch.Tensor, kernel: str = "a CUDA kernel",
                    lockstep: str = "solvers.lbfgsb_batch_minimize, which "
                    "minimize(method='lbfgsb') routes such a callable to"):
    """The kernel form of ``f``: its functor code and its data arrays as
    contiguous tensors of x0's dtype on x0's device, each of the shape its
    functor reads (``(n,)``; ``Q (n, n)``; ``A (rows, n)``, ``b (rows,)``).
    Raises ``NotImplementedError`` for an objective without a kernel form,
    naming ``kernel``, the kernel that asked, and ``lockstep``, what takes
    such a callable instead (by default the lockstep L-BFGS-B that
    ``minimize(method='lbfgsb')`` routes it to; K3's wrapper names
    ``batch_minimize``'s lockstep loop, K4's the lockstep Newton-CG), or an
    objective whose functor no kernel compiles (``exp_bowl``), and
    ``ValueError`` for data of another shape."""
    form = getattr(f, "kernel_form", None)
    if form is None:
        raise NotImplementedError(
            f"{kernel} needs an objective with a kernel_form "
            "(optimization_solvers_tpu_torch.core.problems); arbitrary torch "
            f"callables on CUDA run on a lockstep solver ({lockstep})")
    name, arrays = form(*data)
    if name not in KERNEL_OBJECTIVES:
        raise NotImplementedError(
            f"{kernel} has no {name} functor (ops/csrc/objectives.cuh "
            f"compiles {', '.join(KERNEL_OBJECTIVES)}); the plain version "
            "takes this objective on a CPU tensor")
    n = x0.shape[-1]
    packed = []
    for a, shape in zip(arrays, _data_shapes(name, arrays, n)):
        t = torch.as_tensor(a)
        if tuple(t.shape) != shape:
            raise ValueError(
                (f"{name} data must be 1-D of length {n}" if shape == (n,)
                 else f"{name} data must have shape {shape}")
                + f", got {tuple(t.shape)}")
        if t.device.type != "cpu" and t.device != x0.device:
            raise ValueError(f"{name} data lies on {t.device}, x0 on "
                             f"{x0.device}")
        packed.append(t.to(device=x0.device, dtype=x0.dtype).contiguous())
    return KERNEL_OBJECTIVES[name], tuple(packed)
