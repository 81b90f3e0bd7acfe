"""Problem library: the objectives the ported L-BFGS-B slice uses.

PyTorch counterpart of :mod:`optimization_solvers_tpu.core.problems`
(rosenbrock, diag_quadratic, shifted_quadratic_2d, example_gd), plus the
generic :func:`weighted_squares` that carries its coefficients as problem
data (``data=(d, t)``).

Each entry is an :class:`Objective`: a per-instance ``f(x, *data)`` in torch,
its batched analytic ``value`` / ``value_and_grad`` over ``(B, n)``, and a
``kernel_form`` naming the CUDA objective functor and the 1-D data arrays
that functor reads.  Two functors cover the library:

* ``ROSENBROCK``: ``sum_i 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2``, no data;
* ``WEIGHTED_SQUARES``: ``0.5 sum_i d_i (x_i - t_i)^2`` with data ``(d, t)``.
"""

from __future__ import annotations

from typing import Callable

import torch

ROSENBROCK = "ROSENBROCK"
WEIGHTED_SQUARES = "WEIGHTED_SQUARES"


class Objective:
    """A scalar objective with analytic batched forms and a kernel form.

    ``fn(x, *data)`` is the per-instance objective on an ``(n,)`` tensor;
    ``value(X, *data)`` and ``value_and_grad(X, *data)`` evaluate a
    ``(B, n)`` batch, sharing every data array across instances.
    ``kernel_form(*data)`` returns ``(functor, arrays)``."""

    def __init__(self, fn: Callable, value: Callable, value_and_grad: Callable,
                 kernel_form: Callable):
        self._fn = fn
        self._value = value
        self._value_and_grad = value_and_grad
        self._kernel_form = kernel_form

    def __call__(self, x, *data):
        return self._fn(x, *data)

    def value(self, X, *data):
        return self._value(X, *data)

    def value_and_grad(self, X, *data):
        return self._value_and_grad(X, *data)

    def kernel_form(self, *data):
        return self._kernel_form(*data)


def _rosen_value(X):
    a = X[..., 1:] - X[..., :-1] ** 2
    return torch.sum(100.0 * a ** 2 + (1.0 - X[..., :-1]) ** 2, dim=-1)


def _rosen_value_and_grad(X):
    xl = X[..., :-1]
    a = X[..., 1:] - xl ** 2
    v = torch.sum(100.0 * a ** 2 + (1.0 - xl) ** 2, dim=-1)
    g = torch.zeros_like(X)
    g[..., :-1] = -400.0 * xl * a - 2.0 * (1.0 - xl)
    g[..., 1:] += 200.0 * a
    return v, g


def _like(v, X):
    return torch.as_tensor(v, dtype=X.dtype, device=X.device)


def _ws_value(X, d, t):
    r = X - _like(t, X)
    return 0.5 * torch.sum(_like(d, X) * r * r, dim=-1)


def _ws_value_and_grad(X, d, t):
    r = X - _like(t, X)
    g = _like(d, X) * r
    return 0.5 * torch.sum(g * r, dim=-1), g


def rosenbrock() -> Objective:
    """n-dimensional Rosenbrock; min 0 at the all-ones vector.  The headline
    benchmark objective (10k-batch Rosenbrock-100)."""

    def f(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1.0 - x[:-1]) ** 2)

    return Objective(f, _rosen_value, _rosen_value_and_grad,
                     lambda: (ROSENBROCK, ()))


def weighted_squares() -> Objective:
    """``f(x, d, t) = 0.5 sum_i d_i (x_i - t_i)^2`` with problem data
    ``(d, t)`` of shape ``(n,)``, shared across a batch."""

    def f(x, d, t):
        return 0.5 * torch.sum(d * (x - t) ** 2)

    return Objective(f, _ws_value, _ws_value_and_grad,
                     lambda d, t: (WEIGHTED_SQUARES, (d, t)))


def _bound_weighted_squares(fn, d, t) -> Objective:
    """A weighted-squares objective whose ``(d, t)`` are fixed at
    construction (no problem data at call time)."""
    return Objective(fn, lambda X: _ws_value(X, d, t),
                     lambda X: _ws_value_and_grad(X, d, t),
                     lambda: (WEIGHTED_SQUARES, (d, t)))


def diag_quadratic(d) -> Objective:
    """Separable quadratic ``f = 0.5 sum d_i x_i^2``."""
    d = torch.as_tensor(d)

    def f(x):
        return 0.5 * torch.sum(_like(d, x) * x ** 2)

    return _bound_weighted_squares(f, d, torch.zeros_like(d))


def example_gd() -> Objective:
    """``f = x1^2 + 2 x2^2``; min 0 at the origin."""

    def f(x):
        return x[0] ** 2 + 2.0 * x[1] ** 2

    return _bound_weighted_squares(f, torch.tensor([2.0, 4.0]),
                                   torch.zeros(2))


def shifted_quadratic_2d() -> Objective:
    """``f = (x1-2)^2 + (x2-3)^2``; with box ``x <= 1`` the constrained
    min is 5 at (1, 1)."""

    def f(x):
        return (x[0] - 2.0) ** 2 + (x[1] - 3.0) ** 2

    return _bound_weighted_squares(f, torch.tensor([2.0, 2.0]),
                                   torch.tensor([2.0, 3.0]))
