"""Problem library: the objectives the ported slices use.

PyTorch counterpart of :mod:`optimization_solvers_tpu.core.problems`
(rosenbrock, quadratic, diag_quadratic, log_sum_exp, shifted_quadratic_2d,
example_gd, quadratic_2d, example_bfgs, exp_bowl), plus the generic
:func:`weighted_squares` that carries its coefficients as problem data
(``data=(d, t)``).

Each entry is an :class:`Objective`: a per-instance ``f(x, *data)`` in torch,
its batched analytic ``value`` / ``value_and_grad`` over ``(B, n)``, its
batched analytic second derivatives ``hessian`` (``(B, n, n)``) and ``hvp``
(``(B, n)``), and a ``kernel_form`` naming the CUDA objective functor and the
data arrays that functor reads.  Four functors cover the library:

* ``ROSENBROCK``: ``sum_i 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2``, no data;
* ``WEIGHTED_SQUARES``: ``0.5 sum_i d_i (x_i - t_i)^2`` with data ``(d, t)``,
  both ``(n,)``;
* ``QUADRATIC``: ``0.5 x^T Q x + b^T x`` with data ``Q (n, n)``, ``b (n,)``;
* ``LOG_SUM_EXP``: ``log sum_r exp(a_r^T x + b_r)`` with data
  ``A (rows, n)``, ``b (rows,)``.

The K1 kernel (``ops/csrc/lbfgsb_fused.cu``), the SPG kernel K8
(``spg_fused.cu``) and the first-order and quasi-Newton forms of K3
(``ops/csrc/driver.cu``, ``driver_qn.cu``) compile the first two; the
L-BFGS and dense BFGS kernels K7 and K9 (``lbfgs_fused.cu``,
``bfgs_fused.cu``) the first three; K3's Newton form
(``driver_newton.cu``) and the Newton-CG kernel K4 (``newton_cg.cu``) all
four, with their Hessian and HVP functors; the K2 kernel
(``ops/csrc/lbfgsb_tall.cu``) all four.  The
second derivatives are written in the expressions and order of the CUDA
functors (``ops/csrc/objectives.cuh``).  ``exp_bowl`` has PyTorch forms
only: its kernel form
names the ``EXP_BOWL`` functor, which no kernel compiles, so a CUDA call
with it raises.
"""

from __future__ import annotations

from typing import Callable

import torch

ROSENBROCK = "ROSENBROCK"
WEIGHTED_SQUARES = "WEIGHTED_SQUARES"
QUADRATIC = "QUADRATIC"
LOG_SUM_EXP = "LOG_SUM_EXP"
EXP_BOWL = "EXP_BOWL"


class Objective:
    """A scalar objective with analytic batched forms and a kernel form.

    ``fn(x, *data)`` is the per-instance objective on an ``(n,)`` tensor;
    ``value(X, *data)`` and ``value_and_grad(X, *data)`` evaluate a
    ``(B, n)`` batch, sharing every data array across instances.
    ``hessian(X, *data)`` gives the ``(B, n, n)`` Hessians and
    ``hvp(X, V, *data)`` the ``(B, n)`` Hessian-vector products.
    ``functor`` names the CUDA functor; ``kernel_form(*data)`` returns
    ``(functor, arrays)``, the arrays being ``arrays(*data)`` (by default
    the call-time data itself)."""

    def __init__(self, fn: Callable, value: Callable, value_and_grad: Callable,
                 functor: str, arrays: Callable = lambda *data: data, *,
                 hessian: Callable, hvp: Callable):
        self._fn = fn
        self._value = value
        self._value_and_grad = value_and_grad
        self._hessian = hessian
        self._hvp = hvp
        self.functor = functor
        self._arrays = arrays

    def __call__(self, x, *data):
        return self._fn(x, *data)

    def value(self, X, *data):
        return self._value(X, *data)

    def value_and_grad(self, X, *data):
        return self._value_and_grad(X, *data)

    def hessian(self, X, *data):
        return self._hessian(X, *data)

    def hvp(self, X, V, *data):
        return self._hvp(X, V, *data)

    def kernel_form(self, *data):
        return self.functor, tuple(self._arrays(*data))


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


def _rosen_hess_diag(X):
    """``H_ii``: ``1200 x_i^2 - 400 x_{i+1} + 2`` from term i (i < n-1),
    written ``800 x_i x_i - 400 a_i + 2`` with ``a_i = x_{i+1} - x_i^2`` as
    the functor does, plus 200 from term i-1 (i > 0)."""
    xl = X[..., :-1]
    a = X[..., 1:] - xl * xl
    h = torch.zeros_like(X)
    h[..., :-1] = 800.0 * xl * xl - 400.0 * a + 2.0
    h[..., 1:] += 200.0
    return h


def _rosen_hessian(X):
    """Tridiagonal: ``H_ii`` and ``H_{i,i+1} = H_{i+1,i} = -400 x_i``."""
    B, n = X.shape
    H = torch.zeros((B, n, n), dtype=X.dtype, device=X.device)
    i = torch.arange(n, device=X.device)
    H[:, i, i] = _rosen_hess_diag(X)
    off = -400.0 * X[:, :-1]
    H[:, i[:-1], i[1:]] = off
    H[:, i[1:], i[:-1]] = off
    return H


def _rosen_hvp(X, V):
    out = _rosen_hess_diag(X) * V
    off = -400.0 * X[..., :-1]
    out[..., :-1] += off * V[..., 1:]
    out[..., 1:] += off * V[..., :-1]
    return out


def _like(v, X):
    return torch.as_tensor(v, dtype=X.dtype, device=X.device)


def _ws_hessian(X, d, t):
    return torch.diag_embed(_like(d, X).expand(X.shape).clone())


def _ws_hvp(X, V, d, t):
    return _like(d, X) * V


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

    return Objective(f, _rosen_value, _rosen_value_and_grad, ROSENBROCK,
                     lambda: (), hessian=_rosen_hessian, hvp=_rosen_hvp)


def weighted_squares() -> Objective:
    """``f(x, d, t) = 0.5 sum_i d_i (x_i - t_i)^2`` with problem data
    ``(d, t)`` of shape ``(n,)``, shared across a batch."""

    def f(x, d, t):
        return 0.5 * torch.sum(d * (x - t) ** 2)

    return Objective(f, _ws_value, _ws_value_and_grad, WEIGHTED_SQUARES,
                     hessian=_ws_hessian, hvp=_ws_hvp)


def _bound_weighted_squares(fn, d, t) -> Objective:
    """A weighted-squares objective whose ``(d, t)`` are fixed at
    construction (no problem data at call time)."""
    return Objective(fn, lambda X: _ws_value(X, d, t),
                     lambda X: _ws_value_and_grad(X, d, t), WEIGHTED_SQUARES,
                     lambda: (d, t), hessian=lambda X: _ws_hessian(X, d, t),
                     hvp=lambda X, V: _ws_hvp(X, V, d, t))


def quadratic(Q, b=None) -> Objective:
    """General quadratic ``f = 0.5 x^T Q x + b^T x``.

    The gradient is ``0.5 (Q x + Q^T x) + b`` and the Hessian ``0.5 (Q +
    Q^T)`` (``b`` does not enter), what autodiff of the JAX form gives, so
    a ``Q`` that is not exactly symmetric agrees too; the Hessian is then
    exactly symmetric, which K3's factorization relies on."""
    Q = torch.as_tensor(Q)
    b = torch.zeros(Q.shape[0], dtype=Q.dtype) if b is None else (
        torch.as_tensor(b))

    def f(x):
        return 0.5 * torch.sum(x * (_like(Q, x) @ x)) + torch.sum(
            _like(b, x) * x)

    def value(X):
        Qx = X @ _like(Q, X).T
        return 0.5 * torch.sum(X * Qx, dim=-1) + torch.sum(_like(b, X) * X,
                                                          dim=-1)

    def value_and_grad(X):
        Qm = _like(Q, X)
        Qx = X @ Qm.T
        v = 0.5 * torch.sum(X * Qx, dim=-1) + torch.sum(_like(b, X) * X,
                                                        dim=-1)
        return v, 0.5 * (Qx + X @ Qm) + _like(b, X)

    def hessian(X):
        Qm = _like(Q, X)
        return (0.5 * (Qm + Qm.T)).expand(X.shape[0], -1, -1).clone()

    def hvp(X, V):
        Qm = _like(Q, X)
        return 0.5 * (V @ Qm.T + V @ Qm)

    return Objective(f, value, value_and_grad, QUADRATIC, lambda: (Q, b),
                     hessian=hessian, hvp=hvp)


def log_sum_exp(A, b) -> Objective:
    """``f = log sum_r exp(a_r^T x + b_r)`` in the max-shifted form
    ``z_max + log sum_r exp(z_r - z_max)``; gradient ``A^T softmax(z)``.
    The config-4 objective (10,000-dim, 512 rows)."""
    A = torch.as_tensor(A)
    b = torch.as_tensor(b)

    def f(x):
        z = _like(A, x) @ x + _like(b, x)
        mx = torch.max(z)
        return mx + torch.log(torch.sum(torch.exp(z - mx)))

    def _z(X):
        z = X @ _like(A, X).T + _like(b, X)
        return z, torch.amax(z, dim=-1, keepdim=True)

    def value(X):
        z, mx = _z(X)
        return mx[:, 0] + torch.log(torch.sum(torch.exp(z - mx), dim=-1))

    def value_and_grad(X):
        z, mx = _z(X)
        e = torch.exp(z - mx)
        s = torch.sum(e, dim=-1, keepdim=True)
        return (mx + torch.log(s))[:, 0], (e / s) @ _like(A, X)

    def hessian(X):
        # A^T (diag(p) - p p^T) A with p = softmax(z)
        z, mx = _z(X)
        e = torch.exp(z - mx)
        p = e / torch.sum(e, dim=-1, keepdim=True)
        Am = _like(A, X)
        pA = p @ Am
        return (torch.einsum("br,ri,rj->bij", p, Am, Am)
                - pA[:, :, None] * pA[:, None, :])

    def hvp(X, V):
        z, mx = _z(X)
        e = torch.exp(z - mx)
        p = e / torch.sum(e, dim=-1, keepdim=True)
        Am = _like(A, X)
        Av = V @ Am.T
        return (p * (Av - torch.sum(p * Av, dim=-1, keepdim=True))) @ Am

    return Objective(f, value, value_and_grad, LOG_SUM_EXP, lambda: (A, b),
                     hessian=hessian, hvp=hvp)


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


def quadratic_2d(gamma: float) -> Objective:
    """``f = 0.5 (x1^2 + gamma x2^2)``, the reference's ill-conditioned 2-D
    quadratic; min 0 at the origin."""

    def f(x):
        return 0.5 * (x[0] ** 2 + gamma * x[1] ** 2)

    return _bound_weighted_squares(f, torch.tensor([1.0, float(gamma)]),
                                   torch.zeros(2))


def example_bfgs() -> Objective:
    """``f = x1^2 + 2 x2^2 + 3 x3^2 + x1 x2 + x2 x3``, i.e. ``0.5 x^T Q x``
    with ``Q = [[2, 1, 0], [1, 4, 1], [0, 1, 6]]``; min 0 at the origin."""
    return quadratic(torch.tensor([[2.0, 1.0, 0.0], [1.0, 4.0, 1.0],
                                   [0.0, 1.0, 6.0]]))


def exp_bowl() -> Objective:
    """``f = r + exp(r)`` with ``r = x1^2 + x2^2`` (any n); min 1 at the
    origin.  PyTorch forms only: no CUDA functor."""

    def f(x):
        r2 = torch.sum(x ** 2)
        return r2 + torch.exp(r2)

    def value(X):
        r2 = torch.sum(X ** 2, dim=-1)
        return r2 + torch.exp(r2)

    def value_and_grad(X):
        r2 = torch.sum(X ** 2, dim=-1)
        e = torch.exp(r2)
        return r2 + e, 2.0 * X * (1.0 + e)[:, None]

    def hessian(X):
        # 2 (1 + e) I + 4 e x x^T
        e = torch.exp(torch.sum(X ** 2, dim=-1))
        eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
        return (2.0 * (1.0 + e)[:, None, None] * eye
                + 4.0 * e[:, None, None] * X[:, :, None] * X[:, None, :])

    def hvp(X, V):
        e = torch.exp(torch.sum(X ** 2, dim=-1))
        xv = torch.sum(X * V, dim=-1)
        return (2.0 * (1.0 + e)[:, None] * V
                + 4.0 * (e * xv)[:, None] * X)

    return Objective(f, value, value_and_grad, EXP_BOWL, lambda: (),
                     hessian=hessian, hvp=hvp)
