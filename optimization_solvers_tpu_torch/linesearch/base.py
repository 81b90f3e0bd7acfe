"""Line-search protocol and the lockstep scaffolding the searches share.

Counterpart of :mod:`optimization_solvers_tpu.linesearch.base`.  A line
search is a frozen config with two methods, run by the lockstep driver
(:mod:`..solvers.driver`) and, through its fields, by the whole-solve
kernel K3 (:mod:`..ops.fused_driver`):

``init_state(ev0)``
    the search's state carried across solver iterations (GLL's f history,
    MoreThuenteB's running ``t_max``; ``None`` for the rest);
``step_len(oracle, x, ev, d, state, bounds, max_iter, active=None)``
    ``-> (t, state)``:
    one search over a batch: ``x`` and ``d`` are ``(B, n)``, ``ev`` holds
    ``f`` ``(B,)`` and ``g`` ``(B, n)``, and ``t`` comes back ``(B,)``.
    ``active`` (``(B,)`` bool, optional) marks the instances whose step
    the driver will keep; the others start the search done, which changes
    nothing for the active ones and spares the batch their trials.

The JAX package runs each search as a ``lax.while_loop`` on one instance's
scalars and batches it with ``vmap``; :func:`masked_while` is that loop
over per-instance ``(B,)`` carries: it runs while any instance's condition
holds, and an instance whose condition is false keeps its carry bit for
bit.  So each instance's trials, and the step it takes, are those of a
search of its own.  The shared Wolfe-condition predicates
(``mod.rs:25-86``) are elementwise tensor functions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Bounds = Optional[Tuple[torch.Tensor, torch.Tensor]]


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


def tree_where(mask: torch.Tensor, new, old):
    """``where(mask, new, old)`` over matching trees (tuples, named tuples,
    ``None`` leaves) of tensors with a leading batch axis; ``mask`` is
    ``(B,)`` and broadcasts over each leaf's trailing axes.  A lane whose
    mask is false keeps ``old`` bit for bit, NaN included.  A leaf that is
    the same object in both (state a step leaves alone, such as
    PnormDescent's shared matrix) is kept as it is."""
    if old is None or new is old:
        return old
    if isinstance(old, tuple):
        items = [tree_where(mask, a, b) for a, b in zip(new, old)]
        return type(old)(*items) if hasattr(old, "_fields") else tuple(items)
    m = mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim()))
    return torch.where(m, new, old)


def masked_while(cond, body, carry):
    """The lockstep counterpart of ``vmap(lax.while_loop)``: repeat
    ``carry = body(carry)`` while ``cond(carry)`` (``(B,)`` bool) holds for
    some lane, keeping the carry of every lane whose condition is false.
    One host read of ``any`` per trip."""
    while True:
        run = cond(carry)
        if not bool(run.any()):
            return carry
        carry = tree_where(run, body(carry), carry)


def full_like_batch(ref: torch.Tensor, value, dtype=None) -> torch.Tensor:
    """A ``(B,)`` tensor of ``value`` on ``ref``'s device, of ``ref``'s
    dtype unless ``dtype`` is given."""
    return torch.full(ref.shape[:1], value, dtype=dtype or ref.dtype,
                      device=ref.device)


def start_done(x: torch.Tensor, active) -> torch.Tensor:
    """The searches' initial per-instance ``done`` flag: set where the
    driver marked an instance inactive."""
    if active is None:
        return torch.zeros(x.shape[:1], dtype=torch.bool, device=x.device)
    return ~active


def dtype_const(expr, x: torch.Tensor) -> float:
    """A constant computed in x's dtype, as JAX computes ``2.0 * c1 - 1.0``
    on a dtype array, returned as the Python float it rounds to."""
    return float(expr(lambda v: torch.tensor(v, dtype=x.dtype)))


def max_feasible_step(x, d, bounds):
    """``min_i (bound_i - x_i) / d_i`` over the coordinates that move, per
    instance; a NaN term is skipped, as Rust's min-fold does
    (``morethuente_b.rs:185-201``)."""
    lower, upper = bounds
    pos = (upper - x) / d
    neg = (lower - x) / d
    inf = torch.full_like(x, float("inf"))
    terms = torch.where(d > 0.0, pos, torch.where(d < 0.0, neg, inf))
    terms = torch.where(torch.isnan(terms), inf, terms)
    return torch.amin(terms, dim=-1)


def lanes(t: torch.Tensor) -> torch.Tensor:
    """A ``(B,)`` step as ``(B, 1)``, to scale ``(B, n)`` rows."""
    return t[:, None]


class LineSearch:
    """Base class; concrete searches are frozen dataclasses subclassing
    this."""

    def init_state(self, ev0):
        return None

    def step_len(self, oracle, x, ev, d, state, bounds: Bounds,
                 max_iter: int, active=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no step_len; a line search is one "
            "of the concrete searches of optimization_solvers_tpu_torch."
            "linesearch")

    def step_len_ev(self, oracle, x, ev, d, state, bounds: Bounds,
                    max_iter: int, active=None):
        """``(t, state, x_new, ev_new)``: the accepted step, the updated
        search state, the accepted iterate and its value and gradient.
        Value-only searches re-evaluate at the accepted point (JAX
        ``base.py:63-77``); the Wolfe searches that already evaluated it
        (StrongWolfe, Hager-Zhang) return that evaluation."""
        t, state = self.step_len(oracle, x, ev, d, state, bounds, max_iter,
                                 active)
        x_new = x + lanes(t) * d
        return t, state, x_new, oracle(x_new)
