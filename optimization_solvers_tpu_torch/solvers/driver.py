"""Generic solver driver: the lockstep template loop, and the route of
``batch_minimize`` to the whole-solve kernel K3.

Counterpart of :mod:`optimization_solvers_tpu.solvers.driver`.  The
reference's ``LineSearchSolver::minimize`` loop (``ls_solver.rs:23-112``)
runs on a batch in lockstep: the JAX package vmaps one instance's
``lax.while_loop`` step and freezes finished lanes with per-lane masks;
here the step is written over ``(B, n)`` tensors, the loop is a Python loop
over iterations, and every merge is a ``where`` on the ``(B,)`` active mask
(:func:`..linesearch.base.tree_where`), so a finished instance keeps its
exit state bit for bit while the others go on.  As in JAX:

* the evaluation at the accepted point is made once per iteration and
  carried (the reference's extra post-step oracle call is the next
  iteration's top-of-loop evaluation); a Newton-family direction gets the
  Hessian at the carried iterate, evaluated alone (JAX re-evaluates the
  full oracle there and leaves XLA to drop the duplicate value and
  gradient: the numbers are the same);
* status precedence on exit: the iteration budget (``k >= max_iter``)
  first, then the domain check (non-finite f: OUT_OF_DOMAIN), then
  CONVERGED, then the quasi-Newton STALLED relabel; ``pg_norm`` is the
  projected-gradient infinity norm at the exit point.

:func:`batch_minimize` routes a batch: ``fused="auto"`` sends a (method,
line search) pair that K3 has a form for, with an oracle that keeps its raw
objective (:func:`..core.oracle.make_oracle`) and instances that fit a
block's shared memory, to K3 (:mod:`..ops.fused_driver`: the plain version
for a CPU ``x0``, the kernel for a CUDA ``x0``), on both devices; on a
CUDA ``x0`` only where the chosen form also compiles the objective's
functor (:func:`..ops.fused_driver.compiled_functors`), a static decision
taken before the launch.  Everything else runs the lockstep loop:
``fused=False``, a ``callback``, ``batched_bounds=True``, ``unroll`` other
than 1, an oracle without a raw objective,
``MoreThuente(reference_quirks=True)``, any pair K3 has no form for, and
on a CUDA ``x0`` a callable without a kernel form or a functor the form
lacks (the first-order form, a first-order method with an Armijo-family
search, compiles Rosenbrock and weighted squares; the other forms all four
functors).  Where this differs from JAX: on the CPU the JAX package's
``"auto"`` takes the lockstep loop and K3 only on a TPU, so a CPU solve
that K3 takes here differs from JAX's ``"auto"`` where K3 and the lockstep
loop differ by design (``pallas_driver.py:38-43``: a lane that converges
exactly at the budget reports CONVERGED, and an out-of-domain trial shrinks
within the one trial budget); ``fused=False`` compares like with like.
The JAX compile probe and failure memo have no counterpart: a kernel that
fails to build or launch raises.

The loop's host reads: one ``any(active)`` per ``unroll`` iterations, and
one ``any`` per trip of a search's trial loop.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core.oracle import Oracle, ensure_oracle
from ..core.types import FuncEval, SolveResult, Status
from ..linesearch.base import Bounds, LineSearch, tree_where
from ..ops import fused_driver
from ..ops.batched_oracle import kernel_functor
from ..ops.fused_driver import apply_stall_status, exit_pg_norm
from .base import Method

_KWARGS = {"max_iter", "max_iter_ls", "callback", "unroll"}


class SolverCarry(NamedTuple):
    """The loop's carry, batched: iterate ``(B, n)``, its evaluation,
    completed iterations ``(B,)`` int32, method state, line-search
    state."""

    x: torch.Tensor
    ev: FuncEval
    k: torch.Tensor
    mstate: Any
    ls_state: Any


def as_batch(x0) -> torch.Tensor:
    """``x0`` as a tensor: a tensor keeps its device; anything else (an
    array, a list, a scalar) goes to the GPU, and raises on a machine
    without one.  The entry points run on the card unless the caller hands
    them a CPU tensor."""
    if isinstance(x0, torch.Tensor):
        return x0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "x0 is not a torch tensor, so it goes to torch.device('cuda'), "
            "and no CUDA device is available; pass a CPU tensor to run the "
            "plain PyTorch version on the CPU")
    return torch.as_tensor(x0, device="cuda")


def _as_bounds(bounds, x0):
    if bounds is None:
        return None
    return tuple(torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                 for b in bounds)


def make_step(method, line_search, oracle, *, bounds: Bounds = None,
              max_iter_ls: int = 100, callback=None):
    """``(init_fn, keep_going_fn, step_fn)`` of the solver loop, batched.

    ``init_fn(x0)`` projects a ``(B, n)`` x0 for bounded methods and seeds
    the states; ``keep_going_fn(carry)`` is the per-instance domain and
    convergence predicate (without the iteration budget);
    ``step_fn(carry, active=None)`` performs one iteration on every
    instance (direction, line search, iterate update, state refresh);
    ``active`` lets the searches skip the instances whose step will be
    discarded.  ``callback(k, x, f)``, if given, is called after each step
    with the batched 1-based iteration counts, iterates and values (those
    of inactive instances are discarded by the loop)."""
    if not isinstance(method, Method):
        raise TypeError(f"method must be a method config of "
                        f"optimization_solvers_tpu_torch.solvers, got "
                        f"{type(method).__module__}.{type(method).__name__}")
    if not isinstance(line_search, LineSearch):
        raise TypeError(f"line_search must be a search of "
                        f"optimization_solvers_tpu_torch.linesearch, got "
                        f"{type(line_search).__module__}."
                        f"{type(line_search).__name__}")
    oracle = ensure_oracle(oracle)
    # the oracle as the searches see it: value and gradient, no Hessian
    evaluate = Oracle(oracle.first_order, value_fn=oracle.value)
    needs_h = bool(getattr(method, "needs_hessian", False))

    def init_fn(x0: torch.Tensor) -> SolverCarry:
        x0 = method.prepare_x0(x0, bounds)
        ev0 = evaluate(x0)
        k = torch.zeros(x0.shape[:1], dtype=torch.int32, device=x0.device)
        return SolverCarry(x0, ev0, k, method.init(x0, ev0, bounds),
                           line_search.init_state(ev0))

    def keep_going_fn(c: SolverCarry) -> torch.Tensor:
        return torch.isfinite(c.ev.f) & ~method.converged(c.mstate, c.x, c.ev,
                                                         bounds)

    def step_fn(c: SolverCarry, active=None) -> SolverCarry:
        ev_dir = (c.ev._replace(hessian=oracle.hessian(c.x)) if needs_h
                  else c.ev)
        d, mstate = method.direction(c.mstate, c.x, ev_dir, bounds)
        t, ls_state, x_new, ev_new = line_search.step_len_ev(
            evaluate, c.x, c.ev, d, c.ls_state, bounds, max_iter_ls, active)
        mstate = method.post_step(mstate, c.x, ev_dir, d, t, x_new, ev_new,
                                  bounds)
        if callback is not None:
            callback(c.k + 1, x_new, ev_new.f)
        return SolverCarry(x_new, ev_new, c.k + 1, mstate, ls_state)

    return init_fn, keep_going_fn, step_fn


def _result(final: SolverCarry, max_iter: int, bounds: Bounds = None,
            method=None) -> SolveResult:
    f = final.ev.f
    status = torch.where(
        final.k >= max_iter, int(Status.MAX_ITER_REACHED),
        torch.where(~torch.isfinite(f), int(Status.OUT_OF_DOMAIN),
                    int(Status.CONVERGED))).to(torch.int32)
    pg = exit_pg_norm(final.x, final.ev.g, bounds)
    status = apply_stall_status(status, method, final.x, f, final.ev.g, pg,
                                bounds)
    return SolveResult(final.x, f, final.ev.g, final.k, status, pg_norm=pg)


def lockstep_loop(init_fn, keep_going_fn, step_fn, x0, max_iter: int,
                  unroll: int = 1) -> SolverCarry:
    """Run the solver loop over the batch of ``x0`` in lockstep: every
    iteration steps every instance and keeps the step where the instance
    was active; returns the final carry.

    ``unroll`` steps run between two host checks of ``any(active)``, each
    masked by its own budget and convergence test, so the result is that of
    ``unroll=1`` (JAX runs ``unroll`` masked steps per while-loop trip); the
    trade is up to ``unroll - 1`` wasted steps at the end."""
    c = init_fn(x0)
    active = keep_going_fn(c)
    i = 0
    while i < max_iter and bool(active.any()):
        for j in range(unroll):
            ok = active if j == 0 else active & (i + j < max_iter)
            c = tree_where(ok, step_fn(c, ok), c)
            active = keep_going_fn(c)
        i += unroll
    return c


def _squeeze(r: SolveResult) -> SolveResult:
    return SolveResult(*(None if v is None else v[0] for v in r))


def minimize(method, line_search, oracle, x0, *, bounds: Bounds = None,
             max_iter: int = 1000, max_iter_ls: int = 100,
             callback=None) -> SolveResult:
    """Minimize ``oracle`` from ``x0``; the universal entry point
    (reference ``ls_solver.rs:66-111``).

    A 1-D ``x0`` ``(n,)`` is one instance: the lockstep loop runs it as a
    batch of one and the result has no batch axis; ``callback(k, x, f)``
    then gets the instance's own ``k``, ``(n,)`` x and ``f``.  A ``(B, n)``
    x0 runs the lockstep loop over the batch."""
    x0 = as_batch(x0)
    single = x0.dim() == 1
    cb = callback
    if single and callback is not None:
        def cb(k, x, f):
            callback(k[0], x[0], f[0])
    r = _lockstep(method, line_search, oracle, x0[None] if single else x0,
                  _as_bounds(bounds, x0), max_iter=max_iter,
                  max_iter_ls=max_iter_ls, callback=cb)
    return _squeeze(r) if single else r


def minimize_recorded(method, line_search, oracle, x0, *,
                      bounds: Bounds = None, max_iter: int = 1000,
                      max_iter_ls: int = 100):
    """Like :func:`minimize`, and also the trajectory: ``(result, xs,
    fs)`` with ``xs`` ``(max_iter + 1, n)`` (``(max_iter + 1, B, n)`` for a
    batch) and ``fs`` the values.  Exactly ``max_iter`` masked steps, as
    JAX's ``lax.scan``: a converged instance repeats its final iterate (the
    loop stops early once every instance has, and the rows repeat)."""
    x0 = as_batch(x0)
    single = x0.dim() == 1
    bounds = _as_bounds(bounds, x0)
    init_fn, keep_going_fn, step_fn = make_step(
        method, line_search, oracle, bounds=bounds, max_iter_ls=max_iter_ls)
    c = init_fn(x0[None] if single else x0)
    xs, fs = [c.x], [c.ev.f]
    for _ in range(max_iter):
        active = keep_going_fn(c)
        if bool(active.any()):
            c = tree_where(active, step_fn(c, active), c)
        xs.append(c.x)
        fs.append(c.ev.f)
    r = _result(c, max_iter, bounds, method)
    xs, fs = torch.stack(xs), torch.stack(fs)
    if single:
        return _squeeze(r), xs[:, 0], fs[:, 0]
    return r, xs, fs


def _lockstep(method, line_search, oracle, x0, bounds, *, max_iter=1000,
              max_iter_ls=100, callback=None, unroll=1) -> SolveResult:
    init_fn, keep_going_fn, step_fn = make_step(
        method, line_search, oracle, bounds=bounds, max_iter_ls=max_iter_ls,
        callback=callback)
    final = lockstep_loop(init_fn, keep_going_fn, step_fn, x0, max_iter,
                          unroll=unroll)
    return _result(final, max_iter, bounds, method)


def _k3_fit(spec, oracle, x0):
    """``(fits, compiled)`` for K3's ``spec`` (``None``: no form), decided
    by the form (:func:`..ops.fused_driver.compiled_functors`): an instance
    fits a block's shared memory (a log-sum-exp's rows counted in every form
    that compiles it), and on a CUDA ``x0`` the form compiles the oracle's
    raw objective's functor (always on the CPU, whose plain version takes
    any callable)."""
    if spec is None:
        return False, False
    functor, rows = kernel_functor(getattr(oracle, "raw_f", None),
                                   getattr(oracle, "data", ()))
    fits = fused_driver.fits(x0.shape[-1], spec.ring, x0.element_size(),
                             spec.lbfgs_m, spec.method,
                             fused_driver.k3_rows(spec, functor, rows))
    return fits, (x0.device.type != "cuda"
                  or functor in fused_driver.compiled_functors(spec))


def batch_minimize(method, line_search, oracle, x0, *, bounds: Bounds = None,
                   batched_bounds: bool = False, fused="auto",
                   **kwargs) -> SolveResult:
    """Batched :func:`minimize` over the leading axis of ``x0`` (B, n).

    ``bounds`` is ``(lower, upper)``, each ``(n,)`` or per-instance
    ``(B, n)``; ``batched_bounds=True`` says they are per-instance (the
    lockstep loop then takes them, as JAX vmaps its single-instance loop
    over them).  Keyword arguments: ``max_iter`` (1000), ``max_iter_ls``
    (100), ``callback`` (``(k, x, f)``, batched) and ``unroll`` (lockstep
    steps per host check); any other raises ``TypeError``.

    Routing (see the module docstring): ``fused="auto"`` takes K3 where it
    applies and the lockstep loop elsewhere (on a CUDA ``x0`` also for an
    objective whose functor the chosen form does not compile);
    ``fused=False`` always takes the lockstep loop; ``fused=True`` takes K3
    or raises ``ValueError`` (also with a ``callback``), and on a CUDA
    ``x0`` ``NotImplementedError`` for an objective without a functor of
    the chosen form.  A batch of dense quasi-Newton or Newton slabs (``B
    n^2`` elements) larger than the device's free memory raises."""
    unknown = set(kwargs) - _KWARGS
    if unknown:
        raise TypeError(
            f"batch_minimize got unexpected keyword argument(s) "
            f"{sorted(unknown)}")
    callback = kwargs.get("callback")
    if fused is True and callback is not None:
        raise ValueError(
            "fused=True is incompatible with callback (the whole-solve "
            "kernels have no per-iteration host hooks)")
    x0 = as_batch(x0)
    if x0.dim() != 2:
        raise ValueError(f"x0 must be (B, n), got {tuple(x0.shape)}")
    max_iter = kwargs.get("max_iter", 1000)
    max_iter_ls = kwargs.get("max_iter_ls", 100)
    bounds = _as_bounds(bounds, x0)
    raw_f = getattr(oracle, "raw_f", None)
    spec = (fused_driver.build_spec(method, line_search)
            if fused is not False and raw_f is not None else None)
    fits, compiled = _k3_fit(spec, oracle, x0)
    if fused is True:
        if not fits:
            raise ValueError(
                "fused=True but no fused kernel applies (unsupported combo, "
                "the oracle lacks a raw scalar objective, or an instance "
                "too wide for a block's shared memory)")
    elif (fused is False or not fits or not compiled or batched_bounds
          or callback is not None or kwargs.get("unroll", 1) != 1):
        if batched_bounds and bounds is not None:
            B, n = x0.shape
            for b in bounds:
                if tuple(b.shape) != (B, n):
                    raise ValueError(
                        f"batched_bounds=True needs ({B}, {n}) bounds, got "
                        f"{tuple(b.shape)}")
        return _lockstep(method, line_search, oracle, x0, bounds,
                         max_iter=max_iter, max_iter_ls=max_iter_ls,
                         callback=callback, unroll=kwargs.get("unroll", 1))
    lower, upper = bounds if bounds is not None else (None, None)
    consts = tuple(torch.as_tensor(c, device=x0.device)
                   for c in getattr(oracle, "data", ()))
    return fused_driver.solve_spec(spec, method, raw_f, x0, lower, upper,
                                   consts, max_iter=max_iter,
                                   max_iter_ls=max_iter_ls)


def make_solver(method, line_search, oracle, *, batched: bool = False,
                **kwargs):
    """Close over the static configuration: ``solve(x0, bounds=None) ->
    SolveResult`` through :func:`batch_minimize` (``batched``) or
    :func:`minimize`.  (JAX returns it jitted; eager PyTorch has nothing
    to compile.)"""
    fn = batch_minimize if batched else minimize

    def solve(x0, bounds=None):
        return fn(method, line_search, oracle, x0, bounds=bounds, **kwargs)

    return solve
