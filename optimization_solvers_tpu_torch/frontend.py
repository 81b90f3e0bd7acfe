"""One-call front end: ``optimization_solvers_tpu_torch.minimize(f, x0, ...)``.

Counterpart of ``optimization_solvers_tpu/frontend.py``.  Three routes are
ported:

* ``method="lbfgsb"`` onto two kernels: K1 (:mod:`.ops.fused_lbfgsb`, one
  warp per instance, the whole instance in shared memory) takes the batch
  wherever one instance fits a block's shared memory
  (:func:`.ops.fused_lbfgsb.fits`, counting a log-sum-exp's rows): K1
  compiles every functor of the library, and on the CPU its plain version
  takes any torch callable; every batch past that fit goes to K2, the tall
  kernel (:mod:`.ops.fused_lbfgsb_tall`, one block per instance, state in
  device memory): config 4's 10,000-dim log-sum-exp.  The JAX front end
  routes the same way, by the TPU kernels' VMEM footprint
  (``frontend.py:391-425`` there): the two chips hold different amounts on
  chip, so the boundary moves.  The lockstep solver
  (:mod:`.solvers.lbfgsb`, no kernel) takes what the kernels do not, as in
  JAX (:func:`lockstep_lbfgsb`): a 1-D ``x0``, an oracle, an option only it
  honours, and on CUDA an objective without a ``kernel_form``.
* the template methods -- first-order ``gd``, ``cd``, ``pgd``, ``pnorm``,
  ``spg`` and ``ncg``, dense quasi-Newton ``bfgs``, ``dfp``, ``broyden``,
  ``bfgsb``, ``dfpb``, ``broydenb`` and ``sr1b``, ``lbfgs``, and the Newton
  family ``newton``, ``pn`` (alias ``projected_newton``) and ``spn`` -- with
  their default searches or a ``search=`` of :mod:`.linesearch`, through
  :func:`.solvers.batch_minimize` onto the generic driver kernel K3
  (:mod:`.ops.fused_driver`; the Newton family runs its Newton form).
  A single instance (a 1-D ``x0``) runs the lockstep loop of
  :func:`.solvers.minimize` (JAX ``frontend.py:503``), as does a batch
  that ``batch_minimize`` does not send to K3: on a CUDA ``x0`` also a
  callable without a kernel form, or an objective whose functor the chosen
  form of K3 does not compile (JAX ``solvers/driver.py:318-365`` takes the
  lockstep loop for what its kernel cannot take);
* ``method="newton_cg"`` through :func:`.solvers.newton_cg_batch_minimize`
  onto the Newton-CG kernel K4 (:mod:`.ops.fused_newton_cg`) where K4
  compiles the objective's functor and an instance fits, else onto the
  lockstep Newton-CG loop, the XLA twin's port, which the JAX front end
  runs for every batch (``solvers/newton_cg.py:newton_cg_batch_minimize``
  there); a 1-D ``x0`` runs :func:`.solvers.newton_cg_minimize`.

The rule is the same on both devices; x0's device then picks the version:
a CPU tensor runs the plain PyTorch version of the chosen kernel, a CUDA
tensor the hand-written CUDA kernel.  An ``x0`` that is not a tensor goes
to the GPU.

Example::

    import optimization_solvers_tpu_torch as ostt
    res = ostt.minimize(ostt.problems.rosenbrock(), x0_batch.cuda(),
                        method="lbfgsb", bounds=(-5.0, 5.0), tol=1e-3)
    res = ostt.minimize(ostt.problems.diag_quadratic(d), x0_batch.cuda(),
                        method="gd", tol=1e-6, max_iter=3000)
    res = ostt.minimize(ostt.problems.rosenbrock(), x0_batch.cuda(),
                        method="bfgs", tol=2e-4, scale_b0=True,
                        restart_on_degeneracy=True, max_iter=1500)
    res = ostt.minimize(ostt.problems.quadratic(Q), x0_batch.cuda(),
                        method="pn", bounds=(-2.0, 2.0), max_iter=50)
    res = ostt.minimize(ostt.problems.rosenbrock(), x0_batch.cuda(),
                        method="newton_cg", bounds=(-5.0, 5.0), tol=1e-3,
                        max_iter=600, cg_max=12)
"""

from __future__ import annotations

import dataclasses

import torch

from . import linesearch as ls
from .core.oracle import Oracle, make_oracle
from .ops import fused_lbfgsb
from .ops.batched_oracle import kernel_functor
from .ops.fused_lbfgsb import lbfgsb_solve_fused
from .ops.fused_lbfgsb_tall import lbfgsb_solve_fused_tall
from .solvers import lbfgs, newton, nonlinear_cg, quasi_newton, steepest
from .solvers.driver import as_batch, batch_minimize
from .solvers.driver import minimize as minimize_single
from .solvers.lbfgsb import (LbfgsbConfig, lbfgsb_batch_minimize,
                             lbfgsb_minimize)
from .solvers.newton_cg import (NewtonCGConfig, newton_cg_batch_minimize,
                                newton_cg_minimize)

# LbfgsbConfig fields only the lockstep dcsrch solver honours: a value
# other than the default routes the call there
_LOCKSTEP_ONLY = ("ls_c2", "rel_pg_stop", "verbose", "curvature_eps")
# keywords of the JAX front end whose machinery is not ported yet
_NOT_PORTED = {"precision": "item 10", "polish_max_iter": "item 10"}

# name: (method factory, the field tol fills, default search, bounded) --
# the template methods, as in the JAX front end's table
_TEMPLATE = {
    "gd": (steepest.GradientDescent, "grad_tol", ls.BackTracking, False),
    "cd": (steepest.CoordinateDescent, "grad_tol", ls.BackTracking, False),
    "pgd": (steepest.ProjectedGradientDescent, "grad_tol", ls.BackTrackingB,
            True),
    "pnorm": (steepest.PnormDescent, "grad_tol", ls.BackTracking, False),
    "spg": (steepest.SpectralProjectedGradient, "grad_tol", ls.GLLQuadratic,
            True),
    "bfgs": (quasi_newton.BFGS, "tol", ls.MoreThuente, False),
    "dfp": (quasi_newton.DFP, "tol", ls.MoreThuente, False),
    "broyden": (quasi_newton.Broyden, "tol", ls.MoreThuente, False),
    "bfgsb": (quasi_newton.BFGSB, "tol", ls.MoreThuenteB, True),
    "dfpb": (quasi_newton.DFPB, "tol", ls.MoreThuenteB, True),
    "broydenb": (quasi_newton.BroydenB, "tol", ls.MoreThuenteB, True),
    "sr1b": (quasi_newton.SR1B, "tol", ls.MoreThuenteB, True),
    "ncg": (nonlinear_cg.NonlinearCG, "grad_tol", ls.BackTracking, False),
    "lbfgs": (lbfgs.LBFGS, "tol", ls.HagerZhang, False),
    "newton": (newton.Newton, "tol", ls.MoreThuente, False),
    "pn": (newton.ProjectedNewton, "grad_tol", ls.BackTrackingB, True),
    "spn": (newton.SpectralProjectedNewton, "grad_tol", ls.BackTrackingB,
            True),
}
_ALIASES = {"gradient_descent": "gd", "coordinate_descent": "cd",
            "projected_gradient": "pgd", "projected_newton": "pn",
            "nonlinear_cg": "ncg", "l_bfgs": "lbfgs"}
# policy="fast" overlays of the JAX front end: the alternating BB scalar
# for spg (conv 0.985 -> 1.000 on config 3 in the JAX package's records) and
# the Newton-metric BB pair for spn (2 iterations instead of the reference
# update's BB freeze); a user option always wins.  Besides, in float32 a
# default More-Thuente search gains the approximate-Wolfe acceptance (JAX
# frontend.py:479-484)
_FAST_METHOD_OVERLAY = {"spg": {"bb_variant": "alternate"},
                        "spn": {"precond_bb": True}}


def takes_k1(f, x0, m, data=()) -> bool:
    """Whether ``minimize`` sends this batch to K1 rather than to the tall
    kernel K2, decided by the fit alone, as JAX's route decides by K1's
    footprint: one instance of width n with history m (and, for a
    log-sum-exp, the rows of its ``A``) fits a block's shared memory.  K1
    compiles every functor of the library; a callable without a kernel form
    reaches here only on the CPU, where K1's plain version takes it."""
    rows = (kernel_functor(f, data)[1]
            if getattr(f, "functor", None) == "LOG_SUM_EXP" else 0)
    return fused_lbfgsb.fits(x0.shape[-1], m, x0.element_size(), rows)


def _bounds(bounds, x0):
    """``(lower, upper)``: ``(n,)``, or ``(B, n)`` per instance."""
    n = x0.shape[-1]
    if bounds is None:
        inf = torch.full((n,), float("inf"), dtype=x0.dtype, device=x0.device)
        return -inf, inf
    lo, up = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
              for b in bounds)
    if x0.dim() == 2 and (lo.dim() == 2 or up.dim() == 2):
        # per-instance (B, n) boxes
        return (lo.expand(x0.shape).contiguous(),
                up.expand(x0.shape).contiguous())
    return lo.expand(n).contiguous(), up.expand(n).contiguous()


def minimize(f, x0, method: str = "lbfgs", *, bounds=None, data=(),
             tol: float | None = None, max_iter: int = 1000,
             max_iter_ls=None, search=None, policy: str = "fast",
             **options):
    """Minimize a scalar objective from a batch of starts ``x0`` (B, n).

    ``f`` is an objective of :mod:`.core.problems`, an oracle from
    :func:`.core.oracle.make_oracle` (template methods) or, on the CPU, any
    torch callable ``f(x, *data)``.  A torch ``x0`` keeps its device; any
    other ``x0`` goes to the GPU.  ``bounds`` is ``(lower, upper)``:
    scalars, ``(n,)`` or, for ``lbfgsb``, per-instance ``(B, n)``; ``None``
    means unbounded.  ``tol`` defaults to 1e-6 for float64 and 1e-4 for
    float32.  Float ``data`` is cast to x0's dtype.  ``policy`` is
    ``"fast"`` or ``"reference"``.

    ``method="lbfgsb"``: ``factr`` defaults to 1e7 (float64) and 100
    (float32); ``"reference"`` runs the tall kernel's line search as MINPACK
    dcsrch unless ``tall_line_search`` is given; ``max_iter_ls`` defaults to
    20; extra options name :class:`LbfgsbConfig` fields (``m``, ``pgtol``,
    ``ls_c1``, ``tall_line_search``, ``ls_c2``, ...).  It runs its own line
    search, so a ``search`` raises ``ValueError``.  A 1-D ``x0``, an
    oracle, a non-default ``ls_c2``, ``rel_pg_stop``, ``verbose`` or
    ``curvature_eps``, or a CUDA ``x0`` with a callable that has no
    ``kernel_form`` run the lockstep solver (``solvers.lbfgsb_minimize`` /
    ``lbfgsb_batch_minimize``) on x0's device.

    Template methods (``gd``, ``cd``, ``pgd``, ``pnorm``, ``spg``,
    ``ncg``, ``bfgs``, ``dfp``, ``broyden``, ``bfgsb``, ``dfpb``,
    ``broydenb``, ``sr1b``, ``lbfgs``, ``newton``, ``pn``, ``spn``):
    ``tol`` fills the first-order methods' and PN's and SPN's
    ``grad_tol`` and the quasi-Newton methods' and Newton's ``tol``;
    ``search`` overrides the default search (Armijo backtracking, GLL,
    More-Thuente for the dense quasi-Newton methods and ``newton``,
    Hager-Zhang for ``lbfgs``, bounded backtracking for ``pn`` and
    ``spn``), ``max_iter_ls`` defaults to 40, extra options name fields of
    the method's config (``inverse_p`` for ``pnorm``, ``variant`` for
    ``ncg``, ``scale_b0`` for the dense quasi-Newton methods, ``m`` for
    ``lbfgs``, ``precond_bb`` for ``spn``, ...); ``policy="fast"`` runs
    ``spg`` with ``bb_variant="alternate"``, ``spn`` with
    ``precond_bb=True`` and, in float32, a default More-Thuente search
    with ``approx_wolfe=True``.  The bounded methods (``pgd``, ``spg``,
    ``pn``, ``spn`` and the ``...b`` quasi-Newton methods) need
    ``bounds``, the others refuse them.  Dense quasi-Newton instances may
    exit STALLED (6).  On CUDA a batch whose objective the chosen form of
    K3 does not compile (a torch callable; ``quadratic`` and
    ``log_sum_exp`` with a first-order method and an Armijo-family search,
    K3's first-order form) runs the lockstep loop on the card.

    ``method="newton_cg"``: bounds are scalars or ``(n,)`` (``None``:
    unbounded; per-instance boxes raise ``ValueError``, as JAX's branch
    cannot take them either); ``factr`` defaults to 1e7 (float64) and 100
    (float32), ``pgtol`` to ``tol``; ``max_iter_ls`` passes through; extra
    options name :class:`NewtonCGConfig` fields (``cg_max``, ``c1``, ...).
    It runs its own line search, so a ``search`` raises ``ValueError``.
    K4 takes a batch whose objective has a K4 functor and whose instance
    fits a block's shared memory; an oracle, a torch callable and a wider
    batch run the lockstep Newton-CG loop on x0's device.

    A 1-D ``x0`` is one instance: the template methods run it through
    :func:`.solvers.minimize`, ``lbfgsb`` through
    :func:`.solvers.lbfgsb_minimize`, ``newton_cg`` through
    :func:`.solvers.newton_cg_minimize`, and the result has no batch axis.

    An unknown option raises ``TypeError``, as in the JAX front end; an
    option whose machinery is not ported yet raises
    ``NotImplementedError`` naming its ROADMAP item."""
    if policy not in ("fast", "reference"):
        raise ValueError(
            f"policy must be 'fast' or 'reference', got {policy!r}")
    unported = sorted(set(options) & set(_NOT_PORTED))
    if unported:
        raise NotImplementedError(
            f"option(s) {unported} are not ported yet (ROADMAP.md Queue 1 "
            f"{', '.join(_NOT_PORTED[k] for k in unported)})")
    x0 = as_batch(x0)
    if not x0.dtype.is_floating_point:
        x0 = x0.to(torch.get_default_dtype())
    data = tuple(torch.as_tensor(c, device=x0.device) for c in data)
    data = tuple(c.to(x0.dtype) if c.is_floating_point() else c
                 for c in data)
    if tol is None:
        tol = 1e-6 if x0.dtype == torch.float64 else 1e-4
    name = method.lower().replace("-", "_")
    if name in ("lbfgsb", "l_bfgs_b"):
        if search is not None:
            raise ValueError(
                "method 'lbfgsb' runs its own line search (ls_c1, "
                "tall_line_search); search= applies to the template methods")
        return _lbfgsb(f, x0, bounds, data, tol, max_iter, max_iter_ls,
                       policy, options)
    if name == "newton_cg":
        if search is not None:
            raise ValueError(
                "method 'newton_cg' runs its own line search (c1, "
                "max_iter_ls); search= applies to the template methods")
        return _newton_cg(f, x0, bounds, data, tol, max_iter, max_iter_ls,
                          options)
    return _template(f, x0, method, bounds, data, tol, max_iter, max_iter_ls,
                     search, policy, options)


def lockstep_lbfgsb(f, x0, cfg) -> bool:
    """Whether ``minimize`` runs this L-BFGS-B call on the lockstep solver
    (:mod:`.solvers.lbfgsb`) rather than on K1 or K2, as JAX
    ``frontend.py:327-433`` routes: one instance (a 1-D ``x0``), an
    oracle, an option only the lockstep solver honours (``ls_c2``,
    ``rel_pg_stop``, ``verbose``, ``curvature_eps`` other than the
    default), or a CUDA ``x0`` whose objective has no ``kernel_form`` (the
    kernels compile functors)."""
    default = LbfgsbConfig()
    return (x0.dim() != 2 or isinstance(f, Oracle)
            or any(getattr(cfg, k) != getattr(default, k)
                   for k in _LOCKSTEP_ONLY)
            or (x0.device.type == "cuda" and not hasattr(f, "kernel_form")))


def _lbfgsb(f, x0, bounds, data, tol, max_iter, max_iter_ls, policy, options):
    lower, upper = _bounds(bounds, x0)
    factr = options.pop("factr", 1e7 if x0.dtype == torch.float64 else 100.0)
    if policy == "reference":
        options.setdefault("tall_line_search", "dcsrch")
    fields = set(LbfgsbConfig.__dataclass_fields__)
    cfg = LbfgsbConfig(
        pgtol=options.pop("pgtol", tol), factr=factr, max_iter=max_iter,
        max_iter_ls=20 if max_iter_ls is None else max_iter_ls,
        **{k: options.pop(k) for k in list(options) if k in fields})
    if options:
        raise TypeError(f"unknown lbfgsb option(s) {sorted(options)}")
    if lockstep_lbfgsb(f, x0, cfg):
        oracle = f if isinstance(f, Oracle) else make_oracle(f, data=data)
        if x0.dim() == 2:
            return lbfgsb_batch_minimize(oracle, x0, lower, upper, cfg)
        return lbfgsb_minimize(oracle, x0, lower, upper, cfg)
    kw = dict(m=cfg.m, pgtol=cfg.pgtol, factr=cfg.factr,
              max_iter=cfg.max_iter, max_iter_ls=max(cfg.max_iter_ls, 20),
              c1=cfg.ls_c1)
    if takes_k1(f, x0, cfg.m, data):
        return lbfgsb_solve_fused(f, x0, lower, upper, data, **kw)
    return lbfgsb_solve_fused_tall(f, x0, lower, upper, data,
                                   line_search=cfg.tall_line_search, **kw)


def _newton_cg(f, x0, bounds, data, tol, max_iter, max_iter_ls, options):
    """JAX ``frontend.py:435-458``; a batch runs K4 or the lockstep loop
    (:func:`.solvers.newton_cg_batch_minimize`)."""
    n = x0.shape[-1]
    if bounds is None:
        inf = torch.full((n,), float("inf"), dtype=x0.dtype, device=x0.device)
        lower, upper = -inf, inf
    else:
        lo, up = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                  for b in bounds)
        if lo.dim() > 1 or up.dim() > 1:
            raise ValueError(
                "method 'newton_cg' takes bounds shared by the batch (scalars "
                f"or ({n},)), not per-instance boxes")
        lower, upper = lo.expand(n).contiguous(), up.expand(n).contiguous()
    factr = options.pop("factr", 1e7 if x0.dtype == torch.float64 else 100.0)
    if max_iter_ls is not None:
        options.setdefault("max_iter_ls", max_iter_ls)
    fields = set(NewtonCGConfig.__dataclass_fields__)
    cfg = NewtonCGConfig(
        pgtol=options.pop("pgtol", tol), factr=factr, max_iter=max_iter,
        **{k: options.pop(k) for k in list(options) if k in fields})
    if options:
        raise TypeError(f"unknown newton_cg option(s) {sorted(options)}")
    oracle = f if isinstance(f, Oracle) else make_oracle(f, data=data)
    fn = newton_cg_batch_minimize if x0.dim() == 2 else newton_cg_minimize
    return fn(oracle, x0, lower, upper, cfg)


def _template(f, x0, method, bounds, data, tol, max_iter, max_iter_ls,
              search, policy, options):
    name = method.lower().replace("-", "_").replace(" ", "_")
    name = _ALIASES.get(name, name)
    if name not in _TEMPLATE:
        raise ValueError(
            f"unknown method {name!r}; choose from "
            f"{sorted(_TEMPLATE) + ['lbfgsb', 'newton_cg']}")
    factory, tol_field, default_search, needs_bounds = _TEMPLATE[name]
    m = factory(**{tol_field: tol})
    fields = set(type(m).__dataclass_fields__)
    chosen = {k: options[k] for k in options if k in fields}
    if chosen:
        m = dataclasses.replace(m, **chosen)
    if policy == "fast":
        overlay = {k: v for k, v in _FAST_METHOD_OVERLAY.get(name, {}).items()
                   if k not in options}
        if overlay:
            m = dataclasses.replace(m, **overlay)
    unknown = set(options) - fields
    if unknown:
        raise TypeError(
            f"unknown option(s) {sorted(unknown)} for method {method!r}")
    if getattr(m, "inverse_p", False) is None:
        raise ValueError(
            "method 'pnorm' requires the inverse_p option "
            "(the inverse preconditioner matrix, pnorm_descent.rs:30-37)")
    if max_iter_ls is None:
        max_iter_ls = 40
    s = search if search is not None else default_search()
    if (policy == "fast" and search is None and x0.dtype == torch.float32
            and getattr(s, "approx_wolfe", None) is False):
        # the strong-Wolfe Armijo half is cancellation-undecidable near a
        # minimizer in float32; add the approximate-Wolfe acceptance
        s = dataclasses.replace(s, approx_wolfe=True)
    if needs_bounds and bounds is None:
        raise ValueError(f"method {method!r} requires bounds=(lower, upper)")
    if bounds is not None:
        n = x0.shape[-1]
        bounds = tuple(torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
                       .expand(n) for b in bounds)
        if not needs_bounds:
            raise ValueError(
                f"method {method!r} is unconstrained; use its bounded "
                "sibling (pgd/spg/pn/spn/bfgsb/dfpb/broydenb/sr1b/lbfgsb) "
                "for box constraints")
    oracle = f if isinstance(f, Oracle) else make_oracle(
        f, data=data, with_hessian=m.needs_hessian)
    solve = batch_minimize if x0.dim() == 2 else minimize_single
    return solve(m, s, oracle, x0, bounds=bounds, max_iter=max_iter,
                 max_iter_ls=max_iter_ls)
