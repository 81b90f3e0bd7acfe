"""One-call front end: ``optimization_solvers_tpu_torch.minimize(f, x0, ...)``.

Counterpart of ``optimization_solvers_tpu/frontend.py``; so far it carries
the batched ``method="lbfgsb"`` route onto two kernels:

* K1 (:mod:`.ops.fused_lbfgsb`, one warp per instance, the whole instance
  in shared memory) takes the batch when its objective is one of K1's
  functors (or, on the CPU, any torch callable) and one instance fits a
  block's shared memory (:func:`.ops.fused_lbfgsb.fits`);
* every other batch goes to K2, the tall kernel
  (:mod:`.ops.fused_lbfgsb_tall`, one block per instance, state in device
  memory): config 4's 10,000-dim log-sum-exp, any ``quadratic``.

The rule is the same on both devices; x0's device then picks the version:
a CPU tensor runs the plain PyTorch version of the chosen kernel, a CUDA
tensor the hand-written CUDA kernel.  The JAX front end picks by the TPU
kernels' VMEM footprint instead (``frontend.py:391-425`` there): the two
chips hold different amounts on chip, so the boundary moves.

Example::

    import optimization_solvers_tpu_torch as ostt
    res = ostt.minimize(ostt.problems.rosenbrock(), x0_batch.cuda(),
                        method="lbfgsb", bounds=(-5.0, 5.0), tol=1e-3)
"""

from __future__ import annotations

import torch

from .ops import fused_lbfgsb
from .ops.fused_lbfgsb import lbfgsb_solve_fused
from .ops.fused_lbfgsb_tall import lbfgsb_solve_fused_tall
from .solvers.lbfgsb import LbfgsbConfig

# LbfgsbConfig fields only the lockstep dcsrch solver honours
_LOCKSTEP_ONLY = ("ls_c2", "rel_pg_stop", "verbose", "curvature_eps")
# keywords of the JAX front end whose machinery is not ported yet
_NOT_PORTED = {"search": "items 7-9", "precision": "item 10",
               "polish_max_iter": "item 10"}


def takes_k1(f, x0, m) -> bool:
    """Whether ``minimize`` sends this batch to K1 rather than to the tall
    kernel K2: K1 compiles ``f``'s functor (a callable without a kernel
    form runs only on the CPU, where any callable qualifies) and one
    instance of width n with history m fits a block's shared memory."""
    functor = getattr(f, "functor", None)
    if functor is not None and functor not in fused_lbfgsb.K1_OBJECTIVES:
        return False
    return fused_lbfgsb.fits(x0.shape[-1], m, x0.element_size())


def _bounds(bounds, x0):
    B, n = x0.shape
    if bounds is None:
        inf = torch.full((n,), float("inf"), dtype=x0.dtype, device=x0.device)
        return -inf, inf
    lo, up = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device)
              for b in bounds)
    if lo.dim() == 2 or up.dim() == 2:
        # per-instance (B, n) boxes
        return (lo.expand(B, n).contiguous(), up.expand(B, n).contiguous())
    return lo.expand(n).contiguous(), up.expand(n).contiguous()


def minimize(f, x0, method: str = "lbfgs", *, bounds=None, data=(),
             tol: float | None = None, max_iter: int = 1000,
             max_iter_ls=None, policy: str = "fast", **options):
    """Minimize a scalar objective from a batch of starts ``x0`` (B, n).

    ``f`` is an objective of :mod:`.core.problems` or, on the CPU, any
    torch callable ``f(x, *data)``.  ``bounds`` is ``(lower, upper)``:
    scalars, ``(n,)`` or per-instance ``(B, n)``; ``None`` means unbounded.
    ``tol`` defaults to 1e-6 for float64 and 1e-4 for float32, ``factr``
    to 1e7 and 100.  Float ``data`` is cast to x0's dtype.  ``policy`` is
    ``"fast"`` or ``"reference"``; ``"reference"`` runs the tall kernel's
    line search as MINPACK dcsrch (the Fortran core's pairing) unless
    ``tall_line_search`` is given.  Extra options name
    :class:`LbfgsbConfig` fields (``m``, ``pgtol``, ``ls_c1``,
    ``tall_line_search``, ...); an unknown one raises ``TypeError``; one of
    the JAX front end whose machinery is not ported yet (``search``,
    ``precision``, ``polish_max_iter``, the lockstep-only config fields)
    raises ``NotImplementedError``."""
    if policy not in ("fast", "reference"):
        raise ValueError(
            f"policy must be 'fast' or 'reference', got {policy!r}")
    unported = sorted(set(options) & set(_NOT_PORTED))
    if unported:
        raise NotImplementedError(
            f"option(s) {unported} are not ported yet (ROADMAP.md Queue 1 "
            f"{', '.join(_NOT_PORTED[k] for k in unported)})")
    name = method.lower().replace("-", "_")
    if name not in ("lbfgsb", "l_bfgs_b"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet; only 'lbfgsb' is "
            "(ROADMAP.md Queue 1 items 7-9)")
    x0 = torch.as_tensor(x0)
    if x0.dim() != 2:
        raise NotImplementedError(
            "single-instance (1-D x0) L-BFGS-B runs the lockstep solver, "
            "not ported yet (ROADMAP.md Queue 1 item 3); pass x0 as (1, n)")
    if not x0.dtype.is_floating_point:
        x0 = x0.to(torch.get_default_dtype())
    data = tuple(torch.as_tensor(c, device=x0.device) for c in data)
    data = tuple(c.to(x0.dtype) if c.is_floating_point() else c
                 for c in data)
    if tol is None:
        tol = 1e-6 if x0.dtype == torch.float64 else 1e-4
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
    default = LbfgsbConfig()
    lockstep = [k for k in _LOCKSTEP_ONLY
                if getattr(cfg, k) != getattr(default, k)]
    if lockstep:
        raise NotImplementedError(
            f"option(s) {lockstep} need the lockstep dcsrch L-BFGS-B, not "
            "ported yet (ROADMAP.md Queue 1 item 3)")
    if x0.device.type == "cuda" and not hasattr(f, "kernel_form"):
        raise NotImplementedError(
            "on CUDA the objective needs a kernel_form (core.problems); "
            "arbitrary torch callables wait for the lockstep solver "
            "(ROADMAP.md Queue 1 item 3)")
    kw = dict(m=cfg.m, pgtol=cfg.pgtol, factr=cfg.factr,
              max_iter=cfg.max_iter, max_iter_ls=max(cfg.max_iter_ls, 20),
              c1=cfg.ls_c1)
    if takes_k1(f, x0, cfg.m):
        return lbfgsb_solve_fused(f, x0, lower, upper, data, **kw)
    return lbfgsb_solve_fused_tall(f, x0, lower, upper, data,
                                   line_search=cfg.tall_line_search, **kw)
