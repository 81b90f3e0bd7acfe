"""The generic whole-solve driver K3: one CUDA kernel on the GPU, and its
plain PyTorch version.

Replaces the TPU kernel ``optimization_solvers_tpu/ops/pallas_driver.py``
(``fused_minimize``, kernel body ``_make_kernel``) for all its method specs:
GD, CD, Pnorm, PGD, SPG, NCG (the first-order form), dense quasi-Newton QN
and QNB (updates bfgs, dfp, broyden, sr1) and L-BFGS (the quasi-Newton
form), and Newton, ProjectedNewton and SpectralProjectedNewton (the Newton
form), with the search specs NoSearch, BackTracking, BackTrackingB,
GLLQuadratic (the Armijo family) and MoreThuente, MoreThuenteB, HagerZhang,
HagerZhangB and StrongWolfe (MINPACK dcsrch; the Wolfe family).  Both
versions here run the TPU kernel's algorithm:

* x0 is clipped into the box for the bounded methods (PGD, SPG, QNB, PN,
  SPN), and so is every accepted point;
* each iteration takes a direction, runs the search's trial loop until a
  trial is accepted or ``max_iter_ls`` trips are spent, and re-evaluates
  value and gradient at the new point.  The Armijo family evaluates the
  value alone at a trial and, on exhaustion, takes the last, untested
  update of ``t``; the Wolfe family evaluates value and gradient at a
  trial.  On exhaustion More-Thuente takes its last trial step, dcsrch its
  best step ``stx`` and Hager-Zhang its best trial;
* the Newton form writes the instance's dense Hessian at every direction,
  factors it by a right-looking Cholesky with the pivot test ``piv <= eps
  max(max|diag H|, 1)`` (``eps`` the TPU kernel's literal 1.2e-7 / 2.3e-16,
  ``pallas_driver.py:791``) and pivots ``sqrt(max(piv, eps))``, and solves
  by forward and back substitution; a factor that failed the test or a
  solve that is not finite takes the method's fallback direction;
* status: CONVERGED where converged and finite, else MAX_ITER_REACHED at
  the budget, else OUT_OF_DOMAIN where f is not finite.

Like the TPU kernel, and unlike the JAX lockstep driver, a lane that
converges exactly at the budget reports CONVERGED, and an out-of-domain
trial shrinks ``t`` within the one trial budget
(``pallas_driver.py:38-43``).  More-Thuente evaluates, per trip, the trial
``t``, then (unless ``t`` is accepted) the interval end ``tl``, and the
other end ``tu`` only where the case-4 step needs it: the evaluations
whose values the TPU kernel computes and then discards in a finishing trip
or outside case 4 are not made, so ``nfev`` counts fewer, and every step
is the same.

:func:`fused_minimize` takes the plain version for a CPU ``x0`` and
launches ``csrc/driver.cu`` (the first-order form's kernel in
``csrc/driver_first.cuh`` on the lane layouts of ``csrc/lanes.cuh``, the
kernel template of the other forms in ``csrc/driver.cuh``, the
quasi-Newton form built in ``csrc/driver_qn.cu``, the dense form of QN and
QNB in ``csrc/driver_dense.cu``, the Newton form in
``csrc/driver_newton.cu``) for a CUDA ``x0``; it never falls back from one
to the other.  The dense form runs one block per instance and keeps the
instance's slab (``csrc/dense_slab.cuh``: the packed upper triangle of the
symmetric kinds, Broyden's full matrix) in the block's shared memory where
it fits beside the vectors, else in a device-memory workspace
(:func:`dense_in_shared`; ``fused_minimize.placements`` counts the
launches of each).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from .. import linesearch as ls
from ..core.numerics import (batched_pg_inf_norm, rust_clamp, rust_max,
                             rust_min, sign)
from ..core.types import SolveResult, Status
from ..linesearch.base import max_feasible_step
from ..linesearch.dcsrch import _dcstep
from ..linesearch.morethuente import (_cubic_minimizer, _quadratic_minimizer_1,
                                      _quadratic_minimizer_2, _update_interval)
# the method configs only; solvers.driver imports this module
from ..solvers import lbfgs, newton, nonlinear_cg, quasi_newton, steepest
from . import fused_newton
from .batched_oracle import (KERNEL_OBJECTIVES, batched_hessian,
                             batched_value, batched_value_and_grad,
                             kernel_operands)

# method and search codes of csrc/driver.cuh
GD, CD, PNORM, PGD, SPG, NCG, QN, QNB, LBFGS, NEWTON, PN, SPN = range(12)
NEWTON_METHODS = (NEWTON, PN, SPN)
NOSEARCH, BT, BTB, GLL, MT, MTB, HZ, HZB, SW = range(9)
NCG_VARIANTS = {"fr": 0, "pr+": 1, "hs": 2, "dy": 3}
# the dense update rules; any other name is SR1, as in the TPU kernel's
# _QNSpec (pallas_driver.py:532)
QN_UPDATES = {"bfgs": 0, "dfp": 1, "broyden": 2, "sr1": 3}
# the quasi-Newton form's curvature floor and the Newton form's pivot
# floor: the TPU kernel's literals (pallas_driver.py:475, :700-702, :791),
# not finfo(dtype).eps
QN_EPS = {torch.float32: 1.2e-7, torch.float64: 2.3e-16}
# kSmemPerBlock of csrc/common.cuh, and the functors each form of K3
# compiles: the first-order form (driver.cu) two, the quasi-Newton and
# Wolfe forms (driver_qn.cu, driver_qn_data.cu), the dense form
# (driver_dense.cu) and the Newton form (driver_newton.cu, with their
# Hessians) all four
SMEM_PER_BLOCK = 232448
NEWTON_WORDS = 32          # csrc/driver.cuh kNewtonWords
DENSE_WORDS = 8            # csrc/driver.cuh kDenseWords
LANE_M = 32                # csrc/driver.cuh kLaneM: pairs the compact form holds
DENSE_METHODS = (QN, QNB)
K3_FIRST_ORDER_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES")
K3_OBJECTIVES = ("ROSENBROCK", "WEIGHTED_SQUARES", "QUADRATIC", "LOG_SUM_EXP")
KERNEL = "the CUDA driver kernel K3"
LOCKSTEP = ("solvers.batch_minimize, whose fused='auto' takes it on a CUDA "
            "x0")


@dataclasses.dataclass(frozen=True, eq=False)
class K3Spec:
    """A (method, line search) pair as K3's integer codes and parameters."""

    method: int
    search: int
    bounded: bool
    tol: float
    lam_min: float = 0.0
    lam_max: float = 0.0
    alternate: bool = False
    ncg_variant: int = 0
    restart_every: int = 0
    pinv: Optional[torch.Tensor] = None
    qn_update: int = 0
    scale_b0: bool = False
    restart: bool = False
    lbfgs_m: int = 0
    curv_eps: float = 0.0
    c1: float = 0.0
    beta: float = 0.5
    ring: int = 0
    sigma1: float = 0.0
    sigma2: float = 0.0
    precond_bb: bool = False
    search_bounded: bool = False
    # More-Thuente
    c2: float = 0.0
    t_min: float = 0.0
    t_max: float = math.inf
    delta: float = 0.0
    approx_wolfe: bool = False
    aw_eps: float = 0.0
    # Hager-Zhang (delta above)
    sigma: float = 0.0
    eps: float = 0.0
    theta: float = 0.0
    gamma: float = 0.0
    rho: float = 0.0
    # dcsrch (c1, c2 above)
    xtol: float = 0.0
    stp_min: float = 0.0
    stp_max: float = math.inf
    xtrapl: float = 0.0
    xtrapu: float = 0.0


def _method_fields(method) -> Optional[dict]:
    if isinstance(method, newton.SpectralProjectedNewton):
        return dict(method=SPN, tol=float(method.grad_tol),
                    lam_min=float(method.lambda_min),
                    lam_max=float(method.lambda_max),
                    precond_bb=bool(method.precond_bb))
    if isinstance(method, newton.ProjectedNewton):
        return dict(method=PN, tol=float(method.grad_tol))
    if isinstance(method, newton.Newton):
        return dict(method=NEWTON, tol=float(method.tol))
    if isinstance(method, lbfgs.LBFGS):
        return dict(method=LBFGS, tol=float(method.tol),
                    lbfgs_m=int(method.m),
                    curv_eps=float(method.curvature_eps))
    if isinstance(method, quasi_newton._QuasiNewtonCommon):
        return dict(method=QNB if isinstance(method, quasi_newton.QuasiNewtonB)
                    else QN, tol=float(method.tol),
                    qn_update=QN_UPDATES.get(method.update, 3),
                    scale_b0=bool(method.scale_b0),
                    restart=bool(method.restart_on_degeneracy))
    if isinstance(method, steepest.SpectralProjectedGradient):
        m = dict(method=SPG, lam_min=float(method.lambda_min),
                 lam_max=float(method.lambda_max),
                 alternate=method.bb_variant == "alternate")
    elif isinstance(method, steepest.ProjectedGradientDescent):
        m = dict(method=PGD)
    elif isinstance(method, steepest.GradientDescent):
        m = dict(method=GD)
    elif isinstance(method, steepest.CoordinateDescent):
        m = dict(method=CD)
    elif isinstance(method, steepest.PnormDescent):
        if method.inverse_p is None:
            return None
        m = dict(method=PNORM, pinv=torch.as_tensor(method.inverse_p))
    elif isinstance(method, nonlinear_cg.NonlinearCG):
        m = dict(method=NCG, ncg_variant=NCG_VARIANTS[method.variant],
                 restart_every=int(method.restart_every))
    else:
        return None
    return dict(m, tol=float(method.grad_tol))


def _search_fields(line_search) -> Optional[dict]:
    s = line_search
    if isinstance(s, ls.BackTrackingB):
        return dict(search=BTB, c1=float(s.c1), beta=float(s.beta),
                    search_bounded=True)
    if isinstance(s, ls.BackTracking):
        return dict(search=BT, c1=float(s.c1), beta=float(s.beta))
    if isinstance(s, ls.GLLQuadratic):
        return dict(search=GLL, c1=float(s.c1), ring=int(s.m),
                    sigma1=float(s.sigma1), sigma2=float(s.sigma2))
    if isinstance(s, ls.NoSearch):
        return dict(search=NOSEARCH)
    if isinstance(s, ls.MoreThuente):
        if s.reference_quirks:
            return None
        bounded = isinstance(s, ls.MoreThuenteB)
        return dict(search=MTB if bounded else MT, c1=float(s.c1),
                    c2=float(s.c2), t_min=float(s.t_min),
                    t_max=float(s.t_max), delta=float(s.delta),
                    approx_wolfe=bool(s.approx_wolfe),
                    aw_eps=float(s.aw_eps), search_bounded=bounded)
    if isinstance(s, ls.HagerZhang):
        bounded = isinstance(s, ls.HagerZhangB)
        return dict(search=HZB if bounded else HZ, delta=float(s.delta),
                    sigma=float(s.sigma), eps=float(s.eps),
                    theta=float(s.theta), gamma=float(s.gamma),
                    rho=float(s.rho), search_bounded=bounded)
    if isinstance(s, ls.StrongWolfe):
        return dict(search=SW, c1=float(s.c1), c2=float(s.c2),
                    xtol=float(s.xtol), stp_min=float(s.stp_min),
                    stp_max=float(s.stp_max), xtrapl=float(s.xtrapl),
                    xtrapu=float(s.xtrapu), search_bounded=bool(s.bounded))
    return None


def build_spec(method, line_search) -> Optional[K3Spec]:
    """K3's spec for ``(method, line_search)``, or ``None`` where K3 has no
    fused form: another method or search, PnormDescent without
    ``inverse_p``,
    ``MoreThuente(reference_quirks=True)``, or a bounded search
    (BackTrackingB, MoreThuenteB, HagerZhangB, ``StrongWolfe(bounded=
    True)``) with an unbounded method -- the rules of
    ``pallas_driver.py:1620-1685``."""
    m = _method_fields(method)
    s = _search_fields(line_search)
    if m is None or s is None:
        return None
    bounded = m["method"] in (PGD, SPG, QNB, PN, SPN)
    if s.get("search_bounded") and not bounded:
        return None
    return K3Spec(bounded=bounded, **m, **s)


def fused_supported(method, line_search) -> bool:
    """True if (method, line_search) has a form in K3."""
    return build_spec(method, line_search) is not None


def dense_slab_elems(n: int, qn_update: int) -> int:
    """Elements of one dense quasi-Newton slab (``csrc/dense_slab.cuh``
    ``slab_elems``): the packed upper triangle, n (n + 1) / 2, for the
    symmetric kinds (bfgs, dfp, sr1); n rows of the odd stride ``n | 1``
    for broyden."""
    if qn_update == QN_UPDATES["broyden"]:
        return n * (n | 1)
    return n * (n + 1) // 2


def dense_in_shared(n: int, ring: int, itemsize: int, qn_update: int,
                    rows: int = 0) -> bool:
    """Where the dense form (QN, QNB) keeps an instance's slab
    (``csrc/driver.cuh`` ``dense_in_shared``): in the block's shared memory
    when it fits there beside the vectors (7 n + ring + 8 elements and a
    log-sum-exp's z of ``rows``), else in the device-memory workspace.  A
    route by shape, as K1 against K2: both placements run the same code."""
    vecs = 7 * n + ring + DENSE_WORDS + rows
    return (vecs + dense_slab_elems(n, qn_update)) * itemsize <= SMEM_PER_BLOCK


def smem_per_instance(n: int, ring: int, itemsize: int, m: int = 0,
                      method: Optional[int] = None,
                      qn_update: int = 0, rows: int = 0) -> int:
    """Shared memory one instance takes in the CUDA kernel, mirrored here so
    that the route can decide without the library.  ``rows`` is a
    log-sum-exp's (0 for the other objectives and for the first-order form,
    which does not compile it).  The first-order and quasi-Newton forms:
    ``work_elems`` of ``csrc/driver.cuh`` (7 n, the GLL history, and
    L-BFGS's S and Y rows and three values by slot: 2 m n + 3 m; where
    :func:`compact_fits`, the compact form's u, p and tables S^T Y and Y^T
    Y, 2 m + 2 m^2 more; then ``rows``) times the element size.  Every width
    the two-loop layout fits keeps fitting: the compact form only takes the
    room it finds.  The dense form (``method`` QN or QNB; one block per
    instance): ``dense_smem_elems``, 7 n, the GLL history, 8 command words
    and ``rows``, then the slab of ``qn_update`` where
    :func:`dense_in_shared`.  The Newton form (``method`` Newton, PN or
    SPN; one block per instance): ``newton_smem_elems``, the region of D,
    GN, XT and the solves' staged NB x (NB + 1) block, over which the
    blocked factorization's scratch lies (the larger of the two, rounded up
    to 4), X and G, 32 command words, the GLL history and a log-sum-exp's z
    (``rows`` elements, 0 for the other objectives; its Hessian's scratch
    lies in the region)."""
    if method in DENSE_METHODS:
        slab = (dense_slab_elems(n, qn_update)
                if dense_in_shared(n, ring, itemsize, qn_update, rows) else 0)
        return (7 * n + ring + DENSE_WORDS + rows + slab) * itemsize
    if method in NEWTON_METHODS:
        nb = fused_newton.PANEL[torch.float32 if itemsize == 4
                                else torch.float64]
        region = (max(3 * n + nb * (nb + 1),
                      fused_newton.scratch_elems(itemsize, nb)) + 3) // 4 * 4
        return (region + 2 * n + NEWTON_WORDS + ring + rows) * itemsize
    extra = (2 * m * m + 2 * m if compact_fits(n, ring, itemsize, m, rows)
             else 0)
    return (7 * n + ring + 2 * m * n + 3 * m + extra + rows) * itemsize


def compact_fits(n: int, ring: int, itemsize: int, m: int,
                 rows: int = 0) -> bool:
    """Whether L-BFGS's direction runs in the compact form of H g
    (``compact_fits`` of ``csrc/driver.cuh``): its m x m algebra on lanes,
    so m <= LANE_M, and its tables beside the vectors (and a log-sum-exp's
    z of ``rows``) in a block's shared memory; else the two-loop recursion
    runs."""
    return 1 <= m <= LANE_M and (
        7 * n + ring + 2 * m * n + 5 * m + 2 * m * m + rows) * itemsize <= (
            SMEM_PER_BLOCK)


def fits(n: int, ring: int, itemsize: int, m: int = 0,
         method: Optional[int] = None, rows: int = 0) -> bool:
    """Whether an instance of width ``n`` (and a log-sum-exp's ``rows``)
    fits a block's shared memory in the form of ``method``."""
    return smem_per_instance(n, ring, itemsize, m, method,
                             rows=rows) <= SMEM_PER_BLOCK


def first_order_form(spec: "K3Spec") -> bool:
    """Whether ``spec`` runs K3's first-order form (``qn_form`` of
    ``csrc/driver.cuh`` false: a first-order method with an Armijo-family
    search); the rest run the quasi-Newton, Wolfe, dense or Newton form."""
    return spec.method < QN and spec.search < MT


def k3_rows(spec: "K3Spec", functor, rows: int) -> int:
    """The log-sum-exp rows that ``spec``'s form holds in shared memory
    (its z): ``rows`` for a ``LOG_SUM_EXP`` functor outside the first-order
    form, which does not compile it, else 0."""
    return (rows if functor == "LOG_SUM_EXP" and not first_order_form(spec)
            else 0)


def compiled_functors(spec: "K3Spec"):
    """The functors the form of ``spec`` compiles on the card, decided by
    the form, as ``driver_launch`` (``csrc/driver.cu``) picks it from the
    method and the search: the first-order form's two, or the quasi-Newton,
    Wolfe, dense and Newton forms' four."""
    return (K3_FIRST_ORDER_OBJECTIVES if first_order_form(spec)
            else K3_OBJECTIVES)


def first_order_info(dtype, B, n, method, ring=0):
    """The launch of K3's first-order form for a ``(B, n)`` batch of
    ``dtype``, method code ``method`` and a GLL ring of ``ring`` (the
    weighted-squares functor's kernel, in the layout n takes and of the
    method's class) and its compiled resources: warps per block, resident
    blocks and warps per SM (the card's occupancy calculator), registers
    and local (spill) bytes per thread, dynamic shared memory per block,
    and the coordinates a lane holds in registers (0: the shared-memory
    layout)."""
    from . import _build

    out = (ctypes.c_int * 6)()
    rc = _build.load().driver_first_info(
        1 if dtype == torch.float64 else 0, B, n, ring, method, out)
    if rc != 0:
        raise RuntimeError(f"driver_first_info failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    wpb, blocks, regs, local, smem, lanes = list(out)
    return dict(warps_per_block=wpb, blocks_per_sm=blocks,
                warps_per_sm=wpb * blocks, registers=regs, local_bytes=local,
                smem_per_block=smem, lane_coordinates=lanes)


def _check_fits(n, ring, itemsize, m=0, method=None, rows=0):
    if not fits(n, ring, itemsize, m, method, rows):
        need = smem_per_instance(n, ring, itemsize, m, method, rows=rows)
        raise NotImplementedError(
            f"n={n} needs {need} bytes of shared memory per instance in "
            f"{KERNEL}, more than a block's {SMEM_PER_BLOCK}; such a batch "
            f"needs the lockstep loop (solvers.batch_minimize's fused='auto' "
            f"takes it)")


def workspace_elems(B: int, n: int, method: int, ring: int = 0,
                    itemsize: int = 8, qn_update: int = 0,
                    rows: int = 0) -> int:
    """Device-memory workspace of the CUDA kernel, in elements
    (``csrc/driver.cuh`` ``workspace_elems``): the Newton methods keep one
    (n, n) Hessian slab per instance there, whose Cholesky factor
    overwrites its upper triangle in place; the dense quasi-Newton methods
    one slab of ``qn_update`` per instance where it does not fit the
    block's shared memory (:func:`dense_in_shared`, counting a
    log-sum-exp's ``rows``), else none."""
    if method in NEWTON_METHODS:
        return B * n * n
    if method in DENSE_METHODS and not dense_in_shared(n, ring, itemsize,
                                                       qn_update, rows):
        return B * dense_slab_elems(n, qn_update)
    return 0


def _check_workspace(B, n, spec, itemsize, device, rows=0):
    method = spec.method
    need = workspace_elems(B, n, method, spec.ring, itemsize,
                           spec.qn_update, rows) * itemsize
    if need == 0:
        return
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        what = ("Hessian slabs" if method in NEWTON_METHODS
                else "dense quasi-Newton slabs")
        raise NotImplementedError(
            f"{B} instances of width n={n} need {need} bytes of device "
            f"memory for the {what} of {KERNEL}, more than the {free} "
            f"free; the lockstep loop needs as much: use a smaller batch")


def _spec_for(method, line_search) -> K3Spec:
    spec = build_spec(method, line_search)
    if spec is None:
        raise ValueError(
            f"no fused kernel for ({type(method).__name__}, "
            f"{type(line_search).__name__})")
    return spec


def _check_bounds(spec, method, lower, upper):
    if spec.bounded and (lower is None or upper is None):
        raise ValueError(f"{type(method).__name__} requires bounds")


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _phi(bvg, X, d, t):
    """Value and directional derivative at ``X + t d``, per instance."""
    f, g = bvg(X + t[:, None] * d)
    return f, _dot(g, d)


def _mt_plain(spec, bvg, X, d, f0, g0d, active, t_min, t_max, max_iter_ls,
              nfev):
    """More-Thuente, corrected interval update (``pallas_driver.py:
    1141-1315``), batched with per-instance masks."""
    c1, c2, delta = spec.c1, spec.c2, spec.delta
    one = torch.ones_like(f0)
    t = rust_min(rust_max(one, t_min), t_max)
    tl, tu = t_min.clone(), t_max.clone()
    modified = torch.zeros_like(active)
    int_conv = torch.zeros_like(active)
    done = ~active

    def psi_of(phi_f, phi_g, tt):
        return phi_f - f0 - c1 * tt * g0d, phi_g - c1 * g0d

    for _ in range(max_iter_ls):
        if bool(done.all()):
            break
        ft, gt = _phi(bvg, X, d, t)
        nfev.add_((~done).to(torch.int32))
        swc = ls.strong_wolfe(c1, c2, f0, ft, g0d, gt, t)
        if spec.approx_wolfe:
            swc = swc | (((2.0 * c1 - 1.0) * g0d >= gt) & (gt >= c2 * g0d)
                         & (ft <= f0 + spec.aw_eps * torch.abs(f0))
                         & (t > 0.0))
        finish = swc | int_conv | (t == tl) | (t == tu)
        go = ~done & ~finish
        if not bool(go.any()):
            break
        psi_t_f, psi_t_g = psi_of(ft, gt, t)
        modified = modified | ((psi_t_f <= 0.0) & (gt > 0.0))
        fl, gl = _phi(bvg, X, d, tl)
        nfev.add_(go.to(torch.int32))
        psi_l_f, psi_l_g = psi_of(fl, gl, tl)
        f_l = torch.where(modified, fl, psi_l_f)
        g_l = torch.where(modified, gl, psi_l_g)
        f_c = torch.where(modified, ft, psi_t_f)
        g_c = torch.where(modified, gt, psi_t_g)
        case1 = f_c > f_l
        case2 = ~case1 & (g_c * g_l < 0.0)
        case3 = ~case1 & ~case2 & (torch.abs(g_c) <= torch.abs(g_l))
        case4 = ~(case1 | case2 | case3)
        tc = _cubic_minimizer(tl, t, f_l, f_c, g_l, g_c)
        tq = _quadratic_minimizer_1(tl, t, f_l, f_c, g_l)
        ts = _quadratic_minimizer_2(tl, t, g_l, g_c)
        t1 = torch.where(torch.abs(tc - tl) < torch.abs(tq - tl), tc,
                         0.5 * (tq + tc))
        t2 = torch.where(torch.abs(tc - t) >= torch.abs(ts - t), tc, ts)
        t_plus = torch.where(torch.abs(tc - t) < torch.abs(ts - t), tc, ts)
        t_far = t + delta * (tu - t)
        t3 = torch.where(t > tl, rust_min(t_plus, t_far),
                         rust_max(t_plus, t_far))
        t4 = t
        need_u = go & case4
        if bool(need_u.any()):
            # the case-4 step needs phi at tu
            fu, gu = _phi(bvg, X, d, tu)
            nfev.add_(need_u.to(torch.int32))
            psi_u_f, psi_u_g = psi_of(fu, gu, tu)
            f_u = torch.where(modified, fu, psi_u_f)
            g_u = torch.where(modified, gu, psi_u_g)
            t4 = torch.where(need_u, _cubic_minimizer(tu, t, f_c, f_u, g_c,
                                                      g_u), t)
        t_new = torch.where(case1, t1, torch.where(
            case2, t2, torch.where(case3, t3, t4)))
        t_new = rust_clamp(t_new, t_min, t_max)
        # force progress: extrapolate while unbracketed, bisect once
        # bracketed
        no_prog = (t_new == tl) | (t_new == tu) | ~torch.isfinite(t_new)
        fallback = torch.where(torch.isfinite(tu), 0.5 * (tl + tu), 2.0 * t)
        t_new = torch.where(no_prog, rust_clamp(fallback, t_min, t_max),
                            t_new)
        tl_new, tu_new, conv_new = _update_interval(f_l, f_c, g_c, tl, t, tu)
        t = torch.where(go, t_new, t)
        tl = torch.where(go, tl_new, tl)
        tu = torch.where(go, tu_new, tu)
        int_conv = torch.where(go, conv_new, int_conv)
        done = done | finish
    return t


def _hz_plain(spec, bvg, X, d, f0, d0, active, t_max, max_iter_ls, nfev):
    """Hager-Zhang, the flattened bracket / bisect / secant machine
    (``pallas_driver.py:1483-1612``); returns the best trial step."""
    finfo = torch.finfo(f0.dtype)
    tiny, big = finfo.tiny, finfo.max
    bracket, bisect_, secant = 0, 1, 2
    delta, sigma, theta = spec.delta, spec.sigma, spec.theta
    f_eps = f0 + spec.eps * torch.abs(f0)
    a = torch.zeros_like(f0)
    da = d0.clone()
    b = torch.full_like(f0, big)
    c = torch.minimum(torch.ones_like(f0), t_max)
    mode = torch.zeros_like(f0, dtype=torch.int32)
    t_best = c.clone()
    f_best = torch.full_like(f0, big)
    shrink = torch.full_like(f0, big)
    done = ~active
    for _ in range(max_iter_ls):
        if bool(done.all()):
            break
        fc, dc = _phi(bvg, X, d, c)
        nfev.add_((~done).to(torch.int32))
        wolfe = (fc - f0 <= delta * c * d0) & (dc >= sigma * d0)
        approx = ((dc <= (2.0 * delta - 1.0) * d0) & (dc >= sigma * d0)
                  & (fc <= f_eps))
        ok = wolfe | approx | ((c >= t_max) & (dc < 0.0) & (fc <= f_eps))
        better = (fc < f_best) & (c > 0.0)
        live = ~done
        t_best = torch.where(live & (ok | better), c, t_best)
        f_best = torch.where(live & better, fc, f_best)
        to_secant = dc >= 0.0
        advance = ~to_secant & (fc <= f_eps)
        to_bisect = ~to_secant & (fc > f_eps)
        a_new = torch.where(advance, c, a)
        da_new = torch.where(advance, dc, da)
        b_new = torch.where(to_secant | to_bisect, c, b)
        grow = torch.minimum(spec.rho * c, t_max)
        bis = (1.0 - theta) * a_new + theta * b_new
        denom = dc - da_new
        sec = torch.where(torch.abs(denom) > tiny,
                          (a_new * dc - c * da_new) / denom, bis)
        width = b_new - a_new
        stalled = width > spec.gamma * shrink
        sec = torch.where((sec <= a_new) | (sec >= b_new) | stalled,
                          0.5 * (a_new + b_new), sec)
        next_mode = torch.where(to_secant, secant,
                                torch.where(to_bisect, bisect_, mode))
        in_bracket = (mode == bracket) & advance
        c_new = torch.where(in_bracket, grow,
                            torch.where(next_mode == secant, sec, bis))
        go = live & ~ok
        a = torch.where(go, a_new, a)
        da = torch.where(go, da_new, da)
        b = torch.where(go, b_new, b)
        c = torch.where(go, c_new, c)
        mode = torch.where(go, next_mode, mode)
        shrink = torch.where(go, width, shrink)
        done = done | ok
    return t_best


def _sw_plain(spec, bvg, X, d, f0, ginit, active, stpmax, max_iter_ls,
              nfev):
    """MINPACK dcsrch (``pallas_driver.py:1318-1480``): returns the step on
    a finish exit, the best step ``stx`` on exhaustion, 0 for a
    non-descent direction."""
    c2, xtol = spec.c2, spec.xtol
    xtrapl, xtrapu = spec.xtrapl, spec.xtrapu
    gtest = spec.c1 * ginit
    zero = torch.zeros_like(f0)
    stpmin = torch.full_like(f0, spec.stp_min)
    descent = ginit < 0.0
    stp = torch.where(descent, torch.clamp(torch.ones_like(f0), stpmin,
                                           stpmax), zero)
    width = stpmax - stpmin
    width1 = width / 0.5
    stx, fx, dx = zero.clone(), f0.clone(), ginit.clone()
    sty, fy, dy = zero.clone(), f0.clone(), ginit.clone()
    brackt = torch.zeros_like(active)
    stage1 = torch.ones_like(active)
    stmin, stmax = zero.clone(), stp + xtrapu * stp
    done = ~active | ~descent
    for _ in range(max_iter_ls):
        if bool(done.all()):
            break
        fp, gp = _phi(bvg, X, d, stp)
        nfev.add_((~done).to(torch.int32))
        ftest = f0 + stp * gtest
        stage1_n = stage1 & ~((fp <= ftest) & (gp >= 0.0))
        finish = (((fp <= ftest) & (torch.abs(gp) <= c2 * (-ginit)))
                  | (brackt & (stmax - stmin <= xtol * stmax))
                  | ((stp == stpmax) & (fp <= ftest) & (gp <= gtest))
                  | ((stp == stpmin) & ((fp > ftest) | (gp >= gtest)))
                  | (brackt & ((stp <= stmin) | (stp >= stmax))))
        mod = stage1_n & (fp <= fx) & (fp > ftest)
        sx, fxm, dxm, sy, fym, dym, sn, br = _dcstep(
            stx, torch.where(mod, fx - stx * gtest, fx),
            torch.where(mod, dx - gtest, dx), sty,
            torch.where(mod, fy - sty * gtest, fy),
            torch.where(mod, dy - gtest, dy), stp,
            torch.where(mod, fp - stp * gtest, fp),
            torch.where(mod, gp - gtest, gp), brackt, stmin, stmax)
        fxm = torch.where(mod, fxm + sx * gtest, fxm)
        fym = torch.where(mod, fym + sy * gtest, fym)
        dxm = torch.where(mod, dxm + gtest, dxm)
        dym = torch.where(mod, dym + gtest, dym)
        sn = torch.where(br & (torch.abs(sy - sx) >= 0.66 * width1),
                         sx + 0.5 * (sy - sx), sn)
        width1_n = torch.where(br, width, width1)
        width_n = torch.where(br, torch.abs(sy - sx), width)
        stmin_n = torch.where(br, torch.fmin(sx, sy), sn + xtrapl * (sn - sx))
        stmax_n = torch.where(br, torch.fmax(sx, sy), sn + xtrapu * (sn - sx))
        sn = torch.minimum(torch.maximum(sn, stpmin), stpmax)
        give_up = br & ((sn <= stmin_n) | (sn >= stmax_n)
                        | (stmax_n - stmin_n <= xtol * stmax_n))
        sn = torch.where(give_up, sx, sn)
        go = ~done & ~finish
        stp = torch.where(go, sn, stp)
        stx = torch.where(go, sx, stx)
        fx = torch.where(go, fxm, fx)
        dx = torch.where(go, dxm, dx)
        sty = torch.where(go, sy, sty)
        fy = torch.where(go, fym, fy)
        dy = torch.where(go, dym, dy)
        brackt = torch.where(go, brackt | br, brackt)
        stage1 = torch.where(go, stage1_n, stage1)
        width = torch.where(go, width_n, width)
        width1 = torch.where(go, width1_n, width1)
        stmin = torch.where(go, stmin_n, stmin)
        stmax = torch.where(go, stmax_n, stmax)
        done = done | finish
    return torch.where(done, stp, stx)


def _cholesky_plain(H, eps):
    """The TPU kernel's right-looking Cholesky (``pallas_driver.py:
    785-818``) of each (n, n) Hessian: returns the factor ``L`` with its
    column j stored as row j (the TPU kernel's L slab) and the per-instance
    ``bad`` mask of a pivot that failed ``piv <= eps max(max|diag H|, 1)``.
    Step j takes row j of the downdated H and downdates the trailing block
    only, which is what the TPU kernel's masked full-slab update changes."""
    n = H.shape[-1]
    H = H.clone()
    L = torch.zeros_like(H)
    dmax = torch.amax(torch.abs(torch.diagonal(H, dim1=1, dim2=2)), dim=-1)
    thr = eps * torch.maximum(dmax, torch.ones_like(dmax))
    bad = torch.zeros_like(dmax, dtype=torch.bool)
    floor = torch.full_like(dmax, eps)
    for j in range(n):
        piv = H[:, j, j]
        bad = bad | (piv <= thr)
        piv_s = torch.sqrt(torch.maximum(piv, floor))
        col = H[:, j, j + 1:] / piv_s[:, None]
        L[:, j, j] = piv_s
        L[:, j, j + 1:] = col
        H[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    return L, bad


def _tri_solve_plain(L, rhs):
    """``H w = rhs`` against the factor of :func:`_cholesky_plain`:
    forward then back substitution in the TPU kernel's order
    (``pallas_driver.py:820-854``)."""
    n = rhs.shape[-1]
    w1 = rhs.clone()
    w2 = torch.zeros_like(rhs)
    for j in range(n):
        yj = w1[:, j] / L[:, j, j]
        w2[:, j] = w2[:, j] + yj
        w1[:, j + 1:] = w1[:, j + 1:] - yj[:, None] * L[:, j, j + 1:]
    w1 = torch.zeros_like(rhs)
    for j in range(n - 1, -1, -1):
        dotv = torch.sum(L[:, j, j + 1:] * w1[:, j + 1:], dim=-1)
        w1[:, j] = w1[:, j] + (w2[:, j] - dotv) / L[:, j, j]
    return w1


def _matvec(Bm, v, transpose=False):
    """``B v`` (or ``B^T v``) per instance."""
    if transpose:
        Bm = Bm.transpose(1, 2)
    return torch.matmul(Bm, v[:, :, None])[:, :, 0]


def _solve_plain(spec: K3Spec, f, x0, lower, upper, consts, max_iter,
                 max_iter_ls, ties=None):
    B, n = x0.shape
    dt = x0.dtype
    dev = x0.device
    # the rounding bound of a sum of n terms in any order (n - 1 roundings
    # of at most eps / 2 of the sum of their magnitudes), with room for the
    # terms' own roundings
    tie_eps = (n + 2) * torch.finfo(dt).eps

    def note_ties(live, gap, scale):
        """Where a live instance's decision ``gap <= 0`` (or ``< 0``) lies
        within ``tie_eps * scale`` of flipping, and ``ties`` has no entry
        yet, enter the iterations it has completed."""
        near = live & (torch.abs(gap) <= tie_eps * scale) & (ties < 0)
        ties.copy_(torch.where(near, iters, ties))
    bvg = batched_value_and_grad(f, consts)
    bval = batched_value(f, consts)
    method, search = spec.method, spec.search
    lo = lower.to(dt) if spec.bounded else None
    up = upper.to(dt) if spec.bounded else None

    def clip(v):
        return torch.minimum(torch.maximum(v, lo), up)

    X = clip(x0) if spec.bounded else x0.clone()
    Fv, G = bvg(X)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    nfev = torch.zeros((B,), dtype=torch.int32, device=dev)
    if method == SPG:
        mx = torch.amax(torch.abs(clip(X - G) - X), dim=-1)
        lam = torch.clamp(torch.ones_like(mx) / mx, spec.lam_min,
                          spec.lam_max)
        par = torch.zeros_like(mx)
    if method == NCG:
        Gp, Dp = G.clone(), -G
        ks = torch.zeros((B,), dtype=torch.int32, device=dev)
    if method == PNORM:
        pinv_t = spec.pinv.to(device=dev, dtype=dt).T
    if search == GLL:
        fhist = torch.full((B, spec.ring), float("-inf"), dtype=dt,
                           device=dev)
    if search == MTB:
        run_tmax = torch.full((B,), spec.t_max, dtype=dt, device=dev)
    if method in (QN, QNB):
        eye = torch.eye(n, dtype=dt, device=dev)
        Bm = eye.expand(B, n, n).clone()
        sn = torch.full((B,), float("inf"), dtype=dt, device=dev)
        yn = sn.clone()
        stc = torch.zeros((B,), dtype=torch.int32, device=dev)
        pend = torch.zeros((B,), dtype=torch.bool, device=dev)
    if method == LBFGS:
        m = spec.lbfgs_m
        S = torch.zeros((B, m, n), dtype=dt, device=dev)
        Y = torch.zeros_like(S)
        rho = torch.zeros((B, m), dtype=dt, device=dev)
        valid = torch.zeros_like(rho)
        gam = torch.ones((B,), dtype=dt, device=dev)
    if method in NEWTON_METHODS:
        bhess = batched_hessian(f, consts)
        # the factor of the last direction's Hessian and its bad mask
        # (SPN's precond_bb solves against it after the step)
        fact = fact_bad = None
        inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
        if method == NEWTON:
            dec2 = inf
        if method == PN:
            sn, yn = inf, inf.clone()
        if method == SPN:
            mx = torch.amax(torch.abs(clip(X - G) - X), dim=-1)
            lam = torch.clamp(torch.ones_like(mx) / mx, spec.lam_min,
                              spec.lam_max)

    def converged():
        if method in (QN, QNB):
            # the gradient 2-norm, or the s/y stall (pallas_driver.py:431)
            g_small = torch.sqrt(_dot(G, G)) < spec.tol
            if spec.restart:
                return g_small | (stc >= 2)
            return g_small | (sn < spec.tol) | (yn < spec.tol)
        if method == LBFGS:
            return torch.amax(torch.abs(G), dim=-1) < spec.tol
        if method == NEWTON:
            return dec2 * 0.5 < spec.tol
        pg = G
        if spec.bounded:
            pushing = ((X == lo) & (G > 0.0)) | ((X == up) & (G < 0.0))
            pg = torch.where(pushing, 0.0, G)
        small = torch.amax(torch.abs(pg), dim=-1) < spec.tol
        if method == PN:
            return (sn < spec.tol) | (yn < spec.tol) | small
        return small

    def newton_direction():
        """``pallas_driver.py:893-904``, ``:933-938``, ``:973-978``."""
        nonlocal fact, fact_bad, dec2
        fact, fact_bad = _cholesky_plain(bhess(X), QN_EPS[dt])
        step = _tri_solve_plain(fact, G)
        ok = ~fact_bad & torch.isfinite(step).all(dim=-1)
        if method == NEWTON:
            d = torch.where(ok[:, None], -step, -G)
            # the decrement (H^-1 d) . d, a second solve against the factor
            z = _tri_solve_plain(fact, d)
            dec2 = torch.where(ok, _dot(z, d), dec2)
            return d
        step = torch.where(ok[:, None], step, G)
        if method == PN:
            return clip(X - step) - X
        return clip(X - lam[:, None] * step) - X

    def direction(active):
        nonlocal ks, pend, rho, valid, gam
        if method in NEWTON_METHODS:
            return newton_direction()
        if method in (QN, QNB):
            Bg = _matvec(Bm, G, transpose=spec.qn_update != 2)
            if method == QN:
                d = -Bg
                fallback = -G
                fin = torch.isfinite(d).all(dim=-1)
            else:
                d = clip(X - Bg) - X
                fallback = clip(X - G) - X
                # the poison check reads the raw B g: the clip would hide it
                fin = torch.isfinite(Bg).all(dim=-1)
            if spec.restart:
                keep = fin & (_dot(G, d) < 0.0)
                d = torch.where(keep[:, None], d, fallback)
                pend = pend | (active & ~fin)
            return d
        if method == LBFGS:
            q = G
            alphas = [None] * spec.lbfgs_m
            for j in range(spec.lbfgs_m - 1, -1, -1):      # newest -> oldest
                a = rho[:, j] * _dot(S[:, j], q) * valid[:, j]
                q = q - a[:, None] * Y[:, j]
                alphas[j] = a
            r = gam[:, None] * q
            for j in range(spec.lbfgs_m):                  # oldest -> newest
                b = rho[:, j] * _dot(Y[:, j], r) * valid[:, j]
                r = r + (alphas[j] - b)[:, None] * S[:, j]
            d = -r
            ok = torch.isfinite(d).all(dim=-1) & (_dot(G, d) < 0.0)
            bad = (active & ~ok)[:, None]
            rho = torch.where(bad, 0.0, rho)
            valid = torch.where(bad, 0.0, valid)
            gam = torch.where(bad[:, 0], 1.0, gam)
            return torch.where(ok[:, None], d, -G)
        if method == CD:
            a = torch.abs(G)
            amax = torch.amax(a, dim=-1, keepdim=True)
            ii = torch.arange(n, device=dev)
            idx = torch.amin(torch.where(a == amax, ii, n), dim=-1,
                             keepdim=True)
            return -sign(G) * (ii == idx).to(dt)
        if method == PNORM:
            # rounded to float32 first, as the TPU kernel's float32 matmul
            # output (preferred_element_type) is
            return -(G @ pinv_t).to(torch.float32).to(dt)
        if method == PGD:
            return clip(X - G) - X
        if method == SPG:
            return clip(X - lam[:, None] * G) - X
        if method == NCG:
            y = G - Gp
            gg = torch.sum(G * G, dim=-1)
            if spec.ncg_variant == 0:
                beta = gg / torch.sum(Gp * Gp, dim=-1)
            elif spec.ncg_variant == 1:
                beta = torch.maximum(
                    torch.sum(G * y, dim=-1) / torch.sum(Gp * Gp, dim=-1),
                    torch.zeros_like(gg))
            elif spec.ncg_variant == 2:
                beta = torch.sum(G * y, dim=-1) / torch.sum(Dp * y, dim=-1)
            else:
                beta = gg / torch.sum(Dp * y, dim=-1)
            beta = torch.where(torch.isfinite(beta), beta, 0.0)
            period = spec.restart_every if spec.restart_every > 0 else n
            periodic = ks >= period
            d = -G + torch.where(periodic, 0.0, beta)[:, None] * Dp
            gd = torch.sum(G * d, dim=-1)
            if ties is not None:
                note_ties(active, gd, torch.sum(torch.abs(G * d), dim=-1))
            descent = gd < 0.0
            d = torch.where(descent[:, None], d, -G)
            ks = torch.where(active & (periodic | ~descent), 0, ks)
            return d
        return -G

    def step_length(d, active):
        nonlocal fhist, run_tmax
        t = torch.ones((B,), dtype=dt, device=dev)
        if search == NOSEARCH:
            return t
        g0d = torch.sum(G * d, dim=-1)
        if search in (MT, MTB):
            t_min = torch.full((B,), spec.t_min, dtype=dt, device=dev)
            if search == MTB:
                run_tmax = torch.minimum(
                    run_tmax, max_feasible_step(X, d, (lo, up)))
                t_max = run_tmax
            else:
                t_max = torch.full((B,), spec.t_max, dtype=dt, device=dev)
            return _mt_plain(spec, bvg, X, d, Fv, g0d, active, t_min, t_max,
                             max_iter_ls, nfev)
        if search in (HZ, HZB):
            t_max = (max_feasible_step(X, d, (lo, up)) if search == HZB else
                     torch.full((B,), float("inf"), dtype=dt, device=dev))
            return _hz_plain(spec, bvg, X, d, Fv, g0d, active, t_max,
                             max_iter_ls, nfev)
        if search == SW:
            stpmax = torch.full((B,), spec.stp_max, dtype=dt, device=dev)
            if spec.search_bounded:
                stpmax = torch.minimum(stpmax,
                                       max_feasible_step(X, d, (lo, up)))
            return _sw_plain(spec, bvg, X, d, Fv, g0d, active, stpmax,
                             max_iter_ls, nfev)
        f_ref = Fv
        if search == GLL:
            fhist = torch.cat([fhist[:, 1:], Fv[:, None]], dim=1)
            f_ref = torch.amax(fhist, dim=-1)
        if ties is not None:
            gd_abs = torch.sum(torch.abs(G * d), dim=-1)
        done = ~active
        for _ in range(max_iter_ls):
            if bool(done.all()):
                break
            xt = X + t[:, None] * d
            if search == BTB:
                xt = clip(xt)
            ft = bval(xt)
            nfev.add_((~done).to(torch.int32))
            if search == BTB:
                diff = xt - X
                rhs = (-spec.c1 / t) * torch.sum(diff * diff, -1)
                ok = ft - Fv <= rhs
            else:
                rhs = spec.c1 * t * g0d
                ok = ft - f_ref <= rhs
            if ties is not None:
                ref = Fv if search == BTB else f_ref
                # BackTrackingB's sum has terms of one sign: |rhs| is theirs
                rhs_mags = (rhs.abs() if search == BTB
                            else spec.c1 * t * gd_abs)
                note_ties(~done & torch.isfinite(ft), ft - ref - rhs,
                          ft.abs() + ref.abs() + rhs_mags)
            keep = done | (ok & torch.isfinite(ft))
            if search == GLL:
                t_half = t * 0.5
                t_tmp = -0.5 * t * t * g0d / (ft - Fv - t * g0d)
                t_quad = torch.where(
                    (t_tmp > spec.sigma1) & (t_tmp < spec.sigma2 * t),
                    t_tmp, t_tmp * 0.5)
                t_next = torch.where(t <= 0.1, t_half, t_quad)
                t_next = torch.where(torch.isfinite(t_next) & (t_next > 0.0),
                                     t_next, t_half)
            else:
                t_next = t * spec.beta
            t = torch.where(keep, t, t_next)
            done = keep
        return t

    def qn_post_step(active, s, y):
        """The dense update of ``pallas_driver.py:467-588``."""
        nonlocal Bm, sn, yn, stc, pend
        eps = QN_EPS[dt]
        pending = pend
        sy = _dot(s, y)
        s_norm = torch.sqrt(_dot(s, s))
        y_norm = torch.sqrt(_dot(y, y))
        curv_ok = sy > eps * s_norm * y_norm
        scale_cond = torch.zeros_like(curv_ok)
        gamma = torch.ones_like(sy)
        if spec.scale_b0:
            gamma = torch.where(curv_ok, sy / _dot(y, y), 1.0)
            scale_cond = ~torch.isfinite(sn) & curv_ok
        upd = spec.qn_update
        By = _matvec(Bm, y, transpose=upd != 2)
        By = torch.where(scale_cond[:, None], gamma[:, None] * y, By)
        if spec.restart:
            By = torch.where(pending[:, None], y, By)
        col = (slice(None), None, slice(None))       # v_j along a row
        row = (slice(None), slice(None), None)       # v_i down a column
        if upd == 0:                                 # bfgs
            rho_ = 1.0 / sy
            coeff = rho_ * rho_ * _dot(y, By) + rho_
            ok = curv_ok

            def new_slab(Bc):
                return (Bc - rho_[:, None, None] * (s[row] * By[col]
                                                    + By[row] * s[col])
                        + coeff[:, None, None] * (s[row] * s[col]))
        elif upd == 1:                               # dfp
            yBy = _dot(y, By)
            ok = curv_ok & (yBy > eps * y_norm * y_norm)

            def new_slab(Bc):
                return (Bc + (s[row] * s[col]) / sy[:, None, None]
                        - (By[row] * By[col]) / yBy[:, None, None])
        elif upd == 2:                               # broyden
            Bts = _matvec(Bm, s, transpose=True)
            Bts = torch.where(scale_cond[:, None], gamma[:, None] * s, Bts)
            if spec.restart:
                Bts = torch.where(pending[:, None], s, Bts)
            ok = torch.abs(sy) > eps * s_norm * y_norm

            def new_slab(Bc):
                return Bc + ((s - By)[row] * Bts[col]) / sy[:, None, None]
        else:                                        # sr1
            shy = s - By
            denom = _dot(shy, y)
            ok = (torch.abs(denom)
                  > eps * torch.sqrt(_dot(shy, shy)) * y_norm)

            def new_slab(Bc):
                return Bc + (shy[row] * shy[col]) / denom[:, None, None]

        not_tiny = (s_norm >= spec.tol) & (y_norm >= spec.tol)
        if spec.restart:
            ok = curv_ok
        ok = ok & not_tiny & torch.isfinite(sy)
        Bc = Bm
        if spec.restart:
            Bc = torch.where(pending[:, None, None], eye, Bc)
        if spec.scale_b0:
            Bc = torch.where(scale_cond[:, None, None],
                             gamma[:, None, None] * eye, Bc)
        out = torch.where((active & ok)[:, None, None], new_slab(Bc), Bc)
        stall_clear = ok
        if spec.restart:
            out = torch.where((active & ~ok)[:, None, None], eye, out)
            stall_clear = ok & ~pending
            pend = torch.where(active, False, pend)
        Bm = out
        sn = torch.where(active, s_norm, sn)
        yn = torch.where(active, y_norm, yn)
        stc = torch.where(active, torch.where(stall_clear, 0, stc + 1), stc)

    def lbfgs_post_step(active, s, y):
        """Shift-not-ring history update and the zero-progress repair of
        ``pallas_driver.py:691-731``."""
        nonlocal S, Y, rho, valid, gam
        sy, yy = _dot(s, y), _dot(y, y)
        eps = max(spec.curv_eps, QN_EPS[dt])
        acc = active & (sy > eps * yy)
        a3 = acc[:, None, None]
        S = torch.where(a3, torch.cat([S[:, 1:], s[:, None]], dim=1), S)
        Y = torch.where(a3, torch.cat([Y[:, 1:], y[:, None]], dim=1), Y)
        a2 = acc[:, None]
        rho = torch.where(a2, torch.cat([rho[:, 1:], (1.0 / sy)[:, None]], 1),
                          rho)
        valid = torch.where(a2, torch.cat(
            [valid[:, 1:], torch.ones_like(sy)[:, None]], 1), valid)
        gam = torch.where(acc, sy / yy, gam)
        no_move = active & ~(s != 0.0).any(dim=-1)
        rho = torch.where(no_move[:, None], 0.0, rho)
        valid = torch.where(no_move[:, None], 0.0, valid)
        gam = torch.where(no_move, 1.0, gam)

    active = torch.isfinite(Fv) & ~converged()
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        d = direction(active)
        t = step_length(d, active)
        X_new = X + t[:, None] * d
        if spec.bounded:
            X_new = clip(X_new)
        f_new, g_new = bvg(X_new)
        am = active[:, None]
        X_old, G_old = X, G
        X = torch.where(am, X_new, X)
        Fv = torch.where(active, f_new, Fv)
        G = torch.where(am, g_new, G)
        if method == SPG:
            s = X - X_old
            y = G - G_old
            sy = torch.sum(s * y, dim=-1)
            raw = torch.sum(s * s, dim=-1) / sy
            if spec.alternate:
                raw = torch.where(par > 0.5, sy / torch.sum(y * y, dim=-1),
                                  raw)
                par = torch.where(active, 1.0 - par, par)
            lam_new = torch.where(
                sy <= 0.0, spec.lam_max,
                torch.clamp(raw, spec.lam_min, spec.lam_max))
            lam = torch.where(active, lam_new, lam)
        if method == NCG:
            Gp = torch.where(am, G_old, Gp)
            Dp = torch.where(am, d, Dp)
            ks = ks + active.to(torch.int32)
        if method in (QN, QNB):
            qn_post_step(active, X - X_old, G - G_old)
        if method == LBFGS:
            lbfgs_post_step(active, X - X_old, G - G_old)
        if method == PN:
            s, y = X - X_old, G - G_old
            sn = torch.where(active, torch.sqrt(_dot(s, s)), sn)
            yn = torch.where(active, torch.sqrt(_dot(y, y)), yn)
        if method == SPN:
            # pallas_driver.py:980-999; precond_bb takes H(x_old)^-1 y from
            # the direction's factor, the raw y where that factor was bad
            s, y = X - X_old, G - G_old
            if spec.precond_bb:
                yt = _tri_solve_plain(fact, y)
                bad = fact_bad | ~torch.isfinite(yt).all(dim=-1)
                y = torch.where(bad[:, None], y, yt)
            sy = _dot(s, y)
            lam_bb = torch.clamp(_dot(s, s) / sy, spec.lam_min, spec.lam_max)
            lam_new = torch.where(sy > 0.0, lam_bb, spec.lam_max)
            lam = torch.where(active, lam_new, lam)
        iters = iters + active.to(torch.int32)
        active = torch.isfinite(Fv) & ~converged()

    finite = torch.isfinite(Fv)
    status = torch.where(
        converged() & finite, int(Status.CONVERGED),
        torch.where(iters >= max_iter, int(Status.MAX_ITER_REACHED),
                    torch.where(~finite, int(Status.OUT_OF_DOMAIN),
                                int(Status.MAX_ITER_REACHED))))
    return X, Fv, iters, status.to(torch.int32), nfev


def fused_minimize_plain(method, line_search, f, x0, lower=None, upper=None,
                         consts=(), *, max_iter=1000, max_iter_ls=32,
                         ties=None):
    """K3's algorithm in plain batched PyTorch, on x0's device.

    Arguments as :func:`fused_minimize`.  Returns ``(x, f, iterations,
    status, nfev)`` without the epilogue; ``nfev`` counts each instance's
    trial evaluations (value only in the Armijo family, value and gradient
    in the Wolfe family).

    ``ties``, where given, is an int32 (B,) tensor filled with -1.  An
    instance whose run takes a decision that the order of a sum could
    flip gets there the iterations it had completed before the first
    such decision: an Armijo-family test (NoSearch has none) or NCG's
    descent test whose two sides lie within (n + 2) eps times the sum of
    the magnitudes they add up, which bounds the rounding of any order of
    summation (a bound on f where its terms share one sign, as the
    weighted squares' and Rosenbrock's do).  Another implementation, such
    as a kernel whose lanes sum in another order, may take such a
    decision the other way and follow another path from there."""
    spec = _spec_for(method, line_search)
    _check_bounds(spec, method, lower, upper)
    return _solve_plain(spec, f, x0, lower, upper, tuple(consts), max_iter,
                        max_iter_ls, ties)


def _slots(spec: K3Spec, dtype, rows: int = 0):
    """The int and double parameter arrays of ``driver_launch`` (slots
    ``IntSlot`` and ``DoubleSlot`` of ``csrc/driver.cuh``); ``rows`` is a
    log-sum-exp's."""
    ints = [spec.method, spec.search, int(spec.alternate), spec.ncg_variant,
            spec.restart_every, spec.ring, spec.qn_update, int(spec.scale_b0),
            int(spec.restart), spec.lbfgs_m, int(spec.approx_wolfe),
            int(spec.search_bounded), int(spec.precond_bb), int(rows)]
    doubles = [spec.tol, spec.lam_min, spec.lam_max, spec.c1, spec.beta,
               spec.sigma1, spec.sigma2, max(spec.curv_eps, QN_EPS[dtype]),
               spec.c2, spec.t_min, spec.t_max, spec.delta, spec.aw_eps,
               spec.sigma, spec.eps, spec.theta, spec.gamma, spec.rho,
               spec.xtol, spec.stp_min, spec.stp_max, spec.xtrapl,
               spec.xtrapu]
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_double * len(doubles))(*doubles))


def _launch_cuda(spec: K3Spec, f, x0, lower, upper, consts, max_iter,
                 max_iter_ls):
    """Check the operands, launch ``csrc/driver.cu`` on the current stream
    and return ``(x, f, iterations, status, nfev)``.  The objective needs a
    functor of the chosen form (:func:`compiled_functors`)."""
    from . import _build

    if x0.dim() != 2 or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x0 must be a (B, n) float32/float64 tensor, got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    B, n = x0.shape
    lo = up = None
    bstride = 0
    if spec.bounded:
        bounds = []
        for name, v in (("lower", lower), ("upper", upper)):
            if v.device != x0.device:
                raise ValueError(f"{name} lies on {v.device}, x0 on "
                                 f"{x0.device}")
            if tuple(v.shape) not in ((n,), (B, n)):
                raise ValueError(f"{name} must be ({n},) or ({B}, {n}), got "
                                 f"{tuple(v.shape)}")
            bounds.append(v.to(x0.dtype).contiguous())
        lo, up = bounds
        if lo.shape != up.shape:
            raise ValueError("lower and upper must have the same shape")
        bstride = n if lo.dim() == 2 else 0
    code, arrays = kernel_operands(f, consts, x0, kernel=KERNEL,
                                   lockstep=LOCKSTEP)
    name = next(k for k, v in KERNEL_OBJECTIVES.items() if v == code)
    compiled = compiled_functors(spec)
    if name not in compiled:
        raise NotImplementedError(
            f"{KERNEL} compiles the functors {compiled} in this form, not "
            f"{name}; other objectives need the lockstep loop ({LOCKSTEP})")
    rows = k3_rows(spec, name, arrays[0].shape[0] if arrays else 0)
    pinv = None
    if spec.method == PNORM:
        pinv = spec.pinv.to(device=x0.device, dtype=x0.dtype).contiguous()
        if tuple(pinv.shape) != (n, n):
            raise ValueError(f"inverse_p must be ({n}, {n}), got "
                             f"{tuple(pinv.shape)}")
    itemsize = x0.element_size()
    _check_fits(n, spec.ring, itemsize, spec.lbfgs_m, spec.method, rows)
    _check_workspace(B, n, spec, itemsize, x0.device, rows)
    x0 = x0.contiguous()
    lib = _build.load()
    x = torch.empty_like(x0)
    fv = torch.empty((B,), dtype=x0.dtype, device=x0.device)
    it, st, nfev = (torch.empty((B,), dtype=torch.int32, device=x0.device)
                    for _ in range(3))
    elems = workspace_elems(B, n, spec.method, spec.ring, itemsize,
                            spec.qn_update, rows)
    work = (torch.empty((elems,), dtype=x0.dtype, device=x0.device)
            if elems else None)
    ints, doubles = _slots(spec, x0.dtype, rows)

    def ptr(v):
        return None if v is None else v.data_ptr()

    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.driver_launch(
            1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
            ptr(lo), ptr(up), bstride,
            ptr(arrays[0] if arrays else None),
            ptr(arrays[1] if len(arrays) > 1 else None), ptr(pinv), B, n,
            ints, doubles, int(max_iter), int(max_iter_ls), ptr(work),
            x.data_ptr(), fv.data_ptr(), it.data_ptr(), st.data_ptr(),
            nfev.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"driver_launch failed: "
                           f"{_build.error_string(rc)} (code {rc})")
    fused_minimize.launches += 1
    if spec.method in DENSE_METHODS:
        fused_minimize.placements[
            "shared" if dense_in_shared(n, spec.ring, itemsize,
                                        spec.qn_update, rows)
            else "workspace"] += 1
    return x, fv, it, st, nfev


def apply_stall_status(status, method, x, f, g, pg_norm, bounds):
    """Re-label CONVERGED lanes as :data:`Status.STALLED` where the method's
    ``stall_status`` hook says the exit was a stall at a non-KKT point (the
    dense quasi-Newton family).  Methods without the hook are untouched;
    only CONVERGED is ever re-labelled."""
    hook = getattr(method, "stall_status", None)
    if hook is None:
        return status
    stall = hook(x, f, g, pg_norm, bounds)
    return torch.where((status == Status.CONVERGED) & stall,
                       int(Status.STALLED), status).to(torch.int32)


def exit_pg_norm(x, g, bounds):
    """Exit-time ``pg_norm``: projected-gradient infinity norm (plain
    ``||g||_inf`` unbounded)."""
    if bounds is None:
        return batched_pg_inf_norm(x, g)
    return batched_pg_inf_norm(x, g, bounds[0], bounds[1])


def solve_spec(spec: K3Spec, method, f, x0, lower, upper, consts, *,
               max_iter, max_iter_ls) -> SolveResult:
    """:func:`fused_minimize` for a spec already built from ``method``:
    the plain version for a CPU ``x0``, the kernel for a CUDA ``x0``, then
    the epilogue of the JAX kernel's wrapper."""
    _check_bounds(spec, method, lower, upper)
    consts = tuple(consts)
    if x0.device.type == "cpu":
        x, fv, it, st, _ = _solve_plain(spec, f, x0, lower, upper, consts,
                                        max_iter, max_iter_ls)
    elif x0.device.type == "cuda":
        x, fv, it, st, _ = _launch_cuda(spec, f, x0, lower, upper, consts,
                                        max_iter, max_iter_ls)
    else:
        raise ValueError(f"no K3 route for device {x0.device}")
    return epilogue(method, f, consts, x, fv, it, st, lower, upper)


def epilogue(method, f, consts, x, fv, it, st, lower=None,
             upper=None) -> SolveResult:
    """The JAX kernel wrapper's epilogue on ``(x, f, iterations, status)``:
    the final gradient and ``pg_norm`` from one batched value-and-gradient,
    and the STALLED relabel."""
    _, g = batched_value_and_grad(f, tuple(consts))(x)
    bounds = None if lower is None else (lower.to(x.dtype), upper.to(x.dtype))
    pg = exit_pg_norm(x, g, bounds)
    st = apply_stall_status(st, method, x, fv, g, pg, bounds)
    return SolveResult(x, fv, g, it, st, pg_norm=pg)


def fused_minimize(method, line_search, f, x0, lower=None, upper=None,
                   consts=(), *, max_iter=1000, max_iter_ls=32) -> SolveResult:
    """Batched whole solves of ``(method, line_search)``.

    ``method`` and ``line_search`` are the configs of :mod:`..solvers` and
    :mod:`..linesearch`; ``x0`` is ``(B, n)``; ``lower``/``upper`` are
    ``(n,)`` shared or ``(B, n)`` per instance, needed by the bounded
    methods; ``consts`` is the objective's problem data, ``f(x, *consts)``.
    A CPU ``x0`` runs :func:`fused_minimize_plain`; a CUDA ``x0`` launches
    the kernel (the objective needs a ``kernel_form`` with a K3 functor) or
    raises.  An unsupported combination raises ``ValueError``
    (:func:`fused_supported` tells).  The final ``g`` and ``pg_norm`` come
    from one batched value-and-gradient, as in the JAX epilogue."""
    return solve_spec(_spec_for(method, line_search), method, f, x0, lower,
                      upper, consts, max_iter=max_iter,
                      max_iter_ls=max_iter_ls)


fused_minimize.launches = 0
# the dense form's launches by where the slabs lay (dense_in_shared)
fused_minimize.placements = {"shared": 0, "workspace": 0}
