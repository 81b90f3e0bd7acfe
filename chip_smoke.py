#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and drives the
batched L-BFGS-B path and the template-method paths through
``optimization_solvers_tpu_torch.minimize`` (and ``solvers.batch_minimize``):

* the headline (10,240 x Rosenbrock-100, float32, box [-5, 5], pgtol 1e-3,
  factr 100, m 5, max_iter 600), which the route sends to K1
  (``ops/csrc/lbfgsb_fused.cu``);
* config 4 (512 x the 10,000-dim bounded log-sum-exp with 512 rows,
  float32, box [-1, 1], m 10, pgtol 1e-5, factr 1e3, max_iter 200), which
  the route sends to the tall kernel K2 (``ops/csrc/lbfgsb_tall.cu``, a
  tile of up to four instances per block), with
  ``policy="fast"`` (Armijo) and ``policy="reference"`` (dcsrch).  A and the
  starts come from numpy seeds (A: ``RandomState(0)``; the JAX bench draws
  it from ``jax.random.PRNGKey(0)``), and 4 instances are anchored to
  scipy's ``fmin_l_bfgs_b`` in float64;
* config 3 (10,240 x the 64-dim box quadratic ``0.5 sum d x^2`` with
  ``d = logspace(0, 3)``, float32, box [-2, 2], SPG + GLL, tol 1e-4,
  max_iter 1000, max_iter_ls 30, ``policy="fast"`` and ``"reference"``) and
  config 6 (4,096 x the 100-dim diagonal quadratic with ``d = linspace(1,
  100)``, float32, GD + BackTracking, tol 1e-6, max_iter 3000), which go to
  the generic driver kernel K3 (``ops/csrc/driver.cu``).  The objective is
  the port's ``weighted_squares`` with ``t = 0`` (config 3) and
  ``diag_quadratic`` (config 6): the same function as the JAX bench's;
* config 2 (1,024 x Rosenbrock-100, float32, dense BFGS with tol 2e-4,
  ``scale_b0`` and ``restart_on_degeneracy`` + More-Thuente, max_iter
  1500, max_iter_ls 40) through ``solvers.batch_minimize`` as the JAX bench
  calls it and through ``minimize(method="bfgs")`` in both policies, and
  L-BFGS + Hager-Zhang (``minimize(method="lbfgs")``, tol 1e-4) at the same
  shape, which K3 runs in its dense form (one block per instance) and its
  quasi-Newton form (one warp per instance);
* config 5 (``bench.py:687-741``: 256 and 64 x ``quadratic(Q)`` at n =
  1,024, ``Q = diag(linspace(1, 10)) + (0.2 / n) 1 1^T``, float32, box
  [-2, 2], ``ProjectedNewton(grad_tol=1e-4)`` + ``BackTrackingB``, max_iter
  50) through ``solvers.batch_minimize`` as the JAX bench calls it, and the
  ``pn``, ``spn`` (both policies) and ``newton`` rows of ``minimize`` at the
  same width, which K3 runs in its Newton form (``ops/csrc/
  driver_newton.cu``);
* the Newton-CG headline (the headline's inputs through
  ``minimize(method="newton_cg", cg_max=12)``), which runs the Newton-CG
  kernel K4 (``ops/csrc/newton_cg.cu``);
* the lockstep loop's kernels K5 (``ops/csrc/qn_update.cu``) and K6
  (``ops/csrc/cholesky_solve.cu``) on config 2's and config 5's paths;
* the whole-solve kernels through their entries in ``ops``: K7
  (``ops.lbfgs_solve_fused``, ``ops/csrc/lbfgs_fused.cu``) on the headline's
  inputs without the box (m 5, tol 1e-3), K8 (``ops.spg_solve_fused``,
  ``ops/csrc/spg_fused.cu``) on config 3's and K9 (``ops.bfgs_solve_fused``,
  ``ops/csrc/bfgs_fused.cu``) on config 2's (tol 1e-5, max_iter 600), each
  timed beside K3's nearest method and search;
* K3's dense form (``ops/csrc/driver_dense.cu``, which config 2 runs with
  its slabs in shared memory) and K9 past the shared-memory fit (n = 400,
  B = 64, float64 and float32: the slabs in the device-memory workspace),
  held against their plain versions;
* K3's first-order form (``ops/csrc/driver_first.cuh``: every first-order
  method with each Armijo-family search it takes) and K8 in each of their
  layouts (two coordinates a lane in registers at n = 64, four at 100, the
  warp's shared memory at 160), float64 and float32, held against their
  plain versions;
* K1's scaled form (``ops.lbfgsb_solve_fused_scaled``, phase 35) on the
  headline's inputs with the Rosenbrock Hessian's diagonal, and Jacobi
  preconditioning of a cond-1e6 quadratic; the lockstep L-BFGS-B (phase
  36, no kernel) on the headline with a plain torch callable through
  ``minimize``;
* the lockstep Newton-CG (phase 37, no kernel) on the Newton-CG headline
  with a plain torch callable and on config 4 at full width (past K4's
  shared memory), and the template methods with objectives K3's chosen
  form does not compile, on the lockstep loop on the card;
* the log-sum-exp's second-order functors: K4 (phase 38) at config 4's A
  and b construction at n = 1,000 (512 rows), and K3's Newton form (phase
  39, PN + BackTrackingB) at n = 256 (512 rows) and past the Hessian's rank
  (n = 256, 128 rows);
* the quadratic and log-sum-exp functors of K1 through
  ``minimize(method="lbfgsb")`` (phase 40: the log-sum-exp at phase 38's
  shape with config 4's settings, K2 timed beside it on the same inputs,
  and config 5's quadratic), of K3's quasi-Newton, Wolfe and dense forms
  through ``solvers.batch_minimize`` (phase 41: L-BFGS + Hager-Zhang, NCG
  + More-Thuente and BFGS + More-Thuente on the log-sum-exp at phase 39's
  shape and on config 5's quadratic, the lockstep loop they ran on before
  timed beside) and of K9 through ``ops.bfgs_solve_fused`` (phase 42, the
  log-sum-exp at phase 39's shape).

It prints, last, a JSON line of per-kernel results, the card's name and
power limit, and one JSON line naming the device.  Any failed check exits
non-zero; so does a machine without a CUDA device.

    python3 chip_smoke.py               # the checked run
    python3 chip_smoke.py --breakdown   # also where K1's, K2's and K3's
                                        # time goes
    python3 chip_smoke.py --times DIR   # only config 2, K9, L-BFGS, K7,
                                        # K8, K4 and the headline (B = 10,240
                                        # and 1,056), K5, configs 3, 6, 4 and 5
                                        # (K3 and the lockstep K6 path in
                                        # turns) and K6, with the package
                                        # of checkout DIR
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np

# the CPU tests' geometries (tests/_torch_geometries.py imports no JAX)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

HEADLINE = dict(B=10240, n=100, m=5, pgtol=1e-3, factr=100.0, max_iter=600)
BOX = 5.0
PLAIN_BUDGET_S = 120.0    # longest plain full solve this script will time
CAPPED_ITERS = 10         # iterations of the capped kernel-vs-plain run
X_ATOL_F64 = 1e-6         # kernel vs plain, float64 geometries
# kernel vs plain after CAPPED_ITERS float64 iterations at the headline
# shape: share of instances that must agree within X_ATOL_F64 (a 1e-15
# relative change of x0 moves none of 1024 instances there)
F64_AGREE = 0.999
F32_ATOL = 1e-3           # float32 agreement is reported, not held

CONFIG4 = dict(B=512, n=10_000, rows=512, m=10, pgtol=1e-5, factr=1e3,
               max_iter=200)
C4_BOX = 1.0
C4_F64_ROWS = 64          # instances of the float64 kernel-vs-plain check
C4_F64_RTOL = 1e-10       # f, kernel vs plain, float64 at config-4 width
SCIPY_ROWS = 4
# f against scipy's float64 L-BFGS-B (factr 1e3, pgtol 1e-5).  float64 K2
# stops at pg <= 1e-5 3.6e-5 - 6.1e-5 above scipy's f (the plain version on
# the CPU).  float32 K2 stops where f falls by less than factr * 1.2e-7 =
# 1.2e-4 relative per iteration, 4.2e-4 - 5.3e-4 above scipy's f; two
# float32 solves of one instance both lie in that band, so they are held
# to each other with the same bound.
SCIPY_RTOL_F64 = 1e-4
C4_F32_RTOL = 1e-3

CONFIG3 = dict(B=10240, n=64, box=2.0, tol=1e-4, max_iter=1000,
               max_iter_ls=30)
CONFIG6 = dict(B=4096, n=100, tol=1e-6, max_iter=3000, max_iter_ls=40)
CONV_ATOL = 0.01          # kernel vs plain converged fraction, float32
# K3 vs plain per instance at the main path's shapes, float64.  SPG + GLL
# at config 3 is chaotic: a last-bit change of x0 moves most full solves'
# iteration counts (phase 11 prints the share that kernel and plain agree
# on).  Over its first K3_CAPPED_ITERS iterations a 1e-15 relative change
# moves x far less than K3_X_ATOL (phase 10 prints it; GLL's history of 10
# wraps three times), so config 3 is held per instance there; config 6
# (GD + BackTracking) is held over its full solve.  Each instance's x is
# held within K3_X_ATOL or, where larger, that instance's own spread in the
# plain version under that change of x0: L-BFGS + Hager-Zhang at config
# 2's shape moves two chaotic starts of 1,024 by up to 4.8e-9 there over 30
# iterations
K3_CAPPED_ITERS = 30
K3_X_ATOL = 1e-9
# full float32 solves, kernel vs plain on the same inputs: median
# iterations within 3% and median f within 15% relative (config 3's two
# policies differ by about half in both)
MED_IT_RTOL = 0.03
MED_F_RTOL = 0.15
# config 2 (bench.py:361-377): 1,024 x Rosenbrock-100, float32, dense BFGS
# (tol 2e-4, scale_b0, restart_on_degeneracy) + More-Thuente; and L-BFGS +
# Hager-Zhang (minimize's default method) at the same shape
CONFIG2 = dict(B=1024, n=100, tol=2e-4, max_iter=1500, max_iter_ls=40)
LBFGS_RUN = dict(tol=1e-4, max_iter=1500)
# full float32 solves there, kernel vs plain on the same inputs: success
# class (CONVERGED or STALLED) within CONV_ATOL, median iterations within
# 5% and median f within 20% relative; and what the algorithm must reach
# on the bench call (the JAX package records 1.0 and 0.989)
C2_MED_IT_RTOL = 0.05
C2_MED_F_RTOL = 0.20
C2_SUCCESS = 0.99
C2_STATIONARY = 0.97
# config 5 (bench.py:687-741): B instances of quadratic(Q) at n = 1,024,
# float32, ProjectedNewton(grad_tol=1e-4) + BackTrackingB, box [-2, 2],
# max_iter 50; B_small is the bench's other batch.  x* = 0; the JAX package
# records converged 1.0 in 1 iteration.  Per instance in float64 on the
# first C5_F64_ROWS starts, SPN "reference" capped at C5_SPN_REF_ITERS
# iterations; the reference SPN row of minimize at C5_SPN_REF_ROWS.
CONFIG5 = dict(B=256, B_small=64, n=1024, box=2.0, tol=1e-4, max_iter=50,
               max_iter_ls=100)
C5_F64_ROWS = 8
C5_SPN_REF_ITERS = 10
C5_SPN_REF_ROWS = 16
C5_X_ATOL = 1e-4
# the Newton-CG headline: the headline's inputs with cg_max 12
# (BENCH_NOTES round 1, item 4).  K4 is held per instance in float64 over
# its first K4_CAPPED_ITERS iterations (past ~10 the truncated CG's exits
# are decided by rounding: a 1e-15 relative change of x0 moves x by more
# than 1e-9); the spread at K4_SPREAD_CAPS iterations is printed
NEWTON_CG_MAX = 12
K4_CAPPED_ITERS = 8
K4_SPREAD_CAPS = (15, 30)
# --breakdown's K1 batch sweep: the headline's first B starts
K1_SWEEP = (132, 1056, 4224, 10240)
# calls per configuration of --times
TIMES_REPEATS = 9
# --times also runs the headline and the Newton-CG headline at this B (one
# block of 8 warps per SM)
K1_TIMES_SMALL_B = 1056
# --times also runs config 4 on the first rows of its batch at these sizes,
# where K2 runs one instance per block
C4_SMALL_B = (64, 8)
# the lockstep slice: the lockstep loop's quasi-Newton path at config 2's
# width (1,024 x Rosenbrock-100, float32) with the fused update K5, without
# config 2's scale_b0 and restart_on_degeneracy (K5 refuses them), and the
# Newton path at config 5's width through ops.linalg with the Cholesky
# kernel K6.  K5 is held against its plain version at the path's shape in
# float32 (max |d| over the largest entry 1e-5) and float64 (1e-12); K6 by
# the relative residual ||H x - g|| / ||g|| (1e-4 in float32 on config 5's
# batch, 1e-10 in float64 at B = LS_K6_F64_ROWS).  The K5 path is held per
# instance in float64 over its first LS_QN_CAPPED_ITERS iterations against
# the unfused update (x within the unfused run's own spread under a 1e-15
# relative change of x0, floored at LS_QN_X_FLOOR), and in full float32
# solves by success class (CONV_ATOL), median iterations (C2_MED_IT_RTOL)
# and median f (C2_MED_F_RTOL).  The K6 path must reach config 5's limits
# (converged 1.0, 1 iteration, max|x| <= C5_X_ATOL) and equal the library
# path per instance in float64 at B = C5_F64_ROWS (x within 1e-10).
LOCKSTEP_QN = dict(B=1024, n=100, tol=2e-4, max_iter=1500, max_iter_ls=40)
LS_QN_CAPPED_ITERS = 30
LS_QN_X_FLOOR = 1e-12
K5_RTOL = {"float32": 1e-5, "float64": 1e-12}
# phase 25b: K5 past the shared placement's fit (float32 n <= 238, float64
# n <= 167): B instances at width n32 (float32) and n64 (float64)
K5_FIT = dict(B=64, n32=256, n64=192)
K6_RES = {"float32": 1e-4, "float64": 1e-10}
LS_K6_F64_ROWS = 16
# rounds of phase 29's in-turns timing of the K6 path against K3
C5_TURNS = 9
LS_PROFILE_ITERS = 50

# the whole-solve kernels K7-K9 (phases 30-32), float32: K7 on the
# headline's inputs without its box (m 5, tol 1e-3 on max|g|); K8 on config
# 3's (tol 1e-4, max_iter_ls 30, gll_m 10); K9 on config 2's (tol 1e-5 on
# ||g||, max_iter_ls 24).  Per instance in float64 over the first
# WHOLE_*_CAPPED iterations: x within the plain version's own spread under
# three changes of x0 by 1e-15 relative, floored at WHOLE_X_FLOOR.  Full
# Rosenbrock solves are chaotic, so the caps keep that spread well under
# the floor: at the full batch after 20 iterations it reached 3.4e-9 (K7)
# and 7.3e-11 (K9), after K8's 30 iterations 7.7e-12 (on an H100 at
# 700 W); on the CPU at 128 instances K7's is 4.2e-13 after 10 iterations
# and K9's 4.7e-13 after 10, 1.9e-11 after 20
WHOLE_K7 = dict(B=10240, n=100, m=5, tol=1e-3, max_iter=600, max_iter_ls=16)
WHOLE_K8 = dict(B=10240, n=64, box=2.0, tol=1e-4, max_iter=1000,
                max_iter_ls=30)
WHOLE_K9 = dict(B=1024, n=100, tol=1e-5, max_iter=600, max_iter_ls=24)
# phase 33: the dense kernels past the shared-memory fit (their slabs in
# the device-memory workspace): B instances of the weighted-squares
# quadratic at width n (d = linspace(1, 50), t = linspace(-0.5, 2), starts
# and minimizer inside the box [-2.5, 2.5]), every case converging within
# max_iter at tol (the 2-norm of g) in both types.  float64: status equal,
# x within DENSE_FIT_F64_ATOL (each run within tol / min d of the
# minimizer); float32: status equal on DENSE_FIT_F32_AGREE of the
# instances, x within DENSE_FIT_F32_ATOL (twice tol / min d)
DENSE_FIT = dict(B=64, n=400, box=2.5, tol64=1e-8, tol32=1e-3, max_iter=400,
                 max_iter_ls=40)
DENSE_FIT_F64_ATOL = 2e-8
DENSE_FIT_F32_ATOL = 2e-3
DENSE_FIT_F32_AGREE = 0.99
# phase 34: K3's first-order form and K8 in each of their layouts (two
# coordinates a lane up to n = 64, four up to 128, the warp's shared memory
# past it; widths), B instances of the weighted-squares quadratic (d =
# linspace(1, 10), t = linspace(-1, 1); NoSearch d = linspace(0.2, 1.8)),
# box [-0.5, 0.5] for the bounded methods: float64 per instance over the
# first `iters` iterations (the GLL ring of 10 wraps three times), step
# for step (status, iterations and trials equal, x within K3_X_ATOL),
# float32 full solves at tol32 (converged fraction at least CONV_FLOOR and
# within CONV_ATOL of the plain version's, median iterations and f within
# MED_IT_RTOL and MED_F_RTOL).  Near x* the order of a sum decides an
# Armijo test: SPG + BackTrackingB at n = 64 compared f(x_t) - f(x) =
# -8.9e-16, one ulp of f ~ 7.9, with -c1 |x_t - x|^2 = -1.4e-17 at one
# instance's 13th iteration.  Traced on the CPU from the kernel's own
# source: the plain version's torch.sum loses the change of one term
# there and rejects, the kernel's lanes (two terms each, then a
# butterfly) keep it and accept (on the card 2 of 256 instances took
# another path over 40 iterations).  A change of x0 by 1e-15 or of the
# coordinates' order does not move the plain version's branch there, so
# no spread of its own shows it.  The plain version marks each instance's first decision that
# lies within the rounding bound of any order of its sums (``ties``):
# such an instance is held step for step through the iterations before
# that decision (the kernel and the plain version run again to there),
# and by status over `iters` iterations.  tol32: at 3e-3 float32 rounding
# decides PGD's iteration counts (f ~ 8-19 there, its last decreases an
# ulp or two): the plain version with its coordinates reversed agrees
# with itself on 2-5% of instances, its median 22 -> 21 (the card's
# kernel 19 against 21 at n = 100); at 1e-2 on all of them, and every
# case's plain version converges (GD + GLL 255 of 256 at n = 64 and 100)
LAYOUT_CHECK = dict(B=256, widths=(64, 100, 160), iters=40, tol32=1e-2,
                    max_iter=1500)
# phase 35: K1's scaled form (ops.lbfgsb_solve_fused_scaled).  (a) the
# headline's inputs with diag the Rosenbrock Hessian's diagonal at x* = 1
# (802, 1002, ..., 1002, 200), kernel vs plain on the card by converged
# fraction (CONV_ATOL) and medians (C2_MED_IT_RTOL, C2_MED_F_RTOL); (b) diag
# = 1 bit for bit against the unscaled K1; (c) float64 per instance over
# the first SCALED_CAPPED iterations at SCALED_F64_B of the starts (K1's
# rule: x within the plain version's own spread, floored at WHOLE_X_FLOOR);
# (d) Jacobi preconditioning (JAX tests/test_fused_lbfgsb.py:69) at the
# headline's batch: the cond-1e6 quadratic 0.5 sum d x^2, d = logspace(0,
# 6), in <= JACOBI["iters"] iterations with f < 1e-12 and max|x| < 1e-6
SCALED_CAPPED = 10
SCALED_F64_B = 256
JACOBI = dict(B=10240, n=100, box=3.0, pgtol=1e-6, factr=0.0, max_iter=600,
              iters=3)
# phase 36: the lockstep L-BFGS-B (solvers/lbfgsb.py, no kernel) on the
# card through minimize: (a) the headline's inputs with Rosenbrock as a
# plain torch callable, converged >= CONV_FLOOR and median f <= 1e-4 (the
# JAX package's lockstep solve of the headline: converged 1.0, median f
# 7.5e-6, BENCH_NOTES.md:15-20), the host share over its first
# LS_PROFILE_ITERS iterations; (b) ls_c2 = 0.5 with the objective's kernel
# form, over its first LS_PROFILE_ITERS iterations; (c) a 1-D float64 x0
# of the active-bounds quadratic at n = 100 (JAX tests/test_lbfgs.py:73
# widened: targets 2 and 3, x <= 1, with weights linspace(1, 10) and
# every third target 0.5, inside) on the card against the CPU, x within
# LOCKSTEP_1D_ATOL
LOCKSTEP_B = 10240
LOCKSTEP_1D_ATOL = 1e-8
# phase 37: the lockstep Newton-CG (solvers/newton_cg.py, no kernel) on the
# card through minimize(method="newton_cg"): (a) the Newton-CG headline's
# inputs (cg_max NEWTON_CG_MAX) with Rosenbrock as a plain torch callable,
# converged >= CONV_FLOOR and median f <= 1e-4; (b) config 4's bounded
# log-sum-exp at full width with CONFIG4's pgtol, factr and max_iter (past
# K4's shared memory: the lockstep loop), f against scipy's float64
# L-BFGS-B on SCIPY_ROWS instances within C4_NCG_F32_RTOL: Newton-CG's
# factr stop (a step that lowers f by less than factr * 1.2e-7 relative)
# leaves f 6e-5 to 4.2e-3 above scipy's on the first 8 instances in the
# CPU rehearsal, and JAX's own solver as much (instance 0: 5e-5 there,
# 1.0e-3 in the port: on A's null space rounding decides CG's exits);
# (c) one float64 log-sum-exp instance with more rows than columns
# (NCG_1D) through newton_cg_minimize, card against CPU within
# LOCKSTEP_1D_ATOL; (d) minimize(method="bfgs") with a plain torch callable
# and minimize(method="gd") with a log-sum-exp, which K3's chosen form (the
# first-order form, GD + BackTracking) does not compile, run the lockstep
# loop on the card (REPAIR)
C4_NCG_F32_RTOL = 1e-2
# 37a's host share is read over its first NCG_PROFILE_ITERS iterations: the
# loop is host-bound, and the profiler's own cost grows with the operations
# it records (at 15 iterations 37a took 70.7 s of wall on an H100 at 700 W,
# its solve 38.2 s and the profiled run 1.19 s of it)
NCG_PROFILE_ITERS = 5
NCG_1D = dict(n=200, rows=512, box=1.0)
REPAIR = dict(B=1024, n=100, lse_n=200, lse_rows=512, max_iter=50)
# phase 38: K4 on the log-sum-exp, config 4's A and b construction at the
# width BENCH_SCALE = 10 gives (bench.py:583): n = 1,000, 512 rows (n > rows:
# the Hessian is singular), B = 512, box [-1, 1], CONFIG4's pgtol, factr and
# max_iter, cg_max 32.  float64 over the short horizon K4_LSE_SHORT (3 Newton
# steps of at most 4 CG steps): status, iterations, HVP and trial counts
# equal per instance, x within K4_LSE_SHORT_ATOL.  Past it rounding is
# amplified: 32 CG steps a Newton step on a singular system move x by 2 after
# 8 iterations between the plain version's batch and its instances solved
# alone, where over the short horizon its own spread is 2.3e-14 and an HVP
# without its -p (p . A v) term moves x by 1.94 (tools/k4_lse_horizon.py,
# CPU).  float64 full solves on C4_F64_ROWS instances: status equal, f within
# K4_LSE_F64_RTOL, the total iterations and HVPs within K4_LSE_COUNT_RTOL
# relative (on an H100 the kernel's totals equal the CPU plain version's and
# lie 14% below the card's plain version's, whose products cuBLAS sums in
# another order; that wrong HVP: 40% fewer iterations, 60% fewer HVPs, f
# within 1.7e-8, the same tool).  float32 full solves through minimize:
# converged >= CONV_FLOOR and within CONV_ATOL of the plain version's.  f
# against scipy's float64 L-BFGS-B on SCIPY_ROWS instances, float32 within
# C4_F32_RTOL (4.2e-6 at most on the CPU) and float64 within SCIPY_RTOL_F64
K4_LSE = dict(B=512, n=1000, rows=512, box=1.0, cg_max=32)
K4_LSE_SHORT = dict(max_iter=3, cg_max=4)
K4_LSE_SHORT_ATOL = 1e-9
K4_LSE_COUNT_RTOL = 0.2
# float64 full solves at phase 38's shape, K4 against its plain version: f
# per instance within K4_LSE_F64_RTOL relative (both stop at pg <= 1e-5:
# 3.5e-7 to 7.5e-7 above scipy's f on the CPU)
K4_LSE_F64_RTOL = 1e-6
# phase 39: K3's Newton form on the log-sum-exp, PN + BackTrackingB, n = 256
# with 512 rows (a full-rank Hessian), B = 256, box [-1, 1], tol 1e-4,
# max_iter 50: float64 per instance over K3_LSE_CAPPED iterations, float32
# full solves through minimize by converged fraction (CONV_ATOL); and n >=
# rows (K3_LSE_SINGULAR), where every factor collapses and both versions
# take the fallback direction, held per instance in float64 the same way
K3_LSE = dict(B=256, n=256, rows=512, box=1.0, tol=1e-4, max_iter=50,
              max_iter_ls=40)
K3_LSE_CAPPED = 10
K3_LSE_SINGULAR = dict(B=64, n=256, rows=128)
# phases 40-42: the quadratic and log-sum-exp functors of K1, K3's
# quasi-Newton, Wolfe and dense forms and K9.  Every float64 check holds,
# over the first iterations, status per instance and x within the plain
# version's own spread under three 1e-15 relative changes of x0, floored
# at WHOLE_X_FLOOR, as phases 30-32 hold K7-K9: NCG + More-Thuente on the
# log-sum-exp amplifies rounding from its first iterations (on an NVIDIA
# H100 80GB HBM3 at 700 W after 30 iterations, x 4.2e-5 from the plain
# version's against a spread of 4.8e-5 over the batch, while 131 of 256
# instances each moved more than their own spread under one change).
# Phase 40: K1 through minimize(method="lbfgsb") (a) on the log-sum-exp at
# phase 38's shape and config 4's settings (float32 converged >=
# CONV_FLOOR and within CONV_ATOL of the plain version's; f of SCIPY_ROWS
# instances against scipy's float64 L-BFGS-B, float32 within C4_F32_RTOL
# and float64 within SCIPY_RTOL_F64; float64 over K1_DATA_CAPPED
# iterations on the first C4_F64_ROWS instances; K2, the route before,
# timed on the same inputs) and (b) on config 5's quadratic (pgtol 1e-5
# and factr 0: with factr 100 the float32 f-decrease test stops at max|x|
# ~ 9e-4 near f = 0, the plain version on the CPU), converged >=
# CONV_FLOOR and max|x| <= C5_X_ATOL.  Phase 41: K3 through
# solvers.batch_minimize on the log-sum-exp at phase 39's shape (tol 1e-3:
# f = 5.48 at the minimizer, which lies at |x| ~ 40, and at 1e-4 NCG +
# More-Thuente exhausts 300 float32 iterations in the plain version) and on
# config 5's quadratic at n = 1,024 (tol 1e-4; the dense form at B = 64,
# its slabs in the workspace); float64 over K3_DATA_CAPPED iterations;
# float32 converged (the dense form: success class, CONVERGED or STALLED,
# as config 2) >= CONV_FLOOR and within CONV_ATOL of plain; the lockstep
# loop's ms per iteration (the route these batches took before) over
# LOCKSTEP_DATA_ITERS iterations.  Phase 42: K9 through
# ops.bfgs_solve_fused on phase 39's log-sum-exp, float64 over
# WHOLE_K9_CAPPED iterations (the triangles in the workspace) and float32
# capped at K9_DATA_ITERS iterations (BFGS from B0 = I does not reach tol
# 1e-3 in 600 iterations there, in float64 either, the plain version on the
# CPU), held by status per instance and median f (MED_F_RTOL)
K1_LSE = dict(B=512, n=1000, rows=512, box=1.0)
K1_QUAD = dict(B=256, n=1024, m=5, box=2.0, pgtol=1e-5, factr=0.0,
               max_iter=200)
K1_DATA_CAPPED = 10
K3_DATA = dict(lse=dict(B=256, n=256, rows=512, tol=1e-3),
               quad=dict(B=256, B_dense=64, n=1024, tol=1e-4),
               max_iter=1000, max_iter_ls=40)
K3_DATA_CAPPED = 30
LOCKSTEP_DATA_ITERS = 20
K9_DATA = dict(B=256, n=256, rows=512, tol=1e-3)
K9_DATA_ITERS = 200
CONV_FLOOR = 0.99
WHOLE_K7_CAPPED = 10
WHOLE_K8_CAPPED = 30
WHOLE_K9_CAPPED = 15
WHOLE_X_FLOOR = 1e-10

# the card's rates for the bound (NVIDIA's H100 SXM data sheet, at 700 W):
# HBM3 bytes per second and float32 operations per second outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k6_stream_bytes(n, nb, itemsize):
    """Device-memory bytes the blocked K6 moves per instance at panel width
    ``nb`` (``ops/csrc/chol_blocked.cuh``): the transposing copy of H's
    lower triangle, per panel the diagonal block, the panel rows right of
    it (TRSM) and the trailing triangle (SYRK), each read and written once,
    the two substitutions reading the factor, g read and x written.  The
    panel rows staged again for each output tile are left out (L2 serves
    them), so this is the design's floor."""
    def tri(m):
        return m * (m + 1) // 2

    elems = 2 * tri(n) + 2 * tri(n) + 2 * n
    for k0 in range(0, n, nb):
        w = min(nb, n - k0)
        rest = n - k0 - w
        elems += 2 * tri(w) + 2 * w * rest + 2 * tri(rest)
    return elems * itemsize


def dense_slab_stream_bytes(n, itemsize, directions, products, updates):
    """Device-memory bytes the dense kernels' earlier design streamed
    through their (n, n) slabs in device memory (K3's QN form and K9 until
    this design): one read of the slab per direction (B g) and per B y, a
    read and a write per update.  The new design keeps the slab in shared
    memory at config 2's shape, where this stream is zero."""
    return (directions + products + 2 * updates) * n * n * itemsize


def dense_smem_floor_ms(n, itemsize, directions, products, updates,
                        sm_mhz):
    """The shared-memory floor of the dense kernels' design: the same passes
    over the packed triangle (n (n + 1) / 2 elements) at 128 bytes per
    clock on each of the card's 132 SMs and the SM clock ``sm_mhz``."""
    nbytes = (directions + products + 2 * updates) * n * (n + 1) // 2 \
        * itemsize
    return 1e3 * nbytes / (132 * 128 * sm_mhz * 1e6)


def sm_clock_mhz():
    """The card's top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def k2_stream_bytes(n, m, itemsize, iterations, rows):
    """Device-memory bytes the tiled K2 must move for ``iterations``
    instance-iterations at config 4 (``ops/csrc/lbfgsb_tall.cu``): per
    iteration four passes over the instance's interleaved histories (rows
    of ``2m`` padded to a multiple of 4: W^T (xcp - x), the Gram pass, the
    direction and the update) and the update's write of the new pair, and
    the body's 47 passes over (n,) vectors, each read or write once (the
    bounds are shared by the batch and read from L2).  The objective's
    data (rows x n) counts once.  The Cauchy point's first pass and
    bisection probes, the line search's trials and the passes over A that
    L2 serves are left out: this is the design's floor."""
    R = (2 * m + 3) // 4 * 4
    per_iter = 4 * n * R + 2 * n + 47 * n
    return (iterations * per_iter + rows * n) * itemsize


def tile_spread(iterations, tile):
    """K2's lockstep waste: the mean over tiles of the tile's largest
    iteration count, over the mean count (1: none).  Tiles are
    consecutive instances, the last one ragged."""
    it = [int(v) for v in iterations.cpu().tolist()]
    tops = [max(it[i:i + tile]) for i in range(0, len(it), tile)]
    return (sum(tops) / len(tops)) / (sum(it) / len(it))


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--breakdown", action="store_true",
        help="also print where K1's time goes at the headline (iteration "
        "caps, a batch sweep, registers and resident warps), K2's at config "
        "4 (iteration caps, the bisection's share) and K3's at configs 3, "
        "6, 2 and 5 (a profiled solve, a batch sweep and an iteration cap)")
    parser.add_argument(
        "--times", metavar="ROOT",
        help="only time config 2 (batch_minimize), K9, L-BFGS + HZ, K7, K8, "
        "K4, K5, K6, the headline and configs 3, 6 and 4 through minimize and "
        "config 5 "
        "through K3 and the lockstep K6 path in turns, with the package "
        "found under ROOT (a checkout; '.' for this one), to compare two "
        "commits in turns on one card; prints no result line")
    args = parser.parse_args(argv)
    breakdown = args.breakdown
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.times:
        return in_turns_times(args.times)
    from _torch_geometries import k1_geometries, perturbation_spread, tiled
    from optimization_solvers_tpu_torch import minimize, problems
    from optimization_solvers_tpu_torch.ops import (_build, fused_lbfgsb,
                                                    fused_lbfgsb_tall)

    dev = torch.device("cuda")
    K1 = fused_lbfgsb.lbfgsb_solve_fused
    K2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    plain = fused_lbfgsb.lbfgsb_solve_plain

    # ---- 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"card: {card}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s))")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s (nvcc, sm_90a, {len(_build._sources())} "
        "source(s))")
    with open(_build.LOG) as fh:
        for line in fh:
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                log("  ptxas:", line.strip())

    def tensors(*arrays, dtype=torch.float64):
        return tuple(torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)
                     for a in arrays)

    def sync_time(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # ---- 3. kernel vs plain on the card, 64 instances per geometry
    max_abs_err = 0.0
    for name, (obj, x0, lo, up, data, opts) in k1_geometries().items():
        x0, lo, up = tiled(x0, lo, up, 64)
        tx0, tlo, tup, *tdata = tensors(x0, lo, up, *data)

        def run_plain(x):
            (xt,) = tensors(x)
            return plain(obj, xt, tlo, tup, tuple(tdata), m=5, **opts)

        r = K1(obj, tx0, tlo, tup, tuple(tdata), m=5, **opts)
        torch.cuda.synchronize()
        x, _, it, st = run_plain(x0)
        budget = max(2, perturbation_spread(
            lambda v: run_plain(v)[2].cpu().numpy(), x0))
        err = (r.x - x).abs().max().item()
        dit = (r.iterations.long() - it.long()).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        log(f"kernel vs plain f64 {name}: status equal "
            f"{bool((r.status == st).all())}, max|dx| {err:.3g}, "
            f"max|d iters| {dit} (budget {budget}), converged "
            f"{(r.status == 1).float().mean().item():.3f}")
        check(bool((r.status == st).all()), f"{name}: status differs")
        check(err <= X_ATOL_F64, f"{name}: max|dx| {err} > {X_ATOL_F64}")
        check(dit <= budget, f"{name}: iterations differ by {dit}")

    f = problems.rosenbrock()
    n, B = HEADLINE["n"], HEADLINE["B"]
    kw = dict(m=HEADLINE["m"], pgtol=HEADLINE["pgtol"],
              factr=HEADLINE["factr"], max_iter=HEADLINE["max_iter"])
    lo = torch.full((n,), -BOX, device=dev)
    up = torch.full((n,), BOX, device=dev)
    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (B, n))
    (x64,) = tensors(starts[:64], dtype=torch.float32)
    r = K1(f, x64, lo, up, **kw)
    torch.cuda.synchronize()
    _, _, _, st = plain(f, x64, lo, up, **kw)
    ck = (r.status == 1).float().mean().item()
    cp = (st == 1).float().mean().item()
    log(f"kernel vs plain f32 headline objective, 64 instances: converged "
        f"{ck:.3f} vs {cp:.3f}")
    check(abs(ck - cp) <= 0.01, "f32 converged fractions differ by > 1%")

    # ---- 4. the main path through minimize, at the headline size
    (x0,) = tensors(starts, dtype=torch.float32)

    def solve(x):
        return minimize(f, x, method="lbfgsb", bounds=(-BOX, BOX),
                        tol=HEADLINE["pgtol"], m=HEADLINE["m"],
                        factr=HEADLINE["factr"], max_iter=HEADLINE["max_iter"])

    K1.launches = K2.launches = 0
    res, first_s = sync_time(lambda: solve(x0))
    launches = K1.launches
    check(K2.launches == 0, "the headline launched the tall kernel")
    conv = (res.status == 1).float().mean().item()
    med_f = res.f.median().item()
    log(f"headline via minimize: launches {launches}, converged {conv:.4f}, "
        f"median f {med_f:.3e}, median iterations "
        f"{res.iterations.float().median().item():.0f}, first call "
        f"{first_s:.3f} s")
    check(launches >= 1, "the main path launched no kernel")
    check(res.x.shape == (B, n) and res.f.shape == (B,), "result shapes")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.f).all()),
          "non-finite result")
    check(conv >= 0.99, f"converged fraction {conv} < 0.99")
    check(med_f <= 1e-4, f"median f {med_f} > 1e-4")

    rng = np.random.RandomState(7)
    walls = []
    for _ in range(3):
        (x,) = tensors(rng.uniform(-2.0, 2.0, (B, n)), dtype=torch.float32)
        _, dt = sync_time(lambda: solve(x))
        walls.append(dt)
    sps = [B / w for w in walls]
    log(f"headline solves/s (kernel, 3 repeats, distinct inputs): median "
        f"{statistics.median(sps):.0f}, min {min(sps):.0f}, max "
        f"{max(sps):.0f}  [{card}]")

    # kernel vs plain at the headline shape, CAPPED_ITERS iterations each.
    # float64: both must agree per instance.  float32: a one-ulp change of
    # x0 already moves some instances' Armijo decisions, so agreement is
    # printed beside the plain version's own agreement under that nudge,
    # and the full solves below are compared by converged fraction.
    capped = dict(kw, max_iter=CAPPED_ITERS)
    (x0d,) = tensors(starts)
    lod, upd = lo.double(), up.double()
    rk = K1(f, x0d, lod, upd, **capped)
    xp, _, _, sp = plain(f, x0d, lod, upd, **capped)
    dx = (rk.x - xp).abs().amax(-1)
    close = (dx <= X_ATOL_F64).float().mean().item()
    same = (rk.status == sp).float().mean().item()
    log(f"kernel vs plain f64 headline shape, {CAPPED_ITERS} iterations: "
        f"status equal {same:.5f}, within {X_ATOL_F64} {close:.5f}, "
        f"max|dx| {dx.max().item():.3g}")
    check(same >= F64_AGREE and close >= F64_AGREE,
          "kernel and plain disagree at the headline shape (float64)")
    rk, tk = sync_time(lambda: K1(f, x0, lo, up, **capped))
    (xp, _, _, _), tp = sync_time(lambda: plain(f, x0, lo, up, **capped))
    x1 = torch.nextafter(x0, torch.full_like(x0, 2 * BOX))
    xq = plain(f, x1, lo, up, **capped)[0]

    def agree(a, b):
        return ((a - b).abs().amax(-1) <= F32_ATOL).float().mean().item()

    log(f"kernel vs plain f32 headline shape, {CAPPED_ITERS} iterations: "
        f"within {F32_ATOL}: {agree(rk.x, xp):.4f} (plain vs plain with x0 "
        f"one ulp up: {agree(xq, xp):.4f}); per iteration kernel "
        f"{1e3 * tk / CAPPED_ITERS:.3f} ms, plain "
        f"{1e3 * tp / CAPPED_ITERS:.3f} ms  [{card}]")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    kernel_ms = []
    for _ in range(3):
        start.record()
        K1(f, x0, lo, up, **kw)
        stop.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(stop))
    ms = statistics.median(kernel_ms)
    if tp / CAPPED_ITERS * HEADLINE["max_iter"] <= PLAIN_BUDGET_S:
        (_, fp, _, sp), tpf = sync_time(lambda: plain(f, x0, lo, up, **kw))
        plain_ms = 1e3 * tpf
        cpf = (sp == 1).float().mean().item()
        log(f"plain full solve at the headline shape: {tpf:.2f} s, "
            f"{B / tpf:.0f} solves/s, converged {cpf:.4f}, median f "
            f"{fp.median().item():.3e}; kernel {ms:.2f} ms, "
            f"{1e3 * B / ms:.0f} solves/s  [{card}]")
        check(abs(cpf - conv) <= 0.01, "full-solve converged fractions differ")
    else:
        ms, plain_ms = 1e3 * tk, 1e3 * tp
        log(f"plain full solve would exceed {PLAIN_BUDGET_S:.0f} s; ms and "
            f"plain_ms below are the {CAPPED_ITERS}-iteration runs")

    # bound at the headline: x0 read and x, f, iterations, status written
    # once; per iteration at least the interior-path arithmetic of
    # csrc/lbfgsb_fused.cu (two-loop 8mn, W^T d0 4mn, Gram rows 6mn, one
    # Rosenbrock trial 8n and value-and-gradient 15n, gate, clip and
    # convergence ~18n).  Cauchy walks and further trials depend on the
    # data and are not counted, so this is a floor.
    m1 = HEADLINE["m"]
    bound_ms, bound_by = bound(
        2 * B * n * 4 + 2 * n * 4 + 3 * B * 4,
        res.iterations.double().sum().item() * (18 * m1 * n + 41 * n)
        + B * 15 * n)
    log(f"K1 bound at the headline: {bound_ms:.4f} ms ({bound_by}); kernel "
        f"{ms:.2f} ms  [{card}]")
    k1 = {
        "name": "lbfgsb_fused",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb.py:938",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    tall = tall_slice(dev, card, tensors, sync_time)
    first_order = driver_slice(dev, card, tensors, sync_time)
    quasi_newton = qn_slice(dev, card, tensors, sync_time)
    newton_form = newton_slice(dev, card, tensors, sync_time)
    newton_cg = newton_cg_slice(dev, card, tensors, sync_time)
    k5 = lockstep_slice(dev, card, tensors, sync_time)
    k6 = cholesky_slice(dev, card, tensors, sync_time)
    k7, k8, k9 = whole_solve_slice(dev, card, tensors, sync_time)
    k3_fit_err, k9_fit_err = dense_fit_slice(dev, card, tensors)
    k9["max_abs_err"] = max(k9["max_abs_err"], k9_fit_err)
    k3_layout_err, k8_layout_err = layouts_slice(dev, card, tensors)
    k8["max_abs_err"] = max(k8["max_abs_err"], k8_layout_err)
    k1s = scaled_slice(dev, card, tensors, sync_time)
    lockstep_lbfgsb_slice(dev, card, tensors, sync_time)
    t37 = time.perf_counter()
    lockstep_newton_cg_slice(dev, card, tensors, sync_time)
    k4_lse, k3_lse = lse_second_order_slice(dev, card, tensors, sync_time)
    log(f"phases 37-39: {time.perf_counter() - t37:.1f} s wall")
    t40 = time.perf_counter()
    data_functors = data_functors_slice(dev, card, tensors, sync_time)
    log(f"phases 40-42: {time.perf_counter() - t40:.1f} s wall")
    if breakdown:
        k1_breakdown(dev, card, tensors, sync_time)
        tall_breakdown(dev, card, tensors, sync_time)
        driver_breakdown(dev, card, tensors, sync_time)

    # ---- 26. results.  K3's entry takes config 2 through batch_minimize
    # (its Newton form has an entry of its own); "paths" lists every path
    # of the first-order and quasi-Newton forms
    paths = {k: v for d in (first_order, quasi_newton) for k, v in d.items()
             if k != "max_abs_err"}
    c2 = paths["config 2"]
    driver = {
        "name": "driver",
        "forms": ["first-order", "quasi-Newton", "dense"],
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/driver.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_driver.py:1874",
        "launches": c2["launches"],
        "max_abs_err": max(first_order["max_abs_err"],
                           quasi_newton["max_abs_err"], k3_fit_err,
                           k3_layout_err),
        "ms": c2["ms"],
        "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"],
        "bound_by": c2["bound_by"],
        "library_ms": None,
        "paths": paths,
    }
    log(json.dumps({"kernels": [k1, k1s, tall, driver, newton_form,
                                k3_lse, newton_cg, k4_lse, k5, k6, k7, k8,
                                k9, *data_functors]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def tall_slice(dev, card, tensors, sync_time):
    """Phases 5-8: the tall kernel K2 against its plain version, config 4
    through ``minimize`` in both policies, the scipy anchor and the times.
    Returns K2's entry of the ``kernels`` line."""
    import torch
    from scipy.optimize import fmin_l_bfgs_b

    from _torch_geometries import (k2_geometries, lse_arrays,
                                   perturbation_spread, tiled)
    from optimization_solvers_tpu_torch import minimize, problems
    from optimization_solvers_tpu_torch.ops import (fused_lbfgsb,
                                                    fused_lbfgsb_tall)

    K1 = fused_lbfgsb.lbfgsb_solve_fused
    K2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    plain = fused_lbfgsb_tall.lbfgsb_solve_tall_plain

    # ---- 5. K2 vs plain on the card, float64, 64 instances per geometry
    max_abs_err = 0.0
    cases = [(name, "armijo") for name in k2_geometries()]
    cases.append(("lse_config4_class", "dcsrch"))
    for name, search in cases:
        obj, x0, lo, up, data, opts = k2_geometries()[name]
        opts = dict(opts, line_search=search)
        x0, lo, up = tiled(x0, lo, up, 64)
        tx0, tlo, tup, *tdata = tensors(x0, lo, up, *data)

        def run_plain(x):
            (xt,) = tensors(x)
            return plain(obj, xt, tlo, tup, tuple(tdata), **opts)

        r = K2(obj, tx0, tlo, tup, tuple(tdata), **opts)
        torch.cuda.synchronize()
        x, _, it, st, flag = run_plain(x0)
        budget = max(2, perturbation_spread(
            lambda v: run_plain(v)[2].cpu().numpy(), x0))
        err = (r.x - x).abs().max().item()
        dit = (r.iterations.long() - it.long()).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        log(f"K2 vs plain f64 {name} ({search}): status equal "
            f"{bool((r.status == st).all())}, max|dx| {err:.3g}, "
            f"max|d iters| {dit} (budget {budget}), guard flags equal "
            f"{(r.gcp_multimodal == flag).float().mean().item():.3f}, "
            f"converged {(r.status == 1).float().mean().item():.3f}")
        check(bool((r.status == st).all()), f"K2 {name}: status differs")
        check(err <= X_ATOL_F64, f"K2 {name}: max|dx| {err} > {X_ATOL_F64}")
        check(dit <= budget, f"K2 {name}: iterations differ by {dit}")

    # ---- 6. config 4 through minimize: the route takes K2
    c = CONFIG4
    B, n = c["B"], c["n"]
    A64, b64 = lse_arrays(n, c["rows"])
    lse = problems.log_sum_exp(*tensors(A64, b64, dtype=torch.float32))
    lo = torch.full((n,), -C4_BOX, device=dev)
    up = torch.full((n,), C4_BOX, device=dev)
    starts = np.random.RandomState(4).uniform(-0.5, 0.5, (B, n))
    (x0,) = tensors(starts, dtype=torch.float32)
    tall_kw = dict(m=c["m"], pgtol=c["pgtol"], factr=c["factr"],
                   max_iter=c["max_iter"], max_iter_ls=20)

    def solve(x, policy="fast"):
        return minimize(lse, x, method="lbfgsb", bounds=(-C4_BOX, C4_BOX),
                        m=c["m"], tol=c["pgtol"], factr=c["factr"],
                        max_iter=c["max_iter"], policy=policy)

    def summary(r):
        conv = (r.status == 1).float().mean().item()
        return conv, (f"converged {conv:.4f}, median f "
                      f"{r.f.median().item():.7g}, median iterations "
                      f"{r.iterations.float().median().item():.0f} (max "
                      f"{r.iterations.max().item()}), guard flags "
                      f"{r.gcp_multimodal.float().mean().item():.3f}")

    K1.launches = K2.launches = 0
    res, first_s = sync_time(lambda: solve(x0))
    launches = K2.launches
    check(K1.launches == 0, "config 4 launched K1")
    conv, text = summary(res)
    tile = K2.last_tile
    log(f"config 4 via minimize (fast): K2 launches {launches}, K1 launches "
        f"{K1.launches}, {text}, first call {first_s:.3f} s; tile {tile} "
        f"({-(-B // tile)} blocks of {K2.last_groups} groups), the tiles' "
        f"iteration spread (mean tile maximum over mean) "
        f"{tile_spread(res.iterations, tile):.4f}")
    check(launches == 1, f"config 4: {launches} K2 launches for one call")
    check(launches >= 1, "config 4 launched no tall kernel")
    check(res.x.shape == (B, n) and res.f.shape == (B,), "config 4 shapes")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.f).all()),
          "config 4: non-finite result")
    check(conv >= 0.99, f"config 4 converged fraction {conv} < 0.99")

    (_, fp, _, sp, _), plain_s = sync_time(
        lambda: plain(lse, x0, lo, up, **tall_kw))
    cp = (sp == 1).float().mean().item()
    rel = ((res.f - fp).abs() / fp.abs()).double()
    log(f"config 4 K2 vs plain f32: converged {conv:.4f} vs {cp:.4f}, median "
        f"f {res.f.median().item():.7g} vs {fp.median().item():.7g}, "
        f"per-instance rel |df| max {rel.max().item():.3g}, median "
        f"{rel.median().item():.3g}, within 1e-5 "
        f"{(rel <= 1e-5).float().mean().item():.3f}; plain {plain_s:.3f} s")
    check(abs(conv - cp) <= 0.01, "config 4 converged fractions differ > 1%")
    check(rel.max().item() <= C4_F32_RTOL,
          f"config 4 per-instance f differs by > {C4_F32_RTOL} relative")

    # per instance in float64 at config-4 width, and the scipy anchor
    lse64 = problems.log_sum_exp(*tensors(A64, b64))
    (x64,) = tensors(starts[:C4_F64_ROWS])
    r64 = K2(lse64, x64, lo.double(), up.double(), **tall_kw)
    torch.cuda.synchronize()
    xp, fp64, itp, stp, _ = plain(lse64, x64, lo.double(), up.double(),
                                  **tall_kw)
    err = (r64.x - xp).abs().max().item()
    rel64 = ((r64.f - fp64).abs() / fp64.abs()).max().item()
    dit = (r64.iterations.long() - itp.long()).abs().max().item()
    max_abs_err = max(max_abs_err, err)
    log(f"config 4 K2 vs plain f64, {C4_F64_ROWS} instances: status equal "
        f"{bool((r64.status == stp).all())}, max|dx| {err:.3g}, max rel "
        f"|df| {rel64:.3g}, max|d iters| {dit}")
    check(bool((r64.status == stp).all()), "config 4 f64: status differs")
    check(err <= X_ATOL_F64 and rel64 <= C4_F64_RTOL and dit <= 2,
          "config 4 f64: kernel and plain disagree")

    def fg(x):
        z = A64 @ x + b64
        mz = z.max()
        e = np.exp(z - mz)
        return mz + np.log(e.sum()), A64.T @ (e / e.sum())

    for i in range(SCIPY_ROWS):
        _, fs, _ = fmin_l_bfgs_b(fg, starts[i], bounds=[(-C4_BOX, C4_BOX)] * n,
                                 m=c["m"], pgtol=c["pgtol"], factr=c["factr"],
                                 maxiter=c["max_iter"])
        e64 = abs(r64.f[i].item() - fs) / abs(fs)
        e32 = abs(res.f[i].item() - fs) / abs(fs)
        log(f"config 4 instance {i} vs scipy f64 (f {fs:.10g}): K2 f64 rel "
            f"{e64:.3g}, K2 f32 rel {e32:.3g}")
        check(e64 <= SCIPY_RTOL_F64, f"instance {i}: K2 f64 vs scipy {e64}")
        check(e32 <= C4_F32_RTOL, f"instance {i}: K2 f32 vs scipy {e32}")

    # ---- 7. the same call with policy="reference" (dcsrch in K2)
    K1.launches = K2.launches = 0
    ref, ref_s = sync_time(lambda: solve(x0, "reference"))
    conv_r, text = summary(ref)
    log(f"config 4 via minimize (reference): K2 launches {K2.launches}, K1 "
        f"launches {K1.launches}, {text}, {ref_s:.3f} s "
        f"({B / ref_s:.0f} solves/s); tiles' iteration spread "
        f"{tile_spread(ref.iterations, K2.last_tile):.4f}  [{card}]")
    check(K2.launches >= 1 and K1.launches == 0,
          "config 4 (reference) did not take the tall kernel alone")
    check(conv_r >= 0.99, f"config 4 (reference) converged {conv_r} < 0.99")

    # ---- 8. times at config 4: median of 3 on distinct inputs, in turns
    rng = np.random.RandomState(9)
    kernel_s, plain_s = [], []
    for _ in range(3):
        (x,) = tensors(rng.uniform(-0.5, 0.5, (B, n)), dtype=torch.float32)
        kernel_s.append(sync_time(lambda: solve(x))[1])
        plain_s.append(sync_time(lambda: plain(lse, x, lo, up, **tall_kw))[1])
    for what, ts in (("K2 via minimize", kernel_s), ("K2 plain", plain_s)):
        sps = [B / t for t in ts]
        log(f"config 4 {what}: solves/s median {statistics.median(sps):.1f}, "
            f"min {min(sps):.1f}, max {max(sps):.1f}; "
            f"{1e3 * statistics.median(ts):.1f} ms per call  [{card}]")
    # bound at config 4: x0, A, b and the bounds read once, x, f,
    # iterations, status and flag written once; per iteration at least
    # the objective's three passes over A (the trial's A x, then A x and
    # A^T softmax: 6 rows n) and the history products of
    # csrc/lbfgsb_tall.cu (W^T v and W c 8mn, Gram rows 6mn).  The
    # bisection probes depend on the data and are not counted: a floor.
    rows, m2 = c["rows"], c["m"]
    bound_ms, bound_by = bound(
        2 * B * n * 4 + rows * n * 4 + rows * 4 + 2 * n * 4 + B * 13,
        res.iterations.double().sum().item() * (6 * rows * n + 14 * m2 * n)
        + B * 4 * rows * n)
    floor_ms = 1e3 * k2_stream_bytes(
        n, c["m"], 4, res.iterations.double().sum().item(),
        rows) / HBM_BYTES_PER_S
    log(f"K2 bound at config 4: {bound_ms:.4f} ms ({bound_by}); the tiled "
        f"design's streaming floor {floor_ms:.3f} ms; tile {tile}  [{card}]")
    return {
        "name": "lbfgsb_tall",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_tall.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb_tall.py:941",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": 1e3 * statistics.median(kernel_s),
        "plain_ms": 1e3 * statistics.median(plain_s),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "tile": tile,
    }


def k1_breakdown(dev, card, tensors, sync_time):
    """With ``--breakdown`` only: where K1's time goes at the headline:
    iteration caps 0, 1 and 10 through ``minimize``, a batch sweep (the
    headline's first B starts, K1 launched directly, CUDA events; medians
    of 3), K1's registers and spills as ``ptxas`` reported them, and its
    launch and resident warps per SM from the card's occupancy calculator.
    The phase shares come from ``tools/k1_phase_profile.py``.  Timing
    only: nothing here is held."""
    import torch

    from optimization_solvers_tpu_torch import minimize, problems
    from optimization_solvers_tpu_torch.ops import _build, fused_lbfgsb

    f = problems.rosenbrock()
    B, n, m = HEADLINE["B"], HEADLINE["n"], HEADLINE["m"]
    kw = dict(m=m, pgtol=HEADLINE["pgtol"], factr=HEADLINE["factr"],
              max_iter=HEADLINE["max_iter"])
    (x,) = tensors(np.random.RandomState(42).uniform(-2.0, 2.0, (B, n)),
                   dtype=torch.float32)
    box = torch.full((n,), BOX, device=dev)
    with open(_build.LOG) as fh:
        lines = fh.read().splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry" in line and "lbfgsb_fused_kernel" in line:
            used = next((v.strip() for v in lines[k + 1:k + 4]
                         if "registers" in v), "?")
            spill = next((v.strip() for v in lines[k + 1:k + 4]
                          if "spill" in v), "?")
            log(f"K1 ptxas: {line.split(chr(39))[1]}: {used}; {spill}")
    for dtype in (torch.float32, torch.float64):
        for unbounded in (False, True):
            log(f"K1 launch at the headline, {str(dtype)[6:]}, "
                f"{'unbounded' if unbounded else 'bounded'} body: "
                f"{fused_lbfgsb.kernel_info(dtype, B, n, m, 'ROSENBROCK', unbounded)}")

    def med(fn):
        fn()
        return 1e3 * statistics.median(sync_time(fn)[1] for _ in range(3))

    capped = {cap: med(lambda: minimize(
        f, x, method="lbfgsb", bounds=(-BOX, BOX), tol=kw["pgtol"], m=m,
        factr=kw["factr"], max_iter=cap)) for cap in (0, 1, 10)}
    log(f"headline iteration cap (median of 3): "
        + ", ".join(f"{k}: {v:.3f} ms" for k, v in capped.items())
        + f"; one iteration {capped[1] - capped[0]:.3f} ms (cap 1 - cap 0), "
        f"{(capped[10] - capped[0]) / 10:.3f} ms averaged over 10  [{card}]")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for b in K1_SWEEP:
        xb = x[:b]
        fused_lbfgsb.lbfgsb_solve_fused(f, xb, -box, box, **kw)
        ms = []
        for _ in range(3):
            start.record()
            fused_lbfgsb.lbfgsb_solve_fused(f, xb, -box, box, **kw)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
        info = fused_lbfgsb.kernel_info(torch.float32, b, n, m)
        log(f"K1 batch sweep B = {b}: {statistics.median(ms):.3f} ms "
            f"(median of 3), {info['warps_per_block']} warps per block, "
            f"{-(-b // info['warps_per_block'])} blocks, "
            f"{info['warps_per_sm']} resident warps per SM  [{card}]")


def tall_breakdown(dev, card, tensors, sync_time):
    """With ``--breakdown`` only: where K2's time goes at config 4 (through
    ``minimize``, medians of 3): iteration caps 0, 1 and 10, and the
    Cauchy bisection's share, K2 launched directly at ``bisect_iters`` 40
    (the default) against 2 over the same 10 iterations.  Timing only:
    nothing here is held."""
    import torch

    from _torch_geometries import lse_arrays
    from optimization_solvers_tpu_torch import minimize, problems
    from optimization_solvers_tpu_torch.ops import fused_lbfgsb_tall

    c = CONFIG4
    B, n = c["B"], c["n"]
    lse = problems.log_sum_exp(*tensors(*lse_arrays(n, c["rows"]),
                                        dtype=torch.float32))
    (x,) = tensors(np.random.RandomState(4).uniform(-0.5, 0.5, (B, n)),
                   dtype=torch.float32)
    box = torch.full((n,), C4_BOX, device=dev)

    def med(fn):
        fn()
        return 1e3 * statistics.median(sync_time(fn)[1] for _ in range(3))

    capped = {cap: med(lambda: minimize(
        lse, x, method="lbfgsb", bounds=(-C4_BOX, C4_BOX), m=c["m"],
        tol=c["pgtol"], factr=c["factr"], max_iter=cap)) for cap in (0, 1, 10)}
    gcp = {bi: med(lambda: fused_lbfgsb_tall.lbfgsb_solve_fused_tall(
        lse, x, -box, box, m=c["m"], pgtol=c["pgtol"], factr=c["factr"],
        max_iter=10, bisect_iters=bi)) for bi in (40, 2)}
    it_ms = (capped[10] - capped[0]) / 10
    log(f"config 4 iteration cap (median of 3): "
        + ", ".join(f"{k}: {v:.3f} ms" for k, v in capped.items())
        + f"; one iteration {capped[1] - capped[0]:.3f} ms (cap 1 - cap 0), "
        f"{it_ms:.3f} ms averaged over 10  [{card}]")
    log(f"config 4, 10 iterations: bisect_iters 40 {gcp[40]:.3f} ms, 2 "
        f"{gcp[2]:.3f} ms; the bisection past two probes "
        f"{(gcp[40] - gcp[2]) / max(gcp[40] - capped[0], 1e-9):.3f} of the "
        f"10 iterations' time  [{card}]")


def k3_against_plain(name, g, tensors):
    """K3, launched directly, against its plain version on one geometry of
    ``tests/_torch_geometries.py`` in float64: status equal, iteration
    counts within the plain version's own spread (``max(2, spread)`` on the
    chaotic entries), trial counts equal where the counts must be, x within
    the entry's ``x_atol`` (instances whose f is not finite: within
    ``far_rtol`` relative, default 1e-12; None: printed, not held).
    Returns max |dx| over the finite instances."""
    import torch

    from _torch_geometries import perturbation_spread
    from optimization_solvers_tpu_torch.ops import fused_driver

    def opt(a):
        return None if a is None else tensors(a)[0]

    x0, lo, up = (opt(a) for a in (g["x0"], g["lower"], g["upper"]))
    data = tensors(*g["data"])
    kw = dict(max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])
    spec = fused_driver.build_spec(g["method"], g["search"])
    x, f, it, st, nfev = fused_driver._launch_cuda(
        spec, g["objective"], x0, lo, up, data, **kw)
    torch.cuda.synchronize()

    def run_plain(v):
        return fused_driver.fused_minimize_plain(
            g["method"], g["search"], g["objective"], opt(v), lo, up, data,
            **kw)

    xp, _, itp, stp, nfevp = run_plain(g["x0"])
    spread = perturbation_spread(
        lambda v: run_plain(v)[2].cpu().numpy(), g["x0"],
        runs=6 if g["chaotic"] else 3)
    budget = max(2, spread) if g["chaotic"] else spread
    finite = torch.isfinite(f)
    err = (x - xp)[finite].abs().max().item()
    far_rtol = g.get("far_rtol", 1e-12)
    far = (x[~finite] - xp[~finite]).abs() / xp[~finite].abs()
    far_ok = far_rtol is None or torch.allclose(
        x[~finite], xp[~finite], rtol=far_rtol, atol=0.0, equal_nan=True)
    dit = (it.long() - itp.long()).abs().max().item()
    same_trials = bool((nfev == nfevp).all())
    log(f"K3 vs plain f64 {name}: status equal {bool((st == stp).all())}, "
        f"max|dx| {err:.3g}, max|d iters| {dit} (budget {budget}), trials "
        f"equal {same_trials}, converged "
        f"{(st == 1).float().mean().item():.3f}"
        + (f", max relative |dx| where f is not finite "
           f"{far.nan_to_num(0.0, posinf=float('inf')).max().item():.3g}"
           if far.numel() else ""))
    check(bool((st == stp).all()), f"K3 {name}: status differs")
    check(err <= g["x_atol"],
          f"K3 {name}: max|dx| {err} > {g['x_atol']}")
    check(far_ok, f"K3 {name}: x differs on the instances whose f is not "
          f"finite beyond {far_rtol} relative")
    check(dit <= budget, f"K3 {name}: iterations differ by {dit}")
    if not g["chaotic"] and spread == 0 and g.get("trials_exact", True):
        check(same_trials, f"K3 {name}: trial counts differ")
    return err


def k3_per_instance(what, method, search, obj, x0, lo, up, data, kw,
                    tensors, trials=True):
    """K3, launched directly, against the plain version in float64 on the
    main path's inputs: status, iterations and (with ``trials``) trials
    equal and x within K3_X_ATOL, or where larger the instance's own spread
    in the plain version under a 1e-15 relative change of x0, for every
    instance.  Returns max |dx|."""
    import torch

    from optimization_solvers_tpu_torch.ops import fused_driver

    plain = fused_driver.fused_minimize_plain
    spec = fused_driver.build_spec(method, search)
    x, _, it, st, nfev = fused_driver._launch_cuda(
        spec, obj, x0, lo, up, data, **kw)
    torch.cuda.synchronize()
    xp, _, itp, stp, nfevp = plain(method, search, obj, x0, lo, up, data,
                                   **kw)
    noise = tensors(np.random.RandomState(100).standard_normal(
        tuple(x0.shape)))[0]
    xq = plain(method, search, obj, x0 * (1 + 1e-15 * noise), lo, up, data,
               **kw)[0]
    # per instance: its max|dx| and its own spread
    row_err = (x - xp).abs().amax(-1)
    row_spread = (xq - xp).abs().amax(-1)
    held = row_err <= torch.clamp(row_spread, min=K3_X_ATOL)
    by_spread = (held & (row_err > K3_X_ATOL)).nonzero().flatten().tolist()
    err = row_err.max().item()
    same = [(a == b).float().mean().item()
            for a, b in ((st, stp), (it, itp), (nfev, nfevp))]
    log(f"K3 vs plain f64 {what}, {x0.shape[0]} x {x0.shape[1]}, at most "
        f"{kw['max_iter']} iterations: status equal {same[0]:.5f}, "
        f"iterations equal {same[1]:.5f}, trials equal {same[2]:.5f}, "
        f"max|dx| {err:.3g} (plain vs plain with x0 moved by 1e-15 "
        f"relative: {row_spread.max().item():.3g}); "
        f"{len(by_spread)} instances past K3_X_ATOL held by their own "
        f"spread {by_spread[:8]}; trials per "
        f"iteration {nfev.sum().item() / max(1, it.sum().item()):.3f}, "
        f"converged {(st == 1).float().mean().item():.4f}")
    check(min(same if trials else same[:2]) == 1.0,
          f"K3 {what}: status, iterations or trials differ per instance")
    bad = (~held).nonzero().flatten().tolist()
    check(not bad,
          f"K3 {what}: {len(bad)} instances {bad[:8]} past both K3_X_ATOL "
          f"{K3_X_ATOL} and their own plain spread")
    return err


def medians_agree(what, r, fp, itp, it_rtol=MED_IT_RTOL, f_rtol=MED_F_RTOL,
                  kernel="K3"):
    """Full float32 solves, kernel vs plain on the same inputs."""
    mi, mip = (v.float().median().item() for v in (r.iterations, itp))
    mf, mfp = r.f.median().item(), fp.median().item()
    log(f"{what} {kernel} vs plain f32: median iterations {mi:.0f} vs "
        f"{mip:.0f}, "
        f"median f {mf:.6g} vs {mfp:.6g}; iterations equal per instance "
        f"{(r.iterations == itp).float().mean().item():.4f}")
    check(abs(mi - mip) <= it_rtol * mip,
          f"{what}: median iterations {mi} vs plain {mip}")
    check(abs(mf - mfp) <= f_rtol * abs(mfp),
          f"{what}: median f {mf} vs plain {mfp}")


def report(what, r, seconds=None):
    conv = (r.status == 1).float().mean().item()
    text = (f"{what}: converged {conv:.4f}, median f "
            f"{r.f.median().item():.6g}, median iterations "
            f"{r.iterations.float().median().item():.0f} (max "
            f"{r.iterations.max().item()})")
    if seconds is not None:
        text += f", {seconds:.3f} s"
    log(text)
    return conv


def k3_main_path(what, solve, x, B, n, sync_time):
    """Drive ``solve(x)`` with every count at 0; K3 alone must launch."""
    import torch

    from optimization_solvers_tpu_torch.ops import (fused_driver,
                                                    fused_lbfgsb,
                                                    fused_lbfgsb_tall)

    K1 = fused_lbfgsb.lbfgsb_solve_fused
    K2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    K3 = fused_driver.fused_minimize
    K1.launches = K2.launches = K3.launches = 0
    K3.placements = {"shared": 0, "workspace": 0}
    r, wall = sync_time(lambda: solve(x))
    counts = (K1.launches, K2.launches, K3.launches)
    log(f"{what}: K3 launches {counts[2]} (dense form by placement "
        f"{K3.placements}), K1 {counts[0]}, K2 {counts[1]}")
    check(counts[2] >= 1 and counts[:2] == (0, 0),
          f"{what}: launches {counts}, not K3 alone")
    check(r.x.shape == (B, n) and r.f.shape == (B,), f"{what}: shapes")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.f).all()),
          f"{what}: non-finite result")
    return r, wall, counts[2]


def driver_slice(dev, card, tensors, sync_time):
    """Phases 9-12: the driver kernel K3's first-order form against its
    plain version on every first-order geometry, config 3 (both policies)
    and config 6 through ``minimize``, the times and the bound.  Returns a
    dict of the numbers K3's entry of the ``kernels`` line takes."""
    import torch

    from _torch_geometries import k3_geometries
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.ops import fused_driver

    plain = fused_driver.fused_minimize_plain

    # ---- 9. K3 vs plain on the card, float64, every first-order geometry
    geom_err = max(k3_against_plain(name, g, tensors)
                   for name, g in k3_geometries().items())

    def timed(what, solve, run_plain, B, n, lo_hi, seed):
        """Median of 3 calls on distinct seeded inputs, kernel (through
        minimize) and plain in turns."""
        rng = np.random.RandomState(seed)
        kernel_s, plain_s = [], []
        for _ in range(3):
            (x,) = tensors(rng.uniform(*lo_hi, (B, n)), dtype=torch.float32)
            kernel_s.append(sync_time(lambda: solve(x))[1])
            plain_s.append(sync_time(lambda: run_plain(x))[1])
        for who, ts in (("K3 via minimize", kernel_s), ("K3 plain", plain_s)):
            sps = [B / t for t in ts]
            log(f"{what} {who}: solves/s median {statistics.median(sps):.1f}, "
                f"min {min(sps):.1f}, max {max(sps):.1f}; "
                f"{1e3 * statistics.median(ts):.2f} ms per call  [{card}]")
        return 1e3 * statistics.median(kernel_s), 1e3 * statistics.median(
            plain_s)

    c, c6 = CONFIG3, CONFIG6
    B, n = c["B"], c["n"]
    B6, n6 = c6["B"], c6["n"]
    obj3 = problems.weighted_squares()
    data3 = tensors(np.logspace(0, 3, n), np.zeros(n), dtype=torch.float32)
    lo3 = torch.full((n,), -c["box"], device=dev)
    up3 = torch.full((n,), c["box"], device=dev)
    starts3 = np.random.RandomState(3).uniform(-2.0, 2.0, (B, n))
    (x3,) = tensors(starts3, dtype=torch.float32)
    kw3 = dict(max_iter=c["max_iter"], max_iter_ls=c["max_iter_ls"])
    obj6 = problems.diag_quadratic(np.linspace(1.0, 100.0, n6))
    starts6 = np.random.RandomState(0).uniform(-5.0, 5.0, (B6, n6))
    (x6,) = tensors(starts6, dtype=torch.float32)
    kw6 = dict(max_iter=c6["max_iter"], max_iter_ls=c6["max_iter_ls"])

    def spg(policy):
        # the configs minimize builds for method="spg" under each policy
        return solvers.SpectralProjectedGradient(
            grad_tol=c["tol"],
            bb_variant="alternate" if policy == "fast" else "bb1")

    # ---- 10. K3 vs plain per instance at the main path's shapes, float64
    max_abs_err = 0.0
    x3d, lo3d, up3d, *data3d = tensors(
        starts3, np.full(n, -c["box"]), np.full(n, c["box"]),
        np.logspace(0, 3, n), np.zeros(n))
    for policy in ("fast", "reference"):
        max_abs_err = max(max_abs_err, k3_per_instance(
            f"config 3 ({policy})", spg(policy), ls.GLLQuadratic(), obj3,
            x3d, lo3d, up3d, tuple(data3d),
            dict(kw3, max_iter=K3_CAPPED_ITERS), tensors))
    (x6d,) = tensors(starts6)
    max_abs_err = max(max_abs_err, k3_per_instance(
        "config 6", solvers.GradientDescent(grad_tol=c6["tol"]),
        ls.BackTracking(), obj6, x6d, None, None, (), kw6, tensors))
    log(f"K3 first-order form max|dx| vs plain: {max_abs_err:.3g} at the "
        f"main path's shapes, {geom_err:.3g} on the geometries")

    # ---- 11. config 3 through minimize, both policies

    def solve3(x, policy="fast"):
        return minimize(obj3, x, method="spg", bounds=(-c["box"], c["box"]),
                        data=data3, tol=c["tol"], policy=policy, **kw3)

    def plain3(x, policy="fast"):
        return plain(spg(policy), ls.GLLQuadratic(), obj3, x, lo3, up3,
                     data3, **kw3)

    results = {}
    for policy in ("fast", "reference"):
        res, wall, launches3 = k3_main_path(
            f"config 3 ({policy}) via minimize", lambda x: solve3(x, policy),
            x3, B, n, sync_time)
        conv = report(f"config 3 ({policy}) K3", res, wall)
        (_, fp, itp, stp, _), plain_wall = sync_time(
            lambda: plain3(x3, policy))
        cp = (stp == 1).float().mean().item()
        log(f"config 3 ({policy}) plain on the card: converged {cp:.4f}, "
            f"median f {fp.median().item():.6g}, median iterations "
            f"{itp.float().median().item():.0f}, {plain_wall:.3f} s")
        check(abs(conv - cp) <= CONV_ATOL,
              f"config 3 ({policy}): converged {conv} vs plain {cp}")
        medians_agree(f"config 3 ({policy})", res, fp, itp)
        results[policy] = (res, launches3)
    res3, launches = results["fast"]
    conv3 = (res3.status == 1).float().mean().item()
    check(conv3 >= 0.99, f"config 3 (fast) converged fraction {conv3} < 0.99")
    ms, plain_ms = timed("config 3 (fast)", solve3, plain3, B, n,
                         (-2.0, 2.0), 33)

    # bound at config 3, from the kernel's own counts on the main path's
    # inputs: x0, d, t and the bounds read once, x, f, iterations, status
    # and trial counts written once; the least work the function needs
    # (SPG + GLL): per iteration the direction clip(x - lam g) - x 5n, g.d
    # 2n, the step's clip 2n and gradient 2n (its point and value are the
    # accepted trial's), the BB sums 8n and the masked convergence test 6n,
    # and per trial the trial point and its value 6n (an earlier count,
    # 29n per iteration, took the step's point and value again)
    spec = fused_driver.build_spec(spg("fast"), ls.GLLQuadratic())
    _, _, itk, _, nfevk = fused_driver._launch_cuda(
        spec, obj3, x3, lo3, up3, data3, **kw3)
    bound_ms, bound_by = bound(
        2 * B * n * 4 + 4 * n * 4 + 4 * B * 4,
        n * (25 * itk.double().sum().item() + 6 * nfevk.double().sum().item()
             + 10 * B))
    log(f"K3 bound at config 3 (fast): {bound_ms:.4f} ms ({bound_by}); "
        f"trials per iteration {nfevk.sum().item() / itk.sum().item():.3f}; "
        f"kernel {ms:.2f} ms  [{card}]")

    # ---- 12. config 6 through minimize
    def solve6(x):
        return minimize(obj6, x, method="gd", tol=c6["tol"],
                        max_iter=c6["max_iter"])

    def plain6(x):
        return plain(solvers.GradientDescent(grad_tol=c6["tol"]),
                     ls.BackTracking(), obj6, x, **kw6)

    res6, wall6, launches6 = k3_main_path("config 6 via minimize", solve6,
                                          x6, B6, n6, sync_time)
    conv6 = report("config 6 K3", res6, wall6)
    (_, fp6, itp6, stp6, _), plain_wall6 = sync_time(lambda: plain6(x6))
    cp6 = (stp6 == 1).float().mean().item()
    log(f"config 6 plain on the card: converged {cp6:.4f}, median f "
        f"{fp6.median().item():.6g}, median iterations "
        f"{itp6.float().median().item():.0f}, {plain_wall6:.3f} s")
    check(conv6 >= 0.99, f"config 6 converged fraction {conv6} < 0.99")
    check(abs(conv6 - cp6) <= CONV_ATOL,
          f"config 6: converged {conv6} vs plain {cp6}")
    medians_agree("config 6", res6, fp6, itp6)
    ms6, plain_ms6 = timed("config 6", solve6, plain6, B6, n6, (-5.0, 5.0),
                           66)
    spec6 = fused_driver.build_spec(
        solvers.GradientDescent(grad_tol=c6["tol"]), ls.BackTracking())
    _, _, itk6, _, nfevk6 = fused_driver._launch_cuda(
        spec6, obj6, x6, None, None, (), **kw6)
    # the least work (GD + BackTracking): per iteration the direction n,
    # g.d 2n, the step's gradient 2n (its point and value are the accepted
    # trial's) and the convergence test 2n; per trial the trial point and
    # its value 6n (an earlier count, 11n per iteration, took the step's
    # point and value again)
    b6, by6 = bound(
        2 * B6 * n6 * 4 + 2 * n6 * 4 + 4 * B6 * 4,
        n6 * (7 * itk6.double().sum().item()
              + 6 * nfevk6.double().sum().item() + 4 * B6))
    log(f"K3 bound at config 6: {b6:.4f} ms ({by6}); trials per iteration "
        f"{nfevk6.sum().item() / itk6.sum().item():.3f}; kernel {ms6:.2f} ms"
        f"  [{card}]")
    return {
        "max_abs_err": max_abs_err,
        "config 3 (fast)": dict(launches=launches, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by),
        "config 6": dict(launches=launches6, ms=ms6, plain_ms=plain_ms6,
                         bound_ms=b6, bound_by=by6),
    }


def qn_slice(dev, card, tensors, sync_time):
    """Phases 13-16: K3's quasi-Newton and dense forms against their plain
    version on every quasi-Newton geometry and per instance at config 2's shape, then
    config 2 (dense BFGS + More-Thuente, through ``batch_minimize`` as the
    bench calls it and through ``minimize`` in both policies) and L-BFGS +
    Hager-Zhang at the same shape, with times and bounds.  Returns a dict
    of the numbers K3's entry of the ``kernels`` line takes."""
    import torch

    from _torch_geometries import k3_qn_geometries
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import fused_driver

    plain = fused_driver.fused_minimize_plain

    # ---- 13. K3 vs plain on the card, float64, every quasi-Newton geometry
    geom_err = max(k3_against_plain(name, g, tensors)
                   for name, g in k3_qn_geometries().items())

    # every quasi-Newton row of minimize, with its default search and each
    # Wolfe search, launches K3 once per call (64 x 12 weighted squares)
    d12, t12 = tensors(np.linspace(1.0, 20.0, 12), np.linspace(-0.8, 0.8, 12))
    (x12,) = tensors(np.random.RandomState(1).uniform(-1, 1, (64, 12)))
    free = [None, ls.MoreThuente(), ls.HagerZhang(), ls.StrongWolfe()]
    boxed = [ls.MoreThuenteB(), ls.HagerZhangB(),
             ls.StrongWolfe(bounded=True)]
    K3 = fused_driver.fused_minimize
    calls = 0
    for method in ("bfgs", "dfp", "broyden", "lbfgs", "bfgsb", "dfpb",
                   "broydenb", "sr1b"):
        bounded = method.endswith("b")
        for search in free + (boxed if bounded else []):
            before = K3.launches
            r = minimize(problems.weighted_squares(), x12, method=method,
                         data=(d12, t12), search=search, tol=1e-6,
                         bounds=(-1.0, 1.0) if bounded else None,
                         max_iter=500)
            torch.cuda.synchronize()
            check(K3.launches == before + 1 and r.x.device == x12.device,
                  f"minimize({method!r}, search={search}) did not launch K3")
            check(bool(torch.isin(r.status, torch.tensor(
                [1, 6], device=dev)).all()),
                f"minimize({method!r}, search={search}): not all success")
            calls += 1
    log(f"K3 routes: {calls} quasi-Newton minimize calls (8 rows x their "
        f"default and Wolfe searches), each launched K3 once; all success")

    c = CONFIG2
    B, n = c["B"], c["n"]
    rosen = problems.rosenbrock()
    kw = dict(max_iter=c["max_iter"], max_iter_ls=c["max_iter_ls"])
    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (B, n))

    def bfgs():
        # config 2's method, as bench.py builds it
        return solvers.QuasiNewton(tol=c["tol"], update="bfgs", scale_b0=True,
                                   restart_on_degeneracy=True)

    lbfgs = solvers.LBFGS(tol=LBFGS_RUN["tol"])
    cases = {
        "config 2 (bench: MoreThuente)": (bfgs(), ls.MoreThuente()),
        "config 2 (fast: MoreThuente approx_wolfe)": (
            bfgs(), ls.MoreThuente(approx_wolfe=True)),
        "L-BFGS + HagerZhang": (lbfgs, ls.HagerZhang()),
    }

    # ---- 14. K3 vs plain per instance at config 2's shape, float64, over
    # the first K3_CAPPED_ITERS iterations (full Rosenbrock solves are
    # chaotic per instance)
    (xd,) = tensors(starts)
    max_abs_err = max(
        k3_per_instance(what, method, search, rosen, xd, None, None, (),
                        dict(kw, max_iter=K3_CAPPED_ITERS), tensors)
        for what, (method, search) in cases.items())
    log(f"K3 quasi-Newton form max|dx| vs plain: {max_abs_err:.3g} at config "
        f"2's shape, {geom_err:.3g} on the geometries")

    # ---- 15. config 2 in float32, full solves
    (x,) = tensors(starts, dtype=torch.float32)

    def success(r):
        return torch.isin(r.status, torch.tensor([1, 6], device=dev))

    def stationary(f):
        # bench.py:387-388: the global minimum or the local one near x0 = -1
        return ((f < 1e-6) | ((f - 3.9866).abs() < 1e-2)).float().mean().item()

    def describe(what, r, trials, seconds):
        conv = (r.status == 1).float().mean().item()
        stalled = (r.status == 6).float().mean().item()
        succ = success(r).float().mean().item()
        stat = stationary(r.f)
        log(f"{what}: converged {conv:.4f}, STALLED {stalled:.4f}, success "
            f"class {succ:.4f}, stationary {stat:.4f}, median f "
            f"{r.f.median().item():.6g}, median iterations "
            f"{r.iterations.float().median().item():.0f} (max "
            f"{r.iterations.max().item()}), trials per iteration "
            f"{trials.sum().item() / max(1, r.iterations.sum().item()):.3f},"
            f" {seconds:.3f} s  [{card}]")
        return succ, stat

    def kernel_trials(method, search, xs):
        spec = fused_driver.build_spec(method, search)
        return fused_driver._launch_cuda(spec, rosen, xs, None, None, (),
                                         **kw)[4]

    def against_plain(what, r, method, search, xs, run_kw=kw):
        """The plain version on the same inputs, with the epilogue; the
        success-class (or converged) fractions within 0.01, medians as
        C2_MED_IT_RTOL and C2_MED_F_RTOL.  Returns the plain wall time."""
        (xp, fp, itp, stp, nfevp), wall = sync_time(
            lambda: plain(method, search, rosen, xs, **run_kw))
        rp = fused_driver.epilogue(method, rosen, (), xp, fp, itp, stp)
        describe(f"{what} plain on the card", rp, nfevp, wall)
        sk, sp = success(r).float().mean().item(), success(rp).float().mean(
            ).item()
        check(abs(sk - sp) <= CONV_ATOL,
              f"{what}: success class {sk} vs plain {sp}")
        medians_agree(what, r, fp, itp, C2_MED_IT_RTOL, C2_MED_F_RTOL)
        return wall

    def bench(xs):
        return solvers.batch_minimize(bfgs(), ls.MoreThuente(),
                                      make_oracle(rosen), xs, **kw)

    def front(xs, policy):
        return minimize(rosen, xs, method="bfgs", tol=c["tol"], scale_b0=True,
                        restart_on_degeneracy=True, policy=policy, **kw)

    r, wall, launches = k3_main_path("config 2 via batch_minimize", bench, x,
                                     B, n, sync_time)
    placements = dict(K3.placements)
    check(placements == {"shared": launches, "workspace": 0},
          f"config 2: the dense form's placements {placements}; its slabs "
          "must lie in shared memory at this shape")
    trials = kernel_trials(bfgs(), ls.MoreThuente(), x)
    succ, stat = describe("config 2 (bench) K3", r, trials, wall)
    check(succ >= C2_SUCCESS, f"config 2: success class {succ} < "
          f"{C2_SUCCESS}")
    check(stat >= C2_STATIONARY, f"config 2: stationary {stat} < "
          f"{C2_STATIONARY}")
    plain_s = against_plain("config 2 (bench)", r, bfgs(), ls.MoreThuente(),
                            x)
    for policy, search in (("fast", ls.MoreThuente(approx_wolfe=True)),
                           ("reference", ls.MoreThuente())):
        rp, wallp, _ = k3_main_path(
            f"config 2 ({policy}) via minimize", lambda xs: front(xs, policy),
            x, B, n, sync_time)
        describe(f"config 2 ({policy}) K3", rp,
                 kernel_trials(bfgs(), search, x), wallp)
        if policy == "fast":
            against_plain("config 2 (fast)", rp, bfgs(), search, x)
        else:
            check(torch.equal(rp.x, r.x) and torch.equal(rp.status, r.status),
                  "config 2: the reference policy is not the bench call")
    rng = np.random.RandomState(22)
    walls = []
    for _ in range(3):
        (xs,) = tensors(rng.uniform(-2.0, 2.0, (B, n)), dtype=torch.float32)
        walls.append(sync_time(lambda: bench(xs))[1])
    ms = 1e3 * statistics.median(walls)
    log(f"config 2 (bench) K3 via batch_minimize: {ms:.2f} ms per call "
        f"(median of 3, distinct inputs; min {1e3 * min(walls):.2f}, max "
        f"{1e3 * max(walls):.2f}), {B / (ms / 1e3):.0f} solves/s; plain "
        f"{1e3 * plain_s:.0f} ms for one call  [{card}]")

    # bound at config 2, from this run's counts: x0 read and x, f,
    # iterations, status and trial counts written once (the slabs are the
    # kernel's scratch); per iteration of dense BFGS (csrc/driver.cuh) the
    # direction B g 2n^2, B y 2n^2 and the rank-2 update of the slab 6n^2,
    # plus the step and the value-and-gradient at the new point (Rosenbrock
    # 15n) and the s, y sums 8n; per More-Thuente trial the trial point 2n,
    # the value-and-gradient 15n and g.d 2n.  The slab passes dominate:
    # operations bound it.
    its, nf = r.iterations.double().sum().item(), trials.double().sum().item()
    bound_ms, bound_by = bound(2 * B * n * 4 + 4 * B * 4,
                               its * (10 * n * n + 25 * n) + nf * 19 * n)
    log(f"K3 bound at config 2: {bound_ms:.4f} ms ({bound_by}); kernel "
        f"{ms:.2f} ms  [{card}]")
    # the slab's passes at this run's counts: each iteration a direction
    # pass, B y and the update (the dense form runs all three unless a
    # pending reset or scale_b0 replaces B y): the earlier design's stream
    # through device memory, this design's shared-memory floor
    mhz = sm_clock_mhz()
    stream = dense_slab_stream_bytes(n, 4, its, its, its)
    floor = dense_smem_floor_ms(n, 4, its, its, its, mhz)
    log(f"config 2 slab passes: the earlier design streamed {stream / 1e9:.3f}"
        f" GB through device memory ({1e3 * stream / HBM_BYTES_PER_S:.3f} ms"
        f" at 3.35 TB/s); this design's shared-memory floor {floor:.4f} ms "
        f"(132 SMs x 128 B per clock at {mhz:.0f} MHz)  [{card}]")

    # ---- 16. L-BFGS + Hager-Zhang at the same shape, float32
    def solve_l(xs):
        return minimize(rosen, xs, method="lbfgs", tol=LBFGS_RUN["tol"],
                        max_iter=LBFGS_RUN["max_iter"])

    kw_l = dict(max_iter=LBFGS_RUN["max_iter"], max_iter_ls=40)
    rl, wall_l, launches_l = k3_main_path("L-BFGS + HagerZhang via minimize",
                                          solve_l, x, B, n, sync_time)
    spec_l = fused_driver.build_spec(lbfgs, ls.HagerZhang())
    trials_l = fused_driver._launch_cuda(spec_l, rosen, x, None, None, (),
                                         **kw_l)[4]
    describe("L-BFGS + HagerZhang K3", rl, trials_l, wall_l)
    its_k = rl.iterations.double()
    log(f"L-BFGS + HagerZhang K3: trials per iteration "
        f"{trials_l.double().sum().item() / its_k.sum().item():.4f}; "
        f"iterations over the instances median / p99 / max "
        f"{its_k.median().item():.0f} / "
        f"{torch.quantile(its_k, 0.99).item():.1f} / "
        f"{int(its_k.max().item())} (the slowest instance's chain sets the "
        f"time of a batch that runs in one wave)")
    (xp, fp, itp, stp, nfevp), plain_l = sync_time(
        lambda: plain(lbfgs, ls.HagerZhang(), rosen, x, **kw_l))
    describe("L-BFGS + HagerZhang plain on the card",
             fused_driver.epilogue(lbfgs, rosen, (), xp, fp, itp, stp), nfevp,
             plain_l)
    ck, cp = ((s == 1).float().mean().item() for s in (rl.status, stp))
    check(abs(ck - cp) <= CONV_ATOL,
          f"L-BFGS + HagerZhang: converged {ck} vs plain {cp}")
    medians_agree("L-BFGS + HagerZhang", rl, fp, itp, C2_MED_IT_RTOL,
                  C2_MED_F_RTOL)
    walls = []
    for _ in range(3):
        (xs,) = tensors(rng.uniform(-2.0, 2.0, (B, n)), dtype=torch.float32)
        walls.append(sync_time(lambda: solve_l(xs))[1])
    ms_l = 1e3 * statistics.median(walls)
    # per iteration of L-BFGS (m = 10): H g 8mn (the two loops, or the
    # compact form's two passes and its step sums), the history update 4n,
    # the step, the value-and-gradient 15n and the sums 8n; per
    # Hager-Zhang trial 19n, as above
    m = lbfgs.m
    its_l = rl.iterations.double().sum().item()
    b_l, by_l = bound(2 * B * n * 4 + 4 * B * 4,
                      its_l * (8 * m * n + 27 * n)
                      + trials_l.double().sum().item() * 19 * n)
    log(f"L-BFGS + HagerZhang K3 via minimize: {ms_l:.2f} ms per call "
        f"(median of 3, distinct inputs), plain {1e3 * plain_l:.0f} ms for "
        f"one call; bound {b_l:.4f} ms ({by_l})  [{card}]")
    return {
        "max_abs_err": max_abs_err,
        "config 2": dict(launches=launches, ms=ms, plain_ms=1e3 * plain_s,
                         bound_ms=bound_ms, bound_by=bound_by,
                         placements=placements),
        "L-BFGS + HagerZhang": dict(launches=launches_l, ms=ms_l,
                                    plain_ms=1e3 * plain_l, bound_ms=b_l,
                                    bound_by=by_l),
    }


def in_turns_times(root):
    """Config 2 through ``solvers.batch_minimize`` (the bench call), K9
    through ``ops.bfgs_solve_fused`` (config 2's inputs), L-BFGS +
    Hager-Zhang through ``minimize``, K7, K8 and K4 (also at
    K1_TIMES_SMALL_B) through their entries,
    K5 (bfgs) at its path's shape and K6 on config 5's Hessians, the
    headline (at B = 10,240 and
    K1_TIMES_SMALL_B), configs 3 (fast), 6 and 4 (also at each B of
    C4_SMALL_B) through ``minimize``, and config 5 (PN, B = 256) through
    ``solvers.batch_minimize`` by K3 and by the lockstep K6 path in turns
    (the order alternating), built and imported from the
    checkout at ``root``: median and spread of TIMES_REPEATS calls on
    distinct seeded inputs, after one warm-up call; for config 2, K9,
    L-BFGS, the headline and configs 3 and 6 also the kernel's device time
    alone (CUDA events around the wrapper's launch)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import optimization_solvers_tpu_torch as ostt
    from _torch_geometries import config5_hessian
    from optimization_solvers_tpu_torch import linesearch as ls, solvers
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import (_build, fused_bfgs,
                                                    fused_driver, fused_lbfgs,
                                                    fused_lbfgsb, fused_newton,
                                                    fused_spg, linalg)

    card = card_line()
    t0 = time.perf_counter()
    _build.load()
    log(f"package {os.path.dirname(ostt.__file__)}; build or load "
        f"{time.perf_counter() - t0:.1f} s")
    c, c6 = CONFIG3, CONFIG6
    dev = torch.device("cuda")
    data3 = tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in
                  (np.logspace(0, 3, c["n"]), np.zeros(c["n"])))
    obj6 = ostt.problems.diag_quadratic(np.linspace(1.0, 100.0, c6["n"]))

    def solve3(x):
        return ostt.minimize(ostt.problems.weighted_squares(), x,
                             method="spg", bounds=(-c["box"], c["box"]),
                             data=data3, tol=c["tol"], max_iter=c["max_iter"],
                             max_iter_ls=c["max_iter_ls"])

    def solve6(x):
        return ostt.minimize(obj6, x, method="gd", tol=c6["tol"],
                             max_iter=c6["max_iter"])

    def launch3(x):
        spec = fused_driver.build_spec(solvers.SpectralProjectedGradient(
            grad_tol=c["tol"], bb_variant="alternate"), ls.GLLQuadratic())
        box = torch.full((c["n"],), c["box"], device=dev)
        return fused_driver._launch_cuda(
            spec, ostt.problems.weighted_squares(), x, -box, box, data3,
            c["max_iter"], c["max_iter_ls"])

    def launch6(x):
        spec = fused_driver.build_spec(
            solvers.GradientDescent(grad_tol=c6["tol"]), ls.BackTracking())
        return fused_driver._launch_cuda(spec, obj6, x, None, None, (),
                                         c6["max_iter"], c6["max_iter_ls"])

    def wall_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    def spread(ts):
        return (f"{statistics.median(ts):.3f} ms per call (median of "
                f"{len(ts)}; min {min(ts):.3f}, max {max(ts):.3f})")

    rosen = ostt.problems.rosenbrock()
    hkw = dict(m=HEADLINE["m"], factr=HEADLINE["factr"],
               max_iter=HEADLINE["max_iter"])
    hbox = torch.full((HEADLINE["n"],), BOX, device=dev)

    def solve1(x):
        return ostt.minimize(rosen, x, method="lbfgsb", bounds=(-BOX, BOX),
                             tol=HEADLINE["pgtol"], **hkw)

    def launch1(x):
        return fused_lbfgsb.lbfgsb_solve_fused(
            rosen, x, -hbox, hbox, pgtol=HEADLINE["pgtol"], **hkw)

    # config 2 (the bench call), L-BFGS + Hager-Zhang at its shape, and K9
    c2 = CONFIG2
    spec2 = fused_driver.build_spec(
        solvers.QuasiNewton(tol=c2["tol"], update="bfgs", scale_b0=True,
                            restart_on_degeneracy=True), ls.MoreThuente())
    lbfgs = solvers.LBFGS(tol=LBFGS_RUN["tol"])
    spec_l = fused_driver.build_spec(lbfgs, ls.HagerZhang())
    k9kw = {k: WHOLE_K9[k] for k in ("tol", "max_iter", "max_iter_ls")}

    def solve2(x):
        return solvers.batch_minimize(
            solvers.QuasiNewton(tol=c2["tol"], update="bfgs", scale_b0=True,
                                restart_on_degeneracy=True),
            ls.MoreThuente(), make_oracle(rosen), x,
            max_iter=c2["max_iter"], max_iter_ls=c2["max_iter_ls"])

    def launch2(x):
        return fused_driver._launch_cuda(spec2, rosen, x, None, None, (),
                                         c2["max_iter"], c2["max_iter_ls"])

    def solve_l(x):
        return ostt.minimize(rosen, x, method="lbfgs", tol=LBFGS_RUN["tol"],
                             max_iter=LBFGS_RUN["max_iter"])

    def launch_l(x):
        return fused_driver._launch_cuda(spec_l, rosen, x, None, None, (),
                                         LBFGS_RUN["max_iter"], 40)

    def solve9(x):
        return fused_bfgs.bfgs_solve_fused(rosen, x, c1=1e-4, **k9kw)

    def launch9(x):
        return fused_bfgs._launch_cuda(rosen, x, (), c1=1e-4, **k9kw)

    # K7, K8 and K4 through their entries, on the inputs of phases 30-31
    # and 24 (the entry is timed twice: the wrapper is the call)
    box3 = torch.full((c["n"],), c["box"], device=dev)

    def solve_k7(x):
        return fused_lbfgs.lbfgs_solve_fused(
            rosen, x, m=WHOLE_K7["m"], tol=WHOLE_K7["tol"],
            max_iter=WHOLE_K7["max_iter"],
            max_iter_ls=WHOLE_K7["max_iter_ls"], c1=1e-4)

    def solve_k8(x):
        return fused_spg.spg_solve_fused(
            ostt.problems.weighted_squares(), x, -box3, box3, data3,
            tol=WHOLE_K8["tol"], max_iter=WHOLE_K8["max_iter"],
            max_iter_ls=WHOLE_K8["max_iter_ls"], lam_min=1e-3, lam_max=1e3,
            gll_m=10, c1=1e-4)

    def solve_k4(x):
        return ostt.minimize(rosen, x, method="newton_cg", bounds=(-BOX, BOX),
                             tol=HEADLINE["pgtol"],
                             max_iter=HEADLINE["max_iter"],
                             cg_max=NEWTON_CG_MAX)

    for what, solve, launch, B, n, half, seed in (
            ("config 2 (bench: batch_minimize)", solve2, launch2, c2["B"],
             c2["n"], 2.0, 22),
            ("K9 (ops.bfgs_solve_fused)", solve9, launch9, WHOLE_K9["B"],
             WHOLE_K9["n"], 2.0, 29),
            ("L-BFGS + HagerZhang", solve_l, launch_l, c2["B"], c2["n"], 2.0,
             23),
            ("K7 (ops.lbfgs_solve_fused)", solve_k7, solve_k7,
             WHOLE_K7["B"], WHOLE_K7["n"], 2.0, 17),
            ("K8 (ops.spg_solve_fused)", solve_k8, solve_k8, WHOLE_K8["B"],
             WHOLE_K8["n"], 2.0, 18),
            ("K4 (the Newton-CG headline)", solve_k4, solve_k4,
             HEADLINE["B"], HEADLINE["n"], 2.0, 14),
            (f"K4 at B = {K1_TIMES_SMALL_B}", solve_k4, solve_k4,
             K1_TIMES_SMALL_B, HEADLINE["n"], 2.0, 15),
            ("headline", solve1, launch1, HEADLINE["B"], HEADLINE["n"], 2.0,
             11),
            (f"headline at B = {K1_TIMES_SMALL_B}", solve1, launch1,
             K1_TIMES_SMALL_B, HEADLINE["n"], 2.0, 12),
            ("config 3 (fast)", solve3, launch3, c["B"], c["n"], 2.0, 33),
            ("config 6", solve6, launch6, c6["B"], c6["n"], 5.0, 66)):
        rng = np.random.RandomState(seed)
        xs = [torch.tensor(rng.uniform(-half, half, (B, n)),
                           dtype=torch.float32, device=dev)
              for _ in range(TIMES_REPEATS + 1)]
        solve(xs[0])
        ts = [wall_ms(partial(solve, x)) for x in xs[1:]]
        dev_ms = []
        for x in xs[1:]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(x)
            stop.record()
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(stop))
        log(f"{what}: {spread(ts)}; the kernel's wrapper alone "
            f"{statistics.median(dev_ms):.3f} ms (min {min(dev_ms):.3f}, max "
            f"{max(dev_ms):.3f})  [{card}]")

    # K5 (bfgs) at its path's shape: CUDA events around 50 launches, each
    # of TIMES_REPEATS rounds
    from _torch_geometries import qn_update_arrays
    from optimization_solvers_tpu_torch.ops import fused_qn

    c5q = LOCKSTEP_QN
    Bm, s, y, g = (torch.tensor(a, dtype=torch.float32, device=dev)
                   for a in qn_update_arrays(c5q["B"], c5q["n"],
                                             curvature=True))
    k5_us = [1e3 * event_ms(lambda: fused_qn.qn_update_direction_fused(
        Bm, s, y, g, tol=1e-8, kind="bfgs"), 50)
        for _ in range(TIMES_REPEATS)]
    log(f"K5 bfgs ({LOCKSTEP_QN['B']}, {LOCKSTEP_QN['n']}, "
        f"{LOCKSTEP_QN['n']}) float32: {statistics.median(k5_us):.2f} us per "
        f"launch (median of {TIMES_REPEATS} rounds of 50; min "
        f"{min(k5_us):.2f}, max {max(k5_us):.2f})  [{card}]")
    del Bm, s, y, g

    # config 4 through minimize: K2 of the package at root
    from _torch_geometries import lse_arrays

    c4 = CONFIG4
    lse = ostt.problems.log_sum_exp(*(
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in lse_arrays(c4["n"], c4["rows"])))

    def solve4(x):
        return ostt.minimize(lse, x, method="lbfgsb",
                             bounds=(-C4_BOX, C4_BOX), m=c4["m"],
                             tol=c4["pgtol"], factr=c4["factr"],
                             max_iter=c4["max_iter"])

    rng = np.random.RandomState(44)
    xs = [torch.tensor(rng.uniform(-0.5, 0.5, (c4["B"], c4["n"])),
                       dtype=torch.float32, device=dev)
          for _ in range(TIMES_REPEATS + 1)]
    for B4 in (c4["B"],) + C4_SMALL_B:
        solve4(xs[0][:B4])
        ts = [wall_ms(partial(solve4, x[:B4])) for x in xs[1:]]
        what = "config 4" if B4 == c4["B"] else f"config 4 at B = {B4}"
        log(f"{what}: {spread(ts)}  [{card}]")
    del xs

    c5 = CONFIG5
    n5, B5 = c5["n"], c5["B"]
    Q = torch.tensor(config5_hessian(n5), dtype=torch.float32, device=dev)
    box = torch.full((n5,), c5["box"], device=dev)
    kw5 = dict(max_iter=c5["max_iter"], max_iter_ls=c5["max_iter_ls"])
    pn = solvers.ProjectedNewton(grad_tol=c5["tol"])
    q5 = make_oracle(ostt.problems.quadratic(Q))
    quad = make_oracle(ostt.problems.quadratic(Q), with_hessian=True)

    def k3_path(x):
        return solvers.batch_minimize(pn, ls.BackTrackingB(), q5, x,
                                      bounds=(-box, box), **kw5)

    def k6_path(x):
        return solvers.batch_minimize(pn, ls.BackTrackingB(), quad, x,
                                      bounds=(-box, box), fused=False, **kw5)

    rng = np.random.RandomState(55)
    xs = [torch.tensor(rng.uniform(-2.0, 2.0, (B5, n5)), dtype=torch.float32,
                       device=dev) for _ in range(TIMES_REPEATS + 1)]
    use_kernel = linalg.config.use_kernel
    linalg.config.use_kernel = True
    try:
        k3_path(xs[0])
        k6_path(xs[0])
        k3_ts, k6_ts = [], []
        for turn, x in enumerate(xs[1:]):
            pair = ((k3_ts, k3_path), (k6_ts, k6_path))
            for out, path in pair[::1 if turn % 2 == 0 else -1]:
                out.append(wall_ms(partial(path, x)))
    finally:
        linalg.config.use_kernel = use_kernel
    ahead = sum(a < b for a, b in zip(k3_ts, k6_ts))
    log(f"config 5 (B = {B5}) K3: {spread(k3_ts)}; the lockstep K6 path in "
        f"turns: {spread(k6_ts)}; K3 ahead in {ahead} of {len(k3_ts)}  "
        f"[{card}]")
    # K6 alone on config 5's Hessians (CUDA events around each launch)
    del xs
    Hb = Q.expand(B5, n5, n5).contiguous()
    gb = torch.ones((B5, n5), device=dev)
    fused_newton.cholesky_solve_fused(Hb, gb)
    k6_ms = []
    for _ in range(TIMES_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_newton.cholesky_solve_fused(Hb, gb)
        stop.record()
        torch.cuda.synchronize()
        k6_ms.append(start.elapsed_time(stop))
    log(f"K6 ({B5}, {n5}, {n5}) float32: {spread(k6_ms)}  [{card}]")
    return 0


def driver_breakdown(dev, card, tensors, sync_time):
    """Phase 25, with ``--breakdown`` only: where K3's time goes at configs
    3, 6, 2 and 5: the device time by kernel in one profiled solve, a batch
    sweep and an iteration cap; at config 5 also K6 on the same batch's
    Hessians, the blocked factorization K3's Newton form runs, beside the
    Newton iteration.  Only printed; nothing here is held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from _torch_geometries import config5_hessian
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle

    c, c6, c2, c5 = CONFIG3, CONFIG6, CONFIG2, CONFIG5
    obj3 = problems.weighted_squares()
    data3 = tensors(np.logspace(0, 3, c["n"]), np.zeros(c["n"]),
                    dtype=torch.float32)
    obj6 = problems.diag_quadratic(np.linspace(1.0, 100.0, c6["n"]))
    rosen = problems.rosenbrock()

    def solve3(x, max_iter=c["max_iter"]):
        return minimize(obj3, x, method="spg", bounds=(-c["box"], c["box"]),
                        data=data3, tol=c["tol"], max_iter=max_iter,
                        max_iter_ls=c["max_iter_ls"])

    def solve6(x, max_iter=c6["max_iter"]):
        return minimize(obj6, x, method="gd", tol=c6["tol"],
                        max_iter=max_iter)

    def starts(B, n, half, seed):
        return tensors(np.random.RandomState(seed).uniform(-half, half,
                                                           (B, n)),
                       dtype=torch.float32)[0]

    def solve2(x, max_iter=c2["max_iter"]):
        return minimize(rosen, x, method="bfgs", tol=c2["tol"],
                        scale_b0=True, restart_on_degeneracy=True,
                        policy="reference", max_iter=max_iter,
                        max_iter_ls=c2["max_iter_ls"])

    # config 5 (PN, one Newton iteration per instance): cap 0 is the
    # first value-and-gradient, the host and the epilogue alone
    Q = problems.quadratic(tensors(config5_hessian(c5["n"]),
                                   dtype=torch.float32)[0])
    box5 = torch.full((c5["n"],), c5["box"], device=dev)

    def solve5(x, max_iter=c5["max_iter"]):
        return solvers.batch_minimize(
            solvers.ProjectedNewton(grad_tol=c5["tol"]), ls.BackTrackingB(),
            make_oracle(Q), x, bounds=(-box5, box5), max_iter=max_iter,
            max_iter_ls=c5["max_iter_ls"])

    sweep3 = (132, 1056, 2112, 4224, 8448, 10240, 20480)
    caps = (1, 10, 100, 300)
    cells = (("config 3", solve3, c["n"], 2.0, c["B"], sweep3, caps),
             ("config 6", solve6, c6["n"], 5.0, c6["B"], sweep3, caps),
             ("config 2", solve2, c2["n"], 2.0, c2["B"],
              (132, 264, 528, 1056, 2112, 4224), caps),
             ("config 5", solve5, c5["n"], c5["box"], c5["B"],
              (8, 32, 64, 128, 256, 512), (0, 1)))
    for what, solve, n, half, B, sizes, caps in cells:
        x = starts(B, n, half, 5)
        solve(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = sync_time(lambda: solve(x))
        rows = [(e.key, e.device_time_total) for e in prof.key_averages()
                if e.device_time_total > 0]
        total = sum(t for _, t in rows)
        top = sorted(rows, key=lambda r: -r[1])[:4]
        log(f"{what} profile: wall {1e3 * wall:.3f} ms, device "
            f"{total / 1e3:.3f} ms in {len(rows)} kernels; "
            + "; ".join(f"{k[:40]} {t / 1e3:.3f} ms" for k, t in top))
        sweep = []
        for b in sizes:
            xb = starts(b, n, half, 6)
            solve(xb)
            ts = [sync_time(lambda: solve(xb))[1] for _ in range(3)]
            sweep.append(f"B={b}: {1e3 * statistics.median(ts):.3f} ms")
        log(f"{what} batch sweep (median of 3): " + ", ".join(sweep)
            + f"  [{card}]")
        capped = {}
        for cap in caps:
            ts = [sync_time(lambda: solve(x, cap))[1] for _ in range(3)]
            capped[cap] = 1e3 * statistics.median(ts)
        log(f"{what} iteration cap at B={B} (median of 3): "
            + ", ".join(f"{cap}: {ms:.3f} ms" for cap, ms in capped.items())
            + f"  [{card}]")
        if what == "config 5":
            # the factorization's share of the one Newton iteration: K6 runs
            # the same blocked routine (with its transposing copy and two
            # solves) on the same batch's Hessians
            from optimization_solvers_tpu_torch.ops import fused_newton

            Hb = tensors(config5_hessian(n), dtype=torch.float32)[0].expand(
                B, n, n).contiguous()
            gb = torch.ones((B, n), device=dev)
            k6_ms = event_ms(lambda: fused_newton.cholesky_solve_fused(Hb, gb), 5)
            it_ms = capped[1] - capped[0]
            log(f"config 5: one Newton iteration (cap 1 - cap 0) {it_ms:.3f} "
                f"ms; K6 on the same ({B}, {n}, {n}) Hessians (the blocked "
                f"factorization and two solves) {k6_ms:.3f} ms, "
                f"{k6_ms / it_ms:.2f} of the iteration  [{card}]")
            del Hb
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    log(f"after the K3 runs: {out.stdout.strip()}")


def newton_slice(dev, card, tensors, sync_time):
    """Phases 19-22: K3's Newton form against its plain version on every
    Newton geometry and per instance at config 5's width in float64, then
    config 5 in float32 through ``solvers.batch_minimize`` (B = 256, the
    main path, and 64) and the ``pn``, ``spn`` and ``newton`` rows of
    ``minimize``, with times, the bound and the batched-Cholesky yardstick.
    Returns K3's Newton entry of the ``kernels`` line."""
    import torch

    from _torch_geometries import config5_hessian, k3_newton_geometries
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import fused_driver

    plain = fused_driver.fused_minimize_plain
    c = CONFIG5
    n = c["n"]

    # ---- 19. K3 vs plain on the card, float64, every Newton geometry
    geom_err = max(k3_against_plain(name, g, tensors)
                   for name, g in k3_newton_geometries().items())

    # ---- 20. per instance at config 5's width, float64: PN (the bench's
    # method), Newton, and SPN in both policies (the reference one capped)
    Q64 = config5_hessian(n)
    starts = np.random.RandomState(5).uniform(-2.0, 2.0, (c["B"], n))
    q64 = problems.quadratic(tensors(Q64)[0])
    x8, lo8, up8 = tensors(starts[:C5_F64_ROWS], np.full(n, -c["box"]),
                           np.full(n, c["box"]))
    kw = dict(max_iter=c["max_iter"], max_iter_ls=c["max_iter_ls"])
    cases = (
        ("config 5 PN", solvers.ProjectedNewton(grad_tol=c["tol"]),
         ls.BackTrackingB(), True, kw),
        ("config 5 Newton", solvers.Newton(tol=c["tol"]), ls.MoreThuente(),
         False, kw),
        ("config 5 SPN (fast)", solvers.SpectralProjectedNewton(
            grad_tol=c["tol"], precond_bb=True), ls.BackTrackingB(), True,
         kw),
        ("config 5 SPN (reference)", solvers.SpectralProjectedNewton(
            grad_tol=c["tol"]), ls.BackTrackingB(), True,
         dict(kw, max_iter=C5_SPN_REF_ITERS)))
    max_abs_err = max(
        k3_per_instance(what, method, search, q64, x8,
                        lo8 if bounded else None, up8 if bounded else None,
                        (), run_kw, tensors)
        for what, method, search, bounded, run_kw in cases)
    log(f"K3 Newton form max|dx| vs plain: {max_abs_err:.3g} at config 5's "
        f"width, {geom_err:.3g} on the geometries")

    # ---- 21. config 5 in float32, as bench.py calls it
    (Q,) = tensors(Q64, dtype=torch.float32)
    q = problems.quadratic(Q)
    box = torch.full((n,), c["box"], device=dev)
    pn = solvers.ProjectedNewton(grad_tol=c["tol"])

    def bench(xs):
        return solvers.batch_minimize(pn, ls.BackTrackingB(), make_oracle(q),
                                      xs, bounds=(-box, box), **kw)

    def plain5(xs):
        return plain(pn, ls.BackTrackingB(), q, xs, -box, box, (), **kw)

    def quality(what, r, med_iters=None):
        conv = report(what, r)
        xmax = r.x.abs().max().item()
        log(f"{what}: max|x| {xmax:.3g} (x* = 0)")
        check(conv >= 0.99, f"{what}: converged fraction {conv} < 0.99")
        check(xmax <= C5_X_ATOL, f"{what}: max|x| {xmax} > {C5_X_ATOL}")
        if med_iters is not None:
            med = r.iterations.float().median().item()
            check(med == med_iters,
                  f"{what}: median iterations {med}, not {med_iters}")
        return conv

    results = {}
    for B in (c["B"], c["B_small"]):
        (x,) = tensors(starts[:B], dtype=torch.float32)
        r, wall, launches = k3_main_path(
            f"config 5 (B = {B}) via batch_minimize", bench, x, B, n,
            sync_time)
        conv = quality(f"config 5 (B = {B}) K3", r, 1)
        (_, _, itp, stp, _), plain_wall = sync_time(lambda: plain5(x))
        cp = (stp == 1).float().mean().item()
        log(f"config 5 (B = {B}) plain on the card: converged {cp:.4f}, "
            f"median iterations {itp.float().median().item():.0f}, "
            f"{plain_wall:.3f} s")
        check(abs(conv - cp) <= CONV_ATOL,
              f"config 5 (B = {B}): converged {conv} vs plain {cp}")
        rng = np.random.RandomState(55)
        walls = []
        for _ in range(3):
            (xs,) = tensors(rng.uniform(-2.0, 2.0, (B, n)),
                            dtype=torch.float32)
            walls.append(sync_time(lambda: bench(xs))[1])
        ms = 1e3 * statistics.median(walls)
        its = r.iterations.float().median().item()
        log(f"config 5 (B = {B}) K3 via batch_minimize: {ms:.2f} ms per call "
            f"(median of 3, distinct inputs; min {1e3 * min(walls):.2f}, max "
            f"{1e3 * max(walls):.2f}), {B / (ms / 1e3):.1f} solves/s, "
            f"{ms / its:.2f} ms per Newton iteration; plain "
            f"{1e3 * plain_wall:.0f} ms  [{card}]")
        results[B] = dict(r=r, launches=launches, ms=ms,
                          plain_ms=1e3 * plain_wall)

    # the batched-Cholesky yardstick (cuSOLVER through torch.linalg; K6's
    # library counterpart, used nowhere in the port): factor and solve the
    # same (B, n, n) float32 batch once
    B = c["B"]
    Hb = Q.expand(B, n, n).contiguous()
    (g,) = tensors(starts[:B] @ Q64.T, dtype=torch.float32)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    lib_ms = []
    for _ in range(4):
        start.record()
        L = torch.linalg.cholesky(Hb)
        torch.cholesky_solve(g[:, :, None], L)
        stop.record()
        torch.cuda.synchronize()
        lib_ms.append(start.elapsed_time(stop))
    library_ms = statistics.median(lib_ms[1:])
    del Hb, L
    log(f"yardstick: torch.linalg.cholesky + torch.cholesky_solve on the "
        f"({B}, {n}, {n}) float32 batch: {library_ms:.3f} ms  [{card}]")

    # ---- 22. the Newton rows of minimize at config 5's width
    (x64,) = tensors(starts[:c["B_small"]], dtype=torch.float32)
    for method, policy, med in (("pn", "fast", 1), ("spn", "fast", 2),
                                ("newton", "fast", None)):
        bounds = None if method == "newton" else (-c["box"], c["box"])
        r, wall, _ = k3_main_path(
            f"config 5 minimize({method!r}, {policy})",
            lambda xs: minimize(q, xs, method=method, bounds=bounds,
                                tol=c["tol"], policy=policy, **kw),
            x64, c["B_small"], n, sync_time)
        quality(f"config 5 minimize({method!r}, {policy}) {wall:.3f} s", r,
                med)
    (x16,) = tensors(starts[:C5_SPN_REF_ROWS], dtype=torch.float32)
    r, wall, _ = k3_main_path(
        "config 5 minimize('spn', reference)",
        lambda xs: minimize(q, xs, method="spn", bounds=(-c["box"], c["box"]),
                            tol=c["tol"], policy="reference", **kw),
        x16, C5_SPN_REF_ROWS, n, sync_time)
    report(f"config 5 minimize('spn', reference), B = {C5_SPN_REF_ROWS}, "
           f"{wall:.3f} s (the reference BB scalar freezes on the Newton "
           f"direction)", r)

    # bound at config 5 (PN, B = 256), from this run's counts: x0, Q and the
    # bounds read once, x, f, iterations, status and trials written once;
    # per iteration and instance (csrc/driver.cuh, Newton form) the
    # Hessian 0.5 (Q + Q^T) 2n^2, the factorization n^3 / 3 (n^3 / 6
    # multiply-adds), one solve 2n^2 and the value-and-gradient at the new
    # point (Q x and Q^T x) 4n^2; per trial the value 2n^2; the first
    # value-and-gradient 4n^2.  The factorization dominates: operations
    # bound it.
    r56 = results[B]["r"]
    spec = fused_driver.build_spec(pn, ls.BackTrackingB())
    (x,) = tensors(starts[:B], dtype=torch.float32)
    nfev = fused_driver._launch_cuda(spec, q, x, -box, box, (), **kw)[4]
    its = r56.iterations.double().sum().item()
    bound_ms, bound_by = bound(
        2 * B * n * 4 + n * n * 4 + 2 * n * 4 + 4 * B * 4,
        its * (n ** 3 / 3 + 8 * n * n) + nfev.double().sum().item() * 2 * n * n
        + B * 4 * n * n)
    log(f"K3 Newton-form bound at config 5 (B = {B}): {bound_ms:.4f} ms "
        f"({bound_by}); kernel {results[B]['ms']:.2f} ms; "
        f"{results[B]['ms'] / bound_ms:.0f}x the bound  [{card}]")
    return {
        "name": "driver_newton",
        "form": "Newton",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/driver_newton.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_driver.py:1874",
        "launches": results[B]["launches"],
        "max_abs_err": max(max_abs_err, geom_err),
        "ms": results[B]["ms"],
        "plain_ms": results[B]["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "config 5 (B = 64)": {k: results[c["B_small"]][k]
                              for k in ("launches", "ms", "plain_ms")},
        "cholesky_yardstick_ms": library_ms,
    }


def newton_cg_slice(dev, card, tensors, sync_time):
    """Phases 23-24: the Newton-CG kernel K4 against its plain version per
    instance at the headline's shape in float64 (its first K4_CAPPED_ITERS
    iterations), then the Newton-CG headline in float32 through
    ``minimize(method="newton_cg")``, with times and the bound.  Returns
    K4's entry of the ``kernels`` line."""
    import torch

    from optimization_solvers_tpu_torch import minimize, problems
    from optimization_solvers_tpu_torch.ops import fused_newton_cg

    K4 = fused_newton_cg.newton_cg_solve_fused
    plain = fused_newton_cg.newton_cg_solve_plain
    rosen = problems.rosenbrock()
    n, B = HEADLINE["n"], HEADLINE["B"]
    kw = dict(pgtol=HEADLINE["pgtol"], factr=HEADLINE["factr"],
              max_iter=HEADLINE["max_iter"], cg_max=NEWTON_CG_MAX,
              max_iter_ls=25, c1=1e-4)
    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (B, n))

    # ---- 23. per instance in float64 over the first K4_CAPPED_ITERS
    # iterations (past ~10 a 1e-15 change of x0 moves x by more than 1e-9:
    # the truncated CG's exits are decided by rounding)
    x0d, lod, upd = tensors(starts, np.full(n, -BOX), np.full(n, BOX))
    capped = dict(kw, max_iter=K4_CAPPED_ITERS)
    x, _, it, st, ncg, nfev = fused_newton_cg._launch_cuda(
        rosen, x0d, lod, upd, (), **capped)
    torch.cuda.synchronize()
    xp, _, itp, stp, ncgp, nfevp = plain(rosen, x0d, lod, upd, **capped)
    noise = tensors(np.random.RandomState(100).standard_normal((B, n)))[0]
    xq = plain(rosen, x0d * (1 + 1e-15 * noise), lod, upd, **capped)[0]
    dx = (x - xp).abs().amax(-1)
    dq = (xq - xp).abs().amax(-1)
    close = (dx <= K3_X_ATOL).float().mean().item()
    same = [(a == b).float().mean().item()
            for a, b in ((st, stp), (it, itp), (ncg, ncgp), (nfev, nfevp))]
    max_abs_err = dx.max().item()
    log(f"K4 vs plain f64 at the headline shape, {K4_CAPPED_ITERS} "
        f"iterations: status equal {same[0]:.5f}, iterations equal "
        f"{same[1]:.5f}, HVPs equal {same[2]:.5f}, trials equal "
        f"{same[3]:.5f}, within {K3_X_ATOL} {close:.5f}, max|dx| "
        f"{max_abs_err:.3g}; plain vs plain with x0 moved by 1e-15 relative: "
        f"within {K3_X_ATOL} {(dq <= K3_X_ATOL).float().mean().item():.5f}, "
        f"max {dq.max().item():.3g}")
    check(same[0] == 1.0, "K4 f64: status differs")
    check(close >= F64_AGREE, f"K4 f64: only {close} of the instances "
          f"within {K3_X_ATOL}")
    for k in K4_SPREAD_CAPS:
        ck = dict(kw, max_iter=k)
        a = fused_newton_cg._launch_cuda(rosen, x0d, lod, upd, (), **ck)[0]
        b = plain(rosen, x0d, lod, upd, **ck)[0]
        b2 = plain(rosen, x0d * (1 + 1e-15 * noise), lod, upd, **ck)[0]
        log(f"K4 f64 after {k} iterations: kernel vs plain max|dx| "
            f"{(a - b).abs().max().item():.3g}, plain vs nudged plain "
            f"{(b2 - b).abs().max().item():.3g}")

    # ---- 24. the Newton-CG headline, float32, through minimize
    (x0,) = tensors(starts, dtype=torch.float32)
    lo = torch.full((n,), -BOX, device=dev)

    def solve(xs):
        return minimize(rosen, xs, method="newton_cg", bounds=(-BOX, BOX),
                        tol=HEADLINE["pgtol"], max_iter=HEADLINE["max_iter"],
                        cg_max=NEWTON_CG_MAX)

    def shares(f):
        low = (f < 1e-3).float().mean().item()
        local = ((f - 3.9866).abs() < 1e-2).float().mean().item()
        return low, local

    K4.launches = 0
    r, wall = sync_time(lambda: solve(x0))
    launches = K4.launches
    conv = (r.status == 1).float().mean().item()
    med_f = r.f.median().item()
    low, local = shares(r.f)
    log(f"Newton-CG headline via minimize: K4 launches {launches}, converged "
        f"{conv:.4f}, median f {med_f:.4g}, median iterations "
        f"{r.iterations.float().median().item():.0f} (max "
        f"{r.iterations.max().item()}), f < 1e-3 {low:.4f}, |f - 3.9866| < "
        f"1e-2 {local:.4f}, first call {wall:.3f} s")
    check(launches >= 1, "the Newton-CG headline launched no K4")
    check(r.x.shape == (B, n) and r.f.shape == (B,), "Newton-CG shapes")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.f).all()),
          "Newton-CG: non-finite result")
    check(conv >= 0.99, f"Newton-CG converged fraction {conv} < 0.99")
    check(med_f <= 1e-4, f"Newton-CG median f {med_f} > 1e-4")
    (_, fp, itp, stp, _, _), plain_wall = sync_time(
        lambda: plain(rosen, x0, lo, -lo, **kw))
    cp = (stp == 1).float().mean().item()
    lowp, localp = shares(fp)
    log(f"Newton-CG headline plain on the card: converged {cp:.4f}, median "
        f"f {fp.median().item():.4g}, median iterations "
        f"{itp.float().median().item():.0f} (max {itp.max().item()}), f < "
        f"1e-3 {lowp:.4f}, |f - 3.9866| < 1e-2 {localp:.4f}, "
        f"{plain_wall:.3f} s")
    check(abs(conv - cp) <= CONV_ATOL,
          f"Newton-CG: converged {conv} vs plain {cp}")
    medians_agree("Newton-CG headline", r, fp, itp, C2_MED_IT_RTOL,
                  C2_MED_F_RTOL, kernel="K4")
    rng = np.random.RandomState(44)
    walls = []
    for _ in range(3):
        (xs,) = tensors(rng.uniform(-2.0, 2.0, (B, n)), dtype=torch.float32)
        walls.append(sync_time(lambda: solve(xs))[1])
    ms = 1e3 * statistics.median(walls)
    sps = [B / w for w in walls]
    log(f"Newton-CG headline K4 via minimize: {ms:.2f} ms per call, solves/s "
        f"median {statistics.median(sps):.0f}, min {min(sps):.0f}, max "
        f"{max(sps):.0f} (3 repeats, distinct inputs); plain "
        f"{1e3 * plain_wall:.0f} ms  [{card}]")

    # bound at the Newton-CG headline, from the kernel's own counts on the
    # main path's inputs: x0 and the bounds read once, x, f, iterations and
    # status written once; the operations the function needs at the least
    # (pallas_newton_cg.py:70-267 without the work its algebra makes
    # redundant, whatever implements it): per outer iteration one
    # projection-arc norm 4n, the free mask, g_F and its norm 8n, the
    # fallback pass 3n, the Rosenbrock Hessian's coefficients 9n (H_ii 8n,
    # H_{i,i+1} n) and the gradient at the accepted trial 8n (its value and
    # point are the trial's); per Hessian-vector product the product on
    # those coefficients 5n and the CG passes 13n (the masked product, p.q,
    # p.p, the D, R and P updates and r.r; p * fr is p, so no masked
    # operand); per trial the clipped point and g.(x_t - x) 7n and the value
    # 7n; per instance the first value and gradient 15n
    _, _, itk, _, ncgk, nfevk = fused_newton_cg._launch_cuda(
        rosen, x0, lo, -lo, (), **kw)
    info = fused_newton_cg.kernel_info(torch.float32, B, n)
    log(f"K4 at the Newton-CG headline: {info['registers']} registers, "
        f"{info['local_bytes']} local bytes a thread, "
        f"{info['warps_per_block']} warps a block, {info['warps_per_sm']} "
        f"resident warps per SM, {info['smem_per_block']} bytes of shared "
        f"memory a block  [{card}]")
    bound_ms, bound_by = bound(
        2 * B * n * 4 + 2 * n * 4 + 3 * B * 4,
        n * (32 * itk.double().sum().item() + 18 * ncgk.double().sum().item()
             + 14 * nfevk.double().sum().item() + 15 * B))
    log(f"K4 bound at the Newton-CG headline: {bound_ms:.4f} ms ({bound_by}); "
        f"HVPs per iteration {ncgk.sum().item() / itk.sum().item():.3f}, "
        f"trials per iteration {nfevk.sum().item() / itk.sum().item():.3f}; "
        f"kernel {ms:.2f} ms  [{card}]")
    return {
        "name": "newton_cg",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/newton_cg.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_newton_cg.py:340",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": 1e3 * plain_wall,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "registers": info["registers"],
        "warps_per_sm": info["warps_per_sm"],
    }

def kernel_wrappers():
    """Every kernel's wrapper, whose ``.launches`` counts its launches."""
    from optimization_solvers_tpu_torch.ops import (
        fused_bfgs, fused_driver, fused_lbfgs, fused_lbfgsb,
        fused_lbfgsb_tall, fused_newton, fused_newton_cg, fused_qn,
        fused_spg)

    return {"K1": fused_lbfgsb.lbfgsb_solve_fused,
            "K1s": fused_lbfgsb.lbfgsb_solve_fused_scaled,
            "K2": fused_lbfgsb_tall.lbfgsb_solve_fused_tall,
            "K3": fused_driver.fused_minimize,
            "K4": fused_newton_cg.newton_cg_solve_fused,
            "K5": fused_qn.qn_update_direction_fused,
            "K6": fused_newton.cholesky_solve_fused,
            "K7": fused_lbfgs.lbfgs_solve_fused,
            "K8": fused_spg.spg_solve_fused,
            "K9": fused_bfgs.bfgs_solve_fused}


def device_busy_s(fn, sync_time):
    """Seconds the card spent in kernels and copies while ``fn()`` ran,
    from ``torch.profiler``'s per-kernel device times (one stream: they do
    not overlap); ``None`` where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as p:
        sync_time(fn)
    total = 0.0
    for e in p.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue              # host events (their kernels count below)
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
    torch.cuda.synchronize()
    return total / 1e6 if total > 0 else None


def event_ms(fn, reps):
    """Milliseconds per call of ``fn()`` on the card (CUDA events around
    ``reps`` calls after one warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def drive(what, fn, kernel, sync_time):
    """``fn()`` with every count at 0; ``kernel`` alone must launch, or with
    ``kernel`` None (the lockstep loop) none.  Returns the result, the wall
    time and ``kernel``'s launches."""
    import torch

    counted = kernel_wrappers()
    for k in counted.values():
        k.launches = 0
    r, wall = sync_time(fn)
    counts = {name: k.launches for name, k in counted.items()}
    log(f"{what}: launches {counts}, {wall:.3f} s")
    others = [v for name, v in counts.items() if name != kernel]
    check((kernel is None or counts[kernel] >= 1) and not any(others),
          f"{what}: launches {counts}, not {kernel} alone")
    check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.f).all()),
          f"{what}: non-finite result")
    return r, wall, counts.get(kernel, 0)


def rosen(x):
    """Rosenbrock as a plain torch callable: no analytic forms, no kernel
    form."""
    import torch

    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2)


def lse_scipy(A, b, x0, box, kw):
    """scipy's float64 ``fmin_l_bfgs_b`` on the bounded log-sum-exp from x0
    (config 4's anchor): the final f."""
    from scipy.optimize import fmin_l_bfgs_b

    def fg(x):
        z = A @ x + b
        mz = z.max()
        e = np.exp(z - mz)
        return mz + np.log(e.sum()), A.T @ (e / e.sum())

    return fmin_l_bfgs_b(fg, x0, bounds=[(-box, box)] * len(x0), m=kw["m"],
                         pgtol=kw["pgtol"], factr=kw["factr"],
                         maxiter=kw["max_iter"])[1]


def host_share(what, fn, wall, card, sync_time):
    """The host's share of ``fn()``'s wall time (``None`` where the profiler
    shows no device time)."""
    busy = device_busy_s(fn, sync_time)
    if busy is None:
        log(f"{what}: device busy time not measured (the profiler shows "
            f"no device time)")
        return None
    share = max(0.0, 1.0 - busy / wall)
    log(f"{what}: device busy {busy:.4f} s of {wall:.4f} s wall, host "
        f"share {share:.3f}  [{card}]")
    return share


def stopwatch():
    """``lap(what)``: log the wall seconds since the previous lap (the first
    since this call)."""
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"{what}: {now - last[0]:.1f} s of wall")
        last[0] = now

    return lap


def lockstep_slice(dev, card, tensors, sync_time):
    """Phases 25-27: the lockstep loop's fused dense quasi-Newton update K5
    against its plain version at the shape of its path (every rule in both
    types, timed) and past its shared-memory fit, then that path at
    full width: dense BFGS with ``fused=True`` + More-Thuente through
    ``solvers.batch_minimize(fused=False)`` (config 2's width), with times,
    the bound and the host's share of the wall time.  Returns K5's entry
    of the ``kernels`` line."""
    import torch

    from _torch_geometries import qn_update_arrays
    from optimization_solvers_tpu_torch import (linesearch as ls, problems,
                                                solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import fused_qn

    K5 = fused_qn.qn_update_direction_fused

    # ---- 25. K5 vs plain at the K5 path's shape, all four rules in both
    # types, each timed (its B staged in shared memory: the placement)
    c = LOCKSTEP_QN
    B, n = c["B"], c["n"]
    # curvature pairs (s.y > 0), as the path's Wolfe search feeds K5
    arrays = qn_update_arrays(B, n, curvature=True)
    k5_err = 0.0
    k5_rule_ms = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        Bm, s, y, g = tensors(*arrays, dtype=dtype)
        skip = fused_qn.skip_mask(s, y, 1e-8)
        # B read and B' written once, s, y, g read and B' g written once
        nbytes = (2 * n * n + 4 * n) * B * Bm.element_size()
        for kind in fused_qn.KINDS:
            K5.placements = {"shared": 0, "workspace": 0}
            Bn, Bg = K5(Bm, s, y, g, tol=1e-8, kind=kind)
            torch.cuda.synchronize()
            placements = dict(K5.placements)
            Pn, Pg = fused_qn.qn_update_direction_plain(Bm, s, y, g, skip,
                                                        kind=kind)
            rel = max(((Bn - Pn).abs().max() / Pn.abs().max()).item(),
                      ((Bg - Pg).abs().max() / Pg.abs().max()).item())
            frozen = torch.equal(Bn[1], Bm[1])
            if dtype == torch.float32 and kind == "bfgs":
                k5_err = max((Bn - Pn).abs().max().item(),
                             (Bg - Pg).abs().max().item())
            rule_ms = event_ms(lambda: K5(Bm, s, y, g, tol=1e-8, kind=kind),
                               50)
            k5_rule_ms[f"{kind} {name}"] = rule_ms
            log(f"K5 vs plain {name} {kind} ({B}, {n}, {n}): max|d| / "
                f"max|entry| {rel:.3g}, skipped instance's B unchanged "
                f"{frozen}, placements {placements}; {1e3 * rule_ms:.2f} us "
                f"per launch, {nbytes / (rule_ms * 1e-3) / 1e12:.3f} TB/s "
                f"({nbytes / (rule_ms * 1e-3) / HBM_BYTES_PER_S:.3f} of 3.35 "
                f"TB/s)  [{card}]")
            check(rel <= K5_RTOL[name], f"K5 {name} {kind}: {rel}")
            check(frozen, f"K5 {name} {kind}: the skipped B changed")
            check(placements == {"shared": 1, "workspace": 0},
                  f"K5 {name} {kind}: placements {placements}")
    Bm, s, y, g = tensors(*arrays, dtype=torch.float32)
    skip = fused_qn.skip_mask(s, y, 1e-8)
    k5_ms = k5_rule_ms["bfgs float32"]
    k5_plain_ms = event_ms(lambda: fused_qn.qn_update_direction_plain(
        Bm, s, y, g, skip, kind="bfgs"), 10)
    # B read and B' written once, s, y, g read and B' g written once; ~10
    # n^2 operations per instance (B y 2 n^2, the update ~6 n^2, B' g 2 n^2)
    k5_bound, k5_by = bound((2 * n * n + 4 * n) * B * 4, 10 * n * n * B)
    log(f"K5 bfgs ({B}, {n}, {n}) float32: kernel {1e3 * k5_ms:.1f} us, plain "
        f"{1e3 * k5_plain_ms:.1f} us, bound {1e3 * k5_bound:.1f} us "
        f"({k5_by}); {k5_ms / k5_bound:.1f}x the bound  [{card}]")
    del Bm, s, y, g, Bn, Bg, Pn, Pg

    # ---- 25b. K5 past the shared placement's fit (the workspace placement:
    # B read from device memory) against the plain version
    for dtype, wide in ((torch.float32, K5_FIT["n32"]),
                        (torch.float64, K5_FIT["n64"])):
        name = str(dtype).split(".")[1]
        Bm, s, y, g = tensors(*qn_update_arrays(K5_FIT["B"], wide,
                                                curvature=True), dtype=dtype)
        skip = fused_qn.skip_mask(s, y, 1e-8)
        check(not fused_qn.in_shared(wide, Bm.element_size()),
              f"K5 past the fit: n = {wide} fits shared memory in {name}")
        for kind in fused_qn.KINDS:
            K5.placements = {"shared": 0, "workspace": 0}
            Bn, Bg = K5(Bm, s, y, g, tol=1e-8, kind=kind)
            torch.cuda.synchronize()
            placements = dict(K5.placements)
            Pn, Pg = fused_qn.qn_update_direction_plain(Bm, s, y, g, skip,
                                                        kind=kind)
            rel = max(((Bn - Pn).abs().max() / Pn.abs().max()).item(),
                      ((Bg - Pg).abs().max() / Pg.abs().max()).item())
            frozen = torch.equal(Bn[1], Bm[1])
            log(f"K5 past the fit {name} {kind} ({K5_FIT['B']}, {wide}, "
                f"{wide}): placements {placements}, max|d| / max|entry| "
                f"{rel:.3g}, skipped instance's B unchanged {frozen}")
            check(placements == {"shared": 0, "workspace": 1},
                  f"K5 past the fit {name} {kind}: placements {placements}")
            check(rel <= K5_RTOL[name],
                  f"K5 past the fit {name} {kind}: {rel}")
            check(frozen, f"K5 past the fit {name} {kind}: the skipped B "
                  "changed")
        del Bm, s, y, g, Bn, Bg, Pn, Pg

    # ---- 26. the K5 path: lockstep dense BFGS (fused=True) + More-Thuente
    # at config 2's width, float32, through batch_minimize(fused=False)
    rosen = make_oracle(problems.rosenbrock())
    kw = dict(max_iter=c["max_iter"], max_iter_ls=c["max_iter_ls"])
    search = ls.MoreThuente(approx_wolfe=True)
    fused = solvers.QuasiNewton(update="bfgs", tol=c["tol"], fused=True)
    unfused = solvers.QuasiNewton(update="bfgs", tol=c["tol"])
    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (B, n))

    def qn_path(xs, method=fused, **extra):
        return solvers.batch_minimize(method, search, rosen, xs, fused=False,
                                      **dict(kw, **extra))

    def success(r):
        return torch.isin(r.status, torch.tensor([1, 6], device=dev)
                          ).float().mean().item()

    (x32,) = tensors(starts, dtype=torch.float32)
    K5.placements = {"shared": 0, "workspace": 0}
    r5, wall5, k5_launches = drive(
        "K5 path (lockstep BFGS fused + MoreThuente, 1,024 x 100, f32) via "
        "batch_minimize", lambda: qn_path(x32), "K5", sync_time)
    lockstep_iters = int(r5.iterations.max())
    check(k5_launches == lockstep_iters,
          f"K5 launches {k5_launches}, lockstep iterations {lockstep_iters}")
    check(K5.placements == {"shared": k5_launches, "workspace": 0},
          f"K5 path: placements {K5.placements}")
    conv5 = report("K5 path", r5, wall5)
    log(f"K5 path: success (1 or 6) {success(r5):.4f}, converged {conv5:.4f}, "
        f"{k5_launches} K5 launches = lockstep iterations, "
        f"{B / wall5:.1f} solves/s  [{card}]")
    ru, wall_u = sync_time(lambda: qn_path(x32, unfused))
    report("same solves, unfused update (plain)", ru, wall_u)
    check(abs(success(r5) - success(ru)) <= CONV_ATOL,
          f"K5 path: success {success(r5)} vs unfused {success(ru)}")
    medians_agree("K5 path", r5, ru.f, ru.iterations, C2_MED_IT_RTOL,
                  C2_MED_F_RTOL, kernel="K5")
    # one timed run: a second on distinct inputs (9.9-13 s, host-bound) was
    # cut to keep the script's time as phases 35-36 were added
    log(f"K5 path: {1e3 * wall5 / lockstep_iters:.3f} ms per lockstep "
        f"iteration  [{card}]")
    capped = dict(max_iter=LS_PROFILE_ITERS)
    _, wall_cap = sync_time(lambda: qn_path(x32, **capped))
    qn_host = host_share(f"K5 path, first {LS_PROFILE_ITERS} iterations",
                         lambda: qn_path(x32, **capped), wall_cap, card,
                         sync_time)

    # ---- 27. the K5 path per instance in float64 over its first iterations:
    # the fused update (K5) against the unfused one, on the card
    (x64,) = tensors(starts)
    cap = dict(max_iter=LS_QN_CAPPED_ITERS)
    rf = qn_path(x64, **cap)
    rp = qn_path(x64, unfused, **cap)
    noise = tensors(np.random.RandomState(100).standard_normal((B, n)))[0]
    rq = qn_path(x64 * (1 + 1e-15 * noise), unfused, **cap)
    err = (rf.x - rp.x).abs().max().item()
    spread = (rq.x - rp.x).abs().max().item()
    same = [(a == b).float().mean().item()
            for a, b in ((rf.status, rp.status),
                         (rf.iterations, rp.iterations))]
    log(f"K5 path f64, {B} x {n}, first {LS_QN_CAPPED_ITERS} iterations: "
        f"fused vs unfused status equal {same[0]:.5f}, iterations equal "
        f"{same[1]:.5f}, max|dx| {err:.3g} (unfused vs unfused with x0 moved "
        f"by 1e-15 relative: {spread:.3g})")
    check(min(same) == 1.0, "K5 path f64: status or iterations differ")
    check(err <= max(spread, LS_QN_X_FLOOR),
          f"K5 path f64: max|dx| {err} > spread {spread}")

    k5 = {
        "name": "qn_update",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/qn_update.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_qn.py:92",
        "launches": k5_launches,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound,
        "bound_by": k5_by,
        "library_ms": None,
        "rules_ms": k5_rule_ms,
        "path": {"seconds": wall5, "solves_per_s": B / wall5,
                 "lockstep_iterations": lockstep_iters,
                 "converged": conv5, "success": success(r5),
                 "host_share": qn_host},
    }
    return k5


def cholesky_slice(dev, card, tensors, sync_time):
    """Phases 28-29: the batched Cholesky solve K6 against its plain
    version and the library at config 5's batch (with the bound and the
    blocked design's own streaming floor), then the
    lockstep Newton path, ProjectedNewton with ``ops.linalg.config.
    use_kernel = True`` (config 5's width), with times and the host's share
    of the wall time.  Returns K6's entry of the ``kernels`` line."""
    import torch

    from _torch_geometries import config5_hessian
    from optimization_solvers_tpu_torch import (linesearch as ls, problems,
                                                solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import fused_newton, linalg

    K6 = fused_newton.cholesky_solve_fused

    # ---- 28. K6 vs plain and the library on config 5's batch
    c5 = CONFIG5
    n5, B5 = c5["n"], c5["B"]
    Q64 = config5_hessian(n5)
    starts5 = np.random.RandomState(5).uniform(-2.0, 2.0, (B5, n5))

    def residual(H, x, g):
        r = torch.einsum("bij,bj->bi", H, x) - g
        return (r.norm(dim=-1) / g.norm(dim=-1)).max().item()

    def library(H, g):
        L = torch.linalg.cholesky(H)
        return torch.cholesky_solve(g[:, :, None], L)[..., 0]

    k6_err = 0.0
    for dtype, rows in ((torch.float64, LS_K6_F64_ROWS),
                        (torch.float32, B5)):
        name = str(dtype).split(".")[1]
        (Q,) = tensors(Q64, dtype=dtype)
        H = Q.expand(rows, n5, n5).contiguous()
        (g,) = tensors(starts5[:rows] @ Q64.T, dtype=dtype)
        xk = K6(H, g)
        torch.cuda.synchronize()
        xp = fused_newton.cholesky_solve_plain(H, g)
        xl = linalg.cholesky_solve(H, g)
        res = [residual(H, v, g) for v in (xk, xp, xl)]
        dxp = (xk - xp).abs().max().item()
        log(f"K6 {name} ({rows}, {n5}, {n5}): relative residual kernel "
            f"{res[0]:.3g}, plain {res[1]:.3g}, library {res[2]:.3g}; "
            f"max|x - x_plain| {dxp:.3g}, max|x - x_library| "
            f"{(xk - xl).abs().max().item():.3g}")
        check(max(res) <= K6_RES[name], f"K6 {name}: residuals {res}")
        if dtype == torch.float32:
            k6_err = dxp
            k6_ms = event_ms(lambda: K6(H, g), 5)
            k6_plain_ms = event_ms(
                lambda: fused_newton.cholesky_solve_plain(H, g), 1)
            k6_lib_ms = event_ms(lambda: library(H, g), 5)
        del H, g, xk, xp, xl
    # H and g read once, x written once; n^3 / 3 + 4 n^2 operations per
    # instance (the factorization and the two substitutions)
    k6_bound, k6_by = bound((n5 * n5 + 2 * n5) * B5 * 4,
                            (n5 ** 3 / 3 + 4 * n5 * n5) * B5)
    log(f"K6 ({B5}, {n5}, {n5}) float32: kernel {k6_ms:.3f} ms, plain "
        f"{k6_plain_ms:.1f} ms, torch.linalg.cholesky + torch.cholesky_solve "
        f"{k6_lib_ms:.3f} ms, bound {k6_bound:.3f} ms ({k6_by}); "
        f"{k6_ms / k6_bound:.1f}x the bound  [{card}]")
    nb = fused_newton.PANEL[torch.float32]
    floor_ms = 1e3 * B5 * k6_stream_bytes(n5, nb, 4) / HBM_BYTES_PER_S
    log(f"K6 panel width {nb}: the blocked design's streaming floor (its "
        f"device-memory passes over {HBM_BYTES_PER_S / 1e12:.2f} TB/s) "
        f"{floor_ms:.3f} ms; kernel {k6_ms:.3f} ms  [{card}]")

    # ---- 29. the K6 path: lockstep ProjectedNewton through ops.linalg with
    # the kernel, config 5 (B = 256, n = 1,024, float32)
    (Q,) = tensors(Q64, dtype=torch.float32)
    quad = make_oracle(problems.quadratic(Q), with_hessian=True)
    box = torch.full((n5,), c5["box"], device=dev)
    kw5 = dict(max_iter=c5["max_iter"], max_iter_ls=c5["max_iter_ls"])
    pn = solvers.ProjectedNewton(grad_tol=c5["tol"])

    def newton_path(xs, method=pn, oracle=quad, lo=-box, up=box):
        return solvers.batch_minimize(method, ls.BackTrackingB(), oracle, xs,
                                      bounds=(lo, up), fused=False, **kw5)

    use_kernel = linalg.config.use_kernel
    linalg.config.use_kernel = True
    try:
        (x5,) = tensors(starts5, dtype=torch.float32)
        r6, wall6, k6_launches = drive(
            f"K6 path (lockstep PN, {B5} x {n5}, f32) via batch_minimize",
            lambda: newton_path(x5), "K6", sync_time)
        check(k6_launches == int(r6.iterations.max()),
              f"K6 launches {k6_launches}, iterations "
              f"{int(r6.iterations.max())}")
        conv6 = report("K6 path", r6, wall6)
        xmax = r6.x.abs().max().item()
        med = r6.iterations.float().median().item()
        check(conv6 == 1.0 and med == 1 and xmax <= C5_X_ATOL,
              f"K6 path: converged {conv6}, median iterations {med}, "
              f"max|x| {xmax}")
        # this path and K3's Newton form (phase 21's main path) on the same
        # calls, in turns: each round one input for both, the order
        # alternating from round to round
        q5 = make_oracle(problems.quadratic(Q))

        def k3_path(xs):
            return solvers.batch_minimize(pn, ls.BackTrackingB(), q5, xs,
                                          bounds=(-box, box), **kw5)

        rng = np.random.RandomState(55)
        walls, k3_walls = [], []
        for turn in range(C5_TURNS):
            (xs,) = tensors(rng.uniform(-2.0, 2.0, (B5, n5)),
                            dtype=torch.float32)
            pair = ((walls, newton_path), (k3_walls, k3_path))
            for out, path in pair[::1 if turn % 2 == 0 else -1]:
                out.append(sync_time(partial(path, xs))[1])
        pn_ms = 1e3 * statistics.median(walls)
        k3_ms = 1e3 * statistics.median(k3_walls)
        k3_ahead = sum(a < b for a, b in zip(k3_walls, walls))
        log(f"K6 path: {pn_ms:.2f} ms per call (median of {C5_TURNS}, "
            f"distinct inputs; min {1e3 * min(walls):.2f}, max "
            f"{1e3 * max(walls):.2f}), {B5 / (pn_ms / 1e3):.1f} solves/s; "
            f"K3's Newton form on the same calls in turns {k3_ms:.2f} ms (min "
            f"{1e3 * min(k3_walls):.2f}, max {1e3 * max(k3_walls):.2f}), "
            f"ahead in {k3_ahead} of {C5_TURNS}  [{card}]")
        log("K6 path vs K3, ms per round: " + ", ".join(
            f"{1e3 * a:.2f} / {1e3 * b:.2f}" for a, b in zip(walls, k3_walls)))
        pn_host = host_share("K6 path", lambda: newton_path(x5),
                             min(walls), card, sync_time)
        (x64s,) = tensors(starts5[:64], dtype=torch.float32)
        spn = solvers.SpectralProjectedNewton(grad_tol=c5["tol"],
                                              precond_bb=True)
        rs, walls_, spn_launches = drive(
            "K6 path, SPN precond_bb (64 x 1,024, f32)",
            lambda: newton_path(x64s, spn), "K6", sync_time)
        report("SPN precond_bb", rs, walls_)
        check(spn_launches == 2 * int(rs.iterations.max()),
              f"SPN: K6 launches {spn_launches}, iterations "
              f"{int(rs.iterations.max())}")
        # float64 per instance: the kernel against the library path
        (Q8,) = tensors(Q64)
        q8 = make_oracle(problems.quadratic(Q8), with_hessian=True)
        x8, lo8, up8 = tensors(starts5[:C5_F64_ROWS], np.full(n5, -c5["box"]),
                               np.full(n5, c5["box"]))
        runs = []
        for flag in (True, False):
            linalg.config.use_kernel = flag
            runs.append(newton_path(x8, pn, q8, lo8, up8))
        dx = (runs[0].x - runs[1].x).abs().max().item()
        same = (torch.equal(runs[0].status, runs[1].status)
                and torch.equal(runs[0].iterations, runs[1].iterations))
        log(f"K6 path f64, {C5_F64_ROWS} x {n5}: kernel vs library status and "
            f"iterations equal {same}, max|dx| {dx:.3g}")
        check(same and dx <= 1e-10, f"K6 path f64: {same}, {dx}")
    finally:
        linalg.config.use_kernel = use_kernel

    k6 = {
        "name": "cholesky_solve",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/cholesky_solve.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_newton.py:101",
        "launches": k6_launches,
        "max_abs_err": k6_err,
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound,
        "bound_by": k6_by,
        "library_ms": k6_lib_ms,
        "path": {"ms": pn_ms, "solves_per_s": B5 / (pn_ms / 1e3),
                 "k3_newton_ms": k3_ms, "k3_ahead": k3_ahead,
                 "turns": C5_TURNS, "host_share": pn_host},
    }
    return k6


def dense_fit_slice(dev, card, tensors):
    """Phase 33: K3's dense form and K9 past the shared-memory fit (n =
    400, B = 64, float64 and float32: the slabs in the workspace) against
    their plain versions on the same inputs: BFGS + MoreThuente, BFGSB +
    HagerZhangB and Broyden + BackTracking through ``fused_driver``, and
    ``ops.bfgs_solve_fused``; each launch in the workspace placement.
    (BFGSB + MoreThuenteB stalls at this width: its running step cap, the
    smallest feasible step of every iteration so far, leaves the plain
    version unconverged after 400 iterations too.)  Returns the float64
    max |dx| of K3 and of K9."""
    import torch

    from optimization_solvers_tpu_torch import (linesearch as ls, problems,
                                                solvers)
    from optimization_solvers_tpu_torch.ops import fused_bfgs, fused_driver

    c = DENSE_FIT
    B, n = c["B"], c["n"]
    obj = problems.weighted_squares()
    starts = np.random.RandomState(400).uniform(-2.0, 2.0, (B, n))
    arrays = (starts, np.linspace(1.0, 50.0, n), np.linspace(-0.5, 2.0, n),
              np.full(n, -c["box"]), np.full(n, c["box"]))
    cases = (("BFGS + MoreThuente", solvers.BFGS, ls.MoreThuente, False),
             ("BFGSB + HagerZhangB", solvers.BFGSB, ls.HagerZhangB, True),
             ("Broyden + BackTracking", solvers.Broyden, ls.BackTracking,
              False))
    K3, K9 = fused_driver.fused_minimize, fused_bfgs.bfgs_solve_fused
    errs = {"K3": 0.0, "K9": 0.0}
    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        tol = c["tol64"] if f64 else c["tol32"]
        itemsize = 8 if f64 else 4
        x0, d, t, lo, up = tensors(*arrays, dtype=dtype)
        kw = dict(max_iter=c["max_iter"], max_iter_ls=c["max_iter_ls"])
        runs = []
        for what, make, search, bounded in cases:
            method, box = make(tol=tol), (lo, up) if bounded else (None, None)
            spec = fused_driver.build_spec(method, search())
            check(not fused_driver.dense_in_shared(n, spec.ring, itemsize,
                                                   spec.qn_update),
                  f"{what}: n = {n} fits shared memory")
            K3.placements = {"shared": 0, "workspace": 0}
            x, _, it, st, _ = fused_driver._launch_cuda(spec, obj, x0, *box,
                                                        (d, t), **kw)
            torch.cuda.synchronize()
            placements = dict(K3.placements)
            xp, _, itp, stp, _ = fused_driver.fused_minimize_plain(
                method, search(), obj, x0, *box, (d, t), **kw)
            runs.append(("K3", what, placements, x, it, st, xp, itp, stp))
        K9.placements = {"shared": 0, "workspace": 0}
        x, _, it, st, _, _ = fused_bfgs._launch_cuda(
            obj, x0, (d, t), tol=tol, max_iter=c["max_iter"], max_iter_ls=24,
            c1=1e-4)
        torch.cuda.synchronize()
        placements = dict(K9.placements)
        xp, _, itp, stp = fused_bfgs.bfgs_solve_plain(
            obj, x0, (d, t), tol=tol, max_iter=c["max_iter"], max_iter_ls=24,
            c1=1e-4)
        runs.append(("K9", "K9 dense BFGS + Armijo", placements, x, it, st,
                     xp, itp, stp))
        for key, what, placements, x, it, st, xp, itp, stp in runs:
            err = (x - xp).abs().max().item()
            same = (st == stp).float().mean().item()
            conv = (st == 1).float().mean().item()
            dit = (it.long() - itp.long()).abs().max().item()
            log(f"{what} past the fit, {B} x {n}, {str(dtype)[6:]}: "
                f"placements {placements}, status equal {same:.4f}, "
                f"converged {conv:.4f}, max|dx| {err:.3g}, max|d iters| "
                f"{dit}, median iterations "
                f"{it.float().median().item():.0f}  [{card}]")
            check(placements == {"shared": 0, "workspace": 1},
                  f"{what} past the fit: placements {placements}")
            if f64:
                check(same == 1.0 and err <= DENSE_FIT_F64_ATOL,
                      f"{what} past the fit (float64): status equal {same}, "
                      f"max|dx| {err}")
                errs[key] = max(errs[key], err)
            else:
                check(same >= DENSE_FIT_F32_AGREE
                      and err <= DENSE_FIT_F32_ATOL,
                      f"{what} past the fit (float32): status equal {same}, "
                      f"max|dx| {err}")
    return errs["K3"], errs["K9"]


def layouts_slice(dev, card, tensors):
    """Phase 34: K3's first-order form (every first-order method with each
    Armijo-family search it takes) and K8 in each of their layouts
    (LAYOUT_CHECK's widths: two coordinates a lane, four, the warp's shared
    memory) against their plain versions, float64 per instance and
    float32 full solves; the layout each launch took from the kernels'
    launch reports.  Returns the float64 max |dx| of K3 and of K8."""
    import torch

    from optimization_solvers_tpu_torch import (linesearch as ls, problems,
                                                solvers)
    from optimization_solvers_tpu_torch.ops import fused_driver, fused_spg

    c = LAYOUT_CHECK
    B = c["B"]
    obj = problems.weighted_squares()
    spg = solvers.SpectralProjectedGradient
    cases = (
        ("GD + BackTracking", solvers.GradientDescent, ls.BackTracking, {}),
        ("GD + GLL", solvers.GradientDescent, ls.GLLQuadratic, {}),
        ("GD + NoSearch", solvers.GradientDescent, ls.NoSearch, {}),
        ("CD + BackTracking", solvers.CoordinateDescent, ls.BackTracking, {}),
        ("Pnorm + BackTracking", solvers.PnormDescent, ls.BackTracking, {}),
        ("PGD + BackTracking", solvers.ProjectedGradientDescent,
         ls.BackTracking, {}),
        ("PGD + BackTrackingB", solvers.ProjectedGradientDescent,
         ls.BackTrackingB, {}),
        ("SPG (bb1) + GLL", spg, ls.GLLQuadratic, {}),
        ("SPG (alternate) + GLL", spg, ls.GLLQuadratic,
         {"bb_variant": "alternate"}),
        ("SPG + BackTrackingB", spg, ls.BackTrackingB, {}),
        ("NCG (pr+) + BackTracking", solvers.NonlinearCG, ls.BackTracking,
         {"variant": "pr+"}),
    )
    errs = {"K3": 0.0, "K8": 0.0}
    for n in c["widths"]:
        rng = np.random.RandomState(n)
        starts = rng.uniform(-2.0, 2.0, (B, n))
        d, t = np.linspace(1.0, 10.0, n), np.linspace(-1.0, 1.0, n)
        for dtype in (torch.float64, torch.float32):
            f64 = dtype == torch.float64
            tol = 1e-6 if f64 else c["tol32"]
            max_iter = c["iters"] if f64 else c["max_iter"]
            x0, lo, up = tensors(starts, np.full(n, -0.5), np.full(n, 0.5),
                                 dtype=dtype)
            for what, make, search, extra in cases:
                data = (np.linspace(0.2, 1.8, n) if "NoSearch" in what
                        else d, t)
                if make is solvers.PnormDescent:
                    extra = {"inverse_p": np.diag(1.0 / d) + 1e-3}
                method = make(grad_tol=tol, **extra)
                spec = fused_driver.build_spec(method, search())
                box = (lo, up) if spec.bounded else (None, None)
                dd = tensors(*data, dtype=dtype)
                lanes = fused_driver.first_order_info(
                    dtype, B, n, spec.method, spec.ring)["lane_coordinates"]

                def kernel(iters, spec=spec, box=box, dd=dd):
                    return fused_driver._launch_cuda(
                        spec, obj, x0, *box, dd, max_iter=iters,
                        max_iter_ls=40)

                def plain(iters, ties=None, method=method, search=search,
                          box=box, dd=dd):
                    return fused_driver.fused_minimize_plain(
                        method, search(), obj, x0, *box, dd, max_iter=iters,
                        max_iter_ls=40, ties=ties)

                errs["K3"] = max(errs["K3"], layout_held(
                    f"K3 {what}", n, dtype, lanes, B, kernel, plain,
                    max_iter, card))
            # K8 on the same inputs in the box
            kw8 = dict(tol=tol, lam_min=1e-3, lam_max=1e3, gll_m=10, c1=1e-4,
                       max_iter_ls=30)
            dd = tensors(d, t, dtype=dtype)
            lanes = fused_spg.kernel_info(dtype, B, n)["lane_coordinates"]

            def kernel8(iters, dd=dd):
                return fused_spg._launch_cuda(obj, x0, lo, up, dd,
                                              max_iter=iters, **kw8)

            def plain8(iters, ties=None, dd=dd):
                nfev = torch.zeros((B,), dtype=torch.int32, device=dev)
                xp, fp, itp, stp = fused_spg.spg_solve_plain(
                    obj, x0, lo, up, dd, max_iter=iters, nfev=nfev,
                    ties=ties, **kw8)
                return xp, fp, itp, stp, nfev

            errs["K8"] = max(errs["K8"], layout_held(
                "K8", n, dtype, lanes, B, kernel8, plain8, max_iter, card))
    return errs["K3"], errs["K8"]


def layout_held(what, n, dtype, lanes, B, kernel, plain, max_iter, card):
    """Phase 34's check of one kernel against its plain version, each a
    function of the iteration budget returning ``(x, f, iterations,
    status, trials)``.  float64 per instance: status equal; iterations and
    trials equal and x within K3_X_ATOL where f is finite, on every
    instance whose plain run takes no decision that the order of a sum
    could flip, and on the others through the iterations before the first
    such decision (both run again to there).  float32: converged fraction
    at least CONV_FLOOR and within CONV_ATOL of the plain version's,
    median iterations and f within MED_IT_RTOL and MED_F_RTOL.  Returns
    float64's max |dx|."""
    import torch

    layout = f"{lanes} a lane" if lanes else "shared memory"
    want = 2 if n <= 64 else (4 if n <= 128 else 0)
    check(lanes == want, f"{what} at n = {n}: layout {layout}")
    f64 = dtype == torch.float64
    x, fk, it, st, nfev = kernel(max_iter)
    torch.cuda.synchronize()
    ties = torch.full_like(it, -1) if f64 else None
    xp, fp, itp, stp, nfevp = plain(max_iter, ties)
    tied = (ties >= 0) if f64 else torch.zeros_like(st, dtype=torch.bool)
    fin = torch.isfinite(x).all(-1) & torch.isfinite(xp).all(-1)
    rows = fin & ~tied
    err = (x - xp)[rows].abs().max().item() if bool(rows.any()) else 0.0
    same = [(a == b).float().mean().item()
            for a, b in ((st, stp), (it, itp), (nfev, nfevp))]
    conv, cp = ((v == 1).float().mean().item() for v in (st, stp))
    mi, mip = (v.float().median().item() for v in (it, itp))
    mf, mfp = fk.median().item(), fp.median().item()
    log(f"{what}, n = {n} ({layout}), {B} instances, {str(dtype)[6:]}, at "
        f"most {max_iter} iterations: status / iterations / trials equal "
        f"{same[0]:.4f} / {same[1]:.4f} / {same[2]:.4f}, max|dx| {err:.3g}"
        f", converged {conv:.4f} (plain {cp:.4f}), median iterations "
        f"{mi:.0f} (plain {mip:.0f}), median f {mf:.6g} (plain {mfp:.6g})"
        f"  [{card}]")
    if not f64:
        check(min(conv, cp) >= CONV_FLOOR and abs(conv - cp) <= CONV_ATOL,
              f"{what} at n = {n} (float32): converged {conv} vs plain {cp}")
        check(abs(mi - mip) <= MED_IT_RTOL * mip,
              f"{what} at n = {n} (float32): median iterations {mi} vs "
              f"plain {mip}")
        check(abs(mf - mfp) <= MED_F_RTOL * abs(mfp),
              f"{what} at n = {n} (float32): median f {mf} vs plain {mfp}")
        return 0.0
    check(torch.equal(st, stp),
          f"{what} at n = {n} (float64): status differs per instance")
    check(bool(((it == itp) & (nfev == nfevp))[~tied].all())
          and err <= K3_X_ATOL,
          f"{what} at n = {n} (float64): counts or x differ")
    check(torch.equal(fin, torch.isfinite(xp).all(-1)),
          f"{what} at n = {n} (float64): finite where plain is not")
    apart = ((it != itp) | (nfev != nfevp)
             | ((x - xp).abs().amax(-1) > K3_X_ATOL))[tied]
    for k in sorted(set(ties[tied].tolist()) - {0}):
        # the tied instances through the iterations before their decision
        held = ties == k
        xk, _, itk, stk, nfk = kernel(k)
        torch.cuda.synchronize()
        xq, _, itq, stq, nfq = plain(k)
        dk = (xk - xq)[held].abs().max().item()
        check(all(torch.equal(a[held], b[held]) for a, b in
                  ((stk, stq), (itk, itq), (nfk, nfq))) and dk <= K3_X_ATOL,
              f"{what} at n = {n} (float64): an instance whose first tie "
              f"is at iteration {k + 1} differs before it (max|dx| {dk})")
        err = max(err, dk)
    if bool(tied.any()):
        log(f"{what}, n = {n}: {int(tied.sum())} instances take a decision "
            f"within the rounding of a sum (first after "
            f"{int(ties[tied].min())} to {int(ties[tied].max())} "
            f"iterations), held step for step before it, max|dx| "
            f"{err:.3g}; {int(apart.sum())} of them take another path "
            f"after it")
    return err


def conv_atol(p, B):
    """Tolerance on the difference of two converged fractions near ``p``
    over ``B`` instances: CONV_ATOL, or three standard deviations of the
    difference of two independent binomial fractions where that is larger.
    Where converging is decided by float32 rounding per instance (K9 at
    config 2's inputs converges ~0.47: its 2-norm test at 1e-5 sits at
    float32's gradient noise near x* = 1), kernel and plain draw their
    outcomes independently, and 0.01 would be 0.45 standard deviations."""
    return max(CONV_ATOL, 3.0 * math.sqrt(2.0 * p * (1.0 - p) / B))


def whole_solve_slice(dev, card, tensors, sync_time):
    """Phases 30-32: the whole-solve kernels K7 (L-BFGS, the headline
    without its box), K8 (SPG + GLL, config 3) and K9 (dense BFGS, config
    2's inputs), each through its entry in ``ops``: float64 per instance
    against its plain version over the first iterations, the float32 full
    solve with every count at 0 against the plain version's, times, the
    bound and K3's time with its nearest method and search.  Returns the
    three entries of the ``kernels`` line."""
    import torch

    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import (fused_bfgs, fused_lbfgs,
                                                    fused_spg)

    counted = kernel_wrappers()
    rosen = problems.rosenbrock()
    c3, c7, c9 = WHOLE_K8, WHOLE_K7, WHOLE_K9
    n3 = c3["n"]
    box3 = (np.full(n3, -c3["box"]), np.full(n3, c3["box"]))
    data3 = (np.logspace(0, 3, n3), np.zeros(n3))
    # per kernel: entry, plain, its launch (with the kernel's counts),
    # objective, data, box, options, starts, capped iterations, K3's
    # nearest call, and the bound's operations per instance from the
    # kernel's counts (iterations, trials, updates)
    work = {
        "K7": dict(
            name="lbfgs_fused", file="lbfgs_fused.cu",
            replaces="optimization_solvers_tpu/ops/pallas_lbfgs.py:312",
            what="K7 (L-BFGS, the headline without its box)",
            entry=fused_lbfgs.lbfgs_solve_fused,
            plain=fused_lbfgs.lbfgs_solve_plain,
            launch=fused_lbfgs._launch_cuda, obj=rosen, data=(), box=(),
            kw=dict(m=c7["m"], tol=c7["tol"], max_iter=c7["max_iter"],
                    max_iter_ls=c7["max_iter_ls"], c1=1e-4),
            B=c7["B"], n=c7["n"], seed=42, lo_hi=(-2.0, 2.0),
            capped=WHOLE_K7_CAPPED,
            k3=lambda xs: solvers.batch_minimize(
                solvers.LBFGS(tol=c7["tol"], m=c7["m"]), ls.BackTracking(),
                make_oracle(rosen), xs, max_iter=c7["max_iter"],
                max_iter_ls=c7["max_iter_ls"]),
            k3_what="K3 LBFGS(m=5) + BackTracking",
            # two-loop 8mn, value-and-gradient 15n; per trial 8n
            ops=lambda n, its, tr, upd: its * (8 * c7["m"] * n + 15 * n)
            + tr * 8 * n),
        "K8": dict(
            name="spg_fused", file="spg_fused.cu",
            replaces="optimization_solvers_tpu/ops/pallas_spg.py:195",
            what="K8 (SPG + GLL, config 3)",
            entry=fused_spg.spg_solve_fused, plain=fused_spg.spg_solve_plain,
            launch=fused_spg._launch_cuda, obj=problems.weighted_squares(),
            data=data3, box=box3,
            kw=dict(tol=c3["tol"], max_iter=c3["max_iter"],
                    max_iter_ls=c3["max_iter_ls"], lam_min=1e-3,
                    lam_max=1e3, gll_m=10, c1=1e-4),
            B=c3["B"], n=n3, seed=3, lo_hi=(-2.0, 2.0),
            capped=WHOLE_K8_CAPPED,
            k3=lambda xs: minimize(
                problems.weighted_squares(), xs, method="spg",
                bounds=(-c3["box"], c3["box"]),
                data=tensors(*data3, dtype=torch.float32), tol=c3["tol"],
                policy="reference", max_iter=c3["max_iter"],
                max_iter_ls=c3["max_iter_ls"]),
            k3_what='K3 minimize(method="spg", policy="reference")',
            # the least work: per iteration the direction clip(x - lam g)
            # - x 5n, g.d 2n, the step's gradient 2n (its point and value
            # are the accepted trial's), the BB pair and s.y, s.s 6n and
            # the test |x - clip(x - g)| 6n; per trial the trial point and
            # its value 6n (an earlier count, 18n and 4n, left out the
            # trial point and the convergence test)
            ops=lambda n, its, tr, upd: its * 21 * n + tr * 6 * n),
        "K9": dict(
            name="bfgs_fused", file="bfgs_fused.cu",
            replaces="optimization_solvers_tpu/ops/pallas_bfgs.py:221",
            what="K9 (dense BFGS, config 2's inputs)",
            entry=fused_bfgs.bfgs_solve_fused,
            plain=fused_bfgs.bfgs_solve_plain,
            launch=fused_bfgs._launch_cuda, obj=rosen, data=(), box=(),
            kw=dict(tol=c9["tol"], max_iter=c9["max_iter"],
                    max_iter_ls=c9["max_iter_ls"], c1=1e-4),
            B=c9["B"], n=c9["n"], seed=42, lo_hi=(-2.0, 2.0),
            capped=WHOLE_K9_CAPPED,
            k3=lambda xs: solvers.batch_minimize(
                solvers.QuasiNewton(update="bfgs", tol=c9["tol"]),
                ls.BackTracking(), make_oracle(rosen), xs,
                max_iter=c9["max_iter"], max_iter_ls=c9["max_iter_ls"]),
            k3_what='K3 QuasiNewton(update="bfgs") + BackTracking',
            # B g 2n^2, value-and-gradient 15n; per update B y 2n^2 and
            # the rank-2 update 6n^2; per trial 8n
            ops=lambda n, its, tr, upd: its * (2 * n * n + 15 * n)
            + upd * 8 * n * n + tr * 8 * n),
    }

    entries = []
    for key, w in work.items():
        B, n, kw, what = w["B"], w["n"], w["kw"], w["what"]
        box = tensors(*w["box"], dtype=torch.float32)
        data = tensors(*w["data"], dtype=torch.float32)
        starts = np.random.RandomState(w["seed"]).uniform(*w["lo_hi"], (B, n))

        def plain(x, **extra):
            return w["plain"](w["obj"], x, *box, data, **dict(kw, **extra))

        # ---- float64 per instance over the first capped iterations: status
        # equal and x within the plain version's own spread under three
        # changes of x0 by 1e-15 relative (floored at WHOLE_X_FLOOR)
        boxd, datad = tensors(*w["box"]), tensors(*w["data"])
        capped = dict(kw, max_iter=w["capped"])
        (xd,) = tensors(starts)
        rk = w["launch"](w["obj"], xd, *boxd, datad, **capped)
        torch.cuda.synchronize()
        rp = w["plain"](w["obj"], xd, *boxd, datad, **capped)
        spread = 0.0
        for k in range(3):
            noise = np.random.RandomState(100 + k).standard_normal((B, n))
            (xq,) = tensors(starts * (1 + 1e-15 * noise))
            xq = w["plain"](w["obj"], xq, *boxd, datad, **capped)[0]
            spread = max(spread, (xq - rp[0]).abs().max().item())
        err = (rk[0] - rp[0]).abs().max().item()
        same = [(a == b).float().mean().item()
                for a, b in ((rk[3], rp[3]), (rk[2], rp[2]))]
        log(f"{key} vs plain f64 at {B} x {n}, {w['capped']} "
            f"iterations: status equal {same[0]:.5f}, iterations equal "
            f"{same[1]:.5f}, max|dx| {err:.3g}; plain vs plain with x0 moved "
            f"by 1e-15 relative: max|dx| {spread:.3g}")
        check(same[0] == 1.0, f"{key} f64: status differs")
        check(err <= max(spread, WHOLE_X_FLOOR),
              f"{key} f64: max|dx| {err} beyond the plain spread {spread}")

        # ---- the main path: float32 full solve through the entry
        (x,) = tensors(starts, dtype=torch.float32)
        for k in counted.values():
            k.launches = 0
        fused_bfgs.bfgs_solve_fused.placements = {"shared": 0, "workspace": 0}
        r, first_s = sync_time(lambda: w["entry"](w["obj"], x, *box, data,
                                                  **kw))
        counts = {name: k.launches for name, k in counted.items()}
        placements = (dict(fused_bfgs.bfgs_solve_fused.placements)
                      if key == "K9" else None)
        launches = counts[key]
        others = [v for name, v in counts.items() if name != key]
        conv = (r.status == 1).float().mean().item()
        med_f = r.f.median().item()
        log(f"{what} via ops.{w['entry'].__name__}: launches {counts}, "
            f"converged {conv:.4f}, median f {med_f:.4g}, median iterations "
            f"{r.iterations.float().median().item():.0f} (max "
            f"{r.iterations.max().item()}), first call {first_s:.3f} s")
        check(launches >= 1 and not any(others),
              f"{what}: launches {counts}, not {key} alone")
        if key == "K9":
            log(f"{what}: launches by placement {placements}")
            check(placements == {"shared": launches, "workspace": 0},
                  f"{what}: placements {placements}; the triangles must lie "
                  "in shared memory at this shape")
        check(r.x.shape == (B, n) and r.f.shape == (B,), f"{what}: shapes")
        check(bool(torch.isfinite(r.x).all() and torch.isfinite(r.f).all()),
              f"{what}: non-finite result")

        # the plain version's full solve on the same inputs, unless the
        # capped float32 run projects it past PLAIN_BUDGET_S
        _, t_cap = sync_time(lambda: plain(x, max_iter=w["capped"]))
        longest = r.iterations.max().item()
        if t_cap / w["capped"] * longest <= PLAIN_BUDGET_S:
            (_, fp, itp, stp), plain_s = sync_time(lambda: plain(x))
            cp = (stp == 1).float().mean().item()
            atol = conv_atol(cp, B)
            log(f"{what} plain on the card: converged {cp:.4f}, median f "
                f"{fp.median().item():.4g}, median iterations "
                f"{itp.float().median().item():.0f}, {plain_s:.3f} s; "
                f"converged fractions may differ by {atol:.4f}")
            check(abs(conv - cp) <= atol,
                  f"{what}: converged {conv} vs plain {cp}")
            if key == "K9":
                medians_agree(what, r, fp, itp, C2_MED_IT_RTOL,
                              C2_MED_F_RTOL, kernel=key)
            plain_ms = 1e3 * plain_s
        else:
            plain_ms = 1e3 * t_cap
            log(f"{what}: the plain full solve would exceed "
                f"{PLAIN_BUDGET_S:.0f} s; plain_ms is the {w['capped']}-"
                f"iteration run's, and the converged fractions are not "
                f"compared")

        # ---- times: CUDA events, median of 3 calls on distinct inputs;
        # K3's nearest method and search on the same inputs (no check)
        rng = np.random.RandomState(w["seed"] + 1000)
        kernel_ms, k3_ms, k3_conv = [], [], []
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        w["k3"](x)                     # warm-up
        for _ in range(3):
            (xs,) = tensors(rng.uniform(*w["lo_hi"], (B, n)),
                            dtype=torch.float32)
            for fn, times in ((lambda: w["entry"](w["obj"], xs, *box, data,
                                                  **kw), kernel_ms),
                              (lambda: w["k3"](xs), k3_ms)):
                torch.cuda.synchronize()
                start.record()
                out = fn()
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop))
            k3_conv.append((out.status == 1).float().mean().item())
        ms = statistics.median(kernel_ms)
        k3_med = statistics.median(k3_ms)
        log(f"{what}: kernel {ms:.3f} ms per call (median of 3, distinct "
            f"inputs; min {min(kernel_ms):.3f}, max {max(kernel_ms):.3f}), "
            f"{1e3 * B / ms:.0f} solves/s; plain {plain_ms:.0f} ms; "
            f"{w['k3_what']} {k3_med:.3f} ms (converged "
            f"{statistics.median(k3_conv):.4f})  [{card}]")

        # ---- bound from this run's counts on the main path's inputs: x0
        # (and the box and data) read once, x, f, iterations and status
        # written once
        counts_k = w["launch"](w["obj"], x, *box, data, **kw)
        its = counts_k[2].double().sum().item()
        trials = counts_k[4].double().sum().item()
        upd = counts_k[5].double().sum().item() if len(counts_k) > 5 else 0.0
        nbytes = 2 * B * n * 4 + 3 * B * 4 + n * 4 * (len(box) + len(data))
        bound_ms, bound_by = bound(nbytes,
                                   w["ops"](n, its, trials, upd) + B * 15 * n)
        log(f"{key} bound: {bound_ms:.4f} ms ({bound_by}); iterations "
            f"{its:.0f}, trials per iteration {trials / max(its, 1):.3f}"
            + (f", updates per iteration {upd / max(its, 1):.3f}"
               if key == "K9" else "") + f"; kernel {ms:.3f} ms  [{card}]")
        if key == "K7":
            # the SM time one instance-iteration takes, in the cycles of
            # one resident warp: time x SM clock x SMs x resident warps
            info = fused_lbfgs.kernel_info(torch.float32, B, n, kw["m"])
            mhz = sm_clock_mhz()
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            cycles = (ms * 1e-3 * mhz * 1e6 * sms * info["warps_per_sm"]
                      / max(its, 1))
            log(f"K7: {info['warps_per_sm']} resident warps per SM, "
                f"{info['registers']} registers, {info['local_bytes']} local "
                f"bytes a thread; {trials / max(its, 1):.3f} trials per "
                f"iteration, {cycles:.0f} cycles per instance-iteration "
                f"(kernel time x {mhz:.0f} MHz x {sms} SMs x resident warps "
                f"/ instance-iterations; tools/k7_phase_profile.py counts "
                f"them)  [{card}]")
        if key == "K9":
            # a direction pass per iteration, B y and the update's read and
            # write per update (this run's counts)
            mhz = sm_clock_mhz()
            stream = dense_slab_stream_bytes(n, 4, its, upd, upd)
            floor = dense_smem_floor_ms(n, 4, its, upd, upd, mhz)
            log(f"K9 slab passes: the earlier design streamed "
                f"{stream / 1e9:.3f} GB through device memory "
                f"({1e3 * stream / HBM_BYTES_PER_S:.3f} ms at 3.35 TB/s); "
                f"this design's shared-memory floor {floor:.4f} ms (132 SMs "
                f"x 128 B per clock at {mhz:.0f} MHz)  [{card}]")
        entries.append({
            "name": w["name"],
            "route": "cuda",
            "source": f"optimization_solvers_tpu_torch/ops/csrc/{w['file']}",
            "replaces": w["replaces"],
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "k3_ms": k3_med,
            "converged": conv,
            **({"placements": placements} if placements else {}),
        })
    return entries



def rosenbrock_diag(n):
    """The Rosenbrock Hessian's diagonal at x* = 1: 1200 - 400 + 2 = 802
    from term i, plus 200 from term i - 1."""
    d = np.full(n, 1002.0)
    d[0], d[-1] = 802.0, 200.0
    return d


def scaled_slice(dev, card, tensors, sync_time):
    """Phase 35: K1's scaled form (``Scaled<Obj>`` in ``lbfgsb_fused.cu``)
    through ``ops.lbfgsb_solve_fused_scaled``: the headline's inputs with
    the Rosenbrock Hessian's diagonal against the plain version, diag = 1
    against the unscaled kernel bit for bit, float64 per instance over the
    first iterations, and Jacobi preconditioning beside the unscaled
    kernel.  Returns the entry of the ``kernels`` line."""
    import torch

    from optimization_solvers_tpu_torch import ops, problems
    from optimization_solvers_tpu_torch.ops import fused_lbfgsb

    f = problems.rosenbrock()
    n, B = HEADLINE["n"], HEADLINE["B"]
    kw = dict(m=HEADLINE["m"], pgtol=HEADLINE["pgtol"],
              factr=HEADLINE["factr"], max_iter=HEADLINE["max_iter"])
    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (B, n))
    x0, lo, up, diag = tensors(starts, np.full(n, -BOX), np.full(n, BOX),
                               rosenbrock_diag(n), dtype=torch.float32)
    for k, v in fused_lbfgsb.kernel_info(torch.float32, B, n, HEADLINE["m"],
                                         scaled=True).items():
        log(f"  K1 scaled launch at the headline: {k} {v}")

    # ---- 35a. the main path: the scaled form at the headline
    r, first_s, launches = drive(
        "35a K1 scaled at the headline (diag = Rosenbrock's Hessian diagonal)",
        lambda: ops.lbfgsb_solve_fused_scaled(f, x0, lo, up, diag, **kw),
        "K1s", sync_time)
    conv = report("35a K1 scaled", r, first_s)
    s = torch.sqrt(diag)
    scaled = fused_lbfgsb.ScaledObjective(f, (), s)
    (_, fp, itp, stp), plain_s = sync_time(
        lambda: fused_lbfgsb.lbfgsb_solve_plain(scaled, x0 * s, lo * s,
                                                up * s, **kw))
    cp = (stp == 1).float().mean().item()
    log(f"35a plain on the card: converged {cp:.4f}, median f "
        f"{fp.median().item():.4g}, median iterations "
        f"{itp.float().median().item():.0f}, {plain_s:.3f} s  [{card}]")
    check(conv >= CONV_FLOOR, f"35a: converged {conv} < {CONV_FLOOR}")
    check(abs(conv - cp) <= CONV_ATOL, f"35a: converged {conv} vs plain {cp}")
    medians_agree("35a", r, fp, itp, C2_MED_IT_RTOL, C2_MED_F_RTOL,
                  kernel="K1 scaled")
    # CUDA events, the scaled and the unscaled kernel in turns, medians
    scaled_ms, unscaled_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for fn, times in (
                (lambda: ops.lbfgsb_solve_fused_scaled(f, x0, lo, up, diag,
                                                       **kw), scaled_ms),
                (lambda: ops.lbfgsb_solve_fused(f, x0, lo, up, **kw),
                 unscaled_ms)):
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
    ms, ms_unscaled = (statistics.median(v) for v in (scaled_ms,
                                                      unscaled_ms))
    ru = ops.lbfgsb_solve_fused(f, x0, lo, up, **kw)
    log(f"35a times (CUDA events, medians of 3 in turns): scaled {ms:.3f} "
        f"ms (median {r.iterations.float().median().item():.0f} "
        f"iterations), unscaled {ms_unscaled:.3f} ms (median "
        f"{ru.iterations.float().median().item():.0f}, converged "
        f"{(ru.status == 1).float().mean().item():.4f}), plain "
        f"{1e3 * plain_s:.1f} ms  [{card}]")
    # K1's bound (phase 4) plus the scaled form's divisions: z / s at each
    # coordinate of every evaluation and g / s of each gradient (3n per
    # iteration: a value-and-gradient and a value-only trial), and s read
    bound_ms, bound_by = bound(
        2 * B * n * 4 + 3 * n * 4 + 3 * B * 4,
        r.iterations.double().sum().item() * (18 * kw["m"] * n + 44 * n)
        + B * 17 * n)
    log(f"35a K1 scaled bound: {bound_ms:.4f} ms ({bound_by}); kernel "
        f"{ms:.3f} ms  [{card}]")

    # ---- 35b. diag = 1: the unscaled K1's numbers bit for bit
    one = torch.ones_like(diag)
    ra = ops.lbfgsb_solve_fused_scaled(f, x0, lo, up, one, **kw)
    same = [bool(torch.equal(a, b)) for a, b in zip(ra[:5], ru[:5])]
    log(f"35b diag = 1 against the unscaled K1, float32 headline: x, f, g, "
        f"iterations, status equal {same}")
    check(all(same), "35b: diag = 1 differs from the unscaled kernel")

    # ---- 35c. float64 per instance over the first iterations
    Bd = SCALED_F64_B
    xd, lod, upd, dd = tensors(starts[:Bd], np.full(n, -BOX),
                               np.full(n, BOX), rosenbrock_diag(n))
    sd = torch.sqrt(dd)
    capped = dict(kw, max_iter=SCALED_CAPPED)
    rk = ops.lbfgsb_solve_fused_scaled(f, xd, lod, upd, dd, **capped)
    torch.cuda.synchronize()
    plain_d = fused_lbfgsb.ScaledObjective(f, (), sd)

    def plain64(x):
        z, _, it, st = fused_lbfgsb.lbfgsb_solve_plain(
            plain_d, x * sd, lod * sd, upd * sd, **capped)
        return z / sd, it, st

    xp, itp, stp = plain64(xd)
    spread = 0.0
    for k in range(3):
        noise = np.random.RandomState(100 + k).standard_normal((Bd, n))
        (xq,) = tensors(starts[:Bd] * (1 + 1e-15 * noise))
        spread = max(spread, (plain64(xq)[0] - xp).abs().max().item())
    err = (rk.x - xp).abs().max().item()
    st_same = (rk.status == stp).float().mean().item()
    it_same = (rk.iterations == itp).float().mean().item()
    log(f"35c K1 scaled vs plain f64 at {Bd} x {n}, {SCALED_CAPPED} "
        f"iterations: status equal {st_same:.5f}, iterations equal "
        f"{it_same:.5f}, max|dx| {err:.3g}; plain vs plain with x0 moved by "
        f"1e-15 relative: max|dx| {spread:.3g}")
    check(st_same == 1.0, "35c: status differs")
    check(err <= max(spread, WHOLE_X_FLOOR),
          f"35c: max|dx| {err} beyond the plain spread {spread}")

    # ---- 35d. Jacobi preconditioning, beside the unscaled kernel
    j = JACOBI
    d = np.logspace(0, 6, j["n"])
    xj, loj, upj, dj, tj = tensors(
        np.random.RandomState(0).uniform(-2.0, 2.0, (j["B"], j["n"])),
        np.full(j["n"], -j["box"]), np.full(j["n"], j["box"]), d,
        np.zeros(j["n"]))
    ws = problems.weighted_squares()
    kwj = dict(m=5, pgtol=j["pgtol"], factr=j["factr"],
               max_iter=j["max_iter"])
    rj, tj_s = sync_time(lambda: ops.lbfgsb_solve_fused_scaled(
        ws, xj, loj, upj, dj, (dj, tj), **kwj))
    ruj, tu_s = sync_time(lambda: ops.lbfgsb_solve_fused(
        ws, xj, loj, upj, (dj, tj), **kwj))
    jconv = (rj.status == 1).float().mean().item()
    log(f"35d Jacobi, {j['B']} x {j['n']} float64, d = logspace(0, 6): "
        f"scaled converged {jconv:.4f}, iterations max "
        f"{rj.iterations.max().item()}, max f {rj.f.max().item():.3g}, "
        f"max|x| {rj.x.abs().max().item():.3g}, {1e3 * tj_s:.3f} ms; "
        f"unscaled converged {(ruj.status == 1).float().mean().item():.4f}, "
        f"median iterations {ruj.iterations.float().median().item():.0f} "
        f"(max {ruj.iterations.max().item()}), {1e3 * tu_s:.3f} ms  "
        f"[{card}]")
    check(jconv == 1.0, f"35d: converged {jconv}")
    check(rj.iterations.max().item() <= j["iters"],
          f"35d: {rj.iterations.max().item()} iterations")
    check(rj.f.max().item() < 1e-12, "35d: f >= 1e-12")
    check(rj.x.abs().max().item() < 1e-6, "35d: max|x| >= 1e-6")
    return {
        "name": "lbfgsb_fused_scaled",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb.py:993",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": 1e3 * plain_s,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def lockstep_lbfgsb_slice(dev, card, tensors, sync_time):
    """Phase 36: the lockstep L-BFGS-B (``solvers/lbfgsb.py``; no kernel) on
    the card through ``minimize(method="lbfgsb")``: the headline with a
    plain torch callable, ``ls_c2`` with the objective's kernel form, and a
    single float64 instance on the card against the CPU."""
    import torch

    from optimization_solvers_tpu_torch import minimize, problems

    no_kernel = partial(drive, kernel=None, sync_time=sync_time)

    n, B = HEADLINE["n"], LOCKSTEP_B
    (x0,) = tensors(np.random.RandomState(42).uniform(-2.0, 2.0, (B, n)),
                    dtype=torch.float32)
    kw = dict(bounds=(-BOX, BOX), tol=HEADLINE["pgtol"], m=HEADLINE["m"],
              factr=HEADLINE["factr"], max_iter=HEADLINE["max_iter"])

    # ---- 36a. a torch callable without a kernel form
    r, wall, _ = no_kernel(
        f"36a lockstep L-BFGS-B, {B} x Rosenbrock-{n} as a torch callable",
        lambda: minimize(rosen, x0, method="lbfgsb", **kw))
    conv = report("36a lockstep", r, wall)
    med_f = r.f.median().item()
    log(f"36a lockstep: {B / wall:.1f} solves/s, {int(r.iterations.max())} "
        f"lockstep iterations, {1e3 * wall / int(r.iterations.max()):.3f} ms "
        f"per lockstep iteration  [{card}]")
    check(conv >= CONV_FLOOR, f"36a: converged {conv} < {CONV_FLOOR}")
    check(med_f <= 1e-4, f"36a: median f {med_f} > 1e-4")
    capped = dict(kw, max_iter=LS_PROFILE_ITERS)
    _, wall_cap = sync_time(lambda: minimize(rosen, x0, method="lbfgsb",
                                             **capped))
    host_share(f"36a lockstep, first {LS_PROFILE_ITERS} iterations",
               lambda: minimize(rosen, x0, method="lbfgsb", **capped),
               wall_cap, card, sync_time)

    # ---- 36b. ls_c2 with the objective's kernel form: the lockstep solver,
    # over its first LS_PROFILE_ITERS iterations (the full solve took 23.5
    # s on an H100 at 700 W: the loop is host-bound, so a smaller batch
    # would not shorten it)
    rb, wall_b, _ = no_kernel(
        f"36b ls_c2 = 0.5, the headline's objective with its kernel form, "
        f"first {LS_PROFILE_ITERS} iterations",
        lambda: minimize(problems.rosenbrock(), x0, method="lbfgsb",
                         ls_c2=0.5, **capped))
    report("36b lockstep, ls_c2 = 0.5", rb, wall_b)
    check(bool((rb.iterations == LS_PROFILE_ITERS).any()),
          "36b: the capped run ended early")

    # ---- 36c. one float64 instance, on the card and on the CPU
    target = np.array([2.0, 3.0, 0.5])[np.arange(n) % 3]
    weight = np.linspace(1.0, 10.0, n)

    def shifted(x):
        c, w = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                for v in (target, weight))
        return torch.sum(w * (x - c) ** 2)

    kw1 = dict(bounds=(np.full(n, -np.inf), np.full(n, 1.0)), tol=1e-8,
               factr=10.0, max_iter=200)
    (x1,) = tensors(np.zeros(n))
    rc, _, _ = no_kernel("36c one float64 instance on the card",
                      lambda: minimize(shifted, x1, method="lbfgsb", **kw1))
    rh = minimize(shifted, x1.cpu(), method="lbfgsb", **kw1)
    dx = (rc.x.cpu() - rh.x).abs().max().item()
    log(f"36c card vs CPU: status {int(rc.status)} / {int(rh.status)}, "
        f"iterations {int(rc.iterations)} / {int(rh.iterations)}, f "
        f"{rc.f.item():.12g} / {rh.f.item():.12g}, max|dx| {dx:.3g}")
    check(rc.x.shape == (n,) and rc.x.device.type == "cuda", "36c: shape")
    check(int(rc.status) == int(rh.status) == 1, "36c: status")
    check(dx <= LOCKSTEP_1D_ATOL, f"36c: max|dx| {dx}")



def lockstep_newton_cg_slice(dev, card, tensors, sync_time):
    """Phase 37: the lockstep Newton-CG (``solvers/newton_cg.py``; no
    kernel) on the card through ``minimize(method="newton_cg")``: the
    Newton-CG headline with a plain torch callable, config 4 at full width,
    one float64 instance on the card against the CPU; and the template
    methods with objectives K3's chosen form does not compile."""
    import torch

    from _torch_geometries import lse_arrays
    from optimization_solvers_tpu_torch import minimize, problems

    no_kernel = partial(drive, kernel=None, sync_time=sync_time)
    lap = stopwatch()

    # ---- 37a. the Newton-CG headline with a torch callable
    n, B = HEADLINE["n"], HEADLINE["B"]
    (x0,) = tensors(np.random.RandomState(42).uniform(-2.0, 2.0, (B, n)),
                    dtype=torch.float32)
    kw = dict(bounds=(-BOX, BOX), tol=HEADLINE["pgtol"],
              max_iter=HEADLINE["max_iter"], cg_max=NEWTON_CG_MAX)
    r, wall, _ = no_kernel(
        f"37a lockstep Newton-CG, {B} x Rosenbrock-{n} as a torch callable",
        lambda: minimize(rosen, x0, method="newton_cg", **kw))
    conv = report("37a lockstep Newton-CG", r, wall)
    med_f = r.f.median().item()
    its = int(r.iterations.max())
    log(f"37a lockstep Newton-CG: {B / wall:.1f} solves/s, {its} lockstep "
        f"iterations, {1e3 * wall / its:.3f} ms per lockstep iteration  "
        f"[{card}]")
    check(conv >= CONV_FLOOR, f"37a: converged {conv} < {CONV_FLOOR}")
    check(med_f <= 1e-4, f"37a: median f {med_f} > 1e-4")
    capped = dict(kw, max_iter=NCG_PROFILE_ITERS)
    _, wall_cap = sync_time(lambda: minimize(rosen, x0, method="newton_cg",
                                             **capped))
    host_share(f"37a lockstep Newton-CG, first {NCG_PROFILE_ITERS} "
               f"iterations", lambda: minimize(rosen, x0, method="newton_cg",
                                               **capped),
               wall_cap, card, sync_time)

    lap("37a")

    # ---- 37b. config 4 at full width: past K4's shared memory
    c = CONFIG4
    B4, n4 = c["B"], c["n"]
    A64, b64 = lse_arrays(n4, c["rows"])
    lse = problems.log_sum_exp(*tensors(A64, b64, dtype=torch.float32))
    starts = np.random.RandomState(4).uniform(-0.5, 0.5, (B4, n4))
    (x4,) = tensors(starts, dtype=torch.float32)
    r4, wall4, _ = no_kernel(
        f"37b lockstep Newton-CG, config 4 ({B4} x {n4}, {c['rows']} rows)",
        lambda: minimize(lse, x4, method="newton_cg",
                         bounds=(-C4_BOX, C4_BOX), tol=c["pgtol"],
                         factr=c["factr"], max_iter=c["max_iter"]))
    conv4 = report("37b lockstep Newton-CG config 4", r4, wall4)
    log(f"37b lockstep Newton-CG config 4: {B4 / wall4:.1f} solves/s, "
        f"{1e3 * wall4 / int(r4.iterations.max()):.3f} ms per lockstep "
        f"iteration  [{card}]")
    check(conv4 >= CONV_FLOOR, f"37b: converged {conv4} < {CONV_FLOOR}")
    for i in range(SCIPY_ROWS):
        fs = lse_scipy(A64, b64, starts[i], C4_BOX, c)
        e32 = abs(r4.f[i].item() - fs) / abs(fs)
        log(f"37b instance {i} vs scipy f64 (f {fs:.10g}): lockstep "
            f"Newton-CG f32 rel {e32:.3g}")
        check(e32 <= C4_NCG_F32_RTOL,
              f"37b instance {i}: f vs scipy {e32} > {C4_NCG_F32_RTOL}")

    lap("37b")

    # ---- 37c. one float64 instance, on the card and on the CPU
    A1, b1 = lse_arrays(NCG_1D["n"], NCG_1D["rows"])
    lse1 = problems.log_sum_exp(*tensors(A1, b1))
    (x1,) = tensors(np.random.RandomState(6).uniform(-0.5, 0.5, NCG_1D["n"]))
    kw1 = dict(bounds=(-NCG_1D["box"], NCG_1D["box"]), tol=1e-8,
               max_iter=200)
    rc, _, _ = no_kernel("37c one float64 log-sum-exp instance on the card",
                      lambda: minimize(lse1, x1, method="newton_cg", **kw1))
    lse_cpu = problems.log_sum_exp(*(torch.as_tensor(v) for v in (A1, b1)))
    rh = minimize(lse_cpu, x1.cpu(), method="newton_cg", **kw1)
    dx = (rc.x.cpu() - rh.x).abs().max().item()
    log(f"37c card vs CPU: status {int(rc.status)} / {int(rh.status)}, "
        f"iterations {int(rc.iterations)} / {int(rh.iterations)}, f "
        f"{rc.f.item():.12g} / {rh.f.item():.12g}, max|dx| {dx:.3g}")
    check(rc.x.shape == (NCG_1D["n"],) and rc.x.device.type == "cuda",
          "37c: shape")
    check(int(rc.status) == int(rh.status) == 1, "37c: status")
    check(dx <= LOCKSTEP_1D_ATOL, f"37c: max|dx| {dx}")

    lap("37c")

    # ---- 37d. the template methods with objectives K3's chosen form does
    # not compile run the lockstep loop on the card
    rp = REPAIR
    (xb,) = tensors(np.random.RandomState(8).uniform(-2.0, 2.0,
                                                     (rp["B"], rp["n"])),
                    dtype=torch.float32)
    rb, wall_b, _ = no_kernel(
        f"37d minimize(torch callable, method='bfgs'), {rp['B']} x "
        f"Rosenbrock-{rp['n']}, first {rp['max_iter']} iterations",
        lambda: minimize(rosen, xb, method="bfgs", max_iter=rp["max_iter"]))
    report("37d bfgs with a torch callable", rb, wall_b)
    Al, bl = lse_arrays(rp["lse_n"], rp["lse_rows"])
    lsel = problems.log_sum_exp(*tensors(Al, bl, dtype=torch.float32))
    (xl,) = tensors(np.random.RandomState(9).uniform(
        -0.5, 0.5, (rp["B"] // 4, rp["lse_n"])), dtype=torch.float32)
    rl, wall_l, _ = no_kernel(
        f"37d minimize(log_sum_exp, method='gd'), {rp['B'] // 4} x "
        f"{rp['lse_n']}, first {rp['max_iter']} iterations (K3's first-order "
        f"form compiles Rosenbrock and weighted squares)",
        lambda: minimize(lsel, xl, method="gd", max_iter=rp["max_iter"]))
    report("37d gd with a log-sum-exp", rl, wall_l)
    for what, res in (("bfgs", rb), ("gd", rl)):
        check(res.x.device.type == "cuda", f"37d {what}: x left the card")
    lap("37d")


def lse_second_order_slice(dev, card, tensors, sync_time):
    """Phases 38-39: the log-sum-exp's second-order functors on the card.
    K4 (phase 38) and K3's Newton form (phase 39) against their plain
    versions in float64 per instance, full float32 solves through
    ``minimize`` with times and bounds, the scipy anchor.  Returns their
    entries of the ``kernels`` line."""
    import torch

    from _torch_geometries import lse_arrays
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.ops import (fused_driver,
                                                    fused_newton_cg)

    lap = stopwatch()

    # ---- 38. K4 on the log-sum-exp
    g = K4_LSE
    B, n, rows = g["B"], g["n"], g["rows"]
    c4 = CONFIG4
    A64, b64 = lse_arrays(n, rows)
    starts = np.random.RandomState(4).uniform(-0.5, 0.5, (B, n))
    kw = dict(pgtol=c4["pgtol"], factr=c4["factr"], max_iter=c4["max_iter"],
              cg_max=g["cg_max"], max_iter_ls=25, c1=1e-4)
    plain = fused_newton_cg.newton_cg_solve_plain
    lse64 = problems.log_sum_exp(*tensors(A64, b64))
    x0d, lod, upd = tensors(starts, np.full(n, -g["box"]),
                            np.full(n, g["box"]))
    noise = tensors(np.random.RandomState(100).standard_normal((B, n)))[0]
    # the short horizon, held per instance: x, f, iterations, status, HVPs
    # and trials
    short = dict(kw, **K4_LSE_SHORT)
    ks = fused_newton_cg._launch_cuda(lse64, x0d, lod, upd, (), **short)
    torch.cuda.synchronize()
    ps = plain(lse64, x0d, lod, upd, **short)
    qs = plain(lse64, x0d * (1 + 1e-15 * noise), lod, upd, **short)
    same = [(a == b).float().mean().item() for a, b in zip(ks[2:], ps[2:])]
    short_dx = (ks[0] - ps[0]).abs().max().item()
    log(f"38 K4 vs plain f64, log-sum-exp {B} x {n} ({rows} rows), "
        f"{short['max_iter']} iterations of at most {short['cg_max']} CG "
        f"steps: iterations / status / HVPs / trials equal "
        f"{' / '.join(f'{v:.5f}' for v in same)}, max|dx| {short_dx:.3g} "
        f"(plain vs plain with x0 moved by 1e-15 relative: "
        f"{(qs[0] - ps[0]).abs().max().item():.3g}), HVPs per instance "
        f"{ps[4].float().mean().item():.3f}, trials per instance "
        f"{ps[5].float().mean().item():.3f}")
    check(all(v == 1.0 for v in same),
          "38 K4 f64 short horizon: iterations, status, HVPs or trials "
          "differ")
    check(short_dx <= K4_LSE_SHORT_ATOL,
          f"38 K4 f64 short horizon: max|dx| {short_dx} > "
          f"{K4_LSE_SHORT_ATOL}")
    # past the short horizon, n > rows: A's null space makes CG amplify
    # rounding (32 steps a Newton step on a singular system; after 8
    # iterations the plain version's first instances solved alone differ
    # from its batch, tools/k4_lse_horizon.py), so the float64 full solves
    # are held by status, f and the total counts (x is not unique along A's
    # null space)
    lap("38 float64 short horizon")
    rows64 = slice(0, C4_F64_ROWS)
    _, f64k, it64k, st64k, ncg64k, _ = fused_newton_cg._launch_cuda(
        lse64, x0d[rows64], lod, upd, (), **kw)
    torch.cuda.synchronize()
    _, f64p, it64p, st64p, ncg64p, _ = plain(lse64, x0d[rows64], lod, upd,
                                             **kw)
    f_rel = ((f64k - f64p).abs() / f64p.abs()).max().item()
    totals = [(int(a.sum()), int(b.sum()))
              for a, b in ((it64k, it64p), (ncg64k, ncg64p))]
    count_rel = max(abs(a - b) / b for a, b in totals)
    log(f"38 K4 vs plain f64 full solves, {C4_F64_ROWS} instances: status "
        f"equal {bool((st64k == st64p).all())}, converged "
        f"{(st64k == 1).float().mean().item():.4f}, max rel |df| {f_rel:.3g}, "
        f"iterations {totals[0][0]} / {totals[0][1]}, HVPs {totals[1][0]} / "
        f"{totals[1][1]} (kernel / plain)")
    check(bool((st64k == st64p).all()), "38 K4 f64 full: status differs")
    check(f_rel <= K4_LSE_F64_RTOL,
          f"38 K4 f64 full: rel |df| {f_rel} > {K4_LSE_F64_RTOL}")
    check(count_rel <= K4_LSE_COUNT_RTOL,
          f"38 K4 f64 full: iterations or HVPs {totals} differ by "
          f"{count_rel} > {K4_LSE_COUNT_RTOL}")
    max_err = short_dx
    # float64 full solves on the anchor's instances
    r64 = fused_newton_cg.newton_cg_solve_fused(
        lse64, x0d[:SCIPY_ROWS], lod, upd, **kw)
    lap("38 float64 full solves")

    lse32 = problems.log_sum_exp(*tensors(A64, b64, dtype=torch.float32))
    x0, lo, up = tensors(starts, np.full(n, -g["box"]), np.full(n, g["box"]),
                         dtype=torch.float32)

    def solve(xs):
        return minimize(lse32, xs, method="newton_cg",
                        bounds=(-g["box"], g["box"]), tol=c4["pgtol"],
                        factr=c4["factr"], max_iter=c4["max_iter"],
                        cg_max=g["cg_max"])

    r, wall, launches = drive("38 K4 log-sum-exp via minimize",
                              lambda: solve(x0), "K4", sync_time)
    conv = report("38 K4 log-sum-exp f32", r, wall)
    (_, fp, itp, stp, _, _), plain_wall = sync_time(
        lambda: plain(lse32, x0, lo, up, **kw))
    cp = (stp == 1).float().mean().item()
    log(f"38 plain on the card: converged {cp:.4f}, median f "
        f"{fp.median().item():.7g}, median iterations "
        f"{itp.float().median().item():.0f}, {plain_wall:.3f} s")
    check(conv >= CONV_FLOOR, f"38: converged {conv} < {CONV_FLOOR}")
    check(abs(conv - cp) <= CONV_ATOL, f"38: converged {conv} vs plain {cp}")
    for i in range(SCIPY_ROWS):
        fs = lse_scipy(A64, b64, starts[i], g["box"], c4)
        e64 = abs(r64.f[i].item() - fs) / abs(fs)
        e32 = abs(r.f[i].item() - fs) / abs(fs)
        log(f"38 instance {i} vs scipy f64 (f {fs:.10g}): K4 f64 rel "
            f"{e64:.3g}, K4 f32 rel {e32:.3g}")
        check(e64 <= SCIPY_RTOL_F64, f"38 instance {i}: K4 f64 vs scipy {e64}")
        check(e32 <= C4_F32_RTOL, f"38 instance {i}: K4 f32 vs scipy {e32}")
    lap("38 float32 solves and the scipy anchor")
    walls = [sync_time(lambda: solve(x0))[1] for _ in range(3)]
    k4_ms = 1e3 * statistics.median(walls)
    # bound from the kernel's own counts on these inputs: x0, A, b and the
    # bounds read once, x, f, iterations and status written once; per HVP
    # A v and A^T w (4 rows n), per trial A x and A^T p (2 rows n for the
    # value, the gradient's pass counted with it: 4 rows n would double it)
    _, _, itk, _, ncgk, nfevk = fused_newton_cg._launch_cuda(
        lse32, x0, lo, up, (), **kw)
    k4_bound, k4_by = bound(
        2 * B * n * 4 + rows * n * 4 + rows * 4 + 2 * n * 4 + 3 * B * 4,
        rows * n * (4 * ncgk.double().sum().item()
                    + 2 * nfevk.double().sum().item()))
    log(f"38 K4 log-sum-exp via minimize: {k4_ms:.2f} ms per call (median of "
        f"3), {B / (k4_ms / 1e3):.1f} solves/s; plain {1e3 * plain_wall:.0f} "
        f"ms; bound {k4_bound:.4f} ms ({k4_by}); HVPs per iteration "
        f"{ncgk.sum().item() / itk.sum().item():.3f}, trials per iteration "
        f"{nfevk.sum().item() / itk.sum().item():.3f}  [{card}]")
    k4 = {
        "name": "newton_cg",
        "functor": "LOG_SUM_EXP",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/newton_cg.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_newton_cg.py:340",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k4_ms,
        "plain_ms": 1e3 * plain_wall,
        "bound_ms": k4_bound,
        "bound_by": k4_by,
        "library_ms": None,
    }
    lap("38 times")

    # ---- 39. K3's Newton form on the log-sum-exp
    g = K3_LSE
    B, n, rows = g["B"], g["n"], g["rows"]
    pn = solvers.ProjectedNewton(grad_tol=g["tol"])
    btb = ls.BackTrackingB()
    kw3 = dict(max_iter=g["max_iter"], max_iter_ls=g["max_iter_ls"])
    k3_err = 0.0
    for what, shape in (("full rank", g), ("singular", K3_LSE_SINGULAR)):
        Bc, nc, rc = shape["B"], shape["n"], shape["rows"]
        A, b = lse_arrays(nc, rc)
        lse = problems.log_sum_exp(*tensors(A, b))
        xs, los, ups = tensors(
            np.random.RandomState(5).uniform(-0.5, 0.5, (Bc, nc)),
            np.full(nc, -g["box"]), np.full(nc, g["box"]))
        _, bad = fused_driver._cholesky_plain(
            lse.hessian(xs), fused_driver.QN_EPS[torch.float64])
        log(f"39 {what} ({nc} columns, {rc} rows): the plain factor at x0 "
            f"collapses on {bad.float().mean().item():.4f} of the instances")
        if what == "singular":
            check(bool(bad.all()), "39 singular: a factor did not collapse")
        # the trials of a few instances' last step are decided by rounding
        # (1.2% of the full-rank batch in the first run on an H100):
        # printed, not held
        k3_err = max(k3_err, k3_per_instance(
            f"39 PN + BackTrackingB log-sum-exp, {what}", pn, btb, lse, xs,
            los, ups, (), dict(kw3, max_iter=K3_LSE_CAPPED), tensors,
            trials=False))
    lap("39 float64 per instance")

    A, b = lse_arrays(n, rows)
    lse32 = problems.log_sum_exp(*tensors(A, b, dtype=torch.float32))
    x0, lo, up = tensors(np.random.RandomState(5).uniform(-0.5, 0.5, (B, n)),
                         np.full(n, -g["box"]), np.full(n, g["box"]),
                         dtype=torch.float32)

    def solve3(xs):
        return minimize(lse32, xs, method="pn", bounds=(-g["box"], g["box"]),
                        tol=g["tol"], **kw3)

    r, wall, launches3 = k3_main_path("39 K3 Newton form log-sum-exp via "
                                      "minimize", solve3, x0, B, n, sync_time)
    conv = report("39 K3 Newton form log-sum-exp f32", r, wall)
    (_, fp, itp, stp, _), plain_wall = sync_time(
        lambda: fused_driver.fused_minimize_plain(pn, btb, lse32, x0, lo, up,
                                                  (), **kw3))
    cp = (stp == 1).float().mean().item()
    log(f"39 plain on the card: converged {cp:.4f}, median f "
        f"{fp.median().item():.7g}, median iterations "
        f"{itp.float().median().item():.0f}, {plain_wall:.3f} s")
    check(conv >= CONV_FLOOR, f"39: converged {conv} < {CONV_FLOOR}")
    check(abs(conv - cp) <= CONV_ATOL, f"39: converged {conv} vs plain {cp}")
    walls = [sync_time(lambda: solve3(x0))[1] for _ in range(3)]
    k3_ms = 1e3 * statistics.median(walls)
    # bound from this run's counts: x0, A, b and the bounds read once, x, f,
    # iterations, status and trials written once; per iteration the
    # Hessian's upper triangle of A^T diag(p) A (rows n (n + 1)) and the
    # strips scaled by p (rows n), its factorization (n^3 / 3), one solve
    # (2 n^2) and the value and gradient at the new point (4 rows n); per
    # trial the value (2 rows n); the first value and gradient
    spec = fused_driver.build_spec(pn, btb)
    nfev = fused_driver._launch_cuda(spec, lse32, x0, lo, up, (), **kw3)[4]
    its = r.iterations.double().sum().item()
    k3_bound, k3_by = bound(
        2 * B * n * 4 + rows * n * 4 + rows * 4 + 2 * n * 4 + 4 * B * 4,
        its * (rows * n * (n + 1) + rows * n + n ** 3 / 3 + 2 * n * n
               + 4 * rows * n)
        + nfev.double().sum().item() * 2 * rows * n + B * 4 * rows * n)
    log(f"39 K3 Newton form log-sum-exp via minimize: {k3_ms:.2f} ms per call "
        f"(median of 3), {B / (k3_ms / 1e3):.1f} solves/s, "
        f"{k3_ms / max(1.0, r.iterations.float().median().item()):.2f} ms "
        f"per Newton iteration; plain {1e3 * plain_wall:.0f} ms; bound "
        f"{k3_bound:.4f} ms ({k3_by})  [{card}]")
    k3 = {
        "name": "driver_newton",
        "form": "Newton",
        "functor": "LOG_SUM_EXP",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/driver_newton.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_driver.py:1874",
        "launches": launches3,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": 1e3 * plain_wall,
        "bound_ms": k3_bound,
        "bound_by": k3_by,
        "library_ms": None,
    }
    lap("39 float32 solves and times")
    return k4, k3


def held_per_instance(what, kernel, plain, x0d, tensors):
    """float64, the kernel's ``(x, f, iterations, status, ...)`` against the
    plain version's on ``x0d``, as phases 30-32 hold K7-K9: status equal on
    every instance, and x within the plain version's own spread under three
    1e-15 relative changes of x0 (the largest move of any instance),
    floored at WHOLE_X_FLOOR.  Returns max |dx|."""
    import torch

    k = kernel(x0d)
    torch.cuda.synchronize()
    p = plain(x0d)
    spread = 0.0
    for j in range(3):
        noise = tensors(np.random.RandomState(100 + j).standard_normal(
            tuple(x0d.shape)))[0]
        q = plain(x0d * (1 + 1e-15 * noise))
        spread = max(spread, (q[0] - p[0]).abs().max().item())
    same = [(a == b).float().mean().item()
            for a, b in ((k[3], p[3]), (k[2], p[2]))]
    err = (k[0] - p[0]).abs().max().item()
    log(f"{what} vs plain f64, {x0d.shape[0]} x {x0d.shape[1]}: status equal "
        f"{same[0]:.5f}, iterations equal {same[1]:.5f}, max|dx| {err:.3g} "
        f"(plain vs plain with x0 moved by 1e-15 relative: {spread:.3g}), "
        f"converged {(p[3] == 1).float().mean().item():.4f}")
    check(same[0] == 1.0, f"{what} f64: status differs")
    check(err <= max(spread, WHOLE_X_FLOOR),
          f"{what} f64: max|dx| {err} beyond the plain spread {spread}")
    return err


def data_entry(name, form, functor, source, replaces, launches, err, ms,
               plain_ms, bound_ms, bound_by, **extra):
    return {"name": name, "form": form, "functor": functor, "route": "cuda",
            "source": f"optimization_solvers_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra}


def data_functors_slice(dev, card, tensors, sync_time):
    """Phases 40-42: the quadratic and log-sum-exp functors of K1 (through
    ``minimize(method="lbfgsb")``), of K3's quasi-Newton, Wolfe and dense
    forms (through ``solvers.batch_minimize``) and of K9 (through
    ``ops.bfgs_solve_fused``), each held against its plain version on the
    card and its route shown by launch counts.  Returns their entries of
    the ``kernels`` line."""
    import torch

    from _torch_geometries import config5_hessian, lse_arrays
    from optimization_solvers_tpu_torch import (linesearch as ls, minimize,
                                                problems, solvers)
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import (fused_bfgs, fused_driver,
                                                    fused_lbfgsb,
                                                    fused_lbfgsb_tall)

    lap = stopwatch()
    K1 = fused_lbfgsb.lbfgsb_solve_fused
    plain1 = fused_lbfgsb.lbfgsb_solve_plain
    ls1 = dict(max_iter_ls=20, c1=1e-3)     # minimize's, as the plain call's

    def k1_raw(obj, x, lo, up, **kw):
        """K1's launch: (x, f, iterations, status) as the plain version."""
        return fused_lbfgsb._launch_cuda(obj, x, lo, up, (), **ls1, **kw)

    f32 = torch.float32
    entries = []
    c4 = CONFIG4
    K1_SRC = ("lbfgsb_fused", "lbfgsb_fused.cu",
              "optimization_solvers_tpu/ops/pallas_lbfgsb.py:938")

    # ---- 40a. K1 on the log-sum-exp at phase 38's shape, config 4's
    # settings
    g = K1_LSE
    B, n, rows, box = g["B"], g["n"], g["rows"], g["box"]
    kw = dict(m=c4["m"], pgtol=c4["pgtol"], factr=c4["factr"],
              max_iter=c4["max_iter"])
    A64, b64 = lse_arrays(n, rows)
    starts = np.random.RandomState(4).uniform(-0.5, 0.5, (B, n))
    lse64 = problems.log_sum_exp(*tensors(A64, b64))
    x0d, lod, upd = tensors(starts, np.full(n, -box), np.full(n, box))
    capped = dict(kw, max_iter=K1_DATA_CAPPED)
    err_lse = held_per_instance(
        f"40a K1 log-sum-exp, {K1_DATA_CAPPED} iterations",
        lambda x: k1_raw(lse64, x, lod, upd, **capped),
        lambda x: plain1(lse64, x, lod, upd, **capped), x0d[:C4_F64_ROWS],
        tensors)
    r64 = K1(lse64, x0d[:SCIPY_ROWS], lod, upd, **kw)
    lap("40a float64")
    lse32 = problems.log_sum_exp(*tensors(A64, b64, dtype=f32))
    x0, lo, up = tensors(starts, np.full(n, -box), np.full(n, box), dtype=f32)

    def solve(xs):
        return minimize(lse32, xs, method="lbfgsb", bounds=(-box, box),
                        tol=c4["pgtol"], m=c4["m"], factr=c4["factr"],
                        max_iter=c4["max_iter"])

    r, wall, launches = drive("40a K1 log-sum-exp via minimize",
                              lambda: solve(x0), "K1", sync_time)
    conv = report("40a K1 log-sum-exp f32", r, wall)
    (_, fp, itp, stp), plain_s = sync_time(
        lambda: plain1(lse32, x0, lo, up, **kw))
    cp = (stp == 1).float().mean().item()
    log(f"40a plain on the card: converged {cp:.4f}, median f "
        f"{fp.median().item():.7g}, median iterations "
        f"{itp.float().median().item():.0f}, {plain_s:.3f} s")
    check(conv >= CONV_FLOOR, f"40a: converged {conv} < {CONV_FLOOR}")
    check(abs(conv - cp) <= CONV_ATOL, f"40a: converged {conv} vs plain {cp}")
    for i in range(SCIPY_ROWS):
        fs = lse_scipy(A64, b64, starts[i], box, c4)
        e64 = abs(r64.f[i].item() - fs) / abs(fs)
        e32 = abs(r.f[i].item() - fs) / abs(fs)
        log(f"40a instance {i} vs scipy f64 (f {fs:.10g}): K1 f64 rel "
            f"{e64:.3g}, K1 f32 rel {e32:.3g}")
        check(e64 <= SCIPY_RTOL_F64, f"40a instance {i}: K1 f64 vs scipy {e64}")
        check(e32 <= C4_F32_RTOL, f"40a instance {i}: K1 f32 vs scipy {e32}")
    lap("40a float32 and the scipy anchor")
    # K1 through minimize against K2 (the route before) on the same inputs,
    # in turns
    k2 = fused_lbfgsb_tall.lbfgsb_solve_fused_tall
    t_k1, t_k2 = [], []
    for _ in range(2):
        t_k1.append(event_ms(lambda: solve(x0), 1))
        t_k2.append(event_ms(lambda: k2(lse32, x0, lo, up, **kw), 1))
    ms = statistics.median(t_k1)
    its = r.iterations.double().sum().item()
    # bound: x0, A, b and the box read once, x, f, iterations and status
    # written once; the least work: a value and gradient (4 rows n) at x0
    # and per iteration, and the interior path's algebra (18 m n)
    b_ms, b_by = bound(
        2 * B * n * 4 + rows * n * 4 + rows * 4 + 2 * n * 4 + 3 * B * 4,
        (its + B) * 4 * rows * n + its * 18 * c4["m"] * n)
    info = fused_lbfgsb.kernel_info(f32, B, n, c4["m"], "LOG_SUM_EXP",
                                    rows=rows)
    log(f"40a K1 log-sum-exp via minimize: {ms:.2f} ms per call (in turns "
        f"with K2: K1 {', '.join(f'{t:.2f}' for t in t_k1)}, K2 "
        f"{', '.join(f'{t:.2f}' for t in t_k2)} ms), {B / (ms / 1e3):.1f} "
        f"solves/s; plain {1e3 * plain_s:.0f} ms; bound {b_ms:.4f} ms "
        f"({b_by}); {info['warps_per_sm']} warps per SM, "
        f"{info['registers']} registers, {info['local_bytes']} local bytes  "
        f"[{card}]")
    entries.append(data_entry(
        K1_SRC[0], "whole solve", "LOG_SUM_EXP", K1_SRC[1], K1_SRC[2],
        launches, err_lse, ms, 1e3 * plain_s, b_ms, b_by,
        k2_ms=statistics.median(t_k2)))
    lap("40a times")

    # ---- 40b. K1 on config 5's quadratic
    g = K1_QUAD
    B, n, box = g["B"], g["n"], g["box"]
    Qm = config5_hessian(n)
    kwq = dict(m=g["m"], pgtol=g["pgtol"], factr=g["factr"],
               max_iter=g["max_iter"])
    startsq = np.random.RandomState(5).uniform(-2.0, 2.0, (B, n))
    q64 = problems.quadratic(*tensors(Qm, np.zeros(n)))
    xqd, loqd, upqd = tensors(startsq, np.full(n, -box), np.full(n, box))
    cappedq = dict(kwq, max_iter=K1_DATA_CAPPED)
    err_q = held_per_instance(
        f"40b K1 quadratic, {K1_DATA_CAPPED} iterations",
        lambda x: k1_raw(q64, x, loqd, upqd, **cappedq),
        lambda x: plain1(q64, x, loqd, upqd, **cappedq), xqd, tensors)
    q32 = problems.quadratic(*tensors(Qm, np.zeros(n), dtype=f32))
    xq, loq, upq = tensors(startsq, np.full(n, -box), np.full(n, box),
                           dtype=f32)

    def solve_q(xs):
        return minimize(q32, xs, method="lbfgsb", bounds=(-box, box),
                        tol=g["pgtol"], m=g["m"], factr=g["factr"],
                        max_iter=g["max_iter"])

    rq, wallq, launchesq = drive("40b K1 quadratic via minimize",
                                 lambda: solve_q(xq), "K1", sync_time)
    convq = report("40b K1 quadratic f32", rq, wallq)
    max_x = rq.x.abs().max().item()
    (_, _, _, stq), plain_q = sync_time(
        lambda: plain1(q32, xq, loq, upq, **kwq))
    log(f"40b: max|x| {max_x:.3g} (x* = 0); plain converged "
        f"{(stq == 1).float().mean().item():.4f}, {plain_q:.3f} s")
    check(convq >= CONV_FLOOR, f"40b: converged {convq} < {CONV_FLOOR}")
    check(max_x <= C5_X_ATOL, f"40b: max|x| {max_x} > {C5_X_ATOL}")
    msq = event_ms(lambda: solve_q(xq), 3)
    itsq = rq.iterations.double().sum().item()
    # the least work of a value and gradient of this symmetric Q: Q x once,
    # 2 n^2 (the kernel forms Q x and Q^T x, 4 n^2); Q read once
    bq_ms, bq_by = bound(
        2 * B * n * 4 + n * n * 4 + n * 4 + 2 * n * 4 + 3 * B * 4,
        (itsq + B) * 2 * n * n + itsq * 18 * g["m"] * n)
    log(f"40b K1 quadratic via minimize: {msq:.2f} ms per call (CUDA events, "
        f"3 calls); plain {1e3 * plain_q:.0f} ms; bound {bq_ms:.4f} ms ({bq_by})"
        f"  [{card}]")
    entries.append(data_entry(
        K1_SRC[0], "whole solve", "QUADRATIC", K1_SRC[1], K1_SRC[2],
        launchesq, err_q, msq, 1e3 * plain_q, bq_ms, bq_by))
    lap("40b")

    # ---- 41. K3's quasi-Newton, Wolfe and dense forms through
    # solvers.batch_minimize
    d3 = K3_DATA
    gl, gq = d3["lse"], d3["quad"]
    A, b = lse_arrays(gl["n"], gl["rows"])
    lse3 = {dt: problems.log_sum_exp(*tensors(A, b, dtype=dt))
            for dt in (torch.float64, f32)}
    quad3 = {dt: problems.quadratic(*tensors(config5_hessian(gq["n"]),
                                             np.zeros(gq["n"]), dtype=dt))
             for dt in (torch.float64, f32)}
    forms = {"L-BFGS + Hager-Zhang": ("quasi-Newton", "driver_qn_data.cu"),
             "NCG + More-Thuente": ("Wolfe", "driver_qn_data.cu"),
             "BFGS + More-Thuente": ("dense", "driver_dense.cu")}

    def methods(tol, dt):
        aw = dt == f32    # minimize's float32 policy for More-Thuente
        return {"L-BFGS + Hager-Zhang": (solvers.LBFGS(tol=tol),
                                         ls.HagerZhang()),
                "NCG + More-Thuente": (solvers.NonlinearCG(grad_tol=tol),
                                       ls.MoreThuente(approx_wolfe=aw)),
                "BFGS + More-Thuente": (solvers.BFGS(tol=tol),
                                        ls.MoreThuente(approx_wolfe=aw))}

    kw3 = dict(max_iter=d3["max_iter"], max_iter_ls=d3["max_iter_ls"])
    for fname, objs, gg, xr in (("LOG_SUM_EXP", lse3, gl, 0.5),
                                ("QUADRATIC", quad3, gq, 2.0)):
        n = gg["n"]
        for mname, (form, source) in forms.items():
            B = gg["B_dense"] if form == "dense" and "B_dense" in gg else gg["B"]
            what = f"41 {mname} {fname.lower()} ({B} x {n})"
            starts3 = np.random.RandomState(5).uniform(-xr, xr, (B, n))
            # tol 1e-13: no instance's stopping test falls within rounding
            # of tol inside the horizon (the float32 solves below hold the
            # stop)
            method, search = methods(1e-13, torch.float64)[mname]
            spec = fused_driver.build_spec(method, search)
            obj64 = objs[torch.float64]
            capped3 = dict(kw3, max_iter=K3_DATA_CAPPED)
            err = held_per_instance(
                f"{what}, {K3_DATA_CAPPED} iterations",
                lambda x: fused_driver._launch_cuda(spec, obj64, x, None,
                                                    None, (), **capped3),
                lambda x: fused_driver.fused_minimize_plain(
                    method, search, obj64, x, None, None, (), **capped3),
                tensors(starts3)[0], tensors)
            method, search = methods(gg["tol"], f32)[mname]
            spec32 = fused_driver.build_spec(method, search)
            obj32 = objs[f32]
            (x3,) = tensors(starts3, dtype=f32)

            def solve3(xs):
                return solvers.batch_minimize(method, search,
                                              make_oracle(obj32), xs, **kw3)

            fused_driver.fused_minimize.placements = {"shared": 0,
                                                      "workspace": 0}
            r3, wall3, launches3 = drive(f"{what} via batch_minimize",
                                         lambda: solve3(x3), "K3", sync_time)
            placed = dict(fused_driver.fused_minimize.placements)
            (_, fp3, itp3, stp3, _), plain3 = sync_time(
                lambda: fused_driver.fused_minimize_plain(
                    method, search, obj32, x3, None, None, (), **kw3))

            def ok(st):
                hit = (1, 6) if form == "dense" else (1,)
                return torch.isin(st, torch.tensor(hit, device=st.device)
                                  ).float().mean().item()

            conv3, cp3 = ok(r3.status), ok(stp3)
            log(f"{what}: {'success class' if form == 'dense' else 'converged'}"
                f" {conv3:.4f} vs plain {cp3:.4f}, median iterations "
                f"{r3.iterations.float().median().item():.0f} vs "
                f"{itp3.float().median().item():.0f}, median f "
                f"{r3.f.median().item():.7g} vs {fp3.median().item():.7g}; "
                f"placements {placed}; plain {plain3:.3f} s")
            check(conv3 >= CONV_FLOOR, f"{what}: {conv3} < {CONV_FLOOR}")
            check(abs(conv3 - cp3) <= CONV_ATOL, f"{what}: {conv3} vs {cp3}")
            if form == "dense" and fname == "QUADRATIC":
                check(placed["workspace"] >= 1 and not placed["shared"],
                      f"{what}: placements {placed}; the slabs must lie in "
                      "the workspace at n = 1,024")
            ms3 = event_ms(lambda: solve3(x3), 3)
            nfev = fused_driver._launch_cuda(spec32, obj32, x3, None, None,
                                             (), **kw3)[4]
            its3 = r3.iterations.double().sum().item()
            trials = nfev.double().sum().item()
            # the least work: per Wolfe trial a value and gradient (the
            # log-sum-exp 4 rows n; the symmetric quadratic Q x, 2 n^2),
            # per iteration the direction's algebra (L-BFGS's compact form
            # 8 m n, NCG 6 n, dense BFGS B g 2 n^2 and its update B y and
            # the rank-2 update 8 n^2); the data read once
            ev = 4 * gl["rows"] * n if fname == "LOG_SUM_EXP" else 2 * n * n
            per_it = (8 * method.m * n if form == "quasi-Newton" else
                      6 * n if form == "Wolfe" else 10 * n * n)
            data_bytes = ((gl["rows"] * n + gl["rows"]) if fname ==
                          "LOG_SUM_EXP" else n * n + n) * 4
            b3_ms, b3_by = bound(2 * B * n * 4 + data_bytes + 4 * B * 4,
                                 (trials + B) * ev + its3 * per_it)
            log(f"{what}: K3 {ms3:.2f} ms per call (CUDA events, 3 calls), "
                f"{B / (ms3 / 1e3):.1f} solves/s; plain {1e3 * plain3:.0f} "
                f"ms; bound {b3_ms:.4f} ms ({b3_by}); trials per iteration "
                f"{trials / max(its3, 1):.3f}  [{card}]")
            extra = {}
            if fname == "LOG_SUM_EXP" and form == "quasi-Newton":
                # the route this batch took before: the lockstep loop on
                # the card, its first LOCKSTEP_DATA_ITERS iterations
                rl, wall_l, _ = drive(
                    f"{what}, the lockstep loop (fused=False), first "
                    f"{LOCKSTEP_DATA_ITERS} iterations",
                    lambda: solvers.batch_minimize(
                        method, search, make_oracle(obj32), x3, fused=False,
                        max_iter=LOCKSTEP_DATA_ITERS,
                        max_iter_ls=d3["max_iter_ls"]), None, sync_time)
                per = 1e3 * wall_l / max(1, int(rl.iterations.max()))
                extra["lockstep_ms_per_iteration"] = per
                log(f"{what}: the lockstep loop {per:.3f} ms per lockstep "
                    f"iteration; K3 {ms3 / max(1.0, its3 / B):.3f} ms per "
                    f"mean instance-iteration  [{card}]")
            entries.append(data_entry(
                "driver_dense" if form == "dense" else "driver_qn", form,
                fname, source,
                "optimization_solvers_tpu/ops/pallas_driver.py:1874",
                launches3, err, ms3, 1e3 * plain3, b3_ms, b3_by, **extra))
        lap(f"41 {fname.lower()}")

    # ---- 42. K9 on the log-sum-exp
    g = K9_DATA
    B, n, rows = g["B"], g["n"], g["rows"]
    A9, b9 = lse_arrays(n, rows)
    starts9 = np.random.RandomState(5).uniform(-0.5, 0.5, (B, n))
    kw9 = dict(tol=g["tol"], max_iter=K9_DATA_ITERS, max_iter_ls=24,
               c1=1e-4)
    lse9 = problems.log_sum_exp(*tensors(A9, b9))
    capped9 = dict(kw9, max_iter=WHOLE_K9_CAPPED)
    fused_bfgs.bfgs_solve_fused.placements = {"shared": 0, "workspace": 0}
    err9 = held_per_instance(
        f"42 K9 log-sum-exp, {WHOLE_K9_CAPPED} iterations",
        lambda x: fused_bfgs._launch_cuda(lse9, x, (), **capped9),
        lambda x: fused_bfgs.bfgs_solve_plain(lse9, x, (), **capped9),
        tensors(starts9)[0], tensors)
    log(f"42 float64 placements {fused_bfgs.bfgs_solve_fused.placements}")
    lse9_32 = problems.log_sum_exp(*tensors(A9, b9, dtype=f32))
    (x9,) = tensors(starts9, dtype=f32)
    fused_bfgs.bfgs_solve_fused.placements = {"shared": 0, "workspace": 0}
    r9, wall9, launches9 = drive(
        "42 K9 log-sum-exp via ops.bfgs_solve_fused",
        lambda: fused_bfgs.bfgs_solve_fused(lse9_32, x9, **kw9), "K9",
        sync_time)
    report("42 K9 log-sum-exp f32", r9, wall9)
    log(f"42 float32 placements {fused_bfgs.bfgs_solve_fused.placements}")
    (_, fp9, itp9, stp9), plain9 = sync_time(
        lambda: fused_bfgs.bfgs_solve_plain(lse9_32, x9, (), **kw9))
    same9 = (r9.status == stp9).float().mean().item()
    log(f"42 plain on the card: status equal {same9:.4f}, {plain9:.3f} s")
    medians_agree("42 K9 log-sum-exp", r9, fp9, itp9, kernel="K9")
    ms9 = event_ms(lambda: fused_bfgs.bfgs_solve_fused(lse9_32, x9, **kw9), 3)
    _, _, it9, _, tr9, up9 = fused_bfgs._launch_cuda(lse9_32, x9, (), **kw9)
    its9 = it9.double().sum().item()
    # the least work: per iteration B g (2 n^2) and the accepted point's
    # value and gradient (4 rows n), per further trial a value (2 rows n),
    # per update B y and the rank-2 update (8 n^2); the data read once
    b9_ms, b9_by = bound(
        2 * B * n * 4 + rows * n * 4 + rows * 4 + 3 * B * 4,
        its9 * (2 * n * n + 4 * rows * n) + up9.double().sum().item() * 8 * n
        * n + max(0.0, tr9.double().sum().item() - its9) * 2 * rows * n
        + B * 4 * rows * n)
    log(f"42 K9 log-sum-exp: {ms9:.2f} ms per call (CUDA events, 3 calls); "
        f"plain {1e3 * plain9:.0f} ms; bound {b9_ms:.4f} ms ({b9_by}); "
        f"trials per iteration {tr9.sum().item() / max(its9, 1):.3f}  "
        f"[{card}]")
    entries.append(data_entry(
        "bfgs_fused", "whole solve", "LOG_SUM_EXP", "bfgs_fused.cu",
        "optimization_solvers_tpu/ops/pallas_bfgs.py:221", launches9, err9,
        ms9, 1e3 * plain9, b9_ms, b9_by))
    lap("42")
    return entries


if __name__ == "__main__":
    sys.exit(main())
