#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and drives the
batched L-BFGS-B path through ``optimization_solvers_tpu_torch.minimize``
at two sizes:

* the headline (10,240 x Rosenbrock-100, float32, box [-5, 5], pgtol 1e-3,
  factr 100, m 5, max_iter 600), which the route sends to K1
  (``ops/csrc/lbfgsb_fused.cu``);
* config 4 (512 x the 10,000-dim bounded log-sum-exp with 512 rows,
  float32, box [-1, 1], m 10, pgtol 1e-5, factr 1e3, max_iter 200), which
  the route sends to the tall kernel K2 (``ops/csrc/lbfgsb_tall.cu``), with
  ``policy="fast"`` (Armijo) and ``policy="reference"`` (dcsrch).  A and the
  starts come from numpy seeds (A: ``RandomState(0)``; the JAX bench draws
  it from ``jax.random.PRNGKey(0)``), and 4 instances are anchored to
  scipy's ``fmin_l_bfgs_b`` in float64.

It prints, last, a JSON line of per-kernel results, the card's name and
power limit, and one JSON line naming the device.  Any failed check exits
non-zero; so does a machine without a CUDA device.

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
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

    tall = tall_slice(dev, card, tensors, sync_time)

    # ---- 9. results
    log(json.dumps({"kernels": [{
        "name": "lbfgsb_fused",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb.py:938",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, tall]}))
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
    log(f"config 4 via minimize (fast): K2 launches {launches}, K1 launches "
        f"{K1.launches}, {text}, first call {first_s:.3f} s")
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
        f"({B / ref_s:.0f} solves/s)  [{card}]")
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
    return {
        "name": "lbfgsb_tall",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_tall.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb_tall.py:941",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": 1e3 * statistics.median(kernel_s),
        "plain_ms": 1e3 * statistics.median(plain_s),
    }


if __name__ == "__main__":
    sys.exit(main())
