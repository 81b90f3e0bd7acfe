#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the batched
L-BFGS-B main path at the headline size (10,240 x Rosenbrock-100, float32,
box [-5, 5], pgtol 1e-3, factr 100, m 5, max_iter 600) through
``optimization_solvers_tpu_torch.minimize``, and prints, last, a JSON line
of per-kernel results, the card's name and power limit, and one JSON line
naming the device.  Any failed check exits non-zero; so does a machine
without a CUDA device.

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
    from optimization_solvers_tpu_torch.ops import _build, fused_lbfgsb

    dev = torch.device("cuda")
    K1 = fused_lbfgsb.lbfgsb_solve_fused
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

    K1.launches = 0
    res, first_s = sync_time(lambda: solve(x0))
    launches = K1.launches
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

    # ---- 5. results
    log(json.dumps({"kernels": [{
        "name": "lbfgsb_fused",
        "route": "cuda",
        "source": "optimization_solvers_tpu_torch/ops/csrc/lbfgsb_fused.cu",
        "replaces": "optimization_solvers_tpu/ops/pallas_lbfgsb.py:938",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
