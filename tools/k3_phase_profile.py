#!/usr/bin/env python3
"""Where the dense quasi-Newton kernels' time goes, by phase, on one NVIDIA
GPU: K3's dense form at config 2 and K9 at its workload.

Copies ``optimization_solvers_tpu_torch`` into ``chip_tree/k3_profile/``
(listed in ``.gitignore``) and builds the copy with ``-DK3_PROFILE
-DK9_PROFILE``, which compile in the ``clock64`` counters of
``ops/csrc/driver.cuh`` (the dense methods QN and QNB) and
``ops/csrc/bfgs_fused.cu``: lane 0 of the warp that runs an instance times
the phases of every iteration.  Then it solves

* config 2 as the bench calls it (1,024 x Rosenbrock-100, float32,
  ``QuasiNewton(tol=2e-4, update="bfgs", scale_b0=True,
  restart_on_degeneracy=True)`` + ``MoreThuente()``, max_iter 1,500,
  max_iter_ls 40, starts ``RandomState(42)`` uniform(-2, 2), through
  ``solvers.batch_minimize``) and
* K9's workload (``ops.bfgs_solve_fused`` on the same starts, tol 1e-5,
  max_iter 600, max_iter_ls 24, c1 1e-4),

each in full and capped at 1 and 10 iterations, and prints each phase's
share of the summed per-warp cycles, the cycles per instance-iteration,
the trials and updates per iteration, and each kernel's launch (threads
per block, resident blocks per SM, registers, local bytes, shared memory,
where the slabs live).  The counters cost time of their own, so no time
is printed from the counting copy.

With ``--breakdown`` it first runs, in a child process, the package at
``--root`` (default: this checkout) without counters: the launches and
the kernels' device times (CUDA events around the wrapper's launch,
median of 3) at iteration caps 0, 1 and 10 and at B = 132, 1,024 and
1,056 (the first starts of a ``RandomState(6)`` draw).

``--lbfgs`` profiles K3's quasi-Newton form instead, at ``chip_smoke.py``'s
phase-16 inputs: L-BFGS (m 10) + Hager-Zhang on 1,024 x Rosenbrock-100,
float32, tol 1e-4 on max|g|, max_iter 1,500, max_iter_ls 40, starts
``RandomState(42)`` uniform(-2, 2).  It builds that form alone (``driver.cu``
for the C interface, ``driver_qn.cu``, the other forms stubbed; nvcc,
``sm_90a``, every build started together, into ``chip_tree/k3_qn/``) from
this checkout with ``-DK3_PROFILE`` and as shipped, as shipped from each
``--against`` checkout, and from this checkout with the nvcc flags of each
``--variant`` (a macro that an experiment adds to the source).  It prints
the ``ptxas`` line of each build's float32 and float64 Rosenbrock kernels
and its launch (warps per block, resident warps per SM); from the counting
build each phase's share of the summed per-warp cycles, the cycles per
instance-iteration, the trials per iteration and the share of steps that
kept the accepted trial's evaluation (full solves and capped at 1 and 10
iterations); the spread of iterations over the instances (median / p99 /
max); a batch sweep of the shipped builds in turns (B = 132, 1,024, 4,224,
10,240: the first B rows of one ``RandomState(42)`` draw; CUDA events,
median of QN_ROUNDS); and, in turns at B = 1,024 and 10,240 on the same
starts, the form's other workloads (QN_OTHER: NCG + More-Thuente in
float32, L-BFGS + Hager-Zhang in float64), with each build's residency
where it reports one.

``--first-order`` profiles K3's first-order form and K8 instead, at
``chip_smoke.py``'s inputs: config 6 (GD + BackTracking, 4,096 x the
100-dim diagonal quadratic, float32, starts ``RandomState(0)`` uniform(-5,
5)), config 3 in both policies (SPG + GLL, 10,240 x the 64-dim box
quadratic) and K8's (``WHOLE_K8``, config 3's inputs).  It builds the
first-order form (``driver.cu``, the other forms stubbed) and K8
(``spg_fused.cu``) alone (nvcc, ``sm_90a``, every build started together,
into ``chip_tree/k3_fo/``) from this checkout with ``-DK3_PROFILE
-DK8_PROFILE`` and as shipped, as shipped from each ``--against``
checkout, and with the nvcc flags of each ``--variant``; prints each
build's ``ptxas`` lines, its launch (warps per block, resident warps per
SM, registers, local bytes, shared memory, the layout), converged
fraction, median f, the iteration spread (median / p99 / max) and trials
per iteration; from the counting build each phase's share of the summed
per-warp cycles (the direction and g.d, the GLL reference, the trials,
the step's evaluation, the post-step, the convergence test: the
``FO_PHASES`` slots of ``k3_prof`` / ``k8_prof``), the cycles per
instance-iteration, the share of steps that kept the accepted trial's
evaluation and the distribution of trials per iteration (full solves and
capped at 1 and 10 iterations); a batch sweep of the shipped builds in
turns (``FO_SWEEP``; CUDA events, median of FO_ROUNDS); and the host's
share of a config 3 and a config 6 call through ``minimize`` (wall minus
the launch's device time) on this checkout's package.

    python3 tools/k3_phase_profile.py [--breakdown] [--root DIR]
    python3 tools/k3_phase_profile.py --lbfgs [--against DIR ...]
        [--variant NAME=FLAG[,FLAG] ...]
    python3 tools/k3_phase_profile.py --first-order [--against DIR ...]
        [--variant NAME=FLAG[,FLAG] ...]
"""

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "chip_tree", "k3_profile")
# the counters [0..5] of k3_prof and k9_prof, in order
PHASES = ["direction's pass", "search trials", "value and gradient", "B y",
          "update", "checks"]
B, N = 1024, 100
CONFIG2 = dict(tol=2e-4, max_iter=1500, max_iter_ls=40)
K9 = dict(tol=1e-5, max_iter=600, max_iter_ls=24, c1=1e-4)
SWEEP = (132, 1024, 1056)
CAPS = (0, 1, 10)
# --lbfgs: the quasi-Newton form's counters [0..4], in order, its workload
# and its sweep
QN_PHASES = ["direction", "search trials", "the step's evaluation",
             "pair sums and ring update", "convergence"]
# the compact form's sub-phases, k3_prof[11..14]
QN_SUB = {11: "the direction's m x m algebra", 12: "the step's passes",
          13: "the step's butterflies",
          14: "the step's stores, pair and swap"}
QN = dict(B=1024, n=100, m=10, tol=1e-4, max_iter=1500, max_iter_ls=40)
QN_SWEEP = (132, 1024, 4224, 10240)
# the form's other workloads, timed at QN_OTHER_B on the same starts and
# the same tol and caps: a first-order method with a Wolfe search, and
# L-BFGS in float64
QN_OTHER = (("NCG (PR+) + More-Thuente, float32", "ncg", "float32"),
            ("L-BFGS (m 10) + Hager-Zhang, float64", "lbfgs", "float64"))
QN_OTHER_B = (1024, 10240)
QN_ROUNDS = 6
QN_OUT = os.path.join(ROOT, "chip_tree", "k3_qn")
# --first-order: K3's first-order form and K8.  The counters' slots
# (driver.cuh's k3_prof, spg_fused.cu's k8_prof) and their phases
FO_PHASES = {0: "direction and g.d", 11: "GLL reference", 1: "trials",
             2: "the step's evaluation", 3: "post-step (BB pair, copy)",
             5: "convergence test"}
FO_SWEEP = {"config 6": (132, 1056, 4096),
            "config 3 (fast)": (132, 1056, 10240),
            "K8": (132, 1056, 10240)}
FO_ROUNDS = 6
FO_OUT = os.path.join(ROOT, "chip_tree", "k3_fo")
# the kernel entries whose ptxas lines --first-order prints
FO_ENTRIES = ("driver_kernel", "first_order_kernel", "spg_fused_kernel")


def fo_short(name):
    """A kernel entry's demangled name without its namespaces and
    parameters."""
    for ns in ("ost_driver::", "(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(ns, "")
    end = name.find(">(")
    return name[:end + 1] if end >= 0 else name


# the first-order form's translation unit: driver.cu (the C interface) with
# the other forms stubbed
FO_STUB = """#include "driver.cu"
namespace ost_driver {
template <typename T>
int launch_qn(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template <typename T>
int launch_newton(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template <typename T>
int launch_dense(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template int launch_qn<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn<double>(const Params<double>&, int, cudaStream_t);
template int launch_newton<float>(const Params<float>&, int, cudaStream_t);
template int launch_newton<double>(const Params<double>&, int, cudaStream_t);
template int launch_dense<float>(const Params<float>&, int, cudaStream_t);
template int launch_dense<double>(const Params<double>&, int, cudaStream_t);
}  // namespace ost_driver
"""
# the form of a driver_kernel entry, by the digit of its mangled name
QN_FORMS = {"1": "quasi-Newton form", "4": "Wolfe form"}
# the other forms, which driver.cu's C interface reaches, and the
# quasi-Newton form's quadratic and log-sum-exp instances, as stubs
QN_STUB = """#include "driver.cuh"
namespace ost_driver {
template <typename T>
int launch_qn_data(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template int launch_qn_data<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn_data<double>(const Params<double>&, int, cudaStream_t);
template <typename T>
int launch_newton(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template <typename T>
int launch_dense(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template int launch_newton<float>(const Params<float>&, int, cudaStream_t);
template int launch_newton<double>(const Params<double>&, int, cudaStream_t);
template int launch_dense<float>(const Params<float>&, int, cudaStream_t);
template int launch_dense<double>(const Params<double>&, int, cudaStream_t);
}  // namespace ost_driver
"""


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def runners():
    """The two launches on the package imported: ``k3(x, max_iter)`` and
    ``k9(x, max_iter)``, each returning the wrapper's outputs; and
    ``info(lib, dtype)``, the two launch lines."""
    from optimization_solvers_tpu_torch import linesearch as ls, problems
    from optimization_solvers_tpu_torch import solvers
    from optimization_solvers_tpu_torch.ops import fused_bfgs, fused_driver

    rosen = problems.rosenbrock()
    method = solvers.QuasiNewton(tol=CONFIG2["tol"], update="bfgs",
                                 scale_b0=True, restart_on_degeneracy=True)
    spec = fused_driver.build_spec(method, ls.MoreThuente())

    def k3(x, max_iter=CONFIG2["max_iter"]):
        return fused_driver._launch_cuda(spec, rosen, x, None, None, (),
                                         max_iter, CONFIG2["max_iter_ls"])

    def k9(x, max_iter=K9["max_iter"]):
        return fused_bfgs._launch_cuda(rosen, x, (), **dict(
            K9, max_iter=max_iter))

    def info(lib, dtype=0):
        out = (ctypes.c_int * 6)()
        rc = lib.driver_dense_info(dtype, N, 0, 0, out)
        k3_line = f"rc {rc}" if rc else launch_line(list(out))
        out9 = (ctypes.c_int * 6)()
        rc = lib.bfgs_fused_info(dtype, N, out9)
        k9_line = f"rc {rc}" if rc else launch_line(list(out9))
        return k3_line, k9_line

    return k3, k9, info


def launch_line(v):
    where = {0: "no slab", 1: "shared memory", 2: "the workspace"}[v[5]]
    return (f"{v[0]} threads per block, {v[1]} resident blocks "
            f"({v[1] * v[0] // 32} warps) per SM, {v[2]} registers, {v[3]} "
            f"local bytes a thread, {v[4]} bytes of shared memory per block, "
            f"slabs in {where}")


def starts(torch, b, seed):
    import numpy as np

    return torch.tensor(np.random.RandomState(seed).uniform(-2.0, 2.0,
                                                            (b, N)),
                        dtype=torch.float32, device="cuda")


def times(root):
    """The child of ``--breakdown``: the package at ``root`` without
    counters."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import optimization_solvers_tpu_torch as ostt
    from optimization_solvers_tpu_torch.ops import _build

    card = card_line()
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"package {os.path.dirname(ostt.__file__)}; build or load "
          f"{time.perf_counter() - t0:.1f} s")
    k3, k9, info = runners()
    for dtype, name in ((0, "float32"), (1, "float64")):
        k3_line, k9_line = info(lib, dtype)
        print(f"launch at B = {B}, n = {N}, {name}: K3 dense BFGS: {k3_line}; "
              f"K9: {k9_line}")

    def event_ms(fn, x, cap):
        fn(x, cap)
        ts = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x, cap)
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop))
        return statistics.median(ts)

    x = starts(torch, B, 42)
    for what, fn, full in (("config 2 (K3)", k3, CONFIG2["max_iter"]),
                           ("K9", k9, K9["max_iter"])):
        caps = {cap: event_ms(fn, x, cap) for cap in CAPS + (full,)}
        sweep = {b: event_ms(fn, starts(torch, b, 6), full) for b in SWEEP}
        print(f"{what}: iteration cap " + ", ".join(
            f"{c}: {ms:.3f} ms" for c, ms in caps.items())
            + "; batch sweep " + ", ".join(
                f"B={b}: {ms:.3f} ms" for b, ms in sweep.items())
            + f" (CUDA events, median of 3)  [{card}]")
    return 0


def build_qn(variants):
    """Build K3's quasi-Newton form per variant (name -> (checkout, extra
    nvcc flags)), every compilation started together; returns {name:
    loaded library} after printing ptxas's line for each build's float32
    Rosenbrock kernel."""
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v"]
    jobs = {}
    for name, (root, extra) in variants.items():
        out = os.path.join(QN_OUT, name)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        csrc = os.path.join(os.path.abspath(root),
                            "optimization_solvers_tpu_torch", "ops", "csrc")
        stub = os.path.join(out, "stub.cu")
        with open(stub, "w") as fh:
            fh.write(QN_STUB)
        srcs = [os.path.join(csrc, "driver.cu"),
                os.path.join(csrc, "driver_qn.cu"), stub]
        objs = [os.path.join(out, f"{k}.o") for k in range(len(srcs))]
        jobs[name] = (out, objs, [subprocess.Popen(
            [nvcc, *flags, *extra, "-I", csrc, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)])
    libs = {}
    for name, (out, objs, procs) in jobs.items():
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed for {name}:\n" + "\n".join(
                log[-3000:] for log in logs))
        lines = logs[1].splitlines()
        for j, line in enumerate(lines):
            for t, word in (("f", "float32"), ("d", "float64")):
                if ("Compiling entry" in line and f"driver_kernelI{t}" in line
                        and f"RosenbrockI{t}" in line):
                    form = QN_FORMS.get(line.split("EELi")[-1][:1], "?")
                    print(f"{name}: {word} Rosenbrock kernel, {form}: "
                          + "; ".join(
                              v.split(":", 1)[-1].strip()
                              for v in lines[j + 1:j + 4]
                              if "spill" in v or "registers" in v))
        lib_path = os.path.join(out, "libk3_qn.so")
        subprocess.run([nvcc, *flags[:2], "-shared", "-o", lib_path, *objs],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.driver_launch.restype = i
        lib.driver_launch.argtypes = [
            i, i, vp, vp, vp, i, vp, vp, vp, i, i, ctypes.POINTER(i),
            ctypes.POINTER(d), i, i, vp, vp, vp, vp, vp, vp, vp]
        if hasattr(lib, "driver_qn_info"):
            lib.driver_qn_info.restype = i
            lib.driver_qn_info.argtypes = [i, i, i, i, i, vp]
        libs[name] = lib
    return libs


def lbfgs(against, variants=()):
    """``--lbfgs``: K3's quasi-Newton form at chip_smoke.py's phase-16
    inputs (see the module's docstring)."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from optimization_solvers_tpu_torch import linesearch as ls, solvers
    from optimization_solvers_tpu_torch.ops import fused_driver

    card = card_line()
    builds = {"profile": (ROOT, ["-DK3_PROFILE"]), "shipped": (ROOT, [])}
    for k, root in enumerate(against):
        builds[f"against{k}"] = (root, [])
    for v in variants:
        name, flags = v.split("=", 1)
        builds[name] = (ROOT, flags.split(","))
    t0 = time.perf_counter()
    libs = build_qn(builds)
    print(f"built {len(libs)} copies of the quasi-Newton form in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    for k, root in enumerate(against):
        print(f"against{k}: {os.path.abspath(root)}")
    n, m = QN["n"], QN["m"]
    specs = {"lbfgs": fused_driver.build_spec(
        solvers.LBFGS(tol=QN["tol"], m=m), ls.HagerZhang()),
        "ncg": fused_driver.build_spec(
            solvers.NonlinearCG(grad_tol=QN["tol"]), ls.MoreThuente())}
    slots = {(k, dt): fused_driver._slots(spec, getattr(torch, dt))
             for k, spec in specs.items() for dt in ("float32", "float64")}
    dev = torch.device("cuda")
    draw = torch.tensor(np.random.RandomState(42).uniform(
        -2.0, 2.0, (max(QN_SWEEP), n)), dtype=torch.float32, device=dev)

    def launch(lib, x, max_iter=QN["max_iter"], method="lbfgs"):
        b = x.shape[0]
        dt = str(x.dtype).split(".")[-1]
        ints, doubles = slots[(method, dt)]
        out = [torch.empty_like(x), torch.empty_like(x[:, 0]),
               *(torch.empty(b, dtype=torch.int32, device=dev)
                 for _ in range(3))]
        rc = lib.driver_launch(
            int(dt == "float64"), 0, x.data_ptr(), None, None, 0, None, None,
            None, b, n, ints, doubles, max_iter, QN["max_iter_ls"], None,
            *(t.data_ptr() for t in out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"driver_launch returned {rc}")
        return out

    def in_turns(names, run):
        """{name: [ms, ...]}: QN_ROUNDS timed calls of ``run(name)`` per
        build after one untimed call each, the order reversed every other
        round."""
        ts = {k: [] for k in names}
        for k in names:
            run(k)
        for r in range(QN_ROUNDS):
            for k in (names if r % 2 == 0 else names[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                run(k)
                stop.record()
                torch.cuda.synchronize()
                ts[k].append(start.elapsed_time(stop))
        return ts

    def timings(ts):
        return "; ".join(
            f"{k} {statistics.median(t):.3f} ms (min {min(t):.3f}, max "
            f"{max(t):.3f})" for k, t in ts.items()) + (
            f" (CUDA events, median of {QN_ROUNDS} in turns)  [{card}]")

    x = draw[:QN["B"]].contiguous()
    for name, lib in libs.items():
        _, f, it, st, nfev = launch(lib, x)
        torch.cuda.synchronize()
        info = ""
        if hasattr(lib, "driver_qn_info"):
            v = (ctypes.c_int * 5)()
            rc = lib.driver_qn_info(0, specs["lbfgs"].method, QN["B"], n, m,
                                    ctypes.addressof(v))
            info = (f"rc {rc}" if rc else
                    f"{v[0]} warps per block, {v[0] * v[1]} resident warps "
                    f"per SM, {v[2]} registers, {v[3]} local bytes a "
                    f"thread, {v[4]} bytes of shared memory a block; ")
        itf = it.double()
        print(f"{name}: {info}converged {(st == 1).double().mean().item():.4f}"
              f", median f {f.median().item():.4g}, iterations median / p99 "
              f"/ max {itf.median().item():.0f} / "
              f"{torch.quantile(itf, 0.99).item():.1f} / "
              f"{int(it.max().item())}, trials per iteration "
              f"{nfev.double().sum().item() / itf.sum().item():.4f}")

    prof = libs["profile"]
    prof.k3_qn_prof_read.argtypes = [ctypes.c_void_p]
    for cap in (QN["max_iter"], 1, 10):
        prof.k3_qn_prof_reset()
        launch(prof, x, cap)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        prof.k3_qn_prof_read(ctypes.addressof(buf))
        v = list(buf)
        total = sum(v[:5])
        its = max(v[6], 1)
        print(f"L-BFGS + HZ, max_iter {cap}: {v[8]} instances, {v[6]} "
              f"instance-iterations, {v[7] / its:.4f} trials per iteration, "
              f"{v[9] / its:.4f} of the steps kept the trial's evaluation; "
              f"cycles per instance-iteration {total / its:.0f}, the loop "
              f"{total / max(v[10], 1):.3f} of the instances' cycles")
        print("   " + "; ".join(f"{p} {v[k] / max(total, 1):.3f}"
                                for k, p in enumerate(QN_PHASES)))
        print("   of which (cycles per instance-iteration): " + "; ".join(
            f"{p} {v[k] / its:.0f}" for k, p in QN_SUB.items()))

    names = [k for k in libs if k != "profile"]
    for b in QN_SWEEP:
        xb = draw[:b].contiguous()
        ts = in_turns(names, lambda k: launch(libs[k], xb))
        print(f"B = {b}: " + timings(ts))

    for what, method, dt in QN_OTHER:
        mo = specs[method].lbfgs_m
        for b in QN_OTHER_B:
            xb = draw[:b].to(getattr(torch, dt)).contiguous()
            for k in names:
                _, f, it, st, nfev = launch(libs[k], xb, method=method)
                torch.cuda.synchronize()
                info = ""
                if hasattr(libs[k], "driver_qn_info"):
                    v = (ctypes.c_int * 5)()
                    rc = libs[k].driver_qn_info(
                        int(dt == "float64"), specs[method].method, b, n, mo,
                        ctypes.addressof(v))
                    info = (f"rc {rc}; " if rc else
                            f"{v[0] * v[1]} resident warps per SM, {v[2]} "
                            f"registers, {v[3]} local bytes a thread, "
                            f"{v[4]} bytes of shared memory a block; ")
                itf = it.double()
                print(f"{what}, B = {b}, {k}: {info}converged "
                      f"{(st == 1).double().mean().item():.4f}, median f "
                      f"{f.median().item():.4g}, iterations median / max "
                      f"{itf.median().item():.0f} / {int(it.max().item())},"
                      f" trials per iteration "
                      f"{nfev.double().sum().item() / itf.sum().item():.4f}")
            ts = in_turns(names, lambda k: launch(libs[k], xb, method=method))
            print(f"{what}, B = {b}: " + timings(ts))
    return 0


def build_fo(variants):
    """Build K3's first-order form (``driver.cu``, the other forms stubbed)
    and K8 (``spg_fused.cu``) per variant (name -> (checkout, extra nvcc
    flags)), every compilation started together, into ``chip_tree/k3_fo/``;
    returns {name: loaded library} after printing ptxas's lines for each
    build's first-order and K8 kernel entries."""
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas=-v"]
    jobs = {}
    for name, (root, extra) in variants.items():
        out = os.path.join(FO_OUT, name)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        csrc = os.path.join(os.path.abspath(root),
                            "optimization_solvers_tpu_torch", "ops", "csrc")
        tu = os.path.join(out, "first_order.cu")
        with open(tu, "w") as fh:
            fh.write(FO_STUB)
        srcs = [tu, os.path.join(csrc, "spg_fused.cu")]
        objs = [os.path.join(out, f"{k}.o") for k in range(len(srcs))]
        jobs[name] = (out, objs, [subprocess.Popen(
            [nvcc, *flags, *extra, "-I", csrc, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)])
    libs = {}
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    for name, (out, objs, procs) in jobs.items():
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed for {name}:\n" + "\n".join(
                log[-3000:] for log in logs))
        entries = []
        for log in logs:
            lines = log.splitlines()
            for j, line in enumerate(lines):
                if "Compiling entry" not in line:
                    continue
                entry = line.split("'")[1]
                if not any(k in entry for k in FO_ENTRIES):
                    continue
                entries.append((entry, "; ".join(
                    v.split(":", 1)[-1].strip() for v in lines[j + 1:j + 4]
                    if "spill" in v or "registers" in v)))
        names = [e for e, _ in entries]
        if os.path.exists(filt) and names:
            names = subprocess.run([filt], input="\n".join(names),
                                   capture_output=True, text=True
                                   ).stdout.splitlines()
        for readable, (_, res) in zip(names, entries):
            print(f"{name}: {fo_short(readable)}: {res}")
        lib_path = os.path.join(out, "libk3_fo.so")
        subprocess.run([nvcc, *flags[:2], "-shared", "-o", lib_path, *objs],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.driver_launch.restype = i
        lib.driver_launch.argtypes = [
            i, i, vp, vp, vp, i, vp, vp, vp, i, i, ctypes.POINTER(i),
            ctypes.POINTER(d), i, i, vp, vp, vp, vp, vp, vp, vp]
        lib.spg_fused_launch.restype = i
        lib.spg_fused_launch.argtypes = [i, i, vp, vp, vp, vp, vp, i, i, d,
                                         d, d, i, d, i, i, vp, vp, vp, vp,
                                         vp, vp]
        if hasattr(lib, "driver_first_info"):
            lib.driver_first_info.restype = i
            lib.driver_first_info.argtypes = [i, i, i, i, i, vp]
        if hasattr(lib, "spg_fused_info"):
            lib.spg_fused_info.restype = i
            lib.spg_fused_info.argtypes = [i, i, i, i, vp]
        libs[name] = lib
    return libs


def fo_workloads(torch):
    """{name: workload} of ``--first-order``: chip_smoke.py's config 6,
    config 3 (both policies) and K8's inputs, each a dict with ``kind``
    ("k3" or "k8"), the launch's operands and a (max B, n) float32 draw of
    starts."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from optimization_solvers_tpu_torch import linesearch as ls
    from optimization_solvers_tpu_torch import problems, solvers
    from optimization_solvers_tpu_torch.ops import fused_driver
    from optimization_solvers_tpu_torch.ops.batched_oracle import (
        kernel_operands)

    dev = torch.device("cuda")
    c3, c6, c8 = cs.CONFIG3, cs.CONFIG6, cs.WHOLE_K8

    def draw(seed, lo_hi, b, n):
        return torch.tensor(np.random.RandomState(seed).uniform(
            *lo_hi, (b, n)), dtype=torch.float32, device=dev)

    def k3(method, search, obj, data, box, c, seed, lo_hi):
        n = c["n"]
        x = draw(seed, lo_hi, c["B"], n)
        code, arrays = kernel_operands(obj, tuple(
            torch.tensor(a, dtype=torch.float32, device=dev) for a in data),
            x)
        bounds = (None, None) if box is None else tuple(
            torch.full((n,), v, device=dev) for v in (-box, box))
        return dict(kind="k3", spec=fused_driver.build_spec(method, search),
                    code=code, arrays=[a.contiguous() for a in arrays],
                    bounds=bounds, n=n, draw=x, max_iter=c["max_iter"],
                    max_iter_ls=c["max_iter_ls"], obj=obj, data=data,
                    box=box, tol=c["tol"])

    n3 = c3["n"]
    data3 = (np.logspace(0, 3, n3), np.zeros(n3))
    wl = {}
    for policy, variant in (("fast", "alternate"), ("reference", "bb1")):
        wl[f"config 3 ({policy})"] = k3(
            solvers.SpectralProjectedGradient(grad_tol=c3["tol"],
                                              bb_variant=variant),
            ls.GLLQuadratic(), problems.weighted_squares(), data3,
            c3["box"], c3, 3, (-2.0, 2.0))
    wl["config 6"] = k3(
        solvers.GradientDescent(grad_tol=c6["tol"]), ls.BackTracking(),
        problems.diag_quadratic(np.linspace(1.0, 100.0, c6["n"])), (),
        None, c6, 0, (-5.0, 5.0))
    n8 = c8["n"]
    x8 = draw(3, (-2.0, 2.0), c8["B"], n8)
    code8, arrays8 = kernel_operands(problems.weighted_squares(), tuple(
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in (np.logspace(0, 3, n8), np.zeros(n8))), x8)
    wl["K8"] = dict(kind="k8", code=code8,
                    arrays=[a.contiguous() for a in arrays8],
                    bounds=tuple(torch.full((n8,), v, device=dev)
                                 for v in (-c8["box"], c8["box"])),
                    n=n8, draw=x8, max_iter=c8["max_iter"],
                    max_iter_ls=c8["max_iter_ls"], tol=c8["tol"])
    return wl


def first_order(against, variants=()):
    """``--first-order``: K3's first-order form and K8 at chip_smoke.py's
    inputs (see the module's docstring)."""
    import torch

    sys.path.insert(0, ROOT)
    from optimization_solvers_tpu_torch import minimize
    from optimization_solvers_tpu_torch.ops import _build, fused_driver

    card = card_line()
    builds = {"profile": (ROOT, ["-DK3_PROFILE", "-DK8_PROFILE"]),
              "shipped": (ROOT, [])}
    for k, root in enumerate(against):
        builds[f"against{k}"] = (root, [])
    for v in variants:
        name, flags = v.split("=", 1)
        builds[name] = (ROOT, flags.split(","))
    t0 = time.perf_counter()
    libs = build_fo(builds)
    print(f"built {len(libs)} copies of the first-order form and K8 in "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    for k, root in enumerate(against):
        print(f"against{k}: {os.path.abspath(root)}")
    wl = fo_workloads(torch)
    dev = torch.device("cuda")
    slots = {k: fused_driver._slots(w["spec"], torch.float32)
             for k, w in wl.items() if w["kind"] == "k3"}

    def launch(lib, name, x, max_iter=None):
        w = wl[name]
        b, n = x.shape
        out = [torch.empty_like(x), torch.empty_like(x[:, 0]),
               *(torch.empty(b, dtype=torch.int32, device=dev)
                 for _ in range(3))]
        a = w["arrays"]
        d0 = a[0].data_ptr() if a else None
        d1 = a[1].data_ptr() if len(a) > 1 else None
        lo, up = (None if v is None else v.data_ptr() for v in w["bounds"])
        mi = w["max_iter"] if max_iter is None else max_iter
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if w["kind"] == "k3":
            ints, doubles = slots[name]
            rc = lib.driver_launch(0, w["code"], x.data_ptr(), lo, up, 0, d0,
                                   d1, None, b, n, ints, doubles, mi,
                                   w["max_iter_ls"], None,
                                   *(t.data_ptr() for t in out), stream)
        else:
            rc = lib.spg_fused_launch(0, w["code"], x.data_ptr(), lo, up, d0,
                                      d1, b, n, w["tol"], 1e-3, 1e3, 10,
                                      1e-4, mi, w["max_iter_ls"],
                                      *(t.data_ptr() for t in out), stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch returned {rc}")
        return out

    def residency(lib, name, b):
        w = wl[name]
        fn = "driver_first_info" if w["kind"] == "k3" else "spg_fused_info"
        if not hasattr(lib, fn):
            return "no launch report in this build; "
        v = (ctypes.c_int * 6)()
        if w["kind"] == "k3":
            rc = lib.driver_first_info(0, b, w["n"], w["spec"].ring,
                                       w["spec"].method, ctypes.addressof(v))
        else:
            rc = lib.spg_fused_info(0, b, w["n"], 10, ctypes.addressof(v))
        if rc:
            return f"launch report rc {rc}; "
        return (f"{v[0]} warps per block, {v[0] * v[1]} resident warps per "
                f"SM, {v[2]} registers, {v[3]} local bytes a thread, {v[4]} "
                f"bytes of shared memory a block, vectors in "
                f"{'registers' if v[5] else 'shared memory'}; ")

    def in_turns(names, run):
        ts = {k: [] for k in names}
        for k in names:
            run(k)
        for r in range(FO_ROUNDS):
            for k in (names if r % 2 == 0 else names[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                run(k)
                stop.record()
                torch.cuda.synchronize()
                ts[k].append(start.elapsed_time(stop))
        return ts

    def timings(ts):
        return "; ".join(
            f"{k} {statistics.median(t):.3f} ms (min {min(t):.3f}, max "
            f"{max(t):.3f})" for k, t in ts.items()) + (
            f" (CUDA events, median of {FO_ROUNDS} in turns)  [{card}]")

    for name, w in wl.items():
        x = w["draw"]
        for build, lib in libs.items():
            _, f, it, st, nfev = launch(lib, name, x)
            torch.cuda.synchronize()
            itf = it.double()
            print(f"{name}, {build}: {residency(lib, name, x.shape[0])}"
                  f"converged {(st == 1).double().mean().item():.4f}, median "
                  f"f {f.median().item():.4g}, iterations median / p99 / max "
                  f"{itf.median().item():.0f} / "
                  f"{torch.quantile(itf, 0.99).item():.1f} / "
                  f"{int(it.max().item())}, trials per iteration "
                  f"{nfev.double().sum().item() / itf.sum().item():.4f}")

    prof = libs["profile"]
    for fn in ("k3_fo_prof_read", "k8_prof_read"):
        getattr(prof, fn).argtypes = [ctypes.c_void_p]
    for name, w in wl.items():
        tag = "k3_fo" if w["kind"] == "k3" else "k8"
        for cap in (w["max_iter"], 1, 10):
            getattr(prof, f"{tag}_prof_reset")()
            launch(prof, name, w["draw"], cap)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            getattr(prof, f"{tag}_prof_read")(ctypes.addressof(buf))
            v = list(buf)
            total = sum(v[k] for k in FO_PHASES)
            its = max(v[6], 1)
            print(f"{name}, max_iter {cap}: {v[8]} instances, {v[6]} "
                  f"instance-iterations, {v[7] / its:.4f} trials per "
                  f"iteration, {v[9] / its:.4f} of the steps kept the "
                  f"trial's evaluation; cycles per instance-iteration "
                  f"{total / its:.0f}, the loop {total / max(v[10], 1):.3f} "
                  f"of the instances' cycles")
            print("   " + "; ".join(
                f"{p} {v[k] / max(total, 1):.3f} ({v[k] / its:.0f})"
                for k, p in FO_PHASES.items()))
            hist = v[16:32]
            print("   trials per iteration (share of iterations): " + ", ".join(
                f"{k if k < 15 else '15+'}: {h / its:.4f}"
                for k, h in enumerate(hist) if h))

    names = [k for k in libs if k != "profile"]
    for name, w in wl.items():
        for b in FO_SWEEP.get(name, ()):
            xb = w["draw"][:b].contiguous()
            ts = in_turns(names, lambda k: launch(libs[k], name, xb))
            print(f"{name}, B = {b}: " + timings(ts))

    # the host's share of a call through minimize: this checkout's package
    # on the shipped build of this checkout's kernels
    _build._lib = libs["shipped"]
    for name, method in (("config 3 (fast)", "spg"), ("config 6", "gd")):
        w = wl[name]
        bounds = None if w["box"] is None else (-w["box"], w["box"])
        data = tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in w["data"])
        x = w["draw"]

        def call():
            return minimize(w["obj"], x, method=method, bounds=bounds,
                            data=data, tol=w["tol"], max_iter=w["max_iter"],
                            max_iter_ls=w["max_iter_ls"])

        walls, devs = [], []
        call()
        for _ in range(FO_ROUNDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(libs["shipped"], name, x)
            stop.record()
            torch.cuda.synchronize()
            devs.append(start.elapsed_time(stop))
        wm, dm = statistics.median(walls), statistics.median(devs)
        print(f"{name} through minimize: wall {wm:.3f} ms, the launch alone "
              f"{dm:.3f} ms (CUDA events), host {wm - dm:.3f} ms a call "
              f"(median of {FO_ROUNDS})  [{card}]")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--breakdown", action="store_true",
                        help="also time the package at --root without "
                        "counters: caps 0/1/10 and B = 132, 1,024, 1,056")
    parser.add_argument("--root", default=ROOT, help="the checkout whose "
                        "package --breakdown times (default: this one)")
    parser.add_argument("--times", metavar="ROOT", help=argparse.SUPPRESS)
    parser.add_argument("--lbfgs", action="store_true",
                        help="profile the quasi-Newton form (L-BFGS + "
                        "Hager-Zhang) instead of the dense kernels")
    parser.add_argument("--first-order", action="store_true",
                        help="profile K3's first-order form (configs 6 and "
                        "3) and K8 instead of the dense kernels")
    parser.add_argument("--against", metavar="DIR", action="append",
                        default=[], help="with --lbfgs or --first-order: "
                        "also build DIR's form as shipped and time it in "
                        "turns")
    parser.add_argument("--variant", metavar="NAME=FLAG[,FLAG]",
                        action="append", default=[], help="with --lbfgs or "
                        "--first-order: also build this checkout's form "
                        "with these nvcc flags and time it in turns")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k3_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.lbfgs:
        return lbfgs(args.against, args.variant)
    if args.first_order:
        return first_order(args.against, args.variant)
    if args.times:
        return times(args.times)
    if args.breakdown:
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--times", args.root])
        if child.returncode != 0:
            return child.returncode

    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "optimization_solvers_tpu_torch"),
                    os.path.join(COPY, "optimization_solvers_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, COPY)
    from optimization_solvers_tpu_torch.ops import _build

    _build.NVCC_FLAGS.extend(["-DK3_PROFILE", "-DK9_PROFILE"])
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"built the counting copy in {time.perf_counter() - t0:.1f} s")
    for name in ("k3", "k9"):
        getattr(lib, f"{name}_prof_read").argtypes = [ctypes.c_void_p]
    k3, k9, info = runners()
    k3_line, k9_line = info(lib)
    print(f"launch (counting copy) at B = {B}, n = {N}, float32: K3 dense "
          f"BFGS: {k3_line}; K9: {k9_line}")
    x = starts(torch, B, 42)
    for what, fn, name, full in (
            ("config 2 (K3 dense BFGS + More-Thuente)", k3, "k3",
             CONFIG2["max_iter"]),
            ("K9 (dense BFGS + Armijo)", k9, "k9", K9["max_iter"])):
        for cap in (full, 1, 10):
            getattr(lib, f"{name}_prof_reset")()
            fn(x, cap)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            getattr(lib, f"{name}_prof_read")(ctypes.addressof(buf))
            v = list(buf)
            total = sum(v[:6])
            its = max(v[6], 1)
            print(f"{what}, max_iter {cap}: {v[8]} instances, {v[6]} "
                  f"instance-iterations, {v[7] / its:.3f} trials and "
                  f"{v[9] / its:.3f} updates per iteration; cycles per "
                  f"instance-iteration {total / its:.0f}, the loop "
                  f"{total / max(v[10], 1):.3f} of the instances' cycles")
            print("   " + "; ".join(f"{p} {v[k] / max(total, 1):.3f}"
                                    for k, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
