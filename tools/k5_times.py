#!/usr/bin/env python3
"""Times of the fused dense quasi-Newton update K5 at its path's shape, on
one NVIDIA GPU, for one or more builds of its source in turns.

Each variant ``LABEL=PATH[+FLAG...]`` is ``ops/csrc/qn_update.cu`` of some
checkout (``PATH``), built alone with nvcc (``sm_90a``, extra flags
``FLAG``, the builds in parallel, into ``chip_tree/k5_times/``, listed in
``.gitignore``).  The default is this checkout's source as shipped.  At the
lockstep quasi-Newton path's shape, (1,024, 100, 100) with the curvature
pairs of ``tests/_torch_geometries.py:qn_update_arrays``, it times every
rule (bfgs, dfp, broyden, sr1) in float32 and float64 (CUDA events around
REPS launches after a warm-up, ROUNDS rounds, the variants in turns, the
order alternating) and prints the median microseconds per launch, the
bytes the bound counts (B read and B' written once, s, y, g read and B' g
written once) over that time against the card's 3.35 TB/s, and the
placement and resident blocks per SM where the source reports them;
before timing it holds each variant's B' and B' g against the plain
version (``fused_qn.qn_update_direction_plain``).

    python3 tools/k5_times.py
    S=optimization_solvers_tpu_torch/ops/csrc/qn_update.cu
    python3 tools/k5_times.py parent=chip_tree/parent/$S this=$S
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "optimization_solvers_tpu_torch", "ops", "csrc",
                   "qn_update.cu")
OUT = os.path.join(ROOT, "chip_tree", "k5_times")
KINDS = ("bfgs", "dfp", "broyden", "sr1")
B, N = 1024, 100
REPS, ROUNDS = 50, 5
DEFAULT = [f"shipped={SRC}"]
HBM_BYTES_PER_S = 3.35e12


def build(variants):
    """Start one build per variant together; returns {label: library}."""
    os.makedirs(OUT, exist_ok=True)
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    procs = {}
    for label, (path, flags) in variants.items():
        lib = os.path.join(OUT, f"k5_{label}.so")
        procs[label] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", *flags,
             "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (path, proc) in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n"
                               + "\n".join(lines[-30:]))
        for j, line in enumerate(lines):
            if "Compiling entry" in line:
                print(f"{label}: {line.split('for', 1)[0].strip()} "
                      + line.split("'")[1] + ": " + "; ".join(
                          v.split(":", 1)[-1].strip()
                          for v in lines[j + 1:j + 3]))
        lib = ctypes.CDLL(path)
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.qn_update_launch.restype = i
        lib.qn_update_launch.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i,
                                         d, vp]
        if hasattr(lib, "qn_update_info"):
            lib.qn_update_info.restype = i
            lib.qn_update_info.argtypes = [i, i, vp]
        libs[label] = lib
    return libs


def main(argv=None):
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="LABEL=PATH[+FLAG]",
                        help="sources to build and time (default: this "
                        "checkout's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from _torch_geometries import qn_update_arrays
    from optimization_solvers_tpu_torch.ops import fused_qn

    variants = {}
    for spec in args.variants or DEFAULT:
        label, rest = spec.split("=", 1)
        path, *flags = rest.split("+")
        variants[label] = (os.path.abspath(path), flags)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build(variants)
    print(f"built {len(libs)} source(s) in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    arrays = qn_update_arrays(B, N, curvature=True)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for dtype in (torch.float32, torch.float64):
        Bm, s, y, g = (torch.tensor(a, dtype=dtype, device=dev)
                       for a in arrays)
        Bn, Bg = torch.empty_like(Bm), torch.empty_like(g)
        code = 1 if dtype == torch.float64 else 0
        nbytes = (2 * N * N + 4 * N) * B * Bm.element_size()

        def launch(lib, kind):
            rc = lib.qn_update_launch(
                code, Bm.data_ptr(), s.data_ptr(), y.data_ptr(), g.data_ptr(),
                Bn.data_ptr(), Bg.data_ptr(), B, N, KINDS.index(kind), 1e-8,
                stream)
            if rc != 0:
                raise RuntimeError(f"qn_update_launch returned {rc}")

        skip = fused_qn.skip_mask(s, y, 1e-8)
        for label, lib in libs.items():
            for kind in KINDS:
                launch(lib, kind)
                torch.cuda.synchronize()
                Pn, Pg = fused_qn.qn_update_direction_plain(Bm, s, y, g, skip,
                                                            kind=kind)
                rel = max(((Bn - Pn).abs().max() / Pn.abs().max()).item(),
                          ((Bg - Pg).abs().max() / Pg.abs().max()).item())
                print(f"{label} {kind} {str(dtype)[6:]}: max|d| / max|entry| "
                      f"against the plain version {rel:.3g}, skipped B "
                      f"unchanged {torch.equal(Bn[1], Bm[1])}")
            where = "placement and resources not reported"
            if hasattr(lib, "qn_update_info"):
                out = (ctypes.c_int * 5)()
                rc = lib.qn_update_info(code, N, ctypes.addressof(out))
                shared, blocks, regs, local, smem = list(out)
                where = (f"error {rc}" if rc else
                         f"placement {'shared' if shared else 'workspace'}, "
                         f"{blocks} blocks per SM, {regs} registers, {local} "
                         f"local bytes a thread, {smem} bytes of shared "
                         "memory a block")
            print(f"{label}, {str(dtype)[6:]}: {where}")
        times = {(label, kind): [] for label in libs for kind in KINDS}
        labels = list(libs)
        for r in range(ROUNDS):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                for kind in KINDS:
                    launch(libs[label], kind)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(REPS):
                        launch(libs[label], kind)
                    stop.record()
                    torch.cuda.synchronize()
                    times[label, kind].append(
                        start.elapsed_time(stop) / REPS)
        for (label, kind), ts in times.items():
            ms = statistics.median(ts)
            rate = nbytes / (ms * 1e-3)
            print(f"{label} {kind} ({B}, {N}, {N}) {str(dtype)[6:]}: "
                  f"{1e3 * ms:.2f} us per launch (min {1e3 * min(ts):.2f}, "
                  f"max {1e3 * max(ts):.2f}; {ROUNDS} rounds of {REPS}); "
                  f"{rate / 1e12:.3f} TB/s, {rate / HBM_BYTES_PER_S:.3f} of "
                  f"3.35 TB/s  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
