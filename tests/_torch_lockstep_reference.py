"""The lockstep quasi-Newton path of ``chip_smoke.py`` on the CPU, through
the JAX package and through the port, at a reduced batch; and two
measurements behind the lockstep tests' choice of geometry.

The path: ``batch_minimize(QuasiNewton(update="bfgs", tol=2e-4,
fused=True), MoreThuente(approx_wolfe=True), make_oracle(rosenbrock()),
x0, fused=False, max_iter=1500, max_iter_ls=40)`` with config 2's float32
starts (``RandomState(42).uniform(-2, 2, (1024, 100))``), without config
2's ``scale_b0`` and ``restart_on_degeneracy`` (the fused update refuses
them).  The first ``--rows`` starts (64 by default) run through JAX's
lockstep driver (XLA on the CPU) and through the port's lockstep loop on a
CPU tensor (the plain version of K5); the script prints, for each, the
converged fraction, the success fraction (CONVERGED or STALLED), the
median iterations and the median f.

``--geometry`` prints instead (float64 unless stated):

* K5's plain version in float32 against itself in float64, relative to
  the largest entry, on random pairs (``tests/test_ops.py``'s geometry,
  ``s.y`` of either sign) and on curvature pairs (``s.y > 0``), at
  (1,024, 100, 100) (``_torch_geometries.qn_update_arrays``);
* the box-active weighted quadratic (``d = linspace(1, 50, 8)``, ``t =
  linspace(-2.5, 3.5, 8)``): PGD + BackTrackingB in the box [-1.5, 2.5]
  at tol 1e-8, and BFGSB + MoreThuenteB with per-instance boxes
  ``[-U(0.5, 2), U(0.5, 2)]`` at tol 1e-9, through both packages'
  lockstep drivers: status, iterations and max |dx|.

It needs both packages and runs on the CPU only (pytest does not collect
it):

    JAX_PLATFORMS=cpu python tests/_torch_lockstep_reference.py [--rows 64]
    JAX_PLATFORMS=cpu python tests/_torch_lockstep_reference.py --geometry
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def summary(name, status, iterations, f, seconds):
    status, iterations, f = (np.asarray(v) for v in (status, iterations, f))
    print(f"{name}: converged {np.mean(status == 1):.4f}, success (1 or 6) "
          f"{np.mean(np.isin(status, (1, 6))):.4f}, median iterations "
          f"{np.median(iterations):.0f} (max {iterations.max()}), median f "
          f"{np.median(f):.6g}, {seconds:.1f} s", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=64)
    parser.add_argument("--geometry", action="store_true")
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.geometry:
        jax.config.update("jax_enable_x64", True)
        return geometry()
    import jax.numpy as jnp
    import torch

    import optimization_solvers_tpu.linesearch as jls
    import optimization_solvers_tpu.solvers as jsolvers
    from optimization_solvers_tpu.core import problems as jproblems
    from optimization_solvers_tpu.core.oracle import make_oracle as jmake
    from optimization_solvers_tpu_torch import linesearch as ls, solvers
    from optimization_solvers_tpu_torch.core import problems
    from optimization_solvers_tpu_torch.core.oracle import make_oracle

    starts = np.random.RandomState(42).uniform(-2.0, 2.0, (1024, 100))
    x0 = starts[:args.rows].astype(np.float32)
    kw = dict(max_iter=1500, max_iter_ls=40)

    t = time.perf_counter()
    r = jsolvers.batch_minimize(
        jsolvers.QuasiNewton(update="bfgs", tol=2e-4, fused=True),
        jls.MoreThuente(approx_wolfe=True), jmake(jproblems.rosenbrock()),
        jnp.asarray(x0), fused=False, **kw)
    r.x.block_until_ready()
    summary(f"JAX lockstep (XLA, CPU), {args.rows} x 100, float32",
            r.status, r.iterations, r.f, time.perf_counter() - t)

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t = time.perf_counter()
    r = solvers.batch_minimize(
        solvers.QuasiNewton(update="bfgs", tol=2e-4, fused=True),
        ls.MoreThuente(approx_wolfe=True), make_oracle(problems.rosenbrock()),
        torch.from_numpy(x0), fused=False, **kw)
    summary(f"port lockstep (plain K5, CPU), {args.rows} x 100, float32",
            r.status, r.iterations, r.f, time.perf_counter() - t)
    return 0


def geometry():
    import jax.numpy as jnp
    import torch

    import optimization_solvers_tpu.linesearch as jls
    import optimization_solvers_tpu.solvers as jsolvers
    from _torch_geometries import qn_update_arrays
    from optimization_solvers_tpu.core.oracle import make_oracle as jmake
    from optimization_solvers_tpu_torch import linesearch as ls, solvers
    from optimization_solvers_tpu_torch.core import problems
    from optimization_solvers_tpu_torch.core.oracle import make_oracle
    from optimization_solvers_tpu_torch.ops import fused_qn

    for curvature in (False, True):
        t64 = [torch.from_numpy(a) for a in qn_update_arrays(
            1024, 100, curvature=curvature)]
        t32 = [a.float() for a in t64]
        skip = fused_qn.skip_mask(t64[1], t64[2], 1e-8)
        rel = {}
        for kind in fused_qn.KINDS:
            p64 = fused_qn.qn_update_direction_plain(*t64, skip, kind=kind)
            p32 = fused_qn.qn_update_direction_plain(*t32, skip, kind=kind)
            rel[kind] = max(
                ((a.double() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(p32, p64))
        pairs = "curvature" if curvature else "random"
        print(f"K5 plain float32 vs float64, {pairs} pairs: "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))

    n = 8
    d, t = np.linspace(1.0, 50.0, n), np.linspace(-2.5, 3.5, n)
    x0 = np.random.RandomState(0).uniform(-2, 2, (4, n))
    jo = jmake(lambda x: 0.5 * jnp.sum(jnp.asarray(d) * (x - jnp.asarray(t))
                                       ** 2))
    po = make_oracle(problems.weighted_squares(),
                     data=(torch.from_numpy(d), torch.from_numpy(t)))
    rng = np.random.RandomState(4)
    lo_b, up_b = -rng.uniform(0.5, 2.0, (4, n)), rng.uniform(0.5, 2.0, (4, n))
    cases = (
        ("PGD + BackTrackingB, box [-1.5, 2.5], tol 1e-8",
         "ProjectedGradientDescent", dict(grad_tol=1e-8), "BackTrackingB",
         (np.full(n, -1.5), np.full(n, 2.5)), False, 300),
        ("BFGSB + MoreThuenteB, per-instance boxes, tol 1e-9", "BFGSB",
         dict(tol=1e-9), "MoreThuenteB", (lo_b, up_b), True, 200))
    for what, m, mkw, srch, (lo, up), per, max_iter in cases:
        rj = jsolvers.batch_minimize(
            getattr(jsolvers, m)(**mkw), getattr(jls, srch)(), jo,
            jnp.asarray(x0), bounds=(jnp.asarray(lo), jnp.asarray(up)),
            batched_bounds=per, fused=False, max_iter=max_iter)
        rt = solvers.batch_minimize(
            getattr(solvers, m)(**mkw), getattr(ls, srch)(), po,
            torch.from_numpy(x0), bounds=(torch.from_numpy(lo),
                                          torch.from_numpy(up)),
            batched_bounds=per, fused=False, max_iter=max_iter)
        print(f"{what}: status JAX {np.asarray(rj.status).tolist()} port "
              f"{rt.status.tolist()}, iterations JAX "
              f"{np.asarray(rj.iterations).tolist()} port "
              f"{rt.iterations.tolist()}, max|dx| "
              f"{np.abs(np.asarray(rj.x) - rt.x.numpy()).max():.3g}, f "
              f"{float(np.asarray(rj.f).max()):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
