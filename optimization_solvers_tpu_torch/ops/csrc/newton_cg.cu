// Newton-CG kernel K4 on Hopper (sm_90a): batched box-constrained truncated
// Newton-CG whole solves, one warp per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_newton_cg.py
// (newton_cg_solve_fused, kernel body _make_kernel at :70, pl.pallas_call
// at :340).  The plain PyTorch version of the same algorithm is
// newton_cg_solve_plain in ../fused_newton_cg.py; the two are held against
// each other on the card.
//
// Algorithm (pallas_newton_cg.py:70-267): the outer loop stops on the
// projection-arc residual max_i |x_i - P(x - g)_i| <= pgtol or on the
// relative decrease f_prev - f <= factr eps max(|f|, |f_prev|, 1); each
// iteration takes a two-metric direction (coordinates within min(pg, 1e-2)
// of a bound with the gradient pushing outward take -g, the free ones a
// truncated CG solve of H d = -g on the free subspace: the Steihaug exit on
// p.Hp <= eps p.p with the -g_F fallback before the first step, the
// Eisenstat-Walker forcing ||r||^2 <= (min(sqrt(||g_F||), 0.5) ||g_F||)^2,
// beta = rr_new / max(rr, eps)), a zero direction falls back to -g, then a
// projected backtracking Armijo search halving t from 1, and the step is
// taken where its value and point are finite.  eps is finfo(dtype).eps
// (1.1920929e-7 / 2.220446e-16), not K3's literals.
//
// The TPU kernel's lanes are independent: every state write is masked by
// the lane's own active / CG-done / search-done flag, so one warp that
// leaves its CG loop and its search when its own instance is done computes
// what the TPU kernel computes at any tile.  The Hessian-vector products
// are the objective's analytic hvp functor (objectives.cuh); the TPU kernel
// traces forward-over-reverse AD instead, which rounds differently.
//
// What bounds it on this card: latency.  Per CG step an instance does one
// HVP (Rosenbrock: ~8 n operations) and three passes over its n
// coordinates, each ending in a warp reduction; per outer iteration a
// handful of such passes, the search's value trials and one value and
// gradient.  At the Newton-CG headline (n = 100, 10,240 instances) all
// state of a warp, 8 n elements (3.2 KB in float32), lives in shared
// memory; enough warps per SM hide one another's reductions.
//
// Design:
//  * one warp per instance, coordinate i on lane i % 32; dynamic shared
//    memory per warp: X, G, D, the CG residual R and direction P, the
//    product Hp (Q, also the gradient at the new point), the trial point
//    (XT, also the masked p fed to the HVP) and the free mask (FR, 0 or 1):
//    8 n elements; the bounds (n,) stay in device memory, shared by all
//    warps;
//  * scalars (f, f_prev, rr, t, ...) are replicated in registers after
//    __shfl_xor_sync butterflies, so every branch is warp-uniform;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do.

#include "common.cuh"
#include "objectives.cuh"

namespace {

constexpr int kMaxWarpsK4 = 8;

__host__ __device__ inline long long k4_work_elems(int n) { return 8LL * n; }

template <typename T> struct K4Params {
  const T* x0;
  const T* lo;
  const T* up;
  const T* d0;
  const T* d1;
  int B, n;
  T pgtol, f_rtol, eps, c1;
  int max_iter, cg_max, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* ncg_out;         // Hessian-vector products (CG steps tried)
  int* nfev_out;        // line-search trials
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kMaxWarpsK4)
newton_cg_kernel(const K4Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n;
  const T INF = (T)INFINITY;

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * k4_work_elems(n);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* R = p; p += n;
  T* P = p; p += n;
  T* Q = p; p += n;
  T* XT = p; p += n;
  T* FR = p;

  const T* lo = prm.lo;
  const T* up = prm.up;
  const T* x0 = prm.x0 + (long long)inst * n;
  const Obj obj{prm.d0, prm.d1};

  for (int i = lane; i < n; i += kWarp) X[i] = jclip(x0[i], lo[i], up[i]);
  __syncwarp();
  T F = obj.value_grad(X, G, n, lane);
  __syncwarp();
  T Fprev = INF;
  int iters = 0, ncg = 0, nfev = 0;

  // max_i |x_i - P(x - g)_i| (pallas_newton_cg.py:98-100)
  auto pg_inf = [&]() -> T {
    T mx = 0;
    for (int i = lane; i < n; i += kWarp)
      mx = jmax(mx, (T)fabs(X[i] - jclip(X[i] - G[i], lo[i], up[i])));
    return warp_max(mx);
  };
  auto converged = [&]() -> bool {
    const bool small = pg_inf() <= prm.pgtol;
    const T fmax = jmax(jmax((T)fabs(F), (T)fabs(Fprev)), T(1));
    return small || (isfinite(Fprev) && (Fprev - F) <= prm.f_rtol * fmax);
  };

  for (int it = 0; it < prm.max_iter; ++it) {
    if (!isfinite(F) || converged()) break;

    // ---- two-metric direction: the free mask, then CG on the free
    // subspace (pallas_newton_cg.py:126-202)
    const T w = jmin(pg_inf(), T(1e-2));
    T gn2 = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T g = G[i];
      const bool act = (X[i] - lo[i] <= w && g > T(0)) || (up[i] - X[i] <= w && g < T(0));
      const T fr = act ? T(0) : T(1);
      const T gF = g * fr;
      FR[i] = fr;
      R[i] = gF;
      P[i] = -gF;
      D[i] = 0;
      gn2 += gF * gF;
    }
    gn2 = warp_sum(gn2);
    const T gn = sqrt(gn2);
    const T eta = jmin((T)sqrt(jmax(gn, T(0))), T(0.5));
    const T e = eta * gn;
    const T rtol2 = e * e;
    T rr = gn2;
    bool done = gn2 <= rtol2;
    int steps = 0;
    __syncwarp();
    for (int k = 0; k < prm.cg_max && !done; ++k) {
      for (int i = lane; i < n; i += kWarp) XT[i] = P[i] * FR[i];
      __syncwarp();
      obj.hvp(X, XT, Q, n, lane);
      ++ncg;
      __syncwarp();
      T pq = 0, pp = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T q = Q[i] * FR[i];
        Q[i] = q;
        pq += P[i] * q;
        pp += P[i] * P[i];
      }
      pq = warp_sum(pq);
      pp = warp_sum(pp);
      // Steihaug: stop on curvature at most eps p.p; before any step the
      // direction is -g_F
      const bool negc = pq <= prm.eps * pp;
      const bool restart = negc && steps == 0;
      const T alpha = negc ? T(0) : rr / pq;
      T rn = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T dv = restart ? -(G[i] * FR[i]) : D[i];
        D[i] = dv + alpha * P[i];
        const T r = R[i] + alpha * Q[i];
        R[i] = r;
        rn += r * r;
      }
      const T rr_new = warp_sum(rn);
      if (!negc) {
        const T beta = rr_new / jmax(rr, prm.eps);
        for (int i = lane; i < n; i += kWarp) P[i] = -R[i] + beta * P[i];
        rr = rr_new;
        ++steps;
      }
      done = negc || rr_new <= rtol2;
      __syncwarp();
    }
    // epsilon-active coordinates move along -g; a zero direction falls back
    // to -g
    T dn = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T d = FR[i] > T(0) ? D[i] : -G[i];
      D[i] = d;
      dn += d * d;
    }
    if (!(warp_sum(dn) > T(0)))
      for (int i = lane; i < n; i += kWarp) D[i] = -G[i];
    __syncwarp();

    // ---- projected backtracking Armijo on P(x + t d)
    // (pallas_newton_cg.py:204-234); on exhaustion t is the last, untested
    // halving
    T t = 1;
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      T gs = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T xt = jclip(X[i] + t * D[i], lo[i], up[i]);
        XT[i] = xt;
        gs += G[i] * (xt - X[i]);
      }
      gs = warp_sum(gs);
      __syncwarp();
      const T ft = obj.value(XT, n, lane);
      ++nfev;
      __syncwarp();
      if (ft <= F + prm.c1 * gs && isfinite(ft)) break;
      t = t * T(0.5);
    }

    // ---- the step, taken where its value and point are finite; f_prev
    // advances only then
    bool fin = true;
    for (int i = lane; i < n; i += kWarp) {
      const T xn = jclip(X[i] + t * D[i], lo[i], up[i]);
      XT[i] = xn;
      fin = fin && isfinite(xn);
    }
    fin = __all_sync(kFull, fin);
    __syncwarp();
    const T fnew = obj.value_grad(XT, Q, n, lane);
    __syncwarp();
    if (isfinite(fnew) && fin) {
      Fprev = F;
      F = fnew;
      for (int i = lane; i < n; i += kWarp) {
        X[i] = XT[i];
        G[i] = Q[i];
      }
    }
    ++iters;
    __syncwarp();
  }

  // the TPU kernel's exit: convergence recomputed on the final state, then
  // out of domain where f is not finite, else the budget
  const bool conv = converged();
  const bool finite = isfinite(F);
  const int status = (conv && finite) ? 1 : (!finite ? 3 : 2);
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = F;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.ncg_out[inst] = ncg;
    prm.nfev_out[inst] = nfev;
  }
}

template <typename T, class Obj>
int k4_launch(const K4Params<T>& prm, cudaStream_t stream) {
  const long long per_warp = k4_work_elems(prm.n) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsK4) wpb = kMaxWarpsK4;
  if (wpb > prm.B) wpb = prm.B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = newton_cg_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((prm.B + wpb - 1) / wpb);
  kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int k4_run(int objective, const void* x0, const void* lo, const void* up,
           const void* d0, const void* d1, int B, int n, double pgtol,
           double f_rtol, double eps, int max_iter, int cg_max,
           int max_iter_ls, double c1, void* x, void* f, void* it, void* st,
           void* ncg, void* nfev, void* stream) {
  K4Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.pgtol = (T)pgtol;
  prm.f_rtol = (T)f_rtol;
  prm.eps = (T)eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.cg_max = cg_max;
  prm.max_iter_ls = max_iter_ls;
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.ncg_out = static_cast<int*>(ncg);
  prm.nfev_out = static_cast<int*>(nfev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (objective == kRosenbrock) return k4_launch<T, Rosenbrock<T>>(prm, s);
  if (objective == kQuadratic) return k4_launch<T, Quadratic<T>>(prm, s);
  return k4_launch<T, WeightedSquares<T>>(prm, s);
}

}  // namespace

extern "C" long long newton_cg_smem_per_warp(int n, int elem_size) {
  return k4_work_elems(n) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  lo and up are (n,) device arrays; d0 and
// d1 the objective's data (WeightedSquares: d, t; Quadratic: Q, b).  f_rtol
// is factr * eps.  ncg and nfev receive each instance's Hessian-vector
// products and line-search trials.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int newton_cg_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    const void* d0, const void* d1, int B, int n, double pgtol, double f_rtol,
    double eps, int max_iter, int cg_max, int max_iter_ls, double c1, void* x,
    void* f, void* it, void* st, void* ncg, void* nfev, void* stream) {
  if (B < 1 || n < 1 || x0 == nullptr || lo == nullptr || up == nullptr ||
      (objective != kRosenbrock && objective != kWeightedSquares &&
       objective != kQuadratic) ||
      (objective != kRosenbrock && (d0 == nullptr || d1 == nullptr)))
    return kErrArgs;
  if (dtype == 0)
    return k4_run<float>(objective, x0, lo, up, d0, d1, B, n, pgtol, f_rtol,
                         eps, max_iter, cg_max, max_iter_ls, c1, x, f, it, st,
                         ncg, nfev, stream);
  if (dtype == 1)
    return k4_run<double>(objective, x0, lo, up, d0, d1, B, n, pgtol, f_rtol,
                          eps, max_iter, cg_max, max_iter_ls, c1, x, f, it, st,
                          ncg, nfev, stream);
  return kErrArgs;
}
