// Whole batched box-constrained SPG solves on Hopper (sm_90a), one warp per
// instance (K8).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_spg.py
// (spg_solve_fused, kernel body _make_kernel, pl.pallas_call at :195): the
// reference SPG (projected Barzilai-Borwein step, GLL non-monotone Armijo,
// safeguarded BB scalar) without the policy overlays of K3's SPG spec.  The
// plain PyTorch version of the same algorithm is spg_solve_plain in
// ../fused_spg.py; the two are held against each other on the card.
//
// Design:
//  * one warp per instance; coordinate i belongs to lane i % 32 (see
//    lbfgs_fused.cu);
//  * dynamic shared memory per warp: X, G, the direction D, the trial / new
//    point XT, the new gradient GN, the shared box LO and UP, and the GLL
//    history FH of gll_m values: 7n + gll_m elements;
//  * x0 is clipped into the box; lambda_0 = clip(1 / ||P(x0 - g0) - x0||_inf,
//    lam_min, lam_max), so a zero projected step gives lam_max;
//  * the GLL history starts at -inf and takes f every iteration, the oldest
//    value dropping out.  The TPU kernel shifts its history and appends;
//    here slot (own iteration count mod gll_m) is overwritten, which holds
//    the same set of values, and the Armijo reference is their max;
//  * the search is value-only Armijo from t = 1 against that max, halving
//    up to max_iter_ls times; a non-finite trial counts as a rejection, and
//    after the last rejection the halved step is taken all the same;
//  * BB scalar: lam_max where s.y <= 0, else clip(s.s / s.y, lam_min,
//    lam_max); stop on ||x - P(x - g)||_inf < tol;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do.

#include "common.cuh"
#include "objectives.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;

__host__ __device__ inline long long work_elems(int n, int gll_m) {
  return 7LL * n + gll_m;
}

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  const T* d0;
  const T* d1;
  int B, n, gll_m;
  T tol, lam_min, lam_max, c1;
  int max_iter, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;        // value trials per instance
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
spg_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, gll_m = prm.gll_m;
  const T INF = (T)INFINITY;

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems(n, gll_m);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* GN = p; p += n;
  T* LO = p; p += n;
  T* UP = p; p += n;
  T* FH = p;

  const Obj obj{prm.d0, prm.d1};
  const T* x0 = prm.x0 + (long long)inst * n;
  for (int i = lane; i < n; i += kWarp) {
    LO[i] = prm.lo[i];
    UP[i] = prm.up[i];
    X[i] = jclip(x0[i], LO[i], UP[i]);
  }
  for (int j = lane; j < gll_m; j += kWarp) FH[j] = -INF;
  __syncwarp();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();

  T dmax = 0;
  for (int i = lane; i < n; i += kWarp)
    dmax = jmax(dmax, (T)fabs(jclip(X[i] - G[i], LO[i], UP[i]) - X[i]));
  T lam = jclip(T(1) / warp_max(dmax), prm.lam_min, prm.lam_max);

  // ||x - P(x - g)||_inf < tol (a NaN entry fails the test)
  auto converged = [&]() {
    T pg = 0;
    for (int i = lane; i < n; i += kWarp)
      pg = jmax(pg, (T)fabs(X[i] - jclip(X[i] - G[i], LO[i], UP[i])));
    return warp_max(pg) < prm.tol;
  };

  int iters = 0;
  int nfev = 0;
  bool active = isfinite(Fv) && !converged();
  while (active && iters < prm.max_iter) {
    // ---- projected BB direction and the GLL reference value
    T g0d = 0;
    for (int i = lane; i < n; i += kWarp) {
      D[i] = jclip(X[i] - lam * G[i], LO[i], UP[i]) - X[i];
      g0d += G[i] * D[i];
    }
    g0d = warp_sum(g0d);
    if (lane == 0) FH[iters % gll_m] = Fv;
    __syncwarp();
    T fmax = -INF;
    for (int j = lane; j < gll_m; j += kWarp) fmax = jmax(fmax, FH[j]);
    fmax = warp_max(fmax);

    // ---- value-only non-monotone Armijo backtracking
    T t = 1;
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      const T ft = obj.value(XT, n, lane);
      ++nfev;
      __syncwarp();
      if (ft <= fmax + prm.c1 * t * g0d && isfinite(ft)) break;
      t = t * T(0.5);
    }

    // ---- step, new gradient, safeguarded BB scalar
    for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
    __syncwarp();
    const T fnew = obj.value_grad(XT, GN, n, lane);
    __syncwarp();
    T sy = 0, ss = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T s = XT[i] - X[i];
      const T y = GN[i] - G[i];
      sy += s * y;
      ss += s * s;
      X[i] = XT[i];
      G[i] = GN[i];
    }
    sy = warp_sum(sy);
    ss = warp_sum(ss);
    lam = sy <= T(0) ? prm.lam_max : jclip(ss / sy, prm.lam_min, prm.lam_max);
    Fv = fnew;
    ++iters;
    __syncwarp();
    active = isfinite(Fv) && !converged();
  }

  const bool finite = isfinite(Fv);
  const int status = (converged() && finite) ? 1 : (!finite ? 3 : 2);
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.nfev_out[inst] = nfev;
  }
}

template <typename T, class Obj>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long per_warp = work_elems(prm.n, prm.gll_m) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > prm.B) wpb = prm.B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = spg_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((prm.B + wpb - 1) / wpb);
  kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        const void* d0, const void* d1, int B, int n, double tol,
        double lam_min, double lam_max, int gll_m, double c1, int max_iter,
        int max_iter_ls, void* x, void* f, void* it, void* st, void* nfev,
        void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.gll_m = gll_m;
  prm.tol = (T)tol;
  prm.lam_min = (T)lam_min;
  prm.lam_max = (T)lam_max;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.nfev_out = static_cast<int*>(nfev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>>(prm, s);
  if (prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
  if (objective == kWeightedSquares) return launch<T, WeightedSquares<T>>(prm, s);
  return kErrArgs;
}

}  // namespace

extern "C" long long spg_fused_smem_per_warp(int n, int gll_m, int elem_size) {
  return work_elems(n, gll_m) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int spg_fused_launch(int dtype, int objective, const void* x0,
                                const void* lo, const void* up, const void* d0,
                                const void* d1, int B, int n, double tol,
                                double lam_min, double lam_max, int gll_m,
                                double c1, int max_iter, int max_iter_ls,
                                void* x, void* f, void* it, void* st, void* nfev,
                                void* stream) {
  if (B < 1 || n < 1 || gll_m < 1) return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, d0, d1, B, n, tol, lam_min,
                      lam_max, gll_m, c1, max_iter, max_iter_ls, x, f, it, st,
                      nfev, stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, d0, d1, B, n, tol, lam_min,
                       lam_max, gll_m, c1, max_iter, max_iter_ls, x, f, it,
                       st, nfev, stream);
  return kErrArgs;
}
