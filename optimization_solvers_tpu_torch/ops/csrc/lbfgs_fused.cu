// Whole batched unconstrained L-BFGS solves on Hopper (sm_90a), one warp per
// instance (K7).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgs.py
// (lbfgs_solve_fused, kernel body _make_kernel, pl.pallas_call at :312).
// The plain PyTorch version of the same algorithm is lbfgs_solve_plain in
// ../fused_lbfgs.py; the two are held against each other on the card.
//
// Design:
//  * one warp per instance; coordinate i belongs to lane i % 32, so a lane
//    only ever writes its own coordinates of the per-instance vectors and
//    needs a __syncwarp() only around the objective functors (which read
//    other lanes' coordinates);
//  * dynamic shared memory per warp: X, G, the direction D (q, then r, then
//    d of the two-loop), the trial / new point XT, the new gradient GN, the
//    S and Y rings (m x n each), RHO, VAL and the two-loop's ALPHA:
//    (2m + 5) n + 3m elements; nothing but x0, the objective data and the
//    results touches device memory;
//  * the ring slot is the instance's own iteration count mod m.  The TPU
//    kernel's head is a tile-wide counter; the two agree because an
//    instance is active from its first iteration until it stops and is
//    never active again (x and g freeze once it stops).  A rejected pair
//    writes a zeroed slot with VAL 0, so the instance loses its oldest pair;
//  * reductions are __shfl_xor_sync butterflies, so every lane holds the
//    same sums and the scalar state (f, gamma, t) is replicated in
//    registers; every branch on it is warp-uniform;
//  * the search is value-only Armijo from t = 1, halving up to max_iter_ls
//    times; a non-finite trial counts as a rejection, and after the last
//    rejection the halved step is taken all the same;
//  * max/min propagate NaN as jnp.max does, and the curvature literal is
//    the JAX kernel's (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#include "common.cuh"
#include "objectives.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;

__host__ __device__ inline long long work_elems(int n, int m) {
  return (long long)(2 * m + 5) * n + 3LL * m;
}

template <typename T> struct Params {
  const T* x0;
  const T* d0;
  const T* d1;
  int B, n, m;
  T tol, eps, c1;
  int max_iter, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;        // value trials per instance
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
lbfgs_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, m = prm.m;

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems(n, m);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* GN = p; p += n;
  T* S = p; p += (long long)m * n;
  T* Y = p; p += (long long)m * n;
  T* RHO = p; p += m;
  T* VAL = p; p += m;
  T* ALPHA = p;

  const Obj obj{prm.d0, prm.d1};
  const T* x0 = prm.x0 + (long long)inst * n;
  for (int i = lane; i < n; i += kWarp) X[i] = x0[i];
  for (long long i = lane; i < (long long)m * n; i += kWarp) {
    S[i] = 0;
    Y[i] = 0;
  }
  for (int j = lane; j < m; j += kWarp) {
    RHO[j] = 0;
    VAL[j] = 0;
  }
  __syncwarp();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();

  // max|g| < tol (a NaN entry fails the test)
  auto converged = [&]() {
    T gmax = 0;
    for (int i = lane; i < n; i += kWarp) gmax = jmax(gmax, (T)fabs(G[i]));
    return warp_max(gmax) < prm.tol;
  };

  T gamma = 1;
  int iters = 0;
  int nfev = 0;
  bool active = isfinite(Fv) && !converged();
  while (active && iters < prm.max_iter) {
    const int head = iters % m;

    // ---- two-loop recursion over the ring, newest to oldest and back
    for (int i = lane; i < n; i += kWarp) D[i] = G[i];
    for (int j = 0; j < m; ++j) {
      const int idx = ((head - 1 - j) % m + m) % m;
      const T* Sj = S + (long long)idx * n;
      const T* Yj = Y + (long long)idx * n;
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Sj[i] * D[i];
      const T a = RHO[idx] * warp_sum(s) * VAL[idx];
      for (int i = lane; i < n; i += kWarp) D[i] = D[i] - a * Yj[i];
      if (lane == 0) ALPHA[j] = a;
    }
    __syncwarp();
    for (int i = lane; i < n; i += kWarp) D[i] = gamma * D[i];
    for (int j = m - 1; j >= 0; --j) {
      const int idx = ((head - 1 - j) % m + m) % m;
      const T* Sj = S + (long long)idx * n;
      const T* Yj = Y + (long long)idx * n;
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Yj[i] * D[i];
      const T b = RHO[idx] * warp_sum(s) * VAL[idx];
      const T ab = ALPHA[j] - b;
      for (int i = lane; i < n; i += kWarp) D[i] = D[i] + ab * Sj[i];
    }
    for (int i = lane; i < n; i += kWarp) D[i] = -D[i];

    // ---- value-only Armijo backtracking
    T g0d = 0;
    for (int i = lane; i < n; i += kWarp) g0d += G[i] * D[i];
    g0d = warp_sum(g0d);
    T t = 1;
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      const T ft = obj.value(XT, n, lane);
      ++nfev;
      __syncwarp();
      if (ft <= Fv + prm.c1 * t * g0d && isfinite(ft)) break;
      t = t * T(0.5);
    }

    // ---- step, new gradient, ring write at the instance's own slot
    for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
    __syncwarp();
    const T fnew = obj.value_grad(XT, GN, n, lane);
    __syncwarp();
    T sy = 0, yy = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T s = XT[i] - X[i];
      const T y = GN[i] - G[i];
      sy += s * y;
      yy += y * y;
    }
    sy = warp_sum(sy);
    yy = warp_sum(yy);
    const bool accept = sy > prm.eps * yy;
    T* Sh = S + (long long)head * n;
    T* Yh = Y + (long long)head * n;
    for (int i = lane; i < n; i += kWarp) {
      Sh[i] = accept ? XT[i] - X[i] : T(0);
      Yh[i] = accept ? GN[i] - G[i] : T(0);
      X[i] = XT[i];
      G[i] = GN[i];
    }
    if (lane == 0) {
      RHO[head] = accept ? T(1) / sy : T(0);
      VAL[head] = accept ? T(1) : T(0);
    }
    if (accept) gamma = sy / yy;
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
  const long long per_warp = work_elems(prm.n, prm.m) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > prm.B) wpb = prm.B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = lbfgs_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((prm.B + wpb - 1) / wpb);
  kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int objective, const void* x0, const void* d0, const void* d1, int B,
        int n, int m, double tol, int max_iter, int max_iter_ls, double c1,
        void* x, void* f, void* it, void* st, void* nfev, void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.m = m;
  prm.tol = (T)tol;
  prm.eps = (T)Lit<T>::eps;
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
  if (objective == kQuadratic) return launch<T, Quadratic<T>>(prm, s);
  return kErrArgs;
}

}  // namespace

extern "C" long long lbfgs_fused_smem_per_warp(int n, int m, int elem_size) {
  return work_elems(n, m) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int lbfgs_fused_launch(int dtype, int objective, const void* x0,
                                  const void* d0, const void* d1, int B, int n,
                                  int m, double tol, int max_iter,
                                  int max_iter_ls, double c1, void* x, void* f,
                                  void* it, void* st, void* nfev,
                                  void* stream) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM) return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, d0, d1, B, n, m, tol, max_iter,
                      max_iter_ls, c1, x, f, it, st, nfev, stream);
  if (dtype == 1)
    return run<double>(objective, x0, d0, d1, B, n, m, tol, max_iter,
                       max_iter_ls, c1, x, f, it, st, nfev, stream);
  return kErrArgs;
}
