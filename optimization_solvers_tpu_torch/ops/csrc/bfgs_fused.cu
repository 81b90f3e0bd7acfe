// Whole batched dense BFGS solves on Hopper (sm_90a), one block of four
// warps per instance (K9).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_bfgs.py
// (bfgs_solve_fused, kernel body _make_kernel, pl.pallas_call at :221).  The
// plain PyTorch version of the same algorithm is bfgs_solve_plain in
// ../fused_bfgs.py; the two are held against each other on the card.
//
// Design:
//  * each instance's (n, n) inverse-Hessian approximation lives in a
//    device-memory workspace of B n^2 elements (the TPU kernel's (n, n, T)
//    VMEM slab; its row_block chunking exists only to fit VMEM and has no
//    counterpart here), starting at the identity;
//  * one block of kWarps warps per instance.  d = -B g, B y and the rank-2
//    update are split by rows: warp w takes rows w, w + kWarps, ..., its
//    lanes walk a row's columns (coalesced), and a row's product is a warp
//    reduction;
//  * the objective, the search and the per-instance vectors run on warp 0
//    with the warp functors of objectives.cuh (coordinate i on lane i % 32);
//    the other warps wait at __syncthreads and read the decisions warp 0
//    leaves in shared memory (the active flag, the update gate, 1 / s.y);
//  * dynamic shared memory per block: X, G, D, the trial / new point XT,
//    the new gradient GN, s, y, B y and four scalars: 8n + 4 elements;
//  * the search is value-only Armijo from t = 1, halving up to max_iter_ls
//    times; a non-finite trial counts as a rejection, and after the last
//    rejection the halved step is taken all the same;
//  * the expanded update B - rho (s (By)^T + (By) s^T) + (rho^2 yBy + rho)
//    s s^T, applied only where ||s|| >= tol, ||y|| >= tol and s.y > eps
//    (the JAX kernel's literal, 1.2e-7 / 2.2e-16); no B0 scaling, no
//    restart; stop on the 2-norm ||g|| < tol.

#include "common.cuh"
#include "objectives.cuh"

namespace {

constexpr int kWarps = 4;

__host__ __device__ inline long long smem_elems(int n) { return 8LL * n + 4; }

__host__ __device__ inline long long workspace_elems(long long B, long long n) {
  return B * n * n;
}

template <typename T> struct Params {
  const T* x0;
  const T* d0;
  const T* d1;
  int B, n;
  T tol, eps, c1;
  int max_iter, max_iter_ls;
  T* work;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;        // value trials per instance
  int* nupd_out;        // updates of B per instance
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kWarps)
bfgs_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int inst = blockIdx.x;
  const int n = prm.n;

  T* p = reinterpret_cast<T*>(smem_raw);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* GN = p; p += n;
  T* SV = p; p += n;
  T* YV = p; p += n;
  T* BY = p; p += n;
  T* SC = p;           // [0] active flag, [1] update gate, [2] 1 / s.y

  T* Bm = prm.work + (long long)inst * n * n;
  for (int r = warp; r < n; r += kWarps) {
    T* row = Bm + (long long)r * n;
    for (int j = lane; j < n; j += kWarp) row[j] = j == r ? T(1) : T(0);
  }

  const Obj obj{prm.d0, prm.d1};
  // warp 0's replicated state
  T Fv = 0;
  int iters = 0;
  int nfev = 0;
  int nupd = 0;
  // ||g||_2 < tol (warp 0; a NaN entry fails the test)
  auto converged = [&]() {
    T gg = 0;
    for (int i = lane; i < n; i += kWarp) gg += G[i] * G[i];
    return sqrt(warp_sum(gg)) < prm.tol;
  };
  if (warp == 0) {
    const T* x0 = prm.x0 + (long long)inst * n;
    for (int i = lane; i < n; i += kWarp) X[i] = x0[i];
    __syncwarp();
    Fv = obj.value_grad(X, G, n, lane);
    __syncwarp();
    const bool active = isfinite(Fv) && !converged() && prm.max_iter > 0;
    if (lane == 0) SC[0] = active ? T(1) : T(0);
  }
  __syncthreads();

  while (SC[0] != T(0)) {
    // ---- d = -B g, by rows
    for (int r = warp; r < n; r += kWarps) {
      const T* row = Bm + (long long)r * n;
      T s = 0;
      for (int j = lane; j < n; j += kWarp) s += row[j] * G[j];
      s = warp_sum(s);
      if (lane == 0) D[r] = -s;
    }
    __syncthreads();

    if (warp == 0) {
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

      // ---- step, new gradient, s, y and the update gate
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      const T fnew = obj.value_grad(XT, GN, n, lane);
      __syncwarp();
      T sy = 0, ss = 0, yy = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T s = XT[i] - X[i];
        const T y = GN[i] - G[i];
        SV[i] = s;
        YV[i] = y;
        sy += s * y;
        ss += s * s;
        yy += y * y;
        X[i] = XT[i];
        G[i] = GN[i];
      }
      sy = warp_sum(sy);
      ss = warp_sum(ss);
      yy = warp_sum(yy);
      const bool upd = sqrt(ss) >= prm.tol && sqrt(yy) >= prm.tol && sy > prm.eps;
      nupd += upd;
      Fv = fnew;
      ++iters;
      __syncwarp();
      const bool active = isfinite(Fv) && !converged() && iters < prm.max_iter;
      if (lane == 0) {
        SC[0] = active ? T(1) : T(0);
        SC[1] = upd ? T(1) : T(0);
        SC[2] = T(1) / sy;
      }
    }
    __syncthreads();

    if (SC[1] != T(0)) {
      // ---- B y, by rows
      for (int r = warp; r < n; r += kWarps) {
        const T* row = Bm + (long long)r * n;
        T s = 0;
        for (int j = lane; j < n; j += kWarp) s += row[j] * YV[j];
        s = warp_sum(s);
        if (lane == 0) BY[r] = s;
      }
      __syncthreads();
      // every warp forms y.By itself (the same sum on every warp)
      T yBy = 0;
      for (int i = lane; i < n; i += kWarp) yBy += YV[i] * BY[i];
      yBy = warp_sum(yBy);
      const T rho = SC[2];
      const T coeff = rho * rho * yBy + rho;
      // ---- the rank-2 update, by rows
      for (int r = warp; r < n; r += kWarps) {
        T* row = Bm + (long long)r * n;
        const T si = SV[r];
        const T byi = BY[r];
        for (int j = lane; j < n; j += kWarp)
          row[j] = row[j] - rho * (si * BY[j] + byi * SV[j]) + coeff * (si * SV[j]);
      }
      __syncthreads();
    }
  }

  if (warp == 0) {
    const bool finite = isfinite(Fv);
    const int status = (converged() && finite) ? 1 : (!finite ? 3 : 2);
    for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
    if (lane == 0) {
      prm.f_out[inst] = Fv;
      prm.it_out[inst] = iters;
      prm.st_out[inst] = status;
      prm.nfev_out[inst] = nfev;
      prm.nupd_out[inst] = nupd;
    }
  }
}

template <typename T, class Obj>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long smem = smem_elems(prm.n) * (long long)sizeof(T);
  if (smem > kSmemPerBlock) return kErrSmem;
  auto kernel = bfgs_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<prm.B, kWarps * kWarp, (int)smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int objective, const void* x0, const void* d0, const void* d1, int B,
        int n, double tol, int max_iter, int max_iter_ls, double c1,
        void* work, void* x, void* f, void* it, void* st, void* nfev,
        void* nupd, void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.tol = (T)tol;
  prm.eps = (T)Lit<T>::eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.work = static_cast<T*>(work);
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.nfev_out = static_cast<int*>(nfev);
  prm.nupd_out = static_cast<int*>(nupd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>>(prm, s);
  if (prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
  if (objective == kWeightedSquares) return launch<T, WeightedSquares<T>>(prm, s);
  if (objective == kQuadratic) return launch<T, Quadratic<T>>(prm, s);
  return kErrArgs;
}

}  // namespace

extern "C" long long bfgs_fused_workspace_elems(long long B, long long n) {
  return workspace_elems(B, n);
}

// dtype 0: float32, 1: float64.  `work` holds bfgs_fused_workspace_elems(B,
// n) elements of the dtype.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int bfgs_fused_launch(int dtype, int objective, const void* x0,
                                 const void* d0, const void* d1, int B, int n,
                                 double tol, int max_iter, int max_iter_ls,
                                 double c1, void* work, void* x, void* f,
                                 void* it, void* st, void* nfev, void* nupd,
                                 void* stream) {
  if (B < 1 || n < 1 || work == nullptr) return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, d0, d1, B, n, tol, max_iter, max_iter_ls,
                      c1, work, x, f, it, st, nfev, nupd, stream);
  if (dtype == 1)
    return run<double>(objective, x0, d0, d1, B, n, tol, max_iter,
                       max_iter_ls, c1, work, x, f, it, st, nfev, nupd,
                       stream);
  return kErrArgs;
}
