// Whole batched dense BFGS solves on Hopper (sm_90a), one block per
// instance, the matrix in the block's shared memory (K9): the kernel and
// its launch.  bfgs_fused.cu builds its Rosenbrock, WeightedSquares and
// Quadratic instances with the C interface, bfgs_fused_data.cu its
// LogSumExp instances (one nvcc a source: the earlier functors' instances
// compile in a unit of the same content as before LogSumExp was added).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_bfgs.py
// (bfgs_solve_fused, kernel body _make_kernel, pl.pallas_call at :221).  The
// plain PyTorch version of the same algorithm is bfgs_solve_plain in
// ../fused_bfgs.py; the two are held against each other on the card.
//
// What bounds it.  Per iteration an instance makes three passes over its
// (n, n) inverse-Hessian approximation (d = -B g, B y, the rank-2 update's
// read and write), ~10 n^2 operations, beside the objective's latency
// chain on one warp.  The TPU kernel keeps the (n, n, T) slab in VMEM
// (pallas_bfgs.py:4-7, :216); a slab in device memory (the design until
// this one: 1,024 slabs of 40 KB at config 2's inputs, 41 MB) streamed
// ~164 MB per iteration of the batch.  So the slab lives in the block's
// shared memory (20.2 KB at n = 100 in float32: the packed upper
// triangle) and the block's warps split each pass.
//
// Design:
//  * each instance's inverse-Hessian approximation, starting at the
//    identity, is a slab of dense_slab.cuh: its packed upper triangle (the
//    BFGS update keeps B symmetric bit for bit: the cross term is two
//    unfused products, whose sum does not depend on their order), in the
//    block's dynamic shared memory behind the vectors where both fit
//    kSmemPerBlock, else in a device-memory workspace of one slab per
//    instance (the launch picks the placement by in_shared, the wrapper
//    mirrors it); the TPU kernel's row_block chunking exists only to fit
//    VMEM and has no counterpart here;
//  * one block of kDenseWarps warps per instance.  d = -B g and B y: thread
//    k of the block sums output k over the slab (dense_slab.cuh slab_mv);
//    the rank-2 update splits the rows over the warps, the lanes along a
//    row;
//  * the objective, the search and the per-instance vectors run on warp 0
//    with the warp functors of objectives.cuh (coordinate i on lane i % 32);
//    the other warps wait at the block barrier (block_bar) and read the
//    decisions warp 0 leaves in shared memory (the active flag, the update
//    gate, 1 / s.y);
//  * dynamic shared memory per block: X, G, D, the trial / new point XT,
//    the new gradient GN, s, y, B y and four scalars (8n + 4 elements),
//    the log-sum-exp's z (rows elements; warp 0's evaluations), then the
//    slab.  The kernel compiles the four functors; the quadratic reads Q
//    from device memory (L2) on warp 0 alone: slow, and right;
//  * the search is value-only Armijo from t = 1, halving up to max_iter_ls
//    times; a non-finite trial counts as a rejection, and after the last
//    rejection the halved step is taken all the same;
//  * the expanded update B - rho (s (By)^T + (By) s^T) + (rho^2 yBy + rho)
//    s s^T, applied only where ||s|| >= tol, ||y|| >= tol and s.y > eps
//    (the JAX kernel's literal, 1.2e-7 / 2.2e-16); no B0 scaling, no
//    restart; stop on the 2-norm ||g|| < tol.

#pragma once

#include "common.cuh"
#include "dense_slab.cuh"
#include "objectives.cuh"

// Phase counters, compiled in only with -DK9_PROFILE (tools/k3_phase_profile.py
// builds such a copy; the kernel as shipped has none).  Lane 0 of warp 0
// adds the clock64 cycles of every iteration's phases to k9_prof[0..5] (the
// phases in that tool's K3_PHASES order: the direction's pass, the search
// trials, the value and gradient, B y, the update, the checks); [6] counts
// instance-iterations, [7] trials, [8] instances, [9] updates, [10] the
// cycles of whole instances.
#ifdef K9_PROFILE
namespace {
__device__ unsigned long long k9_prof[16];
}
#define K9_PROF(...) __VA_ARGS__
#else
#define K9_PROF(...)
#endif
#define K9_PHASE(k)                                               \
  K9_PROF(if (tid == 0) {                                         \
    const long long t_ = clock64();                               \
    prof_acc[k] += t_ - prof_t;                                   \
    prof_t = t_;                                                  \
  })

namespace {

using namespace ost_slab;

// the block's vectors X, G, D, XT, GN, s, y, B y, four scalar slots and
// LOG_SUM_EXP's z of `rows` elements (rows 0 for the other functors), then
// the slab where it fits (dense_slab.cuh's fit rule)
__host__ __device__ inline long long vec_elems(int n, int rows) { return 8LL * n + 4 + rows; }

__host__ __device__ inline bool in_shared(int n, int elem_size, int rows) {
  return slab_in_shared(vec_elems(n, rows), n, kSlabBFGS, elem_size);
}

__host__ __device__ inline long long smem_elems(int n, int elem_size, int rows) {
  return vec_elems(n, rows) + (in_shared(n, elem_size, rows) ? slab_elems(n, kSlabBFGS) : 0);
}

__host__ __device__ inline long long workspace_elems(long long B, int n, int elem_size,
                                                     int rows) {
  return in_shared(n, elem_size, rows) ? 0 : B * slab_elems(n, kSlabBFGS);
}

template <typename T> struct Params {
  const T* x0;
  const T* d0;
  const T* d1;
  int B, n;
  T tol, eps, c1;
  int max_iter, max_iter_ls;
  int slab_shared;      // the slab in shared memory (set by the launch)
  T* work;              // workspace_elems slab elements (else nullptr)
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;        // value trials per instance
  int* nupd_out;        // updates of B per instance
  int rows;             // LOG_SUM_EXP's rows (0 otherwise)
};

// the body, with the triangle in shared memory (kShared: its pointer taken
// from the block's buffer, so the passes load and store shared memory with
// 32-bit addresses) or in the workspace
template <typename T, class Obj, bool kShared>
__device__ __forceinline__ void bfgs_body(const Params<T>& prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  T* SC = p; p += 4;   // [0] active flag, [1] update gate, [2] 1 / s.y
  // LOG_SUM_EXP's z, read by warp 0's evaluations (the other functors: 0
  // elements at compile time)
  const int rows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
  T* Z = p; p += rows;

  T* Bm = kShared ? p : prm.work + (long long)inst * slab_elems(n, kSlabBFGS);
  slab_identity(Bm, n, kSlabBFGS, tid, kDenseThreads);

  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1, nullptr, rows, Z, nullptr);
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
  block_bar(kDenseThreads);
  K9_PROF(long long prof_acc[11] = {0}; long long prof_t = clock64();
          const long long prof_t0 = prof_t;)

  while (SC[0] != T(0)) {
    K9_PROF(if (tid == 0) prof_t = clock64();)
    // ---- d = -B g by the block (each thread negates the outputs it wrote)
    slab_mv(Bm, G, D, n, kSlabBFGS, tid, kDenseThreads);
    for (int k = tid; k < n; k += kDenseThreads) D[k] = -D[k];
    block_bar(kDenseThreads);
    K9_PHASE(0);

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
      K9_PHASE(1);

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
      K9_PHASE(2);
      const bool active = isfinite(Fv) && !converged() && iters < prm.max_iter;
      if (lane == 0) {
        SC[0] = active ? T(1) : T(0);
        SC[1] = upd ? T(1) : T(0);
        SC[2] = T(1) / sy;
      }
    }
    block_bar(kDenseThreads);
    K9_PHASE(5);

    if (SC[1] != T(0)) {
      // ---- B y by the block
      slab_mv(Bm, YV, BY, n, kSlabBFGS, tid, kDenseThreads);
      block_bar(kDenseThreads);
      K9_PHASE(3);
      // every warp forms y.By itself (the same sum on every warp)
      T yBy = 0;
      for (int i = lane; i < n; i += kWarp) yBy += YV[i] * BY[i];
      yBy = warp_sum(yBy);
      const T rho = SC[2];
      const SlabUpdate<T> u{kSlabBFGS, true,  false, false, false, T(1),
                            rho,       rho * rho * yBy + rho,  T(0), yBy,  T(0)};
      // ---- the rank-2 update by the block
      slab_update(Bm, n, u, SV, BY, (const T*)nullptr, tid, kDenseThreads);
      block_bar(kDenseThreads);
      K9_PHASE(4);
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
  K9_PROF(if (tid == 0) {
    prof_acc[6] = iters;
    prof_acc[7] = nfev;
    prof_acc[8] = 1;
    prof_acc[9] = nupd;
    prof_acc[10] = clock64() - prof_t0;
    for (int k = 0; k < 11; ++k) atomicAdd(&k9_prof[k], (unsigned long long)prof_acc[k]);
  })
}

template <typename T, class Obj>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
bfgs_fused_kernel(const Params<T> prm) {
  if (prm.slab_shared)
    bfgs_body<T, Obj, true>(prm);
  else
    bfgs_body<T, Obj, false>(prm);
}

template <typename T, class Obj>
int launch(Params<T> prm, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  const int rows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
  const long long smem = smem_elems(prm.n, es, rows) * es;
  if (smem > kSmemPerBlock) return kErrSmem;
  prm.slab_shared = in_shared(prm.n, es, rows);
  if (!prm.slab_shared && prm.work == nullptr) return kErrArgs;
  auto kernel = bfgs_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<prm.B, kDenseThreads, (int)smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// the launch's parameters from bfgs_fused_launch's arguments
template <typename T>
Params<T> make_params(const void* x0, const void* d0, const void* d1, int rows, int B, int n,
                      double tol, int max_iter, int max_iter_ls, double c1, void* work,
                      void* x, void* f, void* it, void* st, void* nfev, void* nupd) {
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
  prm.rows = rows;
  return prm;
}

template <typename T, class Obj>
int kernel_info(int n, int* out) {
  const int es = (int)sizeof(T);
  const long long smem = smem_elems(n, es, 0) * es;
  if (smem > kSmemPerBlock) return kErrSmem;
  auto kernel = bfgs_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kDenseThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kDenseThreads;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)smem;
  out[5] = in_shared(n, es, 0) ? 1 : 2;
  return 0;
}

}  // namespace
