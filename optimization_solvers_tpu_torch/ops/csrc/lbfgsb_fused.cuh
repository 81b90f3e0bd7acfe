// Whole batched L-BFGS-B solves on Hopper (sm_90a), one warp per instance:
// the kernel, its launch and its resources.  lbfgsb_fused.cu builds its
// Rosenbrock and WeightedSquares instances (and their scaled forms) with
// the C interface, lbfgsb_fused_data.cu its Quadratic and LogSumExp
// instances: one nvcc a source, so the two build in parallel, and the
// earlier functors' instances compile in a unit of the same content as
// before those two were added.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgsb.py
// (lbfgsb_solve_fused, kernel body _make_kernel, pl.pallas_call at :938),
// and its scaled form (lbfgsb_solve_fused_scaled, :993): the same kernel
// on Scaled<Obj> (objectives.cuh), whose evaluations read x = z / s with
// s = sqrt(diag) the launch's operand Params::s; the unscaled instances
// never read it.
// The plain PyTorch version of the same algorithm is lbfgsb_solve_plain in
// ../fused_lbfgsb.py; the two are held against each other on the card.
// The kernel compiles the four functors of objectives.cuh (the scaled form
// Rosenbrock and WeightedSquares), as the TPU kernel traces any objective:
// the quadratic reads Q from device memory (L2) on the instance's warp,
// the log-sum-exp A likewise, with its z (rows elements) in the warp's
// shared memory after the tables; both are first versions, not tuned.
//
// What bounds it on this card: not bytes or FLOPs.  An instance's iteration
// is a chain of small dependent steps (passes over the coordinates, warp
// reductions, O(m^2) triangular work), so the time is that chain times the
// waves of instances the SMs cannot hold at once, and past ~16 warps per SM
// the SM's issue rate.  The design shortens the chain and its work:
//
//  * residency: every per-instance vector lives in shared memory for the
//    whole solve ((2m+5) n + 7 m^2 + 13 m elements and a bit mask of n
//    bits per warp: 7,088 bytes at the headline's n 100, m 5, float32, so
//    four 8-warp blocks fit an SM), and __launch_bounds__ gives each thread
//    the registers of two such blocks per SM (16 warps): with the registers
//    of three or four blocks the compiler spills in the passes, and on an
//    H100 the headline ran 2.5% and 12.5% slower at 24 and 32 warps
//    (tools/k1_residency.py).  The launch
//    picks the warps per block that the card's occupancy calculator says
//    keep the most warps resident;
//  * the interior fast path, the headline's common iteration (over 99% of
//    them): one pass over the coordinates gives the gate's breakpoint
//    minima, W^T g (2m sums) and g.g together, and the quasi-Newton step is
//    the compact form of H g (Byrd, Nocedal and Schnabel 1994: H g = g /
//    theta + S p - Y u / theta with u = R^{-1} S^T g and p = R^{-T} ((D +
//    Y^T Y / theta) u - Y^T g / theta), R the upper triangle of S^T Y) from
//    those sums and the Y^T Y table kept beside S^T Y and S^T S, applied in
//    one more pass that also gives g.d: the two-loop recursion's 2m
//    dependent passes and reductions are gone, and t = 1 needs no step
//    bound (the quasi-Newton point lies in the box);
//  * when a step adds a pair, the step's own pass (its checks, its 4m
//    products with the ring, the stopping test) also gives the next gate's
//    sums and breakpoint minima at the new point, so that gate makes no
//    pass: 6m + 1 sums in one 32-wide butterfly at m 5;
//  * independent sums share one transposed butterfly (warp_sums: k sums in
//    k - 1 + 5 - log2 k shuffles and five levels, where one butterfly each
//    takes 5k shuffles in 5k levels), and the tests of a warp minimum or
//    maximum against a bound are votes;
//  * the small algebra runs on as many lanes as the matrices have rows or
//    entries: the Schur complement and its Cholesky factor one entry per
//    lane in registers (m <= 7), M^{-1} v (mid_solve_lanes) and the compact
//    form's triangular solves with lane i holding row i, as column sweeps of
//    one shuffle each, the two independent ones of the gate interleaved; the
//    reciprocals of D-hat and of the pivots are taken once per iteration,
//    and the Gram tables shift on all lanes;
//  * passes keep kUnroll coordinates per lane in flight (their loads are
//    issued before any store); the first Armijo trial evaluates the
//    gradient too (most steps are taken there), and the history update
//    swaps the X/XT and G/DG buffers instead of copying them.
//
// Design:
//  * coordinate i belongs to lane i % 32, so a lane only ever writes its own
//    coordinates of the per-instance vectors;
//  * S and Y are a ring of m slots (WS: the Y slots, then the S slots);
//    slot(q) maps the chronological index q (0 oldest, m-1 newest) to its
//    slot, and the m x m Gram tables S.Y, S.S, Y.Y stay in chronological
//    order, shifted on every accepted pair; the newest nvalid pairs are the
//    valid ones, older slots hold zeros (inert rows of W);
//  * reductions are __shfl_xor_sync butterflies, so the scalar state (f,
//    theta, t, ...) is replicated in registers; all branches on it are
//    warp-uniform;
//  * the Cauchy walk (rare: each instance's first iteration and few others
//    at the headline) solves its three M^{-1} products of a trip together on
//    the row lanes; the walk's breakpoints live in D, its fixed set and the
//    free set after it in the bit mask (bit k of the lane's word is
//    coordinate lane + 32 k);
//  * bounds are read through the cache: a shared box is the same n pairs
//    for every warp of the SM, which L1 holds (each pass reads them once per
//    coordinate, beside the coordinate's shared-memory loads);
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum do (fminf/fmin
//    would drop it), the walk's arg-min breaks ties on the lowest index as
//    jnp.argmin does, and machine epsilon is the JAX kernel's literal
//    (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#pragma once

#include "common.cuh"
#include "objectives.cuh"

// Phase counters, compiled in only with -DK1_PROFILE (tools/k1_phase_profile.py
// builds such a copy; the kernel as shipped has none).  Lane 0 of each warp
// adds the clock64 cycles of every iteration's phases to k1_prof[0..7] (the
// phases in that tool's PHASES order); [8] counts instance-iterations, [9]
// those that took the interior fast path, [10] Cauchy-walk trips, [11]
// Armijo trials, [12] instances, [13] the cycles of whole instances (set-up
// and epilogue included).
#ifdef K1_PROFILE
namespace {
__device__ unsigned long long k1_prof[16];
}
#define K1_PROF(...) __VA_ARGS__
#else
#define K1_PROF(...)
#endif
#define K1_PHASE(k) \
  K1_PROF(if (lane == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; prof_t = t_; })
#define K1_COUNT(k, v) K1_PROF(if (lane == 0) prof_acc[k] += (v);)

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kUnroll = 4;      // coordinates per lane a pass keeps in flight
constexpr int kSums = 16;       // sums per transposed butterfly of W^T v
constexpr int kStepSlots = 5;   // ring slots per butterfly of the step's pass (6 sums each)
constexpr int kRegCholM = 7;    // the Schur factor in registers up to this m

// blocks of kMaxWarpsPerBlock warps per SM that the registers must allow
// (tools/k1_residency.py builds 2, 3 and 4 with -DK1_MIN_BLOCKS and times
// them in turns)
#ifndef K1_MIN_BLOCKS
#define K1_MIN_BLOCKS 2
#endif
constexpr int kMinBlocks = K1_MIN_BLOCKS;

__host__ __device__ inline int mask_words(int n) { return kWarp * ((n + 1023) / 1024); }
// a warp's elements: the vectors, the ring, the tables and, for
// LOG_SUM_EXP, its z of `rows` elements (rows 0 for the other functors)
__host__ __device__ inline long long work_elems(int n, int m, int rows) {
  return (long long)(2 * m + 5) * n + 7LL * m * m + 13LL * m + rows;
}
__host__ __device__ inline long long work_bytes(int n, int m, int itemsize, int rows) {
  return work_elems(n, m, rows) * itemsize + 4LL * mask_words(n);
}

// arg-min over the warp, ties to the lowest index (jnp.argmin)
template <typename T> __device__ __forceinline__ void warp_argmin(T& v, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    T v2 = __shfl_xor_sync(kFull, v, o);
    int i2 = __shfl_xor_sync(kFull, idx, o);
    if (v2 < v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
  }
}

// out = M^{-1} [a; b] for K right-hand sides in[k] = [a; b] (2m entries in
// shared memory, chronological) of the 2m x 2m middle matrix: lane i < m
// returns u[k] = out[i] and v[k] = out[m + i].  SY (chronological), the
// Schur factor L, DHI = 1 / D-hat; li = 1 / L_ii and dhi = DHI[i] on lane i.
// The triangular solves sweep columns, one shuffle per column.
template <int K, typename T>
__device__ __forceinline__ void mid_solve_lanes(const T* const (&in)[K], T (&u)[K], T (&v)[K],
                                                const T* SY, const T* L, const T* DHI,
                                                T li, T dhi, int m, int lane) {
  const int i = lane;
  const bool row = i < m;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = row ? in[k][m + i] : T(0);
  for (int j = 0; j < m; ++j) {        // v = b + L_sy D^-1 a
    if (row && j < i) {
      const T s = SY[i * m + j];
      const T dj = DHI[j];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = v[k] + s * (in[k][j] * dj);
    }
  }
  for (int j = 0; j < m; ++j) {        // forward: L z = v
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T zj = __shfl_sync(kFull, v[k] * li, j);
      if (row && i > j) v[k] = v[k] - L[i * m + j] * zj;
      else if (i == j) v[k] = zj;
    }
  }
  for (int j = m - 1; j >= 0; --j) {   // backward: L^T w = z
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T wj = __shfl_sync(kFull, v[k] * li, j);
      if (row && i < j) v[k] = v[k] - L[j * m + i] * wj;
      else if (i == j) v[k] = wj;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = row ? -in[k][i] : T(0);
  for (int j = 0; j < m; ++j) {        // u = D^-1 (-a + L_sy^T v)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T vj = __shfl_sync(kFull, v[k], j);
      if (row && j > i) u[k] = u[k] + SY[j * m + i] * vj;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = u[k] * dhi;
}

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  int bstride;          // 0: bounds shared by all instances; n: per instance
  const T* d0;
  const T* d1;
  int B, n, m;
  T pgtol, f_rtol, eps, c1;
  int max_iter, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  const T* s;           // the scaled form's sqrt(diag), (n,); null otherwise
  int rows;             // LOG_SUM_EXP's rows (0 otherwise)
};

template <typename T, class Obj, bool UNBOUNDED>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock, kMinBlocks)
lbfgsb_fused_kernel(const Params<T> prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, m = prm.m, m2 = 2 * prm.m;
  const T INF = (T)INFINITY;
  const T eps = prm.eps;
  // LOG_SUM_EXP's z (the other functors read no row buffer: 0 at compile time)
  const int rows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;

  T* p = reinterpret_cast<T*>(smem_raw + (long long)warp * work_bytes(n, m, sizeof(T), rows));
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;           // direction; the walk's breakpoints
  T* XT = p; p += n;          // trial point; the Cauchy point
  T* DG = p; p += n;          // trial gradient; the Cauchy direction; scratch
  T* WS = p; p += 2 * m * n;  // ring slots: Y_0 .. Y_{m-1}, S_0 .. S_{m-1}
  T* SY = p; p += m * m;
  T* SS = p; p += m * m;
  T* YY = p; p += m * m;
  T* L = p; p += m * m;       // Schur factor; in the subspace step H, then its factor
  T* E = p; p += m * m;
  T* GM = p; p += m * m;
  T* EG = p; p += m * m;
  T* DH = p; p += m;
  T* DHI = p; p += m;
  T* R2 = p; p += m;
  T* WV = p; p += m2;         // W^T g in the gate, W^T r_F in the subspace step
  T* P = p; p += m2;
  T* CF = p; p += m2;         // coefficients of a W-apply, in ring-slot order
  T* C = p; p += m2;
  T* WB = p; p += m2;         // the walk's W row; the subspace's [u; v]
  T* Z = p; p += rows;        // LOG_SUM_EXP's z
  T* GR = C;                  // the history update's 4m products (C, WB: walk only)
  unsigned* FXW = reinterpret_cast<unsigned*>(p);
  const int nmask = mask_words(n);

  K1_PROF(long long prof_acc[14] = {0}; const long long prof_t0 = clock64();
          long long prof_t = prof_t0;)
  const T* lo = prm.lo + (long long)inst * prm.bstride;
  const T* up = prm.up + (long long)inst * prm.bstride;
  const T* x0 = prm.x0 + (long long)inst * n;
  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1, prm.s, rows, Z, nullptr);

  int oldest = 0;             // ring slot of the chronologically oldest pair
  int nvalid = 0;             // the newest nvalid pairs are valid
  auto slot = [&](int q) { const int s = oldest + q; return s >= m ? s - m : s; };
  auto chron = [&](int s) { const int q = s - oldest; return q < 0 ? q + m : q; };
  auto Yv = [&](int q) { return WS + slot(q) * n; };
  auto Sv = [&](int q) { return WS + (m + slot(q)) * n; };
  auto valid = [&](int q) { return q >= m - nvalid; };
  // the walk's fixed set, then the subspace step's free set
  auto mbit = [&](int i) -> bool {
    const int k = i >> 5;
    return (FXW[(k >> 5) * kWarp + (i & 31)] >> (k & 31)) & 1u;
  };
  auto mset = [&](int i, bool v) {
    const int k = i >> 5;
    unsigned& w = FXW[(k >> 5) * kWarp + (i & 31)];
    const unsigned b = 1u << (k & 31);
    w = v ? (w | b) : (w & ~b);
  };

  // f(i) on the lane's coordinates, kUnroll at a time
  auto each = [&](auto&& f) {
    for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kWarp;
        if (i < n) f(i);
      }
    }
  };
  // out[i] = f(i): the kUnroll values are computed before any is stored
  auto each_store = [&](T* out, auto&& f) {
    for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kWarp;
        v[u] = i < n ? f(i) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kWarp;
        if (i < n) out[i] = v[u];
      }
    }
  };
  // r[u] += sum_k cf[k] WS_k[i0 + 32 u]: the W-apply with cf in slot order
  auto apply_w = [&](const T* cf, int i0, T (&r)[kUnroll]) {
#pragma unroll 2
    for (int k = 0; k < m2; ++k) {
      const T c = cf[k];
      const T* w = WS + k * n + i0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kWarp < n) r[u] = r[u] + c * w[u * kWarp];
    }
  };

  // ---- small dense algebra (shared memory) ------------------------------

  // in-place lower Cholesky, pivots floored at eps before the square root
  auto chol = [&](T* A) {
    for (int j = 0; j < m; ++j) {
      if (lane == 0) {
        T d = A[j * m + j];
        for (int k = 0; k < j; ++k) d = d - A[j * m + k] * A[j * m + k];
        A[j * m + j] = sqrt(jmax(d, eps));
      }
      __syncwarp();
      const T dj = A[j * m + j];
      for (int i = j + 1 + lane; i < m; i += kWarp) {
        T s = A[i * m + j];
        for (int k = 0; k < j; ++k) s = s - A[i * m + k] * A[j * m + k];
        A[i * m + j] = s / dj;
      }
      __syncwarp();
    }
  };
  // solve (A A^T) z = v in place for a lower factor A (one lane)
  auto chol_solve = [&](const T* A, T* v, int stride) {
    for (int i = 0; i < m; ++i) {
      T s = v[i * stride];
      for (int k = 0; k < i; ++k) s = s - A[i * m + k] * v[k * stride];
      v[i * stride] = s / A[i * m + i];
    }
    for (int i = m - 1; i >= 0; --i) {
      T s = v[i * stride];
      for (int k = i + 1; k < m; ++k) s = s - A[k * m + i] * v[k * stride];
      v[i * stride] = s / A[i * m + i];
    }
  };

  // ---- W = [Y^T, theta S^T] products --------------------------------------

  T theta = 1;
  // out[0:2m] = [Y^T v; s_scale S^T v] in chronological order, kSums sums
  // per transposed butterfly; returns v.v when want_vv.  hook(i) runs on
  // each coordinate in the same pass (once per kSums sums).
  auto wt_dot = [&](const T* v, T* out, T s_scale, bool want_vv, auto&& hook) -> T {
    const int cnt = m2 + (want_vv ? 1 : 0);
    T vv = 0;
    for (int c0 = 0; c0 < cnt; c0 += kSums) {
      T acc[kSums];
#pragma unroll
      for (int kk = 0; kk < kSums; ++kk) acc[kk] = 0;
      for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
        T vu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarp;
          vu[u] = i < n ? v[i] : T(0);
          if (i < n) hook(i);
        }
#pragma unroll
        for (int kk = 0; kk < kSums; ++kk) {
          const int k = c0 + kk;
          if (k < m2) {
            const T* w = WS + k * n + i0;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (i0 + u * kWarp < n) acc[kk] = acc[kk] + w[u * kWarp] * vu[u];
          } else if (k == m2 && want_vv) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) acc[kk] = acc[kk] + vu[u] * vu[u];
          }
        }
      }
      const T r = warp_sums<kSums>(acc, lane);
      const int k = c0 + lane / (kWarp / kSums);
      if (lane % (kWarp / kSums) == 0 && k < m2)
        out[k < m ? chron(k) : m + chron(k - m)] = k < m ? r : s_scale * r;
      if (want_vv && m2 >= c0 && m2 < c0 + kSums)
        vv = __shfl_sync(kFull, r, (m2 - c0) * (kWarp / kSums));
    }
    __syncwarp();
    return vv;
  };
  auto no_hook = [](int) {};
  // out = W c for c in chronological order (each lane its own coordinates)
  auto w_apply = [&](const T* c, T* out) {
    for (int q = lane; q < m; q += kWarp) {
      CF[slot(q)] = c[q];
      CF[m + slot(q)] = c[m + q] * theta;
    }
    __syncwarp();
    for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
      T r[kUnroll] = {};
      apply_w(CF, i0, r);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kWarp < n) out[i0 + u * kWarp] = r[u];
    }
  };
  // CF such that H g = g / theta + sum_k CF[k] WS_k (compact form, from
  // WV = [Y^T g; S^T g] and the tables); lane q < m holds row q of the
  // triangular solves with R (R_qk = SY[q][k], k >= q; diagonal D-hat).
  // with_mid: also p^T M^{-1} p for p in P (mid_solve_lanes' three sweeps,
  // interleaved with these: the two chains are independent); returned.
  auto small_solves = [&](bool with_mid, T gamma, T li, T dhi) -> T {
    const int q = lane;
    const bool row = q < m;
    T v = with_mid && row ? P[m + q] : T(0);
    if (with_mid && row)
      for (int j = 0; j < q; ++j) v = v + SY[q * m + j] * (P[j] * DHI[j]);
    T a = row ? WV[m + q] : T(0);
    for (int t = 0; t < m; ++t) {        // u = R^{-1} S^T g; mid: L z = v
      const int k = m - 1 - t;
      const T uk = __shfl_sync(kFull, a * dhi, k);
      if (row && q < k) a = a - SY[q * m + k] * uk;
      else if (q == k) a = uk;
      if (with_mid) {
        const T zt = __shfl_sync(kFull, v * li, t);
        if (row && q > t) v = v - L[q * m + t] * zt;
        else if (q == t) v = zt;
      }
    }
    T yu = 0;
    for (int t = 0; t < m; ++t) {        // Y^T Y u; mid: L^T w = z
      const T ut = __shfl_sync(kFull, a, t);
      if (row) yu = yu + YY[q * m + t] * ut;
      if (with_mid) {
        const int j = m - 1 - t;
        const T wj = __shfl_sync(kFull, v * li, j);
        if (row && q < j) v = v - L[j * m + q] * wj;
        else if (q == j) v = wj;
      }
    }
    T w = row ? DH[q] * a + gamma * yu - gamma * WV[q] : T(0);
    T u = with_mid && row ? -P[q] : T(0);
    for (int t = 0; t < m; ++t) {        // p = R^{-T} ((D + gamma Y^T Y) u - gamma Y^T g)
      const T pt = __shfl_sync(kFull, w * dhi, t);
      if (row && q > t) w = w - SY[t * m + q] * pt;
      else if (q == t) w = pt;
      if (with_mid) {                    // mid: u = D^-1 (-a + L_sy^T v)
        const T vt = __shfl_sync(kFull, v, t);
        if (row && t > q) u = u + SY[t * m + q] * vt;
      }
    }
    if (row) {
      CF[slot(q)] = -gamma * a;
      CF[m + slot(q)] = w;
    }
    T pMp = 0;
    if (with_mid) pMp = warp_sum(row ? P[q] * (u * dhi) + P[m + q] * v : T(0));
    __syncwarp();
    return pMp;
  };
  auto seg_min = [&](T f1, T f2) -> T {
    return f2 > eps ? -f1 / f2 : (f1 < T(0) ? INF : T(0));
  };
  auto breakpoint = [&](int i) -> T {
    const T g = G[i], x = X[i];
    return g < T(0) ? (x - up[i]) / g : (g > T(0) ? (x - lo[i]) / g : INF);
  };
  // D-hat and its reciprocals
  auto set_dh = [&]() {
    for (int q = lane; q < m; q += kWarp) {
      const T dh = valid(q) ? SY[q * m + q] : T(1);
      DH[q] = dh;
      DHI[q] = T(1) / dh;
    }
    __syncwarp();
  };
  auto wipe = [&]() {
    for (int i = lane; i < 2 * m * n; i += kWarp) WS[i] = 0;
    for (int e = lane; e < m * m; e += kWarp) { SY[e] = 0; SS[e] = 0; YY[e] = 0; }
    theta = 1;
    oldest = 0;
    nvalid = 0;
    __syncwarp();
  };

  // ---- solver state -------------------------------------------------------

  for (int i = lane; i < n; i += kWarp) X[i] = jclip(x0[i], lo[i], up[i]);
  wipe();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();
  T Fprev = INF;
  int iters = 0;
  bool abn = false;

  // max |x - P(x - g)| <= pgtol, kept for the stopping test: the history
  // update's pass refreshes it when a step is taken.  Tests of a warp
  // minimum or maximum against a bound are votes here (a NaN lane votes
  // no, as the NaN-propagating minimum would)
  auto pg_at = [&](int i) { return (T)fabs(XT[i] - jclip(XT[i] - DG[i], lo[i], up[i])); };
  T pgl = 0;
  each([&](int i) { pgl = jmax(pgl, (T)fabs(X[i] - jclip(X[i] - G[i], lo[i], up[i]))); });
  bool pg_ok = __all_sync(kFull, pgl <= prm.pgtol);
  auto converged = [&]() -> bool {
    const T fmax = jmax(jmax((T)fabs(Fv), (T)fabs(Fprev)), T(1));
    return pg_ok ||
           (isfinite(Fprev) && (Fprev - Fv) <= prm.f_rtol * fmax);
  };

  // the gate's pass, done ahead by the step's pass when the step added a
  // pair (ready): the breakpoint minima per lane and g.g; W^T g is in WV
  bool ready = false;
  T tmin_n = INF, tfirst_n = INF, gg_n = 0;
  bool active = isfinite(Fv) && !abn && !converged();
  K1_PROF(prof_t = clock64();)
  for (int it = 0; it < prm.max_iter && active; ++it) {
    K1_PHASE(7);
    K1_COUNT(8, 1);
    const T gamma = T(1) / theta;
    // on the fast path and in the unbounded body the direction's pass also
    // gives g.d, and the first trial is t = 1 (the quasi-Newton point lies
    // in the box, so every max feasible step is at least 1)
    T g0d = 0;
    bool direct = UNBOUNDED;
    if (UNBOUNDED) {
      // every bound infinite: the interior fast path is the iteration
      set_dh();
      if (!ready) wt_dot(G, WV, T(1), false, no_hook);
      small_solves(false, gamma, T(0), lane < m ? DHI[lane] : T(0));
      for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
        T r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r[u] = i0 + u * kWarp < n ? gamma * G[i0 + u * kWarp] : T(0);
        apply_w(CF, i0, r);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarp;
          if (i < n) {
            D[i] = -r[u];
            g0d += G[i] * -r[u];
          }
        }
      }
      g0d = warp_sum(g0d);
      K1_PHASE(1);
      K1_COUNT(9, 1);
    } else {
      // ---- middle matrix: D-hat and the Cholesky factor of the Schur complement
      set_dh();
      auto schur = [&](int r, int q) {   // theta S.S + L D^-1 L^T, patched
        T v = theta * SS[r * m + q];
        for (int k = 0; k < q; ++k) v = v + SY[r * m + k] * SY[q * m + k] * DHI[k];
        return r == q && !valid(r) ? T(1) : v;
      };
      if (m <= kRegCholM) {
        // one lower entry (r, q) per lane, row-major, factored in registers
        // (right-looking: each entry takes its updates in chol's order)
        int r = 0, q = lane;
        while (q > r && r < m) { q -= r + 1; ++r; }
        const bool own = r < m;
        T a = own ? schur(r, q) : T(0);
        for (int j = 0; j < m; ++j) {
          const T d = __shfl_sync(kFull, sqrt(jmax(a, eps)), j * (j + 1) / 2 + j);
          if (own && q == j) a = r == j ? d : a / d;
          const T lr = __shfl_sync(kFull, a, own && r >= j ? r * (r + 1) / 2 + j : 0);
          const T lq = __shfl_sync(kFull, a, own && q >= j ? q * (q + 1) / 2 + j : 0);
          if (own && q > j) a = a - lr * lq;
        }
        if (own) L[r * m + q] = a;
        __syncwarp();
      } else {
        for (int e = lane; e < m * m; e += kWarp) {
          const int r = e / m, q = e % m;
          if (q <= r) L[e] = schur(r, q);
        }
        __syncwarp();
        chol(L);
      }
      const T li = lane < m ? T(1) / L[lane * m + lane] : T(0);
      const T dhi = lane < m ? DHI[lane] : T(0);
      auto mid_pMp = [&](const T* in) -> T {     // in^T M^{-1} in
        const T* ins[1] = {in};
        T u[1], v[1];
        mid_solve_lanes<1>(ins, u, v, SY, L, DHI, li, dhi, m, lane);
        return warp_sum(lane < m ? in[lane] * u[0] + in[m + lane] * v[0] : T(0));
      };
      K1_PHASE(0);

      // ---- interior fast-path gate, decided for this instance: one pass
      // gives the breakpoints' minima, W^T g and g.g
      T tmin = tmin_n, tfirst = tfirst_n, gg = gg_n;
      if (!ready) {
        tmin = INF;
        tfirst = INF;
        gg = wt_dot(G, WV, T(1), true, [&](int i) {
          const T tb = breakpoint(i);
          tmin = jmin(tmin, tb);
          tfirst = jmin(tfirst, tb > T(0) ? tb : INF);
        });
      }
      const bool blocked = !__any_sync(kFull, tmin != tmin) && __any_sync(kFull, tmin <= T(0));
      // unblocked, the Cauchy direction is -g: p = W^T d0 = -W^T g
      T f1 = -gg, f2 = 0;
      bool fast = false;
      if (!blocked) {
        for (int r = lane; r < m2; r += kWarp) P[r] = r < m ? -WV[r] : -(theta * WV[r]);
        __syncwarp();
        f2 = -theta * f1 - small_solves(true, gamma, li, dhi);
        const T dt0 = seg_min(f1, f2);
        if (dt0 == dt0 && !__any_sync(kFull, tfirst <= dt0)) {     // dt0 < min tfirst
          T inmin = INF;
          for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
            T r[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) r[u] = i0 + u * kWarp < n ? gamma * G[i0 + u * kWarp] : T(0);
            apply_w(CF, i0, r);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int i = i0 + u * kWarp;
              if (i < n) {
                const T xn = X[i] - r[u];
                inmin = jmin(inmin, jmin(xn - lo[i], up[i] - xn));
                const T d = jclip(xn, lo[i], up[i]) - X[i];
                D[i] = d;
                g0d += G[i] * d;
              }
            }
          }
          fast = __all_sync(kFull, inmin >= T(0));
          g0d = warp_sum(g0d);
        }
      }

      if (fast) {
        direct = true;
        K1_PHASE(1);
        K1_COUNT(9, 1);
      } else {
        K1_PHASE(1);
        // ---- generalized Cauchy point: breakpoint walk
        for (int i = lane; i < n; i += kWarp) {
          const T tb = breakpoint(i);
          DG[i] = tb > T(0) ? -G[i] : T(0);
          D[i] = tb > T(0) ? tb : INF;
          XT[i] = X[i];
        }
        for (int w = lane; w < nmask; w += kWarp) FXW[w] = 0;
        for (int r = lane; r < m2; r += kWarp) C[r] = 0;
        __syncwarp();
        if (blocked) {
          f1 = -wt_dot(DG, P, theta, true, no_hook);
          f2 = -theta * f1 - mid_pMp(P);
        }
        T t_old = 0, dt_min = seg_min(f1, f2);
        for (int trip = 0; trip < n; ++trip) {
          T tv = INF;
          int bi = n;
          each([&](int i) { const T b = D[i]; if (b < tv) { tv = b; bi = i; } });
          warp_argmin(tv, bi);
          if (!(isfinite(tv) && dt_min >= tv - t_old)) break;
          K1_COUNT(10, 1);
          const T dt = tv - t_old;
          const T gb = G[bi];
          const T bound = DG[bi] > T(0) ? up[bi] : lo[bi];
          const T zb = bound - X[bi];
          for (int r = lane; r < m2; r += kWarp) {
            C[r] = C[r] + dt * P[r];
            WB[r] = r < m ? WS[slot(r) * n + bi] : theta * WS[(m + slot(r - m)) * n + bi];
          }
          __syncwarp();
          const T* ins[3] = {C, P, WB};
          T u[3], v[3];
          mid_solve_lanes<3>(ins, u, v, SY, L, DHI, li, dhi, m, lane);
          T pc = 0, pp = 0, pw = 0;
          if (lane < m) {
            const T w1 = WB[lane], w2 = WB[m + lane];
            pc = w1 * u[0] + w2 * v[0];
            pp = w1 * u[1] + w2 * v[1];
            pw = w1 * u[2] + w2 * v[2];
          }
          const T wMc = warp_sum(pc), wMp = warp_sum(pp), wMw = warp_sum(pw);
          const T f1n = f1 + dt * f2 + gb * gb + theta * gb * zb - gb * wMc;
          const T f2n = f2 - theta * gb * gb - T(2) * gb * wMp - gb * gb * wMw;
          __syncwarp();
          for (int r = lane; r < m2; r += kWarp) P[r] = P[r] + gb * WB[r];
          if (lane == (bi & (kWarp - 1))) {
            DG[bi] = 0;
            XT[bi] = bound;
            mset(bi, true);
            D[bi] = INF;
          }
          __syncwarp();
          f1 = f1n;
          f2 = f2n;
          t_old = tv;
          dt_min = seg_min(f1, f2);
        }
        dt_min = jmax(dt_min, T(0));
        const T t_cp = t_old + dt_min;
        // dt_min = inf: the remaining direction is zero; skip the inf * 0
        const T dt_fin = isfinite(dt_min) ? dt_min : T(0);
        for (int r = lane; r < m2; r += kWarp) C[r] = C[r] + dt_fin * P[r];
        for (int i = lane; i < n; i += kWarp) {
          const bool fixed = mbit(i);
          if (!fixed) XT[i] = X[i] + (DG[i] == T(0) ? T(0) : t_cp * DG[i]);
          mset(i, breakpoint(i) > T(0) && !fixed);   // free
        }
        __syncwarp();
        K1_PHASE(2);

        // ---- primal subspace step from the Cauchy point
        {
          const T* ins[1] = {C};
          T u[1], v[1];
          mid_solve_lanes<1>(ins, u, v, SY, L, DHI, li, dhi, m, lane);
          if (lane < m) {
            WB[lane] = u[0];
            WB[m + lane] = v[0];
          }
          __syncwarp();
        }
        w_apply(WB, DG);
        for (int i = lane; i < n; i += kWarp) {
          const T r = G[i] + theta * (XT[i] - X[i]) - DG[i];
          D[i] = mbit(i) ? r : T(0);
        }
        // E = D + Y_F Y_F^T / theta, H = theta S_A S_A^T (patched),
        // Gm = L^T - Y_F S_F^T
        for (int r = 0; r < m; ++r) {
          const T* Yr = Yv(r);
          const T* Sr = Sv(r);
          for (int q = 0; q < m; ++q) {
            const T* Yq = Yv(q);
            const T* Sq = Sv(q);
            if (q <= r) {
              T se = 0, sh = 0;
              for (int i = lane; i < n; i += kWarp) {
                const T fr = mbit(i) ? T(1) : T(0);
                const T ac = T(1) - fr;
                se += (Yr[i] * fr) * (Yq[i] * fr);
                sh += (Sr[i] * ac) * (Sq[i] * ac);
              }
              T e = warp_sum(se) / theta;
              T h = theta * warp_sum(sh);
              if (r == q) {
                e = e + DH[r];
                h = h + (valid(r) ? T(0) : T(1));
              }
              if (lane == 0) {
                E[r * m + q] = e;
                E[q * m + r] = e;
                L[r * m + q] = h;
                L[q * m + r] = h;
              }
            }
            T sg = 0;
            for (int i = lane; i < n; i += kWarp) {
              const T fr = mbit(i) ? T(1) : T(0);
              sg += (Yr[i] * fr) * (Sq[i] * fr);
            }
            const T gm = (q > r ? SY[q * m + r] : T(0)) - warp_sum(sg);
            if (lane == 0) GM[r * m + q] = gm;
          }
        }
        __syncwarp();
        chol(E);
        for (int j = lane; j < m; j += kWarp) {
          for (int k = 0; k < m; ++k) EG[k * m + j] = GM[k * m + j];
          chol_solve(E, EG + j, m);
        }
        __syncwarp();
        for (int e = lane; e < m * m; e += kWarp) {
          const int r = e / m, q = e % m;
          if (q > r) continue;
          T v = L[e];
          for (int k = 0; k < m; ++k) v = v + GM[k * m + r] * EG[k * m + q];
          L[e] = v;
        }
        __syncwarp();
        chol(L);
        wt_dot(D, WV, theta, false, no_hook);   // [a; b] = W^T r_F
        if (lane == 0) {
          for (int k = 0; k < m; ++k) R2[k] = WV[k];
          chol_solve(E, R2, 1);         // E^{-1} a
          for (int i = 0; i < m; ++i) {
            T s = WV[m + i];
            for (int k = 0; k < m; ++k) s = s + GM[k * m + i] * R2[k];
            WB[m + i] = s;
          }
          chol_solve(L, WB + m, 1);     // v
          for (int i = 0; i < m; ++i) {
            T s = -WV[i];
            for (int k = 0; k < m; ++k) s = s + GM[i * m + k] * WB[m + k];
            WB[i] = s;
          }
          chol_solve(E, WB, 1);         // u
        }
        __syncwarp();
        w_apply(WB, DG);
        T smin = INF;
        for (int i = lane; i < n; i += kWarp) {
          const bool fr = mbit(i);
          const T du = -(D[i] / theta + (fr ? DG[i] : T(0)) / (theta * theta));
          D[i] = du;
          T st = du > T(0) ? (up[i] - XT[i]) / du
                           : (du < T(0) ? (lo[i] - XT[i]) / du : INF);
          if (!fr || isnan(st)) st = INF;
          smin = jmin(smin, st);
        }
        const T alpha = jmin(T(1), warp_min(smin));
        // clip rounding dust (an epsilon-outward step on a coordinate at its
        // bound would collapse the next max feasible step to -0)
        for (int i = lane; i < n; i += kWarp)
          D[i] = jclip(XT[i] + alpha * (mbit(i) ? D[i] : T(0)), lo[i], up[i]) - X[i];
        K1_PHASE(3);
      }
    }

    // ---- projected Armijo backtracking, first trial capped at the max
    // feasible step
    T t = 1;
    if (!direct) {
      g0d = 0;        // the gate's pass may have summed a direction not taken
      T fsmin = INF;
      each([&](int i) {
        const T d = D[i];
        g0d += G[i] * d;
        T fs = d > T(0) ? (up[i] - X[i]) / d : (d < T(0) ? (lo[i] - X[i]) / d : INF);
        if (isnan(fs)) fs = INF;
        fsmin = jmin(fsmin, fs);
      });
      g0d = warp_sum(g0d);
      t = jmin(T(1), warp_min(fsmin));
    }
    // the first trial evaluates the gradient too: most steps are taken there
    bool have_xt = false, have_grad = false;
    T fnew = 0;
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      __syncwarp();
      each_store(XT, [&](int i) { return X[i] + t * D[i]; });
      __syncwarp();
      const T fv = k == 0 ? obj.value_grad(XT, DG, n, lane) : obj.value(XT, n, lane);
      K1_COUNT(11, 1);
      if (fv <= Fv + prm.c1 * t * g0d && isfinite(fv)) {
        have_xt = true;
        have_grad = k == 0;
        fnew = fv;
        break;
      }
      t = t * T(0.5);
    }
    K1_PHASE(4);

    // ---- step, failure semantics and history update
    if (!have_grad) {
      if (!have_xt) {
        __syncwarp();
        each_store(XT, [&](int i) { return X[i] + t * D[i]; });
      }
      __syncwarp();
      fnew = obj.value_grad(XT, DG, n, lane);
    }
    __syncwarp();
    K1_PHASE(5);
    // one pass: the step's checks, its products with every stored pair and,
    // for the next iteration's gate, W^T g+ over the ring the new pair
    // would make, g+.g+ and the breakpoint minima at the new point: per
    // ring slot k six sums, s.Y_k, S_k.y, s.S_k, y.Y_k (to GR[4k + 0..3])
    // and Y_k.g+, S_k.g+ (to WV), the slot the new pair would take giving
    // them for (s, y); the same sums, in the same order, as the gate's pass
    bool fin = true, same = true;
    T pgn = 0;
    tmin_n = INF;
    tfirst_n = INF;
    const int oldest_n = oldest + 1 == m ? 0 : oldest + 1;
    for (int k0 = 0; k0 < m; k0 += kStepSlots) {
      T acc[kWarp];
#pragma unroll
      for (int kk = 0; kk < kWarp; ++kk) acc[kk] = 0;
      for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
        T su[kUnroll], yu[kUnroll], gu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarp;
          su[u] = yu[u] = gu[u] = 0;
          if (i < n) {
            const T xt = XT[i], dg = DG[i], x = X[i];
            if (k0 == 0) {
              fin = fin && isfinite(xt) && isfinite(dg);
              same = same && xt == x;
              pgn = jmax(pgn, pg_at(i));
              if (!UNBOUNDED) {
                const T tb = dg < T(0) ? (xt - up[i]) / dg : (dg > T(0) ? (xt - lo[i]) / dg : INF);
                tmin_n = jmin(tmin_n, tb);
                tfirst_n = jmin(tfirst_n, tb > T(0) ? tb : INF);
              }
            }
            su[u] = xt - x;
            yu[u] = dg - G[i];
            gu[u] = dg;
          }
        }
        if (k0 == 0) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) acc[kWarp - 2] = acc[kWarp - 2] + gu[u] * gu[u];
        }
#pragma unroll
        for (int kj = 0; kj < kStepSlots; ++kj) {
          const int k = k0 + kj;
          if (k < m) {
            const T* yk = WS + k * n + i0;
            const T* sk = WS + (m + k) * n + i0;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (i0 + u * kWarp < n) {
                const T yv = k == oldest ? yu[u] : yk[u * kWarp];
                const T sv = k == oldest ? su[u] : sk[u * kWarp];
                acc[6 * kj + 0] = acc[6 * kj + 0] + su[u] * yv;
                acc[6 * kj + 1] = acc[6 * kj + 1] + sv * yu[u];
                acc[6 * kj + 2] = acc[6 * kj + 2] + su[u] * sv;
                acc[6 * kj + 3] = acc[6 * kj + 3] + yu[u] * yv;
                acc[6 * kj + 4] = acc[6 * kj + 4] + yv * gu[u];
                acc[6 * kj + 5] = acc[6 * kj + 5] + sv * gu[u];
              }
            }
          }
        }
      }
      const T r = warp_sums<kWarp>(acc, lane);
      const int k = k0 + lane / 6, kind = lane % 6;
      if (lane < 6 * kStepSlots && k < m) {
        if (kind < 4) {
          GR[4 * k + kind] = r;
        } else {
          const int q = k - oldest_n;
          WV[(kind == 4 ? 0 : m) + (q < 0 ? q + m : q)] = r;
        }
      }
      if (k0 == 0) gg_n = __shfl_sync(kFull, r, kWarp - 2);
    }
    __syncwarp();
    const bool ok = isfinite(fnew) && __all_sync(kFull, fin);
    const bool no_move = __all_sync(kFull, same);
    const bool fail = !ok || fnew > Fv || t <= T(0) || no_move;
    const bool has_hist = nvalid > 0;
    const bool restart = fail && has_hist;
    if (fail && !has_hist) abn = true;
    const T sy = GR[4 * oldest + 0], yy = GR[4 * oldest + 3];
    ready = !fail && sy > eps * yy;
    if (ready) {
      T* Yn = WS + oldest * n;
      T* Sn = WS + (m + oldest) * n;
      for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
        T su[kUnroll], yu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarp;
          if (i < n) {
            su[u] = XT[i] - X[i];
            yu[u] = DG[i] - G[i];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarp;
          if (i < n) {
            Sn[i] = su[u];
            Yn[i] = yu[u];
          }
        }
      }
      // shift the tables one place up the diagonal, all lanes: the sources
      // ([r+1][q+1]) lie past every target of their chunk and of the chunks
      // before, so each chunk reads, then writes
      const int mm = (m - 1) * (m - 1);
      for (int e0 = 0; e0 < mm; e0 += kWarp) {
        const int e = e0 + lane;
        const int dst = e < mm ? (e / (m - 1)) * m + e % (m - 1) : 0;
        T a = 0, b = 0, c = 0;
        if (e < mm) {
          a = SY[dst + m + 1];
          b = SS[dst + m + 1];
          c = YY[dst + m + 1];
        }
        __syncwarp();
        if (e < mm) {
          SY[dst] = a;
          SS[dst] = b;
          YY[dst] = c;
        }
        __syncwarp();
      }
      oldest = oldest + 1 == m ? 0 : oldest + 1;
      nvalid = nvalid < m ? nvalid + 1 : m;
      theta = yy / sy;
      for (int j = lane; j < m; j += kWarp) {
        const int k = slot(j);
        const T a = GR[4 * k + 0], c = GR[4 * k + 1], s2 = GR[4 * k + 2], y2 = GR[4 * k + 3];
        SY[(m - 1) * m + j] = a;
        SY[j * m + m - 1] = c;
        SS[(m - 1) * m + j] = s2;
        SS[j * m + m - 1] = s2;
        YY[(m - 1) * m + j] = y2;
        YY[j * m + m - 1] = y2;
      }
      __syncwarp();
    }
    // a restart wipes the model (zero pairs are inert rows of W)
    if (restart) wipe();
    // a restart disables the stall exit for the retry iteration
    Fprev = restart ? INF : Fv;
    const bool pgn_ok = __all_sync(kFull, pgn <= prm.pgtol);
    if (!fail) {
      T* tmp = X; X = XT; XT = tmp;
      tmp = G; G = DG; DG = tmp;
      Fv = fnew;
      pg_ok = pgn_ok;
    }
    ++iters;
    __syncwarp();
    K1_PHASE(6);
    active = isfinite(Fv) && !abn && !converged();
  }
  K1_PHASE(7);

  const bool finite = isfinite(Fv);
  const int status = abn ? 5 : ((converged() && finite) ? 1 : (!finite ? 3 : 2));
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
  }
  K1_PROF(if (lane == 0) {
    prof_acc[12] = 1;
    prof_acc[13] = clock64() - prof_t0;
    for (int k = 0; k < 14; ++k) atomicAdd(&k1_prof[k], (unsigned long long)prof_acc[k]);
  })
}

// the launch for a batch of B: the warps per block (1 .. kMaxWarpsPerBlock,
// at most B) that keep the most warps resident per SM by the card's
// occupancy calculator, the larger block on a tie; 0 warps if an instance
// does not fit a block
template <typename T, class Obj, bool UNBOUNDED>
cudaError_t configure(int B, int n, int m, int rows, int& wpb, int& blocks) {
  const long long per_warp = work_bytes(n, m, sizeof(T), rows);
  wpb = 0;
  blocks = 0;
  long long most = kSmemPerBlock / per_warp;
  if (most > kMaxWarpsPerBlock) most = kMaxWarpsPerBlock;
  if (most > B) most = B;
  if (most < 1) return cudaSuccess;
  auto kernel = lbfgsb_fused_kernel<T, Obj, UNBOUNDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(per_warp * most));
  for (int w = (int)most; w >= 1 && err == cudaSuccess; --w) {
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, w * kWarp,
                                                        (size_t)(per_warp * w));
    if (err == cudaSuccess && nb * w > blocks * wpb) {
      wpb = w;
      blocks = nb;
    }
  }
  return err;
}

template <typename T, class Obj, bool UNBOUNDED>
int launch(const Params<T>& prm, cudaStream_t stream) {
  int wpb, blocks;
  const int rows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
  cudaError_t err = configure<T, Obj, UNBOUNDED>(prm.B, prm.n, prm.m, rows, wpb, blocks);
  if (err != cudaSuccess) return (int)err;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(work_bytes(prm.n, prm.m, sizeof(T), rows) * wpb);
  const int grid = (prm.B + wpb - 1) / wpb;
  lbfgsb_fused_kernel<T, Obj, UNBOUNDED><<<grid, wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// out: warps per block, resident blocks per SM, registers per thread, local
// (spill) bytes per thread, dynamic shared memory per block
template <typename T, class Obj, bool UNBOUNDED>
int kernel_info(int B, int n, int m, int rows, int* out) {
  if (Bind<Obj>::kRowBuffers == 0) rows = 0;
  int wpb, blocks;
  cudaError_t err = configure<T, Obj, UNBOUNDED>(B, n, m, rows, wpb, blocks);
  if (err != cudaSuccess) return (int)err;
  if (wpb < 1) return kErrSmem;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, lbfgsb_fused_kernel<T, Obj, UNBOUNDED>);
  if (err != cudaSuccess) return (int)err;
  out[0] = wpb;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)(work_bytes(n, m, sizeof(T), rows) * wpb);
  return 0;
}

// the launch's parameters from lbfgsb_fused_launch's arguments
template <typename T>
Params<T> make_params(const void* x0, const void* lo, const void* up, int bstride,
                      const void* d0, const void* d1, int rows, const void* s, int B,
                      int n, int m, double pgtol, double factr, int max_iter,
                      int max_iter_ls, double c1, void* x, void* f, void* it, void* st) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.bstride = bstride;
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.m = m;
  prm.pgtol = (T)pgtol;
  prm.f_rtol = (T)(factr * Lit<T>::eps);
  prm.eps = (T)Lit<T>::eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.s = static_cast<const T*>(s);
  prm.rows = rows;
  return prm;
}

}  // namespace
