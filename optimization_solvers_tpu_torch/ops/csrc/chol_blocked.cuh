// Blocked Cholesky factorization and substitutions on Hopper (sm_90a), one
// thread block of kCholThreads threads per (n, n) matrix, float32 and
// float64: the routine that both Cholesky kernels of this directory run.
//
// Serves two TPU kernels: the batched Cholesky solve K6
// (optimization_solvers_tpu/ops/pallas_newton.py, cholesky_solve_pallas,
// pl.pallas_call at :101; here cholesky_solve.cu) and the Newton form of
// the generic driver K3 (optimization_solvers_tpu/ops/pallas_driver.py, the
// factorization at :785-818 and the solves at :820-854, pl.pallas_call at
// :1874; here driver.cuh built as driver_newton.cu).  Each kernel brings its
// pivot rule as a policy (PivotPlain: sqrt, a non-positive pivot gives NaN
// that reaches the whole solution; PivotFloor: K3's test against eps
// max(max|diag H|, 1), the floor sqrt(max(piv, eps)) and the failed flag).
//
// The factor layout is K3's: the matrix lives in an (n, n) row-major slab
// in device memory, and its lower triangle is read from, and the factor L
// written to, the slab's upper triangle, column j of L as row j of the
// slab (U = L^T, so A = U^T U).  A row of U is contiguous: the solves and
// the panel loads read it coalesced.
//
// What bounds it at config 5 (B = 256 matrices of n = 1,024, float32, on
// an H100): the factorization is n^3 / 3 operations per matrix, 9.2e10 in
// all, 1.37 ms at 67 TFLOP/s; reading and writing the slab once is 2 GB,
// 0.64 ms at 3.35 TB/s.  A block's 227 KB of shared memory holds no such
// matrix (4 MB), so the slab is streamed, and a right-looking blocked
// factorization by panels of NB rows reads and writes the trailing
// triangle once per panel: sum over panels of (n - k)^2 / 2 elements each
// way, ~n^3 / (3 NB) elements, 22 MB per matrix at NB = 64 and 45 MB at
// NB = 32, so 5.7 GB (1.7 ms) or 11.5 GB (3.4 ms) for the batch.  The
// design:
//  * per panel: the NB x NB diagonal block is factored in shared memory by
//    the block, each thread one column of a fixed group of rows (two
//    barriers per column, O(n NB^2) per matrix in all); the
//    panel's rows right of it are solved against it column by column (the
//    triangular solve, TRSM), each thread one column held in shared
//    memory and solved 16 rows at a time in registers (a whole column in
//    registers spills at two blocks per SM);
//  * the trailing update (SYRK) is register-tiled on the CUDA cores: output
//    tiles of kTile x kTile (64 x 64 in float32), each thread a kMicro x
//    kMicro micro-tile whose operands come from shared memory by 16-byte
//    vector loads (one load feeds kMicro multiply-adds, not one); the
//    panel rows a tile needs stream through shared memory by cp.async, its
//    column block through a three-stage ring (two tiles ahead) and its row
//    block once per tile row, never the whole n x NB panel, so the shared
//    memory does not grow with n; each thread's own block of the output
//    tile goes from device memory to registers one tile ahead and back,
//    with no shared memory; one barrier per tile;
//  * every element takes its updates one multiply-add at a time in column
//    order (fma(-u_ki, u_kj, a)), in the diagonal block, the TRSM and the
//    SYRK alike, so the factor is the unblocked right-looking one's bit for
//    bit, whatever NB;
//  * float32 stays float32: no TF32 and no tensor cores on solver math;
//  * the substitutions go panel by panel: forward (U^T y = b) with the
//    panel's unknowns solved by warp 0 in registers against the panel's
//    diagonal block staged in shared memory and the rows below updated by
//    the block (coalesced rows of U), back (U x = y) with each panel row's
//    dot product against the solved rows by one warp, then the panel's
//    unknowns by warp 0.  The solution accumulates into a zeroed
//    entry, 0 + y, as the TPU kernel's does (the sign of a zero).
// Every barrier here is barrier.sync 1 over the block's kCholThreads
// threads, not __syncthreads: K3 calls these routines from warp 0's
// divergent control flow and from its worker warps' loop, two call sites,
// which the non-aligned barrier allows.  The factorization and the solve
// are not inlined: each gets the registers of a kernel of its own (K3's
// control flow around them would otherwise make them spill).

#pragma once

#include "common.cuh"

namespace ost_chol {

constexpr int kCholThreads = 256;
constexpr int kCholWarps = kCholThreads / kWarp;

// the SYRK tile and each thread's micro-tile: (kTile / kMicro)^2 threads
template <typename T> struct CholTile;
template <> struct CholTile<float> {
  static constexpr int kTile = 64, kMicro = 4;
};
template <> struct CholTile<double> {
  static constexpr int kTile = 32, kMicro = 2;
};

// what upper_from_transpose writes: H's transpose (K6: H's lower
// triangle) or H's symmetric part (K3's quadratic Hessian)
enum UpperMode { kTransposed = 0, kSymPart = 1 };

// the tiles of upper_from_transpose (below), in elements
template <typename T, int kMode>
__host__ __device__ constexpr int upper_tile_elems() {
  constexpr int kT = CholTile<T>::kTile;
  return 2 * (kT * (kT + 1) + (kMode == kSymPart ? kT * kT : 0));
}

// shared memory of the factorization, in elements (a multiple of 4, so
// that what follows stays 16-byte aligned): two staged row blocks and
// three staged column blocks of the panel (NB x kTile each); the diagonal
// block, its transpose and the TRSM's columns, and the transposing
// copies' tiles (upper_from_transpose) reuse it
template <typename T, int NB>
__host__ __device__ constexpr int chol_scratch_elems() {
  constexpr int kT = CholTile<T>::kTile;
  constexpr int syrk = 5 * NB * kT;
  constexpr int trsm = 2 * NB * NB + NB * kCholThreads;
  constexpr int a = syrk > trsm ? syrk : trsm;
  constexpr int b = upper_tile_elems<T, kSymPart>();
  return ((a > b ? a : b) + 3) / 4 * 4;
}

__device__ __forceinline__ void chol_bar() {
  block_bar(kCholThreads);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// kMicro consecutive elements by one 16-byte load or store
template <typename T> struct Vec;
template <> struct Vec<float> {
  __device__ static void ld(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<double> {
  __device__ static void ld(const double* p, double* v) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
  __device__ static void st(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// K6: plain sqrt; a pivot that is not positive gives NaN (or inf), which
// reaches every later column and the whole solution
struct PivotPlain {
  template <typename T> __device__ T operator()(T piv, bool&) const {
    return sqrt(piv);
  }
};
// K3 (pallas_driver.py:785-818): the pivot fails at piv <= thr = eps
// max(max|diag H|, 1), and the factor takes sqrt(max(piv, eps))
template <typename T> struct PivotFloor {
  T thr, eps;
  __device__ T operator()(T piv, bool& bad) const {
    bad = bad || piv <= thr;
    return sqrt(jmax(piv, eps));
  }
};

// rows [r0, r0 + rows) x columns [c0, c0 + kTile) of the slab into dst
// (row stride kTile) by cp.async; what lies outside the n x n slab reads
// as zero.  vec: n is a multiple of the 16-byte vector (then so is every
// offset here) and 16-byte copies are used, else one copy per element.
template <typename T>
__device__ void load_block(T* dst, const T* S, int n, int r0, int rows, int c0,
                           bool vec, int tid) {
  constexpr int kT = CholTile<T>::kTile, kV = 16 / (int)sizeof(T);
  if (vec) {
    constexpr int kPerRow = kT / kV;
    for (int ch = tid; ch < rows * kPerRow; ch += kCholThreads) {
      const int r = ch / kPerRow, c = (ch % kPerRow) * kV;
      T* d = dst + r * kT + c;
      const int gr = r0 + r, gc = c0 + c;
      if (gr < n && gc < n) {
        cp_async16(d, S + (long long)gr * n + gc);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) d[e] = T(0);
      }
    }
  } else {
    for (int e = tid; e < rows * kT; e += kCholThreads) {
      const int gr = r0 + e / kT, gc = c0 + e % kT;
      if (gr < n && gc < n) cp_async_elem(dst + e, S + (long long)gr * n + gc);
      else dst[e] = T(0);
    }
  }
}

// A thread's kMicro x kMicro block of the output tile at rows [p0, p0 +
// kTile) x columns [q0, q0 + kTile) of the slab, read into registers
// (outside the slab: 0).  Each thread reads and writes only its own block,
// so the tile needs no shared memory.
template <typename T>
__device__ void load_micro(const T* S, int n, int p0, int q0, bool vec, int tid,
                           T (&c)[CholTile<T>::kMicro][CholTile<T>::kMicro]) {
  constexpr int kM = CholTile<T>::kMicro, kDim = CholTile<T>::kTile / kM;
  const int p = p0 + (tid / kDim) * kM, q = q0 + (tid % kDim) * kM;
#pragma unroll
  for (int a = 0; a < kM; ++a) {
    const T* src = S + (long long)(p + a) * n + q;
    if (p + a < n && vec && q + kM <= n) {
      Vec<T>::ld(src, c[a]);
    } else {
#pragma unroll
      for (int b = 0; b < kM; ++b) c[a][b] = (p + a < n && q + b < n) ? src[b] : T(0);
    }
  }
}

// One output tile of the trailing update: the thread's block acc (its
// values before the update) minus sum_r A[r][p] B[r][q] over the panel's
// NB rows, in r order, written back; only q >= p (the upper triangle)
// inside the slab is written.
template <typename T, int NB>
__device__ void syrk_tile(const T* A, const T* Bq,
                          T (&acc)[CholTile<T>::kMicro][CholTile<T>::kMicro],
                          T* S, int n, int p0, int q0, bool vec, int tid) {
  constexpr int kT = CholTile<T>::kTile, kM = CholTile<T>::kMicro;
  constexpr int kDim = kT / kM;
  const int ty = tid / kDim, tx = tid % kDim;
#pragma unroll 16
  for (int r = 0; r < NB; ++r) {
    T av[kM], bv[kM];
    Vec<T>::ld(A + r * kT + ty * kM, av);
    Vec<T>::ld(Bq + r * kT + tx * kM, bv);
#pragma unroll
    for (int a = 0; a < kM; ++a)
#pragma unroll
      for (int b = 0; b < kM; ++b) acc[a][b] = fma(-av[a], bv[b], acc[a][b]);
  }
  const int q = q0 + tx * kM;
#pragma unroll
  for (int a = 0; a < kM; ++a) {
    const int p = p0 + ty * kM + a;
    if (p >= n) continue;
    T* dst = S + (long long)p * n + q;
    if (vec && q + kM <= n && q >= p) {
      Vec<T>::st(dst, acc[a]);
    } else {
#pragma unroll
      for (int b = 0; b < kM; ++b)
        if (q + b < n && q + b >= p) dst[b] = acc[a][b];
    }
  }
}

// Factor the (n, n) slab S in place (A's lower triangle read from, U = L^T
// written to, S's upper triangle) with panels of NB rows.  scratch holds
// chol_scratch_elems<T, NB>() elements, 16-byte aligned.  Called by all
// kCholThreads threads of the block; returns (on every thread) whether the
// pivot rule flagged a pivot.
template <typename T, int NB, class Pivot>
__device__ __noinline__ bool chol_factor_blocked(T* S, int n, T* scratch, int tid,
                                    const Pivot& pivot) {
  constexpr int kT = CholTile<T>::kTile, kM = CholTile<T>::kMicro;
  constexpr int kChunk = 16;
  static_assert(NB % kChunk == 0, "the TRSM works in chunks of 16 rows");
  constexpr int kGroups = kCholThreads / NB;
  const int tr = tid / NB, tc = tid % NB;
  const bool vec = n % (16 / (int)sizeof(T)) == 0;
  T* Dg = scratch;                       // the diagonal block, row stride NB
  T* Ar = scratch;                       // two staged row blocks (NB x kT)
  T* Bring = scratch + 2 * NB * kT;      // three staged column blocks
  bool bad = false;
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int w = min(NB, n - k0);
    // ---- the diagonal block, factored in shared memory
    for (int e = tid; e < w * w; e += kCholThreads) {
      const int r = e / w, c = e % w;
      Dg[r * NB + c] = c >= r ? S[(long long)(k0 + r) * n + k0 + c] : T(0);
    }
    chol_bar();
    // thread (tr, tc): column tc, rows tr, tr + kGroups, ...
    for (int r = 0; r < w; ++r) {
      const T ps = pivot(Dg[r * NB + r], bad);   // every thread, the same
      if (tr == 0 && tc > r && tc < w) Dg[r * NB + tc] /= ps;
      chol_bar();
      if (tid == 0) Dg[r * NB + r] = ps;
      if (tc > r && tc < w) {
        const T urc = Dg[r * NB + tc];
        for (int r2 = tr; r2 <= tc; r2 += kGroups)
          if (r2 > r) Dg[r2 * NB + tc] = fma(-Dg[r * NB + r2], urc, Dg[r2 * NB + tc]);
      }
      chol_bar();
    }
    for (int e = tid; e < w * w; e += kCholThreads) {
      const int r = e / w, c = e % w;
      if (c >= r) S[(long long)(k0 + r) * n + k0 + c] = Dg[r * NB + c];
    }
    const int k1 = k0 + NB;
    if (k1 >= n) break;                  // the last panel: nothing trails it
    // ---- the panel's rows right of the block (TRSM): one column per
    // thread, its NB entries in shared memory (V, row stride kCholThreads,
    // conflict-free), solved kChunk rows at a time in registers against
    // the block's transpose (DgT: a chunk of a column of U by 16-byte
    // loads); every entry takes its updates in row order
    T* DgT = Dg + NB * NB;
    T* V = DgT + NB * NB;
    for (int e = tid; e < NB * NB; e += kCholThreads)
      DgT[(e % NB) * NB + e / NB] = Dg[e];
    chol_bar();
    for (int c0 = k1; c0 < n; c0 += kCholThreads) {
      const int c = c0 + tid;
      const bool live = c < n;
      for (int r = 0; r < NB; ++r)
        V[r * kCholThreads + tid] = live ? S[(long long)(k0 + r) * n + c] : T(0);
      for (int rb = 0; rb < NB; rb += kChunk) {
        T v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) v[j] = V[(rb + j) * kCholThreads + tid];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          v[j] = v[j] / Dg[(rb + j) * NB + rb + j];
#pragma unroll
          for (int j2 = j + 1; j2 < kChunk; ++j2)
            v[j2] = fma(-Dg[(rb + j) * NB + rb + j2], v[j], v[j2]);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) V[(rb + j) * kCholThreads + tid] = v[j];
        for (int r2 = rb + kChunk; r2 < NB; ++r2) {
          T u[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; j += kM) Vec<T>::ld(DgT + r2 * NB + rb + j, u + j);
          T a = V[r2 * kCholThreads + tid];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) a = fma(-u[j], v[j], a);
          V[r2 * kCholThreads + tid] = a;
        }
      }
      if (live)
        for (int r = 0; r < NB; ++r) S[(long long)(k0 + r) * n + c] = V[r * kCholThreads + tid];
    }
    chol_bar();
    // ---- the trailing update (SYRK), tile row by tile row over the upper
    // triangle: the panel's column blocks through a three-stage ring (the
    // loads of tile t + 2 in flight while tile t computes), its row block
    // double-buffered per tile row, each thread's output block prefetched
    // into registers one tile ahead; one barrier per tile
    const int nt = (n - k1 + kT - 1) / kT;
    const int count = nt * (nt + 1) / 2;
    auto next = [&](int& I, int& J) {
      if (++J == nt) J = ++I;
    };
    auto issue = [&](int I, int J, int stage, bool row_block) {
      load_block(Bring + stage * NB * kT, S, n, k0, NB, k1 + J * kT, vec, tid);
      if (row_block) load_block(Ar + (I & 1) * NB * kT, S, n, k0, NB, k1 + I * kT, vec, tid);
      cp_async_commit();
    };
    int I = 0, J = 0, I1 = 0, J1 = 0;
    next(I1, J1);                        // tile t + 1
    int I2 = I1, J2 = J1;
    next(I2, J2);                        // tile t + 2
    issue(0, 0, 0, true);
    if (count > 1) issue(I1, J1, 1, I1 != 0);
    else cp_async_commit();
    T cn[kM][kM];
    load_micro(S, n, k1, k1, vec, tid, cn);
    for (int t = 0; t < count; ++t) {
      T acc[kM][kM];
#pragma unroll
      for (int a = 0; a < kM; ++a)
#pragma unroll
        for (int b = 0; b < kM; ++b) acc[a][b] = cn[a][b];
      if (t + 1 < count) load_micro(S, n, k1 + I1 * kT, k1 + J1 * kT, vec, tid, cn);
      cp_async_wait_one();
      chol_bar();
      if (t + 2 < count) issue(I2, J2, (t + 2) % 3, I2 != I1);
      else cp_async_commit();
      syrk_tile<T, NB>(Ar + (I & 1) * NB * kT, Bring + (t % 3) * NB * kT, acc, S,
                       n, k1 + I * kT, k1 + J * kT, vec, tid);
      I = I1;
      J = J1;
      I1 = I2;
      J1 = J2;
      next(I2, J2);
    }
    chol_bar();
  }
  chol_bar();                            // the factor is in S for every thread
  return bad;
}

// Solve A w = b in place on w (shared memory, n elements) against the
// factor of chol_factor_blocked in S.  dsm: chol_solve_elems<NB>() elements
// of shared memory for the panel's diagonal block (row stride NB + 1, so
// that warp 0 reads a row or a column of it without bank conflicts).  All
// kCholThreads threads.
template <int NB>
__host__ __device__ constexpr int chol_solve_elems() {
  return NB * (NB + 1);
}

template <typename T, int NB>
__device__ void stage_diagonal(const T* S, T* dsm, int n, int k0, int wl, int tid) {
  constexpr int kLd = NB + 1;
  for (int r = tid / NB; r < wl; r += kCholThreads / NB) {
    const int c = tid % NB;
    if (c >= r && c < wl) dsm[r * kLd + c] = S[(long long)(k0 + r) * n + k0 + c];
  }
}

template <typename T, int NB>
__device__ __noinline__ void chol_solve_blocked(const T* S, T* w, T* dsm, int n, int tid) {
  static_assert(NB % kWarp == 0, "the panel is whole warps wide");
  constexpr int kPer = NB / kWarp, kLd = NB + 1;
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  // ---- forward, U^T y = b: the panel's unknowns by warp 0 against the
  // staged block, then the rows below by the block while the next block
  // is staged
  stage_diagonal<T, NB>(S, dsm, n, 0, min(NB, n), tid);
  chol_bar();
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int wl = min(NB, n - k0);
    if (warp == 0) {
      T v[kPer];
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int r = lane + kWarp * s;
        v[s] = r < wl ? w[k0 + r] : T(0);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < wl) {
          const T* row = dsm + c * kLd;
          const T yc = __shfl_sync(kFull, v[c / kWarp], c % kWarp) / row[c];
#pragma unroll
          for (int s = 0; s < kPer; ++s) {
            const int r = lane + kWarp * s;
            if (r > c && r < wl) v[s] = fma(-yc, row[r], v[s]);
          }
          if (lane == c % kWarp) v[c / kWarp] = T(0) + yc;
        }
      }
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int r = lane + kWarp * s;
        if (r < wl) w[k0 + r] = v[s];
      }
    }
    chol_bar();
    // the rows below, four per thread at a time (their loads in flight
    // together)
    for (int i0 = k0 + wl + tid; i0 < n; i0 += 4 * kCholThreads) {
      T a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * kCholThreads;
        a[q] = i < n ? w[i] : T(0);
      }
#pragma unroll 8
      for (int c = 0; c < wl; ++c) {
        const T yc = w[k0 + c];
        const T* row = S + (long long)(k0 + c) * n;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q * kCholThreads;
          if (i < n) a[q] = fma(-yc, row[i], a[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + q * kCholThreads;
        if (i < n) w[i] = a[q];
      }
    }
    if (k0 + NB < n) stage_diagonal<T, NB>(S, dsm, n, k0 + NB, min(NB, n - k0 - NB), tid);
    chol_bar();
  }
  // ---- back, U x = y: the panel's rows against the solved unknowns below
  // it (one warp per row) while its block is staged, then the panel's
  // unknowns by warp 0
  for (int k0 = (n - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int wl = min(NB, n - k0);
    for (int r = warp; r < wl; r += kCholWarps) {
      const T* row = S + (long long)(k0 + r) * n;
      T s = 0;
      for (int i = k0 + wl + lane; i < n; i += kWarp) s = fma(row[i], w[i], s);
      s = warp_sum(s);
      if (lane == 0) w[k0 + r] -= s;
    }
    stage_diagonal<T, NB>(S, dsm, n, k0, wl, tid);
    chol_bar();
    if (warp == 0) {
      T v[kPer];
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int r = lane + kWarp * s;
        v[s] = r < wl ? w[k0 + r] : T(0);
      }
#pragma unroll
      for (int c = NB - 1; c >= 0; --c) {
        if (c < wl) {
          const T xc = __shfl_sync(kFull, v[c / kWarp], c % kWarp) / dsm[c * kLd + c];
#pragma unroll
          for (int s = 0; s < kPer; ++s) {
            const int r = lane + kWarp * s;
            if (r < c) v[s] = fma(-dsm[r * kLd + c], xc, v[s]);
          }
          if (lane == c % kWarp) v[c / kWarp] = T(0) + xc;
        }
      }
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int r = lane + kWarp * s;
        if (r < wl) w[k0 + r] = v[s];
      }
    }
    chol_bar();
  }
}

// S's upper triangle (q >= p) from H (kMode, UpperMode): S[p][q] =
// H[q][p] or 0.5 (H[p][q] + H[q][p]), through kTile x (kTile + 1)
// shared-memory tiles of H's block (J, I) transposed and, for the
// symmetric part, kTile x kTile tiles of its block (I, J) (coalesced both ways):
// two buffers, the next tile's cp.async loads in flight while this tile is
// written; one barrier per tile.  All kCholThreads threads; tile holds
// upper_tile_elems<T, kMode>() elements.
template <typename T, int kMode>
__device__ void upper_from_transpose(T* S, const T* H, int n, T* tile, int tid) {
  constexpr int kT = CholTile<T>::kTile, kLd = kT + 1;
  constexpr int kBuf = upper_tile_elems<T, kMode>() / 2;
  constexpr int kDirectAt = kT * kLd;
  const int nt = (n + kT - 1) / kT;
  const int count = nt * (nt + 1) / 2;
  auto issue = [&](int I, int J, T* buf) {
    for (int e = tid; e < kT * kT; e += kCholThreads) {
      const int r = e / kT, c = e % kT;
      const int q = J * kT + r, p = I * kT + c;
      if (q < n && p <= q) cp_async_elem(buf + r * kLd + c, H + (long long)q * n + p);
      if constexpr (kMode == kSymPart) {
        const int p2 = I * kT + r, q2 = J * kT + c;
        if (q2 < n && q2 >= p2)
          cp_async_elem(buf + kDirectAt + e, H + (long long)p2 * n + q2);
      }
    }
    cp_async_commit();
  };
  int I = 0, J = 0;
  issue(0, 0, tile);
  for (int t = 0; t < count; ++t) {
    int In = I, Jn = J + 1;
    if (Jn == nt) Jn = ++In;
    cp_async_wait_all();
    chol_bar();
    if (t + 1 < count) issue(In, Jn, tile + ((t + 1) & 1) * kBuf);
    const T* buf = tile + (t & 1) * kBuf;
    for (int e = tid; e < kT * kT; e += kCholThreads) {
      const int p = I * kT + e / kT, q = J * kT + e % kT;
      if (q < n && q >= p) {
        T v;
        if constexpr (kMode == kTransposed) v = buf[(e % kT) * kLd + e / kT];
        else v = T(0.5) * (buf[kDirectAt + e] + buf[(e % kT) * kLd + e / kT]);
        S[(long long)p * n + q] = v;
      }
    }
    I = In;
    J = Jn;
  }
  chol_bar();
}

}  // namespace ost_chol
