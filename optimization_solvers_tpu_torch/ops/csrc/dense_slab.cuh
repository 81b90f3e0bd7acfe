// Block-level routines over one instance's dense (n, n) quasi-Newton slab,
// shared by K3's dense form (driver_dense.cu: methods QN and QNB, every
// update kind) and K9 (bfgs_fused.cu).  All the block's threads call a
// routine together; it touches the slab and no other shared state, and
// ends without a barrier (the caller's protocol places them).
//
// The layouts (the plain versions' full matrices, fused_driver.py:829-903
// and fused_bfgs.py:85-103, computed element by element):
//  * the symmetric kinds (BFGS, DFP, SR1) keep the packed upper triangle,
//    n (n + 1) / 2 elements (20.2 KB at n = 100 in float32): row i holds
//    columns i .. n-1 from packed_row(i, n).  The plain versions update a
//    full, exactly symmetric matrix: every update adds at (i, j) and at
//    (j, i) the same products in swapped order (BFGS's cross term as two
//    unfused products, whose sum does not depend on the order), so an
//    element of the triangle gets the value both (i, j) and (j, i) of the
//    full update get;
//  * Broyden's B is not symmetric: full and row-major, with an odd row
//    stride full_ld(n) (n, or n + 1 for an even n), so that a warp's 32
//    lanes walking 32 rows read 32 banks.
//
// Products: thread k of the block computes outputs k, k + threads, ...,
// summing over m = 0 .. n-1 in order (one multiply-add at a time).  In the
// packed layout element (m, k) lies in row m for m < k (the 32 lanes read
// 32 consecutive elements) and in row k for m >= k (at most 2-way bank
// conflicts at n = 100).  Updates and the
// identity fill split the rows over the warps (warp w takes rows w, w + W,
// ...), the lanes along a row.
//
// The slab pointer is a generic address: dynamic shared memory where the
// slab and the kernel's vectors fit a block's opt-in 227 KB
// (kSmemPerBlock), else the instance's part of the device-memory
// workspace; the same code runs on either.

#pragma once

#include "common.cuh"

namespace ost_slab {

// the block of one instance: kDenseWarps warps; the registers allow
// kDenseMinBlocks blocks per SM (8: config 2's 1,024 instances in one wave
// on 132 SMs).  tools/dense_residency.py builds other choices
// (-DDENSE_WARPS, -DDENSE_MIN_BLOCKS) and times them in turns.
#ifndef DENSE_WARPS
#define DENSE_WARPS 4
#endif
#ifndef DENSE_MIN_BLOCKS
#define DENSE_MIN_BLOCKS (DENSE_WARPS <= 4 ? 8 : 4)
#endif
constexpr int kDenseWarps = DENSE_WARPS;
constexpr int kDenseThreads = kDenseWarps * kWarp;
constexpr int kDenseMinBlocks = DENSE_MIN_BLOCKS;

// the quasi-Newton update kinds (QnUpdate of driver.cuh, K9's BFGS = 0)
enum SlabKind { kSlabBFGS = 0, kSlabDFP = 1, kSlabBroyden = 2, kSlabSR1 = 3 };

__host__ __device__ inline bool slab_packed(int kind) { return kind != kSlabBroyden; }
__host__ __device__ inline int full_ld(int n) { return n | 1; }
// the first element of packed row i: rows 0 .. i-1 hold n, n-1, ...
// (indices within one slab are ints: a slab of 2^31 elements is 8 GB)
__host__ __device__ inline int packed_row(int i, int n) {
  return i * n - i * (i - 1) / 2;
}
__host__ __device__ inline long long slab_elems(int n, int kind) {
  return slab_packed(kind) ? (long long)n * (n + 1) / 2 : (long long)n * full_ld(n);
}
// whether a block's shared memory holds the slab beside `vec_elems`
// elements of the kernel's own (the fit rule the wrappers mirror)
__host__ __device__ inline bool slab_in_shared(long long vec_elems, int n, int kind,
                                               int elem_size) {
  return (vec_elems + slab_elems(n, kind)) * elem_size <= kSmemPerBlock;
}

// B = I: warp w takes rows w, w + W, ..., its lanes the row's columns
template <typename T>
__device__ void slab_identity(T* P, int n, int kind, int tid, int threads) {
  const int lane = tid & (kWarp - 1), warps = threads / kWarp;
  const bool packed = slab_packed(kind);
  const int ld = full_ld(n);
  for (int i = tid / kWarp; i < n; i += warps) {
    T* row = P + (packed ? packed_row(i, n) - i : i * ld);
    for (int j = (packed ? i : 0) + lane; j < n; j += kWarp) row[j] = i == j ? T(1) : T(0);
  }
}

// out = B v: B symmetric in the packed layout, Broyden's B by rows.
// Output k sums over m =
// 0 .. n-1 in order; in the packed layout the warp's outputs k0 .. k0+31
// read column k of rows m < k0 (all lanes), then the 32 steps where some
// lanes have passed their diagonal, then row k (all lanes): the bounds are
// the warp's, so the warp does not diverge.  The loops are unrolled by 4
// (the loads of four steps in flight, the multiply-adds in order).
template <typename T>
__device__ void slab_mv(const T* __restrict__ P, const T* __restrict__ v, T* __restrict__ out,
                        int n, int kind, int tid, int threads) {
  const int ld = full_ld(n);
  for (int k = tid; k < n; k += threads) {
    T acc = 0;
    if (slab_packed(kind)) {
      const int k0 = k - (tid & (kWarp - 1));
      const int mid = k0 + kWarp < n ? k0 + kWarp : n;
      const T* row = P + packed_row(k, n) - k;
      int col = k;                       // (m, k) in row m, m < k
      int m = 0;
#pragma unroll 4
      for (; m < k0; ++m) {
        acc += P[col] * v[m];
        col += n - m - 1;
      }
      for (; m < mid; ++m) {
        acc += *(m < k ? P + col : row + m) * v[m];
        col += n - m - 1;
      }
#pragma unroll 4
      for (; m < n; ++m) acc += row[m] * v[m];
    } else {
      const T* row = P + k * ld;
#pragma unroll 4
      for (int m = 0; m < n; ++m) acc += row[m] * v[m];
    }
    out[k] = acc;
  }
}

// Broyden's two products of the update in one pass over the slab: out = B v
// by rows and outt = B^T w by columns
template <typename T>
__device__ void slab_mv_broyden(const T* __restrict__ P, const T* __restrict__ v,
                                T* __restrict__ out, const T* __restrict__ w,
                                T* __restrict__ outt, int n, int tid, int threads) {
  const int ld = full_ld(n);
  for (int k = tid; k < n; k += threads) {
    const T* row = P + k * ld;
    T acc = 0, acct = 0;
#pragma unroll 4
    for (int m = 0; m < n; ++m) {
      acc += row[m] * v[m];
      acct += P[m * ld + k] * w[m];
    }
    out[k] = acc;
    outt[k] = acct;
  }
}

// one update of the slab (pallas_driver.py:467-588, K3's dense update):
// B starts from I where `pending` (the restart's deferred reset), from
// gamma I where `scale_cond` (scale_b0's first pair); the kind's rank-one
// or rank-two term is added where `ok`; I replaces the result where
// `reset`.  s, by = B y and bts = B^T s (Broyden only) are the block's
// vectors.
template <typename T> struct SlabUpdate {
  int kind;
  bool ok, reset, pending, scale_cond;
  T gamma, rho, coeff, sy, yBy, shy_y;
};

// the rows of one kind: warp w takes rows w, w + W, ..., its lanes the
// row's columns; s[i] and B y[i] are read once per row.  kPlain: the
// update is taken and none of the resets applies (the common iteration),
// so no element tests a flag
template <typename T, int kKind, bool kPlain>
__device__ __forceinline__ void update_rows(T* __restrict__ P, int n, const SlabUpdate<T>& u,
                                            const T* __restrict__ s, const T* __restrict__ by,
                                            const T* __restrict__ bts, int tid, int threads) {
  const int lane = tid & (kWarp - 1), warps = threads / kWarp;
  const bool packed = slab_packed(kKind);
  const int ld = full_ld(n);
  for (int i = tid / kWarp; i < n; i += warps) {
    T* row = P + (packed ? packed_row(i, n) - i : i * ld);
    const T si = s[i], byi = by[i];
    for (int j = (packed ? i : 0) + lane; j < n; j += kWarp) {
      const T eye = i == j ? T(1) : T(0);
      T b = row[j];
      if (!kPlain && u.pending) b = eye;
      if (!kPlain && u.scale_cond) b = u.gamma * eye;
      T out = b;
      if (kPlain || u.ok) {
        const T sj = s[j], byj = by[j];
        if constexpr (kKind == kSlabBFGS) {
          // two unfused products: the cross term is the same float at
          // (i, j) and (j, i)
          T cross;
          if constexpr (sizeof(T) == 4)
            cross = __fmul_rn(si, byj) + __fmul_rn(byi, sj);
          else
            cross = __dmul_rn(si, byj) + __dmul_rn(byi, sj);
          out = b - u.rho * cross + u.coeff * (si * sj);
        } else if constexpr (kKind == kSlabDFP) {
          out = b + (si * sj) / u.sy - (byi * byj) / u.yBy;
        } else if constexpr (kKind == kSlabBroyden) {
          out = b + ((si - byi) * bts[j]) / u.sy;
        } else {
          out = b + ((si - byi) * (sj - byj)) / u.shy_y;
        }
      }
      if (!kPlain && u.reset) out = eye;
      row[j] = out;
    }
  }
}

template <typename T, int kKind>
__device__ __forceinline__ void update_kind(T* P, int n, const SlabUpdate<T>& u, const T* s,
                                            const T* by, const T* bts, int tid, int threads) {
  if (u.ok && !u.pending && !u.scale_cond && !u.reset)
    update_rows<T, kKind, true>(P, n, u, s, by, bts, tid, threads);
  else
    update_rows<T, kKind, false>(P, n, u, s, by, bts, tid, threads);
}

template <typename T>
__device__ void slab_update(T* P, int n, const SlabUpdate<T>& u, const T* s, const T* by,
                            const T* bts, int tid, int threads) {
  switch (u.kind) {
    case kSlabBFGS: update_kind<T, kSlabBFGS>(P, n, u, s, by, bts, tid, threads); break;
    case kSlabDFP: update_kind<T, kSlabDFP>(P, n, u, s, by, bts, tid, threads); break;
    case kSlabBroyden: update_kind<T, kSlabBroyden>(P, n, u, s, by, bts, tid, threads); break;
    default: update_kind<T, kSlabSR1>(P, n, u, s, by, bts, tid, threads); break;
  }
}

}  // namespace ost_slab
