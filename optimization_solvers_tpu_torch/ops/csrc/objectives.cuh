// Warp-level objective functors shared by the one-warp-per-instance kernels
// (K1 lbfgsb_fused.cu, K3 driver.cu / driver_qn*.cu / driver_dense.cu /
// driver_newton.cu, K4 newton_cg.cu, K7 lbfgs_fused.cu, K8 spg_fused.cu,
// and the first warp of K9 bfgs_fused.cu): one warp evaluates one instance, coordinate i on lane
// i % 32, and every lane returns the warp-reduced value.  The caller
// __syncwarp()s before a call (the functors read other lanes' coordinates
// of x and v) and after value_grad and hvp (each lane writes only its own
// coordinates of g and of the product).  K8 and K3's first-order form
// compile Rosenbrock and WeightedSquares; K7 the first three (values and
// gradients); K1, K3's quasi-Newton, Wolfe (the Wolfe trials through
// value_grad<true>) and dense forms, K9, K3's Newton form and K4 all four
// (LogSumExp bound by Bind, with its shared-memory buffers), the last two
// with the second derivatives: hvp(x, v, out, n, lane) writes H v into out,
// and hessian(x, H, n, tid, scratch) is block-level (K3's Newton form runs
// one block of ost_chol::kCholThreads threads per instance; every thread
// calls it, tid its index): the block writes the upper triangle (j >= i)
// of the instance's (n, n) Hessian, row-major, into H (device memory),
// the warps splitting the rows, or (the quadratic) the block's
// shared-memory tiles in `scratch`; the caller synchronises the block
// after it.  Every Hessian here is exactly
// symmetric, so its upper triangle is all of it, which K3's factorization
// reads.  A functor with kBlockEval also splits value and value_grad over
// the block (rows_part, cols_grad; driver.cuh combines them): the
// quadratic's n^2 passes, which one warp alone walks too slowly at n =
// 1,024.  The plain PyTorch forms in core/problems.py use the same
// expressions in the same order.
//
// Rosenbrock's and WeightedSquares' expressions at one coordinate are their
// `_at` members (WeightedSquares' grad_of from the coordinate's data), which
// every loop here calls; K4 (newton_cg.cu), K3's first-order form and K8
// (through lanes.cuh), which hold a lane's coordinates in registers, call
// the same members.  A
// coordinate's neighbours come through an accessor: x(d) is x_{i+d} for d
// = -1, 0, 1, read only where that coordinate exists (x(1) where i < n - 1,
// x(-1) where i > 0); `in_memory` makes one for a vector in memory.
// Scaled<Obj> (at the end) is K1's scaled form of the first two.

#pragma once

#include "chol_blocked.cuh"
#include "common.cuh"

namespace {

// the accessor of coordinate i's neighbourhood in the vector x
template <typename T> __device__ __forceinline__ auto in_memory(const T* x, int i) {
  return [x, i](int d) { return x[i + d]; };
}

template <typename T> struct Rosenbrock {
  const T* d0;
  const T* d1;
  // term i (i < n - 1): 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2
  template <class X> __device__ static T term_at(const X& x) {
    const T a = x(1) - x(0) * x(0);
    const T b = T(1) - x(0);
    return T(100) * (a * a) + b * b;
  }
  // g_i, adding term i (if any) to s
  template <class X> __device__ static T grad_at(const X& x, int i, int n, T& s) {
    T gi = 0;
    if (i < n - 1) {
      const T a = x(1) - x(0) * x(0);
      const T b = T(1) - x(0);
      s += T(100) * (a * a) + b * b;
      gi = T(-400) * x(0) * a - T(2) * b;
    }
    if (i > 0) gi += T(200) * (x(0) - x(-1) * x(-1));
    return gi;
  }
  // H_ii: 1200 x_i^2 - 400 x_{i+1} + 2 from term i, as 800 x_i x_i - 400 a_i
  // + 2, plus 200 from term i - 1
  template <class X> __device__ static T hess_diag_at(const X& x, int i, int n) {
    T h = 0;
    if (i < n - 1) {
      const T a = x(1) - x(0) * x(0);
      h = T(800) * x(0) * x(0) - T(400) * a + T(2);
    }
    if (i > 0) h += T(200);
    return h;
  }
  // H_{i,i+1} = H_{i+1,i} = -400 x_i
  __device__ static T hess_off(T xi) { return T(-400) * xi; }
  // row i of the Hessian at x: h(d) = H_{i,i+d}
  template <class X> __device__ static auto hess_row_at(const X& x, int i, int n) {
    return [x, i, n](int d) {
      return d == 0 ? hess_diag_at(x, i, n) : hess_off(d > 0 ? x(0) : x(-1));
    };
  }
  // (H v)_i from row i's coefficients h(d) = H_{i,i+d} and v(d) = v_{i+d}
  template <class H, class V> __device__ static T hvp_at(const H& h, const V& v, int i, int n) {
    T o = h(0) * v(0);
    if (i < n - 1) o += h(1) * v(1);
    if (i > 0) o += h(-1) * v(-1);
    return o;
  }
  __device__ T value(const T* x, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n - 1; i += kWarp) s += term_at(in_memory(x, i));
    return warp_sum(s);
  }
  // with kDot, g.d for a direction d into *gd in the same pass, the two
  // warp sums side by side (a Wolfe trial's value and directional
  // derivative)
  template <bool kDot = false>
  __device__ T value_grad(const T* x, T* g, int n, int lane, const T* d = nullptr,
                          T* gd = nullptr) const {
    T s = 0, p = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T gi = grad_at(in_memory(x, i), i, n, s);
      g[i] = gi;
      if constexpr (kDot) p += gi * d[i];
    }
    if constexpr (kDot) *gd = warp_sum(p);
    return warp_sum(s);
  }
  __device__ T hess_diag(const T* x, int i, int n) const {
    return hess_diag_at(in_memory(x, i), i, n);
  }
  static constexpr bool kBlockEval = false;
  __device__ void hessian(const T* x, T* H, int n, int tid, T*) const {
    for (int i = tid / kWarp; i < n; i += ost_chol::kCholWarps) {
      T* row = H + (long long)i * n;
      for (int j = i + tid % kWarp; j < n; j += kWarp) {
        T h = 0;
        if (j == i) h = hess_diag(x, i, n);
        else if (j == i + 1) h = hess_off(x[i]);
        row[j] = h;
      }
    }
  }
  __device__ void hvp(const T* x, const T* v, T* out, int n, int lane) const {
    for (int i = lane; i < n; i += kWarp)
      out[i] = hvp_at(hess_row_at(in_memory(x, i), i, n), in_memory(v, i), i, n);
  }
};

// 0.5 sum_i d_i (x_i - t_i)^2 with problem data d = d0, t = d1
template <typename T> struct WeightedSquares {
  const T* d0;
  const T* d1;
  // g_i = d_i (x_i - t_i) from the coordinate's data d_i and t_i, adding
  // d_i (x_i - t_i)^2 to s
  __device__ static T grad_of(T xi, T di, T ti, T& s) {
    const T r = xi - ti;
    const T gi = di * r;
    s += gi * r;
    return gi;
  }
  __device__ T grad_at(T xi, int i, T& s) const { return grad_of(xi, d0[i], d1[i], s); }
  // H_ii = d_i, the whole Hessian's only non-zero in row i
  __device__ T hess_diag_at(int i) const { return d0[i]; }
  __device__ T value(const T* x, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n; i += kWarp) grad_at(x[i], i, s);
    return T(0.5) * warp_sum(s);
  }
  template <bool kDot = false>
  __device__ T value_grad(const T* x, T* g, int n, int lane, const T* d = nullptr,
                          T* gd = nullptr) const {
    T s = 0, p = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T gi = grad_at(x[i], i, s);
      g[i] = gi;
      if constexpr (kDot) p += gi * d[i];
    }
    if constexpr (kDot) *gd = warp_sum(p);
    return T(0.5) * warp_sum(s);
  }
  static constexpr bool kBlockEval = false;
  __device__ void hessian(const T* x, T* H, int n, int tid, T*) const {
    for (int i = tid / kWarp; i < n; i += ost_chol::kCholWarps) {
      T* row = H + (long long)i * n;
      for (int j = i + tid % kWarp; j < n; j += kWarp)
        row[j] = j == i ? hess_diag_at(i) : T(0);
    }
  }
  __device__ void hvp(const T* x, const T* v, T* out, int n, int lane) const {
    for (int i = lane; i < n; i += kWarp) out[i] = hess_diag_at(i) * v[i];
  }
};

// 0.5 x^T Q x + b^T x with Q = d0 (n x n, row-major, in device memory and
// shared by every warp) and b = d1.  Lane l owns rows l, l+32, ...: (Q x)_i
// walks row i, (Q^T x)_i column i (coalesced across the lanes).  The
// gradient 0.5 (Q x + Q^T x) + b, the Hessian 0.5 (Q + Q^T) and the HVP
// 0.5 (Q v + Q^T v) are autodiff's for a Q that is not exactly symmetric;
// the Hessian is then exactly symmetric whatever Q is.
template <typename T> struct Quadratic {
  const T* d0;
  const T* d1;
  // (Q v)_i and (Q^T v)_i
  __device__ void rowcol(const T* v, int i, int n, T& qv, T& qtv) const {
    const T* Qi = d0 + (long long)i * n;
    qv = 0;
    qtv = 0;
    for (int j = 0; j < n; ++j) {
      qv += Qi[j] * v[j];
      qtv += d0[(long long)j * n + i] * v[j];
    }
  }
  __device__ T value(const T* x, int n, int lane) const {
    T sq = 0, sb = 0;
    for (int i = lane; i < n; i += kWarp) {
      const T* Qi = d0 + (long long)i * n;
      T qx = 0;
      for (int j = 0; j < n; ++j) qx += Qi[j] * x[j];
      sq += x[i] * qx;
      sb += d1[i] * x[i];
    }
    return T(0.5) * warp_sum(sq) + warp_sum(sb);
  }
  // with kDot, g.d for a direction d into *gd in the same pass
  template <bool kDot = false>
  __device__ T value_grad(const T* x, T* g, int n, int lane, const T* d = nullptr,
                          T* gd = nullptr) const {
    T sq = 0, sb = 0, p = 0;
    for (int i = lane; i < n; i += kWarp) {
      T qx, qtx;
      rowcol(x, i, n, qx, qtx);
      sq += x[i] * qx;
      sb += d1[i] * x[i];
      const T gi = T(0.5) * (qx + qtx) + d1[i];
      g[i] = gi;
      if constexpr (kDot) p += gi * d[i];
    }
    if constexpr (kDot) *gd = warp_sum(p);
    return T(0.5) * warp_sum(sq) + warp_sum(sb);
  }
  // the symmetric part's upper triangle through the block's
  // double-buffered shared-memory tiles (chol_blocked.cuh), both reads of
  // Q coalesced
  __device__ void hessian(const T* x, T* H, int n, int tid, T* scratch) const {
    ost_chol::upper_from_transpose<T, ost_chol::kSymPart>(H, d0, n, scratch, tid);
  }
  // the block's share of value (and of value_grad): rows i = warp, warp +
  // nwarps, ..., (Q x)_i by the warp's lanes over j, four rows at a time
  // (their loads in flight together); the warp's partial sums of x_i (Q
  // x)_i and b_i x_i in row order (on every lane), and (Q x)_i into g[i]
  // when g is given
  static constexpr bool kBlockEval = true;
  __device__ void rows_part(const T* x, T* g, int n, int warp, int nwarps,
                            int lane, T& sq, T& sb) const {
    sq = 0;
    sb = 0;
    for (int i0 = warp; i0 < n; i0 += 4 * nwarps) {
      T qx[4] = {0, 0, 0, 0};
#pragma unroll 8
      for (int j = lane; j < n; j += kWarp) {
        const T xj = x[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + k * nwarps;
          if (i < n) qx[k] += d0[(long long)i * n + j] * xj;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * nwarps;
        const T q = warp_sum(qx[k]);
        if (i < n) {
          sq += x[i] * q;
          sb += d1[i] * x[i];
          if (g != nullptr && lane == 0) g[i] = q;
        }
      }
    }
  }
  // after rows_part into g and a block barrier: g_i = 0.5 ((Q x)_i + (Q^T
  // x)_i) + b_i for i = tid, tid + nthreads, ..., (Q^T x)_i walking column i
  // (coalesced across the threads), four columns at a time.
  __device__ void cols_grad(const T* x, T* g, int n, int tid, int nthreads) const {
    for (int i0 = tid; i0 < n; i0 += 4 * nthreads) {
      T qtx[4] = {0, 0, 0, 0};
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const T xj = x[j];
        const T* Qj = d0 + (long long)j * n;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + k * nthreads;
          if (i < n) qtx[k] += Qj[i] * xj;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * nthreads;
        if (i < n) g[i] = T(0.5) * (g[i] + qtx[k]) + d1[i];
      }
    }
  }
  __device__ void hvp(const T* x, const T* v, T* out, int n, int lane) const {
    for (int i = lane; i < n; i += kWarp) {
      T qv, qtv;
      rowcol(v, i, n, qv, qtv);
      out[i] = T(0.5) * (qv + qtv);
    }
  }
};

// log sum_r exp(z_r) with z = A x + b, A = d0 (rows x n, row-major, in
// device memory and shared by every warp) and b = d1, in the max-shifted
// form z_max + log sum_r exp(z_r - z_max); gradient A^T p with p =
// softmax(z) = exp(z - z_max) / sum_r exp(z_r - z_max); Hessian A^T
// (diag(p) - p p^T) A; HVP A^T (p .* (A v - p . A v)): the expressions and
// order of core/problems.py:log_sum_exp.  The functor holds two buffers of
// `rows` elements in the caller's shared memory: z (each evaluation's z,
// then its p) and p (K4: p at the Newton step's x, set by prepare and read
// by every hvp).  A z pass (rows_dot) gives lane l the rows r0 + l of a
// chunk of 32: its lanes walk the columns j (coalesced), 32 partial sums a
// lane, reduced in one transposed butterfly (warp_sums<32>).  A gradient
// pass walks the rows in order for the lane's columns.  hessian is
// block-level (K3's Newton form): z and p by the block into z, A^T p into
// the scratch, then the upper triangle of A^T diag(p) A - (A^T p)(A^T p)^T
// tile by tile (CholTile's tile and micro-tile: every thread a micro-tile of
// sums, kLseRows rows of A's two column strips staged in the scratch at a
// time).  The members are not inlined: each is a pass over A (rows n
// multiply-adds), against which a call costs nothing, and K3's Newton form
// evaluates at many sites (inlined there, the build took a minute longer).
constexpr int kLseRows = 32;

template <typename T> struct LogSumExp {
  const T* d0;
  const T* d1;
  int rows;
  T* z;
  T* p;

  // out[r] = a_r . v (+ b_r with kBias) for every row, by the warp; the
  // chunks of 32 rows from r_first every r_step (K3's Newton form splits
  // them over its warps)
  template <bool kBias>
  __device__ __noinline__ void rows_dot(const T* v, T* out, int n, int lane, int r_first = 0,
                                        int r_step = kWarp) const {
    for (int r0 = r_first; r0 < rows; r0 += r_step) {
      T acc[kWarp];
#pragma unroll
      for (int k = 0; k < kWarp; ++k) acc[k] = 0;
      for (int j = lane; j < n; j += kWarp) {
        const T vj = v[j];
        const T* col = d0 + (long long)r0 * n + j;
#pragma unroll
        for (int k = 0; k < kWarp; ++k)
          if (r0 + k < rows) acc[k] += col[(long long)k * n] * vj;
      }
      const T s = warp_sums<kWarp>(acc, lane);
      const int r = r0 + lane;
      if (r < rows) out[r] = kBias ? s + d1[r] : s;
    }
  }
  // w = A x + b, the value z_max + log sum_r exp(z_r - z_max) on every
  // lane and, with kSoftmax, w = softmax(A x + b) in place
  template <bool kSoftmax> __device__ __noinline__ T lse_pass(const T* x, T* w, int n, int lane) const {
    rows_dot<true>(x, w, n, lane);
    __syncwarp();
    T m = -(T)INFINITY;
    for (int r = lane; r < rows; r += kWarp) m = jmax(m, w[r]);
    const T mx = warp_max(m);
    T e = 0;
    for (int r = lane; r < rows; r += kWarp) e += exp(w[r] - mx);
    const T s = warp_sum(e);
    if constexpr (kSoftmax) {
      __syncwarp();
      for (int r = lane; r < rows; r += kWarp) w[r] = exp(w[r] - mx) / s;
    }
    __syncwarp();
    return mx + log(s);
  }
  __device__ T value(const T* x, int n, int lane) const { return lse_pass<false>(x, z, n, lane); }
  // out[j] = sum_r w_r A[r][j] for the lane's columns, the rows in order
  __device__ __noinline__ void cols_dot(const T* w, T* out, int n, int lane) const {
    for (int j = lane; j < n; j += kWarp) {
      T acc = 0;
      for (int r = 0; r < rows; ++r) acc += w[r] * d0[(long long)r * n + j];
      out[j] = acc;
    }
  }
  // with kDot, g.d for a direction d into *gd in the same pass
  template <bool kDot = false>
  __device__ T value_grad(const T* x, T* g, int n, int lane, const T* d = nullptr,
                          T* gd = nullptr) const {
    const T f = lse_pass<true>(x, z, n, lane);
    cols_dot(z, g, n, lane);
    if constexpr (kDot) {
      T q = 0;
      for (int j = lane; j < n; j += kWarp) q += g[j] * d[j];
      *gd = warp_sum(q);
    }
    __syncwarp();
    return f;
  }
  // p = softmax(A x + b) at x, for the hvps of one Newton step
  __device__ void prepare(const T* x, int n, int lane) const { lse_pass<true>(x, p, n, lane); }
  // H v at prepare's x: A^T (p .* (A v - p . A v)), A v and then the
  // weights in z
  __device__ __noinline__ void hvp(const T*, const T* v, T* out, int n, int lane) const {
    rows_dot<false>(v, z, n, lane);
    __syncwarp();
    T pav = 0;
    for (int r = lane; r < rows; r += kWarp) pav += p[r] * z[r];
    pav = warp_sum(pav);
    for (int r = lane; r < rows; r += kWarp) z[r] = p[r] * (z[r] - pav);
    __syncwarp();
    cols_dot(z, out, n, lane);
    __syncwarp();
  }

  // ---- block-level (kCholThreads threads; every thread calls these)
  static constexpr bool kBlockEval = false;
  // the scratch hessian takes: 16 reduction words, A^T p (n, rounded up to
  // 4) and the two staged strips (kLseRows x kTile each)
  __host__ __device__ static long long hessian_scratch_elems(int n) {
    return 16 + (n + 3) / 4 * 4 + 2LL * kLseRows * ost_chol::CholTile<T>::kTile;
  }
  // the block's max (kMax) or sum of one value a thread, on every thread
  template <bool kMax> __device__ static T block_reduce(T v, T* words, int tid) {
    v = kMax ? warp_max(v) : warp_sum(v);
    if ((tid & (kWarp - 1)) == 0) words[tid / kWarp] = v;
    ost_chol::chol_bar();
    T r = words[0];
    for (int q = 1; q < ost_chol::kCholWarps; ++q) r = kMax ? jmax(r, words[q]) : r + words[q];
    ost_chol::chol_bar();
    return r;
  }
  __device__ __noinline__ void hessian(const T* x, T* H, int n, int tid, T* scratch) const {
    using ost_chol::kCholThreads;
    using ost_chol::kCholWarps;
    constexpr int kT = ost_chol::CholTile<T>::kTile, kM = ost_chol::CholTile<T>::kMicro;
    constexpr int kG = kT / kM;   // micro-tiles along a tile's side
    const int lane = tid & (kWarp - 1), warp = tid / kWarp;
    T* words = scratch;
    T* pa = scratch + 16;
    T* si = pa + (n + 3) / 4 * 4;   // p_r A[r][i0 + c]
    T* sj = si + kLseRows * kT;     // A[r][j0 + c]
    // z by the warps, 32 rows a chunk each in turn, then p
    rows_dot<true>(x, z, n, lane, warp * kWarp, kCholThreads);
    ost_chol::chol_bar();
    T m = -(T)INFINITY;
    for (int r = tid; r < rows; r += kCholThreads) m = jmax(m, z[r]);
    const T mx = block_reduce<true>(m, words, tid);
    T e = 0;
    for (int r = tid; r < rows; r += kCholThreads) e += exp(z[r] - mx);
    const T s = block_reduce<false>(e, words, tid);
    for (int r = tid; r < rows; r += kCholThreads) z[r] = exp(z[r] - mx) / s;
    ost_chol::chol_bar();
    // A^T p, the rows in order
    for (int i = tid; i < n; i += kCholThreads) {
      T acc = 0;
      for (int r = 0; r < rows; ++r) acc += z[r] * d0[(long long)r * n + i];
      pa[i] = acc;
    }
    // the upper triangle's tiles (ti <= tj), each thread its micro-tile
    const int ty = tid / kG, tx = tid % kG;
    const int tiles = (n + kT - 1) / kT;
    for (int ti = 0; ti < tiles; ++ti)
      for (int tj = ti; tj < tiles; ++tj) {
        const int i0 = ti * kT, j0 = tj * kT;
        T acc[kM][kM];
#pragma unroll
        for (int u = 0; u < kM; ++u)
#pragma unroll
          for (int v = 0; v < kM; ++v) acc[u][v] = 0;
        for (int r0 = 0; r0 < rows; r0 += kLseRows) {
          ost_chol::chol_bar();
          for (int e2 = tid; e2 < kLseRows * kT; e2 += kCholThreads) {
            const int r = r0 + e2 / kT, c = e2 % kT;
            const bool in = r < rows;
            const T* ar = d0 + (long long)r * n;
            si[e2] = in && i0 + c < n ? z[r] * ar[i0 + c] : T(0);
            sj[e2] = in && j0 + c < n ? ar[j0 + c] : T(0);
          }
          ost_chol::chol_bar();
          for (int r = 0; r < kLseRows; ++r) {
            T a[kM], b[kM];
#pragma unroll
            for (int u = 0; u < kM; ++u) {
              a[u] = si[r * kT + ty * kM + u];
              b[u] = sj[r * kT + tx * kM + u];
            }
#pragma unroll
            for (int u = 0; u < kM; ++u)
#pragma unroll
              for (int v = 0; v < kM; ++v) acc[u][v] += a[u] * b[v];
          }
        }
#pragma unroll
        for (int u = 0; u < kM; ++u) {
          const int i = i0 + ty * kM + u;
#pragma unroll
          for (int v = 0; v < kM; ++v) {
            const int j = j0 + tx * kM + v;
            if (i < n && j < n && j >= i) H[(long long)i * n + j] = acc[u][v] - pa[i] * pa[j];
          }
        }
      }
  }
};

// K1's scaled form (ops.lbfgsb_solve_fused_scaled): the objective at x =
// z / s and its gradient in z, g_i / s_i, for the change of variables z =
// s x with s = sqrt(diag) in device memory, (n,) and shared by the batch.
// The inner functor's `_at` members evaluate at coordinate i through an
// accessor of z[i + d] / s[i + d], and each gradient entry is divided by
// s_i, as JAX's z / s and its derivative divide: at s = 1 every number is
// the inner functor's bit for bit.
template <typename T> __device__ __forceinline__ auto unscaled(const T* z, const T* s, int i) {
  return [z, s, i](int d) { return z[i + d] / s[i + d]; };
}

template <class Inner> struct Scaled;

template <typename T> struct Scaled<Rosenbrock<T>> {
  Rosenbrock<T> inner;
  const T* s;
  __device__ T value(const T* z, int n, int lane) const {
    T acc = 0;
    for (int i = lane; i < n - 1; i += kWarp) acc += Rosenbrock<T>::term_at(unscaled(z, s, i));
    return warp_sum(acc);
  }
  __device__ T value_grad(const T* z, T* g, int n, int lane) const {
    T acc = 0;
    for (int i = lane; i < n; i += kWarp)
      g[i] = Rosenbrock<T>::grad_at(unscaled(z, s, i), i, n, acc) / s[i];
    return warp_sum(acc);
  }
};

template <typename T> struct Scaled<WeightedSquares<T>> {
  WeightedSquares<T> inner;
  const T* s;
  __device__ T value(const T* z, int n, int lane) const {
    T acc = 0;
    for (int i = lane; i < n; i += kWarp) inner.grad_at(z[i] / s[i], i, acc);
    return T(0.5) * warp_sum(acc);
  }
  __device__ T value_grad(const T* z, T* g, int n, int lane) const {
    T acc = 0;
    for (int i = lane; i < n; i += kWarp) g[i] = inner.grad_at(z[i] / s[i], i, acc) / s[i];
    return T(0.5) * warp_sum(acc);
  }
};

// T in a non-deduced context: a null argument there deduces nothing
template <class T> struct NoDeduce { using type = T; };
template <class T> using NoDeduce_t = typename NoDeduce<T>::type;

// a kernel's functor from its data pointers, the scale s (Scaled only)
// and, for LogSumExp, its rows and its buffers z and p of `rows` elements
// each in the caller's shared memory.  kRowBuffers is how many of them the
// functor reads: LogSumExp's value and gradient read z, its prepare and hvp
// p too (2); the others none, and their kernels leave no room for them.
// A kernel that takes no hvp (K1, K3's one-warp and dense forms, K9)
// reserves z alone and binds p as null
template <class Obj> struct Bind {
  static constexpr int kRowBuffers = 0;
  template <typename T>
  __device__ static Obj make(const T* d0, const T* d1, NoDeduce_t<const T*> = nullptr,
                             int = 0, NoDeduce_t<T*> = nullptr, NoDeduce_t<T*> = nullptr) {
    return Obj{d0, d1};
  }
};
template <class Inner> struct Bind<Scaled<Inner>> {
  static constexpr int kRowBuffers = 0;
  template <typename T>
  __device__ static Scaled<Inner> make(const T* d0, const T* d1, NoDeduce_t<const T*> s,
                                       int = 0, NoDeduce_t<T*> = nullptr,
                                       NoDeduce_t<T*> = nullptr) {
    return Scaled<Inner>{Inner{d0, d1}, s};
  }
};
template <typename T> struct Bind<LogSumExp<T>> {
  static constexpr int kRowBuffers = 2;
  __device__ static LogSumExp<T> make(const T* d0, const T* d1, const T*, int rows, T* z,
                                      T* p) {
    return LogSumExp<T>{d0, d1, rows, z, p};
  }
};

}  // namespace
