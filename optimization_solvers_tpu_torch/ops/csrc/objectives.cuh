// Warp-level objective functors shared by the one-warp-per-instance kernels
// (K1 lbfgsb_fused.cu, K3 driver.cu / driver_qn.cu / driver_newton.cu, K4
// newton_cg.cu, K7 lbfgs_fused.cu, K8 spg_fused.cu, and the first warp of
// K9 bfgs_fused.cu): one warp evaluates one instance, coordinate i on lane
// i % 32, and every lane returns the warp-reduced value.  The caller
// __syncwarp()s before a call (the functors read other lanes' coordinates
// of x and v) and after value_grad and hvp (each lane writes only its own
// coordinates of g and of the product).  K1, K8 and the first-order and
// quasi-Newton forms of K3 compile Rosenbrock and WeightedSquares; K7 and
// K9 all three (values and gradients); K3's Newton form and K4 all three,
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

#pragma once

#include "chol_blocked.cuh"
#include "common.cuh"

namespace {

template <typename T> struct Rosenbrock {
  const T* d0;
  const T* d1;
  __device__ T value(const T* x, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n - 1; i += kWarp) {
      T a = x[i + 1] - x[i] * x[i];
      T b = T(1) - x[i];
      s += T(100) * (a * a) + b * b;
    }
    return warp_sum(s);
  }
  __device__ T value_grad(const T* x, T* g, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n; i += kWarp) {
      T gi = 0;
      if (i < n - 1) {
        T a = x[i + 1] - x[i] * x[i];
        T b = T(1) - x[i];
        s += T(100) * (a * a) + b * b;
        gi = T(-400) * x[i] * a - T(2) * b;
      }
      if (i > 0) gi += T(200) * (x[i] - x[i - 1] * x[i - 1]);
      g[i] = gi;
    }
    return warp_sum(s);
  }
  // H_ii: 1200 x_i^2 - 400 x_{i+1} + 2 from term i, as 800 x_i x_i - 400 a_i
  // + 2, plus 200 from term i - 1; H_{i,i+1} = H_{i+1,i} = -400 x_i
  __device__ T hess_diag(const T* x, int i, int n) const {
    T h = 0;
    if (i < n - 1) {
      const T a = x[i + 1] - x[i] * x[i];
      h = T(800) * x[i] * x[i] - T(400) * a + T(2);
    }
    if (i > 0) h += T(200);
    return h;
  }
  static constexpr bool kBlockEval = false;
  __device__ void hessian(const T* x, T* H, int n, int tid, T*) const {
    for (int i = tid / kWarp; i < n; i += ost_chol::kCholWarps) {
      T* row = H + (long long)i * n;
      for (int j = i + tid % kWarp; j < n; j += kWarp) {
        T h = 0;
        if (j == i) h = hess_diag(x, i, n);
        else if (j == i + 1) h = T(-400) * x[i];
        row[j] = h;
      }
    }
  }
  __device__ void hvp(const T* x, const T* v, T* out, int n, int lane) const {
    for (int i = lane; i < n; i += kWarp) {
      T o = hess_diag(x, i, n) * v[i];
      if (i < n - 1) o += T(-400) * x[i] * v[i + 1];
      if (i > 0) o += T(-400) * x[i - 1] * v[i - 1];
      out[i] = o;
    }
  }
};

// 0.5 sum_i d_i (x_i - t_i)^2 with problem data d = d0, t = d1
template <typename T> struct WeightedSquares {
  const T* d0;
  const T* d1;
  __device__ T value(const T* x, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n; i += kWarp) {
      T r = x[i] - d1[i];
      s += d0[i] * r * r;
    }
    return T(0.5) * warp_sum(s);
  }
  __device__ T value_grad(const T* x, T* g, int n, int lane) const {
    T s = 0;
    for (int i = lane; i < n; i += kWarp) {
      T r = x[i] - d1[i];
      T gi = d0[i] * r;
      g[i] = gi;
      s += gi * r;
    }
    return T(0.5) * warp_sum(s);
  }
  static constexpr bool kBlockEval = false;
  __device__ void hessian(const T* x, T* H, int n, int tid, T*) const {
    for (int i = tid / kWarp; i < n; i += ost_chol::kCholWarps) {
      T* row = H + (long long)i * n;
      for (int j = i + tid % kWarp; j < n; j += kWarp) row[j] = j == i ? d0[i] : T(0);
    }
  }
  __device__ void hvp(const T* x, const T* v, T* out, int n, int lane) const {
    for (int i = lane; i < n; i += kWarp) out[i] = d0[i] * v[i];
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
  __device__ T value_grad(const T* x, T* g, int n, int lane) const {
    T sq = 0, sb = 0;
    for (int i = lane; i < n; i += kWarp) {
      T qx, qtx;
      rowcol(x, i, n, qx, qtx);
      sq += x[i] * qx;
      sb += d1[i] * x[i];
      g[i] = T(0.5) * (qx + qtx) + d1[i];
    }
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

}  // namespace
