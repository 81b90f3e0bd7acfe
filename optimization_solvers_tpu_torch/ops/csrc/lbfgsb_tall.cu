// Whole batched large-n L-BFGS-B solves on Hopper (sm_90a), one thread
// block per instance: the tall kernel K2.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgsb_tall.py
// (lbfgsb_solve_fused_tall, kernel body _make_kernel, pl.pallas_call at
// :941).  The plain PyTorch version of the same algorithm is
// lbfgsb_solve_tall_plain in ../fused_lbfgsb_tall.py; the two are held
// against each other on the card.
//
// What bounds it on this card: bytes.  Each bisection probe of the Cauchy
// point (up to bisect_iters + 3 a iteration, typically 10-20) streams the
// instance's S and Y histories once (2 m n elements: 800 KB at config 4,
// n = 10,000, m = 10, float32), and so do the subspace tables (m passes)
// and the history update.  No SM's shared memory holds that, so the
// histories and every (n,) vector live in a device-memory workspace the
// wrapper allocates; the 50 MB L2 keeps the problem data (A of the
// log-sum-exp, 20 MB at config 4) and part of the histories of the blocks
// in flight.  Nothing here shares a read of S, Y or A between instances or
// between probes: that is where a faster version starts.
//
// Design:
//  * one block (32-256 threads) per instance; coordinate i belongs to
//    thread i % blockDim, so elementwise passes need no barrier, and a
//    barrier precedes every objective evaluation (Rosenbrock reads x[i+1]);
//  * the workspace of an instance is (2m + 9) n elements: X, G, TB
//    (breakpoints), BV (the bound each coordinate moves to), XC (Cauchy
//    point), RF (reduced gradient), D (direction), XT / GT (trial point and
//    its gradient), then the S and Y rings of m slots each;
//    hist(q) maps the chronological index q (0 oldest) to a slot, and the
//    Gram tables S.Y and S.S stay in chronological order in shared memory;
//  * reductions are warp shuffles, then one partial per warp in shared
//    memory summed in warp order, so every thread gets the same bits and
//    all scalar state (f, theta, the bisection bracket, the dcsrch state)
//    is kept replicated in registers; all branches on it are block-uniform;
//  * a probe's 4m + 1 sums (W^T d, W^T u and the free |g|^2) are
//    accumulated per thread in one pass and reduced together;
//  * the small dense algebra (explicit 2m x 2m inverse of the middle matrix,
//    the E / H / Gm tables, their Cholesky factors and solves) runs on warp
//    0 in shared memory, one table entry or one solve column per lane, each
//    entry summed in the TPU kernel's order;
//  * the line search mode ("armijo" or "dcsrch") is a runtime argument,
//    uniform over the grid; templates cover dtype x objective only.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / kWarp;
constexpr int kMaxRed = 4 * kMaxM + 2;        // values one reduction carries
constexpr int kMaxRows = 4096;                 // LOG_SUM_EXP rows in shared memory
constexpr int kVecs = 9;                       // (n,) vectors of the workspace

__host__ __device__ inline long long inst_elems(int n, int m) {
  return (long long)(2 * m + kVecs) * n;
}
__host__ inline long long smem_elems(int m, int rows) {
  // reduction scratch; SY, SS, MM, W0-W3; DL, VAL and six 2m vectors; BC
  return (long long)kMaxWarps * kMaxRed + kMaxRed + 10LL * m * m + 14LL * m + 8 +
         rows;
}

// ---- block reductions ------------------------------------------------------

template <typename T> struct Blk {
  T* red;      // kMaxWarps x kMaxRed partials
  T* out;      // kMaxRed results, read by every thread after the call
  int tid, nt, lane, warp, nw;

  // out[0:k] = sums over the block of the per-thread v[0:k]
  __device__ void sum_n(const T* v, int k) const {
    for (int j = 0; j < k; ++j) {
      const T s = warp_sum(v[j]);
      if (lane == 0) red[warp * kMaxRed + j] = s;
    }
    __syncthreads();
    for (int j = tid; j < k; j += nt) {
      T s = red[j];
      for (int w = 1; w < nw; ++w) s += red[w * kMaxRed + j];
      out[j] = s;
    }
    __syncthreads();
  }
  __device__ T sum(T v) const {
    sum_n(&v, 1);
    return out[0];
  }
  // hi = block max of hi, lo = block min of lo (NaN propagates)
  __device__ void maxmin(T& hi, T& lo) const {
    hi = warp_max(hi);
    lo = warp_min(lo);
    if (lane == 0) {
      red[warp * kMaxRed] = hi;
      red[warp * kMaxRed + 1] = lo;
    }
    __syncthreads();
    if (tid == 0) {
      T a = red[0], b = red[1];
      for (int w = 1; w < nw; ++w) {
        a = jmax(a, red[w * kMaxRed]);
        b = jmin(b, red[w * kMaxRed + 1]);
      }
      out[0] = a;
      out[1] = b;
    }
    __syncthreads();
    hi = out[0];
    lo = out[1];
  }
  __device__ T max(T v) const {
    T lo = v;
    maxmin(v, lo);
    return v;
  }
  __device__ T min(T v) const {
    T hi = v;
    maxmin(hi, v);
    return v;
  }
};

// ---- objective functors at block level -------------------------------------
// value(x) and value_grad(x, g) read x after a barrier and return the value
// to every thread; value_grad writes g at the calling thread's coordinates.

template <typename T> struct Rosenbrock {
  const T* d0;
  const T* d1;
  int rows;
  T* zbuf;
  __device__ T value(const T* x, int n, const Blk<T>& bk) const {
    T s = 0;
    for (int i = bk.tid; i < n - 1; i += bk.nt) {
      const T a = x[i + 1] - x[i] * x[i];
      const T b = T(1) - x[i];
      s += T(100) * (a * a) + b * b;
    }
    return bk.sum(s);
  }
  __device__ T value_grad(const T* x, T* g, int n, const Blk<T>& bk) const {
    T s = 0;
    for (int i = bk.tid; i < n; i += bk.nt) {
      T gi = 0;
      if (i < n - 1) {
        const T a = x[i + 1] - x[i] * x[i];
        const T b = T(1) - x[i];
        s += T(100) * (a * a) + b * b;
        gi = T(-400) * x[i] * a - T(2) * b;
      }
      if (i > 0) gi += T(200) * (x[i] - x[i - 1] * x[i - 1]);
      g[i] = gi;
    }
    return bk.sum(s);
  }
};

// 0.5 sum_i d_i (x_i - t_i)^2 with d = d0, t = d1
template <typename T> struct WeightedSquares {
  const T* d0;
  const T* d1;
  int rows;
  T* zbuf;
  __device__ T value(const T* x, int n, const Blk<T>& bk) const {
    T s = 0;
    for (int i = bk.tid; i < n; i += bk.nt) {
      const T r = x[i] - d1[i];
      s += d0[i] * r * r;
    }
    return T(0.5) * bk.sum(s);
  }
  __device__ T value_grad(const T* x, T* g, int n, const Blk<T>& bk) const {
    T s = 0;
    for (int i = bk.tid; i < n; i += bk.nt) {
      const T r = x[i] - d1[i];
      const T gi = d0[i] * r;
      g[i] = gi;
      s += gi * r;
    }
    return T(0.5) * bk.sum(s);
  }
};

// 0.5 x^T Q x + b^T x with Q = d0 (n x n, row-major), b = d1; the gradient
// 0.5 (Q x + Q^T x) + b is autodiff's for a Q that is not exactly symmetric
template <typename T> struct Quadratic {
  const T* d0;
  const T* d1;
  int rows;
  T* zbuf;
  __device__ T eval(const T* x, T* g, int n, const Blk<T>& bk) const {
    T acc[2] = {0, 0};
    for (int i = bk.tid; i < n; i += bk.nt) {
      const T* Qi = d0 + (long long)i * n;
      T qx = 0, qtx = 0;
      for (int j = 0; j < n; ++j) {
        qx += Qi[j] * x[j];
        if (g) qtx += d0[(long long)j * n + i] * x[j];
      }
      acc[0] += x[i] * qx;
      acc[1] += d1[i] * x[i];
      if (g) g[i] = T(0.5) * (qx + qtx) + d1[i];
    }
    bk.sum_n(acc, 2);
    return T(0.5) * bk.out[0] + bk.out[1];
  }
  __device__ T value(const T* x, int n, const Blk<T>& bk) const {
    return eval(x, nullptr, n, bk);
  }
  __device__ T value_grad(const T* x, T* g, int n, const Blk<T>& bk) const {
    return eval(x, g, n, bk);
  }
};

// log sum_r exp(a_r^T x + b_r) as z_max + log sum_r exp(z_r - z_max), with
// A = d0 (rows x n, row-major), b = d1; z and then softmax(z) stay in shared
// memory (zbuf); one warp per row for A x, threads striding coordinates for
// the gradient A^T softmax(z), so both read A coalesced
template <typename T> struct LogSumExp {
  const T* d0;
  const T* d1;
  int rows;
  T* zbuf;
  __device__ T lse(const T* x, int n, const Blk<T>& bk, T& mx, T& s) const {
    for (int r = bk.warp; r < rows; r += bk.nw) {
      const T* Ar = d0 + (long long)r * n;
      T acc = 0;
      for (int j = bk.lane; j < n; j += kWarp) acc += Ar[j] * x[j];
      acc = warp_sum(acc);
      if (bk.lane == 0) zbuf[r] = acc + d1[r];
    }
    __syncthreads();
    T m_ = -(T)INFINITY;
    for (int r = bk.tid; r < rows; r += bk.nt) m_ = jmax(m_, zbuf[r]);
    mx = bk.max(m_);
    T e = 0;
    for (int r = bk.tid; r < rows; r += bk.nt) e += exp(zbuf[r] - mx);
    s = bk.sum(e);
    return mx + log(s);
  }
  __device__ T value(const T* x, int n, const Blk<T>& bk) const {
    T mx, s;
    return lse(x, n, bk, mx, s);
  }
  __device__ T value_grad(const T* x, T* g, int n, const Blk<T>& bk) const {
    T mx, s;
    const T f = lse(x, n, bk, mx, s);
    for (int r = bk.tid; r < rows; r += bk.nt) zbuf[r] = exp(zbuf[r] - mx) / s;
    __syncthreads();
    for (int j = bk.tid; j < n; j += bk.nt) {
      T acc = 0;
      for (int r = 0; r < rows; ++r) acc += d0[(long long)r * n + j] * zbuf[r];
      g[j] = acc;
    }
    __syncthreads();            // zbuf is rewritten by the next evaluation
    return f;
  }
};

// ---- the kernel --------------------------------------------------------------

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  int bstride;          // 0: bounds shared by all instances; n: per instance
  const T* d0;
  const T* d1;
  int rows;             // LOG_SUM_EXP rows (0 otherwise)
  int B, n, m;
  T pgtol, f_rtol, eps, c1;
  int max_iter, max_iter_ls, bisect_iters, guard_maxseg, dcsrch;
  T* work;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* flag_out;
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kThreads) lbfgsb_tall_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int inst = blockIdx.x;
  const int n = prm.n, m = prm.m, m2 = 2 * prm.m;
  const T INF = (T)INFINITY;
  const T eps = prm.eps;
  Blk<T> bk;
  bk.tid = threadIdx.x;
  bk.nt = blockDim.x;
  bk.lane = bk.tid & (kWarp - 1);
  bk.warp = bk.tid / kWarp;
  bk.nw = bk.nt / kWarp;
  const int tid = bk.tid, nt = bk.nt, lane = bk.lane;
  const bool warp0 = bk.warp == 0;

  // shared memory: reduction scratch, the Gram tables and the small algebra
  T* sp = reinterpret_cast<T*>(smem_raw);
  bk.red = sp; sp += kMaxWarps * kMaxRed;
  bk.out = sp; sp += kMaxRed;
  T* SY = sp; sp += m * m;      // S.Y, chronological
  T* SS = sp; sp += m * m;      // S.S, chronological
  T* MM = sp; sp += 4 * m * m;  // explicit inverse of the middle matrix
  T* W0 = sp; sp += m * m;      // U, then E and its factor
  T* W1 = sp; sp += m * m;      // Sc and its factor, then Gm
  T* W2 = sp; sp += m * m;      // J, then E^-1 Gm
  T* W3 = sp; sp += m * m;      // JU, then H, Sch2 and its factor
  T* DL = sp; sp += m;          // D with invalid slots patched to 1
  T* VAL = sp; sp += m;         // 1 where a history slot holds a pair
  T* P2 = sp; sp += m2;         // W^T d of a probe
  T* C2 = sp; sp += m2;         // W^T u of a probe; W^T (xcp - x)
  T* MC = sp; sp += m2;         // M c
  T* U2 = sp; sp += m2;         // W^T r_F
  T* CO = sp; sp += m2;         // subspace coefficients [u; v]
  T* TMP = sp; sp += m2;
  T* BC = sp; sp += 8;          // scalars broadcast from warp 0
  T* zbuf = sp;                 // LOG_SUM_EXP rows

  const Obj obj{prm.d0, prm.d1, prm.rows, zbuf};
  const T* lo = prm.lo + (long long)inst * prm.bstride;
  const T* up = prm.up + (long long)inst * prm.bstride;
  const T* x0 = prm.x0 + (long long)inst * n;
  T* w = prm.work + (long long)inst * inst_elems(n, m);
  T* X = w; w += n;
  T* G = w; w += n;
  T* TB = w; w += n;
  T* BV = w; w += n;
  T* XC = w; w += n;
  T* RF = w; w += n;
  T* D = w; w += n;
  T* XT = w; w += n;
  T* GT = w; w += n;
  T* S = w; w += (long long)m * n;
  T* Y = w;

  int oldest = 0;               // ring slot of the chronologically oldest pair
  auto slot = [&](int q) { const int s = oldest + q; return s >= m ? s - m : s; };
  auto hist = [&](T* base, int q) { return base + (long long)slot(q) * n; };

  T theta = 1;

  // ---- small dense algebra on warp 0 (shared memory) ----------------------
  // in-place lower Cholesky of an m x m table, pivots floored at eps
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
  // solve (A A^T) z = v in place for a lower factor A; v strided (one lane)
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
  // MM = explicit inverse of the middle matrix (pallas_lbfgsb_tall.py:170-257)
  auto build_middle = [&]() {
    for (int q = lane; q < m; q += kWarp) DL[q] = VAL[q] > T(0) ? SY[q * m + q] : T(1);
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // U = L / D
      const int p = e / m, q = e % m;
      W0[e] = (q < p ? SY[e] : T(0)) / DL[q];
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // Sc
      const int p = e / m, q = e % m;
      const T ssp = SS[e] + ((p == q && !(VAL[p] > T(0))) ? T(1) : T(0));
      T v = theta * ssp;
      for (int k = 0; k < m; ++k) v = v + W0[p * m + k] * (k < q ? SY[q * m + k] : T(0));
      W1[e] = v;
    }
    __syncwarp();
    chol(W1);
    for (int j = lane; j < m; j += kWarp) {                // J = Sc^-1, by columns
      for (int i = 0; i < m; ++i) W2[i * m + j] = i == j ? T(1) : T(0);
      chol_solve(W1, W2 + j, m);
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // JU
      const int p = e / m, q = e % m;
      T v = 0;
      for (int k = 0; k < m; ++k) v = v + W2[p * m + k] * W0[k * m + q];
      W3[e] = v;
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // the four blocks
      const int p = e / m, q = e % m;
      T v = 0;
      for (int k = 0; k < m; ++k) v = v + W0[k * m + p] * W3[k * m + q];
      if (p == q) v = v - T(1) / DL[p];
      MM[p * m2 + q] = v;                                  // TL
      MM[p * m2 + m + q] = W3[q * m + p];                  // JU^T
      MM[(m + p) * m2 + q] = W3[p * m + q];                // JU
      MM[(m + p) * m2 + m + q] = W2[p * m + q];            // J
    }
  };
  // on warp 0: (a^T M b, a^T M c) for 2m-vectors a, b, c
  auto mquad2 = [&](const T* a, const T* b, const T* c, T& ab, T& ac) {
    T sb = 0, sc = 0;
    for (int r = lane; r < m2; r += kWarp) {
      T mb = 0, mc = 0;
      for (int k = 0; k < m2; ++k) {
        mb += MM[r * m2 + k] * b[k];
        mc += MM[r * m2 + k] * c[k];
      }
      sb += a[r] * mb;
      sc += a[r] * mc;
    }
    ab = warp_sum(sb);
    ac = warp_sum(sc);
  };
  auto seg_min = [&](T f1, T f2) -> T {
    return f2 > eps ? -f1 / f2 : (f1 < T(0) ? INF : T(0));
  };

  // ---- passes over the coordinates -----------------------------------------
  T acc[kMaxRed];
  // (f1, f2) of the model along the projected path at t_lo+
  auto seg_eval = [&](T t_lo, T& f1, T& f2) {
    for (int j = 0; j <= 4 * m; ++j) acc[j] = 0;
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i], g = G[i];
      const T mv = tb > T(0) ? T(1) : T(0);
      const T fs = mv * (tb > t_lo ? T(1) : T(0));
      const T d = -g * fs;
      const T u = mv * (tb <= t_lo ? BV[i] - X[i] : -g * t_lo);
      acc[4 * m] += fs * g * g;
      for (int q = 0; q < m; ++q) {
        const T y = hist(Y, q)[i], s = hist(S, q)[i];
        acc[q] += y * d;
        acc[m + q] += s * d;
        acc[2 * m + q] += y * u;
        acc[3 * m + q] += s * u;
      }
    }
    bk.sum_n(acc, 4 * m + 1);
    if (warp0) {
      for (int q = lane; q < m; q += kWarp) {
        P2[q] = bk.out[q];
        P2[m + q] = theta * bk.out[m + q];
        C2[q] = bk.out[2 * m + q];
        C2[m + q] = theta * bk.out[3 * m + q];
      }
      __syncwarp();
      T pc, pp;
      mquad2(P2, C2, P2, pc, pp);
      if (lane == 0) {
        const T g2f = bk.out[4 * m];
        BC[0] = (theta * t_lo - T(1)) * g2f - pc;
        BC[1] = theta * g2f - pp;
      }
    }
    __syncthreads();
    f1 = BC[0];
    f2 = BC[1];
  };
  // start of the segment holding t_at (largest moving breakpoint <= t_at, or
  // 0) and its end (the next moving breakpoint); t_min: the first one
  auto segment = [&](T t_at, T t_min, T& t_lo, T& t_hi) {
    T below = 0, above = INF;
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i];
      if (tb > T(0)) {
        if (tb <= t_at) below = jmax(below, tb);
        else if (tb > t_at) above = jmin(above, tb);
      }
    }
    bk.maxmin(below, above);
    t_lo = below;
    t_hi = below > T(0) ? above : t_min;
  };
  // out = W^T v (2m) for v = vec - base (base may be null)
  auto w_dot = [&](const T* vec, const T* base, T* out) {
    for (int j = 0; j < m2; ++j) acc[j] = 0;
    for (int i = tid; i < n; i += nt) {
      const T v = base ? vec[i] - base[i] : vec[i];
      for (int q = 0; q < m; ++q) {
        acc[q] += hist(Y, q)[i] * v;
        acc[m + q] += hist(S, q)[i] * v;
      }
    }
    bk.sum_n(acc, m2);
    for (int q = tid; q < m; q += nt) {
      out[q] = bk.out[q];
      out[m + q] = theta * bk.out[m + q];
    }
    __syncthreads();
  };
  // (W c)_i at the calling thread's coordinate i
  auto w_apply = [&](const T* c, int i) -> T {
    T a = 0;
    for (int q = 0; q < m; ++q) a = a + c[q] * hist(Y, q)[i];
    for (int q = 0; q < m; ++q) a = a + (c[m + q] * theta) * hist(S, q)[i];
    return a;
  };
  auto converged = [&](T Fv, T Fprev) -> bool {
    T pg = 0;
    for (int i = tid; i < n; i += nt)
      pg = jmax(pg, (T)fabs(X[i] - jclip(X[i] - G[i], lo[i], up[i])));
    pg = bk.max(pg);
    const T fmax = jmax(jmax((T)fabs(Fv), (T)fabs(Fprev)), T(1));
    return (pg <= prm.pgtol) || (isfinite(Fprev) && (Fprev - Fv) <= prm.f_rtol * fmax);
  };

  // ---- solver state -----------------------------------------------------------
  for (int i = tid; i < n; i += nt) X[i] = jclip(x0[i], lo[i], up[i]);
  for (long long i = tid; i < (long long)m * n; i += nt) { S[i] = 0; Y[i] = 0; }
  for (int e = tid; e < m * m; e += nt) { SY[e] = 0; SS[e] = 0; }
  for (int e = tid; e < m; e += nt) VAL[e] = 0;
  __syncthreads();
  T Fv = obj.value_grad(X, G, n, bk);
  T Fprev = INF;
  int iters = 0;
  bool abn = false, gflag = false;

  bool active = isfinite(Fv) && !converged(Fv, Fprev);
  for (int it = 0; it < prm.max_iter && active; ++it) {
    if (warp0) build_middle();
    __syncthreads();

    // ---- generalized Cauchy point by segment bisection
    T t_min = INF, hi0 = -INF;
    for (int i = tid; i < n; i += nt) {
      const T g = G[i], x = X[i];
      const T tb = g < T(0) ? (x - up[i]) / g : (g > T(0) ? (x - lo[i]) / g : INF);
      TB[i] = tb;
      BV[i] = g < T(0) ? up[i] : (g > T(0) ? lo[i] : x);
      if (tb > T(0)) {
        t_min = jmin(t_min, tb);
        if (isfinite(tb)) hi0 = jmax(hi0, tb);
      }
    }
    bk.maxmin(hi0, t_min);
    const bool has_fin = hi0 > T(0);
    T f1, f2;
    seg_eval(T(0), f1, f2);
    const T dt0 = seg_min(f1, f2);
    const bool doneA = f1 >= T(0);                       // t_cp = 0
    const bool doneB = !doneA && dt0 <= t_min;           // min in the 1st segment
    bool doneC = false;
    T dtL = 0;
    if (!doneA && !doneB) {
      seg_eval(has_fin ? hi0 : T(0), f1, f2);
      dtL = seg_min(f1, f2);
      doneC = has_fin && f1 < T(0);
    }
    bool done = doneA || doneB || doneC;
    T t_fin = doneC ? hi0 : T(0);
    T dtm = doneA ? T(0) : (doneB ? dt0 : dtL);
    T b_lo = t_min, b_hi = hi0;
    for (int j = 0; j < prm.bisect_iters && !done; ++j) {
      T t_lo, t_hi;
      segment(sqrt(b_lo) * sqrt(b_hi), t_min, t_lo, t_hi);
      seg_eval(t_lo, f1, f2);
      const T dt = seg_min(f1, f2);
      if ((f1 >= T(0) && t_lo <= b_lo) || (f1 < T(0) && t_lo + dt <= t_hi)) {
        done = true;
        t_fin = t_lo;
        dtm = dt;
      } else if (f1 >= T(0)) {
        b_hi = t_lo;
      } else if (f1 < T(0)) {
        b_lo = t_hi;
      }
    }
    T t_lo_fin = t_fin;
    if (!done) {
      // budget exhausted: finalize in the bracket's lo segment, dt clamped
      T t_lo, t_hi;
      segment(b_lo, t_min, t_lo, t_hi);
      seg_eval(t_lo, f1, f2);
      t_lo_fin = t_lo;
      dtm = jclip(seg_min(f1, f2), T(0), t_hi - t_lo);
      if (prm.guard_maxseg > 0) {
        T cnt = 0;
        for (int i = tid; i < n; i += nt) {
          const T tb = TB[i];
          if (tb > T(0) && tb > b_lo && tb <= b_hi) cnt += T(1);
        }
        if (bk.sum(cnt) <= T(prm.guard_maxseg)) gflag = true;
      }
    }
    dtm = jmax(dtm, T(0));
    const T t_cp = t_lo_fin + dtm;
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i];
      const T fr = (tb > T(0) && tb > t_lo_fin) ? T(1) : T(0);
      const T d_rem = -G[i] * fr;
      // t_cp is inf only where d_rem == 0: skip the inf * 0
      XC[i] = (tb > T(0) && tb <= t_lo_fin) ? BV[i]
                                            : X[i] + (d_rem == T(0) ? T(0) : t_cp * d_rem);
    }
    w_dot(XC, X, C2);                                    // c = W^T (xcp - x)
    if (warp0) {
      for (int r = lane; r < m2; r += kWarp) {
        T v = 0;
        for (int k = 0; k < m2; ++k) v += MM[r * m2 + k] * C2[k];
        MC[r] = v;
      }
    }
    __syncthreads();

    // ---- subspace minimization from the Cauchy point
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i];
      const T fr = (tb > T(0) && tb > t_lo_fin) ? T(1) : T(0);
      RF[i] = (G[i] + theta * (XC[i] - X[i]) - w_apply(MC, i)) * fr;
    }
    // E = Y_F Y_F^T / theta + D, H = theta (S.S~ - S_F S_F^T),
    // Gm = L^T - Y_F S_F^T, row p of each in one pass
    for (int p = 0; p < m; ++p) {
      const int k = 2 * (p + 1) + m;
      for (int j = 0; j < k; ++j) acc[j] = 0;
      const T* Yp = hist(Y, p);
      const T* Sp = hist(S, p);
      for (int i = tid; i < n; i += nt) {
        const T tb = TB[i];
        const T fr = (tb > T(0) && tb > t_lo_fin) ? T(1) : T(0);
        const T yp = Yp[i] * fr, spf = Sp[i] * fr;
        for (int q = 0; q < m; ++q) {
          const T sq = hist(S, q)[i] * fr;
          acc[2 * (p + 1) + q] += yp * sq;
          if (q <= p) {
            acc[q] += yp * (hist(Y, q)[i] * fr);
            acc[p + 1 + q] += spf * sq;
          }
        }
      }
      bk.sum_n(acc, k);
      for (int q = tid; q < m; q += nt) {
        if (q <= p) {
          T e = bk.out[q] / theta;
          if (q == p) e = e + DL[p];
          const T ssp = SS[p * m + q] + ((p == q && !(VAL[p] > T(0))) ? T(1) : T(0));
          const T h = theta * (ssp - bk.out[p + 1 + q]);
          W0[p * m + q] = e;
          W0[q * m + p] = e;
          W3[p * m + q] = h;
          W3[q * m + p] = h;
        }
        W1[p * m + q] = (q > p ? SY[q * m + p] : T(0)) - bk.out[2 * (p + 1) + q];
      }
    }
    __syncthreads();
    if (warp0) {
      chol(W0);                                          // E
      for (int j = lane; j < m; j += kWarp) {            // E^-1 Gm, by columns
        for (int i = 0; i < m; ++i) W2[i * m + j] = W1[i * m + j];
        chol_solve(W0, W2 + j, m);
      }
      __syncwarp();
      for (int e = lane; e < m * m; e += kWarp) {        // Sch2 = H + Gm^T E^-1 Gm
        const int p = e / m, q = e % m;
        if (q > p) continue;
        T v = W3[e];
        for (int k = 0; k < m; ++k) v = v + W1[k * m + p] * W2[k * m + q];
        W3[e] = v;
      }
      __syncwarp();
      chol(W3);
    }
    w_dot(RF, nullptr, U2);                              // [a; b] = W^T r_F
    if (tid == 0) {
      for (int i = 0; i < m; ++i) TMP[i] = U2[i];
      chol_solve(W0, TMP, 1);                            // E^-1 a
      for (int i = 0; i < m; ++i) {
        T s = U2[m + i];
        for (int k = 0; k < m; ++k) s = s + W1[k * m + i] * TMP[k];
        CO[m + i] = s;
      }
      chol_solve(W3, CO + m, 1);                         // v
      for (int i = 0; i < m; ++i) {
        T s = -U2[i];
        for (int k = 0; k < m; ++k) s = s + W1[i * m + k] * CO[m + k];
        CO[i] = s;
      }
      chol_solve(W0, CO, 1);                             // u
    }
    __syncthreads();
    T smin = INF;
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i];
      const bool free_i = tb > T(0) && tb > t_lo_fin;
      const T fr = free_i ? T(1) : T(0);
      const T du = -(RF[i] / theta + fr * w_apply(CO, i) / (theta * theta));
      D[i] = du;
      T st = du > T(0) ? (up[i] - XC[i]) / du : (du < T(0) ? (lo[i] - XC[i]) / du : INF);
      if (!free_i || st != st) st = INF;
      smin = jmin(smin, st);
    }
    const T alpha = jmin(T(1), bk.min(smin));
    T g0d = 0, fsmin = INF;
    for (int i = tid; i < n; i += nt) {
      const T tb = TB[i];
      const bool free_i = tb > T(0) && tb > t_lo_fin;
      const T d = jclip(XC[i] + alpha * (free_i ? D[i] : T(0)), lo[i], up[i]) - X[i];
      D[i] = d;
      g0d += G[i] * d;
      T fs = d > T(0) ? (up[i] - X[i]) / d : (d < T(0) ? (lo[i] - X[i]) / d : INF);
      if (fs != fs) fs = INF;
      fsmin = jmin(fsmin, fs);
    }
    g0d = bk.sum(g0d);
    const T stpmax = bk.min(fsmin);
    const T f0 = Fv;

    // ---- line search
    T t;
    if (!prm.dcsrch) {
      // projected value-only Armijo backtracking, first trial capped
      t = jmin(T(1), stpmax);
      for (int k = 0; k < prm.max_iter_ls; ++k) {
        for (int i = tid; i < n; i += nt) XT[i] = X[i] + t * D[i];
        __syncthreads();
        const T fv = obj.value(XT, n, bk);
        if (fv <= f0 + prm.c1 * t * g0d && isfinite(fv)) break;
        t = t * T(0.5);
      }
    } else {
      // MINPACK dcsrch strong Wolfe: ftol c1, gtol 0.9, xtol 0.1
      const T gtol = 0.9, xtol = 0.1, xtrapl = 1.1, xtrapu = 4.0;
      const T ginit = g0d, gtest = prm.c1 * ginit, stpmin = 0;
      const bool descent = ginit < T(0);
      T stp = descent ? jclip(T(1), stpmin, stpmax) : T(0);
      T stx = 0, fx = f0, dx = ginit, sty = 0, fy = f0, dy = ginit;
      bool brackt = false, stage1 = true;
      T width = stpmax - stpmin, width1 = width / T(0.5);
      T stmin = 0, stmax = stp + xtrapu * stp;
      bool wdone = !descent;
      for (int k = 0; k < prm.max_iter_ls && !wdone; ++k) {
        for (int i = tid; i < n; i += nt) XT[i] = X[i] + stp * D[i];
        __syncthreads();
        const T ft = obj.value_grad(XT, GT, n, bk);
        T gd = 0;
        for (int i = tid; i < n; i += nt) gd += GT[i] * D[i];
        gd = bk.sum(gd);
        const T ftest = f0 + stp * gtest;
        const bool stage1_n = stage1 && !(ft <= ftest && gd >= T(0));
        const bool finish = (ft <= ftest && fabs(gd) <= gtol * (-ginit)) ||
                            (brackt && stmax - stmin <= xtol * stmax) ||
                            (stp == stpmax && ft <= ftest && gd <= gtest) ||
                            (stp == stpmin && (ft > ftest || gd >= gtest)) ||
                            (brackt && (stp <= stmin || stp >= stmax));
        if (finish) {
          wdone = true;
          break;
        }
        const bool mod = stage1_n && ft <= fx && ft > ftest;
        T sx = stx, fxm = mod ? fx - stx * gtest : fx, dxm = mod ? dx - gtest : dx;
        T sy = sty, fym = mod ? fy - sty * gtest : fy, dym = mod ? dy - gtest : dy;
        T sn = stp;
        bool br = brackt;
        dcstep(sx, fxm, dxm, sy, fym, dym, sn, mod ? ft - stp * gtest : ft,
               mod ? gd - gtest : gd, br, stmin, stmax);
        if (mod) {
          fxm = fxm + sx * gtest;
          fym = fym + sy * gtest;
          dxm = dxm + gtest;
          dym = dym + gtest;
        }
        if (br && fabs(sy - sx) >= T(0.66) * width1) sn = sx + T(0.5) * (sy - sx);
        const T width1_n = br ? width : width1;
        const T width_n = br ? (T)fabs(sy - sx) : width;
        const T stmin_n = br ? fmin(sx, sy) : sn + xtrapl * (sn - sx);
        const T stmax_n = br ? fmax(sx, sy) : sn + xtrapu * (sn - sx);
        sn = jclip(sn, stpmin, stpmax);
        if (br && (sn <= stmin_n || sn >= stmax_n || stmax_n - stmin_n <= xtol * stmax_n))
          sn = sx;
        stp = sn;
        stx = sx; fx = fxm; dx = dxm;
        sty = sy; fy = fym; dy = dym;
        brackt = brackt || br;
        stage1 = stage1_n;
        width = width_n;
        width1 = width1_n;
        stmin = stmin_n;
        stmax = stmax_n;
      }
      t = wdone ? stp : stx;                             // exhaustion returns stx
    }

    // ---- step, failure semantics and history update
    for (int i = tid; i < n; i += nt) XT[i] = X[i] + t * D[i];
    __syncthreads();
    const T fnew = obj.value_grad(XT, GT, n, bk);
    bool fin = true, same = true;
    for (int i = tid; i < n; i += nt) {
      fin = fin && isfinite(XT[i]) && isfinite(GT[i]);
      same = same && XT[i] == X[i];
    }
    const bool ok = isfinite(fnew) && __syncthreads_and(fin);
    const bool no_move = __syncthreads_and(same);
    const bool fail = !ok || fnew > f0 || t <= T(0) || no_move;
    bool has_hist = false;
    for (int q = 0; q < m; ++q) has_hist = has_hist || VAL[q] > T(0);
    const bool restart = fail && has_hist;
    if (fail && !has_hist) abn = true;
    if (!fail) {
      T sy2[2] = {0, 0};
      for (int i = tid; i < n; i += nt) {
        const T s = XT[i] - X[i];
        const T y = GT[i] - G[i];
        sy2[0] += s * y;
        sy2[1] += y * y;
      }
      bk.sum_n(sy2, 2);
      const T sy = bk.out[0], yy = bk.out[1];
      __syncthreads();
      if (sy > eps * yy) {
        T* Sn = S + (long long)oldest * n;
        T* Yn = Y + (long long)oldest * n;
        for (int i = tid; i < n; i += nt) {
          Sn[i] = XT[i] - X[i];
          Yn[i] = GT[i] - G[i];
        }
        oldest = slot(1);
        if (tid == 0) {
          for (int r = 0; r < m - 1; ++r) {
            for (int q = 0; q < m - 1; ++q) {
              SY[r * m + q] = SY[(r + 1) * m + q + 1];
              SS[r * m + q] = SS[(r + 1) * m + q + 1];
            }
            VAL[r] = VAL[r + 1];
          }
          VAL[m - 1] = 1;
        }
        theta = yy / sy;
        const T* Snew = hist(S, m - 1);
        const T* Ynew = hist(Y, m - 1);
        for (int j = 0; j < 3 * m; ++j) acc[j] = 0;
        for (int i = tid; i < n; i += nt) {
          const T sn = Snew[i], yn = Ynew[i];
          for (int j = 0; j < m; ++j) {
            acc[j] += sn * hist(Y, j)[i];
            acc[m + j] += hist(S, j)[i] * yn;
            acc[2 * m + j] += sn * hist(S, j)[i];
          }
        }
        bk.sum_n(acc, 3 * m);
        if (tid == 0) {
          for (int j = 0; j < m; ++j) {
            SY[(m - 1) * m + j] = bk.out[j];
            SY[j * m + m - 1] = bk.out[m + j];
            SS[(m - 1) * m + j] = bk.out[2 * m + j];
            SS[j * m + m - 1] = bk.out[2 * m + j];
          }
        }
      }
    }
    if (restart) {
      // wipe the model: zero pairs are inert rows of W
      for (long long i = tid; i < (long long)m * n; i += nt) { S[i] = 0; Y[i] = 0; }
      for (int e = tid; e < m * m; e += nt) { SY[e] = 0; SS[e] = 0; }
      for (int e = tid; e < m; e += nt) VAL[e] = 0;
      theta = 1;
      oldest = 0;
    }
    // a restart disables the stall exit for the retry iteration
    Fprev = restart ? INF : f0;
    if (!fail) {
      for (int i = tid; i < n; i += nt) {
        X[i] = XT[i];
        G[i] = GT[i];
      }
      Fv = fnew;
    }
    ++iters;
    __syncthreads();
    active = isfinite(Fv) && !abn && !converged(Fv, Fprev);
  }

  const bool finite = isfinite(Fv);
  const int status = abn ? 5 : ((converged(Fv, Fprev) && finite) ? 1 : (!finite ? 3 : 2));
  for (int i = tid; i < n; i += nt) prm.x_out[(long long)inst * n + i] = X[i];
  if (tid == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.flag_out[inst] = gflag ? 1 : 0;
  }
}

template <typename T, class Obj>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long smem = smem_elems(prm.m, prm.rows) * (long long)sizeof(T);
  if (smem > kSmemPerBlock) return kErrSmem;
  int nt = ((prm.n + kWarp - 1) / kWarp) * kWarp;
  if (nt > kThreads) nt = kThreads;
  auto kernel = lbfgsb_tall_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<prm.B, nt, (size_t)smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int objective, const Params<T>& prm, cudaStream_t stream) {
  const bool two = prm.d0 != nullptr && prm.d1 != nullptr;
  switch (objective) {
    case kRosenbrock: return launch<T, Rosenbrock<T>>(prm, stream);
    case kWeightedSquares: return two ? launch<T, WeightedSquares<T>>(prm, stream) : kErrArgs;
    case kQuadratic: return two ? launch<T, Quadratic<T>>(prm, stream) : kErrArgs;
    case kLogSumExp:
      return two && prm.rows >= 1 && prm.rows <= kMaxRows
                 ? launch<T, LogSumExp<T>>(prm, stream) : kErrArgs;
  }
  return kErrArgs;
}

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        int bstride, const void* d0, const void* d1, int rows, int B, int n,
        int m, double pgtol, double factr, int max_iter, int max_iter_ls,
        double c1, int bisect_iters, int guard_maxseg, int dcsrch, void* work,
        void* x, void* f, void* it, void* st, void* flag, void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.bstride = bstride;
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.rows = objective == kLogSumExp ? rows : 0;
  prm.B = B;
  prm.n = n;
  prm.m = m;
  prm.pgtol = (T)pgtol;
  prm.f_rtol = (T)(factr * Lit<T>::eps);
  prm.eps = (T)Lit<T>::eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.bisect_iters = bisect_iters;
  prm.guard_maxseg = guard_maxseg;
  prm.dcsrch = dcsrch;
  prm.work = static_cast<T*>(work);
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.flag_out = static_cast<int*>(flag);
  return dispatch<T>(objective, prm, static_cast<cudaStream_t>(stream));
}

}  // namespace

// elements of the workspace the wrapper allocates for B instances
extern "C" long long lbfgsb_tall_work_elems(int B, int n, int m) {
  return (long long)B * inst_elems(n, m);
}

// dtype 0: float32, 1: float64; line_search 0: Armijo, 1: dcsrch.  Returns
// 0, a cudaError_t, or a negative ErrorCode; launches on `stream` and does
// not synchronise.
extern "C" int lbfgsb_tall_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    int bstride, const void* d0, const void* d1, int rows, int B, int n, int m,
    double pgtol, double factr, int max_iter, int max_iter_ls, double c1,
    int bisect_iters, int guard_maxseg, int line_search, void* work, void* x,
    void* f, void* it, void* st, void* flag, void* stream) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM || (bstride != 0 && bstride != n) ||
      (line_search != 0 && line_search != 1) || work == nullptr)
    return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, bstride, d0, d1, rows, B, n, m,
                      pgtol, factr, max_iter, max_iter_ls, c1, bisect_iters,
                      guard_maxseg, line_search, work, x, f, it, st, flag, stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, bstride, d0, d1, rows, B, n, m,
                       pgtol, factr, max_iter, max_iter_ls, c1, bisect_iters,
                       guard_maxseg, line_search, work, x, f, it, st, flag, stream);
  return kErrArgs;
}
