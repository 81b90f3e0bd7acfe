// Whole batched L-BFGS-B solves on Hopper (sm_90a), one warp per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgsb.py
// (lbfgsb_solve_fused, kernel body _make_kernel, pl.pallas_call at :938).
// The plain PyTorch version of the same algorithm is lbfgsb_solve_plain in
// ../fused_lbfgsb.py; the two are held against each other on the card.
//
// What bounds it on this card: not bytes or FLOPs.  Per iteration an
// instance does O((m + walk) n) multiply-adds and O(m^2) small dense work,
// almost all of it latency-bound: warp reductions (five shuffles each),
// shared-memory round trips and the serial O(m^2)/O(m^3) triangular work.
// The design keeps every per-instance vector in shared memory for the whole
// solve, so device memory is touched only to read x0, the bounds and the
// objective data and to write the result; enough warps per SM hide the
// latency of one another.
//
// Design:
//  * one warp per instance; coordinate i belongs to lane i % 32, so a lane
//    only ever writes its own coordinates of the per-instance vectors;
//  * dynamic shared memory per warp: X, G, the direction D, the trial /
//    Cauchy point XT, DG (Cauchy direction, then the trial gradient), TB
//    (breakpoints, then scratch), FX (fixed, then free mask), the S and Y
//    histories and the m x m tables: (2m+7) n + 6 m^2 + 17 m elements;
//  * S and Y are a ring of m slots; hist(p) maps the chronological index p
//    (0 oldest, m-1 newest) to its slot, and the small Gram tables S.Y and
//    S.S stay in chronological order, shifted on every accepted pair;
//  * reductions are __shfl_xor_sync butterflies, so every lane holds the
//    same sum and the scalar state (f, theta, t, ...) is kept replicated in
//    registers; all branches on it are warp-uniform;
//  * the O(m^2)/O(m^3) middle-matrix work runs in shared memory on one lane
//    (Cholesky columns on several), and the three independent M^{-1}
//    solves of each Cauchy-walk step on lanes 0, 1 and 2;
//  * the one-hot gathers of the TPU kernel are direct reads of coordinate b;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum do (fminf/fmin
//    would drop it), the walk's arg-min breaks ties on the lowest index as
//    jnp.argmin does, and machine epsilon is the JAX kernel's literal
//    (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxM = 20;
constexpr long long kSmemPerBlock = 232448;   // 227 KB opt-in per block

enum ErrorCode { kErrArgs = -1, kErrSmem = -2 };
enum ObjectiveCode { kRosenbrock = 0, kWeightedSquares = 1 };

template <typename T> struct Lit;
template <> struct Lit<float> { static constexpr double eps = 1.2e-7; };
template <> struct Lit<double> { static constexpr double eps = 2.2e-16; };

__host__ __device__ inline long long work_elems(int n, int m) {
  return (long long)(2 * m + 7) * n + 6LL * m * m + 17LL * m;
}

template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}
template <typename T> __device__ __forceinline__ T jclip(T x, T lo, T up) {
  return jmin(jmax(x, lo), up);
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

// ---- objective functors: value (warp-reduced) and value + gradient -------

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
};

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
};

template <typename T, class Obj, bool UNBOUNDED>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
lbfgsb_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, m = prm.m, m2 = 2 * prm.m;
  const T INF = (T)INFINITY;
  const T eps = prm.eps;

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems(n, m);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* DG = p; p += n;
  T* TB = p; p += n;
  T* FX = p; p += n;
  T* S = p; p += (long long)m * n;
  T* Y = p; p += (long long)m * n;
  T* SY = p; p += m * m;
  T* SS = p; p += m * m;
  T* L = p; p += m * m;       // Schur factor; in the subspace step H, then its factor
  T* E = p; p += m * m;
  T* GM = p; p += m * m;
  T* EG = p; p += m * m;
  T* DH = p; p += m;
  T* VAL = p; p += m;
  T* ALPHA = p; p += m;
  T* C = p; p += m2;
  T* P = p; p += m2;
  T* WB = p; p += m2;
  T* R0 = p; p += m2;
  T* R1 = p; p += m2;
  T* R2 = p; p += m2;
  T* UV = p;

  const T* lo = prm.lo + (long long)inst * prm.bstride;
  const T* up = prm.up + (long long)inst * prm.bstride;
  const T* x0 = prm.x0 + (long long)inst * n;
  const Obj obj{prm.d0, prm.d1};

  int oldest = 0;             // ring slot of the chronologically oldest pair
  auto hist = [&](T* base, int q) { return base + (long long)((oldest + q) % m) * n; };

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
  // out = M^{-1} in for the 2m x 2m middle matrix (one lane; no aliasing)
  auto mid_solve = [&](const T* in, T* out) {
    const T* a = in;
    const T* bv = in + m;
    T* v = out + m;
    for (int i = 0; i < m; ++i) {
      T s = bv[i];
      for (int k = 0; k < i; ++k) s = s + SY[i * m + k] * a[k] / DH[k];
      v[i] = s;
    }
    chol_solve(L, v, 1);
    for (int i = 0; i < m; ++i) {
      T s = -a[i];
      for (int k = i + 1; k < m; ++k) s = s + SY[k * m + i] * v[k];
      out[i] = s / DH[i];
    }
  };

  // ---- W = [Y^T, theta S^T] products --------------------------------------

  T theta = 1;
  // out[0:2m] = W^T vec (written by lane 0)
  auto w_dot = [&](const T* vec, T* out) {
    for (int q = 0; q < m; ++q) {
      const T* Yq = hist(Y, q);
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Yq[i] * vec[i];
      s = warp_sum(s);
      if (lane == 0) out[q] = s;
    }
    for (int q = 0; q < m; ++q) {
      const T* Sq = hist(S, q);
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Sq[i] * vec[i];
      s = theta * warp_sum(s);
      if (lane == 0) out[m + q] = s;
    }
  };
  // out = W c (each lane its own coordinates)
  auto w_apply = [&](const T* c, T* out) {
    for (int i = lane; i < n; i += kWarp) out[i] = 0;
    for (int q = 0; q < m; ++q) {
      const T* Yq = hist(Y, q);
      const T cq = c[q];
      for (int i = lane; i < n; i += kWarp) out[i] = out[i] + cq * Yq[i];
    }
    for (int q = 0; q < m; ++q) {
      const T* Sq = hist(S, q);
      const T cq = c[m + q] * theta;
      for (int i = lane; i < n; i += kWarp) out[i] = out[i] + cq * Sq[i];
    }
  };
  // r with x - r the quasi-Newton point, H0 = I / theta
  auto two_loop = [&](T* r) {
    for (int i = lane; i < n; i += kWarp) r[i] = G[i];
    for (int j = m - 1; j >= 0; --j) {
      const T* Sj = hist(S, j);
      const T* Yj = hist(Y, j);
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Sj[i] * r[i];
      const T a = (VAL[j] / DH[j]) * warp_sum(s);
      if (lane == 0) ALPHA[j] = a;
      for (int i = lane; i < n; i += kWarp) r[i] = r[i] - a * Yj[i];
    }
    for (int i = lane; i < n; i += kWarp) r[i] = r[i] / theta;
    __syncwarp();
    for (int j = 0; j < m; ++j) {
      const T* Sj = hist(S, j);
      const T* Yj = hist(Y, j);
      T s = 0;
      for (int i = lane; i < n; i += kWarp) s += Yj[i] * r[i];
      const T coef = ALPHA[j] - (VAL[j] / DH[j]) * warp_sum(s);
      for (int i = lane; i < n; i += kWarp) r[i] = r[i] + coef * Sj[i];
    }
  };
  auto seg_min = [&](T f1, T f2) -> T {
    return f2 > eps ? -f1 / f2 : (f1 < T(0) ? INF : T(0));
  };
  auto breakpoint = [&](int i) -> T {
    const T g = G[i], x = X[i];
    return g < T(0) ? (x - up[i]) / g : (g > T(0) ? (x - lo[i]) / g : INF);
  };

  // ---- solver state -------------------------------------------------------

  for (int i = lane; i < n; i += kWarp) X[i] = jclip(x0[i], lo[i], up[i]);
  for (long long i = lane; i < (long long)m * n; i += kWarp) { S[i] = 0; Y[i] = 0; }
  for (int e = lane; e < m * m; e += kWarp) { SY[e] = 0; SS[e] = 0; }
  for (int e = lane; e < m; e += kWarp) VAL[e] = 0;
  __syncwarp();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();
  T Fprev = INF;
  int iters = 0;
  bool abn = false;

  auto converged = [&]() -> bool {
    T pg = 0;
    for (int i = lane; i < n; i += kWarp)
      pg = jmax(pg, (T)fabs(X[i] - jclip(X[i] - G[i], lo[i], up[i])));
    pg = warp_max(pg);
    const T fmax = jmax(jmax((T)fabs(Fv), (T)fabs(Fprev)), T(1));
    return (pg <= prm.pgtol) ||
           (isfinite(Fprev) && (Fprev - Fv) <= prm.f_rtol * fmax);
  };

  bool active = isfinite(Fv) && !abn && !converged();
  for (int it = 0; it < prm.max_iter && active; ++it) {
    if (UNBOUNDED) {
      // every bound infinite: the interior fast path is the iteration
      for (int q = lane; q < m; q += kWarp) DH[q] = VAL[q] > T(0) ? SY[q * m + q] : T(1);
      __syncwarp();
      two_loop(D);
      for (int i = lane; i < n; i += kWarp) D[i] = -D[i];
    } else {
      // ---- middle matrix: DH and the Cholesky factor of the Schur complement
      for (int q = lane; q < m; q += kWarp) DH[q] = VAL[q] > T(0) ? SY[q * m + q] : T(1);
      __syncwarp();
      for (int e = lane; e < m * m; e += kWarp) {
        const int r = e / m, q = e % m;
        if (q > r) continue;
        T v = theta * SS[e];
        for (int k = 0; k < q; ++k) v = v + SY[r * m + k] * SY[q * m + k] / DH[k];
        if (r == q && !(VAL[r] > T(0))) v = T(1);
        L[e] = v;
      }
      __syncwarp();
      chol(L);

      // ---- interior fast-path gate, decided for this instance
      T tmin = INF, tfirst = INF, dd = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T tb = breakpoint(i);
        tmin = jmin(tmin, tb);
        tfirst = jmin(tfirst, tb > T(0) ? tb : INF);
        const T d0 = tb > T(0) ? -G[i] : T(0);
        DG[i] = d0;
        dd += d0 * d0;
      }
      const bool blocked = warp_min(tmin) <= T(0);
      tfirst = warp_min(tfirst);
      T f1 = -warp_sum(dd);
      w_dot(DG, P);
      __syncwarp();
      if (lane == 0) mid_solve(P, R1);
      __syncwarp();
      T pMp = 0;
      for (int r = 0; r < m2; ++r) pMp = pMp + P[r] * R1[r];
      T f2 = -theta * f1 - pMp;
      const T dt0 = seg_min(f1, f2);
      two_loop(TB);
      T inmin = INF;
      for (int i = lane; i < n; i += kWarp) {
        const T xn = X[i] - TB[i];
        inmin = jmin(inmin, jmin(xn - lo[i], up[i] - xn));
      }
      const bool in_box = warp_min(inmin) >= T(0);

      if (!blocked && dt0 < tfirst && in_box) {
        for (int i = lane; i < n; i += kWarp)
          D[i] = jclip(X[i] - TB[i], lo[i], up[i]) - X[i];
      } else {
        // ---- generalized Cauchy point: breakpoint walk
        for (int i = lane; i < n; i += kWarp) {
          const T tb = breakpoint(i);
          DG[i] = tb > T(0) ? -G[i] : T(0);
          TB[i] = tb > T(0) ? tb : INF;
          XT[i] = X[i];
          FX[i] = 0;
        }
        __syncwarp();
        if (lane == 0)
          for (int r = 0; r < m2; ++r) C[r] = 0;
        T t_old = 0, dt_min = seg_min(f1, f2);
        for (int trip = 0; trip < n; ++trip) {
          T tv = INF;
          int bi = n;
          for (int i = lane; i < n; i += kWarp)
            if (TB[i] < tv) { tv = TB[i]; bi = i; }
          warp_argmin(tv, bi);
          if (!(isfinite(tv) && dt_min >= tv - t_old)) break;
          const T dt = tv - t_old;
          const T gb = G[bi];
          const T bound = DG[bi] > T(0) ? up[bi] : lo[bi];
          const T zb = bound - X[bi];
          if (lane == 0) {
            for (int r = 0; r < m2; ++r) C[r] = C[r] + dt * P[r];
            for (int q = 0; q < m; ++q) {
              WB[q] = hist(Y, q)[bi];
              WB[m + q] = theta * hist(S, q)[bi];
            }
          }
          __syncwarp();
          if (lane == 0) mid_solve(C, R0);
          else if (lane == 1) mid_solve(P, R1);
          else if (lane == 2) mid_solve(WB, R2);
          __syncwarp();
          T wMc = 0, wMp = 0, wMw = 0;
          for (int r = 0; r < m2; ++r) {
            wMc = wMc + WB[r] * R0[r];
            wMp = wMp + WB[r] * R1[r];
            wMw = wMw + WB[r] * R2[r];
          }
          const T f1n = f1 + dt * f2 + gb * gb + theta * gb * zb - gb * wMc;
          const T f2n = f2 - theta * gb * gb - T(2) * gb * wMp - gb * gb * wMw;
          __syncwarp();
          if (lane == 0)
            for (int r = 0; r < m2; ++r) P[r] = P[r] + gb * WB[r];
          if (lane == (bi & (kWarp - 1))) {
            DG[bi] = 0;
            XT[bi] = bound;
            FX[bi] = 1;
            TB[bi] = INF;
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
        if (lane == 0)
          for (int r = 0; r < m2; ++r) C[r] = C[r] + dt_fin * P[r];
        for (int i = lane; i < n; i += kWarp) {
          if (!(FX[i] > T(0))) XT[i] = X[i] + (DG[i] == T(0) ? T(0) : t_cp * DG[i]);
          FX[i] = (breakpoint(i) > T(0) && FX[i] == T(0)) ? T(1) : T(0);   // free
        }
        __syncwarp();

        // ---- primal subspace step from the Cauchy point
        if (lane == 0) mid_solve(C, R0);
        __syncwarp();
        w_apply(R0, TB);
        for (int i = lane; i < n; i += kWarp) {
          const T r = G[i] + theta * (XT[i] - X[i]) - TB[i];
          D[i] = FX[i] > T(0) ? r : T(0);
        }
        // E = D + Y_F Y_F^T / theta, H = theta S_A S_A^T (patched),
        // Gm = L^T - Y_F S_F^T
        for (int r = 0; r < m; ++r) {
          const T* Yr = hist(Y, r);
          const T* Sr = hist(S, r);
          for (int q = 0; q < m; ++q) {
            const T* Yq = hist(Y, q);
            const T* Sq = hist(S, q);
            if (q <= r) {
              T se = 0, sh = 0;
              for (int i = lane; i < n; i += kWarp) {
                const T fr = FX[i];
                const T ac = T(1) - fr;
                se += (Yr[i] * fr) * (Yq[i] * fr);
                sh += (Sr[i] * ac) * (Sq[i] * ac);
              }
              T e = warp_sum(se) / theta;
              T h = theta * warp_sum(sh);
              if (r == q) {
                e = e + DH[r];
                h = h + (VAL[r] > T(0) ? T(0) : T(1));
              }
              if (lane == 0) {
                E[r * m + q] = e;
                E[q * m + r] = e;
                L[r * m + q] = h;
                L[q * m + r] = h;
              }
            }
            T sg = 0;
            for (int i = lane; i < n; i += kWarp) sg += (Yr[i] * FX[i]) * (Sq[i] * FX[i]);
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
        w_dot(D, R1);                   // [a; b] = W^T r_F
        __syncwarp();
        if (lane == 0) {
          for (int k = 0; k < m; ++k) R2[k] = R1[k];
          chol_solve(E, R2, 1);         // E^{-1} a
          for (int i = 0; i < m; ++i) {
            T s = R1[m + i];
            for (int k = 0; k < m; ++k) s = s + GM[k * m + i] * R2[k];
            UV[m + i] = s;
          }
          chol_solve(L, UV + m, 1);     // v
          for (int i = 0; i < m; ++i) {
            T s = -R1[i];
            for (int k = 0; k < m; ++k) s = s + GM[i * m + k] * UV[m + k];
            UV[i] = s;
          }
          chol_solve(E, UV, 1);         // u
        }
        __syncwarp();
        w_apply(UV, TB);
        T smin = INF;
        for (int i = lane; i < n; i += kWarp) {
          const bool fr = FX[i] > T(0);
          const T du = -(D[i] / theta + (fr ? TB[i] : T(0)) / (theta * theta));
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
          D[i] = jclip(XT[i] + alpha * (FX[i] > T(0) ? D[i] : T(0)), lo[i], up[i]) - X[i];
      }
    }

    // ---- projected Armijo backtracking, first trial capped at the max
    // feasible step
    T g0d = 0;
    for (int i = lane; i < n; i += kWarp) g0d += G[i] * D[i];
    g0d = warp_sum(g0d);
    T t = 1;
    if (!UNBOUNDED) {
      T fsmin = INF;
      for (int i = lane; i < n; i += kWarp) {
        const T d = D[i];
        T fs = d > T(0) ? (up[i] - X[i]) / d : (d < T(0) ? (lo[i] - X[i]) / d : INF);
        if (isnan(fs)) fs = INF;
        fsmin = jmin(fsmin, fs);
      }
      t = jmin(T(1), warp_min(fsmin));
    }
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      __syncwarp();
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      const T fv = obj.value(XT, n, lane);
      if (fv <= Fv + prm.c1 * t * g0d && isfinite(fv)) break;
      t = t * T(0.5);
    }

    // ---- step, failure semantics and history update
    __syncwarp();
    for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
    __syncwarp();
    const T fnew = obj.value_grad(XT, DG, n, lane);
    bool fin = true, same = true;
    for (int i = lane; i < n; i += kWarp) {
      fin = fin && isfinite(XT[i]) && isfinite(DG[i]);
      same = same && XT[i] == X[i];
    }
    const bool ok = isfinite(fnew) && __all_sync(kFull, fin);
    const bool no_move = __all_sync(kFull, same);
    const bool fail = !ok || fnew > Fv || t <= T(0) || no_move;
    bool has_hist = false;
    for (int q = 0; q < m; ++q) has_hist = has_hist || VAL[q] > T(0);
    const bool restart = fail && has_hist;
    if (fail && !has_hist) abn = true;
    T sy = 0, yy = 0;
    if (!fail) {
      for (int i = lane; i < n; i += kWarp) {
        const T s = XT[i] - X[i];
        const T y = DG[i] - G[i];
        sy += s * y;
        yy += y * y;
      }
    }
    sy = warp_sum(sy);
    yy = warp_sum(yy);
    if (!fail && sy > eps * yy) {
      T* Sn = S + (long long)oldest * n;
      T* Yn = Y + (long long)oldest * n;
      for (int i = lane; i < n; i += kWarp) {
        Sn[i] = XT[i] - X[i];
        Yn[i] = DG[i] - G[i];
      }
      oldest = (oldest + 1) % m;
      __syncwarp();
      if (lane == 0) {
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
      __syncwarp();
      const T* Snew = hist(S, m - 1);
      const T* Ynew = hist(Y, m - 1);
      for (int j = 0; j < m; ++j) {
        const T* Sj = hist(S, j);
        const T* Yj = hist(Y, j);
        T a = 0, c = 0, s2 = 0;
        for (int i = lane; i < n; i += kWarp) {
          a += Snew[i] * Yj[i];
          c += Sj[i] * Ynew[i];
          s2 += Snew[i] * Sj[i];
        }
        a = warp_sum(a);
        c = warp_sum(c);
        s2 = warp_sum(s2);
        if (lane == 0) {
          SY[(m - 1) * m + j] = a;
          SY[j * m + m - 1] = c;
          SS[(m - 1) * m + j] = s2;
          SS[j * m + m - 1] = s2;
        }
      }
      __syncwarp();
    }
    if (restart) {
      // wipe the model: zero pairs are inert rows of W
      for (long long i = lane; i < (long long)m * n; i += kWarp) { S[i] = 0; Y[i] = 0; }
      for (int e = lane; e < m * m; e += kWarp) { SY[e] = 0; SS[e] = 0; }
      for (int e = lane; e < m; e += kWarp) VAL[e] = 0;
      theta = 1;
      oldest = 0;
      __syncwarp();
    }
    // a restart disables the stall exit for the retry iteration
    Fprev = restart ? INF : Fv;
    if (!fail) {
      for (int i = lane; i < n; i += kWarp) {
        X[i] = XT[i];
        G[i] = DG[i];
      }
      Fv = fnew;
    }
    ++iters;
    __syncwarp();
    active = isfinite(Fv) && !abn && !converged();
  }

  const bool finite = isfinite(Fv);
  const int status = abn ? 5 : ((converged() && finite) ? 1 : (!finite ? 3 : 2));
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
  }
}

template <typename T, class Obj, bool UNBOUNDED>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long per_warp = work_elems(prm.n, prm.m) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > prm.B) wpb = prm.B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = lbfgsb_fused_kernel<T, Obj, UNBOUNDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((prm.B + wpb - 1) / wpb);
  kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int objective, int unbounded, const Params<T>& prm, cudaStream_t stream) {
  if (objective == kRosenbrock)
    return unbounded ? launch<T, Rosenbrock<T>, true>(prm, stream)
                     : launch<T, Rosenbrock<T>, false>(prm, stream);
  if (objective == kWeightedSquares) {
    if (prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
    return unbounded ? launch<T, WeightedSquares<T>, true>(prm, stream)
                     : launch<T, WeightedSquares<T>, false>(prm, stream);
  }
  return kErrArgs;
}

template <typename T>
int run(int objective, int unbounded, const void* x0, const void* lo,
        const void* up, int bstride, const void* d0, const void* d1, int B,
        int n, int m, double pgtol, double factr, int max_iter,
        int max_iter_ls, double c1, void* x, void* f, void* it, void* st,
        void* stream) {
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
  return dispatch<T>(objective, unbounded, prm, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" long long lbfgsb_fused_smem_per_warp(int n, int m, int elem_size) {
  return work_elems(n, m) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int lbfgsb_fused_launch(
    int dtype, int objective, int unbounded, const void* x0, const void* lo,
    const void* up, int bstride, const void* d0, const void* d1, int B, int n,
    int m, double pgtol, double factr, int max_iter, int max_iter_ls,
    double c1, void* x, void* f, void* it, void* st, void* stream) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM || (bstride != 0 && bstride != n))
    return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, unbounded, x0, lo, up, bstride, d0, d1, B, n,
                      m, pgtol, factr, max_iter, max_iter_ls, c1, x, f, it,
                      st, stream);
  if (dtype == 1)
    return run<double>(objective, unbounded, x0, lo, up, bstride, d0, d1, B,
                       n, m, pgtol, factr, max_iter, max_iter_ls, c1, x, f,
                       it, st, stream);
  return kErrArgs;
}

extern "C" const char* ost_error_string(int code) {
  if (code == kErrArgs) return "invalid arguments";
  if (code == kErrSmem) return "shared memory per instance exceeds a block's";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
