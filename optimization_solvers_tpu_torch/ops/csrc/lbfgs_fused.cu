// Whole batched unconstrained L-BFGS solves on Hopper (sm_90a), one warp per
// instance (K7).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgs.py
// (lbfgs_solve_fused, kernel body _make_kernel, pl.pallas_call at :312).
// The plain PyTorch version of the same algorithm is lbfgs_solve_plain in
// ../fused_lbfgs.py; the two are held against each other on the card.
//
// The algorithm is the JAX kernel's: the direction -H g of the last m
// accepted pairs with H0 = gamma I (gamma = s.y / y.y of the last accepted
// pair, 1 before any); value Armijo from t = 1, halving up to max_iter_ls
// times, a non-finite trial rejected, and after the last rejection the
// halved step taken all the same; the pair accepted where s.y > eps y.y, a
// rejected pair writing a zeroed slot (the instance loses its oldest pair);
// stop on max|g| < tol.
//
// What bounds it on this card: not bytes or FLOPs.  An instance's iteration
// is a chain of passes over its coordinates and warp reductions; at the
// headline's inputs 32 warps per SM keep each SM's issue slots and shared
// memory busy (a batch of one wave runs ~1.5x as long as one of a quarter
// wave), so the time is the instructions the chain issues.  The design cuts
// them where the two-loop recursion spent two thirds of the cycles:
//  * the direction is the compact form of H g (Byrd, Nocedal and Schnabel
//    1994): H g = gamma g + S p - gamma Y u with u = R^{-1} S^T g and p =
//    R^{-T} ((D + gamma Y^T Y) u - gamma Y^T g), R the upper triangle of
//    S^T Y in the pairs' chronological order and D its diagonal.  The m x m
//    algebra runs on lanes (lane q holds chronological row q; the two
//    triangular solves are column sweeps of one shuffle each), and one pass
//    forms d and g.d.  A slot with no pair (zeroed, VAL 0) takes R_qq = 1:
//    its sums and table entries are exact zeros, so u_q = p_q = 0 and it
//    drops out exactly as it contributes 0 to the two-loop;
//  * the tables S^T Y and Y^T Y are kept by slot: when a pair is written at
//    its slot h it is the newest, so R needs only its column s_k.y_h (and
//    Y^T Y its row and column); the step's pass forms those 2m sums with
//    the next iteration's S^T g and Y^T g (2m more) in one transposed
//    butterfly (warp_sums, 31 shuffles in five levels for up to 8 slots),
//    and max|g| < tol is one vote;
//  * every Armijo trial evaluates the value and the gradient (one functor
//    body, so the accepted trial's value is the one its test read), and the
//    accepted trial's gradient is kept: about one objective pass per
//    iteration where the value-only trials and the accepted point's
//    value-gradient took two.  Only the point after the last rejection is
//    evaluated again;
//  * X/XT and G/GN swap roles after a step instead of being copied.
//
// Design:
//  * one warp per instance; coordinate i belongs to lane i % 32, so a lane
//    only ever writes its own coordinates of the per-instance vectors and
//    needs a __syncwarp() only around the objective functors (which read
//    other lanes' coordinates) and the small tables;
//  * dynamic shared memory per warp: X, G, the direction D, the trial / new
//    point XT, the new gradient GN, the S and Y rings (m x n each), the
//    tables SY (s_k . y_h at [k][h]) and YY (m x m each), S^T g, Y^T g, u,
//    p and VAL by slot: (2m + 5) n + 2 m^2 + 5 m elements; nothing but x0,
//    the objective data and the results touches device memory;
//  * the ring slot is the instance's own iteration count mod m (the oldest
//    pair's, chronological row q at slot (head + q) mod m).  The TPU
//    kernel's head is a tile-wide counter; the two agree because an
//    instance is active from its first iteration until it stops and is
//    never active again (x and g freeze once it stops);
//  * reductions are __shfl_xor_sync butterflies, so every lane holds the
//    same sums and the scalar state (f, gamma, t) is replicated in
//    registers; every branch on it is warp-uniform;
//  * max/min propagate NaN as jnp.max does, and the curvature literal is
//    the JAX kernel's (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#include "common.cuh"
#include "objectives.cuh"

// Phase counters, compiled in only with -DK7_PROFILE (tools/k7_phase_profile.py
// builds such a copy; the kernel as shipped has none).  Lane 0 of each warp
// adds the clock64 cycles of every iteration's phases to k7_prof[0..4] (the
// phases in that tool's PHASES order); [5] counts instance-iterations, [6]
// Armijo trials, [7] instances, [8] the cycles of whole instances (set-up
// and epilogue included).
#ifdef K7_PROFILE
__device__ unsigned long long k7_prof[16];
#define K7_PROF(...) __VA_ARGS__
#else
#define K7_PROF(...)
#endif
#define K7_PHASE(k) \
  K7_PROF(if (lane == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; prof_t = t_; })

namespace {

constexpr int kMaxWarpsPerBlock = 8;

constexpr int kStepSlots = 8;   // ring slots per butterfly of the step's pass
constexpr int kUnroll = 4;      // coordinates a lane of the direction's pass holds

// registers for the blocks of kMaxWarpsPerBlock warps per SM that
// __launch_bounds__ must allow in float32: 4 blocks (32 warps, 64
// registers a thread) hold every warp the shared memory allows at the
// headline's n 100, m 5, without spills; on an H100 the headline's inputs
// took 11.99 ms there, 12.91 at 3 blocks and 15.41 at 2
// (tools/k7_phase_profile.py --residency builds 2, 3 and 4 with
// -DK7_MIN_BLOCKS and times them in turns)
#ifndef K7_MIN_BLOCKS
#define K7_MIN_BLOCKS 4
#endif
// float64 doubles the shared memory a warp takes, so 2 blocks fill an SM
// there whatever the registers, and a cap of 64 would only spill
template <typename T> constexpr int min_blocks() {
  return sizeof(T) == 4 ? K7_MIN_BLOCKS : 2;
}

__host__ __device__ inline long long work_elems(int n, int m) {
  return (long long)(2 * m + 5) * n + 2LL * m * m + 5LL * m;
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
  int* nfev_out;        // Armijo trials per instance
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock, min_blocks<T>())
lbfgs_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, m = prm.m;
  K7_PROF(long long prof_acc[9] = {0}; const long long prof_t0 = clock64();
          long long prof_t = prof_t0;)

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems(n, m);
  T* X = p; p += n;
  T* G = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* GN = p; p += n;
  T* S = p; p += (long long)m * n;
  T* Y = p; p += (long long)m * n;
  T* SY = p; p += m * m;
  T* YY = p; p += m * m;
  T* SG = p; p += m;      // S^T g by slot
  T* YG = p; p += m;      // Y^T g by slot
  T* U = p; p += m;
  T* P = p; p += m;
  T* VAL = p;

  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1);
  const T* x0 = prm.x0 + (long long)inst * n;
  for (int i = lane; i < n; i += kWarp) X[i] = x0[i];
  for (long long i = lane; i < (long long)m * n; i += kWarp) {
    S[i] = 0;
    Y[i] = 0;
  }
  for (int j = lane; j < m * m; j += kWarp) {
    SY[j] = 0;
    YY[j] = 0;
  }
  for (int j = lane; j < m; j += kWarp) {
    SG[j] = 0;
    YG[j] = 0;
    VAL[j] = 0;
  }
  __syncwarp();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();

  // max|g| < tol as a vote (a NaN entry fails its lane's test)
  T gmax = 0;
  for (int i = lane; i < n; i += kWarp) gmax = jmax(gmax, (T)fabs(G[i]));
  bool conv = __all_sync(kFull, gmax < prm.tol);
  T gamma = 1;
  int iters = 0;
  int nfev = 0;
  bool active = isfinite(Fv) && !conv;
  K7_PROF(prof_t = clock64();)
  while (active && iters < prm.max_iter) {
    const int head = iters % m;

    // ---- the direction by the compact form: lane q < m holds the pair of
    // chronological row q (slot sq); R_qq = s_q.y_q, 1 on a slot with no pair
    const int q = lane;
    const bool row = q < m;
    int sq = head + q;
    if (sq >= m) sq -= m;
    const T dq = row && VAL[sq] != T(0) ? SY[sq * m + sq] : T(1);
    const T rinv = T(1) / dq;
    T u = row ? SG[sq] : T(0);
    for (int c = m - 1, sc = (head + m - 1) % m; c >= 0;
         --c, sc = sc == 0 ? m - 1 : sc - 1) {        // u = R^-1 S^T g
      const T uc = __shfl_sync(kFull, u * rinv, c);
      if (q == c) u = uc;
      else if (q < c) u = u - SY[sq * m + sc] * uc;
    }
    T yu = 0;
    for (int r = 0, sr = head; r < m; ++r, sr = sr + 1 == m ? 0 : sr + 1) {
      const T ur = __shfl_sync(kFull, u, r);
      if (row) yu += YY[sq * m + sr] * ur;
    }
    T pq = row ? dq * u + gamma * (yu - YG[sq]) : T(0);
    for (int c = 0, sc = head; c < m; ++c, sc = sc + 1 == m ? 0 : sc + 1) {
      const T pc = __shfl_sync(kFull, pq * rinv, c);   // p = R^-T (...)
      if (q == c) pq = pc;
      else if (row && q > c) pq = pq - SY[sc * m + sq] * pc;
    }
    if (row) {
      U[sq] = u;
      P[sq] = pq;
    }
    __syncwarp();
    T g0d = 0;
    for (int i0 = lane; i0 < n; i0 += kWarp * kUnroll) {
      T yu_i[kUnroll], sp_i[kUnroll];
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) yu_i[e] = sp_i[e] = 0;
      for (int k = 0; k < m; ++k) {
        const T uk = U[k], pk = P[k];
        const T* Yk = Y + (long long)k * n;
        const T* Sk = S + (long long)k * n;
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          const int i = i0 + e * kWarp;
          if (i < n) {
            yu_i[e] += Yk[i] * uk;
            sp_i[e] += Sk[i] * pk;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kUnroll; ++e) {
        const int i = i0 + e * kWarp;
        if (i < n) {
          const T di = -(gamma * (G[i] - yu_i[e]) + sp_i[e]);
          D[i] = di;
          g0d += G[i] * di;
        }
      }
    }
    g0d = warp_sum(g0d);
    K7_PHASE(0);

    // ---- Armijo backtracking; each trial evaluates value and gradient
    T t = 1, fnew = 0;
    bool taken = false;
    for (int k = 0; k < prm.max_iter_ls; ++k) {
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      const T ft = obj.value_grad(XT, GN, n, lane);
      ++nfev;
      __syncwarp();
      if (ft <= Fv + prm.c1 * t * g0d && isfinite(ft)) {
        fnew = ft;
        taken = true;
        break;
      }
      t = t * T(0.5);
    }
    K7_PHASE(1);
    if (!taken) {     // the step after the last rejection
      for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
      __syncwarp();
      fnew = obj.value_grad(XT, GN, n, lane);
      __syncwarp();
    }
    K7_PHASE(2);

    // ---- the step's pass: the new pair s = XT - X, y = GN - G at slot
    // head, and per slot k the sums s_k.y, y_k.y (the tables' column head),
    // s_k.g', y_k.g' (the next direction's S^T g, Y^T g), kStepSlots slots
    // per butterfly; max|g'| per lane
    T* Sh = S + (long long)head * n;
    T* Yh = Y + (long long)head * n;
    gmax = 0;
    for (int c0 = 0; c0 < m; c0 += kStepSlots) {
      T acc[4 * kStepSlots];
#pragma unroll
      for (int e = 0; e < 4 * kStepSlots; ++e) acc[e] = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T gn = GN[i];
        const T yi = gn - G[i];
        if (c0 == 0) {
          Sh[i] = XT[i] - X[i];
          Yh[i] = yi;
          gmax = jmax(gmax, (T)fabs(gn));
        }
#pragma unroll
        for (int k = 0; k < kStepSlots; ++k) {
          if (c0 + k < m) {
            const T sk = S[(long long)(c0 + k) * n + i];
            const T yk = Y[(long long)(c0 + k) * n + i];
            acc[4 * k] += sk * yi;
            acc[4 * k + 1] += yk * yi;
            acc[4 * k + 2] += sk * gn;
            acc[4 * k + 3] += yk * gn;
          }
        }
      }
      const T r = warp_sums<4 * kStepSlots>(acc, lane);
      const int slot = c0 + lane / 4;
      if (slot < m) {
        const int kind = lane & 3;
        if (kind == 0) {
          SY[slot * m + head] = r;
        } else if (kind == 1) {
          YY[slot * m + head] = r;
          YY[head * m + slot] = r;
        } else if (kind == 2) {
          SG[slot] = r;
        } else {
          YG[slot] = r;
        }
      }
    }
    __syncwarp();
    const T sy = SY[head * m + head], yy = YY[head * m + head];
    const bool accept = sy > prm.eps * yy;
    if (!accept) {      // a zeroed slot: its sums and table entries are 0
      __syncwarp();
      for (int i = lane; i < n; i += kWarp) {
        Sh[i] = 0;
        Yh[i] = 0;
      }
      if (lane < m) {
        SY[lane * m + head] = 0;
        YY[lane * m + head] = 0;
        YY[head * m + lane] = 0;
      }
      if (lane == 0) {
        SG[head] = 0;
        YG[head] = 0;
      }
    }
    if (lane == 0) VAL[head] = accept ? T(1) : T(0);
    if (accept) gamma = sy / yy;
    T* w = X;
    X = XT;
    XT = w;
    w = G;
    G = GN;
    GN = w;
    Fv = fnew;
    ++iters;
    __syncwarp();
    K7_PHASE(3);
    conv = __all_sync(kFull, gmax < prm.tol);
    active = isfinite(Fv) && !conv;
    K7_PHASE(4);
  }

  const bool finite = isfinite(Fv);
  const int status = (conv && finite) ? 1 : (!finite ? 3 : 2);
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.nfev_out[inst] = nfev;
  }
  K7_PROF(if (lane == 0) {
    prof_acc[5] = iters;
    prof_acc[6] = nfev;
    prof_acc[7] = 1;
    prof_acc[8] = clock64() - prof_t0;
    for (int k = 0; k < 9; ++k) atomicAdd(&k7_prof[k], (unsigned long long)prof_acc[k]);
  })
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

// out: warps per block, resident blocks per SM, registers per thread, local
// (spill) bytes per thread, dynamic shared memory per block
template <typename T, class Obj>
int kernel_info(int B, int n, int m, int* out) {
  const long long per_warp = work_elems(n, m) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > B) wpb = B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = lbfgs_fused_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        (int)wpb * kWarp, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)wpb;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  return 0;
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

#ifdef K7_PROFILE
extern "C" int k7_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k7_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k7_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k7_prof, z, sizeof(z));
}
#endif

extern "C" long long lbfgs_fused_smem_per_warp(int n, int m, int elem_size) {
  return work_elems(n, m) * (long long)elem_size;
}

// the launch for one call's shape and the compiled kernel's resources (see
// kernel_info); the Rosenbrock functor's kernel
extern "C" int lbfgs_fused_kernel_info(int dtype, int B, int n, int m, int* out) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM) return kErrArgs;
  if (dtype == 0) return kernel_info<float, Rosenbrock<float>>(B, n, m, out);
  if (dtype == 1) return kernel_info<double, Rosenbrock<double>>(B, n, m, out);
  return kErrArgs;
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
