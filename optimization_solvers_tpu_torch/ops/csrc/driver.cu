// Generic whole-solve driver K3 on Hopper (sm_90a), first-order form, one
// warp per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_driver.py
// (fused_minimize, kernel body _make_kernel, pl.pallas_call at :1874) for
// its first-order method specs (GD, CD, Pnorm, PGD, SPG, NCG) and its
// Armijo-family search specs (NoSearch, BackTracking, BackTrackingB, GLL).
// The plain PyTorch version of the same algorithm is fused_minimize_plain
// in ../fused_driver.py; the two are held against each other on the card.
//
// What bounds it on this card: latency, not bytes or FLOPs.  Per iteration
// an instance does a few elementwise passes over its n coordinates, each
// ending in a warp reduction (five shuffles), plus one value evaluation per
// line-search trial and one value-and-gradient at the accepted point; at
// config 3 (n = 64) that is two coordinates per lane, so the chain of
// reductions and shared-memory round trips is the whole cost.  Device
// memory is touched only to read x0, the bounds, the objective data and
// P^{-1}, and to write the result; enough warps per SM hide one another's
// latency.
//
// Design:
//  * one warp per instance, coordinate i on lane i % 32.  K3's lanes are
//    independent (every state write of the TPU kernel is masked by its own
//    lane's active/done flag, and a lane that stops never restarts), so a
//    warp that leaves when its instance is done computes what the TPU
//    kernel computes at any tile;
//  * dynamic shared memory per warp: X, G, the new gradient GN, the
//    direction D, the trial point XT, NCG's previous gradient and direction
//    GP / DP, and GLL's f history ring: 7 n + m elements;
//  * the method and the search are runtime, grid-uniform switches on integer
//    codes; the template axes are dtype x objective (4 instantiations);
//  * scalars (f, t, lambda, beta, ...) are replicated in registers after
//    __shfl_xor_sync butterflies, so every branch is warp-uniform;
//  * P^{-1} of PnormDescent stays in device memory, shared by all warps and
//    served from L2; the matvec P^{-1} g is computed here, each lane its own
//    rows.  As in the TPU kernel (preferred_element_type=float32), the
//    product is rounded to float32 before it becomes the float64 direction;
//  * GLL's history is a ring with a write position instead of the TPU
//    kernel's shift: only its max is read, and a max does not depend on
//    the order;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do, and
//    sign(NaN) is NaN as jnp.sign's is.

#include "common.cuh"
#include "objectives.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;

enum MethodCode { kGD = 0, kCD = 1, kPnorm = 2, kPGD = 3, kSPG = 4, kNCG = 5 };
enum SearchCode { kNoSearch = 0, kBT = 1, kBTB = 2, kGLL = 3 };
enum NcgVariant { kFR = 0, kPRPlus = 1, kHS = 2, kDY = 3 };

__host__ __device__ inline long long work_elems(int n, int ring) {
  return 7LL * n + ring;
}

template <typename T> __device__ __forceinline__ T jsign(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : v);   // 0, -0 and NaN pass
}

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  int bstride;          // 0: bounds shared by all instances; n: per instance
  const T* d0;
  const T* d1;
  const T* pinv;        // (n, n), PnormDescent only
  int B, n;
  int method, search;
  T tol, lam_min, lam_max;
  int alternate, ncg_variant, restart_every;
  T c1, beta, sigma1, sigma2;
  int ring;             // GLL history length (0 for the other searches)
  int max_iter, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;
};

template <typename T, class Obj>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
driver_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n;
  const int method = prm.method, search = prm.search;
  const bool bounded = method == kPGD || method == kSPG;
  const T INF = (T)INFINITY;

  T* p = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems(n, prm.ring);
  T* X = p; p += n;
  T* G = p; p += n;
  T* GN = p; p += n;
  T* D = p; p += n;
  T* XT = p; p += n;
  T* GP = p; p += n;
  T* DP = p; p += n;
  T* H = p;

  const T* lo = bounded ? prm.lo + (long long)inst * prm.bstride : nullptr;
  const T* up = bounded ? prm.up + (long long)inst * prm.bstride : nullptr;
  const T* x0 = prm.x0 + (long long)inst * n;
  const Obj obj{prm.d0, prm.d1};

  for (int i = lane; i < n; i += kWarp)
    X[i] = bounded ? jclip(x0[i], lo[i], up[i]) : x0[i];
  __syncwarp();
  T Fv = obj.value_grad(X, G, n, lane);
  __syncwarp();
  int iters = 0, nfev = 0;

  // ---- method and search state
  T lam = 0, par = 0;
  int ks = 0;
  if (method == kSPG) {
    T mx = 0;
    for (int i = lane; i < n; i += kWarp)
      mx = jmax(mx, (T)fabs(jclip(X[i] - G[i], lo[i], up[i]) - X[i]));
    lam = jclip(T(1) / warp_max(mx), prm.lam_min, prm.lam_max);
  }
  if (method == kNCG)
    for (int i = lane; i < n; i += kWarp) {
      GP[i] = G[i];
      DP[i] = -G[i];
    }
  int pos = 0;
  if (search == kGLL)
    for (int e = lane; e < prm.ring; e += kWarp) H[e] = -INF;
  __syncwarp();

  // ||g||_inf, or for the bounded methods the infinity norm of g with the
  // components that push against an active bound masked out
  auto converged = [&]() -> bool {
    T mx = 0;
    for (int i = lane; i < n; i += kWarp) {
      T gi = G[i];
      if (bounded && ((X[i] == lo[i] && gi > T(0)) || (X[i] == up[i] && gi < T(0))))
        gi = 0;
      mx = jmax(mx, (T)fabs(gi));
    }
    return warp_max(mx) < prm.tol;
  };

  bool active = isfinite(Fv) && !converged();
  for (int it = 0; it < prm.max_iter && active; ++it) {
    // ---- direction D
    switch (method) {
      case kCD: {
        // Gauss-Southwell: -sign(g_i) e_i at the first largest |g_i|; a NaN
        // max matches no coordinate
        T amax = 0;
        for (int i = lane; i < n; i += kWarp) amax = jmax(amax, (T)fabs(G[i]));
        amax = warp_max(amax);
        int idx = n;
        for (int i = lane; i < n; i += kWarp)
          if ((T)fabs(G[i]) == amax) { idx = i; break; }
        idx = warp_min(idx);
        for (int i = lane; i < n; i += kWarp)
          D[i] = -jsign(G[i]) * (i == idx ? T(1) : T(0));
        break;
      }
      case kPnorm:
        for (int i = lane; i < n; i += kWarp) {
          const T* row = prm.pinv + (long long)i * n;
          T acc = 0;
          for (int j = 0; j < n; ++j) acc += row[j] * G[j];
          D[i] = -(T)(float)acc;
        }
        break;
      case kPGD:
        for (int i = lane; i < n; i += kWarp)
          D[i] = jclip(X[i] - G[i], lo[i], up[i]) - X[i];
        break;
      case kSPG:
        for (int i = lane; i < n; i += kWarp)
          D[i] = jclip(X[i] - lam * G[i], lo[i], up[i]) - X[i];
        break;
      case kNCG: {
        T gg = 0, gy = 0, gpgp = 0, dpy = 0;
        for (int i = lane; i < n; i += kWarp) {
          const T g = G[i], gp = GP[i], y = g - gp;
          gg += g * g;
          gy += g * y;
          gpgp += gp * gp;
          dpy += DP[i] * y;
        }
        gg = warp_sum(gg);
        gy = warp_sum(gy);
        gpgp = warp_sum(gpgp);
        dpy = warp_sum(dpy);
        T beta;
        switch (prm.ncg_variant) {
          case kFR: beta = gg / gpgp; break;
          case kPRPlus: beta = jmax(gy / gpgp, T(0)); break;
          case kHS: beta = gy / dpy; break;
          default: beta = gg / dpy; break;
        }
        if (!isfinite(beta)) beta = 0;
        const int period = prm.restart_every > 0 ? prm.restart_every : n;
        const bool periodic = ks >= period;
        const T bc = periodic ? T(0) : beta;
        T gd = 0;
        for (int i = lane; i < n; i += kWarp) {
          const T d = -G[i] + bc * DP[i];
          D[i] = d;
          gd += G[i] * d;
        }
        const bool descent = warp_sum(gd) < T(0);
        if (!descent)
          for (int i = lane; i < n; i += kWarp) D[i] = -G[i];
        if (periodic || !descent) ks = 0;
        break;
      }
      default:   // kGD
        for (int i = lane; i < n; i += kWarp) D[i] = -G[i];
        break;
    }
    __syncwarp();

    // ---- step length: the trial loop runs until a trial is accepted or
    // the budget is spent; on exhaustion t is the last update, untested
    T t = 1;
    if (search != kNoSearch) {
      T g0d = 0;
      for (int i = lane; i < n; i += kWarp) g0d += G[i] * D[i];
      g0d = warp_sum(g0d);
      T f_ref = Fv;
      if (search == kGLL) {
        if (lane == 0) H[pos] = Fv;
        pos = (pos + 1) % prm.ring;
        __syncwarp();
        T fm = -INF;
        for (int e = lane; e < prm.ring; e += kWarp) fm = jmax(fm, H[e]);
        f_ref = warp_max(fm);
      }
      for (int k = 0; k < prm.max_iter_ls; ++k) {
        for (int i = lane; i < n; i += kWarp) {
          const T xt = X[i] + t * D[i];
          XT[i] = search == kBTB ? jclip(xt, lo[i], up[i]) : xt;
        }
        __syncwarp();
        const T ft = obj.value(XT, n, lane);
        ++nfev;
        bool ok;
        if (search == kBTB) {
          T dd = 0;
          for (int i = lane; i < n; i += kWarp) {
            const T df = XT[i] - X[i];
            dd += df * df;
          }
          ok = ft - Fv <= (-prm.c1 / t) * warp_sum(dd);
        } else {
          ok = ft - f_ref <= prm.c1 * t * g0d;
        }
        __syncwarp();
        if (ok && isfinite(ft)) break;
        if (search == kGLL) {
          // safeguarded quadratic interpolation in the absolute window
          // (sigma1, sigma2 t), halving otherwise and at t <= 0.1
          const T t_half = t * T(0.5);
          const T t_tmp = T(-0.5) * t * t * g0d / (ft - Fv - t * g0d);
          const T t_quad = (t_tmp > prm.sigma1 && t_tmp < prm.sigma2 * t) ? t_tmp
                                                                         : t_tmp * T(0.5);
          const T t_next = t <= T(0.1) ? t_half : t_quad;
          t = (isfinite(t_next) && t_next > T(0)) ? t_next : t_half;
        } else {
          t = t * prm.beta;
        }
      }
    }

    // ---- step (re-clipped for the bounded methods) and state update
    for (int i = lane; i < n; i += kWarp) {
      const T xn = X[i] + t * D[i];
      XT[i] = bounded ? jclip(xn, lo[i], up[i]) : xn;
    }
    __syncwarp();
    const T fnew = obj.value_grad(XT, GN, n, lane);
    __syncwarp();
    if (method == kSPG) {
      T sy = 0, ss = 0, yy = 0;
      for (int i = lane; i < n; i += kWarp) {
        const T s = XT[i] - X[i], y = GN[i] - G[i];
        sy += s * y;
        ss += s * s;
        yy += y * y;
      }
      sy = warp_sum(sy);
      ss = warp_sum(ss);
      yy = warp_sum(yy);
      T raw = ss / sy;
      if (prm.alternate) {
        if (par > T(0.5)) raw = sy / yy;
        par = T(1) - par;
      }
      lam = sy <= T(0) ? prm.lam_max : jclip(raw, prm.lam_min, prm.lam_max);
    }
    for (int i = lane; i < n; i += kWarp) {
      if (method == kNCG) {
        GP[i] = G[i];
        DP[i] = D[i];
      }
      X[i] = XT[i];
      G[i] = GN[i];
    }
    ks += 1;
    Fv = fnew;
    ++iters;
    __syncwarp();
    active = isfinite(Fv) && !converged();
  }

  // status precedence of the TPU kernel: converged and finite, then the
  // budget, then out of domain
  const bool finite = isfinite(Fv);
  const int status = (converged() && finite) ? 1 : (iters >= prm.max_iter ? 2 : (!finite ? 3 : 2));
  for (int i = lane; i < n; i += kWarp) prm.x_out[(long long)inst * n + i] = X[i];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.nfev_out[inst] = nfev;
  }
}

template <typename T, class Obj>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long per_warp = work_elems(prm.n, prm.ring) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > prm.B) wpb = prm.B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = driver_kernel<T, Obj>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((prm.B + wpb - 1) / wpb);
  kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        int bstride, const void* d0, const void* d1, const void* pinv, int B,
        int n, int method, int search, double tol, double lam_min,
        double lam_max, int alternate, int ncg_variant, int restart_every,
        double c1, double beta, double sigma1, double sigma2, int ring,
        int max_iter, int max_iter_ls, void* x, void* f, void* it, void* st,
        void* nfev, void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.bstride = bstride;
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.pinv = static_cast<const T*>(pinv);
  prm.B = B;
  prm.n = n;
  prm.method = method;
  prm.search = search;
  prm.tol = (T)tol;
  prm.lam_min = (T)lam_min;
  prm.lam_max = (T)lam_max;
  prm.alternate = alternate;
  prm.ncg_variant = ncg_variant;
  prm.restart_every = restart_every;
  prm.c1 = (T)c1;
  prm.beta = (T)beta;
  prm.sigma1 = (T)sigma1;
  prm.sigma2 = (T)sigma2;
  prm.ring = ring;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.nfev_out = static_cast<int*>(nfev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>>(prm, s);
  if (objective == kWeightedSquares) {
    if (d0 == nullptr || d1 == nullptr) return kErrArgs;
    return launch<T, WeightedSquares<T>>(prm, s);
  }
  return kErrArgs;
}

}  // namespace

extern "C" long long driver_smem_per_warp(int n, int ring, int elem_size) {
  return work_elems(n, ring) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int driver_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    int bstride, const void* d0, const void* d1, const void* pinv, int B,
    int n, int method, int search, double tol, double lam_min,
    double lam_max, int alternate, int ncg_variant, int restart_every,
    double c1, double beta, double sigma1, double sigma2, int ring,
    int max_iter, int max_iter_ls, void* x, void* f, void* it, void* st,
    void* nfev, void* stream) {
  const bool bounded = method == kPGD || method == kSPG;
  if (B < 1 || n < 1 || method < kGD || method > kNCG || search < kNoSearch ||
      search > kGLL || (bstride != 0 && bstride != n) ||
      (bounded && (lo == nullptr || up == nullptr)) ||
      (search == kBTB && !bounded) || (search == kGLL) != (ring > 0) ||
      (method == kPnorm && pinv == nullptr))
    return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, bstride, d0, d1, pinv, B, n,
                      method, search, tol, lam_min, lam_max, alternate,
                      ncg_variant, restart_every, c1, beta, sigma1, sigma2,
                      ring, max_iter, max_iter_ls, x, f, it, st, nfev, stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, bstride, d0, d1, pinv, B, n,
                       method, search, tol, lam_min, lam_max, alternate,
                       ncg_variant, restart_every, c1, beta, sigma1, sigma2,
                       ring, max_iter, max_iter_ls, x, f, it, st, nfev,
                       stream);
  return kErrArgs;
}
