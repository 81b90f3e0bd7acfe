// K3's first-order form on Hopper (sm_90a): the first-order methods GD, CD,
// Pnorm, PGD, SPG and NCG with the Armijo-family searches NoSearch,
// BackTracking, BackTrackingB and GLL, one warp per instance, built in
// driver.cu.  It replaces those specs of the TPU kernel
// optimization_solvers_tpu/ops/pallas_driver.py (_GDSpec :165, _CDSpec
// :192, _PnormSpec :207, _PGDSpec :228, _SPGSpec :241, _NCGSpec :290,
// _NoSearchSpec :1007, _BTSpec :1020, _GLLSpec :1069, kernel body
// _make_kernel :1698); the rest of K3 is driver.cuh's.  The plain version
// is fused_minimize_plain in ../fused_driver.py; every step, step length,
// trial count (nfev), iteration count and status is its.
//
// What bounds it: each instance's chain of passes and warp reductions, and
// the SM's issue rate, not bytes or FLOPs.  Before this design (every
// vector in the warp's shared memory, a reduction behind a shared-memory
// round trip for g.d, each serial trial, the step's value, the GLL max,
// each BB sum and the convergence max, and a second value-and-gradient at
// the point the last trial had just accepted) an H100 spent 24,097 cycles
// per instance-iteration at config 6, 0.714 of them in GD +
// BackTracking's 6.6 serial trials, and 7,012 at config 3; this design
// spends 5,269 and 4,025 (tools/k3_phase_profile.py --first-order).  The
// design:
//  * Layout (lanes.cuh): lane l holds two coordinates, 2l and 2l + 1, up to
//    n = 64 (four, 4l .. 4l + 3, would leave half the lanes idle and double
//    the registers: config 3 took 2.758 ms with four against 1.804 with
//    two on an H100), and four up to n = 128, of X, G, the trial or new
//    gradient GN, D, the new point XT, NCG's GP and DP, the box (shared,
//    or per instance where bstride is n) and the objective's data, in
//    registers; a Rosenbrock neighbour comes by shuffle.  Wider instances
//    keep every vector in the warp's shared memory, coordinate i on lane
//    i % 32 (7 n + ring elements, the fit as before).  Pnorm's P^-1 g
//    reads all of g on every lane: the register layouts stage g in n
//    elements of the warp's shared memory (after the GLL ring) for the
//    product, the shared layout reads its G.  CD's argmax needs no
//    staging: the first largest |g_i| is a warp max, then a warp min of
//    each lane's first index at it.
//  * The method and the search are runtime switches, so a kernel holds
//    the registers of every method it compiles: the register layouts'
//    kernels are split by method class (FoClass), so that GD's carries no
//    box and no NCG pair.
//  * BackTracking's and BackTrackingB's schedule (t = 1, beta, beta^2, ...
//    by repeated multiplication, so the serial bits) is known before any
//    value: lanes.cuh's joint_trials evaluates kJoint (BackTrackingB:
//    kJointB, with its |x_t - x|^2 sums) trials in one pass and one
//    butterfly and takes the first in order that passes with a finite
//    value; nfev and the exhaustion rule stay the serial search's.  At
//    config 6 every iteration took 6 or 7 trials (0.41 / 0.59), so 8 a
//    pass is one pass.  GLL's quadratic interpolation needs the last value
//    for the next t: its trials stay serial, each evaluating value and
//    gradient.
//  * The accepted trial is the step where t was tested and accepted and
//    the bounded methods' re-clip moves no coordinate (one vote;
//    BackTrackingB's trials are clipped already): its value is the step's,
//    and its gradient is the serial trial's or, after joint trials, one
//    elementwise pass at its point without a reduction.  After
//    exhaustion (t untested) and for NoSearch the step is evaluated.
//  * g.d and the GLL ring's max in one butterfly (lanes.cuh sum_max); SPG's
//    s.y, s.s and y.y in one (warp_sums); NCG's four sums in one; the
//    convergence test max|g| < tol (masked at active bounds) a vote.  The
//    GLL ring lies in the warp's shared memory, entry e owned by lane e %
//    32, so its write and its reads need no barrier.
//  * X/XT and G/GN (NCG: G/GP/GN and D/DP) swap instead of copying.
// Reductions change order against the shared-memory layout's (a lane sums
// its contiguous coordinates); the float64 per-instance checks hold that.
// min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do.

#pragma once

#include "driver.cuh"
#include "lanes.cuh"

// the widest instance held in registers (64 or 128; 0 puts every instance
// in shared memory, as the tests build it to run that layout at small
// widths)
#ifndef K3_REG_N
#define K3_REG_N 128
#endif

namespace ost_driver {

// the register layouts: two coordinates a lane up to n = 64, four up to
// K3_REG_N
constexpr int kFoRegN = K3_REG_N;
static_assert(kFoRegN == 0 || kFoRegN == 2 * kWarp || kFoRegN == 4 * kWarp, "K3_REG_N");
using FoRegs2 = LanesInRegs<2>;
using FoRegs4 = LanesInRegs<4>;

// the methods a kernel of the register layouts compiles, so that it holds
// only their vectors: GD, CD and Pnorm (x, g, d); PGD and SPG (and the
// box); NCG (and the previous gradient and direction).  The shared layout
// compiles them all in one kernel (kFoAll).  (A further split by search,
// the joint trials apart from NoSearch and GLL, took config 3 from 1.804
// to 1.786 ms on an H100 and made this source's build several times
// longer.)
enum FoClass { kFoPlain = 0, kFoBox = 1, kFoNcg = 2, kFoAll = 3 };

__host__ __device__ inline int first_order_class(int method) {
  return method == kPGD || method == kSPG ? kFoBox : (method == kNCG ? kFoNcg : kFoPlain);
}

// BackTracking's trials a pass: kJoint, the box class's kJointBox (its
// registers hold the box too); BackTrackingB's kJointB (8 sums a pass).
// At config 6 every iteration took 6 or 7 trials: on an H100 8 a pass took
// 2.051 ms there against 2.140 for 4 (tools/k3_phase_profile.py
// --first-order); 8 in the box class's kernel spilled (64 registers, 48
// bytes) and config 3 took 1.804 ms against 1.750 with 4
constexpr int kJoint = 8, kJointBox = 4, kJointB = 4;
template <int kClass> __host__ __device__ constexpr int joint_trials_of() {
  return kClass == kFoBox || kClass == kFoAll ? kJointBox : kJoint;
}

// a warp's shared memory in the first-order form: the shared layout's
// seven vectors, the GLL ring, and the register layout's stage of g for
// Pnorm
template <class L>
__host__ __device__ inline long long first_order_elems(int n, int ring, int method) {
  return (L::kRegs ? 0LL : 7LL * n) + ring + (L::kRegs && method == kPnorm ? n : 0);
}

// blocks of kMaxWarpsPerBlock warps per SM that __launch_bounds__ asks the
// registers of the register layouts to allow: 4 in float32 (64
// registers: config 6's 4,096 instances in one wave of 32 warps per SM;
// with 5, 48 registers spilled and config 6 took 2.704 ms against 2.103
// in turns on an H100, tools/k3_phase_profile.py --first-order), 2 in
// float64
template <typename T, class L> constexpr int first_order_min_blocks() {
  return L::kRegs ? (sizeof(T) == 4 ? 4 : 2) : 1;
}

template <typename T, class Obj, class L, int kClass>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock, (first_order_min_blocks<T, L>()))
first_order_kernel(const Params<T> prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V = typename L::template Vec<T>;
  using E = LaneObj<T, Obj>;
  constexpr bool kPlain = kClass == kFoPlain || kClass == kFoAll;
  constexpr bool kBox = kClass == kFoBox || kClass == kFoAll;
  constexpr bool kNcgs = kClass == kFoNcg || kClass == kFoAll;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, method = prm.method, search = prm.search, ring = prm.ring;
  const bool bounded = kBox && bounded_method(method);
  const bool ncg = kNcgs && method == kNCG;
  const T INF = (T)INFINITY;

  T* work = reinterpret_cast<T*>(smem_raw) +
            (long long)warp * first_order_elems<L>(n, ring, method);
  V X = L::template alloc<T>(work, n, lane);
  V G = L::template alloc<T>(work, n, lane);
  V GN = L::template alloc<T>(work, n, lane);
  V D = L::template alloc<T>(work, n, lane);
  V XT = L::template alloc<T>(work, n, lane);
  V GP = L::template alloc<T>(work, n, lane);
  V DP = L::template alloc<T>(work, n, lane);
  T* H = work;                        // the GLL ring, entry e on lane e % 32
  T* stage = H + ring;                // Pnorm's g (the register layout)
  const T* x0 = prm.x0 + (long long)inst * n;
  // the box (an unbounded method's kernel holds none; one of the shared
  // layout reads x0 in its place, and never uses it)
  using BV = decltype(L::load(x0, n, lane));
  const BV LO = kBox ? L::load(bounded ? prm.lo + (long long)inst * prm.bstride : x0, n, lane)
                     : BV{};
  const BV UP = kBox ? L::load(bounded ? prm.up + (long long)inst * prm.bstride : x0, n, lane)
                     : BV{};
  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1);
  const typename E::template Data<L> dat(obj, n, lane);

  LANES_FOR(L, e, i) X[e] = bounded ? jclip(x0[i], LO[e], UP[e]) : x0[i];
  L::sync();
  T Fv = value_grad<L, E>(dat, X, G, n, lane);
  L::sync();
  int iters = 0, nfev = 0;

  T lam = 0, par = 0;
  int ks = 0, pos = 0;
  if (kBox && method == kSPG) {
    T mx = 0;
    LANES_FOR(L, e, i) mx = jmax(mx, (T)fabs(jclip(X[e] - G[e], LO[e], UP[e]) - X[e]));
    lam = jclip(T(1) / warp_max(mx), prm.lam_min, prm.lam_max);
  }
  if (ncg) {
    LANES_FOR(L, e, i) {
      GP[e] = G[e];
      DP[e] = -G[e];
    }
  }
  if (search == kGLL)
    for (int e = lane; e < ring; e += kWarp) H[e] = -INF;
  L::sync();

  // ||g||_inf < tol, for the bounded methods with the components that push
  // against an active bound masked: a vote (a NaN fails it on its lane)
  auto converged = [&]() -> bool {
    T mx = 0;
    LANES_FOR(L, e, i) {
      T gi = G[e];
      if (bounded && ((X[e] == LO[e] && gi > T(0)) || (X[e] == UP[e] && gi < T(0)))) gi = 0;
      mx = jmax(mx, (T)fabs(gi));
    }
    return __all_sync(kFull, mx < prm.tol);
  };

  K3_PROF(long long prof_acc[32] = {0}; long long prof_t = clock64();
          const long long prof_t0 = prof_t; constexpr bool prof_on = true;)
  bool active = isfinite(Fv) && !converged();
  for (int it = 0; it < prm.max_iter && active; ++it) {
    K3_PROF(if (lane == 0) prof_t = clock64();)
    // ---- direction D with the lane's share of g.d
    T gd = 0, gg = 0;
    bool periodic = false;
    switch (kPlain || kBox ? method : kNCG) {
      case kCD: {
        if constexpr (!kPlain) break;
        // Gauss-Southwell: -sign(g_i) e_i at the first largest |g_i|; a NaN
        // max matches no coordinate
        T amax = 0;
        LANES_FOR(L, e, i) amax = jmax(amax, (T)fabs(G[e]));
        amax = warp_max(amax);
        int idx = n;
        LANES_FOR(L, e, i) if (idx == n && (T)fabs(G[e]) == amax) idx = i;
        idx = warp_min(idx);
        LANES_FOR(L, e, i) {
          D[e] = -jsign(G[e]) * (i == idx ? T(1) : T(0));
          gd += G[e] * D[e];
        }
        break;
      }
      case kPnorm: {
        if constexpr (!kPlain) break;
        // rows i of P^-1 against all of g, rounded to float32 as the TPU
        // kernel's float32 product is (preferred_element_type)
        const T* g_all;
        if constexpr (L::kRegs) {
          LANES_FOR(L, e, i) stage[i] = G[e];
          __syncwarp();
          g_all = stage;
        } else {
          g_all = &G[0] - lane;
        }
        LANES_FOR(L, e, i) {
          const T* row = prm.pinv + (long long)i * n;
          T acc = 0;
          for (int j = 0; j < n; ++j) acc += row[j] * g_all[j];
          D[e] = -(T)(float)acc;
          gd += G[e] * D[e];
        }
        __syncwarp();                 // the stage is read before it is rewritten
        break;
      }
      case kPGD:
        if constexpr (!kBox) break;
        LANES_FOR(L, e, i) {
          D[e] = jclip(X[e] - G[e], LO[e], UP[e]) - X[e];
          gd += G[e] * D[e];
        }
        break;
      case kSPG:
        if constexpr (!kBox) break;
        LANES_FOR(L, e, i) {
          D[e] = jclip(X[e] - lam * G[e], LO[e], UP[e]) - X[e];
          gd += G[e] * D[e];
        }
        break;
      case kNCG: {
        if constexpr (!kNcgs) break;
        T v[4] = {0, 0, 0, 0}, s[4];
        LANES_FOR(L, e, i) {
          const T g = G[e], gp = GP[e], y = g - gp;
          v[0] += g * g;
          v[1] += g * y;
          v[2] += gp * gp;
          v[3] += DP[e] * y;
        }
        all_sums<4>(v, s, lane);
        gg = s[0];
        T beta;
        switch (prm.ncg_variant) {
          case kFR: beta = s[0] / s[2]; break;
          case kPRPlus: beta = jmax(s[1] / s[2], T(0)); break;
          case kHS: beta = s[1] / s[3]; break;
          default: beta = s[0] / s[3]; break;
        }
        if (!isfinite(beta)) beta = 0;
        const int period = prm.restart_every > 0 ? prm.restart_every : n;
        periodic = ks >= period;
        const T bc = periodic ? T(0) : beta;
        LANES_FOR(L, e, i) {
          const T d = -G[e] + bc * DP[e];
          D[e] = d;
          gd += G[e] * d;
        }
        break;
      }
      default:                        // kGD
        LANES_FOR(L, e, i) {
          D[e] = -G[e];
          gd += G[e] * D[e];
        }
        break;
    }
    // g.d (the search's and NCG's descent test) and the GLL reference,
    // the ring's max after f is written at pos, in one butterfly
    T g0d = 0, f_ref = Fv;
    if (search == kGLL) {
      T hm = -INF;
      for (int e = lane; e < ring; e += kWarp) {
        const T h = e == pos ? Fv : H[e];
        if (e == pos) H[e] = Fv;
        hm = jmax(hm, h);
      }
      pos = pos + 1 == ring ? 0 : pos + 1;
      sum_max(gd, hm, lane);
      g0d = gd;
      f_ref = hm;
    } else if (search != kNoSearch || method == kNCG) {
      g0d = warp_sum(gd);
    }
    if (ncg) {
      // not a descent direction: steepest descent, whose g.d is -g.g
      // bit for bit (each term and each sum negated)
      const bool descent = g0d < T(0);
      if (!descent) {
        LANES_FOR(L, e, i) D[e] = -G[e];
        g0d = -gg;
      }
      if (periodic || !descent) ks = 0;
    }
    L::sync();
    K3_PHASE(0);

    // ---- step length: `taken` where t was tested and accepted with value
    // fnew (GLL: its point in XT and gradient in GN)
    T t = 1, fnew = 0;
    bool taken = false, gll_point = false;
    K3_PROF(const int nfev_it = nfev;)
    if (search == kGLL) {
      for (int k = 0; k < prm.max_iter_ls; ++k) {
        LANES_FOR(L, e, i) XT[e] = X[e] + t * D[e];
        L::sync();
        const T ft = value_grad<L, E>(dat, XT, GN, n, lane);
        L::sync();
        ++nfev;
        if (ft - f_ref <= prm.c1 * t * g0d && isfinite(ft)) {
          taken = gll_point = true;
          fnew = ft;
          break;
        }
        // safeguarded quadratic interpolation in the absolute window
        // (sigma1, sigma2 t), halving otherwise and at t <= 0.1
        const T t_half = t * T(0.5);
        const T t_tmp = T(-0.5) * t * t * g0d / (ft - Fv - t * g0d);
        const T t_quad = (t_tmp > prm.sigma1 && t_tmp < prm.sigma2 * t) ? t_tmp : t_tmp * T(0.5);
        const T t_next = t <= T(0.1) ? t_half : t_quad;
        t = (isfinite(t_next) && t_next > T(0)) ? t_next : t_half;
      }
    } else if (search == kBT) {
      const T c1 = prm.c1;
      taken = joint_trials<joint_trials_of<kClass>(), false, L, E>(
          dat, X, D, LO, UP, false, prm.beta, prm.max_iter_ls,
          [&](T ft, T tk, T) { return ft - f_ref <= c1 * tk * g0d; }, t, fnew, nfev, n, lane);
    } else if (kBox && search == kBTB) {
      const T c1 = prm.c1, f0 = Fv;
      taken = joint_trials<kJointB, true, L, E>(
          dat, X, D, LO, UP, true, prm.beta, prm.max_iter_ls,
          [&](T ft, T tk, T dd) { return ft - f0 <= (-c1 / tk) * dd; }, t, fnew, nfev, n, lane);
    }
    K3_PHASE(1);
    K3_PROF(if (lane == 0) ++prof_acc[16 + min(nfev - nfev_it, 15)];)

    // ---- the step x + t d, re-clipped for the bounded methods: the
    // accepted trial's point where the clip moves no coordinate (one vote;
    // BackTrackingB's trials are clipped), then its value is the step's
    // and its gradient the serial trial's or one elementwise pass
    bool kept = taken;
    if (!gll_point || bounded) {
      bool moved = false;
      LANES_FOR(L, e, i) {
        const T xn = X[e] + t * D[e];
        const T xc = bounded ? jclip(xn, LO[e], UP[e]) : xn;
        XT[e] = xc;
        moved = moved || xc != xn;
      }
      if (search != kBTB) kept = kept && !__any_sync(kFull, moved);
    }
    L::sync();
    if (kept) {
      if (!gll_point) E::template grad<L>(dat, XT, GN, n, lane);
      K3_PROF(if (lane == 0) ++prof_acc[9];)
    } else {
      fnew = value_grad<L, E>(dat, XT, GN, n, lane);
    }
    L::sync();
    K3_PHASE(2);

    // ---- SPG's Barzilai-Borwein scalar from s = XT - X, y = GN - G
    if (kBox && method == kSPG) {
      T v[4] = {0, 0, 0, 0}, s[4];
      LANES_FOR(L, e, i) {
        const T sv = XT[e] - X[e], y = GN[e] - G[e];
        v[0] += sv * y;
        v[1] += sv * sv;
        v[2] += y * y;
      }
      all_sums<4>(v, s, lane);
      const T sy = s[0];
      T raw = s[1] / sy;
      if (prm.alternate) {
        if (par > T(0.5)) raw = sy / s[2];
        par = T(1) - par;
      }
      lam = sy <= T(0) ? prm.lam_max : jclip(raw, prm.lam_min, prm.lam_max);
    }
    // the new point and gradient by swapping; NCG keeps the old gradient
    // and the direction as GP and DP
    if (ncg) {
      V w = GP;
      GP = G;
      G = GN;
      GN = w;
      w = DP;
      DP = D;
      D = w;
    } else {
      const V w = G;
      G = GN;
      GN = w;
    }
    {
      const V w = X;
      X = XT;
      XT = w;
    }
    ks += 1;
    Fv = fnew;
    ++iters;
    L::sync();
    K3_PHASE(3);
    active = isfinite(Fv) && !converged();
    K3_PHASE(5);
  }

  // status precedence of the TPU kernel: converged and finite, then the
  // budget, then out of domain
  const bool finite = isfinite(Fv);
  const int status = (converged() && finite) ? 1 : (iters >= prm.max_iter ? 2 : (!finite ? 3 : 2));
  LANES_FOR(L, e, i) prm.x_out[(long long)inst * n + i] = X[e];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.nfev_out[inst] = nfev;
  }
  K3_PROF(if (lane == 0) {
    prof_acc[6] = iters;
    prof_acc[7] = nfev;
    prof_acc[8] = 1;
    prof_acc[10] = clock64() - prof_t0;
    for (int k = 0; k < 32; ++k) atomicAdd(&k3_prof[k], (unsigned long long)prof_acc[k]);
  })
}

// the launch of a (B, n) batch: warps per block and dynamic shared memory
// per block (0 warps: an instance does not fit)
template <typename T, class L> void first_order_shape(const Params<T>& prm, int& wpb, int& smem) {
  const long long per_warp =
      first_order_elems<L>(prm.n, prm.ring, prm.method) * (long long)sizeof(T);
  long long w = per_warp > 0 ? kSmemPerBlock / per_warp : kMaxWarpsPerBlock;
  if (w > kMaxWarpsPerBlock) w = kMaxWarpsPerBlock;
  if (w > prm.B) w = prm.B;
  wpb = (int)w;
  smem = (int)(per_warp * w);
}

template <typename T, class Obj, class L, int kClass>
int first_order_launch(const Params<T>& prm, cudaStream_t stream) {
  int wpb, smem;
  first_order_shape<T, L>(prm, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = first_order_kernel<T, Obj, L, kClass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (prm.B + wpb - 1) / wpb;
  kernel<<<grid, wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// a register layout's kernel of the method's class
template <typename T, class Obj, class L>
int launch_class(const Params<T>& prm, cudaStream_t stream) {
  switch (first_order_class(prm.method)) {
    case kFoBox: return first_order_launch<T, Obj, L, kFoBox>(prm, stream);
    case kFoNcg: return first_order_launch<T, Obj, L, kFoNcg>(prm, stream);
    default: return first_order_launch<T, Obj, L, kFoPlain>(prm, stream);
  }
}

// two coordinates a lane up to n = 64, four up to kFoRegN, else the shared
// layout: a route by shape
template <typename T, class Obj> int launch_first(const Params<T>& prm, cudaStream_t stream) {
  if constexpr (kFoRegN > 0)
    if (prm.n <= 2 * kWarp) return launch_class<T, Obj, FoRegs2>(prm, stream);
  if constexpr (kFoRegN > 2 * kWarp)
    if (prm.n <= kFoRegN) return launch_class<T, Obj, FoRegs4>(prm, stream);
  return first_order_launch<T, Obj, InShared, kFoAll>(prm, stream);
}

// out: warps per block, resident blocks per SM, registers per thread, local
// (spill) bytes per thread, dynamic shared memory per block, the layout (1:
// registers, 0: shared memory); the weighted-squares kernel
template <typename T, class L, int kClass> int first_order_info(const Params<T>& prm, int* out) {
  int wpb, smem;
  first_order_shape<T, L>(prm, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = first_order_kernel<T, WeightedSquares<T>, L, kClass>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, wpb * kWarp, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = wpb;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  out[5] = L::kRegs ? (int)(sizeof(typename L::template Vec<T>) / sizeof(T)) : 0;
  return 0;
}

// first_order_info of the kernel launch_first takes for prm's shape and
// method
template <typename T> int first_order_info_for(const Params<T>& prm, int* out) {
  auto by_class = [&](auto layout) {
    using L = decltype(layout);
    switch (first_order_class(prm.method)) {
      case kFoBox: return first_order_info<T, L, kFoBox>(prm, out);
      case kFoNcg: return first_order_info<T, L, kFoNcg>(prm, out);
      default: return first_order_info<T, L, kFoPlain>(prm, out);
    }
  };
  if constexpr (kFoRegN > 0)
    if (prm.n <= 2 * kWarp) return by_class(FoRegs2{});
  if constexpr (kFoRegN > 2 * kWarp)
    if (prm.n <= kFoRegN) return by_class(FoRegs4{});
  return first_order_info<T, InShared, kFoAll>(prm, out);
}

}  // namespace ost_driver
