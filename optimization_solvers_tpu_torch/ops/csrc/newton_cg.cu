// Newton-CG kernel K4 on Hopper (sm_90a): batched box-constrained truncated
// Newton-CG whole solves, one warp per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_newton_cg.py
// (newton_cg_solve_fused, kernel body _make_kernel at :70, pl.pallas_call
// at :340).  The plain PyTorch version of the same algorithm is
// newton_cg_solve_plain in ../fused_newton_cg.py; the two are held against
// each other on the card.
//
// Algorithm (pallas_newton_cg.py:70-267): the outer loop stops on the
// projection-arc residual max_i |x_i - P(x - g)_i| <= pgtol or on the
// relative decrease f_prev - f <= factr eps max(|f|, |f_prev|, 1); each
// iteration takes a two-metric direction (coordinates within min(pg, 1e-2)
// of a bound with the gradient pushing outward take -g, the free ones a
// truncated CG solve of H d = -g on the free subspace: the Steihaug exit on
// p.Hp <= eps p.p with the -g_F fallback before the first step, the
// Eisenstat-Walker forcing ||r||^2 <= (min(sqrt(||g_F||), 0.5) ||g_F||)^2,
// beta = rr_new / max(rr, eps)), a zero direction falls back to -g, then a
// projected backtracking Armijo search halving t from 1, and the step is
// taken where its value and point are finite.  eps is finfo(dtype).eps
// (1.1920929e-7 / 2.220446e-16), not K3's literals.
//
// The TPU kernel's lanes are independent: every state write is masked by
// the lane's own active / CG-done / search-done flag, so one warp that
// leaves its CG loop and its search when its own instance is done computes
// what the TPU kernel computes at any tile.  The Hessian-vector products
// are the objective's analytic hvp (objectives.cuh); the TPU kernel traces
// forward-over-reverse AD instead, which rounds differently.
//
// What bounds it on this card: not bytes or FLOPs but each instance's
// chain of passes, products and warp reductions.  At the Newton-CG
// headline (n = 100, 10,240 instances, ~6.2 CG steps and ~2.3 trials per
// iteration) the time follows the waves of resident warps, so the SMs'
// issue rate and the chain's latency set it; with every vector in shared
// memory the passes over it took 0.47 of the cycles
// (tools/k4_phase_profile.py).  The design:
//  * InRegs (Rosenbrock and weighted squares up to n = K4_REG_N = 128):
//    lane l holds coordinates 4l .. 4l + 3 of every vector in registers;
//    the Rosenbrock stencil takes one shuffle per neighbour; no shared
//    memory; 24 resident warps per SM at 80 registers in float32.
//    InShared (the quadratic, the log-sum-exp, and wider instances): every
//    vector in the warp's shared memory, coordinate i on lane i % 32, 8 n
//    elements (the log-sum-exp's z and p 2 rows more), which decides the
//    widest instance K4 takes;
//  * the Hessian's coefficients (Rosenbrock: H_ii, H_{i,i+1} = -400 x_i,
//    H_{i,i-1} = -400 x_{i-1}; weighted squares: d_i) are computed once
//    per Newton step in InRegs; every value, gradient, coefficient and
//    product is the functor's own per-coordinate expression
//    (objectives.cuh: grad_at, hess_diag_at, hess_off, hvp_at), so every
//    product is the one hvp gives;
//  * the product reads p itself: the masked operand p * fr equals p
//    (R, P and the masked products are +-0 or NaN on the bound-active
//    coordinates from the start and stay so: tests/test_torch_k4_algebra.py);
//    the product's pass masks q and forms p.q and p.p, both reduced in one
//    transposed butterfly (warp_sums);
//  * the projection-arc norm once per iteration (the stop and w);
//  * every trial evaluates value and gradient, its g.(x_t - x) reduced in
//    the value's butterfly, and the accepted trial's value and gradient are
//    the step's; only the point after the last rejection is evaluated after
//    the search; X/XT and G/Q swap instead of being copied;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do.
// The step's P update cannot join the D/R pass: beta needs that pass's sum.
// Scalars (f, f_prev, rr, t, ...) are replicated on every lane after the
// butterflies, so every branch is warp-uniform.
//
// The log-sum-exp (A rows x n, shared by the batch) is bound by its passes
// over A instead: 2 rows n per product and per trial, rows n per Newton
// step for p; every warp reads A from L2 (2 MB at n = 1,000, 512 rows in
// float32), its columns coalesced across the lanes.

#include "common.cuh"
#include "lanes.cuh"
#include "objectives.cuh"

// Phase counters, compiled in only with -DK4_PROFILE (tools/k4_phase_profile.py
// builds such a copy; the kernel as shipped has none).  Lane 0 of each warp
// adds the clock64 cycles of its instance's phases to k4_prof[0..5] (the
// phases in that tool's PHASES order); [6] counts instance-iterations, [7]
// Hessian-vector products, [8] trials, [9] instances, [10] the cycles of
// whole instances (set-up and epilogue included).
#ifdef K4_PROFILE
__device__ unsigned long long k4_prof[16];
#define K4_PROF(...) __VA_ARGS__
#else
#define K4_PROF(...)
#endif
#define K4_PHASE(k) \
  K4_PROF(if (lane == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; prof_t = t_; })

// the widest instance held in registers (a multiple of 32 up to 128; 0
// puts every instance in shared memory, as the tests build it to run the
// InShared layout on every geometry)
#ifndef K4_REG_N
#define K4_REG_N 128
#endif
// blocks of kMaxWarpsK4 warps per SM that __launch_bounds__ asks the
// registers of the float32 InRegs kernel to allow.  In one run in turns on
// an H100 (tools/k4_phase_profile.py --residency), 3 blocks (24 warps, 80
// registers, 8 bytes spilled), 4 (32 warps, 64 registers, 64 bytes
// spilled) and 2 (16 warps, 90 registers) took 7.009 / 6.817 / 8.390 ms
// at the headline and 1.813 / 2.031 / 1.798 ms at B = 1,056: 4 blocks gain
// 3% where the batch fills several waves and lose 12% where it fills one
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 3
#endif

namespace {

constexpr int kMaxWarpsK4 = 8;
constexpr int kRegN = K4_REG_N;
constexpr int kE = kRegN > 0 ? kRegN / kWarp : 1;   // coordinates a lane holds
static_assert(kRegN % kWarp == 0 && kRegN <= 4 * kWarp, "K4_REG_N");

// ---- where an instance's vectors live (lanes.cuh): InRegs, lane l
// holding coordinates kE l + e in registers, or InShared
struct InRegs : LanesInRegs<kE> {};

// what InRegs keeps of the Hessian for one Newton step: the diagonal and
// (Rosenbrock) the couplings H_{i,i+1}, with x_{i-1} of slot 0 (the
// neighbouring lane's last slot) for slot 0's H_{i,i-1}.  InShared keeps
// none (the fit): the product forms each row from x.  Forming the
// couplings in each product instead cost more than the registers they
// free (tools/k4_phase_profile.py, PERF.md).
template <class L, typename T> struct Coefs {};
template <typename T> struct Coefs<InRegs, T> {
  InRegs::Vec<T> diag, up;
  T xp0;
};

// the warp sums of a and b on every lane: one transposed butterfly
// (warp_sums, warp_sum's pairing, so the same bits), then one exchange
// between its two halves
template <typename T> __device__ __forceinline__ void pair_sums(T& a, T& b, int lane) {
  T v[2] = {a, b};
  const T r = warp_sums<2>(v, lane);
  const T o = __shfl_xor_sync(kFull, r, kWarp / 2);
  const bool hi = lane >= kWarp / 2;
  a = hi ? o : r;
  b = hi ? r : o;
}

// ---- the objectives on a layout: value and gradient (returning f, with
// the warp sum of `extra`'s partial taken in the same butterfly where the
// functor allows), the coefficients, and the masked product q = (H p) fr
// with the partial sums p.q and p.p.  Every expression is the functor's
// own (objectives.cuh), read through the layout's slots.
template <typename T> __device__ __forceinline__ T with_extra(T s, T& extra, int lane) {
  pair_sums(extra, s, lane);
  return s;
}

// q = (H p) fr on slot e, adding p.q and p.p
template <typename T, class V>
__device__ __forceinline__ void masked(T o, const V& p, V& q, const V& fr, int e, T& pq, T& pp) {
  const T qi = o * fr[e];
  q[e] = qi;
  pq += p[e] * qi;
  pp += p[e] * p[e];
}

template <typename T, class Obj> struct K4Eval;

template <typename T> struct K4Eval<T, Rosenbrock<T>> {
  using Obj = Rosenbrock<T>;
  static constexpr bool kRegs = true;
  template <class L, class V>
  __device__ static T value_grad(const Obj&, const V& x, V& g, int n, int lane, T& extra) {
    const V xn = L::next(x, lane), xp = L::prev(x, lane);
    T s = 0;
    LANES_FOR(L, e, i) g[e] = Obj::grad_at(slot_at(x, xn, xp, e), i, n, s);
    return with_extra(s, extra, lane);
  }
  template <class L, class V>
  __device__ static void prepare(const Obj&, Coefs<L, T>& c, const V& x, int n, int lane) {
    if constexpr (L::kRegs) {
      const V xn = L::next(x, lane), xp = L::prev(x, lane);
      LANES_FOR(L, e, i) {
        c.diag[e] = Obj::hess_diag_at(slot_at(x, xn, xp, e), i, n);
        c.up[e] = Obj::hess_off(x[e]);
      }
      c.xp0 = xp[0];
    }
  }
  template <class L, class V>
  __device__ static void product(const Obj&, const Coefs<L, T>& c, const V& x, const V& p,
                                 V& q, const V& fr, int n, int lane, T& pq, T& pp) {
    const V pn = L::next(p, lane), pv = L::prev(p, lane);
    LANES_FOR(L, e, i) {
      const auto pe = slot_at(p, pn, pv, e);
      T o;
      if constexpr (L::kRegs) {
        // row i: h(d) = H_{i,i+d}
        const auto h = [&](int d) {
          return d == 0 ? c.diag[e] : d > 0 ? c.up[e] : e == 0 ? Obj::hess_off(c.xp0) : c.up[e - 1];
        };
        o = Obj::hvp_at(h, pe, i, n);
      } else {
        const V xn = L::next(x, lane), xp = L::prev(x, lane);
        o = Obj::hvp_at(Obj::hess_row_at(slot_at(x, xn, xp, e), i, n), pe, i, n);
      }
      masked(o, p, q, fr, e, pq, pp);
    }
  }
};

template <typename T> struct K4Eval<T, WeightedSquares<T>> {
  using Obj = WeightedSquares<T>;
  static constexpr bool kRegs = true;
  template <class L, class V>
  __device__ static T value_grad(const Obj& obj, const V& x, V& g, int n, int lane, T& extra) {
    T s = 0;
    LANES_FOR(L, e, i) g[e] = obj.grad_at(x[e], i, s);
    return T(0.5) * with_extra(s, extra, lane);
  }
  template <class L, class V>
  __device__ static void prepare(const Obj& obj, Coefs<L, T>& c, const V&, int n, int lane) {
    if constexpr (L::kRegs) {
      LANES_FOR(L, e, i) c.diag[e] = obj.hess_diag_at(i);
    }
  }
  template <class L, class V>
  __device__ static void product(const Obj& obj, const Coefs<L, T>& c, const V&, const V& p,
                                 V& q, const V& fr, int n, int lane, T& pq, T& pp) {
    LANES_FOR(L, e, i) {
      T h;
      if constexpr (L::kRegs) h = c.diag[e];
      else h = obj.hess_diag_at(i);
      masked(h * p[e], p, q, fr, e, pq, pp);
    }
  }
};

// the quadratic reads all of x (and of p) on every lane: InShared only,
// through the functor itself
template <typename T> struct K4Eval<T, Quadratic<T>> {
  using Obj = Quadratic<T>;
  static constexpr bool kRegs = false;
  template <class L, class V>
  __device__ static T value_grad(const Obj& obj, const V& x, V& g, int n, int lane, T& extra) {
    const T f = obj.value_grad(&x[0] - lane, &g[0] - lane, n, lane);
    extra = warp_sum(extra);
    return f;
  }
  template <class L, class V>
  __device__ static void prepare(const Obj&, Coefs<L, T>&, const V&, int, int) {}
  template <class L, class V>
  __device__ static void product(const Obj& obj, const Coefs<L, T>&, const V& x, const V& p,
                                 V& q, const V& fr, int n, int lane, T& pq, T& pp) {
    obj.hvp(&x[0] - lane, &p[0] - lane, &q[0] - lane, n, lane);
    LANES_FOR(L, e, i) masked(q[e], p, q, fr, e, pq, pp);
  }
};

// the log-sum-exp reads all of x and p, and A's rows: InShared only,
// through the functor, with its buffers z and p (2 rows elements) after the
// warp's vectors; p = softmax(A x + b) once per Newton step (prepare), so
// that each product is two passes over A (A p, then A^T of the weights)
template <typename T> struct K4Eval<T, LogSumExp<T>> {
  using Obj = LogSumExp<T>;
  static constexpr bool kRegs = false;
  template <class L, class V>
  __device__ static T value_grad(const Obj& obj, const V& x, V& g, int n, int lane, T& extra) {
    const T f = obj.value_grad(&x[0] - lane, &g[0] - lane, n, lane);
    extra = warp_sum(extra);
    return f;
  }
  template <class L, class V>
  __device__ static void prepare(const Obj& obj, Coefs<L, T>&, const V& x, int n, int lane) {
    obj.prepare(&x[0] - lane, n, lane);
  }
  template <class L, class V>
  __device__ static void product(const Obj& obj, const Coefs<L, T>&, const V& x, const V& p,
                                 V& q, const V& fr, int n, int lane, T& pq, T& pp) {
    obj.hvp(&x[0] - lane, &p[0] - lane, &q[0] - lane, n, lane);
    LANES_FOR(L, e, i) masked(q[e], p, q, fr, e, pq, pp);
  }
};

// shared memory of one warp's instance in elements: the layout's vectors,
// then the functor's row buffers (LogSumExp: z and p)
template <class L, class Obj> __host__ __device__ long long k4_warp_elems(int n, int rows) {
  return L::work_elems(n) + (long long)Bind<Obj>::kRowBuffers * rows;
}

template <typename T, class L> constexpr int k4_min_blocks() {
  return L::kRegs ? (sizeof(T) == 4 ? K4_MIN_BLOCKS : 2) : 1;
}

template <typename T> struct K4Params {
  const T* x0;
  const T* lo;
  const T* up;
  const T* d0;
  const T* d1;
  int rows;             // LOG_SUM_EXP rows (0 otherwise)
  int B, n;
  T pgtol, f_rtol, eps, c1;
  int max_iter, cg_max, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* ncg_out;         // Hessian-vector products (CG steps tried)
  int* nfev_out;        // line-search trials
};

template <typename T, class Obj, class L>
__global__ void __launch_bounds__(kWarp * kMaxWarpsK4, (k4_min_blocks<T, L>()))
newton_cg_kernel(const K4Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  using V = typename L::template Vec<T>;
  using E = K4Eval<T, Obj>;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n;
  const T INF = (T)INFINITY;
  K4_PROF(long long prof_acc[11] = {0}; const long long prof_t0 = clock64();
          long long prof_t = prof_t0;)

  T* work = reinterpret_cast<T*>(smem_raw) + (long long)warp * k4_warp_elems<L, Obj>(n, prm.rows);
  V X = L::template alloc<T>(work, n, lane);
  V G = L::template alloc<T>(work, n, lane);
  V D = L::template alloc<T>(work, n, lane);
  V R = L::template alloc<T>(work, n, lane);
  V P = L::template alloc<T>(work, n, lane);
  V Q = L::template alloc<T>(work, n, lane);    // H p, then the trial's gradient
  V XT = L::template alloc<T>(work, n, lane);   // the trial point
  V FR = L::template alloc<T>(work, n, lane);   // the free mask, 0 or 1
  const auto LO = L::load(prm.lo, n, lane);
  const auto UP = L::load(prm.up, n, lane);
  Coefs<L, T> C;
  // work now points past the vectors: the functor's row buffers
  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1, nullptr, prm.rows, work, work + prm.rows);

  const T* x0 = prm.x0 + (long long)inst * n;
  LANES_FOR(L, e, i) X[e] = jclip(x0[i], LO[e], UP[e]);
  L::sync();
  T none = 0;
  T F = E::template value_grad<L>(obj, X, G, n, lane, none);
  L::sync();
  T Fprev = INF;
  int iters = 0, ncg = 0, nfev = 0;
  K4_PROF(prof_t = clock64();)

  // max_i |x_i - P(x - g)_i| (pallas_newton_cg.py:98-100)
  auto pg_inf = [&]() -> T {
    T mx = 0;
    LANES_FOR(L, e, i) mx = jmax(mx, (T)fabs(X[e] - jclip(X[e] - G[e], LO[e], UP[e])));
    return warp_max(mx);
  };
  auto converged = [&](T pg) -> bool {
    const T fmax = jmax(jmax((T)fabs(F), (T)fabs(Fprev)), T(1));
    return pg <= prm.pgtol || (isfinite(Fprev) && (Fprev - F) <= prm.f_rtol * fmax);
  };

  for (int it = 0; it < prm.max_iter; ++it) {
    const T pg = pg_inf();
    if (!isfinite(F) || converged(pg)) break;

    // ---- two-metric direction: the free mask, then CG on the free
    // subspace (pallas_newton_cg.py:126-202)
    const T w = jmin(pg, T(1e-2));
    T gn2 = 0;
    LANES_FOR(L, e, i) {
      const T g = G[e];
      const bool act = (X[e] - LO[e] <= w && g > T(0)) || (UP[e] - X[e] <= w && g < T(0));
      const T fr = act ? T(0) : T(1);
      const T gF = g * fr;
      FR[e] = fr;
      R[e] = gF;
      P[e] = -gF;
      D[e] = 0;
      gn2 += gF * gF;
    }
    gn2 = warp_sum(gn2);
    const T gn = sqrt(gn2);
    const T eta = jmin((T)sqrt(jmax(gn, T(0))), T(0.5));
    const T e2 = eta * gn;
    const T rtol2 = e2 * e2;
    T rr = gn2;
    bool done = gn2 <= rtol2;
    int steps = 0;
    if (!done) E::template prepare<L>(obj, C, X, n, lane);
    L::sync();
    K4_PHASE(0);
    for (int k = 0; k < prm.cg_max && !done; ++k) {
      T pq = 0, pp = 0;
      E::template product<L>(obj, C, X, P, Q, FR, n, lane, pq, pp);
      ++ncg;
      K4_PHASE(2);
      pair_sums(pq, pp, lane);
      L::sync();
      K4_PHASE(3);
      // Steihaug: stop on curvature at most eps p.p; before any step the
      // direction is -g_F
      const bool negc = pq <= prm.eps * pp;
      const bool restart = negc && steps == 0;
      const T alpha = negc ? T(0) : rr / pq;
      T rn = 0;
      LANES_FOR(L, e, i) {
        const T dv = restart ? -(G[e] * FR[e]) : D[e];
        D[e] = dv + alpha * P[e];
        const T r = R[e] + alpha * Q[e];
        R[e] = r;
        rn += r * r;
      }
      K4_PHASE(1);
      const T rr_new = warp_sum(rn);
      K4_PHASE(3);
      if (!negc) {
        const T beta = rr_new / jmax(rr, prm.eps);
        LANES_FOR(L, e, i) P[e] = -R[e] + beta * P[e];
        rr = rr_new;
        ++steps;
      }
      done = negc || rr_new <= rtol2;
      L::sync();
      K4_PHASE(1);
    }
    // epsilon-active coordinates move along -g; a zero direction falls back
    // to -g
    T dn = 0;
    LANES_FOR(L, e, i) {
      const T d = FR[e] > T(0) ? D[e] : -G[e];
      D[e] = d;
      dn += d * d;
    }
    K4_PHASE(1);
    const bool zero = !(warp_sum(dn) > T(0));
    K4_PHASE(3);
    if (zero) {
      LANES_FOR(L, e, i) D[e] = -G[e];
    }
    K4_PHASE(1);

    // ---- projected backtracking Armijo on P(x + t d)
    // (pallas_newton_cg.py:204-234), each trial a value and gradient into
    // XT and Q; on exhaustion t is the last, untested halving
    T t = 1, fnew = 0;
    bool taken = false, fin = true;
    for (int k = 0; k < prm.max_iter_ls && !taken; ++k) {
      T gs = 0;
      fin = true;
      LANES_FOR(L, e, i) {
        const T xt = jclip(X[e] + t * D[e], LO[e], UP[e]);
        XT[e] = xt;
        gs += G[e] * (xt - X[e]);
        fin = fin && isfinite(xt);
      }
      L::sync();
      const T ft = E::template value_grad<L>(obj, XT, Q, n, lane, gs);
      ++nfev;
      L::sync();
      if (ft <= F + prm.c1 * gs && isfinite(ft)) {
        fnew = ft;
        taken = true;
      } else {
        t = t * T(0.5);
      }
    }
    K4_PHASE(4);

    // ---- the step, taken where its value and point are finite; f_prev
    // advances only then
    if (!taken) {
      fin = true;
      LANES_FOR(L, e, i) {
        const T xn = jclip(X[e] + t * D[e], LO[e], UP[e]);
        XT[e] = xn;
        fin = fin && isfinite(xn);
      }
      L::sync();
      fnew = E::template value_grad<L>(obj, XT, Q, n, lane, none);
      L::sync();
    }
    fin = __all_sync(kFull, fin);
    if (isfinite(fnew) && fin) {
      Fprev = F;
      F = fnew;
      const V xs = X, gs = G;
      X = XT;
      XT = xs;
      G = Q;
      Q = gs;
    }
    ++iters;
    K4_PHASE(5);
  }
  K4_PHASE(0);

  // the TPU kernel's exit: convergence recomputed on the final state, then
  // out of domain where f is not finite, else the budget
  const bool conv = converged(pg_inf());
  const bool finite = isfinite(F);
  const int status = (conv && finite) ? 1 : (!finite ? 3 : 2);
  LANES_FOR(L, e, i) prm.x_out[(long long)inst * n + i] = X[e];
  if (lane == 0) {
    prm.f_out[inst] = F;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.ncg_out[inst] = ncg;
    prm.nfev_out[inst] = nfev;
  }
  K4_PROF(if (lane == 0) {
    prof_acc[6] = iters;
    prof_acc[7] = ncg;
    prof_acc[8] = nfev;
    prof_acc[9] = 1;
    prof_acc[10] = clock64() - prof_t0;
    for (int k = 0; k < 11; ++k) atomicAdd(&k4_prof[k], (unsigned long long)prof_acc[k]);
  })
}

// the launch of a (B, n) batch: warps per block and dynamic shared memory
// per block (0 warps: an instance does not fit)
template <typename T, class L, class Obj>
void k4_shape(int B, int n, int rows, int& wpb, int& smem) {
  const long long per_warp = k4_warp_elems<L, Obj>(n, rows) * (long long)sizeof(T);
  long long w = per_warp > 0 ? kSmemPerBlock / per_warp : kMaxWarpsK4;
  if (w > kMaxWarpsK4) w = kMaxWarpsK4;
  if (w > B) w = B;
  wpb = (int)w;
  smem = (int)(per_warp * w);
}

template <typename T, class Obj, class L>
int k4_launch(const K4Params<T>& prm, cudaStream_t stream) {
  int wpb, smem;
  k4_shape<T, L, Obj>(prm.B, prm.n, prm.rows, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = newton_cg_kernel<T, Obj, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (prm.B + wpb - 1) / wpb;
  kernel<<<grid, wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// InRegs for the functors that have it up to n = kRegN, else InShared
template <typename T, class Obj> int k4_route(const K4Params<T>& prm, cudaStream_t stream) {
  if constexpr (K4Eval<T, Obj>::kRegs)
    if (prm.n <= kRegN) return k4_launch<T, Obj, InRegs>(prm, stream);
  return k4_launch<T, Obj, InShared>(prm, stream);
}

// out: warps per block, resident blocks per SM, registers per thread, local
// (spill) bytes per thread, dynamic shared memory per block
template <typename T, class L> int k4_info(int B, int n, int* out) {
  int wpb, smem;
  k4_shape<T, L, Rosenbrock<T>>(B, n, 0, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = newton_cg_kernel<T, Rosenbrock<T>, L>;
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
  return 0;
}

template <typename T>
int k4_run(int objective, const void* x0, const void* lo, const void* up,
           const void* d0, const void* d1, int rows, int B, int n,
           double pgtol, double f_rtol, double eps, int max_iter, int cg_max,
           int max_iter_ls, double c1, void* x, void* f, void* it, void* st,
           void* ncg, void* nfev, void* stream) {
  K4Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.rows = objective == kLogSumExp ? rows : 0;
  prm.B = B;
  prm.n = n;
  prm.pgtol = (T)pgtol;
  prm.f_rtol = (T)f_rtol;
  prm.eps = (T)eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.cg_max = cg_max;
  prm.max_iter_ls = max_iter_ls;
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.ncg_out = static_cast<int*>(ncg);
  prm.nfev_out = static_cast<int*>(nfev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (objective == kRosenbrock) return k4_route<T, Rosenbrock<T>>(prm, s);
  if (objective == kQuadratic) return k4_route<T, Quadratic<T>>(prm, s);
  if (objective == kLogSumExp) return k4_route<T, LogSumExp<T>>(prm, s);
  return k4_route<T, WeightedSquares<T>>(prm, s);
}

}  // namespace

#ifdef K4_PROFILE
extern "C" int k4_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k4_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k4_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k4_prof, z, sizeof(z));
}
#endif

// shared memory one instance takes in the InShared layout (8 n elements,
// and LOG_SUM_EXP's 2 rows; rows 0 for the other functors), which decides
// the widest instance K4 takes; InRegs takes none
extern "C" long long newton_cg_smem_per_warp(int n, int rows, int elem_size) {
  return (InShared::work_elems(n) + 2LL * rows) * (long long)elem_size;
}

// the launch for one call's shape and the compiled kernel's resources (see
// k4_info); the Rosenbrock functor's kernel in the layout n takes
extern "C" int newton_cg_kernel_info(int dtype, int B, int n, int* out) {
  if (B < 1 || n < 1) return kErrArgs;
  const bool regs = n <= kRegN;
  if (dtype == 0)
    return regs ? k4_info<float, InRegs>(B, n, out) : k4_info<float, InShared>(B, n, out);
  if (dtype == 1)
    return regs ? k4_info<double, InRegs>(B, n, out) : k4_info<double, InShared>(B, n, out);
  return kErrArgs;
}

// dtype 0: float32, 1: float64.  lo and up are (n,) device arrays; d0 and
// d1 the objective's data (WeightedSquares: d, t; Quadratic: Q, b;
// LogSumExp: A (rows, n), b (rows,), with `rows` its rows).  f_rtol
// is factr * eps.  ncg and nfev receive each instance's Hessian-vector
// products and line-search trials.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int newton_cg_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    const void* d0, const void* d1, int rows, int B, int n, double pgtol,
    double f_rtol, double eps, int max_iter, int cg_max, int max_iter_ls,
    double c1, void* x, void* f, void* it, void* st, void* ncg, void* nfev,
    void* stream) {
  if (B < 1 || n < 1 || x0 == nullptr || lo == nullptr || up == nullptr ||
      (objective != kRosenbrock && objective != kWeightedSquares &&
       objective != kQuadratic && objective != kLogSumExp) ||
      (objective != kRosenbrock && (d0 == nullptr || d1 == nullptr)) ||
      (objective == kLogSumExp && rows < 1))
    return kErrArgs;
  if (dtype == 0)
    return k4_run<float>(objective, x0, lo, up, d0, d1, rows, B, n, pgtol,
                         f_rtol, eps, max_iter, cg_max, max_iter_ls, c1, x, f,
                         it, st, ncg, nfev, stream);
  if (dtype == 1)
    return k4_run<double>(objective, x0, lo, up, d0, d1, rows, B, n, pgtol,
                          f_rtol, eps, max_iter, cg_max, max_iter_ls, c1, x, f,
                          it, st, ncg, nfev, stream);
  return kErrArgs;
}
