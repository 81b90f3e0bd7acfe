// Where one warp's instance keeps its vectors, and what K3's first-order
// form and K8 evaluate on them.  Shared by K4 (newton_cg.cu: the layouts),
// K3's first-order form (driver_first.cuh) and K8 (spg_fused.cu).
//
// A layout gives the coordinates lane `lane` holds (slots e < count,
// coordinate index(lane, e)), a vector type indexed by slot, its
// neighbours' values (next / prev: slot e holds coordinate index + 1 /
// index - 1; read only where that coordinate exists) and the barrier a
// write needs before another lane reads it:
//  * LanesInRegs<kE>: lane l holds coordinates kE l .. kE l + kE - 1 of
//    every vector in registers; a neighbour across lanes comes by one
//    shuffle;
//  * InShared: coordinate i on lane i % 32, each vector n elements of the
//    warp's shared memory (a Vec points at the lane's first coordinate).
//
// LaneObj<T, Obj> evaluates Rosenbrock and WeightedSquares on a layout
// through the functors' own per-coordinate members (objectives.cuh), so
// every value and gradient is the one the functors' loops give:
// value_grad (the gradient, and the value by one butterfly), grad (the
// gradient alone, no reduction: the value of a point whose value a trial
// already reduced), part (a trial's partial sum of the value, for a
// butterfly of several).  joint_trials runs value-only Armijo trials of a
// fixed-ratio schedule K at a time on it.

#pragma once

#include "common.cuh"
#include "objectives.cuh"

namespace {

// lane l holds coordinates kE l + e in registers; a slot past n holds 0
// and is never written or summed
template <int kE> struct LanesInRegs {
  static constexpr bool kRegs = true;
  template <typename T> struct Vec {
    T a[kE];
    __device__ __forceinline__ T& operator[](int e) { return a[e]; }
    __device__ __forceinline__ const T& operator[](int e) const { return a[e]; }
  };
  __host__ __device__ static constexpr long long work_elems(int) { return 0; }
  __device__ static constexpr int count(int, int) { return kE; }
  __device__ static int index(int lane, int e) { return lane * kE + e; }
  __device__ static void sync() {}
  template <typename T> __device__ static Vec<T> alloc(T*&, int, int) { return Vec<T>{}; }
  template <typename T> __device__ static Vec<T> load(const T* src, int n, int lane) {
    Vec<T> v{};
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (index(lane, e) < n) v[e] = src[index(lane, e)];
    return v;
  }
  template <typename T> __device__ static Vec<T> next(const Vec<T>& v, int lane) {
    Vec<T> o;
#pragma unroll
    for (int e = 0; e + 1 < kE; ++e) o[e] = v[e + 1];
    o[kE - 1] = __shfl_sync(kFull, v[0], lane + 1);
    return o;
  }
  template <typename T> __device__ static Vec<T> prev(const Vec<T>& v, int lane) {
    Vec<T> o;
    o[0] = __shfl_sync(kFull, v[kE - 1], lane - 1);
#pragma unroll
    for (int e = 1; e < kE; ++e) o[e] = v[e - 1];
    return o;
  }
};

// coordinate i on lane i % 32, each vector n elements of the warp's shared
// memory (a Vec points at the lane's first coordinate); work_elems is K4's
// eight vectors
struct InShared {
  static constexpr bool kRegs = false;
  template <typename T> struct Vec {
    T* p;
    __device__ __forceinline__ T& operator[](int e) const { return p[e * kWarp]; }
  };
  __host__ __device__ static constexpr long long work_elems(int n) { return 8LL * n; }
  __device__ static int count(int n, int lane) { return (n - lane + kWarp - 1) / kWarp; }
  __device__ static int index(int lane, int e) { return lane + kWarp * e; }
  __device__ static void sync() { __syncwarp(); }
  template <typename T> __device__ static Vec<T> alloc(T*& work, int n, int lane) {
    Vec<T> v{work + lane};
    work += n;
    return v;
  }
  template <typename T> __device__ static Vec<const T> load(const T* src, int, int lane) {
    return Vec<const T>{src + lane};
  }
  template <typename T> __device__ static Vec<T> next(const Vec<T>& v, int) { return Vec<T>{v.p + 1}; }
  template <typename T> __device__ static Vec<T> prev(const Vec<T>& v, int) { return Vec<T>{v.p - 1}; }
};

#define LANES_FOR(L, e, i)                               \
  _Pragma("unroll") for (int e = 0; e < L::count(n, lane); ++e) \
    if (const int i = L::index(lane, e); i < n)

// slot e's neighbourhood as objectives.cuh's accessors read it: v(d) is
// the value at coordinate i + d, from v and its neighbour views vn, vp
// (L::next, L::prev)
template <class V>
__device__ __forceinline__ auto slot_at(const V& v, const V& vn, const V& vp, int e) {
  return [&v, &vn, &vp, e](int d) { return d == 0 ? v[e] : d > 0 ? vn[e] : vp[e]; };
}

// a trial point's coordinate x + t d, clipped into [lo, up] with `clip`
template <typename T> __device__ __forceinline__ T trial_at(T x, T d, T lo, T up, T t, bool clip) {
  const T xt = x + t * d;
  return clip ? jclip(xt, lo, up) : xt;
}

// S warp sums of v (S a power of two up to 32) on every lane: one
// transposed butterfly (warp_sums, warp_sum's pairing, so the same bits),
// then one shuffle of each sum from a lane that holds it.  v is clobbered
template <int S, typename T>
__device__ __forceinline__ void all_sums(T (&v)[S], T (&out)[S], int lane) {
  const T r = warp_sums<S>(v, lane);
  if constexpr (S == 1) {
    out[0] = r;
  } else {
#pragma unroll
    for (int j = 0; j < S; ++j) out[j] = __shfl_sync(kFull, r, j * (kWarp / S));
  }
}

// The warp sum of s and the warp max of m (jmax: NaN propagates) on every
// lane in one butterfly of six shuffles, where the two take ten apart:
// the low half of the warp reduces s in warp_sum's pairing (so the same
// bits), the high half m, and one exchange gives both to every lane
template <typename T> __device__ __forceinline__ void sum_max(T& s, T& m, int lane) {
  const bool hi = lane & (kWarp / 2);
  T v = hi ? m : s;
  const T o = __shfl_xor_sync(kFull, hi ? s : m, kWarp / 2);
  v = hi ? jmax(v, o) : v + o;
#pragma unroll
  for (int w = kWarp / 4; w > 0; w >>= 1) {
    const T u = __shfl_xor_sync(kFull, v, w);
    v = hi ? jmax(v, u) : v + u;
  }
  const T x = __shfl_xor_sync(kFull, v, kWarp / 2);
  s = hi ? x : v;
  m = hi ? v : x;
}

// ---- the objectives on a layout.  Data<L>: what a lane's slots read of
// the objective's data (WeightedSquares: d and t, in registers for
// LanesInRegs, a view of device memory for InShared); value_of: f from the
// warp sum of the partial sums; part(dat, p, n, lane): the lane's partial
// sum of the value at the point p (p(e, 0) slot e's coordinate, p(e, 1)
// the next coordinate's; the value alone, as a trial needs it);
// grad(dat, x, g, n, lane): the gradient of x into g, returning the
// partial sum of the value (the same bits as part's at the same point).
template <typename T, class Obj> struct LaneObj;

template <typename T> struct LaneObj<T, Rosenbrock<T>> {
  using Obj = Rosenbrock<T>;
  static constexpr bool kNext = true;   // a term reads the next coordinate
  template <class L> struct Data {
    __device__ Data(const Obj&, int, int) {}
  };
  __device__ static T value_of(T sum) { return sum; }
  template <class L, class D, class P>
  __device__ static T part(const D&, const P& p, int n, int lane) {
    T s = 0;
    LANES_FOR(L, e, i) if (i < n - 1) s += Obj::term_at([&](int d) { return p(e, d); });
    return s;
  }
  template <class L, class D, class V>
  __device__ static T grad(const D&, const V& x, V& g, int n, int lane) {
    const V xn = L::next(x, lane), xp = L::prev(x, lane);
    T s = 0;
    LANES_FOR(L, e, i) g[e] = Obj::grad_at(slot_at(x, xn, xp, e), i, n, s);
    return s;
  }
};

template <typename T> struct LaneObj<T, WeightedSquares<T>> {
  using Obj = WeightedSquares<T>;
  static constexpr bool kNext = false;
  template <class L> struct Data {
    using DV = decltype(L::template load<T>((const T*)nullptr, 0, 0));
    DV d, c;
    __device__ Data(const Obj& o, int n, int lane)
        : d(L::template load<T>(o.d0, n, lane)), c(L::template load<T>(o.d1, n, lane)) {}
  };
  __device__ static T value_of(T sum) { return T(0.5) * sum; }
  template <class L, class D, class P>
  __device__ static T part(const D& dat, const P& p, int n, int lane) {
    T s = 0;
    LANES_FOR(L, e, i) Obj::grad_of(p(e, 0), dat.d[e], dat.c[e], s);
    return s;
  }
  template <class L, class D, class V>
  __device__ static T grad(const D& dat, const V& x, V& g, int n, int lane) {
    T s = 0;
    LANES_FOR(L, e, i) g[e] = Obj::grad_of(x[e], dat.d[e], dat.c[e], s);
    return s;
  }
};

// value and gradient of x: the gradient into g, f by one butterfly
template <class L, class E, class D, class V>
__device__ __forceinline__ auto value_grad(const D& dat, const V& x, V& g, int n, int lane) {
  return E::value_of(warp_sum(E::template grad<L>(dat, x, g, n, lane)));
}

// Value-only Armijo trials at t, t beta, t beta^2, ... (the serial
// schedule, each t the last times beta, so the same bits) K at a time:
// each pass forms the K trials' partial values (kDist: and their squared
// distances |x_t - x|^2) coordinate by coordinate, reduces them in one
// transposed butterfly and takes the first trial in order that `accept(f,
// t, dd)` passes with a finite value, as the serial search does; trials
// past `budget` are formed and ignored.  The trial point is x + t d,
// clipped into [LO, UP] where `clip`.  Returns whether a trial was
// accepted: then t is its step and f its value; else t is the update after
// the last trial, untested.  nfev counts the trials up to the accepted one
// (all `budget` on exhaustion), as the serial search does.
template <int K, bool kDist, class L, class E, typename T, class D, class V, class B, class A>
__device__ bool joint_trials(const D& dat, const V& X, const V& Dv, const B& LO, const B& UP,
                             bool clip, T beta, int budget, const A& accept, T& t, T& f,
                             int& nfev, int n, int lane) {
  constexpr int S = kDist ? 2 * K : K;
  V XN = X, DN = Dv;
  B LON = LO, UPN = UP;
  if constexpr (E::kNext) {
    XN = L::next(X, lane);
    DN = L::next(Dv, lane);
    if (clip) {
      LON = L::next(LO, lane);
      UPN = L::next(UP, lane);
    }
  }
  for (int done = 0; done < budget; done += K) {
    const int kk = budget - done < K ? budget - done : K;
    T ts[K];
    ts[0] = t;
#pragma unroll
    for (int k = 1; k < K; ++k) ts[k] = ts[k - 1] * beta;
    T acc[S];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T tk = ts[k];
      acc[k] = E::template part<L>(dat, [&](int e, int d) {
        return d == 0 ? trial_at(X[e], Dv[e], LO[e], UP[e], tk, clip)
                      : trial_at(XN[e], DN[e], LON[e], UPN[e], tk, clip);
      }, n, lane);
      if constexpr (kDist) {
        T dd = 0;
        LANES_FOR(L, e, i) {
          const T df = trial_at(X[e], Dv[e], LO[e], UP[e], tk, clip) - X[e];
          dd += df * df;
        }
        acc[K + k] = dd;
      }
    }
    T sums[S];
    all_sums<S>(acc, sums, lane);
    int hit = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T fk = E::value_of(sums[k]);
      T dd = 0;
      if constexpr (kDist) dd = sums[K + k];   // (an index past S, even unread,
                                               // would put sums in local memory)
      if (hit < 0 && k < kk && accept(fk, ts[k], dd) && isfinite(fk)) hit = k;
    }
    // a select, not an index: a register array indexed at run time would
    // live in local memory
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == hit) {
        t = ts[k];
        f = E::value_of(sums[k]);
      } else if (hit < 0 && k == kk - 1) {
        t = ts[k] * beta;
      }
    }
    if (hit >= 0) {
      nfev += hit + 1;
      return true;
    }
    nfev += kk;
  }
  return false;
}

}  // namespace
