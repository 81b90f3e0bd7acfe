// Whole batched box-constrained SPG solves on Hopper (sm_90a), one warp per
// instance (K8).
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_spg.py
// (spg_solve_fused, kernel body _make_kernel :34, pl.pallas_call at :195):
// the reference SPG (projected Barzilai-Borwein step, GLL non-monotone
// Armijo, safeguarded BB scalar) without the policy overlays of K3's SPG
// spec.  The plain PyTorch version of the same algorithm is
// spg_solve_plain in ../fused_spg.py; the two are held against each other
// on the card, and every step, trial count and status is the plain
// version's.
//
// Algorithm:
//  * x0 is clipped into the box; lambda_0 = clip(1 / ||P(x0 - g0) - x0||_inf,
//    lam_min, lam_max), so a zero projected step gives lam_max;
//  * the GLL history starts at -inf and takes f every iteration, the oldest
//    value dropping out.  The TPU kernel shifts its history and appends;
//    here slot (own iteration count mod gll_m) is overwritten, which holds
//    the same set of values, and the Armijo reference is their max;
//  * the search is value-only Armijo from t = 1 against that max, halving
//    up to max_iter_ls times; a non-finite trial counts as a rejection, and
//    after the last rejection the halved step is taken all the same; the
//    step is x + t d, not clipped;
//  * BB scalar: lam_max where s.y <= 0, else clip(s.s / s.y, lam_min,
//    lam_max); stop on ||x - P(x - g)||_inf < tol;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do.
//
// What bounds it: each instance's chain of passes and warp reductions, and
// the SM's issue rate.  With every vector in the warp's shared memory, a
// reduction behind a shared-memory round trip for g.d, the GLL max, each
// serial trial, the step's value, s.y and s.s and the convergence max,
// and a second value-and-gradient at the point the last trial had just
// accepted, an H100 spent 6,209 cycles per instance-iteration at config
// 3's inputs; this design spends 4,061 (tools/k3_phase_profile.py
// --first-order).  The design is K3's first-order form's
// (driver_first.cuh), on lanes.cuh:
//  * lane l holds two coordinates a lane up to n = 64 and four up to
//    K8_REG_N = 128 of X, G, D, the new point XT and gradient GN, the box
//    and the objective's data in registers; wider instances keep X, G, D,
//    XT, GN, LO and UP in the warp's shared memory, coordinate i on lane
//    i % 32 (7 n + gll_m elements, the fit as before);
//  * the GLL history in the warp's shared memory, entry j owned by lane j
//    % 32; g.d and its max in one butterfly (sum_max);
//  * the halving schedule is known before any value: kJoint trials a pass
//    (joint_trials), the first that passes with a finite value taken;
//    kJoint is 1 (below: 0.83 of config 3's iterations take one trial);
//  * the accepted trial's point is the step: its value is the step's and
//    its gradient one elementwise pass, no reduction; after exhaustion the
//    step is evaluated;
//  * s.y and s.s in one butterfly, the convergence test a vote; X/XT and
//    G/GN swap instead of copying.

#include "common.cuh"
#include "lanes.cuh"
#include "objectives.cuh"

// Phase counters, compiled in only with -DK8_PROFILE
// (tools/k3_phase_profile.py --first-order builds such a copy; the kernel
// as shipped has none), in the slots of K3's first-order form: lane 0 of
// each warp adds the clock64 cycles of its instance's phases to k8_prof[0]
// (the direction, g.d and the GLL reference), [1] (the trials), [2] (the
// step's evaluation), [3] (the BB pair and the swap) and [5] (the
// convergence test); [6] counts instance-iterations, [7] trials, [8]
// instances, [9] steps that kept the accepted trial's evaluation, [10]
// the cycles of whole instances, [16 + k] the iterations that made k
// trials (k = 15: 15 or more).
#ifdef K8_PROFILE
__device__ unsigned long long k8_prof[32];
#define K8_PROF(...) __VA_ARGS__
#else
#define K8_PROF(...)
#endif
#define K8_PHASE(k) \
  K8_PROF(if (lane == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; prof_t = t_; })

// the widest instance held in registers (64 or 128; 0 puts every instance
// in shared memory, as the tests build it)
#ifndef K8_REG_N
#define K8_REG_N 128
#endif
// the widest instance held two coordinates a lane (64, or 0: four
// coordinates a lane from n = 1, as the tests build it)
#ifndef K8_PAIR_N
#define K8_PAIR_N 64
#endif

namespace {

constexpr int kMaxWarpsPerBlock = 8;
// the register layouts: two coordinates a lane up to n = 64, four up to
// K8_REG_N
constexpr int kK8RegN = K8_REG_N, kK8PairN = K8_PAIR_N;
static_assert(kK8RegN == 0 || kK8RegN == 2 * kWarp || kK8RegN == 4 * kWarp, "K8_REG_N");
static_assert(kK8PairN == 0 || kK8PairN == 2 * kWarp, "K8_PAIR_N");

// a warp's shared memory: the shared layout's seven vectors, the history
template <class L> __host__ __device__ inline long long work_elems(int n, int gll_m) {
  return (L::kRegs ? 0LL : 7LL * n) + gll_m;
}

// trials a pass evaluates together: 1, because at config 3's inputs 0.83
// of the iterations take one trial, and on an H100 (tools/k3_phase_profile.py
// --first-order) one a pass took 1.929 ms there against 2.203 for two and
// 2.452 for four (40 registers and 48 warps per SM against 48 and 40)
constexpr int kJoint = 1;

// blocks of kMaxWarpsPerBlock warps per SM that __launch_bounds__ asks the
// registers of the register layouts to allow: in float32 6 for two
// coordinates a lane (40 registers, 48 warps, no spills at config 3's
// inputs; 8 gave 32 registers, spilled, and took 2.130 ms against 1.997),
// 4 for four (64 registers, as K3's first-order form; 40 spilled); 2 in
// float64
template <typename T, class L> constexpr int k8_min_blocks() {
  if constexpr (!L::kRegs) return 1;
  if constexpr (sizeof(T) == 8) return 2;
  return sizeof(typename L::template Vec<T>) == 2 * sizeof(T) ? 6 : 4;
}

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  const T* d0;
  const T* d1;
  int B, n, gll_m;
  T tol, lam_min, lam_max, c1;
  int max_iter, max_iter_ls;
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;        // value trials per instance
};

template <typename T, class Obj, class L>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock, (k8_min_blocks<T, L>()))
spg_fused_kernel(const Params<T> prm) {
  extern __shared__ unsigned char smem_raw[];
  using V = typename L::template Vec<T>;
  using E = LaneObj<T, Obj>;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n, gll_m = prm.gll_m;
  const T INF = (T)INFINITY;

  T* work = reinterpret_cast<T*>(smem_raw) + (long long)warp * work_elems<L>(n, gll_m);
  V X = L::template alloc<T>(work, n, lane);
  V G = L::template alloc<T>(work, n, lane);
  V D = L::template alloc<T>(work, n, lane);
  V XT = L::template alloc<T>(work, n, lane);
  V GN = L::template alloc<T>(work, n, lane);
  V LO = L::template alloc<T>(work, n, lane);
  V UP = L::template alloc<T>(work, n, lane);
  T* FH = work;                       // the history, entry j on lane j % 32

  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1);
  const typename E::template Data<L> dat(obj, n, lane);
  const T* x0 = prm.x0 + (long long)inst * n;
  LANES_FOR(L, e, i) {
    LO[e] = prm.lo[i];
    UP[e] = prm.up[i];
    X[e] = jclip(x0[i], LO[e], UP[e]);
  }
  for (int j = lane; j < gll_m; j += kWarp) FH[j] = -INF;
  L::sync();
  T Fv = value_grad<L, E>(dat, X, G, n, lane);
  L::sync();

  T dmax = 0;
  LANES_FOR(L, e, i) dmax = jmax(dmax, (T)fabs(jclip(X[e] - G[e], LO[e], UP[e]) - X[e]));
  T lam = jclip(T(1) / warp_max(dmax), prm.lam_min, prm.lam_max);

  // ||x - P(x - g)||_inf < tol: a vote (a NaN entry fails it on its lane)
  auto converged = [&]() {
    T pg = 0;
    LANES_FOR(L, e, i) pg = jmax(pg, (T)fabs(X[e] - jclip(X[e] - G[e], LO[e], UP[e])));
    return __all_sync(kFull, pg < prm.tol);
  };

  int iters = 0;
  int nfev = 0;
  K8_PROF(long long prof_acc[32] = {0}; const long long prof_t0 = clock64();
          long long prof_t = prof_t0;)
  bool active = isfinite(Fv) && !converged();
  while (active && iters < prm.max_iter) {
    K8_PROF(if (lane == 0) prof_t = clock64(); const int nfev_it = nfev;)
    // ---- projected BB direction, g.d and the GLL reference (the
    // history's max after f is written at iters % gll_m) in one butterfly
    T g0d = 0;
    LANES_FOR(L, e, i) {
      D[e] = jclip(X[e] - lam * G[e], LO[e], UP[e]) - X[e];
      g0d += G[e] * D[e];
    }
    const int slot = iters % gll_m;
    T fmax = -INF;
    for (int j = lane; j < gll_m; j += kWarp) {
      const T h = j == slot ? Fv : FH[j];
      if (j == slot) FH[j] = Fv;
      fmax = jmax(fmax, h);
    }
    sum_max(g0d, fmax, lane);
    L::sync();
    K8_PHASE(0);

    // ---- value-only non-monotone Armijo backtracking, kJoint trials a
    // pass
    T t = 1, fnew = 0;
    const T c1 = prm.c1;
    const bool taken = joint_trials<kJoint, false, L, E>(
        dat, X, D, LO, UP, false, T(0.5), prm.max_iter_ls,
        [&](T ft, T tk, T) { return ft <= fmax + c1 * tk * g0d; }, t, fnew, nfev, n, lane);
    K8_PHASE(1);
    K8_PROF(if (lane == 0) ++prof_acc[16 + min(nfev - nfev_it, 15)];)

    // ---- the step x + t d: the accepted trial's point (its value, and
    // its gradient by one elementwise pass), else evaluated
    LANES_FOR(L, e, i) XT[e] = X[e] + t * D[e];
    L::sync();
    if (taken) {
      E::template grad<L>(dat, XT, GN, n, lane);
      K8_PROF(if (lane == 0) ++prof_acc[9];)
    } else {
      fnew = value_grad<L, E>(dat, XT, GN, n, lane);
    }
    L::sync();
    K8_PHASE(2);

    // ---- safeguarded BB scalar from s.y and s.s in one butterfly; the new
    // point and gradient by swapping
    T v[2] = {0, 0}, sums[2];
    LANES_FOR(L, e, i) {
      const T s = XT[e] - X[e];
      const T y = GN[e] - G[e];
      v[0] += s * y;
      v[1] += s * s;
    }
    all_sums<2>(v, sums, lane);
    const T sy = sums[0], ss = sums[1];
    lam = sy <= T(0) ? prm.lam_max : jclip(ss / sy, prm.lam_min, prm.lam_max);
    V w = X;
    X = XT;
    XT = w;
    w = G;
    G = GN;
    GN = w;
    Fv = fnew;
    ++iters;
    L::sync();
    K8_PHASE(3);
    active = isfinite(Fv) && !converged();
    K8_PHASE(5);
  }

  const bool finite = isfinite(Fv);
  const int status = (converged() && finite) ? 1 : (!finite ? 3 : 2);
  LANES_FOR(L, e, i) prm.x_out[(long long)inst * n + i] = X[e];
  if (lane == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.nfev_out[inst] = nfev;
  }
  K8_PROF(if (lane == 0) {
    prof_acc[6] = iters;
    prof_acc[7] = nfev;
    prof_acc[8] = 1;
    prof_acc[10] = clock64() - prof_t0;
    for (int k = 0; k < 32; ++k) atomicAdd(&k8_prof[k], (unsigned long long)prof_acc[k]);
  })
}

// the launch of a (B, n) batch: warps per block and dynamic shared memory
// per block (0 warps: an instance does not fit)
template <typename T, class L> void k8_shape(int B, int n, int gll_m, int& wpb, int& smem) {
  const long long per_warp = work_elems<L>(n, gll_m) * (long long)sizeof(T);
  long long w = kSmemPerBlock / per_warp;
  if (w > kMaxWarpsPerBlock) w = kMaxWarpsPerBlock;
  if (w > B) w = B;
  wpb = (int)w;
  smem = (int)(per_warp * w);
}

template <typename T, class Obj, class L>
int k8_launch(const Params<T>& prm, cudaStream_t stream) {
  int wpb, smem;
  k8_shape<T, L>(prm.B, prm.n, prm.gll_m, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = spg_fused_kernel<T, Obj, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (prm.B + wpb - 1) / wpb;
  kernel<<<grid, wpb * kWarp, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// two coordinates a lane up to n = 64, four up to kK8RegN, else the
// shared layout: a route by shape
template <typename T, class Obj>
int launch(const Params<T>& prm, cudaStream_t stream) {
  if constexpr (kK8RegN > 0 && kK8PairN > 0)
    if (prm.n <= kK8PairN) return k8_launch<T, Obj, LanesInRegs<2>>(prm, stream);
  if constexpr (kK8RegN > 2 * kWarp)
    if (prm.n <= kK8RegN) return k8_launch<T, Obj, LanesInRegs<4>>(prm, stream);
  return k8_launch<T, Obj, InShared>(prm, stream);
}

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        const void* d0, const void* d1, int B, int n, double tol,
        double lam_min, double lam_max, int gll_m, double c1, int max_iter,
        int max_iter_ls, void* x, void* f, void* it, void* st, void* nfev,
        void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.B = B;
  prm.n = n;
  prm.gll_m = gll_m;
  prm.tol = (T)tol;
  prm.lam_min = (T)lam_min;
  prm.lam_max = (T)lam_max;
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
  return kErrArgs;
}

}  // namespace

#ifdef K8_PROFILE
extern "C" int k8_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k8_prof, sizeof(unsigned long long) * 32);
}
extern "C" int k8_prof_reset() {
  const unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(k8_prof, z, sizeof(z));
}
#endif

namespace {
template <typename T, class L> int k8_info(int B, int n, int gll_m, int* out) {
  int wpb, smem;
  k8_shape<T, L>(B, n, gll_m, wpb, smem);
  if (wpb < 1) return kErrSmem;
  auto kernel = spg_fused_kernel<T, WeightedSquares<T>, L>;
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

template <typename T> int k8_info_at(int B, int n, int gll_m, int* out) {
  if constexpr (kK8RegN > 0 && kK8PairN > 0)
    if (n <= kK8PairN) return k8_info<T, LanesInRegs<2>>(B, n, gll_m, out);
  if constexpr (kK8RegN > 2 * kWarp)
    if (n <= kK8RegN) return k8_info<T, LanesInRegs<4>>(B, n, gll_m, out);
  return k8_info<T, InShared>(B, n, gll_m, out);
}
}  // namespace

// The launch of the weighted-squares kernel at batch B and width n with a
// GLL history of gll_m: out[0] warps (instances) per block, [1] resident
// blocks per SM (the occupancy calculator), [2] registers and [3] local
// bytes a thread, [4] dynamic shared memory per block, [5] the coordinates a
// lane holds in registers (0: the shared-memory layout).
extern "C" int spg_fused_info(int dtype, int B, int n, int gll_m, int* out) {
  if (B < 1 || n < 1 || gll_m < 1 || out == nullptr) return kErrArgs;
  if (dtype == 0) return k8_info_at<float>(B, n, gll_m, out);
  if (dtype == 1) return k8_info_at<double>(B, n, gll_m, out);
  return kErrArgs;
}

// shared memory one instance takes in the shared layout, which decides the
// widest instance K8 takes (the register layout takes the history alone)
extern "C" long long spg_fused_smem_per_warp(int n, int gll_m, int elem_size) {
  return work_elems<InShared>(n, gll_m) * (long long)elem_size;
}

// dtype 0: float32, 1: float64.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int spg_fused_launch(int dtype, int objective, const void* x0,
                                const void* lo, const void* up, const void* d0,
                                const void* d1, int B, int n, double tol,
                                double lam_min, double lam_max, int gll_m,
                                double c1, int max_iter, int max_iter_ls,
                                void* x, void* f, void* it, void* st, void* nfev,
                                void* stream) {
  if (B < 1 || n < 1 || gll_m < 1) return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, d0, d1, B, n, tol, lam_min,
                      lam_max, gll_m, c1, max_iter, max_iter_ls, x, f, it, st,
                      nfev, stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, d0, d1, B, n, tol, lam_min,
                       lam_max, gll_m, c1, max_iter, max_iter_ls, x, f, it,
                       st, nfev, stream);
  return kErrArgs;
}
