// Generic whole-solve driver K3 on Hopper (sm_90a), one warp per instance
// (the block forms: one block): the kernel template, shared by driver.cu
// (the C interface, and the first-order form, whose kernel of its own is
// in driver_first.cuh), driver_qn.cu (the quasi-Newton and Wolfe forms),
// driver_dense.cu (the dense form) and driver_newton.cu (the Newton form).
// The forms are compiled in separate sources, so that they build in
// parallel and the compiler's choices for one form (inlining of the
// objective, registers) do not depend on another form's code.  The
// first-order form compiles the Rosenbrock and WeightedSquares functors;
// the quasi-Newton, Wolfe, dense and Newton forms these, Quadratic and
// LogSumExp (objectives.cuh; the Newton form with their Hessians, the
// quasi-Newton and Wolfe forms' Quadratic and LogSumExp instances in
// driver_qn_data.cu, the dense form's in driver_dense_data.cu).  The one-warp forms give a log-sum-exp instance's
// warp its z of `rows` elements behind its other vectors, the dense form
// its block, ahead of the slab; the quadratic reads Q from device memory
// (L2), the dense form's on warp 0 alone: slow, and right.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_driver.py
// (fused_minimize, kernel body _make_kernel, pl.pallas_call at :1874) for
// all its method specs: the first-order ones (GD, CD, Pnorm, PGD, SPG,
// NCG), the quasi-Newton ones (dense QN and QNB with the bfgs, dfp,
// broyden and sr1 updates, L-BFGS) and the Newton ones (Newton, PN, SPN
// with precond_bb), with its Armijo-family search specs (NoSearch,
// BackTracking, BackTrackingB, GLL) and its Wolfe-family search specs
// (MoreThuente, MoreThuenteB, HagerZhang, HagerZhangB, MINPACK dcsrch).
// The plain PyTorch version of the same algorithm is fused_minimize_plain
// in ../fused_driver.py; the two are held against each other on the card.
//
// What bounds it on this card.  The first-order form: latency, not bytes
// or FLOPs (driver_first.cuh).  The quasi-Newton form: latency too.  L-BFGS at chip_smoke.py's inputs (1,024
// instances, one wave of about 8 warps per SM) lasts as long as its
// slowest instance's chain of dependent shuffles, shared-memory loads and
// divisions, iteration after iteration; the two-loop recursion alone put
// 2 m butterflies in series on it, which the compact form replaces by two
// m-step shuffle sweeps.  The
// dense quasi-Newton methods (QN, QNB) add three passes over the
// instance's (n, n) slab per iteration (B g, B y, and the update's read
// and write), ~10 n^2 operations.  Run by one warp over a slab in device
// memory, those passes set the time at config 2 (n = 100, float32; 1,024
// slabs of 40 KB, 41 MB): each lane walked its 4 columns down all 100
// rows, a chain of some 1,600 slab accesses per lane and iteration (~105
// us for one instance alone on an H100), and the batch streamed ~160 MB of
// slab per iteration.  So the dense form runs one block of kDenseWarps
// warps per instance, the slab in the block's shared memory
// (dense_slab.cuh: the packed upper triangle of the symmetric kinds, 20.2
// KB at config 2, 8 instances per SM), and splits each pass over the
// block's threads.  The Newton form
// writes the dense Hessian into a device-memory slab and factors it there
// every iteration: n^3 / 3 operations per instance (3.6e8 at config 5, n =
// 1,024), 1.4 ms for 256 instances at the card's float32 rate, with the
// slab streamed once per panel of the blocked factorization
// (chol_blocked.cuh, shared with K6).  So the Newton form runs one block of
// 256 threads per instance: warp 0 runs the instance as the other forms'
// warps do, and at the Hessian, the factorization, the solves and (for the
// quadratic, whose passes are n^2) the value and gradient, the block's
// other warps join it.
//
// Design:
//  * one warp per instance (the Newton and dense forms: one block, below),
//    coordinate i on lane i % 32.  K3's lanes are
//    independent (every state write of the TPU kernel is masked by its own
//    lane's active/done flag, and a lane that stops never restarts), so a
//    warp that leaves when its instance is done computes what the TPU
//    kernel computes at any tile;
//  * dynamic shared memory per warp: X, G, the new or trial gradient GN,
//    the direction D, the trial point XT, two scratch vectors GP / DP
//    (NCG's previous gradient and direction; the quasi-Newton pair s, y),
//    GLL's f history ring, and L-BFGS's S and Y rows with three values by
//    slot (valid, and rho and the two-loop alphas or S^T g and Y^T g): 7 n
//    + ring + 2 m n + 3 m elements, and where compact_fits the compact
//    form's u, p and tables S^T Y and Y^T Y, 2 m + 2 m^2 more;
//  * the dense form (QN, QNB; every update kind and search): one block of
//    kDenseThreads threads per instance.  Warp 0 runs the instance as the
//    other forms' warps do; at the slab's passes it posts a command (the
//    direction's B g, the update's B y with Broyden's B^T s, the update)
//    in the command words, and all the block's threads run it between
//    named barriers, as in the Newton form.  The slab (dense_slab.cuh:
//    BFGS, DFP and SR1 keep B symmetric bit for bit, so the packed upper
//    triangle holds it; Broyden's full) lies in the block's shared memory
//    behind the vectors where both fit kSmemPerBlock, else in the
//    device-memory workspace, one slab per instance: the launch picks the
//    placement by dense_in_shared, the wrapper mirrors it.  Its shared
//    memory: X, G, GN, D, XT, s (GP), y (DP), the GLL ring, the words;
//    7 n + ring + 8 elements, then the slab;
//  * L-BFGS keeps its history as a ring with a write position instead of
//    the TPU kernel's shift: head, the oldest pair's slot, moves only when
//    a pair is accepted, so chronological row q (the shift's slot q) lies
//    at slot (head + q) % m.  A reset (the descent safeguard, the
//    zero-progress repair) zeroes VAL (and rho) but leaves S and Y stale;
//  * L-BFGS's direction is the compact form of H g (Byrd, Nocedal and
//    Schnabel 1994; K7's design, lbfgs_fused.cu): H g = gamma g + S p -
//    gamma Y u with u = R^-1 S^T g and p = R^-T ((D + gamma Y^T Y) u -
//    gamma Y^T g), R the upper triangle of S^T Y in chronological order.
//    The m x m algebra runs on lanes (lane q holds row q; the triangular
//    solves are sweeps of one shuffle each), one pass forms d and g.d, and
//    the search reuses that g.d.  An invalid slot's sums and table entries
//    are multiplied by its VAL, so it drops out exactly as its rho * dot *
//    VAL = 0 drops out of the two-loop, and a stale sum that overflowed
//    still poisons the direction (NaN) and takes the same reset.  The
//    tables are kept by slot: a pair accepted at slot h is the newest, so
//    R needs only its column s_k.y_h and Y^T Y its row and column.  The
//    step's pass forms those with the next direction's S^T g and Y^T g
//    (4 m sums, kStepSlots slots per transposed butterfly, the new pair
//    in place of slot h's until it is accepted) and votes max|g| < tol.
//    Past kLaneM pairs, or where the tables do not fit, the two-loop
//    recursion runs, newest -> oldest and back;
//  * where the Wolfe search's last trial is the step (t equals its t, and
//    a bounded method's clip moves no coordinate), its value and gradient
//    are the step's: the quasi-Newton form skips the evaluation there
//    (nfev counts trials only, so every count stays the plain version's).
//    L-BFGS's step then swaps X/XT and G/GN instead of copying;
//  * the Wolfe searches evaluate value and gradient at a trial into GN.
//    More-Thuente evaluates, per trip, t, then tl unless t is accepted,
//    and tu only for its case-4 step: the TPU kernel evaluates all three
//    in lockstep and discards the values these skip, so every step is the
//    same;
//  * the Newton form keeps one (n, n) slab per instance in the device-memory
//    workspace.  The Hessian functor writes the upper triangle of the dense
//    Hessian into it at every direction (its warps split the rows); the
//    blocked Cholesky factor then overwrites that triangle in place, column
//    j of the factor as row j of the slab (the TPU kernel's L slab layout,
//    so the solves read it coalesced).  The TPU kernel downdates the whole
//    symmetric slab and reads row j; the functors' Hessians are exactly
//    symmetric and a downdate subtracts c_i c_k at (i, k) and c_k c_i at
//    (k, i), equal products, so the upper triangle alone holds the same
//    values, and the blocked order gives every element its updates one
//    multiply-add at a time in column order, as the unblocked loop did.
//    The pivot test, the pivot floor sqrt(max(piv, eps)) and eps (QnLit:
//    1.2e-7 / 2.3e-16, pallas_driver.py:791) are the TPU kernel's.  The
//    solves run in place on one shared-memory vector; the factor stays in
//    the slab until the next direction, where SPN's precond_bb solves
//    against it after the step;
//  * the Newton form's block: warp 0 posts a command (Hessian and factor,
//    solve, value, value and gradient) in shared memory and all 256 threads
//    run it between named barriers (barrier.sync 1, non-aligned: warp 0
//    reaches them from inside its divergent control flow, the worker warps
//    from their command loop); warp 0 posts exit at the end.  Its shared
//    memory: X, G, the commands' words, the GLL ring, and D, GN, XT and
//    the solves' staged block, over which the factorization's scratch lies
//    (they are dead while it runs); it keeps no GP/DP pair: after a step D
//    holds s and XT holds y;
//  * the method and the search are runtime, grid-uniform switches on
//    integer codes; the template axes are dtype x objective x form: the
//    quasi-Newton form (L-BFGS with every search) and the Wolfe form (the first-order methods with the
//    Wolfe-family searches: the same code without L-BFGS's, so that its
//    registers do not cost those methods resident warps), both in
//    driver_qn.cu, the dense form (QN and QNB with every search, in driver_dense.cu) and
//    the Newton form (the Newton methods with every search, in
//    driver_newton.cu);
//  * scalars (f, t, lambda, beta, the search state, ...) are replicated in
//    registers after __shfl_xor_sync butterflies, so every branch is
//    warp-uniform;
//  * P^{-1} of PnormDescent stays in device memory, shared by all warps and
//    served from L2; the matvec P^{-1} g is computed here, each lane its own
//    rows.  As in the TPU kernel (preferred_element_type=float32), the
//    product is rounded to float32 before it becomes the float64 direction;
//  * GLL's history is a ring with a write position instead of the TPU
//    kernel's shift: only its max is read, and a max does not depend on
//    the order;
//  * min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do,
//    More-Thuente's rust_min/rust_max/rust_clamp drop it as Rust's f64
//    min/max do, and sign(NaN) is NaN as jnp.sign's is.

#pragma once

#include "chol_blocked.cuh"
#include "common.cuh"
#include "dense_slab.cuh"
#include "objectives.cuh"

// Phase counters of the dense form (QN, QNB), the quasi-Newton form and
// the first-order form, compiled in only with -DK3_PROFILE
// (tools/k3_phase_profile.py builds such a copy; the kernel as shipped has
// none).  Lane 0 of the instance's warp adds the clock64 cycles of every
// iteration's phases to k3_prof[0..5] (the phases in that tool's PHASES
// order for the dense form, QN_PHASES for the quasi-Newton form, which uses
// [0..4], FO_PHASES for the first-order form, which uses [0..3], [5] and
// [11]); [6] counts instance-iterations, [7] search trials, [8] instances,
// [9] the dense form's updates of the slab and the other forms' steps that
// kept the accepted trial's evaluation, [10] the cycles of whole instances
// (set-up and epilogue included), and the first-order form's [16 + k] the
// iterations that made k trials (k = 15: 15 or more).  Each source that
// builds a form has its own copy; the sources of the forms read theirs.
#ifdef K3_PROFILE
namespace {
__device__ unsigned long long k3_prof[32];
}
#define K3_PROF(...) __VA_ARGS__
#else
#define K3_PROF(...)
#endif
#define K3_PHASE(k)                                               \
  K3_PROF(if (prof_on && lane == 0) {                             \
    const long long t_ = clock64();                               \
    prof_acc[k] += t_ - prof_t;                                   \
    prof_t = t_;                                                  \
  })
// sub-phases inside a phase (the quasi-Newton form's k3_prof[11..14]):
// K3_MARK() starts one, K3_SUB(k) adds its cycles to [k] and starts the next
#define K3_MARK() K3_PROF(if (prof_on && lane == 0) sub_t = clock64();)
#define K3_SUB(k)                                                 \
  K3_PROF(if (prof_on && lane == 0) {                             \
    const long long t_ = clock64();                               \
    prof_acc[k] += t_ - sub_t;                                    \
    sub_t = t_;                                                   \
  })

namespace ost_driver {

using namespace ost_chol;
using namespace ost_slab;

// instances (warps) per block of the one-warp forms.  One instance per
// block puts one on each SM at B = 132: L-BFGS + Hager-Zhang took the same
// time there as 8 instances per SM on an H100, so an instance's own chain
// of latencies, not the SM's shared issue or shared-memory rate, sets the
// quasi-Newton form's time
constexpr int kMaxWarpsPerBlock = 8;

enum MethodCode {
  kGD = 0, kCD = 1, kPnorm = 2, kPGD = 3, kSPG = 4, kNCG = 5, kQN = 6,
  kQNB = 7, kLBFGS = 8, kNewton = 9, kPN = 10, kSPN = 11
};
// the template's forms.  The Wolfe form is the quasi-Newton form without
// L-BFGS's code, for the first-order methods with a Wolfe-family search;
// the first-order methods with an Armijo-family search run in the
// first-order form, driver_first.cuh's kernel, not one of this template
enum Form { kQnForm = 1, kNewtonForm = 2, kDenseForm = 3, kWolfeForm = 4 };
enum SearchCode {
  kNoSearch = 0, kBT = 1, kBTB = 2, kGLL = 3, kMT = 4, kMTB = 5, kHZ = 6,
  kHZB = 7, kSW = 8
};
enum NcgVariant { kFR = 0, kPRPlus = 1, kHS = 2, kDY = 3 };
enum QnUpdate { kBFGS = 0, kDFP = 1, kBroyden = 2, kSR1 = 3 };

// the int and double parameter slots of driver_launch (mirrored by
// _launch_cuda in ../fused_driver.py)
enum IntSlot {
  iMethod, iSearch, iAlternate, iNcgVariant, iRestartEvery, iRing, iQnUpdate,
  iScaleB0, iRestart, iLbfgsM, iApproxWolfe, iSearchBounded, iPrecondBB,
  iRows, kIntSlots
};
enum DoubleSlot {
  dTol, dLamMin, dLamMax, dC1, dBeta, dSigma1, dSigma2, dLbfgsEps, dC2,
  dTMin, dTMax, dDelta, dAwEps, dHzSigma, dHzEps, dHzTheta, dHzGamma,
  dHzRho, dXtol, dStpMin, dStpMax, dXtrapl, dXtrapu, kDoubleSlots
};

// the quasi-Newton form's curvature floor and the Newton form's pivot
// floor: the TPU kernel's literals (pallas_driver.py:475, :791), not
// finfo(dtype).eps
template <typename T> struct QnLit;
template <> struct QnLit<float> {
  static constexpr double eps = 1.2e-7;
  static constexpr double tiny = 1.17549435082228750797e-38;
  static constexpr double big = 3.40282346638528859812e+38;
};
template <> struct QnLit<double> {
  static constexpr double eps = 2.3e-16;
  static constexpr double tiny = 2.2250738585072014e-308;
  static constexpr double big = 1.7976931348623157e308;
};

__host__ __device__ inline bool newton_method(int method) {
  return method >= kNewton;
}

__host__ __device__ inline bool qn_form(int method, int search) {
  return method >= kQN || search >= kMT;
}

__host__ __device__ inline bool dense_method(int method) {
  return method == kQN || method == kQNB;
}

__host__ __device__ inline bool bounded_method(int method) {
  return method == kPGD || method == kSPG || method == kQNB || method == kPN ||
         method == kSPN;
}

// L-BFGS's direction in the compact form of H g (below) runs its m x m
// algebra on lanes, chronological row q on lane q: up to kLaneM pairs, and
// where the tables S^T Y and Y^T Y fit beside the vectors.  Past either
// the two-loop recursion runs in the smaller two-loop layout, so every
// width that layout fits is taken
constexpr int kLaneM = kWarp;
// ring slots per transposed butterfly of L-BFGS's step pass, four sums each
// (2, 4 or 8: warp_sums<8>, <16>, <32>), one pass over the coordinates per
// butterfly.  At m = 10 on an H100, L-BFGS + Hager-Zhang at 1,024 x
// Rosenbrock-100 took 4.728 ms with 4, 4.825 with 8 and 5.791 with 2 in one
// run in turns: three butterflies of 16 sums beat two of 32
constexpr int kStepSlots = 4;
constexpr int kUnroll = 4;      // coordinates a lane of the direction's pass holds

// a warp's shared memory in the quasi-Newton and Wolfe forms: X, G, GN, D,
// XT, GP, DP, the GLL ring, L-BFGS's S and Y and by slot VAL and rho (the
// two-loop) or S^T g (the compact form), the two-loop's alphas or Y^T g;
// the compact form adds u and p by slot and the tables S^T Y and Y^T Y;
// last, LOG_SUM_EXP's z of `rows` elements (rows 0 for the other functors).
// At m = 0 and rows = 0, 7 n + ring: the first-order form's shared layout
// too
__host__ __device__ inline long long two_loop_elems(int n, int ring, int m) {
  return 7LL * n + ring + 2LL * m * n + 3LL * m;
}

__host__ __device__ inline bool compact_fits(int n, int ring, int m, int elem_size,
                                             int rows = 0) {
  return m >= 1 && m <= kLaneM &&
         (two_loop_elems(n, ring, m) + 2LL * m * m + 2LL * m + rows) * elem_size <=
             kSmemPerBlock;
}

__host__ __device__ inline long long work_elems(int n, int ring, int m, int elem_size,
                                                int rows = 0) {
  return two_loop_elems(n, ring, m) +
         (compact_fits(n, ring, m, elem_size, rows) ? 2LL * m * m + 2LL * m : 0) + rows;
}

// the dense form's block: its vectors X, G, GN, D, XT, GP (s), DP (y), the
// GLL ring, kDenseWords command words (the update's six scalars, then the
// command and its flags as ints from kDenseCtl) and LOG_SUM_EXP's z of
// `rows` elements (warp 0 evaluates; rows 0 for the other functors), then
// the slab where it fits
constexpr int kDenseWords = 8;
constexpr int kDenseCtl = 6;
enum DenseCmd { kDenseExit = 0, kDenseDirection, kDenseProducts, kDenseUpdate };

__host__ __device__ inline long long dense_vec_elems(int n, int ring, int rows = 0) {
  return 7LL * n + ring + kDenseWords + rows;
}

__host__ __device__ inline bool dense_in_shared(int n, int ring, int kind, int elem_size,
                                                int rows = 0) {
  return slab_in_shared(dense_vec_elems(n, ring, rows), n, kind, elem_size);
}

__host__ __device__ inline long long dense_smem_elems(int n, int ring, int kind,
                                                      int elem_size, int rows = 0) {
  return dense_vec_elems(n, ring, rows) +
         (dense_in_shared(n, ring, kind, elem_size, rows) ? slab_elems(n, kind) : 0);
}

// the device-memory workspace: the Newton form's (n, n) Hessian slabs, the
// dense form's slabs where they do not fit a block's shared memory
__host__ __device__ inline long long workspace_elems(long long B, int n, int method,
                                                     int ring, int kind, int elem_size,
                                                     int rows = 0) {
  if (newton_method(method)) return B * n * n;
  if (dense_method(method) && !dense_in_shared(n, ring, kind, elem_size, rows))
    return B * slab_elems(n, kind);
  return 0;
}

// the Newton form: the panel width of its factorization (as K6's), its
// command words, and its block's shared memory in elements: the region of
// D, GN, XT and the factorization's scratch, X, G, the words, the GLL ring,
// and LOG_SUM_EXP's buffer z of `rows` elements (rows 0 for the others; its
// Hessian's scratch lies in the region)
template <typename T> struct NewtonPanel;
template <> struct NewtonPanel<float> { static constexpr int kNB = 64; };
template <> struct NewtonPanel<double> { static constexpr int kNB = 32; };
constexpr int kNewtonWords = 32;
enum NewtonCmd { kCmdExit = 0, kCmdValue, kCmdValueGrad, kCmdFactor, kCmdSolve };

template <typename T>
__host__ __device__ inline long long newton_region_elems(int n) {
  constexpr int nb = NewtonPanel<T>::kNB;
  const long long scratch = chol_scratch_elems<T, nb>();
  const long long vecs = 3LL * n + chol_solve_elems<nb>();
  return ((vecs > scratch ? vecs : scratch) + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ inline long long newton_smem_elems(int n, int ring, int rows) {
  return newton_region_elems<T>(n) + 2LL * n + kNewtonWords + ring + rows;
}

// Rust's f64::min/max: a NaN operand is discarded
template <typename T> __device__ __forceinline__ T rmin(T a, T b) {
  return a != a ? b : (b != b ? a : (b < a ? b : a));
}
template <typename T> __device__ __forceinline__ T rmax(T a, T b) {
  return a != a ? b : (b != b ? a : (b > a ? b : a));
}
template <typename T> __device__ __forceinline__ T rclamp(T t, T lo, T hi) {
  return jmin(t != t ? lo : jmax(t, lo), hi);
}

// More-Thuente's trial-value formulas (linesearch/morethuente.py)
template <typename T>
__device__ __forceinline__ T cubic_min(T ta, T tb, T fa, T fb, T ga, T gb) {
  const T s = T(3) * (fb - fa) / (tb - ta);
  const T z = s - ga - gb;
  const T w = sqrt(z * z - ga * gb);
  return ta + (tb - ta) * ((w - ga - z) / (gb - ga + T(2) * w));
}
template <typename T>
__device__ __forceinline__ T quad_min1(T ta, T tb, T fa, T fb, T ga) {
  const T lin = (fa - fb) / (ta - tb);
  return ta - T(0.5) * ((ta - tb) * ga / (ga - lin));
}
template <typename T>
__device__ __forceinline__ T quad_min2(T ta, T tb, T ga, T gb) {
  return ta - ga * ((ta - tb) / (ga - gb));
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
  int qn_update, scale_b0, restart, m;
  int precond_bb;       // SPN: the Barzilai-Borwein pair in the Newton metric
  int rows;             // LOG_SUM_EXP's rows (0 otherwise)
  T lbfgs_eps;
  T c2, t_min, t_max, delta, aw_eps;
  int approx_wolfe, search_bounded;
  T hz_sigma, hz_eps, hz_theta, hz_gamma, hz_rho;
  // 2 c1 - 1 (approx-Wolfe), 2 delta - 1 and 1 - theta (Hager-Zhang),
  // formed in double and rounded once, as the plain version's Python
  // floats are
  T aw_fac, hz_2dm1, hz_1mt;
  T xtol, stp_min, stp_max, xtrapl, xtrapu;
  int max_iter, max_iter_ls;
  int slab_shared;      // QN/QNB: the slab in shared memory (set by the launch)
  T* work;              // workspace_elems slab elements (else nullptr)
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* nfev_out;
};

// One command of the Newton form, run by all kCholThreads threads of the
// instance's block: warp 0 posts it in the command words (ctl[0] the
// command, ctl[1..2] its vectors as offsets from the region), the worker
// warps wait for it in newton_worker.  Ends with a block barrier, after
// which warp 0 reads the result (the value in words[16], the failed-pivot
// flag in ctl[3]).  Not inlined: warp 0 and the workers call it from two
// sites, and one copy of the factorization per kernel is enough.
template <typename T, class Obj>
__device__ __noinline__ void newton_command(const Obj& obj, T* region, const T* X, T* Bm,
                                            T* words, int n, int tid) {
  int* ctl = reinterpret_cast<int*>(words + 24);
  const int cmd = ctl[0];
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  T* a = region + ctl[1];
  T* b = region + ctl[2];
  if (cmd == kCmdFactor) {
    // the Hessian's upper triangle, its largest |diagonal entry|, the
    // factor (pallas_driver.py:785-818)
    obj.hessian(X, Bm, n, tid, region);
    chol_bar();
    T dm = 0;
    for (int i = tid; i < n; i += kCholThreads) dm = jmax(dm, (T)fabs(Bm[(long long)i * n + i]));
    dm = warp_max(dm);
    if (lane == 0) words[warp] = dm;
    chol_bar();
    T mx = words[0];
    for (int q = 1; q < kCholWarps; ++q) mx = jmax(mx, words[q]);
    const T eps = (T)QnLit<T>::eps;
    const bool bad = chol_factor_blocked<T, NewtonPanel<T>::kNB>(
        Bm, n, region, tid, PivotFloor<T>{eps * jmax(mx, T(1)), eps});
    if (tid == 0) ctl[3] = bad;
  } else if (cmd == kCmdSolve) {
    // the diagonal blocks are staged past D, GN and XT
    chol_solve_blocked<T, NewtonPanel<T>::kNB>(Bm, a, region + 3 * n, n, tid);
  } else {
    if constexpr (Obj::kBlockEval) {
      // value of x = a, and with kCmdValueGrad its gradient into b
      T sq, sb;
      obj.rows_part(a, cmd == kCmdValueGrad ? b : nullptr, n, warp, kCholWarps, lane, sq, sb);
      if (cmd == kCmdValueGrad) {
        chol_bar();
        obj.cols_grad(a, b, n, tid, kCholThreads);
      }
      if (lane == 0) {
        words[warp] = sq;
        words[kCholWarps + warp] = sb;
      }
      chol_bar();
      if (tid == 0) {
        T s1 = 0, s2 = 0;
        for (int q = 0; q < kCholWarps; ++q) {
          s1 += words[q];
          s2 += words[kCholWarps + q];
        }
        words[16] = T(0.5) * s1 + s2;
      }
    }
  }
  chol_bar();
}

// The Newton form's worker warps (1..7 of the block): run warp 0's
// commands until it posts exit.
template <typename T, class Obj>
__device__ void newton_worker(const Obj& obj, T* region, const T* X, T* Bm,
                              T* words, int n, int tid) {
  const int* ctl = reinterpret_cast<const int*>(words + 24);
  for (;;) {
    chol_bar();
    if (ctl[0] == kCmdExit) return;
    newton_command<T, Obj>(obj, region, X, Bm, words, n, tid);
  }
}

// The dense form's block (QN, QNB): the slab (in the workspace, or
// nullptr where it lies in shared memory, slab_off elements into the
// block's dynamic shared memory), the vectors its commands read and write,
// and the command words (words[0..5] the update's scalars, ctl = words +
// kDenseCtl: the command and the update's flags).
template <typename T> struct DenseBlock {
  T* slab;
  int slab_off;
  const T* G;
  T* D;
  T* XT;
  const T* GP;
  const T* DP;
  T* words;
  int n, kind;
};

// One command of the dense form, run by all kDenseThreads threads: the
// direction's B g into D, the update's B y into D (and Broyden's B^T s into
// XT), or the update of the slab.  Ends with a block barrier.  Inlined at
// warp 0's and the workers' sites (a call was slower: tools/
// dense_residency.py).
template <typename T>
__device__ __forceinline__ void dense_exec(T* slab, const DenseBlock<T>& b, const int* ctl,
                                           int tid) {
  const int cmd = ctl[0];
  if (cmd == kDenseDirection) {
    slab_mv(slab, b.G, b.D, b.n, b.kind, tid, kDenseThreads);
  } else if (cmd == kDenseProducts) {
    if (b.kind == kSlabBroyden)
      slab_mv_broyden(slab, b.DP, b.D, b.GP, b.XT, b.n, tid, kDenseThreads);
    else
      slab_mv(slab, b.DP, b.D, b.n, b.kind, tid, kDenseThreads);
  } else if (cmd == kDenseUpdate) {
    const int flags = ctl[1];
    const T* w = b.words;
    const SlabUpdate<T> u{b.kind,  (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
                          (flags & 8) != 0, w[0], w[1], w[2], w[3], w[4], w[5]};
    slab_update(slab, b.n, u, b.GP, b.D, b.XT, tid, kDenseThreads);
  }
}

// the passes run on a pointer the compiler sees is shared memory (from
// the block's buffer) where the slab lies there: shared loads, 32-bit
// addresses; on the workspace's generic pointer otherwise
template <typename T>
__device__ __forceinline__ void dense_command(const DenseBlock<T>& b, int tid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int* ctl = reinterpret_cast<const int*>(b.words + kDenseCtl);
  if (b.slab == nullptr)
    dense_exec(reinterpret_cast<T*>(smem_raw) + b.slab_off, b, ctl, tid);
  else
    dense_exec(b.slab, b, ctl, tid);
  block_bar(kDenseThreads);
}

// The dense form's worker warps (1 .. kDenseWarps - 1): run warp 0's
// commands until it posts exit.
template <typename T>
__device__ void dense_worker(const DenseBlock<T>& b, int tid) {
  const int* ctl = reinterpret_cast<const int*>(b.words + kDenseCtl);
  for (;;) {
    block_bar(kDenseThreads);
    if (ctl[0] == kDenseExit) return;
    dense_command<T>(b, tid);
  }
}

template <typename T, class Obj, int kForm>
__device__ __forceinline__ void driver_body(const Params<T>& prm) {
  constexpr bool kQn = kForm == kQnForm || kForm == kWolfeForm;
  constexpr bool kNewt = kForm == kNewtonForm;
  constexpr bool kDense = kForm == kDenseForm;
  constexpr bool kBlock = kNewt || kDense;   // one block per instance
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int inst = kBlock ? (int)blockIdx.x : blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= prm.B) return;          // the whole warp leaves together
  const int n = prm.n;
  const int method = prm.method, search = prm.search;
  const bool bounded = bounded_method(method);
  const T INF = (T)INFINITY;
  const bool lbfgs = kForm == kQnForm && method == kLBFGS;
  const int m = lbfgs ? prm.m : 0;
  // LOG_SUM_EXP's z in the one-warp and dense forms (0 at compile time for
  // the functors that read no row buffer; the Newton form places its own)
  const int zrows = !kNewt && Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
  const bool compact = kQn && compact_fits(n, prm.ring, m, (int)sizeof(T), zrows);

  T *X, *G, *GN, *D, *XT, *GP, *DP, *H, *S, *Y, *RHO, *VAL, *AL;
  T *U = nullptr, *P = nullptr, *SY = nullptr, *YY = nullptr;
  T* region = nullptr;                // the Newton form's block layout
  T* words = nullptr;
  T* Z = nullptr;                     // LOG_SUM_EXP's z
  if constexpr (kNewt) {
    region = reinterpret_cast<T*>(smem_raw);
    D = region;
    GN = region + n;
    XT = region + 2 * n;
    X = region + newton_region_elems<T>(n);
    G = X + n;
    words = G + n;
    H = words + kNewtonWords;
    GP = DP = GN;                     // unused by the Newton methods
    S = Y = RHO = VAL = AL = nullptr;
  } else {
    T* const base = reinterpret_cast<T*>(smem_raw) +
                    (kBlock ? 0LL : (long long)warp * work_elems(n, prm.ring, m, (int)sizeof(T),
                                                                 zrows));
    T* p = base;
    X = p; p += n;
    G = p; p += n;
    GN = p; p += n;
    D = p; p += n;
    XT = p; p += n;
    GP = p; p += n;
    DP = p; p += n;
    H = p; p += prm.ring;
    S = p; p += (long long)m * n;
    Y = p; p += (long long)m * n;
    RHO = p; p += m;                  // the compact form: S^T g by slot
    VAL = p; p += m;
    AL = p;                           // the compact form: Y^T g by slot
    if constexpr (kQn) {
      U = AL + m;
      P = U + m;
      SY = P + m;                     // s_k . y_h at [k * m + h]
      YY = SY + (long long)m * m;
    }
    if constexpr (kDense) {
      words = AL;                     // m = 0: the words follow the ring
      Z = words + kDenseWords;
      region = Z + zrows;             // the slab, where it is in shared memory
    } else {
      Z = base + work_elems(n, prm.ring, m, (int)sizeof(T), zrows) - zrows;
    }
  }

  const T* lo = bounded ? prm.lo + (long long)inst * prm.bstride : nullptr;
  const T* up = bounded ? prm.up + (long long)inst * prm.bstride : nullptr;
  const T* x0 = prm.x0 + (long long)inst * n;
  T* Bm = nullptr;
  if constexpr (kNewt) Bm = prm.work + (long long)inst * n * n;
  if constexpr (kDense)
    Bm = prm.slab_shared ? region : prm.work + (long long)inst * slab_elems(n, prm.qn_update);
  // LOG_SUM_EXP's z (the Newton form's past its GLL ring); K3 reads no p
  const Obj obj = Bind<Obj>::make(prm.d0, prm.d1, nullptr, prm.rows,
                                  kNewt ? H + prm.ring : Z, nullptr);
  const DenseBlock<T> dense{prm.slab_shared ? nullptr : Bm,
                            kDense ? (int)(region - reinterpret_cast<T*>(smem_raw)) : 0,
                            G, D, XT, GP, DP, words, n, prm.qn_update};

  if constexpr (kNewt) {
    if (warp != 0) {
      newton_worker<T, Obj>(obj, region, X, Bm, words, n, threadIdx.x);
      return;
    }
  }
  if constexpr (kDense) {
    // B0 = I by the block, then warps 1 .. kDenseWarps-1 serve warp 0
    slab_identity(Bm, n, prm.qn_update, (int)threadIdx.x, kDenseThreads);
    block_bar(kDenseThreads);
    if (warp != 0) {
      dense_worker<T>(dense, threadIdx.x);
      return;
    }
  }
  // the block forms: post a command to the block and run warp 0's share
  // (a, b: the Newton form's vectors; flags: the dense update's)
  auto command = [&](int cmd, const T* a, const T* b, int flags = 0) {
    if constexpr (kBlock) {
      __syncwarp();
      if (lane == 0) {
        int* ctl = reinterpret_cast<int*>(words + (kNewt ? 24 : kDenseCtl));
        ctl[0] = cmd;
        if constexpr (kNewt) {
          ctl[1] = a == nullptr ? 0 : (int)(a - region);
          ctl[2] = b == nullptr ? 0 : (int)(b - region);
        } else {
          ctl[1] = flags;
        }
      }
      if constexpr (kNewt) {
        chol_bar();
        newton_command<T, Obj>(obj, region, X, Bm, words, n, threadIdx.x);
      } else {
        block_bar(kDenseThreads);
        dense_command<T>(dense, threadIdx.x);
      }
    }
  };
  // value and value-and-gradient: the block's for the Newton form's
  // quadratic, warp 0's (or the instance's warp's) otherwise
  auto eval_value = [&](const T* xv) -> T {
    if constexpr (kNewt && Obj::kBlockEval) {
      command(kCmdValue, xv, nullptr);
      return words[16];
    } else {
      return obj.value(xv, n, lane);
    }
  };
  auto eval_value_grad = [&](const T* xv, T* gv) -> T {
    if constexpr (kNewt && Obj::kBlockEval) {
      command(kCmdValueGrad, xv, gv);
      return words[16];
    } else {
      return obj.value_grad(xv, gv, n, lane);
    }
  };

  for (int i = lane; i < n; i += kWarp)
    X[i] = bounded ? jclip(x0[i], lo[i], up[i]) : x0[i];
  __syncwarp();
  T Fv = eval_value_grad(X, G);
  __syncwarp();
  int iters = 0, nfev = 0;

  // ---- method and search state
  T lam = 0, par = 0;
  int ks = 0;
  if (method == kSPG || method == kSPN) {
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
  // quasi-Newton form: s/y norms, stall count, pending reset; L-BFGS's
  // ring position and H0 scaling; More-Thuente-B's running t_max
  T sn = INF, yn = INF, gam = 1, run_tmax = prm.t_max;
  int stc = 0, head = 0;
  bool pend = false;
  // Newton form: the squared decrement (Newton) and whether the last
  // direction's factor failed its pivot test
  T dec2 = INF;
  bool fact_bad = false;
  if constexpr (kQn) {
    for (long long e = lane; e < 2LL * m * n; e += kWarp) S[e] = 0;
    if (compact) {
      // VAL, S^T g and Y^T g by slot, u, p and the tables
      for (long long e = lane; e < 5LL * m + 2LL * m * m; e += kWarp) RHO[e] = 0;
    } else {
      for (int e = lane; e < m; e += kWarp) RHO[e] = VAL[e] = 0;
    }
  }
  __syncwarp();

  auto converged = [&]() -> bool {
    if constexpr (kNewt) {
      if (method == kNewton) return dec2 * T(0.5) < prm.tol;
    }
    if constexpr (kDense) {
      if (method == kQN || method == kQNB) {
        // the gradient 2-norm, or the s/y stall (pallas_driver.py:431)
        T gg = 0;
        for (int i = lane; i < n; i += kWarp) gg += G[i] * G[i];
        const bool g_small = sqrt(warp_sum(gg)) < prm.tol;
        if (prm.restart) return g_small || stc >= 2;
        return g_small || sn < prm.tol || yn < prm.tol;
      }
    }
    // ||g||_inf, or for the bounded first-order methods the infinity norm
    // of g with the components that push against an active bound masked
    T mx = 0;
    for (int i = lane; i < n; i += kWarp) {
      T gi = G[i];
      if (bounded && ((X[i] == lo[i] && gi > T(0)) || (X[i] == up[i] && gi < T(0))))
        gi = 0;
      mx = jmax(mx, (T)fabs(gi));
    }
    const bool small = warp_max(mx) < prm.tol;
    // PN: or the iterate or the gradient stopped moving
    if constexpr (kNewt) {
      if (method == kPN) return small || sn < prm.tol || yn < prm.tol;
    }
    return small;
  };

  K3_PROF(long long prof_acc[32] = {0}; long long prof_t = clock64(); long long sub_t = 0;
          const long long prof_t0 = prof_t;
          const bool prof_on = kDense || kQn;)
  bool active = isfinite(Fv) && !converged();
  for (int it = 0; it < prm.max_iter && active; ++it) {
    K3_PROF(if (prof_on && lane == 0) prof_t = clock64();)
    // the compact L-BFGS direction's g.d, which the search reuses
    T g0d_dir = 0;
    bool have_g0d = false;
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
      default:
        if constexpr (kNewt) {
          // the Hessian into the slab, its factor in place, the step
          // H^-1 g in D (pallas_driver.py:893-904, :933-938, :973-978),
          // each by the block
          command(kCmdFactor, nullptr, nullptr);
          fact_bad = reinterpret_cast<const int*>(words + 24)[3] != 0;
          for (int i = lane; i < n; i += kWarp) D[i] = G[i];
          command(kCmdSolve, D, nullptr);
          bool fin = true;
          for (int i = lane; i < n; i += kWarp) fin = fin && isfinite(D[i]);
          const bool ok = !fact_bad && __all_sync(kFull, fin);
          if (method == kNewton) {
            for (int i = lane; i < n; i += kWarp) D[i] = ok ? -D[i] : -G[i];
            __syncwarp();
            if (ok) {
              // the decrement (H^-1 d) . d: a second solve against the
              // factor, in XT
              for (int i = lane; i < n; i += kWarp) XT[i] = D[i];
              command(kCmdSolve, XT, nullptr);
              T zd = 0;
              for (int i = lane; i < n; i += kWarp) zd += XT[i] * D[i];
              dec2 = warp_sum(zd);
            }
          } else {
            for (int i = lane; i < n; i += kWarp) {
              const T st = ok ? D[i] : G[i];
              D[i] = jclip(X[i] - (method == kSPN ? lam * st : st), lo[i], up[i]) - X[i];
            }
          }
          break;
        }
        if constexpr (kDense) {
          if (method == kQN || method == kQNB) {
            // D = B g by the block, then the direction; the poison check
            // reads the raw B g (for QNB before the clip, which would hide
            // it)
            command(kDenseDirection, nullptr, nullptr);
            bool fin = true;
            T gd = 0;
            for (int i = lane; i < n; i += kWarp) {
              const T bg = D[i];
              fin = fin && isfinite(bg);
              const T d = method == kQN ? -bg : jclip(X[i] - bg, lo[i], up[i]) - X[i];
              D[i] = d;
              gd += G[i] * d;
            }
            fin = __all_sync(kFull, fin);
            gd = warp_sum(gd);
            if (prm.restart) {
              if (!(fin && gd < T(0)))
                for (int i = lane; i < n; i += kWarp)
                  D[i] = method == kQN ? -G[i] : jclip(X[i] - G[i], lo[i], up[i]) - X[i];
              if (!fin) pend = true;
            }
            break;
          }
        }
        if constexpr (kQn) {
          if (lbfgs && compact) {
            // the compact form of H g: lane q < m holds chronological row
            // q at slot sq (head is the oldest pair's slot), v its VAL.  A
            // slot without a valid pair takes R_qq = 1 and has its row's
            // sums and table entries multiplied by v = 0, so that u_q = p_q
            // = 0 and it drops out as it contributes RHO * dot * VAL = 0 to
            // the two-loop; a stale sum that overflowed still gives NaN and
            // takes the reset below, as it does there
            K3_MARK();
            const int q = lane;
            const bool row = q < m;
            int sq = head + q;
            if (sq >= m) sq -= m;
            const T v = row ? VAL[sq] : T(0);
            const T dq = row && v != T(0) ? SY[sq * m + sq] : T(1);
            const T rinv = T(1) / dq;
            T u = row ? v * RHO[sq] : T(0);
            // each step's table entry is loaded one step ahead, off the
            // chain of shuffles
            {
              int c = m - 1, sc = head == 0 ? m - 1 : head - 1;
              T rn = q < c ? v * SY[sq * m + sc] : T(0);
              while (c >= 0) {                                // u = R^-1 S^T g
                const T rc = rn;
                const int c1 = c - 1, sc1 = sc == 0 ? m - 1 : sc - 1;
                if (q < c1) rn = v * SY[sq * m + sc1];
                const T uc = __shfl_sync(kFull, u * rinv, c);
                if (q == c) u = uc;
                else if (q < c) u = u - rc * uc;
                c = c1;
                sc = sc1;
              }
            }
            T yu = 0;
            {
              T yn = row ? YY[sq * m + head] : T(0);
              for (int r = 0, sr = head; r < m; ++r) {
                const T yr = yn;
                sr = sr + 1 == m ? 0 : sr + 1;
                if (row && r + 1 < m) yn = YY[sq * m + sr];
                const T ur = __shfl_sync(kFull, u, r);
                if (row) yu += yr * ur;
              }
            }
            T pq = row ? dq * u + gam * (v * (yu - AL[sq])) : T(0);
            {
              int c = 0, sc = head;
              T rn = row && q > 0 ? v * SY[sc * m + sq] : T(0);
              while (c < m) {                                 // p = R^-T (...)
                const T rc = rn;
                const int c1 = c + 1, sc1 = sc + 1 == m ? 0 : sc + 1;
                if (row && q > c1) rn = v * SY[sc1 * m + sq];
                const T pc = __shfl_sync(kFull, pq * rinv, c);
                if (q == c) pq = pc;
                else if (row && q > c) pq = pq - rc * pc;
                c = c1;
                sc = sc1;
              }
            }
            if (row) {
              U[sq] = u;
              P[sq] = pq;
            }
            __syncwarp();
            K3_SUB(11);
            // d = -(gamma (g - Y u) + S p) and g.d in one pass
            bool fin = true;
            T gd = 0;
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
                  const T d = -(gam * (G[i] - yu_i[e]) + sp_i[e]);
                  D[i] = d;
                  fin = fin && isfinite(d);
                  gd += G[i] * d;
                }
              }
            }
            fin = __all_sync(kFull, fin);
            gd = warp_sum(gd);
            if (fin && gd < T(0)) {
              g0d_dir = gd;     // the search's g.d: the same sum
              have_g0d = true;
            } else {
              // a corrupt model: discard it, retry from steepest descent
              for (int i = lane; i < n; i += kWarp) D[i] = -G[i];
              for (int e = lane; e < m; e += kWarp) VAL[e] = 0;
              gam = 1;
            }
            break;
          }
          if (lbfgs) {
            // two-loop recursion over the ring, newest -> oldest and back
            for (int i = lane; i < n; i += kWarp) D[i] = G[i];
            __syncwarp();
            for (int q = m - 1; q >= 0; --q) {
              const int slot = (head + q) % m;
              const T* s_ = S + (long long)slot * n;
              const T* y_ = Y + (long long)slot * n;
              T dot = 0;
              for (int i = lane; i < n; i += kWarp) dot += s_[i] * D[i];
              const T a = RHO[slot] * warp_sum(dot) * VAL[slot];
              for (int i = lane; i < n; i += kWarp) D[i] = D[i] - a * y_[i];
              if (lane == 0) AL[q] = a;
              __syncwarp();
            }
            for (int i = lane; i < n; i += kWarp) D[i] = gam * D[i];
            for (int q = 0; q < m; ++q) {
              const int slot = (head + q) % m;
              const T* s_ = S + (long long)slot * n;
              const T* y_ = Y + (long long)slot * n;
              T dot = 0;
              for (int i = lane; i < n; i += kWarp) dot += y_[i] * D[i];
              const T b = RHO[slot] * warp_sum(dot) * VAL[slot];
              const T coef = AL[q] - b;
              for (int i = lane; i < n; i += kWarp) D[i] = D[i] + coef * s_[i];
            }
            bool fin = true;
            T gd = 0;
            for (int i = lane; i < n; i += kWarp) {
              const T d = -D[i];
              D[i] = d;
              fin = fin && isfinite(d);
              gd += G[i] * d;
            }
            fin = __all_sync(kFull, fin);
            if (!(fin && warp_sum(gd) < T(0))) {
              // a corrupt model: discard it, retry from steepest descent
              for (int i = lane; i < n; i += kWarp) D[i] = -G[i];
              for (int e = lane; e < m; e += kWarp) RHO[e] = VAL[e] = 0;
              gam = 1;
            }
            break;
          }
        }
        for (int i = lane; i < n; i += kWarp) D[i] = -G[i];   // kGD
        break;
    }
    __syncwarp();
    K3_PHASE(0);

    // ---- step length; the quasi-Newton form keeps the last Wolfe trial's
    // step and value (its point is in XT, its gradient in GN)
    T t = 1;
    T t_last = (T)NAN, f_last = 0;
    if (search == kNoSearch) {
    } else if (search <= kGLL) {
      // the Armijo family: value-only trials until one is accepted or the
      // budget is spent; on exhaustion t is the last update, untested
      T g0d = 0;
      if (kQn && have_g0d) {
        g0d = g0d_dir;
      } else {
        for (int i = lane; i < n; i += kWarp) g0d += G[i] * D[i];
        g0d = warp_sum(g0d);
      }
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
        const T ft = eval_value(XT);
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
    } else {
      // the Wolfe family: value-and-gradient trials.  phi: value and
      // directional derivative at X + t D (trial point in XT, its gradient
      // in GN)
      auto phi = [&](T t, T& ft, T& gt) {
        for (int i = lane; i < n; i += kWarp) XT[i] = X[i] + t * D[i];
        __syncwarp();
        if constexpr (kQn) {
          // the gradient's pass forms g.d too
          ft = obj.template value_grad<true>(XT, GN, n, lane, D, &gt);
          __syncwarp();
          t_last = t;
          f_last = ft;
        } else {
          ft = eval_value_grad(XT, GN);
          __syncwarp();
          T s = 0;
          for (int i = lane; i < n; i += kWarp) s += GN[i] * D[i];
          gt = warp_sum(s);
        }
        ++nfev;
      };
      // per instance min_i (bound_i - x_i) / d_i, NaN terms as +inf
      auto max_feasible_step = [&]() -> T {
        T mn = INF;
        for (int i = lane; i < n; i += kWarp) {
          const T d = D[i];
          T term = d > T(0) ? (up[i] - X[i]) / d : (d < T(0) ? (lo[i] - X[i]) / d : INF);
          if (term != term) term = INF;
          mn = jmin(mn, term);
        }
        return warp_min(mn);
      };
      T g0d = 0;
      if (kQn && have_g0d) {
        g0d = g0d_dir;
      } else {
        for (int i = lane; i < n; i += kWarp) g0d += G[i] * D[i];
        g0d = warp_sum(g0d);
      }
      const T f0 = Fv;
      if (search == kMT || search == kMTB) {
        // More-Thuente, corrected interval update (pallas_driver.py:1141)
        const T c1 = prm.c1, c2 = prm.c2, t_min = prm.t_min;
        T t_max = prm.t_max;
        if (search == kMTB) {
          run_tmax = jmin(run_tmax, max_feasible_step());
          t_max = run_tmax;
        }
        t = rmin(rmax(T(1), t_min), t_max);
        T tl = t_min, tu = t_max;
        bool modified = false, int_conv = false;
        for (int k = 0; k < prm.max_iter_ls; ++k) {
          T ft, gt;
          phi(t, ft, gt);
          bool swc = (ft - f0 <= c1 * t * g0d) && (fabs(gt) <= c2 * fabs(g0d));
          if (prm.approx_wolfe)
            swc = swc || (prm.aw_fac * g0d >= gt && gt >= c2 * g0d &&
                          ft <= f0 + prm.aw_eps * (T)fabs(f0) && t > T(0));
          if (swc || int_conv || t == tl || t == tu) break;
          const T psi_t_f = ft - f0 - c1 * t * g0d, psi_t_g = gt - c1 * g0d;
          modified = modified || (psi_t_f <= T(0) && gt > T(0));
          T fl, gl;
          phi(tl, fl, gl);
          const T f_l = modified ? fl : fl - f0 - c1 * tl * g0d;
          const T g_l = modified ? gl : gl - c1 * g0d;
          const T f_c = modified ? ft : psi_t_f;
          const T g_c = modified ? gt : psi_t_g;
          const bool case1 = f_c > f_l;
          const bool case2 = !case1 && g_c * g_l < T(0);
          const bool case3 = !case1 && !case2 && fabs(g_c) <= fabs(g_l);
          const T tc = cubic_min(tl, t, f_l, f_c, g_l, g_c);
          const T tq = quad_min1(tl, t, f_l, f_c, g_l);
          const T ts = quad_min2(tl, t, g_l, g_c);
          T t_new;
          if (case1) {
            t_new = fabs(tc - tl) < fabs(tq - tl) ? tc : T(0.5) * (tq + tc);
          } else if (case2) {
            t_new = fabs(tc - t) >= fabs(ts - t) ? tc : ts;
          } else if (case3) {
            const T t_plus = fabs(tc - t) < fabs(ts - t) ? tc : ts;
            const T t_far = t + prm.delta * (tu - t);
            t_new = t > tl ? rmin(t_plus, t_far) : rmax(t_plus, t_far);
          } else {
            // case 4 needs phi at tu
            T fu, gu;
            phi(tu, fu, gu);
            const T f_u = modified ? fu : fu - f0 - c1 * tu * g0d;
            const T g_u = modified ? gu : gu - c1 * g0d;
            t_new = cubic_min(tu, t, f_c, f_u, g_c, g_u);
          }
          t_new = rclamp(t_new, t_min, t_max);
          // force progress: extrapolate while unbracketed, bisect once
          // bracketed
          if (t_new == tl || t_new == tu || !isfinite(t_new))
            t_new = rclamp(isfinite(tu) ? T(0.5) * (tl + tu) : T(2) * t, t_min, t_max);
          // the interval revised at the evaluated t (cases U1-U3)
          const bool u1 = f_c > f_l;
          const T gdi = g_c * (tl - t);
          const bool u2 = !u1 && gdi > T(0);
          const bool u3 = !u1 && !u2 && gdi < T(0);
          int_conv = !(u1 || u2 || u3);
          const T tl_new = (u2 || u3) ? t : tl;
          tu = u1 ? t : (u3 ? tl : tu);
          tl = tl_new;
          t = t_new;
        }
      } else if (search == kHZ || search == kHZB) {
        // Hager-Zhang (pallas_driver.py:1483): one evaluation per trip,
        // the best trial returned on exhaustion
        const T t_cap = search == kHZB ? max_feasible_step() : INF;
        const T tiny = (T)QnLit<T>::tiny, big = (T)QnLit<T>::big;
        const T delta = prm.delta, sigma = prm.hz_sigma, theta = prm.hz_theta;
        const T f_eps = f0 + prm.hz_eps * (T)fabs(f0);
        T a = 0, da = g0d, b = big, c = jmin(T(1), t_cap);
        int mode = 0;   // 0 bracket, 1 bisect, 2 secant
        T t_best = c, f_best = big, shrink = big;
        for (int k = 0; k < prm.max_iter_ls; ++k) {
          T fc, dc;
          phi(c, fc, dc);
          const bool ok = (fc - f0 <= delta * c * g0d && dc >= sigma * g0d) ||
                          (dc <= prm.hz_2dm1 * g0d && dc >= sigma * g0d && fc <= f_eps) ||
                          (c >= t_cap && dc < T(0) && fc <= f_eps);
          const bool better = fc < f_best && c > T(0);
          if (ok || better) t_best = c;
          if (better) f_best = fc;
          if (ok) break;
          const bool to_secant = dc >= T(0);
          const bool advance = !to_secant && fc <= f_eps;
          const bool to_bisect = !to_secant && fc > f_eps;
          const T a_new = advance ? c : a;
          const T da_new = advance ? dc : da;
          const T b_new = (to_secant || to_bisect) ? c : b;
          const T grow = jmin(prm.hz_rho * c, t_cap);
          const T bis = prm.hz_1mt * a_new + theta * b_new;
          const T denom = dc - da_new;
          T sec = fabs(denom) > tiny ? (a_new * dc - c * da_new) / denom : bis;
          const T width = b_new - a_new;
          const bool stalled = width > prm.hz_gamma * shrink;
          if (sec <= a_new || sec >= b_new || stalled) sec = T(0.5) * (a_new + b_new);
          const int next_mode = to_secant ? 2 : (to_bisect ? 1 : mode);
          const bool in_bracket = mode == 0 && advance;
          c = in_bracket ? grow : (next_mode == 2 ? sec : bis);
          a = a_new;
          da = da_new;
          b = b_new;
          mode = next_mode;
          shrink = width;
        }
        t = t_best;
      } else {
        // MINPACK dcsrch (pallas_driver.py:1318): the step on a finish
        // exit, the best step stx on exhaustion, 0 for a non-descent d
        const T ginit = g0d, gtest = prm.c1 * ginit, stpmin = prm.stp_min;
        T stpmax = prm.stp_max;
        if (prm.search_bounded) stpmax = jmin(stpmax, max_feasible_step());
        const bool descent = ginit < T(0);
        T stp = descent ? jclip(T(1), stpmin, stpmax) : T(0);
        T stx = 0, fx = f0, dx = ginit, sty = 0, fy = f0, dy = ginit;
        bool brackt = false, stage1 = true;
        T width = stpmax - stpmin, width1 = width / T(0.5);
        T stmin = 0, stmax = stp + prm.xtrapu * stp;
        bool wdone = !descent;
        for (int k = 0; k < prm.max_iter_ls && !wdone; ++k) {
          T ft, gd;
          phi(stp, ft, gd);
          const T ftest = f0 + stp * gtest;
          const bool stage1_n = stage1 && !(ft <= ftest && gd >= T(0));
          const bool finish = (ft <= ftest && fabs(gd) <= prm.c2 * (-ginit)) ||
                              (brackt && stmax - stmin <= prm.xtol * stmax) ||
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
          T sn_ = stp;
          bool br = brackt;
          dcstep(sx, fxm, dxm, sy, fym, dym, sn_, mod ? ft - stp * gtest : ft,
                 mod ? gd - gtest : gd, br, stmin, stmax);
          if (mod) {
            fxm = fxm + sx * gtest;
            fym = fym + sy * gtest;
            dxm = dxm + gtest;
            dym = dym + gtest;
          }
          if (br && fabs(sy - sx) >= T(0.66) * width1) sn_ = sx + T(0.5) * (sy - sx);
          const T width1_n = br ? width : width1;
          const T width_n = br ? (T)fabs(sy - sx) : width;
          const T stmin_n = br ? fmin(sx, sy) : sn_ + prm.xtrapl * (sn_ - sx);
          const T stmax_n = br ? fmax(sx, sy) : sn_ + prm.xtrapu * (sn_ - sx);
          sn_ = jclip(sn_, stpmin, stpmax);
          if (br && (sn_ <= stmin_n || sn_ >= stmax_n || stmax_n - stmin_n <= prm.xtol * stmax_n))
            sn_ = sx;
          stp = sn_;
          stx = sx; fx = fxm; dx = dxm;
          sty = sy; fy = fym; dy = dym;
          brackt = brackt || br;
          stage1 = stage1_n;
          width = width_n;
          width1 = width1_n;
          stmin = stmin_n;
          stmax = stmax_n;
        }
        t = wdone ? stp : stx;
      }
    }
    __syncwarp();
    K3_PHASE(1);

    // ---- step (re-clipped for the bounded methods) and state update
    T fnew;
    if constexpr (kQn) {
      // where t is the last Wolfe trial's step, the step's point is that
      // trial's bit for bit unless the clip of a bounded method moves a
      // coordinate (one vote): its value and gradient (in XT and GN) are
      // kept, and the evaluation the plain version makes there is skipped
      bool kept = t == t_last;
      if (!kept || bounded) {
        bool clipped = false;
        for (int i = lane; i < n; i += kWarp) {
          const T xn = X[i] + t * D[i];
          const T xc = bounded ? jclip(xn, lo[i], up[i]) : xn;
          XT[i] = xc;
          clipped = clipped || xc != xn;
        }
        kept = kept && !__any_sync(kFull, clipped);
      }
      if (kept) {
        fnew = f_last;
        K3_PROF(if (lane == 0) ++prof_acc[9];)
      } else {
        __syncwarp();
        fnew = eval_value_grad(XT, GN);
        __syncwarp();
      }
      K3_PHASE(2);
    } else {
      for (int i = lane; i < n; i += kWarp) {
        const T xn = X[i] + t * D[i];
        XT[i] = bounded ? jclip(xn, lo[i], up[i]) : xn;
      }
      __syncwarp();
      fnew = eval_value_grad(XT, GN);
      __syncwarp();
    }
    if constexpr (kQn) {
      if (lbfgs && compact) {
        // the step's pass: the new pair s = XT - X, y = GN - G and, per
        // slot k, s_k.y and y_k.y (the tables' column for the pair, if it
        // is accepted) and s_k.g', y_k.g' (the next direction's S^T g and
        // Y^T g), the new pair in place of slot head's: kStepSlots slots
        // per transposed butterfly, chronologically from head, so that
        // the first butterfly's lanes 0 and per hold s.y and y.y; max|g'|
        // and whether x moved as votes
        constexpr int kChunks = kLaneM / kStepSlots;
        constexpr int kSums = 4 * kStepSlots;            // sums per butterfly
        static_assert(kSums <= kWarp, "at most 32 sums per butterfly");
        constexpr int per = kWarp / kSums;               // lanes per sum
        const int h = head;
        T gmax = 0, sy = 0, yy = 0;
        bool moved = false, accept = false;
        K3_MARK();
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int j0 = c * kStepSlots;
          if (j0 < m) {
            T acc[kSums];
#pragma unroll
            for (int e = 0; e < kSums; ++e) acc[e] = 0;
            for (int i = lane; i < n; i += kWarp) {
              const T gn = GN[i];
              const T si = XT[i] - X[i], yi = gn - G[i];
              if (c == 0) {
                moved = moved || si != T(0);
                gmax = jmax(gmax, (T)fabs(gn));
              }
#pragma unroll
              for (int k = 0; k < kStepSlots; ++k) {
                const int j = j0 + k;
                if (j < m) {
                  int slot = h + j;
                  if (slot >= m) slot -= m;
                  const T sk = j == 0 ? si : S[(long long)slot * n + i];
                  const T yk = j == 0 ? yi : Y[(long long)slot * n + i];
                  acc[4 * k] += sk * yi;
                  acc[4 * k + 1] += yk * yi;
                  acc[4 * k + 2] += sk * gn;
                  acc[4 * k + 3] += yk * gn;
                }
              }
            }
            K3_SUB(12);
            const T r = warp_sums<kSums>(acc, lane);      // sum lane / per
            K3_SUB(13);
            if (c == 0) {
              // the new pair's s.y and y.y, the first butterfly's first sums
              sy = __shfl_sync(kFull, r, 0);
              yy = __shfl_sync(kFull, r, per);
              accept = sy > prm.lbfgs_eps * yy;
            }
            // the ring update (pallas_driver.py:691-731): an accepted pair
            // goes to slot head with its column of the tables; S^T g and
            // Y^T g of every other slot are the new ones either way
            const int sum = lane / per, kind = sum & 3, j = j0 + (sum >> 2);
            if (j < m) {
              int slot = h + j;
              if (slot >= m) slot -= m;
              if (kind == 0) {
                if (accept) SY[slot * m + h] = r;
              } else if (kind == 1) {
                if (accept) YY[slot * m + h] = YY[h * m + slot] = r;
              } else if (j != 0 || accept) {
                (kind == 2 ? RHO : AL)[slot] = r;
              }
            }
            K3_SUB(14);
          }
        }
        moved = __any_sync(kFull, moved);
        const bool conv = __all_sync(kFull, gmax < prm.tol);
        if (accept) {
          T* s_ = S + (long long)h * n;
          T* y_ = Y + (long long)h * n;
          for (int i = lane; i < n; i += kWarp) {
            s_[i] = XT[i] - X[i];
            y_[i] = GN[i] - G[i];
          }
          if (lane == 0) VAL[h] = 1;
          head = h + 1 == m ? 0 : h + 1;
          gam = sy / yy;
        } else {
          // slot head keeps its pair: its S^T g and Y^T g at the new g
          const T* s_ = S + (long long)h * n;
          const T* y_ = Y + (long long)h * n;
          T acc[2] = {0, 0};
          for (int i = lane; i < n; i += kWarp) {
            acc[0] += s_[i] * GN[i];
            acc[1] += y_[i] * GN[i];
          }
          const T rr = warp_sums<2>(acc, lane);
          if (lane == 0) RHO[h] = rr;
          if (lane == kWarp / 2) AL[h] = rr;
        }
        if (!moved) {
          // the zero-progress repair: the model is dropped, S and Y stay
          for (int e = lane; e < m; e += kWarp) VAL[e] = 0;
          gam = 1;
        }
        T* w = X;
        X = XT;
        XT = w;
        w = G;
        G = GN;
        GN = w;
        Fv = fnew;
        ++iters;
        __syncwarp();
        K3_SUB(14);
        K3_PHASE(3);
        active = isfinite(Fv) && !conv;
        K3_PHASE(4);
        continue;
      }
    }
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
    // the quasi-Newton pair s, y into GP, DP, with its sums; the Newton
    // form's (PN/SPN) into D and XT, spent once the step is taken
    T sy = 0, ss = 0, yy = 0;
    bool moved = false;
    if constexpr (kNewt) {
      for (int i = lane; i < n; i += kWarp) {
        const T s = XT[i] - X[i], y = GN[i] - G[i];
        sy += s * y;
        ss += s * s;
        yy += y * y;
        X[i] = XT[i];
        G[i] = GN[i];
        D[i] = s;
        XT[i] = y;
      }
      sy = warp_sum(sy);
      ss = warp_sum(ss);
      yy = warp_sum(yy);
    } else {
      if (method >= kQN) {
        for (int i = lane; i < n; i += kWarp) {
          const T s = XT[i] - X[i], y = GN[i] - G[i];
          GP[i] = s;
          DP[i] = y;
          sy += s * y;
          ss += s * s;
          yy += y * y;
          moved = moved || s != T(0);
        }
        sy = warp_sum(sy);
        ss = warp_sum(ss);
        yy = warp_sum(yy);
        moved = __any_sync(kFull, moved);
      }
      for (int i = lane; i < n; i += kWarp) {
        if (method == kNCG) {
          GP[i] = G[i];
          DP[i] = D[i];
        }
        X[i] = XT[i];
        G[i] = GN[i];
      }
    }
    ks += 1;
    Fv = fnew;
    ++iters;
    __syncwarp();
    K3_PHASE(kQn ? 3 : 2);

    if constexpr (kNewt) {
      if (method == kPN) {
        sn = sqrt(ss);
        yn = sqrt(yy);
      } else if (method == kSPN) {
        // pallas_driver.py:980-999: with precond_bb, y is replaced by
        // H(x_old)^-1 y from the direction's factor (still in the slab),
        // unless that factor failed or the solve is not finite
        T sy_b = sy;
        if (prm.precond_bb) {
          // y (in XT) solved in place; s in D
          command(kCmdSolve, XT, nullptr);
          bool fin = true;
          T a = 0;
          for (int i = lane; i < n; i += kWarp) {
            fin = fin && isfinite(XT[i]);
            a += D[i] * XT[i];
          }
          a = warp_sum(a);
          if (!fact_bad && __all_sync(kFull, fin)) sy_b = a;
          __syncwarp();
        }
        // sy > 0, not sy <= 0: a NaN pair resets to lambda_max too
        lam = sy_b > T(0) ? jclip(ss / sy_b, prm.lam_min, prm.lam_max) : prm.lam_max;
      }
    }
    if constexpr (kDense) {
      if (method == kQN || method == kQNB) {
        // the dense update (pallas_driver.py:467-588); s in GP, y in DP,
        // B y into D, Broyden's B^T s into XT, each by the block
        const T eps = (T)QnLit<T>::eps;
        const bool pending = prm.restart && pend;
        const T s_norm = sqrt(ss), y_norm = sqrt(yy);
        const bool curv_ok = sy > eps * s_norm * y_norm;
        bool scale_cond = false;
        T gamma = 1;
        if (prm.scale_b0) {
          gamma = curv_ok ? sy / yy : T(1);
          scale_cond = !isfinite(sn) && curv_ok;
        }
        const int upd = prm.qn_update;
        if (pending || scale_cond) {
          for (int i = lane; i < n; i += kWarp) {
            D[i] = pending ? DP[i] : gamma * DP[i];
            if (upd == kBroyden) XT[i] = pending ? GP[i] : gamma * GP[i];
          }
        } else {
          command(kDenseProducts, nullptr, nullptr);
        }
        __syncwarp();
        K3_PHASE(3);
        T yBy = 0, shy_y = 0, shy_sq = 0;
        for (int i = lane; i < n; i += kWarp) {
          yBy += DP[i] * D[i];
          const T shy = GP[i] - D[i];
          shy_y += shy * DP[i];
          shy_sq += shy * shy;
        }
        yBy = warp_sum(yBy);
        shy_y = warp_sum(shy_y);
        shy_sq = warp_sum(shy_sq);
        bool ok;
        T rho = 0, coeff = 0;
        switch (upd) {
          case kBFGS:
            rho = T(1) / sy;
            coeff = rho * rho * yBy + rho;
            ok = curv_ok;
            break;
          case kDFP: ok = curv_ok && yBy > eps * y_norm * y_norm; break;
          case kBroyden: ok = fabs(sy) > eps * s_norm * y_norm; break;
          default: ok = fabs(shy_y) > eps * sqrt(shy_sq) * y_norm; break;
        }
        if (prm.restart) ok = curv_ok;
        ok = ok && s_norm >= prm.tol && y_norm >= prm.tol && isfinite(sy);
        const bool reset = prm.restart && !ok;
        if (ok || reset || pending || scale_cond) {
          // the update by the block: its scalars in words[0..5], its
          // flags in the command word
          if (lane == 0) {
            words[0] = gamma;
            words[1] = rho;
            words[2] = coeff;
            words[3] = sy;
            words[4] = yBy;
            words[5] = shy_y;
          }
          command(kDenseUpdate, nullptr, nullptr,
                  (ok ? 1 : 0) | (reset ? 2 : 0) | (pending ? 4 : 0) | (scale_cond ? 8 : 0));
        }
        pend = false;
        sn = s_norm;
        yn = y_norm;
        stc = (ok && !pending) ? 0 : stc + 1;
        __syncwarp();
        K3_PROF(if (lane == 0) prof_acc[9] += ok;)
        K3_PHASE(4);
      }
    }
    if constexpr (kQn) {
      if (lbfgs) {
        // ring update and the zero-progress repair
        // (pallas_driver.py:691-731)
        if (sy > prm.lbfgs_eps * yy) {
          T* s_ = S + (long long)head * n;
          T* y_ = Y + (long long)head * n;
          for (int i = lane; i < n; i += kWarp) {
            s_[i] = GP[i];
            y_[i] = DP[i];
          }
          if (lane == 0) {
            RHO[head] = T(1) / sy;
            VAL[head] = 1;
          }
          head = (head + 1) % m;
          gam = sy / yy;
        }
        if (!moved) {
          for (int e = lane; e < m; e += kWarp) RHO[e] = VAL[e] = 0;
          gam = 1;
        }
        __syncwarp();
        K3_PHASE(3);
      }
    }
    active = isfinite(Fv) && !converged();
    K3_PHASE(kQn ? 4 : 5);
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
  K3_PROF(if (prof_on && lane == 0) {
    prof_acc[6] = iters;
    prof_acc[7] = nfev;
    prof_acc[8] = 1;
    prof_acc[10] = clock64() - prof_t0;
    for (int k = 0; k < 32; ++k) atomicAdd(&k3_prof[k], (unsigned long long)prof_acc[k]);
  })
  if constexpr (kBlock) {
    __syncwarp();
    if (lane == 0)
      reinterpret_cast<int*>(words + (kNewt ? 24 : kDenseCtl))[0] = kNewt ? (int)kCmdExit : (int)kDenseExit;
    __syncwarp();
    block_bar(kNewt ? kCholThreads : kDenseThreads);   // the worker warps leave
  }
}

// the quasi-Newton and Wolfe forms: one warp per instance, up to
// kMaxWarpsPerBlock instances per block
template <typename T, class Obj, int kForm>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
driver_kernel(const Params<T> prm) {
  driver_body<T, Obj, kForm>(prm);
}

// the Newton form: one block of kCholThreads threads per instance, two
// blocks per SM
template <typename T, class Obj>
__global__ void __launch_bounds__(kCholThreads, 2)
driver_newton_kernel(const Params<T> prm) {
  driver_body<T, Obj, kNewtonForm>(prm);
}

// the dense form: one block of kDenseThreads threads per instance,
// kDenseMinBlocks blocks per SM
template <typename T, class Obj>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
driver_dense_kernel(const Params<T> prm) {
  driver_body<T, Obj, kDenseForm>(prm);
}

template <typename T, class Obj, int kForm>
int launch(const Params<T>& prm, cudaStream_t stream) {
  if constexpr (kForm == kNewtonForm) {
    const long long smem =
        newton_smem_elems<T>(prm.n, prm.ring, prm.rows) * (long long)sizeof(T);
    if (smem > kSmemPerBlock) return kErrSmem;
    if constexpr (Bind<Obj>::kRowBuffers > 0)
      if (Obj::hessian_scratch_elems(prm.n) > newton_region_elems<T>(prm.n)) return kErrSmem;
    auto kernel = driver_newton_kernel<T, Obj>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<prm.B, kCholThreads, smem, stream>>>(prm);
    return (int)cudaGetLastError();
  } else if constexpr (kForm == kDenseForm) {
    const int kind = prm.qn_update, es = (int)sizeof(T);
    const int zrows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
    Params<T> p = prm;
    p.slab_shared = dense_in_shared(prm.n, prm.ring, kind, es, zrows);
    const long long smem = dense_smem_elems(prm.n, prm.ring, kind, es, zrows) * es;
    if (smem > kSmemPerBlock) return kErrSmem;
    if (!p.slab_shared && prm.work == nullptr) return kErrArgs;
    auto kernel = driver_dense_kernel<T, Obj>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<p.B, kDenseThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  } else {
    // the one-warp forms (not instantiated for the block forms: each such
    // kernel cost a minute of the build, never launched)
    const int m = prm.method == kLBFGS ? prm.m : 0;
    const int zrows = Bind<Obj>::kRowBuffers > 0 ? prm.rows : 0;
    const long long per_warp =
        work_elems(prm.n, prm.ring, m, (int)sizeof(T), zrows) * (long long)sizeof(T);
    long long wpb = kSmemPerBlock / per_warp;
    if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
    if (wpb > prm.B) wpb = prm.B;
    if (wpb < 1) return kErrSmem;
    const int smem = (int)(per_warp * wpb);
    auto kernel = driver_kernel<T, Obj, kForm>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (int)((prm.B + wpb - 1) / wpb);
    kernel<<<grid, (int)wpb * kWarp, smem, stream>>>(prm);
    return (int)cudaGetLastError();
  }
}

// L-BFGS in the quasi-Newton form; every other method, a first-order one
// with a Wolfe-family search, in the Wolfe form.  With L-BFGS's registers
// (128 in float32, against 80 before its compact form) NCG + More-Thuente
// at 10,240 x Rosenbrock-100 held 2 blocks of 8 warps per SM, not 3, and
// took 11% longer on an H100
template <typename T, class Obj>
int launch_method(const Params<T>& prm, cudaStream_t stream) {
  if (prm.method == kLBFGS) return launch<T, Obj, kQnForm>(prm, stream);
  return launch<T, Obj, kWolfeForm>(prm, stream);
}

// the quasi-Newton and Wolfe forms of every objective (driver_qn.cu), the
// quadratic and the log-sum-exp in a source of their own (driver_qn_data.cu)
template <typename T>
int launch_qn(const Params<T>& prm, int objective, cudaStream_t stream);
template <typename T>
int launch_qn_data(const Params<T>& prm, int objective, cudaStream_t stream);
// the Newton form of every objective (driver_newton.cu)
template <typename T>
int launch_newton(const Params<T>& prm, int objective, cudaStream_t stream);
// the dense form of every objective (driver_dense.cu), the quadratic and the
// log-sum-exp in a source of their own (driver_dense_data.cu)
template <typename T>
int launch_dense(const Params<T>& prm, int objective, cudaStream_t stream);
template <typename T>
int launch_dense_data(const Params<T>& prm, int objective, cudaStream_t stream);

}  // namespace ost_driver
