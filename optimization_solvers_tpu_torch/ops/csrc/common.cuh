// Helpers shared by the kernels of this directory (each source includes
// this header; everything here has internal linkage per source): NaN-aware
// min/max/clip and sign, warp reductions, and MINPACK-2 dcstep.
//
// min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do
// (fminf/fmin would drop it), and machine epsilon is the JAX kernels'
// literal (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxM = 20;
constexpr long long kSmemPerBlock = 232448;   // 227 KB opt-in per block

// error codes of the C entry points (a cudaError_t is positive)
enum ErrorCode { kErrArgs = -1, kErrSmem = -2 };
// objective functors; K1, K3 and K8 compile the first two (objectives.cuh),
// K4, K7 and K9 the first three, K2 all four
enum ObjectiveCode {
  kRosenbrock = 0, kWeightedSquares = 1, kQuadratic = 2, kLogSumExp = 3
};

template <typename T> struct Lit;
template <> struct Lit<float> { static constexpr double eps = 1.2e-7; };
template <> struct Lit<double> { static constexpr double eps = 2.2e-16; };

template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}
template <typename T> __device__ __forceinline__ T jclip(T x, T lo, T up) {
  return jmin(jmax(x, lo), up);
}

// jnp.sign: 0, -0 and NaN pass through
template <typename T> __device__ __forceinline__ T jsign(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : v);
}

// One barrier of a block's first `threads` threads (barrier 1, not
// __syncthreads' barrier 0): non-aligned, so a warp may reach it from inside
// divergent control flow.  Every block barrier of K3's block forms and K9
// goes through here; the tests' CPU warp emulator defines OST_EMULATED and
// its own block_bar.
#ifndef OST_EMULATED
__device__ __forceinline__ void block_bar(int threads) {
  asm volatile("barrier.sync 1, %0;" ::"r"(threads) : "memory");
}
#endif

// Asynchronous bulk copies from device memory to shared memory through the
// mbarrier `bar` (8 bytes of shared memory, 8-byte aligned), which thread 0
// of the block initialises once with bulk_barrier_init before the first
// copy.  bulk_copy(dst, src, count, ...), called by every thread, copies
// `count` elements to `dst`, which the caller places to agree with src
// modulo 16 bytes: thread 0 starts the tensor memory accelerator's
// cp.async.bulk of the 16-byte-aligned middle, which completes on `bar`,
// and the block's `nthreads` threads (this one is `tid`) copy the ends
// element by element.  After a block barrier (which publishes the ends and
// the barrier's initialisation) every thread calls bulk_copy_wait with what
// bulk_copy returned and the barrier's phase (0 for its first copy, then
// alternating) before it reads dst; the wait traps rather than hang should
// the copy never complete.  The tests' CPU warp emulator (OST_EMULATED)
// copies at once and waits for nothing.
#ifndef OST_EMULATED
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bulk_barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void bulk_copy_start(void* dst, const void* src,
                                                unsigned bytes, unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy_wait(bool started, unsigned long long* bar,
                                               unsigned phase) {
  if (!started) return;
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
    if (spins > (1LL << 26)) __trap();
  }
}
#else
inline void bulk_barrier_init(unsigned long long*) {}
inline void bulk_copy_start(void* dst, const void* src, unsigned bytes,
                            unsigned long long*) {
  memcpy(dst, src, bytes);
}
inline void bulk_copy_wait(bool, unsigned long long*, unsigned) {}
#endif
template <typename T>
__device__ __forceinline__ bool bulk_copy(T* dst, const T* src, long long count,
                                          int tid, int nthreads, unsigned long long* bar) {
  long long head =
      ((16 - (int)(reinterpret_cast<uintptr_t>(src) & 15)) & 15) / (int)sizeof(T);
  if (head > count) head = count;
  const long long bytes = (count - head) * (long long)sizeof(T) / 16 * 16;
  const long long tail = head + bytes / (long long)sizeof(T);
  if (tid == 0 && bytes > 0) bulk_copy_start(dst + head, src + head, (unsigned)bytes, bar);
  for (long long k = tid; k < head; k += nthreads) dst[k] = src[k];
  for (long long k = tail + tid; k < count; k += nthreads) dst[k] = src[k];
  return bytes > 0;
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

// one halving exchange of warp_sums, at W sums per lane, then the next (a
// template level each, so that every loop unrolls and v stays in registers)
template <int W, int K, typename T> __device__ __forceinline__ void halve(T (&v)[K], int lane) {
  constexpr int h = W / 2, o = 16 * W / K;
  const bool hi = lane & o;
#pragma unroll
  for (int j = 0; j < h; ++j) {
    const T send = hi ? v[j] : v[j + h];
    const T keep = hi ? v[j + h] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, o);
  }
  if constexpr (h > 1) halve<h, K>(v, lane);
}

// K independent warp sums (K a power of two up to 32) in one transposed
// butterfly: log2(K) halving exchanges, each lane keeping half of its sums
// and sending the other half, then 5 - log2(K) plain butterfly steps; K - 1
// + 5 - log2(K) shuffles in five levels.  Returns sum number lane / (32 / K)
// on each lane; every pairing tree is the same, so the 32 / K lanes that
// hold a sum hold the same bits, and equal inputs give equal sums.  v is
// clobbered.
template <int K, typename T> __device__ __forceinline__ T warp_sums(T (&v)[K], int lane) {
  if constexpr (K > 1) halve<K, K>(v, lane);
  T r = v[0];
#pragma unroll
  for (int o = 16 / K; o > 0; o >>= 1) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

// MINPACK-2 dcstep on replicated scalars, shared by K2's dcsrch mode and
// K3's StrongWolfe search (optimization_solvers_tpu/linesearch/dcsrch.py
// _dcstep, NaN handling included: a NaN trial value counts as higher, a
// NaN trial polynomial bisects the bracket)
template <typename T>
__device__ void dcstep(T& stx, T& fx, T& dx, T& sty, T& fy, T& dy, T& stp,
                       T fp, T dp, bool& brackt, T stmin, T stmax) {
  const T sgnd = dp * jsign(dx);
  const T theta = T(3) * (fx - fp) / (stp - stx) + dx + dp;
  const T s = jmax(jmax((T)fabs(theta), (T)fabs(dx)), (T)fabs(dp));
  const T gsq = (theta / s) * (theta / s) - (dx / s) * (dp / s);
  const T gamma = s * sqrt(jmax(gsq, T(0)));

  const T g1 = stp < stx ? -gamma : gamma;
  const T p1 = (g1 - dx) + theta;
  const T q1 = ((g1 - dx) + g1) + dp;
  const T stpc1 = stx + (p1 / q1) * (stp - stx);
  const T stpq1 = stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / T(2)) * (stp - stx);
  const bool case1 = !(fp <= fx);
  const T stpf1 = fabs(stpc1 - stx) < fabs(stpq1 - stx) ? stpc1
                                                        : stpc1 + (stpq1 - stpc1) / T(2);

  const T g2 = stp > stx ? -gamma : gamma;
  const T p2 = (g2 - dp) + theta;
  const T q2 = ((g2 - dp) + g2) + dx;
  const T stpc2 = stp + (p2 / q2) * (stx - stp);
  const T stpq2 = stp + (dp / (dp - dx)) * (stx - stp);
  const bool case2 = !case1 && sgnd < T(0);
  const T stpf2 = fabs(stpc2 - stp) > fabs(stpq2 - stp) ? stpc2 : stpq2;

  const T g3 = g2;
  const T p3 = (g3 - dp) + theta;
  const T q3 = (g3 + (dx - dp)) + g3;
  const T r3 = p3 / q3;
  const T stpc3 = (r3 < T(0) && g3 != T(0)) ? stp + r3 * (stx - stp)
                                             : (stp > stx ? stmax : stmin);
  const T stpq3 = stp + (dp / (dp - dx)) * (stx - stp);
  const bool case3 = !case1 && !case2 && fabs(dp) < fabs(dx);
  const T near3 = fabs(stpc3 - stp) < fabs(stpq3 - stp) ? stpc3 : stpq3;
  const T cap3 = stp + T(0.66) * (sty - stp);
  const T stpf3_b = stp > stx ? jmin(cap3, near3) : jmax(cap3, near3);
  const T stpf3_f =
      jclip(fabs(stpc3 - stp) > fabs(stpq3 - stp) ? stpc3 : stpq3, stmin, stmax);
  const T stpf3 = brackt ? stpf3_b : stpf3_f;

  const T theta4 = T(3) * (fp - fy) / (sty - stp) + dy + dp;
  const T s4 = jmax(jmax((T)fabs(theta4), (T)fabs(dy)), (T)fabs(dp));
  const T gamma4 =
      s4 * sqrt(jmax((theta4 / s4) * (theta4 / s4) - (dy / s4) * (dp / s4), T(0)));
  const T g4 = stp > sty ? -gamma4 : gamma4;
  const T p4 = (g4 - dp) + theta4;
  const T q4 = ((g4 - dp) + g4) + dy;
  const T stpc4 = stp + (p4 / q4) * (sty - stp);
  const T stpf4 = brackt ? stpc4 : (stp > stx ? stmax : stmin);

  T stpf = case1 ? stpf1 : (case2 ? stpf2 : (case3 ? stpf3 : stpf4));
  const bool nbr = brackt || case1 || case2;

  const T sty_n = case1 ? stp : (sgnd < T(0) ? stx : sty);
  const T fy_n = case1 ? fp : (sgnd < T(0) ? fx : fy);
  const T dy_n = case1 ? dp : (sgnd < T(0) ? dx : dy);
  const T stx_n = case1 ? stx : stp;
  const T fx_n = case1 ? fx : fp;
  const T dx_n = case1 ? dx : dp;

  stpf = jclip(stpf, stmin, stmax);
  if (stpf != stpf) stpf = nbr ? stx_n + T(0.5) * (sty_n - stx_n) : stmin;
  stx = stx_n;
  fx = fx_n;
  dx = dx_n;
  sty = sty_n;
  fy = fy_n;
  dy = dy_n;
  stp = stpf;
  brackt = nbr;
}

}  // namespace
