// Helpers shared by the kernels of this directory (each source includes
// this header; everything here has internal linkage per source).
//
// min/max/clip propagate NaN as jnp.minimum/jnp.maximum/jnp.clip do
// (fminf/fmin would drop it), and machine epsilon is the JAX kernels'
// literal (1.2e-7 / 2.2e-16), not FLT_EPSILON.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxM = 20;
constexpr long long kSmemPerBlock = 232448;   // 227 KB opt-in per block

// error codes of the C entry points (a cudaError_t is positive)
enum ErrorCode { kErrArgs = -1, kErrSmem = -2 };
// objective functors; K1 and K3 compile the first two (objectives.cuh),
// K2 all four
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

}  // namespace
