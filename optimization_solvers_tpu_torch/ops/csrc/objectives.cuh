// Warp-level objective functors shared by the one-warp-per-instance kernels
// (K1 lbfgsb_fused.cu and K3 driver.cu): one warp evaluates one instance,
// coordinate i on lane i % 32, and every lane returns the warp-reduced
// value.  The caller __syncwarp()s before a call (the functors read other
// lanes' coordinates of x) and after value_grad (each lane writes only its
// own coordinates of g).  The plain PyTorch forms in core/problems.py use
// the same expressions in the same order.

#pragma once

#include "common.cuh"

namespace {

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

}  // namespace
