// Whole batched L-BFGS-B solves on Hopper (sm_90a), one warp per instance:
// the C interface, and the Rosenbrock and WeightedSquares instances of the
// kernel (and their scaled forms).  The kernel, its design and what bounds
// it are in lbfgsb_fused.cuh; the Quadratic and LogSumExp instances build
// in lbfgsb_fused_data.cu.

#include "lbfgsb_fused.cuh"

namespace {

// Rosenbrock and WeightedSquares, and their scaled forms
template <typename T>
int dispatch(int objective, int unbounded, const Params<T>& prm, cudaStream_t stream) {
  const bool scaled = prm.s != nullptr;
  if (objective == kRosenbrock) {
    if (scaled)
      return unbounded ? launch<T, Scaled<Rosenbrock<T>>, true>(prm, stream)
                       : launch<T, Scaled<Rosenbrock<T>>, false>(prm, stream);
    return unbounded ? launch<T, Rosenbrock<T>, true>(prm, stream)
                     : launch<T, Rosenbrock<T>, false>(prm, stream);
  }
  if (prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
  if (objective == kWeightedSquares) {
    if (scaled)
      return unbounded ? launch<T, Scaled<WeightedSquares<T>>, true>(prm, stream)
                       : launch<T, Scaled<WeightedSquares<T>>, false>(prm, stream);
    return unbounded ? launch<T, WeightedSquares<T>, true>(prm, stream)
                     : launch<T, WeightedSquares<T>, false>(prm, stream);
  }
  return kErrArgs;
}

template <typename T>
int info_dispatch(int objective, int unbounded, int scaled, int B, int n, int m, int rows,
                  int* out) {
  if (objective == kRosenbrock) {
    if (scaled)
      return unbounded ? kernel_info<T, Scaled<Rosenbrock<T>>, true>(B, n, m, rows, out)
                       : kernel_info<T, Scaled<Rosenbrock<T>>, false>(B, n, m, rows, out);
    return unbounded ? kernel_info<T, Rosenbrock<T>, true>(B, n, m, rows, out)
                     : kernel_info<T, Rosenbrock<T>, false>(B, n, m, rows, out);
  }
  if (objective == kWeightedSquares) {
    if (scaled)
      return unbounded ? kernel_info<T, Scaled<WeightedSquares<T>>, true>(B, n, m, rows, out)
                       : kernel_info<T, Scaled<WeightedSquares<T>>, false>(B, n, m, rows, out);
    return unbounded ? kernel_info<T, WeightedSquares<T>, true>(B, n, m, rows, out)
                     : kernel_info<T, WeightedSquares<T>, false>(B, n, m, rows, out);
  }
  return kErrArgs;
}

}  // namespace

// the Quadratic and LogSumExp instances (lbfgsb_fused_data.cu), with the
// arguments of lbfgsb_fused_launch and lbfgsb_fused_kernel_info
extern "C" int lbfgsb_fused_data_launch(
    int dtype, int objective, int unbounded, const void* x0, const void* lo,
    const void* up, int bstride, const void* d0, const void* d1, int rows,
    const void* s, int B, int n, int m, double pgtol, double factr,
    int max_iter, int max_iter_ls, double c1, void* x, void* f, void* it,
    void* st, void* stream);
extern "C" int lbfgsb_fused_data_kernel_info(int dtype, int objective, int unbounded,
                                             int scaled, int B, int n, int m, int rows,
                                             int* out);

// rows: LOG_SUM_EXP's (0 for the other functors)
extern "C" long long lbfgsb_fused_smem_per_warp(int n, int m, int elem_size, int rows) {
  return work_bytes(n, m, elem_size, rows);
}

// dtype 0: float32, 1: float64; rows: LOG_SUM_EXP's rows (the other
// functors ignore it); s: the scaled form's sqrt(diag), (n,), or null for
// the unscaled kernel (Rosenbrock and WeightedSquares only).  Returns 0, a
// cudaError_t, or a negative ErrorCode; launches on `stream` and does not
// synchronise.
extern "C" int lbfgsb_fused_launch(
    int dtype, int objective, int unbounded, const void* x0, const void* lo,
    const void* up, int bstride, const void* d0, const void* d1, int rows,
    const void* s, int B, int n, int m, double pgtol, double factr,
    int max_iter, int max_iter_ls, double c1, void* x, void* f, void* it,
    void* st, void* stream) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM || (bstride != 0 && bstride != n) || rows < 0)
    return kErrArgs;
  if (objective == kQuadratic || objective == kLogSumExp)
    return lbfgsb_fused_data_launch(dtype, objective, unbounded, x0, lo, up, bstride, d0, d1,
                                    rows, s, B, n, m, pgtol, factr, max_iter, max_iter_ls,
                                    c1, x, f, it, st, stream);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(objective, unbounded,
                           make_params<float>(x0, lo, up, bstride, d0, d1, rows, s, B, n, m,
                                              pgtol, factr, max_iter, max_iter_ls, c1, x,
                                              f, it, st),
                           cs);
  if (dtype == 1)
    return dispatch<double>(objective, unbounded,
                            make_params<double>(x0, lo, up, bstride, d0, d1, rows, s, B, n,
                                                m, pgtol, factr, max_iter, max_iter_ls, c1,
                                                x, f, it, st),
                            cs);
  return kErrArgs;
}

// the launch configuration and the compiled kernel's resources for one
// call's shape (see kernel_info; rows: LOG_SUM_EXP's), of the scaled form
// if `scaled`; returns 0, a cudaError_t or an ErrorCode
extern "C" int lbfgsb_fused_kernel_info(int dtype, int objective, int unbounded,
                                        int scaled, int B, int n, int m, int rows, int* out) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM || rows < 0) return kErrArgs;
  if (objective == kQuadratic || objective == kLogSumExp)
    return lbfgsb_fused_data_kernel_info(dtype, objective, unbounded, scaled, B, n, m, rows,
                                         out);
  if (dtype == 0) return info_dispatch<float>(objective, unbounded, scaled, B, n, m, rows, out);
  if (dtype == 1) return info_dispatch<double>(objective, unbounded, scaled, B, n, m, rows, out);
  return kErrArgs;
}

#ifdef K1_PROFILE
extern "C" int k1_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k1_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k1_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k1_prof, z, sizeof(z));
}
#endif

extern "C" const char* ost_error_string(int code) {
  if (code == kErrArgs) return "invalid arguments";
  if (code == kErrSmem) return "shared memory per instance exceeds a block's";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
