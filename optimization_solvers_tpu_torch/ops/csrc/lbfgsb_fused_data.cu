// Whole batched L-BFGS-B solves on Hopper (sm_90a): the Quadratic and
// LogSumExp instances of the kernel in lbfgsb_fused.cuh, in a source of
// their own (one nvcc a source: they build beside lbfgsb_fused.cu).  The
// scaled form does not take them.  lbfgsb_fused_launch and
// lbfgsb_fused_kernel_info (lbfgsb_fused.cu) forward their codes here.

#include "lbfgsb_fused.cuh"

namespace {

template <typename T>
int dispatch_data(int objective, int unbounded, const Params<T>& prm, cudaStream_t stream) {
  if (prm.s != nullptr || prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
  if (objective == kQuadratic)
    return unbounded ? launch<T, Quadratic<T>, true>(prm, stream)
                     : launch<T, Quadratic<T>, false>(prm, stream);
  if (objective == kLogSumExp && prm.rows >= 1)
    return unbounded ? launch<T, LogSumExp<T>, true>(prm, stream)
                     : launch<T, LogSumExp<T>, false>(prm, stream);
  return kErrArgs;
}

template <typename T>
int info_dispatch_data(int objective, int unbounded, int B, int n, int m, int rows, int* out) {
  if (objective == kQuadratic)
    return unbounded ? kernel_info<T, Quadratic<T>, true>(B, n, m, rows, out)
                     : kernel_info<T, Quadratic<T>, false>(B, n, m, rows, out);
  if (objective == kLogSumExp)
    return unbounded ? kernel_info<T, LogSumExp<T>, true>(B, n, m, rows, out)
                     : kernel_info<T, LogSumExp<T>, false>(B, n, m, rows, out);
  return kErrArgs;
}

}  // namespace

extern "C" int lbfgsb_fused_data_launch(
    int dtype, int objective, int unbounded, const void* x0, const void* lo,
    const void* up, int bstride, const void* d0, const void* d1, int rows,
    const void* s, int B, int n, int m, double pgtol, double factr,
    int max_iter, int max_iter_ls, double c1, void* x, void* f, void* it,
    void* st, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_data<float>(objective, unbounded,
                                make_params<float>(x0, lo, up, bstride, d0, d1, rows, s, B,
                                                   n, m, pgtol, factr, max_iter, max_iter_ls,
                                                   c1, x, f, it, st),
                                cs);
  if (dtype == 1)
    return dispatch_data<double>(objective, unbounded,
                                 make_params<double>(x0, lo, up, bstride, d0, d1, rows, s,
                                                     B, n, m, pgtol, factr, max_iter,
                                                     max_iter_ls, c1, x, f, it, st),
                                 cs);
  return kErrArgs;
}

extern "C" int lbfgsb_fused_data_kernel_info(int dtype, int objective, int unbounded,
                                             int scaled, int B, int n, int m, int rows,
                                             int* out) {
  if (scaled) return kErrArgs;
  if (dtype == 0) return info_dispatch_data<float>(objective, unbounded, B, n, m, rows, out);
  if (dtype == 1) return info_dispatch_data<double>(objective, unbounded, B, n, m, rows, out);
  return kErrArgs;
}
