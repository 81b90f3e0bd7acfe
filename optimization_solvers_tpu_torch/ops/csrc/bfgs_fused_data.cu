// Whole batched dense BFGS solves on Hopper (sm_90a), K9: the LogSumExp
// instances of the kernel in bfgs_fused.cuh, in a source of their own (one
// nvcc a source: they build beside bfgs_fused.cu, which forwards
// bfgs_fused_launch's LOG_SUM_EXP calls here).

#include "bfgs_fused.cuh"

extern "C" int bfgs_fused_data_launch(int dtype, int objective, const void* x0,
                                      const void* d0, const void* d1, int rows, int B, int n,
                                      double tol, int max_iter, int max_iter_ls, double c1,
                                      void* work, void* x, void* f, void* it, void* st,
                                      void* nfev, void* nupd, void* stream) {
  if (objective != kLogSumExp || rows < 1 || d0 == nullptr || d1 == nullptr) return kErrArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, LogSumExp<float>>(
        make_params<float>(x0, d0, d1, rows, B, n, tol, max_iter, max_iter_ls, c1, work, x, f,
                           it, st, nfev, nupd),
        s);
  if (dtype == 1)
    return launch<double, LogSumExp<double>>(
        make_params<double>(x0, d0, d1, rows, B, n, tol, max_iter, max_iter_ls, c1, work, x,
                            f, it, st, nfev, nupd),
        s);
  return kErrArgs;
}
