// Whole batched dense BFGS solves on Hopper (sm_90a), K9: the C interface
// and the Rosenbrock, WeightedSquares and Quadratic instances of the kernel
// in bfgs_fused.cuh (its design and what bounds it are there); the
// LogSumExp instances build in bfgs_fused_data.cu.

#include "bfgs_fused.cuh"

namespace {

template <typename T>
int dispatch(int objective, const Params<T>& prm, cudaStream_t s) {
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>>(prm, s);
  if (prm.d0 == nullptr || prm.d1 == nullptr) return kErrArgs;
  if (objective == kWeightedSquares) return launch<T, WeightedSquares<T>>(prm, s);
  if (objective == kQuadratic) return launch<T, Quadratic<T>>(prm, s);
  return kErrArgs;
}

}  // namespace

// the LogSumExp instances (bfgs_fused_data.cu), with bfgs_fused_launch's
// arguments
extern "C" int bfgs_fused_data_launch(int dtype, int objective, const void* x0,
                                      const void* d0, const void* d1, int rows, int B, int n,
                                      double tol, int max_iter, int max_iter_ls, double c1,
                                      void* work, void* x, void* f, void* it, void* st,
                                      void* nfev, void* nupd, void* stream);

// The launch at width n (Rosenbrock): out[0] threads per block, [1]
// resident blocks per SM (the occupancy calculator), [2] registers and
// [3] local bytes a thread, [4] dynamic shared memory per block, [5] where
// the matrices live (1 shared memory, 2 the workspace).
extern "C" int bfgs_fused_info(int dtype, int n, int* out) {
  if (n < 1 || out == nullptr) return kErrArgs;
  if (dtype == 0) return kernel_info<float, Rosenbrock<float>>(n, out);
  if (dtype == 1) return kernel_info<double, Rosenbrock<double>>(n, out);
  return kErrArgs;
}

#ifdef K9_PROFILE
extern "C" int k9_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k9_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k9_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k9_prof, z, sizeof(z));
}
#endif

// shared memory of one instance's block, in bytes: the vectors (with
// LOG_SUM_EXP's z of `rows`, 0 for the other functors), and the slab where
// it fits
extern "C" long long bfgs_fused_smem(int n, int rows, int elem_size) {
  return smem_elems(n, elem_size, rows) * (long long)elem_size;
}

extern "C" long long bfgs_fused_workspace_elems(long long B, int n, int rows, int elem_size) {
  return workspace_elems(B, n, elem_size, rows);
}

// dtype 0: float32, 1: float64; rows: LOG_SUM_EXP's rows (the other
// functors ignore it).  `work` holds bfgs_fused_workspace_elems(B, n,
// rows) elements of the dtype.  Returns 0, a cudaError_t, or a negative
// ErrorCode; launches on `stream` and does not synchronise.
extern "C" int bfgs_fused_launch(int dtype, int objective, const void* x0,
                                 const void* d0, const void* d1, int rows, int B, int n,
                                 double tol, int max_iter, int max_iter_ls,
                                 double c1, void* work, void* x, void* f,
                                 void* it, void* st, void* nfev, void* nupd,
                                 void* stream) {
  if (B < 1 || n < 1 || rows < 0) return kErrArgs;
  if (objective == kLogSumExp)
    return bfgs_fused_data_launch(dtype, objective, x0, d0, d1, rows, B, n, tol, max_iter,
                                  max_iter_ls, c1, work, x, f, it, st, nfev, nupd, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(objective,
                           make_params<float>(x0, d0, d1, rows, B, n, tol, max_iter,
                                              max_iter_ls, c1, work, x, f, it, st, nfev,
                                              nupd),
                           s);
  if (dtype == 1)
    return dispatch<double>(objective,
                            make_params<double>(x0, d0, d1, rows, B, n, tol, max_iter,
                                                max_iter_ls, c1, work, x, f, it, st, nfev,
                                                nupd),
                            s);
  return kErrArgs;
}
