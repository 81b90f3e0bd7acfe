// Generic whole-solve driver K3 on Hopper (sm_90a): its quasi-Newton form
// (L-BFGS, and every first-order method with a Wolfe-family search), built
// apart from the first-order form in driver.cu, for Rosenbrock and
// WeightedSquares; the quadratic's and the log-sum-exp's instances are
// built in driver_qn_data.cu.  The kernel is described in driver.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_qn(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kRosenbrock) return launch_method<T, Rosenbrock<T>>(prm, stream);
  if (objective == kWeightedSquares) return launch_method<T, WeightedSquares<T>>(prm, stream);
  return launch_qn_data<T>(prm, objective, stream);
}

template int launch_qn<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn<double>(const Params<double>&, int, cudaStream_t);

template <typename T, int kForm>
int qn_info(int B, int n, int m, int* out) {
  const long long per_warp = work_elems(n, 0, m, (int)sizeof(T)) * (long long)sizeof(T);
  long long wpb = kSmemPerBlock / per_warp;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  if (wpb > B) wpb = B;
  if (wpb < 1) return kErrSmem;
  const int smem = (int)(per_warp * wpb);
  auto kernel = driver_kernel<T, Rosenbrock<T>, kForm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, (int)wpb * kWarp,
                                                        smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)wpb;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  return 0;
}

}  // namespace ost_driver

using namespace ost_driver;

// The launch of the quasi-Newton form (method kLBFGS, memory m) or of the
// Wolfe form (any other method code; m is taken as 0) for Rosenbrock, no
// GLL ring, at batch B and width n: out[0] warps (instances) per block,
// [1] resident blocks per SM (the occupancy calculator), [2] registers and
// [3] local bytes a thread, [4] dynamic shared memory per block.
extern "C" int driver_qn_info(int dtype, int method, int B, int n, int m, int* out) {
  if (B < 1 || n < 1 || m < 0 || out == nullptr) return kErrArgs;
  const bool lbfgs = method == kLBFGS;
  if (!lbfgs) m = 0;
  if (dtype == 0)
    return lbfgs ? qn_info<float, kQnForm>(B, n, m, out) : qn_info<float, kWolfeForm>(B, n, m, out);
  if (dtype == 1)
    return lbfgs ? qn_info<double, kQnForm>(B, n, m, out)
                 : qn_info<double, kWolfeForm>(B, n, m, out);
  return kErrArgs;
}

#ifdef K3_PROFILE
extern "C" int k3_qn_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k3_qn_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k3_prof, z, sizeof(z));
}
#endif
