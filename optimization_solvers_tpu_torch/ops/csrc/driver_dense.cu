// Generic whole-solve driver K3 on Hopper (sm_90a): its dense form (the
// dense quasi-Newton methods QN and QNB with every update kind and search,
// one block per instance, the slab in shared memory where it fits), built
// apart from the other forms, for Rosenbrock and WeightedSquares; the
// quadratic's and the log-sum-exp's instances are built in
// driver_dense_data.cu.  The kernel is described in driver.cuh, the
// slab's layouts and passes in dense_slab.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_dense(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>, kDenseForm>(prm, stream);
  if (objective == kWeightedSquares)
    return launch<T, WeightedSquares<T>, kDenseForm>(prm, stream);
  return launch_dense_data<T>(prm, objective, stream);
}

template int launch_dense<float>(const Params<float>&, int, cudaStream_t);
template int launch_dense<double>(const Params<double>&, int, cudaStream_t);

template <typename T>
int dense_info(int n, int ring, int kind, int* out) {
  const int es = (int)sizeof(T);
  const long long smem = dense_smem_elems(n, ring, kind, es) * es;
  if (smem > kSmemPerBlock) return kErrSmem;
  auto kernel = driver_dense_kernel<T, Rosenbrock<T>>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kDenseThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kDenseThreads;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)smem;
  out[5] = dense_in_shared(n, ring, kind, es) ? 1 : 2;
  return 0;
}

}  // namespace ost_driver

using namespace ost_driver;

// The dense form's launch at width n (Rosenbrock): out[0] threads per
// block, [1] resident blocks per SM (the occupancy calculator), [2]
// registers and [3] local bytes a thread, [4] dynamic shared memory per
// block, [5] where the slabs live (1 shared memory, 2 the workspace).
extern "C" int driver_dense_info(int dtype, int n, int ring, int kind, int* out) {
  if (n < 1 || ring < 0 || kind < kBFGS || kind > kSR1 || out == nullptr) return kErrArgs;
  if (dtype == 0) return dense_info<float>(n, ring, kind, out);
  if (dtype == 1) return dense_info<double>(n, ring, kind, out);
  return kErrArgs;
}

#ifdef K3_PROFILE
extern "C" int k3_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k3_prof_reset() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k3_prof, z, sizeof(z));
}
#endif
