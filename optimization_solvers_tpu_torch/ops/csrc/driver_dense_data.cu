// Generic whole-solve driver K3 on Hopper (sm_90a): the dense form
// (driver_dense.cu) for the Quadratic and LogSumExp functors, in a source of
// their own (one nvcc a source: the build's wall is its longest source's,
// which driver_dense.cu with all four functors would lengthen).  Warp 0
// evaluates them alone, the log-sum-exp's z in the block's shared memory
// ahead of the slab.  The kernel is described in driver.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_dense_data(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kQuadratic) return launch<T, Quadratic<T>, kDenseForm>(prm, stream);
  if (objective == kLogSumExp) return launch<T, LogSumExp<T>, kDenseForm>(prm, stream);
  return kErrArgs;
}

template int launch_dense_data<float>(const Params<float>&, int, cudaStream_t);
template int launch_dense_data<double>(const Params<double>&, int, cudaStream_t);

}  // namespace ost_driver
