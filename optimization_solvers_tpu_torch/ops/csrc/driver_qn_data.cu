// Generic whole-solve driver K3 on Hopper (sm_90a): the quasi-Newton and
// Wolfe forms (driver_qn.cu) for the Quadratic and LogSumExp functors, in
// a source of their own: the build runs one nvcc per source in parallel,
// so its wall is its longest source's, which driver_qn.cu with all four
// functors would lengthen.  The kernel is described in driver.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_qn_data(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kQuadratic) return launch_method<T, Quadratic<T>>(prm, stream);
  if (objective == kLogSumExp) return launch_method<T, LogSumExp<T>>(prm, stream);
  return kErrArgs;
}

template int launch_qn_data<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn_data<double>(const Params<double>&, int, cudaStream_t);

}  // namespace ost_driver
