// Generic whole-solve driver K3 on Hopper (sm_90a): its quasi-Newton form
// (L-BFGS, and every first-order method with a Wolfe-family search), built
// apart from the first-order form in driver.cu.  The kernel is described
// in driver.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_qn(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>, kQnForm>(prm, stream);
  return launch<T, WeightedSquares<T>, kQnForm>(prm, stream);
}

template int launch_qn<float>(const Params<float>&, int, cudaStream_t);
template int launch_qn<double>(const Params<double>&, int, cudaStream_t);

}  // namespace ost_driver
