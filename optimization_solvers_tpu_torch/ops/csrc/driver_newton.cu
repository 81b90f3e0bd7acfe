// Generic whole-solve driver K3 on Hopper (sm_90a): its Newton form (Newton,
// PN and SPN with every search), built apart from the first-order form in
// driver.cu and the quasi-Newton form in driver_qn.cu.  The kernel, its
// one block per instance and what bounds it are described in driver.cuh,
// the blocked factorization and solves in chol_blocked.cuh.

#include "driver.cuh"

namespace ost_driver {

template <typename T>
int launch_newton(const Params<T>& prm, int objective, cudaStream_t stream) {
  if (objective == kRosenbrock) return launch<T, Rosenbrock<T>, kNewtonForm>(prm, stream);
  if (objective == kQuadratic) return launch<T, Quadratic<T>, kNewtonForm>(prm, stream);
  if (objective == kLogSumExp) return launch<T, LogSumExp<T>, kNewtonForm>(prm, stream);
  return launch<T, WeightedSquares<T>, kNewtonForm>(prm, stream);
}

template int launch_newton<float>(const Params<float>&, int, cudaStream_t);
template int launch_newton<double>(const Params<double>&, int, cudaStream_t);

}  // namespace ost_driver
