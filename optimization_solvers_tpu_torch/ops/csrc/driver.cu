// Generic whole-solve driver K3 on Hopper (sm_90a): its C interface and its
// first-order form (driver_first.cuh).  The kernel template, its other
// forms' design and what bounds them are described in driver.cuh; the
// quasi-Newton and Wolfe forms are built in driver_qn.cu and
// driver_qn_data.cu, the dense form in driver_dense.cu and
// driver_dense_data.cu, the Newton form in driver_newton.cu.

#include "driver_first.cuh"

using namespace ost_driver;

namespace {

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        int bstride, const void* d0, const void* d1, const void* pinv, int B,
        int n, const int* ip, const double* dp, int max_iter, int max_iter_ls,
        void* work, void* x, void* f, void* it, void* st, void* nfev,
        void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.bstride = bstride;
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.pinv = static_cast<const T*>(pinv);
  prm.B = B;
  prm.n = n;
  prm.method = ip[iMethod];
  prm.search = ip[iSearch];
  prm.alternate = ip[iAlternate];
  prm.ncg_variant = ip[iNcgVariant];
  prm.restart_every = ip[iRestartEvery];
  prm.ring = ip[iRing];
  prm.qn_update = ip[iQnUpdate];
  prm.scale_b0 = ip[iScaleB0];
  prm.restart = ip[iRestart];
  prm.m = ip[iLbfgsM];
  prm.approx_wolfe = ip[iApproxWolfe];
  prm.search_bounded = ip[iSearchBounded];
  prm.precond_bb = ip[iPrecondBB];
  prm.rows = objective == kLogSumExp ? ip[iRows] : 0;
  prm.tol = (T)dp[dTol];
  prm.lam_min = (T)dp[dLamMin];
  prm.lam_max = (T)dp[dLamMax];
  prm.c1 = (T)dp[dC1];
  prm.beta = (T)dp[dBeta];
  prm.sigma1 = (T)dp[dSigma1];
  prm.sigma2 = (T)dp[dSigma2];
  prm.lbfgs_eps = (T)dp[dLbfgsEps];
  prm.c2 = (T)dp[dC2];
  prm.t_min = (T)dp[dTMin];
  prm.t_max = (T)dp[dTMax];
  prm.delta = (T)dp[dDelta];
  prm.aw_eps = (T)dp[dAwEps];
  prm.hz_sigma = (T)dp[dHzSigma];
  prm.hz_eps = (T)dp[dHzEps];
  prm.hz_theta = (T)dp[dHzTheta];
  prm.hz_gamma = (T)dp[dHzGamma];
  prm.hz_rho = (T)dp[dHzRho];
  prm.xtol = (T)dp[dXtol];
  prm.stp_min = (T)dp[dStpMin];
  prm.stp_max = (T)dp[dStpMax];
  prm.xtrapl = (T)dp[dXtrapl];
  prm.xtrapu = (T)dp[dXtrapu];
  prm.aw_fac = (T)(2.0 * dp[dC1] - 1.0);
  prm.hz_2dm1 = (T)(2.0 * dp[dDelta] - 1.0);
  prm.hz_1mt = (T)(1.0 - dp[dHzTheta]);
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.slab_shared = 0;
  prm.work = static_cast<T*>(work);
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.nfev_out = static_cast<int*>(nfev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool newton = newton_method(prm.method);
  // the first-order form compiles Rosenbrock and WeightedSquares, the
  // other forms all four functors
  const bool all_four = newton || dense_method(prm.method) || qn_form(prm.method, prm.search);
  if (objective < kRosenbrock || objective > kLogSumExp ||
      (!all_four && objective != kRosenbrock && objective != kWeightedSquares))
    return kErrArgs;
  if (objective == kLogSumExp && prm.rows < 1) return kErrArgs;
  if (objective != kRosenbrock && (d0 == nullptr || d1 == nullptr)) return kErrArgs;
  if (newton) return launch_newton<T>(prm, objective, s);
  if (dense_method(prm.method)) return launch_dense<T>(prm, objective, s);
  if (qn_form(prm.method, prm.search)) return launch_qn<T>(prm, objective, s);
  if (objective == kRosenbrock) return launch_first<T, Rosenbrock<T>>(prm, s);
  return launch_first<T, WeightedSquares<T>>(prm, s);
}

}  // namespace

// The launch of the first-order form for the weighted-squares functor at
// batch B and width n with a GLL ring of `ring` and method code `method`:
// out[0] warps (instances) per block, [1] resident blocks per SM (the
// occupancy calculator), [2] registers and [3] local bytes a thread, [4]
// dynamic shared memory per block, [5] the coordinates a lane holds in
// registers (0: the shared-memory layout).
extern "C" int driver_first_info(int dtype, int B, int n, int ring, int method, int* out) {
  if (B < 1 || n < 1 || ring < 0 || out == nullptr) return kErrArgs;
  auto info = [&](auto zero) {
    using T = decltype(zero);
    Params<T> prm{};
    prm.B = B;
    prm.n = n;
    prm.ring = ring;
    prm.method = method;
    return first_order_info_for<T>(prm, out);
  };
  if (dtype == 0) return info(0.0f);
  if (dtype == 1) return info(0.0);
  return kErrArgs;
}

#ifdef K3_PROFILE
extern "C" int k3_fo_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k3_prof, sizeof(unsigned long long) * 32);
}
extern "C" int k3_fo_prof_reset() {
  const unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(k3_prof, z, sizeof(z));
}
#endif

// shared memory of a warp (one instance) of the quasi-Newton and Wolfe
// forms, in bytes; rows: LOG_SUM_EXP's (0 for the other functors)
extern "C" long long driver_smem_per_warp(int n, int ring, int m, int rows, int elem_size) {
  return work_elems(n, ring, m, elem_size, rows) * (long long)elem_size;
}

// shared memory of the Newton form's block (one instance), in bytes;
// rows: LOG_SUM_EXP's (0 for the other functors)
extern "C" long long driver_smem_newton(int n, int ring, int rows, int elem_size) {
  return (elem_size == 8 ? newton_smem_elems<double>(n, ring, rows)
                         : newton_smem_elems<float>(n, ring, rows)) * (long long)elem_size;
}

// shared memory of the dense form's block (one instance), in bytes: its
// vectors (with LOG_SUM_EXP's z of `rows`), and the slab where
// dense_in_shared says it fits
extern "C" long long driver_smem_dense(int n, int ring, int kind, int rows, int elem_size) {
  return dense_smem_elems(n, ring, kind, elem_size, rows) * (long long)elem_size;
}

extern "C" long long driver_workspace_elems(long long B, int n, int method, int ring,
                                            int kind, int rows, int elem_size) {
  return workspace_elems(B, n, method, ring, kind, elem_size, rows);
}

// dtype 0: float32, 1: float64.  ip and dp are host arrays of kIntSlots ints
// and kDoubleSlots doubles (IntSlot, DoubleSlot); work is the device
// workspace of driver_workspace_elems elements (nullptr when 0).  Returns
// 0, a cudaError_t, or a negative ErrorCode; launches on `stream` and does
// not synchronise.
extern "C" int driver_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    int bstride, const void* d0, const void* d1, const void* pinv, int B,
    int n, const int* ip, const double* dp, int max_iter, int max_iter_ls,
    void* work, void* x, void* f, void* it, void* st, void* nfev,
    void* stream) {
  if (ip == nullptr || dp == nullptr) return kErrArgs;
  const int method = ip[iMethod], search = ip[iSearch];
  const bool bounded = bounded_method(method);
  const bool bounded_search = search == kBTB || search == kMTB ||
                              search == kHZB || (search == kSW && ip[iSearchBounded]);
  if (B < 1 || n < 1 || method < kGD || method > kSPN || search < kNoSearch ||
      search > kSW || (bstride != 0 && bstride != n) ||
      (bounded && (lo == nullptr || up == nullptr)) ||
      (bounded_search && !bounded) || (search == kGLL) != (ip[iRing] > 0) ||
      (method == kPnorm && pinv == nullptr) ||
      (method == kLBFGS && ip[iLbfgsM] < 1) ||
      (dense_method(method) && (ip[iQnUpdate] < kBFGS || ip[iQnUpdate] > kSR1)) ||
      (workspace_elems(B, n, method, ip[iRing], ip[iQnUpdate], dtype == 1 ? 8 : 4,
                       objective == kLogSumExp ? ip[iRows] : 0) > 0 &&
       work == nullptr))
    return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, bstride, d0, d1, pinv, B, n, ip,
                      dp, max_iter, max_iter_ls, work, x, f, it, st, nfev,
                      stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, bstride, d0, d1, pinv, B, n, ip,
                       dp, max_iter, max_iter_ls, work, x, f, it, st, nfev,
                       stream);
  return kErrArgs;
}
