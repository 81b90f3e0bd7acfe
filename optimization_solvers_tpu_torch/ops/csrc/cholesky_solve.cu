// Batched Cholesky solve K6 on Hopper (sm_90a): x = H^{-1} g for a batch of
// symmetric positive definite H (B, n, n) and g (B, n), one thread block
// per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_newton.py
// (cholesky_solve_pallas, pl.pallas_call at :101; the masked right-looking
// factorization _chol_factor_masked at :30 and the substitutions at :52 and
// :63).  The plain PyTorch version of the same function is
// cholesky_solve_plain in ../fused_newton.py; the two are held against each
// other on the card.
//
// The function: the Cholesky factor L of the matrix whose lower triangle is
// H's (the TPU kernel reads columns below the diagonal too), then forward
// substitution L y = g and back substitution L^T x = y.  A pivot that is
// not positive gives sqrt of a negative number, NaN, which reaches every
// later column, every y and, through the back substitution that starts at
// the last row, every x: such an instance comes back all NaN, as the TPU
// kernel's (and XLA's) does.  H is never written: the factor goes to an
// (n, n) workspace per instance.
//
// What bounds it, and the design: chol_blocked.cuh, shared with K3's
// Newton form.  At config 5's batch (B = 256, n = 1,024, float32) the
// n^3 / 3 operations per instance take 1.4 ms at the card's float32 rate,
// reading H and g once and writing x 0.32 ms; the blocked factorization
// streams the trailing triangle once per panel (~1.7 ms of device-memory
// traffic at NB = 64).  Here: one pass copies the transpose of H's lower
// triangle into the workspace's upper triangle (the routine's layout; 64 x
// 65 shared-memory tiles, coalesced both ways, the next tile's loads in
// flight while one is written), the routine factors the
// workspace in place with the plain-sqrt pivot rule, and solves on the
// right-hand side held in shared memory.  One block of 256 threads per
// instance and ~100 KB of shared memory in float32, so two blocks share an
// SM and a (256, 1,024, 1,024) batch runs in one wave over 132 SMs.

#include "chol_blocked.cuh"

using namespace ost_chol;

namespace {

// the panel width: NB = 64 in float32 (half the trailing traffic of 32,
// and faster on the card; PERF.md has both times), 32 in float64 (the
// largest whose unrolled TRSM column fits the registers of two blocks per
// SM)
template <typename T> struct K6Panel;
template <> struct K6Panel<float> { static constexpr int kNB = 64; };
template <> struct K6Panel<double> { static constexpr int kNB = 32; };

template <typename T, int NB>
constexpr long long k6_smem_elems(int n) {
  return (long long)chol_scratch_elems<T, NB>() + n;
}

template <typename T> struct K6Params {
  const T* h;   // (B, n, n) row-major; only the lower triangle is read
  const T* g;   // (B, n)
  T* work;      // (B, n, n): the factor, upper triangle (U = L^T)
  T* x;         // (B, n)
  int n;
};

template <typename T, int NB>
__global__ void __launch_bounds__(kCholThreads, 2)
cholesky_solve_kernel(K6Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.n, tid = threadIdx.x;
  T* scratch = reinterpret_cast<T*>(smem_raw);
  T* w = scratch + chol_scratch_elems<T, NB>();   // g -> y -> x
  const long long nn = (long long)n * n;
  const T* H = p.h + blockIdx.x * nn;
  T* S = p.work + blockIdx.x * nn;
  for (int i = tid; i < n; i += kCholThreads) w[i] = p.g[(long long)blockIdx.x * n + i];
  upper_from_transpose<T, kTransposed>(S, H, n, scratch, tid);
  chol_factor_blocked<T, NB>(S, n, scratch, tid, PivotPlain{});
  chol_solve_blocked<T, NB>(S, w, scratch, n, tid);
  for (int i = tid; i < n; i += kCholThreads) p.x[(long long)blockIdx.x * n + i] = w[i];
}

template <typename T, int NB>
int k6_launch(const void* h, const void* g, void* work, void* x, int B, int n,
              void* stream) {
  const long long smem = k6_smem_elems<T, NB>(n) * (long long)sizeof(T);
  if (smem > kSmemPerBlock) return kErrSmem;
  K6Params<T> prm;
  prm.h = static_cast<const T*>(h);
  prm.g = static_cast<const T*>(g);
  prm.work = static_cast<T*>(work);
  prm.x = static_cast<T*>(x);
  prm.n = n;
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_solve_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_solve_kernel<T, NB><<<B, kCholThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int k6_panel(int n) {
  constexpr int nb = K6Panel<T>::kNB;
  return k6_smem_elems<T, nb>(n) * (long long)sizeof(T) <= kSmemPerBlock ? nb : 0;
}

}  // namespace

// The panel width the kernel takes for width n (0: n does not fit).
extern "C" int cholesky_solve_panel(int n, int elem_size) {
  if (n < 1) return 0;
  if (elem_size == 4) return k6_panel<float>(n);
  if (elem_size == 8) return k6_panel<double>(n);
  return 0;
}

// dtype 0: float32, 1: float64.  h is (B, n, n) and g (B, n), contiguous;
// work is a (B, n, n) workspace that receives the factors; x receives the
// solutions.  Returns 0, a cudaError_t, or a negative ErrorCode; launches
// on `stream` and does not synchronise.
extern "C" int cholesky_solve_launch(int dtype, const void* h, const void* g,
                                     void* work, void* x, int B, int n,
                                     void* stream) {
  if (B < 1 || n < 1 || h == nullptr || g == nullptr || work == nullptr ||
      x == nullptr)
    return kErrArgs;
  if (dtype == 0)
    return k6_launch<float, K6Panel<float>::kNB>(h, g, work, x, B, n, stream);
  if (dtype == 1)
    return k6_launch<double, K6Panel<double>::kNB>(h, g, work, x, B, n, stream);
  return kErrArgs;
}
