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
// What bounds it on this card: at the lockstep Newton path's shape (config
// 5: B = 256, n = 1,024, float32) the n^3 / 3 operations per instance, 9.3e10
// in all, take 1.4 ms at the card's float32 rate; reading H and g once and
// writing x, 1.07 GB, takes 0.32 ms.  The TPU kernel keeps the whole (n, n)
// matrix in VMEM and updates all of it n times.  A block's shared memory
// holds a 1,024-wide matrix in neither type, so the design streams it:
//  * right-looking by panels of nb columns (nb = 32 in float32 and 16 in
//    float64 at n = 1,024, the widest power of two up to 32 whose panel
//    fits shared memory): the panel, rows k..n-1 of columns k..k+nb-1, is
//    loaded into shared memory column-major, factored there column by
//    column, and written to the workspace (row-major, lower triangle);
//  * the trailing lower triangle takes the panel's rank-nb update in one
//    pass: one warp per row, lanes over columns (coalesced), the row's nb
//    panel values in registers, the columns' from shared memory without
//    bank conflicts.  So the workspace is read and written n / nb times,
//    not n times (the first panel reads H and writes the workspace);
//  * the forward substitution runs panel by panel beside the factorization
//    (the panel is in shared memory then), the back substitution panel by
//    panel in reverse, reloading each panel; y and x live in shared memory.
// One block of 512 threads per instance; a (256, 1,024, 1,024) batch runs
// in two waves over 132 SMs.

#include "common.cuh"

namespace {

constexpr int kK6Threads = 512;
constexpr int kK6MaxPanel = 32;

__host__ __device__ inline long long k6_smem_elems(int n, int nb) {
  return (long long)nb * n + n + nb;
}

// the widest panel (a power of two up to 32) whose shared memory fits a
// block; 0 when not even one column fits
inline int k6_panel(int n, int elem_size) {
  for (int nb = kK6MaxPanel; nb >= 1; nb >>= 1)
    if (k6_smem_elems(n, nb) * elem_size <= kSmemPerBlock) return nb;
  return 0;
}

template <typename T> struct K6Params {
  const T* h;   // (B, n, n) row-major; only the lower triangle is read
  const T* g;   // (B, n)
  T* work;      // (B, n, n): the factor L, row-major lower triangle
  T* x;         // (B, n)
  int n;
  int nb;
};

template <typename T>
__global__ void __launch_bounds__(kK6Threads)
cholesky_solve_kernel(K6Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  const int n = p.n, nb = p.nb;
  T* P = reinterpret_cast<T*>(smem_raw);   // panel: column c at P + c * rows
  T* r = P + (long long)nb * n;            // rhs -> y -> x
  T* red = r + n;                          // nb partial sums
  const long long nn = (long long)n * n;
  const T* H = p.h + (long long)blockIdx.x * nn;
  T* L = p.work + (long long)blockIdx.x * nn;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;

  for (int i = tid; i < n; i += blockDim.x) r[i] = p.g[(long long)blockIdx.x * n + i];

  // ---- factorization and forward substitution, panel by panel
  for (int k = 0; k < n; k += nb) {
    const int w = min(nb, n - k);
    const int rows = n - k;
    const T* src = k == 0 ? H : L;
    for (int rr = warp; rr < rows; rr += nwarps)
      if (lane < w) P[lane * rows + rr] = src[(long long)(k + rr) * n + k + lane];
    __syncthreads();
    for (int c = 0; c < w; ++c) {
      const T piv = sqrt(P[c * rows + c]);
      __syncthreads();
      for (int rr = c + 1 + tid; rr < rows; rr += blockDim.x) P[c * rows + rr] /= piv;
      if (tid == 0) P[c * rows + c] = piv;
      __syncthreads();
      for (int c2 = c + 1; c2 < w; ++c2) {
        const T lc = P[c * rows + c2];
        for (int rr = c2 + tid; rr < rows; rr += blockDim.x)
          P[c2 * rows + rr] -= P[c * rows + rr] * lc;
      }
      __syncthreads();
    }
    for (int rr = warp; rr < rows; rr += nwarps)
      if (lane < w && lane <= rr) L[(long long)(k + rr) * n + k + lane] = P[lane * rows + rr];
    // forward substitution for the panel's own unknowns (one warp), then
    // their contribution to the rows below
    if (warp == 0) {
      for (int c = 0; c < w; ++c) {
        const T yc = r[k + c] / P[c * rows + c];
        __syncwarp();
        if (lane == 0) r[k + c] = yc;
        if (lane > c && lane < w) r[k + lane] -= P[c * rows + lane] * yc;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int rr = w + tid; rr < rows; rr += blockDim.x) {
      T acc = r[k + rr];
      for (int c = 0; c < w; ++c) acc -= P[c * rows + rr] * r[k + c];
      r[k + rr] = acc;
    }
    // trailing update of the lower triangle: L[i][j] = src[i][j] -
    // sum_c P[c][i] P[c][j] for k + w <= j <= i
    for (int rr = w + warp; rr < rows; rr += nwarps) {
      const long long i = k + rr;
      T pi[kK6MaxPanel];
#pragma unroll
      for (int c = 0; c < kK6MaxPanel; ++c) pi[c] = c < w ? P[c * rows + rr] : T(0);
      for (int j = k + w + lane; j <= i; j += kWarp) {
        T a = src[i * n + j];
        const int jj = j - k;
#pragma unroll
        for (int c = 0; c < kK6MaxPanel; ++c)
          if (c < w) a -= pi[c] * P[c * rows + jj];
        L[i * n + j] = a;
      }
    }
    __syncthreads();
  }

  // ---- back substitution L^T x = y, panel by panel in reverse
  for (int k = ((n - 1) / nb) * nb; k >= 0; k -= nb) {
    const int w = min(nb, n - k);
    const int rows = n - k;
    for (int rr = warp; rr < rows; rr += nwarps)
      if (lane < w) P[lane * rows + rr] = lane <= rr ? L[(long long)(k + rr) * n + k + lane] : T(0);
    __syncthreads();
    // the rows below the panel: red[c] = sum_{rr >= w} L[k + rr][k + c] x[k + rr]
    for (int c = warp; c < w; c += nwarps) {
      T acc = T(0);
      for (int rr = w + lane; rr < rows; rr += kWarp) acc += P[c * rows + rr] * r[k + rr];
      acc = warp_sum(acc);
      if (lane == 0) red[c] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      T rem = lane < w ? r[k + lane] - red[lane] : T(0);
      for (int c = w - 1; c >= 0; --c) {
        const T xc = __shfl_sync(kFull, rem, c) / P[c * rows + c];
        if (lane < c) rem -= P[lane * rows + c] * xc;
        if (lane == c) rem = xc;
      }
      if (lane < w) r[k + lane] = rem;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += blockDim.x) p.x[(long long)blockIdx.x * n + i] = r[i];
}

template <typename T>
int k6_launch(const void* h, const void* g, void* work, void* x, int B, int n,
              void* stream) {
  const int nb = k6_panel(n, sizeof(T));
  if (nb == 0) return kErrSmem;
  K6Params<T> prm;
  prm.h = static_cast<const T*>(h);
  prm.g = static_cast<const T*>(g);
  prm.work = static_cast<T*>(work);
  prm.x = static_cast<T*>(x);
  prm.n = n;
  prm.nb = nb;
  const size_t smem = k6_smem_elems(n, nb) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_solve_kernel<T><<<B, kK6Threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// The panel width the kernel takes for width n (0: n does not fit).
extern "C" int cholesky_solve_panel(int n, int elem_size) {
  return k6_panel(n, elem_size);
}

// dtype 0: float32, 1: float64.  h is (B, n, n) and g (B, n), contiguous;
// work is a (B, n, n) workspace that receives the factors; x receives the
// solutions.  Returns 0, a cudaError_t, or a negative ErrorCode; launches on
// `stream` and does not synchronise.
extern "C" int cholesky_solve_launch(int dtype, const void* h, const void* g,
                                     void* work, void* x, int B, int n,
                                     void* stream) {
  if (B < 1 || n < 1 || h == nullptr || g == nullptr || work == nullptr ||
      x == nullptr)
    return kErrArgs;
  if (dtype == 0) return k6_launch<float>(h, g, work, x, B, n, stream);
  if (dtype == 1) return k6_launch<double>(h, g, work, x, B, n, stream);
  return kErrArgs;
}
