// Fused dense quasi-Newton update K5 on Hopper (sm_90a): for a batch of
// inverse-Hessian approximations B (b, n, n) and correction pairs s, y with
// the new gradient g (b, n), B' = update(B, s, y) and B' g in one kernel,
// one thread block per instance.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_qn.py
// (qn_update_direction_pallas, pl.pallas_call at :92; the math of
// _update_math at :25).  The plain PyTorch version of the same function is
// qn_update_direction_plain in ../fused_qn.py; the two are held against
// each other on the card.
//
// The four rules of the reference family, with rho = 1 / s.y:
//   bfgs    B' = B - rho (s (By)^T + (By) s^T) + (rho^2 y.By + rho) s s^T
//   dfp     B' = B + s s^T / s.y - (By)(By)^T / y.By
//   broyden B' = B + (s - By)(B^T s)^T / s.y
//   sr1     B' = B + (s - By)(s - By)^T / ((s - By).y)
// and the degenerate-pair skip sqrt(s.s) < tol or sqrt(y.y) < tol, decided
// in the kernel as the TPU kernel decides it (pallas_qn.py:55-69): B' = B
// then, and B' g is computed all the same.
//
// What bounds it on this card: bytes.  B is read and B' written once each,
// 2 n^2 elements per instance (81.9 MB at the lockstep quasi-Newton path's
// 1,024 x n = 100 in float32, 24.4 us at 3.35 TB/s), against ~10 n^2
// operations.  The TPU kernel holds B in VMEM for its one pass; here the
// first pass over B (one warp per row, lanes over columns: coalesced) forms
// B y and, for broyden, a second one B^T s (threads over columns); the
// dot products s.s, y.y, s.y, y.By and (s - By).y are block reductions; the
// last pass reads each row of B again (from L2 at this shape), writes the
// row of B' and reduces its dot with g.  The vectors live in shared memory.

#include "common.cuh"

namespace {

constexpr int kK5Threads = 256;
enum QnKind { kBfgs = 0, kDfp = 1, kBroyden = 2, kSr1 = 3 };

__host__ __device__ inline long long k5_smem_elems(int n) {
  return 5LL * n + 3 * (kK5Threads / kWarp);
}

template <typename T> struct K5Params {
  const T* B;
  const T* s;
  const T* y;
  const T* g;
  T* Bn;
  T* Bg;
  int n;
  int kind;
  T tol;
};

// sums of three values over the block; every thread gets the totals
template <typename T>
__device__ void block_sum3(T& a, T& b, T& c, T* red) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  __syncthreads();
  if (lane == 0) {
    red[warp] = a;
    red[nwarps + warp] = b;
    red[2 * nwarps + warp] = c;
  }
  __syncthreads();
  a = b = c = T(0);
  for (int w = 0; w < nwarps; ++w) {
    a += red[w];
    b += red[nwarps + w];
    c += red[2 * nwarps + w];
  }
}

template <typename T>
__global__ void __launch_bounds__(kK5Threads) qn_update_kernel(K5Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  const int n = p.n;
  T* s = reinterpret_cast<T*>(smem_raw);
  T* y = s + n;
  T* g = y + n;
  T* By = g + n;
  T* Bts = By + n;
  T* red = Bts + n;
  const long long nn = (long long)n * n;
  const T* Bm = p.B + (long long)blockIdx.x * nn;
  T* Bn = p.Bn + (long long)blockIdx.x * nn;
  const long long off = (long long)blockIdx.x * n;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;

  T ss = T(0), yy = T(0), sy = T(0);
  for (int j = tid; j < n; j += blockDim.x) {
    const T sj = p.s[off + j], yj = p.y[off + j];
    s[j] = sj;
    y[j] = yj;
    g[j] = p.g[off + j];
    ss += sj * sj;
    yy += yj * yj;
    sy += sj * yj;
  }
  block_sum3(ss, yy, sy, red);   // its barriers also publish s, y, g
  for (int i = warp; i < n; i += nwarps) {
    T acc = T(0);
    for (int j = lane; j < n; j += kWarp) acc += Bm[(long long)i * n + j] * y[j];
    acc = warp_sum(acc);
    if (lane == 0) By[i] = acc;
  }
  if (p.kind == kBroyden) {
    for (int j = tid; j < n; j += blockDim.x) {
      T acc = T(0);
      for (int i = 0; i < n; ++i) acc += Bm[(long long)i * n + j] * s[i];
      Bts[j] = acc;
    }
  }
  __syncthreads();
  T yBy = T(0), shyy = T(0), unused = T(0);
  for (int j = tid; j < n; j += blockDim.x) {
    yBy += y[j] * By[j];
    shyy += (s[j] - By[j]) * y[j];
  }
  block_sum3(yBy, shyy, unused, red);
  const bool skip = sqrt(ss) < p.tol || sqrt(yy) < p.tol;
  const T rho = T(1) / sy;
  const T coef = rho * rho * yBy + rho;

  for (int i = warp; i < n; i += nwarps) {
    const T si = s[i], byi = By[i], shi = s[i] - By[i];
    T acc = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T b = Bm[(long long)i * n + j];
      T bn = b;
      if (!skip) {
        if (p.kind == kBfgs)
          bn = b - rho * (si * By[j] + byi * s[j]) + coef * (si * s[j]);
        else if (p.kind == kDfp)
          bn = b + (si * s[j]) / sy - (byi * By[j]) / yBy;
        else if (p.kind == kBroyden)
          bn = b + (shi * Bts[j]) / sy;
        else
          bn = b + (shi * (s[j] - By[j])) / shyy;
      }
      Bn[(long long)i * n + j] = bn;
      acc += bn * g[j];
    }
    acc = warp_sum(acc);
    if (lane == 0) p.Bg[off + i] = acc;
  }
}

template <typename T>
int k5_launch(const void* B, const void* s, const void* y, const void* g,
              void* Bn, void* Bg, int b, int n, int kind, double tol,
              void* stream) {
  const size_t smem = k5_smem_elems(n) * sizeof(T);
  if ((long long)smem > kSmemPerBlock) return kErrSmem;
  K5Params<T> prm;
  prm.B = static_cast<const T*>(B);
  prm.s = static_cast<const T*>(s);
  prm.y = static_cast<const T*>(y);
  prm.g = static_cast<const T*>(g);
  prm.Bn = static_cast<T*>(Bn);
  prm.Bg = static_cast<T*>(Bg);
  prm.n = n;
  prm.kind = kind;
  prm.tol = (T)tol;
  cudaError_t err = cudaFuncSetAttribute(
      qn_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qn_update_kernel<T><<<b, kK5Threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one instance takes, in elements (s, y, g, By, B^T s and the
// reduction slots).
extern "C" long long qn_update_smem_elems(int n) { return k5_smem_elems(n); }

// dtype 0: float32, 1: float64.  B (b, n, n) and s, y, g (b, n) contiguous;
// Bn receives B' and Bg receives B' g.  kind: 0 bfgs, 1 dfp, 2 broyden,
// 3 sr1.  Returns 0, a cudaError_t, or a negative ErrorCode; launches on
// `stream` and does not synchronise.
extern "C" int qn_update_launch(int dtype, const void* B, const void* s,
                                const void* y, const void* g, void* Bn,
                                void* Bg, int b, int n, int kind, double tol,
                                void* stream) {
  if (b < 1 || n < 1 || B == nullptr || s == nullptr || y == nullptr ||
      g == nullptr || Bn == nullptr || Bg == nullptr || kind < 0 || kind > 3)
    return kErrArgs;
  if (dtype == 0)
    return k5_launch<float>(B, s, y, g, Bn, Bg, b, n, kind, tol, stream);
  if (dtype == 1)
    return k5_launch<double>(B, s, y, g, Bn, Bg, b, n, kind, tol, stream);
  return kErrArgs;
}
