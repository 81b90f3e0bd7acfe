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
// operations.  The TPU kernel holds B in VMEM for its one pass; so does
// this one, in the block's shared memory (the "shared" placement, wherever
// B and the vectors fit a block: n <= 238 in float32, n <= 167 in float64):
//  * one thread starts a bulk copy of the instance's B by the tensor
//    memory accelerator (cp.async.bulk of the contiguous n^2 elements onto
//    an mbarrier; the staging buffer is offset so that it agrees with B's
//    address modulo 16 bytes, and the ends are copied singly) before the
//    block loads s, y, g and forms s.s, y.y, s.y, so the copy overlaps
//    that work;
//  * B y and, for broyden, B^T s (threads over columns) read the staged
//    copy; the update is one more sweep over its rows that stores each
//    element of B' to device memory as it is formed and reduces the row's
//    dot with g, as the plain version and the JAX kernel form B' g (never B
//    g plus the rank-two terms, which cancel).  Both sweeps put lanes on
//    consecutive columns (coalesced, and conflict-free in shared memory)
//    and reduce kRows rows of a warp in one transposed butterfly.
// Device memory sees each B read once and each B' written once.  On an
// H100 this ran faster than a persistent grid with two staging buffers
// (2 blocks per SM; the next instance's copy in flight during the
// update), than B' stored in flat 16-byte groups with a third pass for B'
// g (the first version of that pass, one 16-byte group a thread, also met
// 4-way bank conflicts), than 128 or 512 threads a block in float32, and
// than 16-byte cp.async copies by every thread (PERF.md).  Past the
// fit (the "workspace" placement) B stays where it lies: the products read
// it from device memory, and the update's sweep reads each row again (from
// L2 at such a batch).  The placement is a route by shape (k5_in_shared,
// mirrored by fused_qn.in_shared); a failed launch is reported, never
// rerouted.  The vectors live in shared memory in both placements.

#include "common.cuh"

namespace {

constexpr int kK5Threads = 256;
// blocks per SM __launch_bounds__ keeps the registers for: float32's
// shared placement holds 5 (42 KB each at n = 100), which 48 registers a
// thread allow (left free, nvcc took 63 to 95 and the card held 2 to 4
// blocks: 48 to 54 us against 41 on an H100); float64's holds 2, whatever
// the registers
template <typename T> constexpr int k5_min_blocks() { return sizeof(T) == 4 ? 5 : 1; }
enum QnKind { kBfgs = 0, kDfp = 1, kBroyden = 2, kSr1 = 3, kSkip = 4 };
constexpr int kRows = 4;   // rows a warp reduces together in the sweeps

// s, y, g, By, B^T s and the reduction slots
__host__ __device__ inline long long k5_vec_elems(int n) {
  return 5LL * n + 3 * (kK5Threads / kWarp);
}
__host__ __device__ inline long long k5_vec_bytes(int n, int itemsize) {
  return (k5_vec_elems(n) * itemsize + 15) / 16 * 16;
}
// the vectors' bytes rounded up to 16, 16 bytes for the copy's mbarrier,
// then B's staged copy and the up to 16 bytes that align it with B
__host__ __device__ inline long long k5_shared_bytes(int n, int itemsize) {
  return k5_vec_bytes(n, itemsize) + 16 + (long long)n * n * itemsize + 16;
}
__host__ __device__ inline bool k5_in_shared(int n, int itemsize) {
  return k5_shared_bytes(n, itemsize) <= kSmemPerBlock;
}

template <typename T> struct K5Params {
  const T* B;
  const T* s;
  const T* y;
  const T* g;
  T* Bn;
  T* Bg;
  int b;
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

// the vectors and scalars of one instance's rank-two update
template <typename T> struct Rank2 {
  const T* s;
  const T* By;
  const T* Bts;
  T rho, coef, iyBy, ishyy;   // 1 / s.y, rho^2 y.By + rho, 1 / y.By, 1 / (s - By).y
};

// B'_ij from B_ij under rule KIND (kSkip: B' = B)
template <int KIND, typename T>
__device__ __forceinline__ T updated(T b, int i, int j, const Rank2<T>& r) {
  if constexpr (KIND == kSkip) {
    return b;
  } else if constexpr (KIND == kBfgs) {
    return b - r.rho * (r.s[i] * r.By[j] + r.By[i] * r.s[j]) + r.coef * (r.s[i] * r.s[j]);
  } else if constexpr (KIND == kDfp) {
    return b + (r.s[i] * r.s[j]) * r.rho - (r.By[i] * r.By[j]) * r.iyBy;
  } else if constexpr (KIND == kBroyden) {
    return b + ((r.s[i] - r.By[i]) * r.Bts[j]) * r.rho;
  } else {
    return b + ((r.s[i] - r.By[i]) * (r.s[j] - r.By[j])) * r.ishyy;
  }
}

// For every row i of M (row-major, n x n): out[i] = sum_j M'_ij v_j with
// M' = updated<KIND>(M) (kSkip: M itself), each M'_ij also stored to Mn
// where Mn is given; kRows rows per warp and pass (lanes over j: coalesced,
// and conflict-free in shared memory), their sums in one transposed
// butterfly
template <int KIND, typename T>
__device__ __forceinline__ void row_sweep(const T* M, T* Mn, const T* v, T* out, int n,
                                          const Rank2<T>& r, int warp, int nwarps,
                                          int lane) {
  for (int i0 = warp; i0 < n; i0 += kRows * nwarps) {
    T acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = T(0);
    for (int j = lane; j < n; j += kWarp) {
      const T vj = v[j];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * nwarps;
        if (i < n) {
          const T mn = updated<KIND>(M[(long long)i * n + j], i, j, r);
          if (Mn != nullptr) Mn[(long long)i * n + j] = mn;
          acc[k] += mn * vj;
        }
      }
    }
    const T sum = warp_sums<kRows>(acc, lane);
    const int i = i0 + lane / (kWarp / kRows) * nwarps;
    if (lane % (kWarp / kRows) == 0 && i < n) out[i] = sum;
  }
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kK5Threads, k5_min_blocks<T>())
qn_update_kernel(K5Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = p.n;
  T* s = reinterpret_cast<T*>(smem_raw);
  T* y = s + n;
  T* g = y + n;
  T* By = g + n;
  T* Bts = By + n;
  T* red = Bts + n;
  const long long nn = (long long)n * n;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  // the staging copy's mbarrier, after the vectors
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem_raw + k5_vec_bytes(n, sizeof(T)));
  if (SHARED && tid == 0) bulk_barrier_init(bar);
  unsigned phase = 0;
  // one instance per block as launched (grid b), any grid served; in this
  // form the 5-block bound fits 48 registers without spills
  for (long long inst = blockIdx.x; inst < p.b; inst += gridDim.x) {
    const T* Bm = p.B + inst * nn;
    T* Bn = p.Bn + inst * nn;
    const long long off = inst * n;
    // the staged copy of B agrees with B modulo 16 bytes
    T* Bs = reinterpret_cast<T*>(smem_raw + k5_vec_bytes(n, sizeof(T)) + 16 +
                                 (reinterpret_cast<uintptr_t>(Bm) & 15));
    const bool started = SHARED && bulk_copy(Bs, Bm, nn, tid, blockDim.x, bar);
    const T* Bsrc = SHARED ? Bs : Bm;

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
    block_sum3(ss, yy, sy, red);   // its barriers publish s, y, g and the copy's ends
    bulk_copy_wait(started, bar, phase);
    phase ^= started ? 1u : 0u;
    row_sweep<kSkip>(Bsrc, static_cast<T*>(nullptr), y, By, n, Rank2<T>{}, warp,
                     nwarps, lane);
    if (p.kind == kBroyden) {
      for (int j = tid; j < n; j += blockDim.x) {
        T acc = T(0);
        for (int i = 0; i < n; ++i) acc += Bsrc[(long long)i * n + j] * s[i];
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
    Rank2<T> r;
    r.s = s;
    r.By = By;
    r.Bts = Bts;
    r.rho = T(1) / sy;
    r.coef = r.rho * r.rho * yBy + r.rho;
    r.iyBy = T(1) / yBy;
    r.ishyy = T(1) / shyy;
    // B' to device memory as each row's sweep forms it, and B' g
    T* Bg = p.Bg + off;
    switch (skip ? int(kSkip) : p.kind) {
      case kBfgs: row_sweep<kBfgs>(Bsrc, Bn, g, Bg, n, r, warp, nwarps, lane); break;
      case kDfp: row_sweep<kDfp>(Bsrc, Bn, g, Bg, n, r, warp, nwarps, lane); break;
      case kBroyden: row_sweep<kBroyden>(Bsrc, Bn, g, Bg, n, r, warp, nwarps, lane); break;
      case kSr1: row_sweep<kSr1>(Bsrc, Bn, g, Bg, n, r, warp, nwarps, lane); break;
      default: row_sweep<kSkip>(Bsrc, Bn, g, Bg, n, r, warp, nwarps, lane); break;
    }
    __syncthreads();   // the block is done with this instance's buffers
  }
}

template <typename T, bool SHARED>
int k5_launch_placed(const K5Params<T>& prm, int b, cudaStream_t stream) {
  const long long smem = SHARED ? k5_shared_bytes(prm.n, sizeof(T))
                                : k5_vec_elems(prm.n) * (long long)sizeof(T);
  if (smem > kSmemPerBlock) return kErrSmem;
  cudaError_t err = cudaFuncSetAttribute(
      qn_update_kernel<T, SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qn_update_kernel<T, SHARED><<<b, kK5Threads, (int)smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// out: 1 for the shared placement (0: workspace), resident blocks per SM,
// registers per thread, local (spill) bytes per thread, dynamic shared
// memory per block
template <typename T, bool SHARED>
int k5_info(int n, int* out) {
  const long long smem = SHARED ? k5_shared_bytes(n, sizeof(T))
                                : k5_vec_elems(n) * (long long)sizeof(T);
  if (smem > kSmemPerBlock) return kErrSmem;
  auto kernel = qn_update_kernel<T, SHARED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kK5Threads,
                                                        (size_t)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = SHARED ? 1 : 0;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)smem;
  return 0;
}

template <typename T>
int k5_launch(const void* B, const void* s, const void* y, const void* g,
              void* Bn, void* Bg, int b, int n, int kind, double tol,
              void* stream) {
  K5Params<T> prm;
  prm.B = static_cast<const T*>(B);
  prm.s = static_cast<const T*>(s);
  prm.y = static_cast<const T*>(y);
  prm.g = static_cast<const T*>(g);
  prm.Bn = static_cast<T*>(Bn);
  prm.Bg = static_cast<T*>(Bg);
  prm.b = b;
  prm.n = n;
  prm.kind = kind;
  prm.tol = (T)tol;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k5_in_shared(n, sizeof(T))) return k5_launch_placed<T, true>(prm, b, st);
  return k5_launch_placed<T, false>(prm, b, st);
}

}  // namespace

// Shared memory the workspace placement takes per block, in elements (s,
// y, g, By, B^T s and the reduction slots): the least any launch needs.
extern "C" long long qn_update_smem_elems(int n) { return k5_vec_elems(n); }

// 1 where an instance of width n with elements of itemsize bytes takes the
// shared placement (B staged in the block's shared memory), else 0.
extern "C" int qn_update_in_shared(int n, int itemsize) {
  return k5_in_shared(n, itemsize) ? 1 : 0;
}

// the placement and the compiled kernel's resources at width n (see k5_info)
extern "C" int qn_update_info(int dtype, int n, int* out) {
  if (n < 1) return kErrArgs;
  if (dtype == 0)
    return k5_in_shared(n, 4) ? k5_info<float, true>(n, out)
                              : k5_info<float, false>(n, out);
  if (dtype == 1)
    return k5_in_shared(n, 8) ? k5_info<double, true>(n, out)
                              : k5_info<double, false>(n, out);
  return kErrArgs;
}

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
