// Whole batched large-n L-BFGS-B solves on Hopper (sm_90a): the tall kernel
// K2, a tile of instances per thread block.
//
// Replaces the TPU kernel optimization_solvers_tpu/ops/pallas_lbfgsb_tall.py
// (lbfgsb_solve_fused_tall, kernel body _make_kernel, pl.pallas_call at
// :941).  The plain PyTorch version of the same algorithm is
// lbfgsb_solve_tall_plain in ../fused_lbfgsb_tall.py; the two are held
// against each other on the card.
//
// What bounds it on this card.  An instance's histories S and Y (2 m n
// elements: 800 KB at config 4, n = 10,000, m = 10, float32) and its (n,)
// vectors live in a device-memory workspace, so every pass over the
// coordinates streams them, and each pass is a chain of dependent loads
// and group reductions: latency, not bandwidth.  The objective's data (A
// of the log-sum-exp, 20 MB at config 4) is streamed from L2 by every
// evaluation, once per tile and pass, at the rate L2 feeds the SMs.  The
// design cuts both:
//
//  * A tile of up to kMaxTile instances per block (the wrapper picks the
//    fewest that put one block on each SM), one group of 128 threads per
//    instance.  A smaller tile (a batch too small to fill the card) keeps
//    up to kMaxTile groups where shared memory allows: the extra groups run
//    no instance and join only the objective's passes, which spread over
//    every thread of the block.  The log-sum-exp and quadratic objectives
//    are tile products in the kernel's own code, float32 (float64) FMAs,
//    no tensor cores:
//    for Z = X_tile A^T each warp stages 32 rows of A (128-byte segments,
//    16-byte cp.async) and the tile's x through its own double buffer, one
//    lane per row, so no warp waits for another; softmax(Z) A streams A
//    once more by rows, each thread four columns, through a kStages-deep
//    ring; the quadratic's Q x and Q^T x come from one block-wide pass
//    over Q's rows.  A's copies ask L2 to keep it (evict_last) and the
//    histories are read as streaming loads.  Where the line search's last
//    trial is the step, its evaluation is reused: dcsrch's f and gradient,
//    Armijo's z = A x + b.
//  * The objective is tile-wide, so the tile runs in lockstep, as the TPU
//    kernel's tile does: every loop that evaluates it (the outer
//    iteration, the Armijo and dcsrch searches) runs while any instance of
//    the tile is open, every write is masked per instance, and a finished
//    instance stays frozen with its own iteration count.  Every sum of an
//    instance is taken in the same order at any tile width and group
//    count, so an instance computes what it computes alone, bit for bit.
//  * The Cauchy point's bisection scans only its bracket.  seg_eval(t)
//    sums over moving coordinates, and its sums split at t; the first
//    pass evaluates t = 0 and t = hi0 together and lists the coordinates
//    with finite breakpoints.  After that the coordinates below the list's
//    window and above it are carried as partial sums (and their nearest
//    breakpoints), and every probe reads only the listed coordinates,
//    compacting the list (per warp, in order) as the bracket shrinks.
//  * The histories are coordinate-major and interleaved (row i holds the
//    m Y slots, then the m S slots, padded to a multiple of 4), so a
//    gathered coordinate is one contiguous vector load and a full pass is
//    one coalesced stream.  The subspace tables (the Gram matrix of the
//    free rows of W, and W^T r_F) come from one pass in which each thread
//    owns a few entries over value-major chunks staged in shared memory;
//    the new pair's products, the step's copy and the stopping test share
//    one pass; the plain passes take two coordinates per step.
//
// Reductions are warp shuffles, then one partial per warp summed in warp
// order, so every thread of a group gets the same bits and all scalar
// state is replicated in registers; every branch on it is uniform over the
// group.  The small dense algebra (explicit 2m x 2m inverse of the middle
// matrix, the E / H / Gm tables, their Cholesky factors and solves) runs
// on the group's first warp in shared memory.

#include "common.cuh"

// Phase counters, compiled in only with -DK2_PROFILE (tools/k2_phase_profile.py
// builds such a copy; the kernel as shipped has none).  Each group's thread 0
// adds the clock64 cycles of every iteration's phases to k2_prof[0..9] (the
// phases in that tool's PHASES order) and [15] (iterations the instance sat
// out); [10] and [14] sum the gradient and value passes per block, [11] the
// instance-iterations, [12] the bisection probes, [13] the listed
// coordinates read per warp and probe.
#ifdef K2_PROFILE
__device__ unsigned long long k2_prof[16];
#define K2_PROF(...) __VA_ARGS__
#else
#define K2_PROF(...)
#endif
#define K2_PHASE(k) \
  K2_PROF(if (tid == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; prof_t = t_; })

namespace {

constexpr int kGroup = 128;                    // threads per instance
constexpr int kGroupWarps = kGroup / kWarp;
constexpr int kMaxTile = 4;                    // instances per block
constexpr int kMaxThreads = kGroup * kMaxTile;
constexpr int kMaxRows = 4096;                 // LOG_SUM_EXP rows in shared memory
constexpr int kVecs = 10;                      // (n,) vectors per instance, list included
constexpr int kGramChunk = kGroup;             // coordinates staged per Gram chunk
constexpr int kGramRow = kGramChunk + 4;       // ... padded: 16-byte loads, distinct banks
constexpr int kBcast = 16;                     // scalars broadcast in a group
constexpr int kStages = 4;                     // LOG_SUM_EXP gradient pass: ring depth

// values one group reduction carries: 6 mx + 2 sums, a max and a min
__host__ __device__ constexpr int red_width(int mx) { return 6 * mx + 4; }
// elements of one coordinate's history row (2m, padded for vector loads)
__host__ __device__ inline int hist_stride(int m) { return (2 * m + 3) / 4 * 4; }

// tile products.  The quadratic's block-wide pass stages chunks of kc
// columns (rows padded to ks); LOG_SUM_EXP's value pass stages, per warp,
// chunks of kw columns (one 128-byte segment of each of 32 rows, padded to
// kws); its gradient pass chunks of rc rows.  Padded rows make 16-byte
// loads of consecutive rows hit distinct banks; v values per 16 bytes.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int kc = 16, ks = 20, kw = 32, kws = 36, rc = 16, v = 4;
};
template <> struct Chunk<double> {
  static constexpr int kc = 8, ks = 10, kw = 16, kws = 18, rc = 8, v = 2;
};
// elements of one warp's double buffer in LOG_SUM_EXP's value pass
template <typename T> __host__ __device__ constexpr int warp_stage() {
  return 2 * (kWarp * Chunk<T>::kws + kMaxTile * Chunk<T>::kw);
}
// LOG_SUM_EXP's rows of z per instance, padded for 16-byte loads
__host__ __device__ inline int zrow_stride(int rows) { return (rows + 3) / 4 * 4; }

__host__ __device__ inline long long lmax(long long a, long long b) { return a > b ? a : b; }

// shared memory of one block of `groups` groups running a tile of `tile`
// instances, in elements: the tile region (staging for the objective's
// products and the Gram chunks, the softmax rows, per-instance f and
// flags), then one region per group
struct Layout {
  long long stage, zbuf, tsc, group, total;
  __host__ __device__ Layout(int obj, int tile, int groups, int m, int rows, int mx, int kc,
                             int ks, int rc, int wstage) {
    const long long nt = (long long)kGroup * groups;
    const int m2 = 2 * m;
    long long st = (long long)groups * kGramRow * (m2 + 1);
    const long long val = 2 * nt * ks + 2LL * kMaxTile * kc;
    if (obj == kLogSumExp) st = lmax(st, lmax(nt / kWarp * wstage, (long long)kStages * rc * nt));
    if (obj == kQuadratic)
      st = lmax(st, val + kMaxTile * nt + (nt / kWarp) * kMaxTile * kc);
    stage = st;
    zbuf = obj == kLogSumExp ? (long long)zrow_stride(rows) * tile : 0;
    tsc = 3 * kMaxTile;
    const int rw = red_width(mx);
    group = (long long)kGroupWarps * rw + rw + 10LL * m * m + 2LL * m + 11LL * m2 + kBcast;
    total = stage + zbuf + tsc + groups * group;
  }
};

// ---- PTX primitives ----------------------------------------------------------

__device__ __forceinline__ void group_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
// copies of the objective's data ask L2 to keep it (evict_last): the
// histories stream past it every iteration
__device__ __forceinline__ unsigned long long l2_keep() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
template <typename T>
__device__ __forceinline__ void cp_async_keep(T* dst, const T* src, unsigned long long pol) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "l"(pol) : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async16_keep(void* dst, const void* src,
                                                unsigned long long pol) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// the gradient pass's ring: kStages - 1 chunks in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  static_assert(kStages == 4, "wait_group's count is kStages - 1");
  asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// ---- end of PTX primitives ---------------------------------------------------

// one history row into registers (vector loads; rows are 16-byte aligned;
// streaming, so L2 keeps the objective's data rather than the histories)
__device__ __forceinline__ void put(const float4& v, float* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void put(const double2& v, double* w) {
  w[0] = v.x; w[1] = v.y;
}
template <typename T> struct Vec;
template <> struct Vec<float> { using V = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using V = double2; static constexpr int n = 2; };
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* p, int R, T (&w)[K]) {
  using V = typename Vec<T>::V;
  constexpr int v = Vec<T>::n;
#pragma unroll
  for (int c = 0; c < K; c += v)
    if (c < R) put(__ldcs(reinterpret_cast<const V*>(p + c)), w + c);
}

// ---- group reductions ----------------------------------------------------------

template <typename T> struct Grp {
  T* red;      // kGroupWarps x rw partials
  T* out;      // rw results, read by every thread of the group after the call
  int tid, lane, warp, bar, rw;

  __device__ void sync() const { group_bar(bar, kGroup); }
  // out[0:k] = group sums of v[0:k]; hi, lo = group max / min (NaN propagates)
  template <int K>
  __device__ void reduce(const T (&v)[K], int k, T& hi, T& lo) const {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) {
        const T s = warp_sum(v[j]);
        if (lane == 0) red[warp * rw + j] = s;
      }
    hi = warp_max(hi);
    lo = warp_min(lo);
    if (lane == 0) {
      red[warp * rw + rw - 2] = hi;
      red[warp * rw + rw - 1] = lo;
    }
    sync();
    for (int j = tid; j < k; j += kGroup) {
      T s = red[j];
      for (int w = 1; w < kGroupWarps; ++w) s += red[w * rw + j];
      out[j] = s;
    }
    if (tid == kGroup - 1) {
      T a = red[rw - 2], b = red[rw - 1];
      for (int w = 1; w < kGroupWarps; ++w) {
        a = jmax(a, red[w * rw + rw - 2]);
        b = jmin(b, red[w * rw + rw - 1]);
      }
      out[rw - 2] = a;
      out[rw - 1] = b;
    }
    sync();
    hi = out[rw - 2];
    lo = out[rw - 1];
  }
  __device__ T sum(T v) const {
    T a[1] = {v};
    T hi = 0, lo = 0;
    reduce(a, 1, hi, lo);
    return out[0];
  }
  __device__ void sum2(T a, T b) const {
    T v[2] = {a, b};
    T hi = 0, lo = 0;
    reduce(v, 2, hi, lo);
  }
  __device__ T max(T v) const {
    T a[1] = {0};
    T lo = 0;
    reduce(a, 0, v, lo);
    return v;
  }
  __device__ T min(T v) const {
    T a[1] = {0};
    T hi = 0;
    reduce(a, 0, hi, v);
    return v;
  }
};

// ---- the kernel --------------------------------------------------------------

template <typename T> struct Params {
  const T* x0;
  const T* lo;
  const T* up;
  int bstride;          // 0: bounds shared by all instances; n: per instance
  int objective;
  const T* d0;
  const T* d1;
  int rows;             // LOG_SUM_EXP rows (0 otherwise)
  int B, n, m, tile;
  int groups;           // groups of kGroup threads per block, >= tile
  T pgtol, f_rtol, eps, c1;
  int max_iter, max_iter_ls, bisect_iters, guard_maxseg, dcsrch;
  T* work;              // B n R history elements, then B kVecs n vector elements
  T* x_out;
  T* f_out;
  int* it_out;
  int* st_out;
  int* flag_out;
};


// vector slots of an instance's workspace
enum VecSlot { kX = 0, kG, kTB, kBV, kXC, kRF, kD, kXT, kGT, kList };

// ---- the objective, tile-wide ----------------------------------------------

template <typename T> struct TileCtx {
  const T* d0;
  const T* d1;
  int rows, n, objective, tile, groups, grp;   // tile: instances; groups >= tile
  T* stage;                 // staging for the products
  T* zbuf;                  // LOG_SUM_EXP: z, then softmax(z), rows x tile
  T* FT;                    // f of each instance of the tile
  T* PART;                  // 1: the instance takes part in this evaluation
  T* VNEED;                 // LOG_SUM_EXP: 1 where z must be computed (0: the
                            // instance's z rows still hold its last trial's)
  T* vecs;                  // (n,) vectors of the tile's first instance
  long long vstride;        // elements between two instances' vectors
  Grp<T> bk;
  __device__ T* vec(int t, int s) const { return vecs + t * vstride + (long long)s * n; }
};

// rows pass: acc_t(r) = sum_j M[r][j] x_t[j] for the rows r of a row block of
// M (mrows x n, row-major), each thread one row, M staged by column chunks
// through a cp.async double buffer; emit(r, acc) after each row block.
// With colw, also the column sums sum_r M[r][k] x_t[r] of each chunk, added
// into the RF vector of each instance (the quadratic's Q^T x).
template <typename T, class Emit>
__device__ void rows_pass(const TileCtx<T>& c, const T* Mt, int mrows, int src,
                          const T* take, bool colw, Emit&& emit) {
  constexpr int KC = Chunk<T>::kc, KS = Chunk<T>::ks, V = Chunk<T>::v;
  using VT = typename Vec<T>::V;
  const int n = c.n, tile = c.tile, NT = kGroup * c.groups, btid = threadIdx.x;
  T* As = c.stage;                                  // 2 x NT x KS
  T* Xs = As + 2LL * NT * KS;                       // 2 x kMaxTile x KC
  T* XR = Xs + 2 * kMaxTile * KC;                   // kMaxTile x NT
  T* R2 = XR + (long long)kMaxTile * NT;            // warps x kMaxTile x KC
  const int nch = (n + KC - 1) / KC;
  for (int r0 = 0; r0 < mrows; r0 += NT) {
    if (colw)
      for (int e = btid; e < tile * NT; e += NT) {
        const int t = e / NT, i = e % NT;
        if (take[t] > T(0) && r0 + i < mrows) XR[t * NT + i] = c.vec(t, src)[r0 + i];
      }
    auto issue = [&](int ch, int b) {
      const int k0 = ch * KC;
      for (int e = btid; e < NT * KC; e += NT) {
        const int i = e / KC, k = e % KC;
        if (r0 + i < mrows && k0 + k < n)
          cp_async(As + (long long)b * NT * KS + i * KS + k,
                   Mt + (long long)(r0 + i) * n + k0 + k);
      }
      if (btid < tile * KC) {
        const int t = btid / KC, k = btid % KC;
        if (take[t] > T(0) && k0 + k < n)
          cp_async(Xs + b * kMaxTile * KC + t * KC + k, c.vec(t, src) + k0 + k);
      }
    };
    T acc[kMaxTile];
#pragma unroll
    for (int t = 0; t < kMaxTile; ++t) acc[t] = 0;
    issue(0, 0);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) issue(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const int b = ch & 1, k0 = ch * KC;
      const int kcnt = n - k0 < KC ? n - k0 : KC;
      const T* Ab = As + (long long)b * NT * KS;
      const T* Xb = Xs + b * kMaxTile * KC;
      const T* arow = Ab + btid * KS;
      int kk = 0;
      for (; kk + V <= kcnt; kk += V) {          // 16-byte loads, kk in order
        T a[V];
        put(*reinterpret_cast<const VT*>(arow + kk), a);
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t)
          if (t < tile) {
            T x[V];
            put(*reinterpret_cast<const VT*>(Xb + t * KC + kk), x);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[t] += a[v] * x[v];
          }
      }
      for (; kk < kcnt; ++kk) {
        const T a = arow[kk];
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t)
          if (t < tile) acc[t] += a * Xb[t * KC + kk];
      }
      if (colw) {
        // column k of the chunk, by sub-blocks of kGroup rows, each summed
        // by one group as at any tile width: kGroup / KC threads of KC
        // rows each, then the lanes of a warp, then the group's warps in
        // order; the sub-blocks join the sum in row order
        const int q = btid / kGroup, lt = btid % kGroup;
        const int k = lt % KC, p = lt / KC, np = kGroup / KC;
        T cs[kMaxTile];
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t) cs[t] = 0;
        for (int u = 0; u < KC; ++u) {
          const int i = q * kGroup + p + np * u;
          if (r0 + i < mrows) {
            const T a = Ab[i * KS + k];
#pragma unroll
            for (int t = 0; t < kMaxTile; ++t)
              if (t < tile) cs[t] += a * XR[t * NT + i];
          }
        }
        const int wb = btid / kWarp, ln = btid % kWarp;
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t) {
          for (int o = KC; o < kWarp; o <<= 1) cs[t] += __shfl_xor_sync(kFull, cs[t], o);
          if (ln < KC) R2[(wb * kMaxTile + t) * KC + k] = cs[t];
        }
        __syncthreads();
        if (btid < tile * KC) {
          const int t = btid / KC, kq = btid % KC;
          if (take[t] > T(0) && k0 + kq < n) {
            T col = c.vec(t, kRF)[k0 + kq];
            for (int g = 0; g < c.groups; ++g) {
              const int w0 = g * kGroupWarps;
              T s = R2[(w0 * kMaxTile + t) * KC + kq];
              for (int w = 1; w < kGroupWarps; ++w)
                s += R2[((w0 + w) * kMaxTile + t) * KC + kq];
              col += s;
            }
            c.vec(t, kRF)[k0 + kq] = col;
          }
        }
      }
      __syncthreads();
    }
    emit(r0 + btid, acc);
  }
}

// LOG_SUM_EXP's value pass: acc_t(r) = sum_j A[r][j] x_t[j] for every row
// r, one lane per row.  Each warp stages its 32 rows of A (one 128-byte
// segment of each, 16-byte copies where the rows are aligned) and the
// tile's x by column chunks through its own cp.async double buffer, so no
// warp waits for another; emit(r, acc) per row.  An instance with take = 0
// is neither read nor computed for.
template <typename T, class Emit>
__device__ void rows_pass_warp(const TileCtx<T>& c, const T* Mt, int mrows, int src,
                               const T* take, Emit&& emit) {
  constexpr int KW = Chunk<T>::kw, KWS = Chunk<T>::kws, V = Chunk<T>::v;
  constexpr int BUF = warp_stage<T>() / 2;
  using VT = typename Vec<T>::V;
  const int n = c.n, tile = c.tile, nw = kGroup * c.groups / kWarp;
  const int wid = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  T* const buf = c.stage + (long long)wid * 2 * BUF;
  const bool vec16 = n % V == 0;                  // every row 16-byte aligned
  const unsigned long long pol = l2_keep();
  const int nch = (n + KW - 1) / KW;
  for (int r0 = wid * kWarp; r0 < mrows; r0 += nw * kWarp) {
    auto issue = [&](int ch, int b) {
      T* As = buf + b * BUF;
      T* Xs = As + kWarp * KWS;
      const int k0 = ch * KW;
      if (vec16 && k0 + KW <= n) {
        for (int e = lane; e < kWarp * (KW / V); e += kWarp) {
          const int i = e / (KW / V), kv = e % (KW / V) * V;
          if (r0 + i < mrows)
            cp_async16_keep(As + i * KWS + kv, Mt + (long long)(r0 + i) * n + k0 + kv, pol);
        }
      } else {
        for (int e = lane; e < kWarp * KW; e += kWarp) {
          const int i = e / KW, k = e % KW;
          if (r0 + i < mrows && k0 + k < n)
            cp_async_keep(As + i * KWS + k, Mt + (long long)(r0 + i) * n + k0 + k, pol);
        }
      }
      for (int e = lane; e < tile * KW; e += kWarp) {
        const int t = e / KW, k = e % KW;
        if (take[t] > T(0) && k0 + k < n) cp_async(Xs + t * KW + k, c.vec(t, src) + k0 + k);
      }
    };
    T acc[kMaxTile];
#pragma unroll
    for (int t = 0; t < kMaxTile; ++t) acc[t] = 0;
    issue(0, 0);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      __syncwarp();                       // every lane is done with buffer (ch + 1) & 1
      if (ch + 1 < nch) issue(ch + 1, (ch + 1) & 1);
      cp_async_commit();
      cp_async_wait1();
      __syncwarp();                       // chunk ch has landed for every lane
      const T* As = buf + (ch & 1) * BUF;
      const T* Xs = As + kWarp * KWS;
      const int k0 = ch * KW;
      const int kcnt = n - k0 < KW ? n - k0 : KW;
      const T* arow = As + lane * KWS;
      int kk = 0;
      for (; kk + V <= kcnt; kk += V) {            // 16-byte loads, kk in order
        T a[V];
        put(*reinterpret_cast<const VT*>(arow + kk), a);
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t)
          if (t < tile) {
            T x[V];
            put(*reinterpret_cast<const VT*>(Xs + t * KW + kk), x);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[t] += a[v] * x[v];
          }
      }
      for (; kk < kcnt; ++kk) {
        const T a = arow[kk];
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t)
          if (t < tile) acc[t] += a * Xs[t * KW + kk];
      }
    }
    emit(r0 + lane, acc);
  }
}

// LOG_SUM_EXP's gradient pass, g_t = softmax(z_t)^T A with softmax(z) in
// the z rows: each thread owns CPT consecutive columns (CPT = V, one
// 16-byte copy per row, where the rows of A are 16-byte aligned), A's rows
// staged by chunks through a kStages-deep cp.async ring, one sequence over
// every column block; each thread consumes only what it copied, so no
// barrier.  Each column is summed over the rows in order, at any CPT.
template <typename T, int CPT>
__device__ void grad_pass(const TileCtx<T>& c, int dst) {
  constexpr int V = Chunk<T>::v;
  constexpr int RCC = Chunk<T>::rc / CPT;          // rows per chunk
  using VT = typename Vec<T>::V;
  const int n = c.n, rows = c.rows, zrs = zrow_stride(rows), tile = c.tile;
  const int NT = kGroup * c.groups, btid = threadIdx.x, CB = NT * CPT;
  const T* zbuf = c.zbuf;
  T* As = c.stage;                                  // kStages x RCC x CB
  const unsigned long long pol = l2_keep();
  const int nrc = (rows + RCC - 1) / RCC;
  const int total = (n + CB - 1) / CB * nrc;
  auto issue = [&](int q) {
    if (q < total) {
      const int j = q / nrc * CB + btid * CPT, r0 = q % nrc * RCC;
      T* d = As + (long long)(q % kStages) * RCC * CB + btid * CPT;
      if (j < n)
        for (int u = 0; u < RCC; ++u)
          if (r0 + u < rows) {
            if constexpr (CPT == V)
              cp_async16_keep(d + u * CB, c.d0 + (long long)(r0 + u) * n + j, pol);
            else
              cp_async_keep(d + u * CB, c.d0 + (long long)(r0 + u) * n + j, pol);
          }
    }
    cp_async_commit();
  };
  T acc[kMaxTile][CPT];
#pragma unroll
  for (int t = 0; t < kMaxTile; ++t)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[t][cc] = 0;
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    issue(q + kStages - 1);                         // into the slot chunk q - 1 left
    cp_async_wait_ring();                           // chunk q has landed
    const int j = q / nrc * CB + btid * CPT, ch = q % nrc, r0 = ch * RCC;
    if (j < n) {
      const T* Ab = As + (long long)(q % kStages) * RCC * CB + btid * CPT;
      const int rcnt = rows - r0 < RCC ? rows - r0 : RCC;
      for (int u = 0; u < rcnt; ++u) {
        T a[CPT];
        if constexpr (CPT == V)
          put(*reinterpret_cast<const VT*>(Ab + u * CB), a);
        else
          a[0] = Ab[u * CB];
#pragma unroll
        for (int t = 0; t < kMaxTile; ++t)
          if (t < tile) {
            const T zr = zbuf[t * zrs + r0 + u];
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) acc[t][cc] += zr * a[cc];
          }
      }
    }
    if (ch == nrc - 1) {                            // the column block is done
#pragma unroll
      for (int t = 0; t < kMaxTile; ++t) {
        if (t < tile && c.PART[t] > T(0))
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
            if (j + cc < n) c.vec(t, dst)[j + cc] = acc[t][cc];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[t][cc] = 0;
      }
    }
  }
}

// The objective at the tile's vectors in slot src (and its gradient into
// slot dst): every thread of the block calls it; an instance with
// part = false neither reads nor writes.  For LOG_SUM_EXP, vneed = false
// reuses the z the instance's last value pass left in its rows (its x is
// the same): the tile's value pass runs only if some instance needs it.
// Returns the caller's f.
template <typename T>
__device__ __noinline__ T tile_eval(const TileCtx<T>& c, bool grad, int src,
                                    int dst, bool part, bool vneed) {
  constexpr int V = Chunk<T>::v;
  const Grp<T>& bk = c.bk;
  const int n = c.n, tile = c.tile;
  const int tid = bk.tid, grp = c.grp;
  const T INF = (T)INFINITY;
  if (tid == 0) {
    c.PART[grp] = part ? T(1) : T(0);
    c.VNEED[grp] = part && vneed ? T(1) : T(0);
  }
  __syncthreads();
  bool anyp = false, anyv = false;
  for (int t = 0; t < tile; ++t) {
    anyp = anyp || c.PART[t] > T(0);
    anyv = anyv || c.VNEED[t] > T(0);
  }
  const T* xs = c.vec(grp, src);
  T* gs = c.vec(grp, dst);
  T f = 0;
  switch (c.objective) {
    case kRosenbrock:
      if (part) {
        T s = 0;
        for (int i = tid; i < n; i += kGroup) {
          T gi = 0;
          if (i < n - 1) {
            const T a = xs[i + 1] - xs[i] * xs[i];
            const T b = T(1) - xs[i];
            s += T(100) * (a * a) + b * b;
            gi = T(-400) * xs[i] * a - T(2) * b;
          }
          if (grad) {
            if (i > 0) gi += T(200) * (xs[i] - xs[i - 1] * xs[i - 1]);
            gs[i] = gi;
          }
        }
        f = bk.sum(s);
      }
      break;
    case kWeightedSquares:                   // 0.5 sum_i d_i (x_i - t_i)^2
      if (part) {
        T s = 0;
        for (int i = tid; i < n; i += kGroup) {
          const T r = xs[i] - c.d1[i];
          if (grad) {
            const T gi = c.d0[i] * r;
            gs[i] = gi;
            s += gi * r;
          } else {
            s += c.d0[i] * r * r;
          }
        }
        f = T(0.5) * bk.sum(s);
      }
      break;
    case kQuadratic: {
      // 0.5 x^T Q x + b^T x; the gradient 0.5 (Q x + Q^T x) + b is
      // autodiff's for a Q that is not exactly symmetric.  Q x goes to XC
      // and Q^T x to RF of each instance (both free during evaluations),
      // from one pass over Q's rows.
      T* XCv = c.vec(grp, kXC);
      T* RFv = c.vec(grp, kRF);
      if (part && grad)
        for (int i = tid; i < n; i += kGroup) RFv[i] = 0;
      if (anyp)
        rows_pass(c, c.d0, n, src, c.PART, grad, [&](int r, const T (&acc)[kMaxTile]) {
          if (r < n)
#pragma unroll
            for (int t = 0; t < kMaxTile; ++t)
              if (t < tile && c.PART[t] > T(0)) c.vec(t, kXC)[r] = acc[t];
        });
      __syncthreads();
      if (part) {
        T a0 = 0, a1 = 0;
        for (int i = tid; i < n; i += kGroup) {
          const T qx = XCv[i];
          a0 += xs[i] * qx;
          a1 += c.d1[i] * xs[i];
          if (grad) gs[i] = T(0.5) * (qx + RFv[i]) + c.d1[i];
        }
        bk.sum2(a0, a1);
        f = T(0.5) * bk.out[0] + bk.out[1];
      }
      break;
    }
    case kLogSumExp: {
      // log sum_r exp(a_r^T x + b_r) as z_max + log sum_r exp(z_r - z_max)
      const int rows = c.rows, zrs = zrow_stride(rows);
      T* zbuf = c.zbuf;
      K2_PROF(const long long prof_v0 = clock64();)
      if (anyv)
        rows_pass_warp(c, c.d0, rows, src, c.VNEED, [&](int r, const T (&acc)[kMaxTile]) {
          if (r < rows)
#pragma unroll
            for (int t = 0; t < kMaxTile; ++t)
              if (t < tile && c.VNEED[t] > T(0)) zbuf[t * zrs + r] = acc[t] + c.d1[r];
        });
      __syncthreads();
      K2_PROF(if (threadIdx.x == 0)
                atomicAdd(&k2_prof[14], (unsigned long long)(clock64() - prof_v0));)
      T* z = zbuf + grp * zrs;
      if (part) {
        T m_ = -INF;
        for (int r = tid; r < rows; r += kGroup) m_ = jmax(m_, z[r]);
        const T mx = bk.max(m_);
        T e = 0;
        for (int r = tid; r < rows; r += kGroup) e += exp(z[r] - mx);
        const T s = bk.sum(e);
        f = mx + log(s);
        if (grad)
          for (int r = tid; r < rows; r += kGroup) z[r] = exp(z[r] - mx) / s;
      }
      if (grad && anyp) {
        // g_t = softmax(z_t)^T A (after a barrier: z holds softmax(z))
        __syncthreads();
        K2_PROF(const long long prof_g0 = clock64();)
        if (n % V == 0)
          grad_pass<T, V>(c, dst);
        else
          grad_pass<T, 1>(c, dst);
        K2_PROF(__syncthreads(); if (threadIdx.x == 0)
                  atomicAdd(&k2_prof[10], (unsigned long long)(clock64() - prof_g0));)
      }
      break;
    }
  }
  if (tid == 0) c.FT[grp] = f;
  __syncthreads();
  return c.FT[grp];
}

template <typename T, int MX>
__global__ void __launch_bounds__(kMaxThreads) lbfgsb_tall_kernel(const Params<T> prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int M2X = 2 * MX;
  constexpr int KC = Chunk<T>::kc, RC = Chunk<T>::rc;
  const int tile = prm.tile;
  const int grp = threadIdx.x / kGroup;
  const int inst = blockIdx.x * tile + grp;
  const bool real = grp < tile && inst < prm.B;
  const int n = prm.n, m = prm.m, m2 = 2 * prm.m;
  const int R = hist_stride(m);
  const T INF = (T)INFINITY;
  const T eps = prm.eps;

  Grp<T> bk;
  bk.tid = threadIdx.x % kGroup;
  bk.lane = bk.tid & (kWarp - 1);
  bk.warp = bk.tid / kWarp;
  bk.bar = 1 + grp;
  bk.rw = red_width(MX);
  const int tid = bk.tid, lane = bk.lane, wid = bk.warp;
  const bool warp0 = wid == 0;

  // shared memory
  const Layout L(prm.objective, tile, prm.groups, m, prm.rows, MX, KC, Chunk<T>::ks, RC,
                 warp_stage<T>());
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const stage = smem;
  T* const zbuf = smem + L.stage;
  T* const FT = zbuf + L.zbuf;                  // f of each instance of the tile
  T* const PART = FT + kMaxTile;                // 1: the instance takes part
  T* const VNEED = PART + kMaxTile;             // 1: its z must be computed
  T* sp = VNEED + kMaxTile + grp * L.group;
  bk.red = sp; sp += kGroupWarps * bk.rw;
  bk.out = sp; sp += bk.rw;
  T* SY = sp; sp += m * m;      // S.Y, chronological
  T* SS = sp; sp += m * m;      // S.S, chronological
  T* MM = sp; sp += 4 * m * m;  // explicit inverse of the middle matrix
  T* W0 = sp; sp += m * m;      // U, then E and its factor
  T* W1 = sp; sp += m * m;      // Sc and its factor, then Gm
  T* W2 = sp; sp += m * m;      // J, then E^-1 Gm
  T* W3 = sp; sp += m * m;      // JU, then H, Sch2 and its factor
  T* DL = sp; sp += m;          // D with invalid slots patched to 1
  T* VAL = sp; sp += m;         // 1 where a history slot holds a pair
  T* P2 = sp; sp += m2;         // W^T d of a probe
  T* C2 = sp; sp += m2;         // W^T u of a probe; W^T (xcp - x)
  T* MC = sp; sp += m2;         // M c
  T* U2 = sp; sp += m2;         // W^T r_F
  T* CO = sp; sp += m2;         // subspace coefficients [u; v]
  T* TMP = sp; sp += m2;
  T* CS = sp; sp += m2;         // coefficients in slot order, theta folded in
  T* PZ = sp; sp += m2;         // a probe's sum of z w (slot order)
  T* PA = sp; sp += m2;         // a probe's sum of g w (slot order)
  T* ZLc = sp; sp += m2;        // carried: z w below the bracket
  T* AHc = sp; sp += m2;        // carried: g w above the bracket
  T* BC = sp;                   // scalars broadcast from warp 0
  T* const GS = stage + (long long)grp * kGramRow * (m2 + 1);     // Gram chunk

  const long long vstride = (long long)kVecs * n;
  T* const hist_base = prm.work;
  T* const vec_base = prm.work + (long long)prm.B * n * R;
  const int inst_c = real ? inst : 0;
  T* const V0 = vec_base + (long long)inst_c * vstride;
  T* X = V0 + (long long)kX * n;
  T* G = V0 + (long long)kG * n;
  T* TB = V0 + (long long)kTB * n;
  T* BV = V0 + (long long)kBV * n;
  T* XC = V0 + (long long)kXC * n;
  T* RF = V0 + (long long)kRF * n;
  T* D = V0 + (long long)kD * n;
  T* XT = V0 + (long long)kXT * n;
  T* GT = V0 + (long long)kGT * n;
  int* KL = reinterpret_cast<int*>(V0 + (long long)kList * n);
  T* const WH = hist_base + (long long)inst_c * n * R;     // row i at WH + i R
  const T* lo = prm.lo + (long long)inst_c * prm.bstride;
  const T* up = prm.up + (long long)inst_c * prm.bstride;
  const T* x0 = prm.x0 + (long long)inst_c * n;
  // this warp's contiguous range of coordinates (the bisection's list)
  const int r_lo = (int)((long long)n * wid / kGroupWarps);
  const int r_hi = (int)((long long)n * (wid + 1) / kGroupWarps);

  int oldest = 0;               // ring slot of the chronologically oldest pair
  auto slot = [&](int q) { const int s = oldest + q; return s >= m ? s - m : s; };
  auto chron = [&](int s) { const int q = s - oldest; return q < 0 ? q + m : q; };
  T theta = 1;

  TileCtx<T> tc;
  tc.d0 = prm.d0;
  tc.d1 = prm.d1;
  tc.rows = prm.rows;
  tc.n = n;
  tc.objective = prm.objective;
  tc.tile = tile;
  tc.groups = prm.groups;
  tc.grp = grp;
  tc.stage = stage;
  tc.zbuf = zbuf;
  tc.FT = FT;
  tc.PART = PART;
  tc.VNEED = VNEED;
  tc.vecs = vec_base + (long long)blockIdx.x * tile * vstride;
  tc.vstride = vstride;
  tc.bk = bk;

  // ---- small dense algebra on warp 0 (shared memory) ----------------------
  // in-place lower Cholesky of an m x m table, pivots floored at eps
  auto chol = [&](T* A) {
    for (int j = 0; j < m; ++j) {
      if (lane == 0) {
        T d = A[j * m + j];
        for (int k = 0; k < j; ++k) d = d - A[j * m + k] * A[j * m + k];
        A[j * m + j] = sqrt(jmax(d, eps));
      }
      __syncwarp();
      const T dj = A[j * m + j];
      for (int i = j + 1 + lane; i < m; i += kWarp) {
        T s = A[i * m + j];
        for (int k = 0; k < j; ++k) s = s - A[i * m + k] * A[j * m + k];
        A[i * m + j] = s / dj;
      }
      __syncwarp();
    }
  };
  // solve (A A^T) z = v in place for a lower factor A; v strided (one lane)
  auto chol_solve = [&](const T* A, T* v, int stride) {
    for (int i = 0; i < m; ++i) {
      T s = v[i * stride];
      for (int k = 0; k < i; ++k) s = s - A[i * m + k] * v[k * stride];
      v[i * stride] = s / A[i * m + i];
    }
    for (int i = m - 1; i >= 0; --i) {
      T s = v[i * stride];
      for (int k = i + 1; k < m; ++k) s = s - A[k * m + i] * v[k * stride];
      v[i * stride] = s / A[i * m + i];
    }
  };
  // MM = explicit inverse of the middle matrix (pallas_lbfgsb_tall.py:170-257)
  auto build_middle = [&]() {
    for (int q = lane; q < m; q += kWarp) DL[q] = VAL[q] > T(0) ? SY[q * m + q] : T(1);
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // U = L / D
      const int p = e / m, q = e % m;
      W0[e] = (q < p ? SY[e] : T(0)) / DL[q];
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // Sc
      const int p = e / m, q = e % m;
      const T ssp = SS[e] + ((p == q && !(VAL[p] > T(0))) ? T(1) : T(0));
      T v = theta * ssp;
      for (int k = 0; k < m; ++k) v = v + W0[p * m + k] * (k < q ? SY[q * m + k] : T(0));
      W1[e] = v;
    }
    __syncwarp();
    chol(W1);
    for (int j = lane; j < m; j += kWarp) {                // J = Sc^-1, by columns
      for (int i = 0; i < m; ++i) W2[i * m + j] = i == j ? T(1) : T(0);
      chol_solve(W1, W2 + j, m);
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // JU
      const int p = e / m, q = e % m;
      T v = 0;
      for (int k = 0; k < m; ++k) v = v + W2[p * m + k] * W0[k * m + q];
      W3[e] = v;
    }
    __syncwarp();
    for (int e = lane; e < m * m; e += kWarp) {           // the four blocks
      const int p = e / m, q = e % m;
      T v = 0;
      for (int k = 0; k < m; ++k) v = v + W0[k * m + p] * W3[k * m + q];
      if (p == q) v = v - T(1) / DL[p];
      MM[p * m2 + q] = v;                                  // TL
      MM[p * m2 + m + q] = W3[q * m + p];                  // JU^T
      MM[(m + p) * m2 + q] = W3[p * m + q];                // JU
      MM[(m + p) * m2 + m + q] = W2[p * m + q];            // J
    }
  };
  // on warp 0: (a^T M b, a^T M c) for 2m-vectors a, b, c
  auto mquad2 = [&](const T* a, const T* b, const T* c, T& ab, T& ac) {
    T sb = 0, sc = 0;
    for (int r = lane; r < m2; r += kWarp) {
      T mb = 0, mc = 0;
      for (int k = 0; k < m2; ++k) {
        mb += MM[r * m2 + k] * b[k];
        mc += MM[r * m2 + k] * c[k];
      }
      sb += a[r] * mb;
      sc += a[r] * mc;
    }
    ab = warp_sum(sb);
    ac = warp_sum(sc);
  };
  auto seg_min = [&](T f1, T f2) -> T {
    return f2 > eps ? -f1 / f2 : (f1 < T(0) ? INF : T(0));
  };
  // slot-ordered coefficients of W c for a chronological 2m-vector c
  // (warp 0; theta folded into the S half)
  auto to_slots = [&](const T* c) {
    for (int s = lane; s < m; s += kWarp) {
      const int q = chron(s);
      CS[s] = c[q];
      CS[m + s] = c[m + q] * theta;
    }
  };
  // (W c)_i from a row in registers and CS
  auto w_apply = [&](const T (&w)[M2X]) -> T {
    T a = 0;
#pragma unroll
    for (int k = 0; k < M2X; ++k)
      if (k < m2) a = a + CS[k] * w[k];
    return a;
  };

  // ---- the Cauchy point's probes ---------------------------------------------
  // (f1, f2) of the model along the projected path at t_lo+, from the
  // slot-ordered sums PZ = sum_{tb <= t} z w and PA = sum_{tb > t} g w and
  // G2F = sum_{tb > t} g^2 over moving coordinates: W^T d = -PA and
  // W^T u = PZ - t PA
  // (two calls can follow each other with no barrier between a slow warp's
  // read of BC and the next write: the calls alternate between two slots)
  int bslot = 0;
  auto finish = [&](T t, T g2f, T& f1, T& f2) {
    T* const bc = BC + 2 * bslot;
    bslot ^= 1;
    if (warp0) {
      __syncwarp();
      for (int q = lane; q < m; q += kWarp) {
        const int s = slot(q);
        P2[q] = -PA[s];
        P2[m + q] = theta * -PA[m + s];
        C2[q] = PZ[s] - t * PA[s];
        C2[m + q] = theta * (PZ[m + s] - t * PA[m + s]);
      }
      __syncwarp();
      T pc, pp;
      mquad2(P2, C2, P2, pc, pp);
      if (lane == 0) {
        bc[0] = (theta * t - T(1)) * g2f - pc;
        bc[1] = theta * g2f - pp;
      }
    }
    bk.sync();
    f1 = bc[0];
    f2 = bc[1];
  };
  auto converged = [&](T Fv, T Fprev) -> bool {
    T pg = 0;
    for (int i = tid; i < n; i += kGroup)
      pg = jmax(pg, (T)fabs(X[i] - jclip(X[i] - G[i], lo[i], up[i])));
    pg = bk.max(pg);
    const T fmax = jmax(jmax((T)fabs(Fv), (T)fabs(Fprev)), T(1));
    return (pg <= prm.pgtol) || (isfinite(Fprev) && (Fprev - Fv) <= prm.f_rtol * fmax);
  };

  // passes over the coordinates two at a time: both coordinates' loads are
  // issued before either is used, so twice the loads are in flight, and
  // each thread still takes its coordinates in order
  auto pairs = [&](auto&& load, auto&& use) {
    for (int i = tid; i < n; i += 2 * kGroup) {
      const int j = i + kGroup;
      const auto a = load(i);
      auto b = a;
      if (j < n) b = load(j);
      use(i, a);
      if (j < n) use(j, b);
    }
  };
  struct Row { T w[M2X]; };
  struct In4 { T a, b, c, d; };

  // ---- solver state -----------------------------------------------------------
  if (real) {
    for (int i = tid; i < n; i += kGroup) X[i] = jclip(x0[i], lo[i], up[i]);
    for (long long i = tid; i < (long long)n * R; i += kGroup) WH[i] = 0;
    for (int e = tid; e < m * m; e += kGroup) { SY[e] = 0; SS[e] = 0; }
    for (int e = tid; e < m; e += kGroup) VAL[e] = 0;
  }
  T Fv = tile_eval(tc, true, kX, kG, real, true);
  T Fprev = INF;
  int iters = 0;
  bool abn = false, gflag = false;

  bool active = real && isfinite(Fv) && !converged(Fv, Fprev);
  K2_PROF(long long prof_acc[16] = {0}; long long prof_t = clock64();)
  for (int it = 0; it < prm.max_iter; ++it) {
    if (!__syncthreads_or(active)) break;
    K2_PHASE(15);
    T t = 0, f0 = Fv, g0d = 0, stpmax = 0;
    if (active) {
      if (warp0) build_middle();
      bk.sync();
      K2_PHASE(0);

      // ---- generalized Cauchy point: the first pass evaluates t = 0 and
      // t = hi0 and lists the coordinates with finite breakpoints
      T t_min = INF, hi0 = -INF;
      int klen = 0;                                      // this warp's list
      {
        T acc[6 * MX + 2];
#pragma unroll
        for (int j = 0; j < 6 * MX + 2; ++j) acc[j] = 0;
        for (int base = r_lo; base < r_hi; base += kWarp) {
          const int i = base + lane;
          bool keep = false;
          if (i < r_hi) {
            const T g = G[i], x = X[i];
            const T tb = g < T(0) ? (x - up[i]) / g : (g > T(0) ? (x - lo[i]) / g : INF);
            const T bv = g < T(0) ? up[i] : (g > T(0) ? lo[i] : x);
            TB[i] = tb;
            BV[i] = bv;
            if (tb > T(0)) {
              const bool fin = isfinite(tb);
              t_min = jmin(t_min, tb);
              if (fin) hi0 = jmax(hi0, tb);
              keep = fin;
              T w[M2X];
              load_row(WH + (long long)i * R, R, w);
              const T ck = fin ? g : T(0), ch = fin ? T(0) : g, cz = fin ? bv - x : T(0);
#pragma unroll
              for (int k = 0; k < M2X; ++k)
                if (k < m2) {
                  acc[k] += ck * w[k];
                  acc[M2X + k] += ch * w[k];
                  acc[2 * M2X + k] += cz * w[k];
                }
              acc[3 * M2X] += ck * g;
              acc[3 * M2X + 1] += ch * g;
            }
          }
          const unsigned bal = __ballot_sync(kFull, keep);
          if (keep) KL[r_lo + klen + __popc(bal & ((1u << lane) - 1u))] = i;
          klen += __popc(bal);
        }
        bk.reduce(acc, 3 * M2X + 2, hi0, t_min);
      }
      // out: AK = sum_K g w, AH = sum_H g w, ZK = sum_K z w, G2K, G2H over
      // K (finite breakpoints) and H (infinite ones)
      const T G2K = bk.out[3 * M2X], G2H0 = bk.out[3 * M2X + 1];
      if (warp0)
        for (int k = lane; k < m2; k += kWarp) {
          PZ[k] = 0;
          PA[k] = bk.out[k] + bk.out[M2X + k];
          AHc[k] = bk.out[M2X + k];
          ZLc[k] = 0;
        }
      const bool has_fin = hi0 > T(0);
      T f1, f2;
      finish(T(0), G2K + G2H0, f1, f2);
      const T dt0 = seg_min(f1, f2);
      const bool doneA = f1 >= T(0);                     // t_cp = 0
      const bool doneB = !doneA && dt0 <= t_min;         // min in the 1st segment
      bool doneC = false;
      T dtL = 0;
      if (!doneA && !doneB) {
        if (warp0)
          for (int k = lane; k < m2; k += kWarp) {
            PZ[k] = bk.out[2 * M2X + k];
            PA[k] = bk.out[M2X + k];
          }
        finish(has_fin ? hi0 : T(0), G2H0, f1, f2);
        dtL = seg_min(f1, f2);
        doneC = has_fin && f1 < T(0);
      }
      bool done = doneA || doneB || doneC;
      T t_fin = doneC ? hi0 : T(0);
      T dtm = doneA ? T(0) : (doneB ? dt0 : dtL);
      T b_lo = t_min, b_hi = hi0;
      K2_PHASE(1);

      // ---- bisection over the bracket's list.  Below the list's window
      // [Lb, Hb] the coordinates are carried in ZLc (and Lmax, their
      // largest breakpoint), above it in AHc and G2Hc (Hmin, their
      // smallest); when a probe point falls outside (Lmax, Hmin) the list
      // becomes every moving coordinate again
      T Lb = t_min, Hb = hi0, Lmax = 0, Hmin = INF, G2Hc = G2H0;
      bool whole = false;
      T below = 0, above = INF, gcnt = 0, sK = 0;
      auto probe = [&](T t_at, T& t_lo, T& t_hi) {
        if (!whole && !(Lmax <= t_at && t_at < Hmin)) {
          klen = 0;
          for (int base = r_lo; base < r_hi; base += kWarp) {
            const int i = base + lane;
            const bool keep = i < r_hi && TB[i] > T(0);
            const unsigned bal = __ballot_sync(kFull, keep);
            if (keep) KL[r_lo + klen + __popc(bal & ((1u << lane) - 1u))] = i;
            klen += __popc(bal);
          }
          if (warp0)
            for (int k = lane; k < m2; k += kWarp) { ZLc[k] = 0; AHc[k] = 0; }
          G2Hc = 0;
          Lmax = 0;
          Hmin = INF;
          Lb = 0;
          Hb = INF;
          whole = true;
        }
        // segment of t_at, compacting the list to [Lb, Hb]; the guard's
        // count of breakpoints in (b_lo, b_hi]
        {
          T bl = 0, ab = INF, cnt = 0;
          int kept = 0;
          for (int base = 0; base < klen; base += kWarp) {
            const int p = base + lane;
            int i = 0;
            T tb = 0;
            bool keep = false;
            if (p < klen) {
              i = KL[r_lo + p];
              tb = TB[i];
              keep = Lb <= tb && tb <= Hb;
            }
            const unsigned bal = __ballot_sync(kFull, keep);
            if (keep) {
              KL[r_lo + kept + __popc(bal & ((1u << lane) - 1u))] = i;
              if (tb <= t_at) bl = jmax(bl, tb);
              else if (tb > t_at) ab = jmin(ab, tb);
              if (tb > b_lo && tb <= b_hi) cnt += T(1);
            }
            kept += __popc(bal);
          }
          klen = kept;
          T c1v[1] = {cnt};
          bk.reduce(c1v, 1, bl, ab);
          gcnt = bk.out[0];
          below = jmax(bl, Lmax);
          above = jmin(ab, Hmin);
        }
        t_lo = below;
        t_hi = below > T(0) ? above : t_min;
        // the probe's sums over the list
        T acc[4 * MX + 1];
#pragma unroll
        for (int j = 0; j < 4 * MX + 1; ++j) acc[j] = 0;
        for (int p = lane; p < klen; p += kWarp) {
          const int i = KL[r_lo + p];
          const T tb = TB[i], g = G[i];
          const bool le = tb <= t_lo;
          const T cz = le ? BV[i] - X[i] : T(0), cg = le ? T(0) : g;
          T w[M2X];
          load_row(WH + (long long)i * R, R, w);
#pragma unroll
          for (int k = 0; k < M2X; ++k)
            if (k < m2) {
              acc[k] += cz * w[k];
              acc[M2X + k] += cg * w[k];
            }
          acc[2 * M2X] += cg * g;
        }
        T hi = 0, lo_ = 0;
        bk.reduce(acc, 2 * M2X + 1, hi, lo_);
        sK = bk.out[2 * M2X];
        if (warp0)
          for (int k = lane; k < m2; k += kWarp) {
            PZ[k] = ZLc[k] + bk.out[k];
            PA[k] = AHc[k] + bk.out[M2X + k];
          }
      };
      for (int j = 0; j < prm.bisect_iters && !done; ++j) {
        T t_lo, t_hi;
        K2_PROF(if (tid == 0) atomicAdd(&k2_prof[12], 1ull);
                if (lane == 0) atomicAdd(&k2_prof[13], (unsigned long long)klen);)
        probe(sqrt(b_lo) * sqrt(b_hi), t_lo, t_hi);
        finish(t_lo, G2Hc + sK, f1, f2);
        const T dt = seg_min(f1, f2);
        if ((f1 >= T(0) && t_lo <= b_lo) || (f1 < T(0) && t_lo + dt <= t_hi)) {
          done = true;
          t_fin = t_lo;
          dtm = dt;
        } else if (f1 >= T(0)) {
          // coordinates above t_lo join the carried sums
          b_hi = t_lo;
          if (warp0)
            for (int k = lane; k < m2; k += kWarp) AHc[k] = PA[k];
          G2Hc = G2Hc + sK;
          Hmin = above;
          Hb = t_lo;
          whole = false;
        } else if (f1 < T(0)) {
          // coordinates at or below t_lo join the carried sums
          b_lo = t_hi;
          if (warp0)
            for (int k = lane; k < m2; k += kWarp) ZLc[k] = PZ[k];
          Lmax = below;
          Lb = t_hi;
          whole = false;
        }
      }
      T t_lo_fin = t_fin;
      if (!done) {
        // budget exhausted: finalize in the bracket's lo segment, dt clamped
        T t_lo, t_hi;
        probe(b_lo, t_lo, t_hi);
        finish(t_lo, G2Hc + sK, f1, f2);
        t_lo_fin = t_lo;
        dtm = jclip(seg_min(f1, f2), T(0), t_hi - t_lo);
        if (prm.guard_maxseg > 0 && gcnt <= T(prm.guard_maxseg)) gflag = true;
      }
      dtm = jmax(dtm, T(0));
      const T t_cp = t_lo_fin + dtm;
      K2_PHASE(2);

      // ---- Cauchy point and c = W^T (xcp - x)
      {
        T acc[M2X];
#pragma unroll
        for (int k = 0; k < M2X; ++k) acc[k] = 0;
        struct In { In4 s; Row r; };
        pairs([&](int i) {
          In v;
          v.s = In4{TB[i], G[i], BV[i], X[i]};
          load_row(WH + (long long)i * R, R, v.r.w);
          return v;
        }, [&](int i, const In& v) {
          const T tb = v.s.a, x = v.s.d;
          const T fr = (tb > T(0) && tb > t_lo_fin) ? T(1) : T(0);
          const T d_rem = -v.s.b * fr;
          // t_cp is inf only where d_rem == 0: skip the inf * 0
          const T xc = (tb > T(0) && tb <= t_lo_fin) ? v.s.c
                                                     : x + (d_rem == T(0) ? T(0) : t_cp * d_rem);
          XC[i] = xc;
          const T dv = xc - x;
#pragma unroll
          for (int k = 0; k < M2X; ++k)
            if (k < m2) acc[k] += v.r.w[k] * dv;
        });
        T hi = 0, lo_ = 0;
        bk.reduce(acc, m2, hi, lo_);
        if (warp0) {
          for (int q = lane; q < m; q += kWarp) {
            C2[q] = bk.out[slot(q)];
            C2[m + q] = theta * bk.out[m + slot(q)];
          }
          __syncwarp();
          for (int r = lane; r < m2; r += kWarp) {
            T v = 0;
            for (int k = 0; k < m2; ++k) v += MM[r * m2 + k] * C2[k];
            MC[r] = v;
          }
          __syncwarp();
          to_slots(MC);
        }
        bk.sync();
      }

      K2_PHASE(3);
      // ---- subspace minimization from the Cauchy point.  One pass: r_F
      // and the rows of W on free coordinates are staged in chunks; each
      // thread owns entries of their Gram matrix and of W^T r_F
      {
        const int ntri = m2 * (m2 + 1) / 2, nent = ntri + m2;
        constexpr int EPT = (MX * (2 * MX + 1) + 2 * MX + kGroup - 1) / kGroup;
        int ea[EPT], eb[EPT];
        T ge[EPT];
#pragma unroll
        for (int u = 0; u < EPT; ++u) {
          int e = tid + u * kGroup, a = 0;
          ge[u] = 0;
          ea[u] = -1;
          eb[u] = 0;
          if (e < ntri) {
            while (e >= m2 - a) { e -= m2 - a; ++a; }
            ea[u] = a;
            eb[u] = a + e;
          } else if (e < nent) {
            ea[u] = e - ntri;
            eb[u] = m2;
          }
        }
        const int gw = m2 + 1;
        // each thread stages one coordinate of a chunk; the next chunk's
        // row and scalars are in flight while the chunk is summed
        T w[M2X];
        T g_n = 0, xc_n = 0, x_n = 0, tb_n = 0;
        auto fetch = [&](int i) {
          if (i < n) {
            load_row(WH + (long long)i * R, R, w);
            g_n = G[i];
            xc_n = XC[i];
            x_n = X[i];
            tb_n = TB[i];
          }
        };
        fetch(tid);
        // the chunk is stored value-major (row k holds value k of every
        // coordinate), so an entry's sum reads 16 bytes at a time
        constexpr int V = Chunk<T>::v;
        using VT = typename Vec<T>::V;
        for (int c0 = 0; c0 < n; c0 += kGramChunk) {
          {
            const int i = c0 + tid;
            if (i < n) {
              const T fr = (tb_n > T(0) && tb_n > t_lo_fin) ? T(1) : T(0);
              const T rf = (g_n + theta * (xc_n - x_n) - w_apply(w)) * fr;
              RF[i] = rf;
#pragma unroll
              for (int k = 0; k < M2X; ++k)
                if (k < m2) GS[k * kGramRow + tid] = w[k] * fr;
              GS[m2 * kGramRow + tid] = rf;
            } else {
              for (int k = 0; k <= m2; ++k) GS[k * kGramRow + tid] = 0;
            }
            fetch(i + kGramChunk);
          }
          bk.sync();
          const int cn = n - c0 < kGramChunk ? n - c0 : kGramChunk;
#pragma unroll
          for (int u = 0; u < EPT; ++u)
            if (ea[u] >= 0) {
              const T* ra = GS + ea[u] * kGramRow;
              const T* rb = GS + eb[u] * kGramRow;
              T s = ge[u];
              int cc = 0;
              for (; cc + V <= cn; cc += V) {      // coordinates in order
                T a[V], b[V];
                put(*reinterpret_cast<const VT*>(ra + cc), a);
                put(*reinterpret_cast<const VT*>(rb + cc), b);
#pragma unroll
                for (int v = 0; v < V; ++v) s += a[v] * b[v];
              }
              for (; cc < cn; ++cc) s += ra[cc] * rb[cc];
              ge[u] = s;
            }
          bk.sync();
        }
        // the Gram matrix (upper triangle, slot order) and W^T r_F into GS
        T* GR = GS;
#pragma unroll
        for (int u = 0; u < EPT; ++u)
          if (ea[u] >= 0) GR[ea[u] * gw + eb[u]] = ge[u];
        bk.sync();
        // E = Y_F Y_F^T / theta + D, H = theta (S.S~ - S_F S_F^T),
        // Gm = L^T - Y_F S_F^T, chronological
        for (int e = tid; e < m * m; e += kGroup) {
          const int p = e / m, q = e % m;
          const int sp_ = slot(p), sq = slot(q);
          if (q <= p) {
            const int a = sq < sp_ ? sq : sp_, b = sq < sp_ ? sp_ : sq;
            T ev = GR[a * gw + b] / theta;
            if (q == p) ev = ev + DL[p];
            const T ssp = SS[p * m + q] + ((p == q && !(VAL[p] > T(0))) ? T(1) : T(0));
            const T h = theta * (ssp - GR[(m + a) * gw + m + b]);
            W0[p * m + q] = ev;
            W0[q * m + p] = ev;
            W3[p * m + q] = h;
            W3[q * m + p] = h;
          }
          W1[p * m + q] = (q > p ? SY[q * m + p] : T(0)) - GR[sp_ * gw + m + sq];
        }
        for (int q = tid; q < m; q += kGroup) {
          U2[q] = GR[slot(q) * gw + m2];
          U2[m + q] = theta * GR[(m + slot(q)) * gw + m2];
        }
        bk.sync();
      }
      K2_PHASE(4);
      if (warp0) {
        chol(W0);                                        // E
        for (int j = lane; j < m; j += kWarp) {          // E^-1 Gm, by columns
          for (int i = 0; i < m; ++i) W2[i * m + j] = W1[i * m + j];
          chol_solve(W0, W2 + j, m);
        }
        __syncwarp();
        for (int e = lane; e < m * m; e += kWarp) {      // Sch2 = H + Gm^T E^-1 Gm
          const int p = e / m, q = e % m;
          if (q > p) continue;
          T v = W3[e];
          for (int k = 0; k < m; ++k) v = v + W1[k * m + p] * W2[k * m + q];
          W3[e] = v;
        }
        __syncwarp();
        chol(W3);
        if (lane == 0) {
          for (int i = 0; i < m; ++i) TMP[i] = U2[i];
          chol_solve(W0, TMP, 1);                        // E^-1 a
          for (int i = 0; i < m; ++i) {
            T s = U2[m + i];
            for (int k = 0; k < m; ++k) s = s + W1[k * m + i] * TMP[k];
            CO[m + i] = s;
          }
          chol_solve(W3, CO + m, 1);                     // v
          for (int i = 0; i < m; ++i) {
            T s = -U2[i];
            for (int k = 0; k < m; ++k) s = s + W1[i * m + k] * CO[m + k];
            CO[i] = s;
          }
          chol_solve(W0, CO, 1);                         // u
        }
        __syncwarp();
        to_slots(CO);
      }
      bk.sync();
      K2_PHASE(5);
      T smin = INF;
      {
        struct In { In4 s; T u; Row r; };
        pairs([&](int i) {
          In v;
          v.s = In4{TB[i], RF[i], XC[i], lo[i]};
          v.u = up[i];
          load_row(WH + (long long)i * R, R, v.r.w);
          return v;
        }, [&](int i, const In& v) {
          const T tb = v.s.a, xc = v.s.c;
          const bool free_i = tb > T(0) && tb > t_lo_fin;
          const T fr = free_i ? T(1) : T(0);
          const T du = -(v.s.b / theta + fr * w_apply(v.r.w) / (theta * theta));
          D[i] = du;
          T st = du > T(0) ? (v.u - xc) / du : (du < T(0) ? (v.s.d - xc) / du : INF);
          if (!free_i || st != st) st = INF;
          smin = jmin(smin, st);
        });
      }
      const T alpha = jmin(T(1), bk.min(smin));
      T fsmin = INF;
      {
        struct In { In4 s; In4 t; };
        pairs([&](int i) {
          return In{In4{TB[i], XC[i], D[i], X[i]}, In4{G[i], lo[i], up[i], T(0)}};
        }, [&](int i, const In& v) {
          const T tb = v.s.a, x = v.s.d, l = v.t.b, u = v.t.c;
          const bool free_i = tb > T(0) && tb > t_lo_fin;
          const T d = jclip(v.s.b + alpha * (free_i ? v.s.c : T(0)), l, u) - x;
          D[i] = d;
          g0d += v.t.a * d;
          T fs = d > T(0) ? (u - x) / d : (d < T(0) ? (l - x) / d : INF);
          if (fs != fs) fs = INF;
          fsmin = jmin(fsmin, fs);
        });
      }
      g0d = bk.sum(g0d);
      stpmax = bk.min(fsmin);
    }

    K2_PHASE(6);
    // ---- line search, tile-wide: each loop runs while any instance of the
    // tile is open
    bool kept = false, zkept = false;
    T f_kept = 0;
    if (!prm.dcsrch) {
      // projected value-only Armijo backtracking, first trial capped
      t = jmin(T(1), stpmax);
      bool open = active;
      for (int k = 0; k < prm.max_iter_ls; ++k) {
        if (!__syncthreads_or(open)) break;
        if (open)
          for (int i = tid; i < n; i += kGroup) XT[i] = X[i] + t * D[i];
        const T fv = tile_eval(tc, false, kXT, kGT, open, true);
        if (open) {
          if (fv <= f0 + prm.c1 * t * g0d && isfinite(fv)) {
            open = false;
            zkept = true;               // XT is the step: its z stays
          } else {
            t = t * T(0.5);
          }
        }
      }
    } else {
      // MINPACK dcsrch strong Wolfe: ftol c1, gtol 0.9, xtol 0.1
      const T gtol = 0.9, xtol = 0.1, xtrapl = 1.1, xtrapu = 4.0;
      const T ginit = g0d, gtest = prm.c1 * ginit, stpmin = 0;
      const bool descent = ginit < T(0);
      T stp = descent ? jclip(T(1), stpmin, stpmax) : T(0);
      T stx = 0, fx = f0, dx = ginit, sty = 0, fy = f0, dy = ginit;
      bool brackt = false, stage1 = true;
      T width = stpmax - stpmin, width1 = width / T(0.5);
      T stmin = 0, stmax = stp + xtrapu * stp;
      bool wdone = !descent;
      for (int k = 0; k < prm.max_iter_ls; ++k) {
        const bool open = active && !wdone;
        if (!__syncthreads_or(open)) break;
        if (open)
          for (int i = tid; i < n; i += kGroup) XT[i] = X[i] + stp * D[i];
        const T ft = tile_eval(tc, true, kXT, kGT, open, true);
        if (!open) continue;
        T gd = 0;
        for (int i = tid; i < n; i += kGroup) gd += GT[i] * D[i];
        gd = bk.sum(gd);
        const T ftest = f0 + stp * gtest;
        const bool stage1_n = stage1 && !(ft <= ftest && gd >= T(0));
        const bool finish_ = (ft <= ftest && fabs(gd) <= gtol * (-ginit)) ||
                             (brackt && stmax - stmin <= xtol * stmax) ||
                             (stp == stpmax && ft <= ftest && gd <= gtest) ||
                             (stp == stpmin && (ft > ftest || gd >= gtest)) ||
                             (brackt && (stp <= stmin || stp >= stmax));
        if (finish_) {
          wdone = true;
          kept = true;                  // XT is the step: f and GT stay
          f_kept = ft;
          continue;
        }
        const bool mod = stage1_n && ft <= fx && ft > ftest;
        T sx = stx, fxm = mod ? fx - stx * gtest : fx, dxm = mod ? dx - gtest : dx;
        T sy = sty, fym = mod ? fy - sty * gtest : fy, dym = mod ? dy - gtest : dy;
        T sn = stp;
        bool br = brackt;
        dcstep(sx, fxm, dxm, sy, fym, dym, sn, mod ? ft - stp * gtest : ft,
               mod ? gd - gtest : gd, br, stmin, stmax);
        if (mod) {
          fxm = fxm + sx * gtest;
          fym = fym + sy * gtest;
          dxm = dxm + gtest;
          dym = dym + gtest;
        }
        if (br && fabs(sy - sx) >= T(0.66) * width1) sn = sx + T(0.5) * (sy - sx);
        const T width1_n = br ? width : width1;
        const T width_n = br ? (T)fabs(sy - sx) : width;
        const T stmin_n = br ? fmin(sx, sy) : sn + xtrapl * (sn - sx);
        const T stmax_n = br ? fmax(sx, sy) : sn + xtrapu * (sn - sx);
        sn = jclip(sn, stpmin, stpmax);
        if (br && (sn <= stmin_n || sn >= stmax_n || stmax_n - stmin_n <= xtol * stmax_n))
          sn = sx;
        stp = sn;
        stx = sx; fx = fxm; dx = dxm;
        sty = sy; fy = fym; dy = dym;
        brackt = brackt || br;
        stage1 = stage1_n;
        width = width_n;
        width1 = width1_n;
        stmin = stmin_n;
        stmax = stmax_n;
      }
      t = wdone ? stp : stx;                             // exhaustion returns stx
    }

    K2_PHASE(7);
    // ---- step, failure semantics and history update.  Where the search's
    // last trial was the step, XT is already x + t d, and the evaluation
    // there is reused: dcsrch's f and gradient, Armijo's z
    const bool eval = active && !kept;
    if (eval && !zkept)
      for (int i = tid; i < n; i += kGroup) XT[i] = X[i] + t * D[i];
    const T fe = tile_eval(tc, true, kXT, kGT, eval, !zkept);
    if (!active) continue;
    const T fnew = kept ? f_kept : fe;
    K2_PHASE(8);
    // read before the reduction below: its barrier orders every read of
    // VAL before the ring update or the wipe rewrites it
    bool has_hist = false;
    for (int q = 0; q < m; ++q) has_hist = has_hist || VAL[q] > T(0);
    // one pass for the step's checks and the curvature pair's s.y and y.y
    T sy = 0, yy = 0;
    bool ok, no_move;
    {
      T acc4[4] = {0, 0, 0, 0};                 // not finite, moved, s.y, y.y
      pairs([&](int i) { return In4{XT[i], GT[i], X[i], G[i]}; },
            [&](int i, const In4& v) {
        const T xt = v.a, gt = v.b, x = v.c;
        if (!(isfinite(xt) && isfinite(gt))) acc4[0] = T(1);
        if (!(xt == x)) acc4[1] = T(1);
        const T s = xt - x, y = gt - v.d;
        acc4[2] += s * y;
        acc4[3] += y * y;
      });
      T hi = 0, lo_ = 0;
      bk.reduce(acc4, 4, hi, lo_);
      ok = isfinite(fnew) && bk.out[0] == T(0);
      no_move = bk.out[1] == T(0);
      sy = bk.out[2];
      yy = bk.out[3];
    }
    const bool fail = !ok || fnew > f0 || t <= T(0) || no_move;
    const bool restart = fail && has_hist;
    if (fail && !has_hist) abn = true;
    const bool accept = !fail && sy > eps * yy;
    const int ns = oldest;                      // the slot the new pair takes
    if (accept) {
      oldest = slot(1);
      if (tid == 0) {
        for (int r = 0; r < m - 1; ++r) {
          for (int q = 0; q < m - 1; ++q) {
            SY[r * m + q] = SY[(r + 1) * m + q + 1];
            SS[r * m + q] = SS[(r + 1) * m + q + 1];
          }
          VAL[r] = VAL[r + 1];
        }
        VAL[m - 1] = 1;
      }
      theta = yy / sy;
    }
    if (restart) {
      // wipe the model: zero pairs are inert rows of W
      for (long long i = tid; i < (long long)n * R; i += kGroup) WH[i] = 0;
      for (int e = tid; e < m * m; e += kGroup) { SY[e] = 0; SS[e] = 0; }
      for (int e = tid; e < m; e += kGroup) VAL[e] = 0;
      theta = 1;
      oldest = 0;
    }
    // a restart disables the stall exit for the retry iteration
    Fprev = restart ? INF : f0;
    if (!fail) Fv = fnew;
    // one pass: the step taken, the new pair into its slot with its
    // products with every entry of the row (its own slot included: s_new.
    // y_q, s_new . s_q, s_q . y_new), and the projected gradient of the
    // stopping test
    {
      T acc[2 * M2X];
#pragma unroll
      for (int j = 0; j < 2 * M2X; ++j) acc[j] = 0;
      T pg = 0;
      struct In { In4 s; T l, u; Row r; };
      pairs([&](int i) {
        In v;
        v.s = In4{X[i], G[i], fail ? T(0) : XT[i], fail ? T(0) : GT[i]};
        v.l = lo[i];
        v.u = up[i];
        if (accept) load_row(WH + (long long)i * R, R, v.r.w);
        return v;
      }, [&](int i, const In& v) {
        T x = v.s.a, g = v.s.b;
        if (!fail) {
          const T xt = v.s.c, gt = v.s.d;
          if (accept) {
            const T sn = xt - x, yn = gt - g;
            T* row = WH + (long long)i * R;
            row[ns] = yn;
            row[m + ns] = sn;
#pragma unroll
            for (int k = 0; k < M2X; ++k)
              if (k < m2) {
                // the row as just written: the new pair in slot ns
                const T wk = k == ns ? yn : (k == m + ns ? sn : v.r.w[k]);
                acc[k] += sn * wk;
                acc[M2X + k] += yn * wk;
              }
          }
          X[i] = xt;
          G[i] = gt;
          x = xt;
          g = gt;
        }
        pg = jmax(pg, (T)fabs(x - jclip(x - g, v.l, v.u)));
      });
      T lo_ = 0;
      bk.reduce(acc, accept ? 2 * M2X : 0, pg, lo_);
      if (accept && tid == 0) {
        for (int j = 0; j < m; ++j) {
          const int s = slot(j);
          SY[(m - 1) * m + j] = bk.out[s];
          SY[j * m + m - 1] = bk.out[M2X + m + s];
          SS[(m - 1) * m + j] = bk.out[m + s];
          SS[j * m + m - 1] = bk.out[m + s];
        }
      }
      ++iters;
      K2_PROF(if (tid == 0) atomicAdd(&k2_prof[11], 1ull);)
      const T fmax = jmax(jmax((T)fabs(Fv), (T)fabs(Fprev)), T(1));
      const bool conv = (pg <= prm.pgtol) ||
                        (isfinite(Fprev) && (Fprev - Fv) <= prm.f_rtol * fmax);
      active = isfinite(Fv) && !abn && !conv;
    }
    K2_PHASE(9);
  }
  K2_PROF(if (tid == 0) for (int k = 0; k < 16; ++k) if (k != 10 && k != 14)
            atomicAdd(&k2_prof[k], (unsigned long long)prof_acc[k]);)

  if (!real) return;
  const bool finite = isfinite(Fv);
  const bool conv = converged(Fv, Fprev);
  const int status = abn ? 5 : ((conv && finite) ? 1 : (!finite ? 3 : 2));
  for (int i = tid; i < n; i += kGroup) prm.x_out[(long long)inst * n + i] = X[i];
  if (tid == 0) {
    prm.f_out[inst] = Fv;
    prm.it_out[inst] = iters;
    prm.st_out[inst] = status;
    prm.flag_out[inst] = gflag ? 1 : 0;
  }
}

template <typename T>
long long smem_bytes(int objective, int tile, int groups, int m, int rows) {
  const int mx = m <= 10 ? 10 : 20;
  const Layout L(objective, tile, groups, m, rows, mx, Chunk<T>::kc, Chunk<T>::ks,
                 Chunk<T>::rc, warp_stage<T>());
  return L.total * (long long)sizeof(T);
}

template <typename T, int MX>
int launch(const Params<T>& prm, cudaStream_t stream) {
  const long long smem = smem_bytes<T>(prm.objective, prm.tile, prm.groups, prm.m, prm.rows);
  if (smem > kSmemPerBlock) return kErrSmem;
  auto kernel = lbfgsb_tall_kernel<T, MX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (prm.B + prm.tile - 1) / prm.tile;
  kernel<<<blocks, kGroup * prm.groups, (size_t)smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int objective, const void* x0, const void* lo, const void* up,
        int bstride, const void* d0, const void* d1, int rows, int B, int n,
        int m, int tile, int groups, double pgtol, double factr, int max_iter,
        int max_iter_ls, double c1, int bisect_iters, int guard_maxseg,
        int dcsrch, void* work, void* x, void* f, void* it, void* st,
        void* flag, void* stream) {
  Params<T> prm;
  prm.x0 = static_cast<const T*>(x0);
  prm.lo = static_cast<const T*>(lo);
  prm.up = static_cast<const T*>(up);
  prm.bstride = bstride;
  prm.objective = objective;
  prm.d0 = static_cast<const T*>(d0);
  prm.d1 = static_cast<const T*>(d1);
  prm.rows = objective == kLogSumExp ? rows : 0;
  prm.B = B;
  prm.n = n;
  prm.m = m;
  prm.tile = tile;
  prm.groups = groups;
  prm.pgtol = (T)pgtol;
  prm.f_rtol = (T)(factr * Lit<T>::eps);
  prm.eps = (T)Lit<T>::eps;
  prm.c1 = (T)c1;
  prm.max_iter = max_iter;
  prm.max_iter_ls = max_iter_ls;
  prm.bisect_iters = bisect_iters;
  prm.guard_maxseg = guard_maxseg;
  prm.dcsrch = dcsrch;
  prm.work = static_cast<T*>(work);
  prm.x_out = static_cast<T*>(x);
  prm.f_out = static_cast<T*>(f);
  prm.it_out = static_cast<int*>(it);
  prm.st_out = static_cast<int*>(st);
  prm.flag_out = static_cast<int*>(flag);
  const bool two = prm.d0 != nullptr && prm.d1 != nullptr;
  switch (objective) {
    case kRosenbrock: break;
    case kWeightedSquares:
    case kQuadratic:
      if (!two) return kErrArgs;
      break;
    case kLogSumExp:
      if (!two || rows < 1 || rows > kMaxRows) return kErrArgs;
      break;
    default: return kErrArgs;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m <= 10 ? launch<T, 10>(prm, s) : launch<T, 20>(prm, s);
}

}  // namespace

// elements of the workspace the wrapper allocates for B instances: the
// interleaved histories (n rows of hist_stride(m)), then the (n,) vectors
extern "C" long long lbfgsb_tall_work_elems(int B, int n, int m) {
  return (long long)B * n * hist_stride(m) + (long long)B * kVecs * n;
}

static long long smem_of(int dtype, int objective, int tile, int groups, int m, int rows) {
  return dtype == 1 ? smem_bytes<double>(objective, tile, groups, m, rows)
                    : smem_bytes<float>(objective, tile, groups, m, rows);
}

// the largest tile <= `tile` whose shared memory fits a block of as many
// groups (0: none)
extern "C" int lbfgsb_tall_fit_tile(int dtype, int objective, int m, int rows,
                                    int tile) {
  if (tile > kMaxTile) tile = kMaxTile;
  for (int t = tile; t >= 1; --t)
    if (smem_of(dtype, objective, t, t, m, rows) <= kSmemPerBlock) return t;
  return 0;
}

// the most groups, from `tile` to kMaxTile, whose shared memory fits a
// block running a tile of `tile` instances (the tile itself must fit)
extern "C" int lbfgsb_tall_fit_groups(int dtype, int objective, int m, int rows,
                                      int tile) {
  for (int g = kMaxTile; g > tile; --g)
    if (smem_of(dtype, objective, tile, g, m, rows) <= kSmemPerBlock) return g;
  return tile;
}

// dtype 0: float32, 1: float64; line_search 0: Armijo, 1: dcsrch.  Returns
// 0, a cudaError_t, or a negative ErrorCode; launches on `stream` and does
// not synchronise.
extern "C" int lbfgsb_tall_launch(
    int dtype, int objective, const void* x0, const void* lo, const void* up,
    int bstride, const void* d0, const void* d1, int rows, int B, int n, int m,
    int tile, int groups, double pgtol, double factr, int max_iter, int max_iter_ls,
    double c1, int bisect_iters, int guard_maxseg, int line_search, void* work,
    void* x, void* f, void* it, void* st, void* flag, void* stream) {
  if (B < 1 || n < 1 || m < 1 || m > kMaxM || tile < 1 || groups < tile ||
      groups > kMaxTile || (bstride != 0 && bstride != n) ||
      (line_search != 0 && line_search != 1) || work == nullptr)
    return kErrArgs;
  if (dtype == 0)
    return run<float>(objective, x0, lo, up, bstride, d0, d1, rows, B, n, m,
                      tile, groups, pgtol, factr, max_iter, max_iter_ls, c1,
                      bisect_iters, guard_maxseg, line_search, work, x, f, it,
                      st, flag, stream);
  if (dtype == 1)
    return run<double>(objective, x0, lo, up, bstride, d0, d1, rows, B, n, m,
                       tile, groups, pgtol, factr, max_iter, max_iter_ls, c1,
                       bisect_iters, guard_maxseg, line_search, work, x, f, it,
                       st, flag, stream);
  return kErrArgs;
}

#ifdef K2_PROFILE
extern "C" int k2_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, k2_prof, sizeof(unsigned long long) * 16);
}
extern "C" int k2_prof_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(k2_prof, z, sizeof(z));
}
#endif
