"""CUDA kernels of ``optimization_solvers_tpu_torch/ops/csrc`` built with
the host C++ compiler against a warp emulator (``CUDA_RUNTIME_H``, written
out as ``cuda_runtime.h`` beside the build) and run on CPU tensors: a
kernel's own source, thread by thread, where the card is not there.  K1
(``lbfgsb_fused.cu``: one warp per instance), K9 (``bfgs_fused.cu``), K3's
dense form (``driver_dense.cu``) and K5 (``qn_update.cu``: one block of
several warps per instance, whose warps meet at block barriers), K7
(``lbfgs_fused.cu``), K4 (``newton_cg.cu``), K8 (``spg_fused.cu``) and K3's
first-order and quasi-Newton forms (``driver.cu``, ``driver_qn.cu``), one
warp per instance; K3's Newton form (``driver_newton.cu``, one block of 256
threads per instance), whose blocked Cholesky's ``cp.async`` copies become
plain copies here (:data:`CP_ASYNC_STANDIN`).  A test-only harness: the
port never calls it."""

import ctypes
import glob
import os
import re
import shutil
import subprocess

import torch

from optimization_solvers_tpu_torch.ops.batched_oracle import kernel_operands

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "optimization_solvers_tpu_torch",
                    "ops", "csrc")
SOURCE = os.path.join(CSRC, "lbfgsb_fused.cu")

# the host stand-in for the CUDA runtime that the kernel's headers include
CUDA_RUNTIME_H = r"""// A host stand-in for the CUDA runtime, for running a kernel of
// optimization_solvers_tpu_torch/ops/csrc on the CPU in the tests (built
// with g++ by tests/_torch_warp_emulator.py, which holds this text).  A
// block's threads run as coroutines on one thread.  Every warp collective
// (shuffle, vote, __syncwarp) is a barrier of the warp's lanes, every
// block barrier (__syncthreads, block_bar) one of the block's threads; a
// barrier that not all reach never completes (the launch then aborts), as
// it is undefined or hangs on the card.  The lanes of a warp take turns
// between its collectives; the warps take turns between block barriers in
// the order emu_set_seed names (1: the lowest-numbered warp first, 2: the
// highest first, any other: an order drawn from a generator of that seed,
// now and then switching warps at a collective too), so that a read of
// what another warp writes between the same two barriers shows as a
// result that depends on the seed.  On x86-64
// a switch saves the callee-saved registers and the stack pointer (no
// system call: a collective is 64 switches); elsewhere it is swapcontext.
// Blocks run one after another.  Not CUDA semantics beyond that: no memory
// model, no timing, no fused multiply-add unless the host compiler
// contracts.
#pragma once
#if !defined(__x86_64__)
#include <ucontext.h>
#endif

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x) __attribute__((aligned(x)))
#define asm(...) ((void)0)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 1 };
struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }

#if defined(__x86_64__)
// emu_switch(&from, to): save this lane's registers and stack pointer in
// from and continue where to left off
struct EmuCtx { void* sp; };
extern "C" void emu_switch(void** from, void* to);
__asm__(R"(
  .text
  .globl emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
inline void emu_swap(EmuCtx& from, EmuCtx& to) { emu_switch(&from.sp, to.sp); }
// a fresh stack that enters entry() as if called (16-byte aligned frame)
inline void emu_make(EmuCtx& c, char* stack, size_t size, void (*entry)()) {
  uintptr_t top = (reinterpret_cast<uintptr_t>(stack) + size) & ~uintptr_t(15);
  void** sp = reinterpret_cast<void**>(top);
  *--sp = nullptr;                                // entry's return address
  *--sp = reinterpret_cast<void*>(entry);         // popped by ret
  for (int k = 0; k < 6; ++k) *--sp = nullptr;    // rbp, rbx, r12-r15
  c.sp = sp;
}
inline void emu_resume(EmuCtx& main, EmuCtx& first) { emu_switch(&main.sp, first.sp); }
inline void emu_leave(EmuCtx& to) {
  void* scratch;
  emu_switch(&scratch, to.sp);
}
#else
struct EmuCtx { ucontext_t uc; };
inline void emu_swap(EmuCtx& from, EmuCtx& to) { swapcontext(&from.uc, &to.uc); }
inline void emu_make(EmuCtx& c, char* stack, size_t size, void (*entry)()) {
  getcontext(&c.uc);
  c.uc.uc_stack.ss_sp = stack;
  c.uc.uc_stack.ss_size = size;
  c.uc.uc_link = nullptr;
  makecontext(&c.uc, entry, 0);
}
inline void emu_resume(EmuCtx& main, EmuCtx& first) { swapcontext(&main.uc, &first.uc); }
inline void emu_leave(EmuCtx& to) { setcontext(&to.uc); }
#endif

// A block's threads as coroutines: lane l of warp w is thread 32 w + l.
// wait: what a parked lane waits for (0 nothing, 1 its warp's collective,
// 2 the block barrier), gen: that barrier's generation when it parked.
struct EmuLane { dim3 tid; EmuCtx ctx; bool done; int wait; unsigned gen; };
struct EmuWarpState { int arrived, done; unsigned gen; uint64_t slots[32]; };
struct EmuBlock {
  std::vector<EmuLane> lane;
  std::vector<EmuWarpState> warp;
  EmuCtx main;
  int threads, cur, done, arrived;
  unsigned gen;
  uint64_t rng;
  dim3 bid, bdim, gdim;
  unsigned char* smem;
};
inline EmuBlock* emu_block;
inline uint64_t emu_seed = 1;
extern "C" void emu_set_seed(unsigned long long s) { emu_seed = s ? s : 1; }
#define threadIdx (emu_block->lane[emu_block->cur].tid)
#define blockIdx (emu_block->bid)
#define blockDim (emu_block->bdim)
#define gridDim (emu_block->gdim)
#define smem_raw (emu_block->smem)

struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
// one resident block: the launch then takes the largest block that fits
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* nb, F, int, size_t) {
  *nb = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class S> cudaError_t cudaMemcpyFromSymbol(void* dst, const S& sym, size_t n) {
  std::memcpy(dst, &sym, n);
  return 0;
}
template <class S> cudaError_t cudaMemcpyToSymbol(S& sym, const void* src, size_t n) {
  std::memcpy(&sym, src, n);
  return 0;
}
template <class T> T atomicAdd(T* p, T v) {
  const T old = *p;
  *p = old + v;
  return old;
}
inline const char* cudaGetErrorString(cudaError_t) { return "warp emulator"; }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
inline long long clock64() { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
using std::fabs;
using std::isfinite;
using std::isnan;
using std::sqrt;

inline int emu_lane() { return emu_block->cur & 31; }
inline EmuWarpState& emu_warp() { return emu_block->warp[emu_block->cur / 32]; }
inline int emu_warp_size(const EmuBlock* b, int w) {
  const int left = b->threads - 32 * w;
  return left < 32 ? left : 32;
}
inline bool emu_runnable(const EmuBlock* b, int t) {
  const EmuLane& l = b->lane[t];
  if (l.done) return false;
  if (l.wait == 1) return b->warp[t / 32].gen != l.gen;
  if (l.wait == 2) return b->gen != l.gen;
  return true;
}
inline uint64_t emu_next(EmuBlock* b) {
  b->rng ^= b->rng << 13;
  b->rng ^= b->rng >> 7;
  b->rng ^= b->rng << 17;
  return b->rng;
}
// hand the thread to another lane: the next runnable lane of this warp,
// unless `pick` asks for a warp to be picked; then, or when the warp has
// none, a runnable lane of the warp the order picks.  The order: seed 1
// the lowest-numbered warp first, seed 2 the highest, any other seed the
// warps in the order the seeded generator draws.
inline void emu_schedule(bool pick) {
  EmuBlock* b = emu_block;
  const int from = b->cur, w = from / 32, nw = (int)b->warp.size();
  int to = -1;
  if (!pick) {
    const int size = emu_warp_size(b, w);
    for (int k = 1; k <= size && to < 0; ++k) {
      const int t = 32 * w + (from % 32 + k) % size;
      if (emu_runnable(b, t)) to = t;
    }
  }
  if (to < 0) {
    const int start = emu_seed <= 2 ? 0 : (int)(emu_next(b) % (uint64_t)nw);
    for (int k = 0; k < nw && to < 0; ++k) {
      const int v = emu_seed == 2 ? nw - 1 - k : (start + k) % nw;
      for (int l = 0; l < emu_warp_size(b, v) && to < 0; ++l)
        if (emu_runnable(b, 32 * v + l)) to = 32 * v + l;
    }
  }
  if (to < 0) {
    if (b->done == b->threads) {
      emu_leave(b->main);
      return;
    }
    std::fprintf(stderr, "warp emulator: a barrier or collective that the other threads never reach\n");
    std::abort();
  }
  if (to == from) return;
  b->lane[to].wait = 0;
  b->cur = to;
  emu_swap(b->lane[from].ctx, b->lane[to].ctx);
}
inline void emu_park(int wait, unsigned gen) {
  EmuLane& l = emu_block->lane[emu_block->cur];
  l.wait = wait;
  l.gen = gen;
  emu_schedule(false);
}
// a warp collective: a barrier of the warp's lanes that have not finished
inline void emu_barrier() {
  EmuBlock* b = emu_block;
  EmuWarpState& ws = emu_warp();
  const unsigned g = ws.gen;
  if (++ws.arrived == emu_warp_size(b, b->cur / 32) - ws.done) {
    ws.arrived = 0;
    ++ws.gen;
    // under a drawn order, now and then another warp runs first
    if (b->warp.size() > 1 && emu_seed > 2 && (emu_next(b) & 3) == 0) emu_schedule(true);
  } else {
    emu_park(1, g);
  }
}
// the block barrier (__syncthreads, barrier 1 of block_bar): every thread
// of the block that has not finished
inline void emu_block_barrier(int threads) {
  EmuBlock* b = emu_block;
  if (threads != b->threads) {
    std::fprintf(stderr, "warp emulator: a barrier of %d of the block's %d threads\n",
                 threads, b->threads);
    std::abort();
  }
  const unsigned g = b->gen;
  if (++b->arrived == b->threads - b->done) {
    b->arrived = 0;
    ++b->gen;
    emu_schedule(true);
  } else {
    emu_park(2, g);
  }
}
#define OST_EMULATED 1
inline void block_bar(int threads) { emu_block_barrier(threads); }
inline void __syncthreads() { emu_block_barrier(emu_block->threads); }
template <class T> T emu_exchange(T v, int src) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  emu_warp().slots[emu_lane()] = bits;
  emu_barrier();
  const uint64_t r = emu_warp().slots[src & 31];
  emu_barrier();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return emu_exchange(v, emu_lane() ^ o); }
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_barrier(); }
inline bool emu_vote(bool p, bool all) {
  EmuWarpState& ws = emu_warp();
  ws.slots[emu_lane()] = p;
  emu_barrier();
  bool r = all;
  const int size = emu_warp_size(emu_block, emu_block->cur / 32);
  for (int l = 0; l < size; ++l) r = all ? (r && ws.slots[l]) : (r || ws.slots[l]);
  emu_barrier();
  return r;
}
inline bool __all_sync(unsigned, bool p) { return emu_vote(p, true); }
inline bool __any_sync(unsigned, bool p) { return emu_vote(p, false); }

// kernel<<<grid, block, smem>>>(prm): each block in turn, all its threads
// as coroutines on a fresh shared-memory buffer filled with garbage
template <class K, class P> struct EmuEntry {
  static inline K kernel;
  static inline const P* prm;
  static void run() {
    kernel(*prm);
    EmuBlock* b = emu_block;
    b->lane[b->cur].done = true;
    ++b->done;
    // a finished thread no longer counts at the barriers of the others
    EmuWarpState& ws = emu_warp();
    ++ws.done;
    if (ws.arrived > 0 && ws.arrived == emu_warp_size(b, b->cur / 32) - ws.done) {
      ws.arrived = 0;
      ++ws.gen;
    }
    if (b->arrived > 0 && b->arrived == b->threads - b->done) {
      b->arrived = 0;
      ++b->gen;
    }
    emu_schedule(false);
  }
};
template <class K, class P>
void emu_launch(K kernel, int grid, int block, int smem, const P& prm) {
  constexpr size_t kStack = 1 << 19;
  std::vector<unsigned char> buf((size_t)smem + 64);
  // untouched stack pages are never committed
  std::unique_ptr<char[]> stacks(new char[(size_t)block * kStack]);
  EmuEntry<K, P>::kernel = kernel;
  EmuEntry<K, P>::prm = &prm;
  for (int bi = 0; bi < grid; ++bi) {
    std::memset(buf.data(), 0xcd, buf.size());
    EmuBlock blk;
    blk.threads = block;
    blk.lane.resize(block);
    blk.warp.assign((block + 31) / 32, EmuWarpState{});
    blk.cur = blk.done = blk.arrived = 0;
    blk.gen = 0;
    blk.rng = emu_seed * 0x9E3779B97F4A7C15ull + (uint64_t)bi + 1;
    blk.bid.x = bi;
    blk.bdim.x = block;
    blk.gdim.x = grid;
    blk.smem = buf.data();
    for (int t = 0; t < block; ++t) {
      blk.lane[t].tid.x = t;
      blk.lane[t].done = false;
      blk.lane[t].wait = 0;
      emu_make(blk.lane[t].ctx, stacks.get() + t * kStack, kStack, &EmuEntry<K, P>::run);
    }
    emu_block = &blk;
    emu_resume(blk.main, blk.lane[0].ctx);
    emu_block = nullptr;
  }
}
"""


LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<([^,;]+), ([^,;]+), ([^,;]+), "
                    r"([^,;>]+)>>>\(([^;]*)\);")

# chol_blocked.cuh's cp.async helpers as plain copies: on the card the copy
# completes by the wait that precedes every read of its tile, here at once
CP_ASYNC_STANDIN = """__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  memcpy(dst, src, 16);
}
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) { *dst = *src; }
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait_one() {}
__device__ __forceinline__ void cp_async_wait_all() {}

"""


def _host_text(name, text):
    """A source of ops/csrc as the emulated build compiles it."""
    text = re.sub(r"\n\s*extern __shared__ [^\n]*smem_raw\[\];", "\n", text)
    text = LAUNCH.sub(r"emu_launch(\1, \2, \3, \4, \6);", text)
    if name == "chol_blocked.cuh":
        start = text.index("__device__ __forceinline__ void cp_async16(")
        end = text.index("// kMicro consecutive elements")
        text = text[:start] + CP_ASYNC_STANDIN + text[end:]
    return text


def build_sources(out_dir, sources, name, extra="", flags=()):
    """Compile ``sources`` of ``ops/csrc`` (and the C++ text ``extra``) for
    the emulator into one library in ``out_dir``; returns it loaded.  Every
    header and source is copied there with its dynamic shared memory turned
    into the emulator's per-block buffer and each launch into a call of
    ``emu_launch``; the sources are compiled as one translation unit."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the warp emulator needs a host C++ compiler")
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        with open(path) as fh:
            text = _host_text(os.path.basename(path), fh.read())
        with open(os.path.join(out_dir, os.path.basename(path)), "w") as fh:
            fh.write(text)
    src = os.path.join(out_dir, f"{name}_emulated.cpp")
    lib = os.path.join(out_dir, f"lib{name}_emulated.so")
    with open(src, "w") as fh:
        fh.write("".join(f'#include "{s}"\n' for s in sources) + extra)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as fh:
        fh.write(CUDA_RUNTIME_H)
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", *flags, "-I", out_dir, "-include",
         "cuda_runtime.h",
         "-x", "c++", src, "-o", lib], check=True, capture_output=True,
        text=True)
    lib = ctypes.CDLL(lib)
    lib.emu_set_seed.argtypes = [ctypes.c_ulonglong]
    return lib


def build(out_dir):
    """K1's sources (``lbfgsb_fused.cu``, ``lbfgsb_fused_data.cu``) for the
    emulator."""
    lib = build_sources(out_dir, ["lbfgsb_fused.cu", "lbfgsb_fused_data.cu"],
                        "lbfgsb_fused")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lbfgsb_fused_launch.restype = i
    lib.lbfgsb_fused_launch.argtypes = [
        i, i, i, vp, vp, vp, i, vp, vp, i, vp, i, i, i, d, d, i, i, d,
        vp, vp, vp, vp, vp]
    lib.lbfgsb_fused_smem_per_warp.restype = ctypes.c_longlong
    lib.lbfgsb_fused_smem_per_warp.argtypes = [i, i, i, i]
    return lib


# K3's C interface (driver.cu) reaches the Newton form: a build of the
# other forms alone answers the Newton methods with kErrArgs
NEWTON_STUB = """
namespace ost_driver {
template <typename T>
int launch_newton(const Params<T>&, int, cudaStream_t) { return kErrArgs; }
template int launch_newton<float>(const Params<float>&, int, cudaStream_t);
template int launch_newton<double>(const Params<double>&, int, cudaStream_t);
}  // namespace ost_driver
"""


def build_k3(out_dir, extra_flags=(), newton=False):
    """K3's first-order, quasi-Newton, Wolfe and dense forms (``driver.cu``
    with ``driver_first.cuh``, ``driver_qn.cu``, ``driver_qn_data.cu``,
    ``driver_dense.cu``, ``driver_dense_data.cu``) for the emulator; with
    ``newton`` its Newton form (``driver_newton.cu``) too, else the Newton
    methods are answered with kErrArgs."""
    sources = ["driver.cu", "driver_qn.cu", "driver_qn_data.cu",
               "driver_dense.cu", "driver_dense_data.cu"]
    lib = build_sources(out_dir, sources + ["driver_newton.cu"] * newton,
                        "driver_newton" if newton else "driver",
                        "" if newton else NEWTON_STUB, flags=extra_flags)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.driver_launch.restype = i
    lib.driver_launch.argtypes = [
        i, i, vp, vp, vp, i, vp, vp, vp, i, i, ctypes.POINTER(i),
        ctypes.POINTER(d), i, i, vp, vp, vp, vp, vp, vp, vp]
    lib.driver_smem_dense.restype = ctypes.c_longlong
    lib.driver_smem_dense.argtypes = [i, i, i, i, i]
    lib.driver_smem_per_warp.restype = ctypes.c_longlong
    lib.driver_smem_per_warp.argtypes = [i, i, i, i, i]
    lib.driver_workspace_elems.restype = ctypes.c_longlong
    lib.driver_workspace_elems.argtypes = [ctypes.c_longlong, i, i, i, i, i,
                                           i]
    return lib


def build_k8(out_dir, extra_flags=()):
    """K8's source (``spg_fused.cu``) for the emulator."""
    lib = build_sources(out_dir, ["spg_fused.cu"], "spg_fused",
                        flags=extra_flags)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.spg_fused_launch.restype = i
    lib.spg_fused_launch.argtypes = [
        i, i, vp, vp, vp, vp, vp, i, i, d, d, d, i, d, i, i,
        vp, vp, vp, vp, vp, vp]
    lib.spg_fused_smem_per_warp.restype = ctypes.c_longlong
    lib.spg_fused_smem_per_warp.argtypes = [i, i, i]
    return lib


def spg_solve(lib, obj, x0, lower, upper, data=(), *, tol=1e-5,
              lam_min=1e-3, lam_max=1e3, gll_m=10, c1=1e-4, max_iter=1000,
              max_iter_ls=24, seed=1):
    """K8 on CPU tensors through the emulated library, with the arguments
    ``fused_spg._launch_cuda`` passes; the warps take turns in the order
    ``seed`` draws.  Returns ``(x, f, iterations, status, trials)``."""
    from optimization_solvers_tpu_torch.ops import fused_spg

    x0 = x0.contiguous()
    B, n = x0.shape
    lo = lower.to(x0.dtype).contiguous()
    up = upper.to(x0.dtype).contiguous()
    code, _arrays, (d0, d1), outs = fused_spg.kernel_call_operands(
        obj, data, x0, fused_spg.KERNEL, fused_spg.K8_OBJECTIVES)
    lib.emu_set_seed(seed)
    rc = lib.spg_fused_launch(
        1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
        lo.data_ptr(), up.data_ptr(), d0, d1, B, n, float(tol),
        float(lam_min), float(lam_max), int(gll_m), float(c1), int(max_iter),
        int(max_iter_ls), *(t.data_ptr() for t in outs), None)
    if rc != 0:
        raise RuntimeError(f"spg_fused_launch returned {rc}")
    return outs


def build_k9(out_dir):
    """K9's sources (``bfgs_fused.cu``, ``bfgs_fused_data.cu``) for the
    emulator."""
    lib = build_sources(out_dir, ["bfgs_fused.cu", "bfgs_fused_data.cu"],
                        "bfgs_fused")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.bfgs_fused_launch.restype = i
    lib.bfgs_fused_launch.argtypes = [
        i, i, vp, vp, vp, i, i, i, d, i, i, d, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.bfgs_fused_smem.restype = ctypes.c_longlong
    lib.bfgs_fused_smem.argtypes = [i, i, i]
    lib.bfgs_fused_workspace_elems.restype = ctypes.c_longlong
    lib.bfgs_fused_workspace_elems.argtypes = [ctypes.c_longlong, i, i, i]
    return lib


def build_k7(out_dir):
    """K7's source (``lbfgs_fused.cu``) for the emulator."""
    lib = build_sources(out_dir, ["lbfgs_fused.cu"], "lbfgs_fused")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lbfgs_fused_launch.restype = i
    lib.lbfgs_fused_launch.argtypes = [
        i, i, vp, vp, vp, i, i, i, d, i, i, d, vp, vp, vp, vp, vp, vp]
    lib.lbfgs_fused_smem_per_warp.restype = ctypes.c_longlong
    lib.lbfgs_fused_smem_per_warp.argtypes = [i, i, i]
    return lib


def lbfgs_solve(lib, obj, x0, data=(), *, m=10, tol=1e-5, max_iter=500,
                max_iter_ls=16, c1=1e-4, seed=1):
    """K7 on CPU tensors through the emulated library, with the arguments
    ``fused_lbfgs._launch_cuda`` passes; the warps take turns in the order
    ``seed`` draws.  Returns ``(x, f, iterations, status, trials)``."""
    from optimization_solvers_tpu_torch.ops import fused_lbfgs

    x0 = x0.contiguous()
    B, n = x0.shape
    code, _arrays, (d0, d1), outs = fused_lbfgs.kernel_call_operands(
        obj, data, x0, fused_lbfgs.KERNEL, fused_lbfgs.K7_OBJECTIVES)
    lib.emu_set_seed(seed)
    rc = lib.lbfgs_fused_launch(
        1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(), d0, d1, B,
        n, m, float(tol), int(max_iter), int(max_iter_ls), float(c1),
        *(t.data_ptr() for t in outs), None)
    if rc != 0:
        raise RuntimeError(f"lbfgs_fused_launch returned {rc}")
    return outs


def build_k4(out_dir, extra_flags=()):
    """K4's source (``newton_cg.cu``) for the emulator."""
    lib = build_sources(out_dir, ["newton_cg.cu"], "newton_cg",
                        flags=extra_flags)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.newton_cg_launch.restype = i
    lib.newton_cg_launch.argtypes = [
        i, i, vp, vp, vp, vp, vp, i, i, i, d, d, d, i, i, i, d,
        vp, vp, vp, vp, vp, vp, vp]
    lib.newton_cg_smem_per_warp.restype = ctypes.c_longlong
    lib.newton_cg_smem_per_warp.argtypes = [i, i, i]
    return lib


def newton_cg_solve(lib, obj, x0, lower, upper, data=(), *, pgtol=1e-5,
                    factr=1e7, max_iter=200, cg_max=32, max_iter_ls=25,
                    c1=1e-4, seed=1):
    """K4 on CPU tensors through the emulated library, with the arguments
    ``fused_newton_cg._launch_cuda`` passes; the warps take turns in the
    order ``seed`` draws.  Returns ``(x, f, iterations, status, ncg,
    nfev)`` as ``newton_cg_solve_plain`` does."""
    x0 = x0.contiguous()
    B, n = x0.shape
    lo = lower.to(x0.dtype).contiguous()
    up = upper.to(x0.dtype).contiguous()
    code, arrays = kernel_operands(obj, data, x0)
    arrays = [a.contiguous() for a in arrays]
    rows = arrays[0].shape[0] if code == 3 else 0
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype)
    it, st, ncg, nfev = (torch.empty((B,), dtype=torch.int32)
                         for _ in range(4))
    eps = float(torch.finfo(x0.dtype).eps)
    lib.emu_set_seed(seed)
    rc = lib.newton_cg_launch(
        1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(),
        lo.data_ptr(), up.data_ptr(),
        arrays[0].data_ptr() if arrays else None,
        arrays[1].data_ptr() if len(arrays) > 1 else None, rows, B, n,
        float(pgtol), float(factr) * eps, eps, int(max_iter), int(cg_max),
        int(max_iter_ls), float(c1), x.data_ptr(), f.data_ptr(),
        it.data_ptr(), st.data_ptr(), ncg.data_ptr(), nfev.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"newton_cg_launch returned {rc}")
    return x, f, it, st, ncg, nfev


def build_k5(out_dir):
    """K5's source (``qn_update.cu``) for the emulator."""
    lib = build_sources(out_dir, ["qn_update.cu"], "qn_update")
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.qn_update_launch.restype = i
    lib.qn_update_launch.argtypes = [i, vp, vp, vp, vp, vp, vp, i, i, i, d,
                                     vp]
    lib.qn_update_smem_elems.restype = ctypes.c_longlong
    lib.qn_update_smem_elems.argtypes = [i]
    lib.qn_update_in_shared.restype = i
    lib.qn_update_in_shared.argtypes = [i, i]
    return lib


def qn_update(lib, B, s, y, g, *, tol=1e-8, kind="bfgs", seed=1):
    """K5 on CPU tensors through the emulated library, with the arguments
    ``fused_qn._launch_cuda`` passes; the warps take turns in the order
    ``seed`` draws.  Returns ``(B', B' g)``."""
    from optimization_solvers_tpu_torch.ops import fused_qn

    B, s, y, g = (v.contiguous() for v in (B, s, y, g))
    b, n, _ = B.shape
    Bn, Bg = torch.empty_like(B), torch.empty_like(g)
    lib.emu_set_seed(seed)
    rc = lib.qn_update_launch(
        1 if B.dtype == torch.float64 else 0, B.data_ptr(), s.data_ptr(),
        y.data_ptr(), g.data_ptr(), Bn.data_ptr(), Bg.data_ptr(), b, n,
        fused_qn.KINDS.index(kind), float(tol), None)
    if rc != 0:
        raise RuntimeError(f"qn_update_launch returned {rc}")
    return Bn, Bg


def solve(lib, obj, x0, lower, upper, data=(), *, m=5, pgtol=1e-5,
          factr=1e7, max_iter=500, max_iter_ls=20, c1=1e-3, scale=None,
          seed=1):
    """K1 on CPU tensors through the emulated library, with the arguments
    ``fused_lbfgsb._launch_cuda`` passes (``scale``: the scaled form's
    sqrt(diag), ``(n,)``, with x0 and the bounds already in z = scale x);
    the warps take turns in the order ``seed`` draws.  Returns ``(x, f,
    iterations, status)`` as ``lbfgsb_solve_plain`` does."""
    x0 = x0.contiguous()
    B, n = x0.shape
    lo = lower.to(x0.dtype).contiguous()
    up = upper.to(x0.dtype).contiguous()
    code, arrays = kernel_operands(obj, data, x0)
    arrays = [a.contiguous() for a in arrays]
    rows = arrays[0].shape[0] if code == 3 else 0
    s = None if scale is None else scale.to(x0.dtype).contiguous()
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype)
    it = torch.empty((B,), dtype=torch.int32)
    st = torch.empty((B,), dtype=torch.int32)
    unbounded = bool(torch.isneginf(lo).all() and torch.isposinf(up).all())
    lib.emu_set_seed(seed)
    rc = lib.lbfgsb_fused_launch(
        1 if x0.dtype == torch.float64 else 0, code, int(unbounded),
        x0.data_ptr(), lo.data_ptr(), up.data_ptr(),
        n if lo.dim() == 2 else 0,
        arrays[0].data_ptr() if arrays else None,
        arrays[1].data_ptr() if len(arrays) > 1 else None, rows,
        None if s is None else s.data_ptr(), B, n, m,
        float(pgtol), float(factr), int(max_iter), int(max_iter_ls),
        float(c1), x.data_ptr(), f.data_ptr(), it.data_ptr(), st.data_ptr(),
        None)
    if rc != 0:
        raise RuntimeError(f"lbfgsb_fused_launch returned {rc}")
    return x, f, it, st


def bfgs_solve(lib, obj, x0, data=(), *, tol=1e-5, max_iter=500,
               max_iter_ls=24, c1=1e-4, seed=1):
    """K9 on CPU tensors through the emulated library, with the arguments
    ``fused_bfgs._launch_cuda`` passes; the warps take turns in the order
    ``seed`` draws.  Returns ``(x, f, iterations, status, trials,
    updates)``."""
    from optimization_solvers_tpu_torch.ops import fused_bfgs
    from optimization_solvers_tpu_torch.ops.fused_lbfgs import (
        kernel_call_operands)

    x0 = x0.contiguous()
    B, n = x0.shape
    code, arrays, (d0, d1), outs = kernel_call_operands(
        obj, data, x0, fused_bfgs.KERNEL, fused_bfgs.K9_OBJECTIVES)
    rows = arrays[0].shape[0] if code == 3 else 0
    outs = outs + (torch.empty_like(outs[4]),)
    elems = fused_bfgs.workspace_elems(B, n, x0.element_size(), rows)
    work = torch.empty((elems,), dtype=x0.dtype) if elems else None
    lib.emu_set_seed(seed)
    rc = lib.bfgs_fused_launch(
        1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(), d0, d1,
        rows, B, n, float(tol), int(max_iter), int(max_iter_ls), float(c1),
        None if work is None else work.data_ptr(),
        *(t.data_ptr() for t in outs), None)
    if rc != 0:
        raise RuntimeError(f"bfgs_fused_launch returned {rc}")
    return outs


def driver_solve(lib, method, search, obj, x0, lower=None, upper=None,
                 data=(), *, max_iter=20, max_iter_ls=20, seed=1):
    """K3 on CPU tensors through the emulated library, with the arguments
    ``fused_driver._launch_cuda`` passes (the dense form for QN and QNB);
    the warps take turns in the order ``seed`` draws.  Returns ``(x, f,
    iterations, status, nfev)`` as ``fused_minimize_plain`` does."""
    from optimization_solvers_tpu_torch.ops import fused_driver

    spec = fused_driver.build_spec(method, search)
    x0 = x0.contiguous()
    B, n = x0.shape
    lo = up = None
    bstride = 0
    if spec.bounded:
        lo = lower.to(x0.dtype).contiguous()
        up = upper.to(x0.dtype).contiguous()
        bstride = n if lo.dim() == 2 else 0
    code, arrays = kernel_operands(obj, data, x0)
    arrays = [a.contiguous() for a in arrays]
    rows = arrays[0].shape[0] if code == 3 else 0
    pinv = (None if spec.pinv is None else
            spec.pinv.to(x0.dtype).contiguous())
    elems = fused_driver.workspace_elems(
        B, n, spec.method, spec.ring, x0.element_size(), spec.qn_update,
        fused_driver.k3_rows(spec, "LOG_SUM_EXP" if code == 3 else None,
                             rows))
    work = torch.empty((elems,), dtype=x0.dtype) if elems else None
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype)
    it, st, nfev = (torch.empty((B,), dtype=torch.int32) for _ in range(3))
    ints, doubles = fused_driver._slots(spec, x0.dtype, rows)

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib.emu_set_seed(seed)
    rc = lib.driver_launch(
        1 if x0.dtype == torch.float64 else 0, code, x0.data_ptr(), ptr(lo),
        ptr(up), bstride, ptr(arrays[0] if arrays else None),
        ptr(arrays[1] if len(arrays) > 1 else None), ptr(pinv), B, n, ints,
        doubles, int(max_iter), int(max_iter_ls), ptr(work), x.data_ptr(),
        f.data_ptr(), it.data_ptr(), st.data_ptr(), nfev.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"driver_launch returned {rc}")
    return x, f, it, st, nfev
