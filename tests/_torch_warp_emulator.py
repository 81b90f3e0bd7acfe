"""The CUDA kernel K1 (``optimization_solvers_tpu_torch/ops/csrc/
lbfgsb_fused.cu``) built with the host C++ compiler against a warp
emulator (``CUDA_RUNTIME_H``, written out as ``cuda_runtime.h`` beside the
build) and run on CPU tensors: the kernel's own source, lane by lane,
where the card is not there.  A test-only harness: the port never calls
it."""

import ctypes
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
CUDA_RUNTIME_H = r"""// A host stand-in for the CUDA runtime, for running a one-warp-per-instance
// kernel of optimization_solvers_tpu_torch/ops/csrc on the CPU in the tests
// (built with g++ by tests/_torch_warp_emulator.py, which holds this text).
// Each warp's 32 lanes run as 32 coroutines on one thread, taking turns at
// every warp collective (shuffle, vote, __syncwarp), which is a barrier of
// the 32: a collective that not all lanes reach never completes (the
// launch then aborts), as it is undefined on the card.  On x86-64 a lane
// switch saves the callee-saved registers and the stack pointer (no system
// call: a collective is 64 switches); elsewhere it is swapcontext.  Blocks
// run one after another, and each warp of a block on its own: the kernels
// this serves share nothing between warps.  Not CUDA semantics beyond
// that: no memory model, no timing, no fused multiply-add unless the host
// compiler contracts.
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

struct EmuLane { dim3 tid; EmuCtx ctx; bool done; };
struct EmuWarp {
  EmuLane lane[32];
  EmuCtx main;
  int cur, done, arrived;
  unsigned gen;
  uint64_t slots[32];
  dim3 bid, bdim;
  unsigned char* smem;
};
inline EmuWarp* emu_warp;
#define threadIdx (emu_warp->lane[emu_warp->cur].tid)
#define blockIdx (emu_warp->bid)
#define blockDim (emu_warp->bdim)
#define smem_raw (emu_warp->smem)

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
inline const char* cudaGetErrorString(cudaError_t) { return "warp emulator"; }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
inline long long clock64() { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
using std::fabs;
using std::isfinite;
using std::isnan;
using std::sqrt;

inline int emu_lane() { return emu_warp->cur; }
// hand the thread to the next lane that has not finished
inline void emu_yield() {
  EmuWarp* w = emu_warp;
  const int from = w->cur;
  int to = (from + 1) & 31;
  while (w->lane[to].done) to = (to + 1) & 31;
  if (to == from) {
    std::fprintf(stderr, "warp emulator: a collective that the other lanes never reach\n");
    std::abort();
  }
  w->cur = to;
  emu_swap(w->lane[from].ctx, w->lane[to].ctx);
}
inline void emu_barrier() {
  EmuWarp* w = emu_warp;
  const unsigned g = w->gen;
  if (++w->arrived == 32 - w->done) {
    w->arrived = 0;
    ++w->gen;
  } else {
    while (w->gen == g) emu_yield();
  }
}
template <class T> T emu_exchange(T v, int src) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  emu_warp->slots[emu_lane()] = b;
  emu_barrier();
  const uint64_t r = emu_warp->slots[src & 31];
  emu_barrier();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) { return emu_exchange(v, emu_lane() ^ o); }
template <class T> T __shfl_sync(unsigned, T v, int src) { return emu_exchange(v, src); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_barrier(); }
inline bool emu_vote(bool p, bool all) {
  emu_warp->slots[emu_lane()] = p;
  emu_barrier();
  bool r = all;
  for (int l = 0; l < 32; ++l)
    r = all ? (r && emu_warp->slots[l]) : (r || emu_warp->slots[l]);
  emu_barrier();
  return r;
}
inline bool __all_sync(unsigned, bool p) { return emu_vote(p, true); }
inline bool __any_sync(unsigned, bool p) { return emu_vote(p, false); }

// kernel<<<grid, block, smem>>>(prm): each warp of each block in turn, its
// lanes as coroutines, on a fresh shared-memory buffer filled with garbage
template <class K, class P> struct EmuEntry {
  static inline K kernel;
  static inline const P* prm;
  static void run() {
    kernel(*prm);
    EmuWarp* w = emu_warp;
    w->lane[w->cur].done = true;
    if (++w->done == 32) emu_leave(w->main);
    // a finished lane no longer counts at the barriers of the others
    if (w->arrived == 32 - w->done && w->arrived > 0) {
      w->arrived = 0;
      ++w->gen;
    }
    emu_yield();
  }
};
template <class K, class P>
void emu_launch(K kernel, int grid, int block, int smem, const P& prm) {
  constexpr size_t kStack = 1 << 20;
  std::vector<unsigned char> buf((size_t)smem + 64);
  std::vector<char> stacks(32 * kStack);
  EmuEntry<K, P>::kernel = kernel;
  EmuEntry<K, P>::prm = &prm;
  for (int b = 0; b < grid; ++b) {
    std::memset(buf.data(), 0xcd, buf.size());
    for (int w0 = 0; w0 < block; w0 += 32) {
      EmuWarp warp{};
      warp.bid.x = b;
      warp.bdim.x = block;
      warp.smem = buf.data();
      for (int l = 0; l < 32; ++l) {
        warp.lane[l].tid.x = w0 + l;
        emu_make(warp.lane[l].ctx, stacks.data() + l * kStack, kStack,
                 &EmuEntry<K, P>::run);
      }
      emu_warp = &warp;
      warp.cur = 0;
      emu_resume(warp.main, warp.lane[0].ctx);
      emu_warp = nullptr;
    }
  }
}
"""


def build(out_dir):
    """Compile K1's source for the emulator into ``out_dir``; returns the
    loaded library.  The dynamic shared memory becomes the emulator's
    per-block buffer and the launch a call of ``emu_launch``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the warp emulator needs a host C++ compiler")
    with open(SOURCE) as fh:
        text = fh.read()
    text, n_smem = re.subn(r"\n\s*extern __shared__ [^\n]*smem_raw\[\];", "\n",
                           text)
    text, n_launch = re.subn(
        r"(lbfgsb_fused_kernel<T, Obj, UNBOUNDED>)<<<([^,]+), ([^,]+), "
        r"([^,]+), stream>>>\(prm\);", r"emu_launch(\1, \2, \3, \4, prm);",
        text)
    if (n_smem, n_launch) != (1, 1):
        raise RuntimeError("lbfgsb_fused.cu no longer has the one shared "
                           "buffer and one launch the emulator replaces")
    src = os.path.join(out_dir, "lbfgsb_fused_emulated.cpp")
    lib = os.path.join(out_dir, "liblbfgsb_fused_emulated.so")
    with open(src, "w") as fh:
        fh.write(text)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as fh:
        fh.write(CUDA_RUNTIME_H)
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", "-I", out_dir, "-I", CSRC, "-include", "cuda_runtime.h", "-x", "c++", src, "-o",
         lib], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lbfgsb_fused_launch.restype = i
    lib.lbfgsb_fused_launch.argtypes = [
        i, i, i, vp, vp, vp, i, vp, vp, i, i, i, d, d, i, i, d,
        vp, vp, vp, vp, vp]
    lib.lbfgsb_fused_smem_per_warp.restype = ctypes.c_longlong
    lib.lbfgsb_fused_smem_per_warp.argtypes = [i, i, i]
    return lib


def solve(lib, obj, x0, lower, upper, data=(), *, m=5, pgtol=1e-5,
          factr=1e7, max_iter=500, max_iter_ls=20, c1=1e-3):
    """K1 on CPU tensors through the emulated library, with the arguments
    ``fused_lbfgsb._launch_cuda`` passes; returns ``(x, f, iterations,
    status)`` as ``lbfgsb_solve_plain`` does."""
    x0 = x0.contiguous()
    B, n = x0.shape
    lo = lower.to(x0.dtype).contiguous()
    up = upper.to(x0.dtype).contiguous()
    code, arrays = kernel_operands(obj, data, x0)
    arrays = [a.contiguous() for a in arrays]
    x = torch.empty_like(x0)
    f = torch.empty((B,), dtype=x0.dtype)
    it = torch.empty((B,), dtype=torch.int32)
    st = torch.empty((B,), dtype=torch.int32)
    unbounded = bool(torch.isneginf(lo).all() and torch.isposinf(up).all())
    rc = lib.lbfgsb_fused_launch(
        1 if x0.dtype == torch.float64 else 0, code, int(unbounded),
        x0.data_ptr(), lo.data_ptr(), up.data_ptr(),
        n if lo.dim() == 2 else 0,
        arrays[0].data_ptr() if arrays else None,
        arrays[1].data_ptr() if len(arrays) > 1 else None, B, n, m,
        float(pgtol), float(factr), int(max_iter), int(max_iter_ls),
        float(c1), x.data_ptr(), f.data_ptr(), it.data_ptr(), st.data_ptr(),
        None)
    if rc != 0:
        raise RuntimeError(f"lbfgsb_fused_launch returned {rc}")
    return x, f, it, st
