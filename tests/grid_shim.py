"""A grid-level stand-in for the CUDA runtime, so that kernels which meet at
grid-wide barriers (a cooperative launch, `cooperative_groups::this_grid()
.sync()`) compile with g++ and run on the CPU: csrc/barotropic.cu and
csrc/bt_gather.cu.

On top of the thread-loop stand-in of tests/test_torch_sphere_split_shim.py
(`RUNTIME`: `__global__` etc. to nothing, the rounded products, dim3 and
the thread indices), every thread of every block of a launch is a fiber
(`ucontext`) on the calling thread. The fibers run in turn, each up to its
next barrier: `__syncthreads()` is passed when every live thread of its
block has reached one, `grid.sync()` when every thread of the grid has
reached one (a thread that ended before it, or a block barrier met by part
of a block while the rest waits at the grid's, is a deadlock: the launch
returns an error). Each block's dynamic shared array is a buffer of its own,
filled with NaN bytes before the launch, so a read of a slot no thread
wrote shows. The device is what the test sets with `shim_set_device`: SMs,
blocks an SM holds (the occupancy query's answer while the shared memory
fits) and the most dynamic shared memory a block may opt into (each
setting a new device number, so the launchers' kept answers do not carry
over); a
cooperative launch of more blocks than the SMs hold, or with more shared
memory, is refused as the card refuses it
(cudaErrorCooperativeLaunchTooLarge). `__ldg` / `__ldcg` are plain loads
(the sources take them only where `__CUDA_ARCH__` is defined).

    lib = grid_shim.build(tmp_dir, ["barotropic.cu"], "name")
    lib.shim_set_device(sms, blocks_per_sm, smem_optin)
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from test_torch_sphere_split_shim import CSRC, RUNTIME

GRID_RUNTIME = RUNTIME + r"""
#include <ucontext.h>
#include <cstdio>
#include <cstring>
#include <memory>
#include <type_traits>
#include <utility>
#include <vector>
#define __align__(n) alignas(n)
#define __syncthreads() shim::block_sync()
enum {
  cudaErrorInvalidConfiguration = 9,
  cudaErrorLaunchFailure = 719,
  cudaErrorCooperativeLaunchTooLarge = 720,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrMultiProcessorCount = 16
};
namespace shim {
// the device the test set (shim_set_device); each setting is a device of
// its own (cudaGetDevice answers its number), so that what a launcher
// learnt of an earlier one does not carry over
inline int sms = 4, blocks_per_sm = 1, smem_optin = 232448, device = 0;
enum { RUN = 0, AT_BLOCK = 1, AT_GRID = 2, DONE = 3 };
inline thread_local ucontext_t* sched = nullptr;
inline thread_local ucontext_t* cur = nullptr;
inline thread_local char* state = nullptr;
inline thread_local unsigned cur_f = 0;
inline thread_local void (*body)(void*) = nullptr;
inline thread_local void* body_arg = nullptr;
inline thread_local unsigned char* dyn = nullptr;
inline void block_sync() {
  state[cur_f] = AT_BLOCK;
  swapcontext(cur, sched);
}
inline void grid_sync() {
  state[cur_f] = AT_GRID;
  swapcontext(cur, sched);
}
inline void trampoline() {
  body(body_arg);
  state[cur_f] = DONE;
}
// every thread of the grid a fiber; 0 when every fiber ended, else the
// deadlock's error code
template <class F>
cudaError_t run_grid(dim3 g, dim3 b, size_t smem, F f) {
  const unsigned nb = g.x * g.y * g.z, nt = b.x * b.y * b.z, n = nb * nt;
  constexpr size_t kStack = 1 << 16;
  std::vector<std::vector<double>> bufs(
      nb, std::vector<double>(smem / sizeof(double) + 1));
  for (auto& v : bufs) std::memset(v.data(), 0xff, v.size() * sizeof(double));
  std::vector<std::unique_ptr<char[]>> stacks(n);
  std::vector<ucontext_t> ctx(n);
  std::vector<char> st(n, RUN);
  ucontext_t main_ctx;
  gridDim = g;
  blockDim = b;
  sched = &main_ctx;
  state = st.data();
  body = [](void* a) { (*static_cast<F*>(a))(); };
  body_arg = &f;
  for (unsigned i = 0; i < n; ++i) {
    stacks[i].reset(new char[kStack]);
    getcontext(&ctx[i]);
    ctx[i].uc_stack.ss_sp = stacks[i].get();
    ctx[i].uc_stack.ss_size = kStack;
    ctx[i].uc_link = &main_ctx;
    makecontext(&ctx[i], trampoline, 0);
  }
  for (;;) {
    for (unsigned i = 0; i < n; ++i) {
      if (st[i] != RUN) continue;
      const unsigned blk = i / nt, t = i % nt;
      blockIdx = dim3(blk % g.x, blk / g.x % g.y, blk / (g.x * g.y));
      threadIdx = dim3(t % b.x, t / b.x % b.y, t / (b.x * b.y));
      dyn = reinterpret_cast<unsigned char*>(bufs[blk].data());
      cur = &ctx[i];
      cur_f = i;
      swapcontext(&main_ctx, &ctx[i]);
    }
    unsigned done = 0, at_grid = 0;
    for (char s : st) {
      done += s == DONE;
      at_grid += s == AT_GRID;
    }
    if (done == n) return 0;
    if (at_grid == n) {
      std::fill(st.begin(), st.end(), RUN);
      continue;
    }
    bool moved = false;
    for (unsigned blk = 0; blk < nb; ++blk) {
      unsigned live = 0, waiting = 0;
      for (unsigned t = 0; t < nt; ++t) {
        const char s = st[blk * nt + t];
        live += s != DONE;
        waiting += s == AT_BLOCK;
      }
      if (live > 0 && waiting == live) {
        for (unsigned t = 0; t < nt; ++t)
          if (st[blk * nt + t] == AT_BLOCK) st[blk * nt + t] = RUN;
        moved = true;
      }
    }
    if (!moved) {
      std::fprintf(stderr, "grid shim: deadlock (%u of %u threads ended, "
                   "%u at the grid barrier)\n", done, n, at_grid);
      return cudaErrorLaunchFailure;
    }
  }
}
template <class... A, size_t... I>
void call(void (*k)(A...), void** args, std::index_sequence<I...>) {
  k(*static_cast<std::remove_cv_t<std::remove_reference_t<A>>*>(args[I])...);
}
}  // namespace shim
inline cudaError_t cudaGetDevice(int* d) { *d = shim::device; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? shim::sms : shim::smem_optin;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int v) {
  return v > shim::smem_optin ? cudaErrorInvalidValue : 0;
}
template <class... A>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, void (*)(A...), int, size_t smem) {
  *n = static_cast<long long>(smem) > shim::smem_optin ? 0
                                                         : shim::blocks_per_sm;
  return 0;
}
template <class... A>
cudaError_t cudaLaunchCooperativeKernel(void (*k)(A...), dim3 g, dim3 b,
                                        void** args, size_t smem,
                                        cudaStream_t) {
  if (static_cast<long long>(g.x) * g.y * g.z >
          static_cast<long long>(shim::sms) * shim::blocks_per_sm ||
      static_cast<long long>(smem) > shim::smem_optin) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  return shim::run_grid(g, b, smem, [&] {
    shim::call(k, args, std::index_sequence_for<A...>{});
  });
}
"""

COOPERATIVE_GROUPS = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() const { shim::grid_sync(); }
};
inline grid_group this_grid() { return grid_group(); }
}  // namespace cooperative_groups
"""

DEVICE_SETTER = r"""
#include "cuda_runtime.h"
extern "C" void shim_set_device(int sms, int blocks_per_sm, int smem_optin) {
  shim::sms = sms;
  shim::blocks_per_sm = blocks_per_sm;
  shim::smem_optin = smem_optin;
  ++shim::device;
}
"""

DYN_SMEM = re.compile(r"extern __shared__[^;]*?(\w+)\[\];")


def build(d, sources, name):
    """`sources` (names in csrc/) built by g++ against the grid runtime into
    lib<name>.so under the directory `d`, loaded; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    inc = d / "include"
    inc.mkdir()
    (inc / "cuda_runtime.h").write_text(GRID_RUNTIME)
    (inc / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(DYN_SMEM.sub(
            r"unsigned char* \1 = shim::dyn;", f.read_text()))
    (d / "shim_device.cpp").write_text(DEVICE_SETTER)
    so = d / f"lib{name}.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-w", f"-I{inc}",
         "-x", "c++", *(str(d / s) for s in sources),
         str(d / "shim_device.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.shim_set_device.argtypes = [ctypes.c_int] * 3
    lib.shim_set_device.restype = None
    return lib
