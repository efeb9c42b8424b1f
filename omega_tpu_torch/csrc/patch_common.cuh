// Shared by the sphere's patch kernels (patch_step.cuh, patch_vmix.cu,
// patch_fct.cu): the layout of the compact per-position table and the const
// planes built by ops/patch_megastep.py (compact_table, prep), the reads
// through it, and a kernel's registers, spill and blocks per SM.
//
// The frames are (K, 4+L, P) with P = 10 S S positions: channel 0 = h,
// 1..3 = the edge classes of u, 4.. = tracers; a layer's channels are
// contiguous. A table row holds one value per position. For a group of
// tables that share a support and a destination channel, `slots` rows of
// offsets (flat within one layer of the source field) and the same number
// of weight rows per table of the group; unused slots hold offset 0 and
// weight 0, so no read leaves the frame and no uninitialised value enters
// a sum. Slots run in the reference's entry order.
#pragma once

#include "stencil_common.cuh"

namespace omega {
namespace patch {

// rows of the compact offset table (GROUPS of ops/patch_megastep.py)
constexpr int kOffDiv = 0;    // div group, 6 slots
constexpr int kOffCurl = 6;   // 2 vertex channels x 3
constexpr int kOffKite = 12;  // 2 x 3
constexpr int kOffTang = 18;  // 3 edge channels x 10
constexpr int kOffCm = 48;    // cmean group, 3 x 2
constexpr int kOffVm = 54;    // vmean group, 3 x 2
constexpr int kOffRows = 60;
// rows of the weight table
constexpr int kWDiv = 0, kWKe = 6, kWSg = 12, kWSg2 = 18, kWSg4 = 24;
constexpr int kWCurl = 30, kWKite = 36, kWTang = 42;
constexpr int kWCmean = 72, kWCdiff = 78, kWCgrad = 84, kWC0 = 90,
              kWC1 = 96;
constexpr int kWVmean = 102, kWVgrad = 108, kWVgf = 114;
constexpr int kWRows = 120;
// const planes: f_vertex (2), gdepth (3), scal2 (3), scal4 (3), mask (3),
// then the wind stress on the three edge classes (3)
constexpr int kCFv = 0, kCGd = 2, kCS2 = 5, kCS4 = 8, kCEm = 11,
              kCWind = 14;
constexpr int kCRows = 17;
// the rows an FCT prep appends (FCT_GROUPS of ops/patch_megastep.py): the
// relu'd divergence halves on their own 6 offset slots, then one single-slot
// group per neighbour pick j (offset row kOffCoc + j, weight row kWCoc + j)
constexpr int kOffFdiv = kOffRows, kOffCoc = kOffRows + 6;
constexpr int kOffFctRows = kOffRows + 12;
constexpr int kWDpos = kWRows, kWDneg = kWRows + 6, kWCoc = kWRows + 12;
constexpr int kWFctRows = kWRows + 18;

template <int N>
__device__ __forceinline__ void load_off(const int* off, int row, int P,
                                         int p, int (&o)[N]) {
  _Pragma("unroll") for (int s = 0; s < N; ++s)
    o[s] = off[static_cast<long long>(row + s) * P + p];
}

template <int N, typename T>
__device__ __forceinline__ void load_w(const T* w, int row, int P, int p,
                                       T (&v)[N]) {
  _Pragma("unroll") for (int s = 0; s < N; ++s)
    v[s] = w[static_cast<long long>(row + s) * P + p];
}

// sum_s w[s] x[p + o[s]] in slot order, each product rounded on its own
template <int N, typename T>
__device__ __forceinline__ T sten(const T (&w)[N], const int (&o)[N],
                                  const T* __restrict__ x, int p) {
  T acc = T(0);
  _Pragma("unroll") for (int s = 0; s < N; ++s)
    acc = acc + mul_rn(w[s], x[p + o[s]]);
  return acc;
}

template <typename T>
__device__ __forceinline__ T safe_div(T n, T d) {
  return d != T(0) ? n / d : T(0);
}

// cudaFuncGetAttributes of kernel k (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) and the blocks of `threads` threads an
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor, out[3])
inline int kernel_attrs(const void* k, int threads, int* out) {
  if (k == nullptr || out == nullptr || threads < 32 || threads > 256)
    return cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace patch
}  // namespace omega
