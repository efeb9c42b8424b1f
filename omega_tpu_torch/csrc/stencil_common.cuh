// Shared by the structured-stencil kernel (stencil.cu), the fused chains
// (slab_chain.cuh) and the vertical-mixing kernels (vmix.cu): the shift-table
// entry, the index helpers of the doubly periodic hex lattice, and a product
// kept out of a fused multiply-add.
//
// A table entry says: destination class t_dst at (y, x) reads source class
// `ts` at (y + dj, x + di), where di = di_e on even destination rows and
// di_o on odd ones (the odd-row stagger of the offset hex layout), and adds
// w times that value. Entries arrive grouped by t_dst, in table order, so a
// sum runs in the same order as the plain PyTorch version.
#pragma once

#include <cuda_runtime.h>

namespace omega {

template <typename T>
struct Entry {
  T w;
  signed char ts, dj, di_e, di_o;
};

// i folded into [0, n) for any int i (a slab may be wider than a tiny domain,
// so one conditional add is not enough here).
__device__ __forceinline__ int wrap_any(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// i folded into [0, n) when i is known to lie in [-n, 2n).
__device__ __forceinline__ int wrap_near(int i, int n) {
  i += (i < 0) ? n : 0;
  i -= (i >= n) ? n : 0;
  return i;
}

// a product rounded on its own, never fused into a following add
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

}  // namespace omega
