// Backward-Euler vertical diffusion of a group of columns by parallel cyclic
// reduction, in shared memory: the levels of the sphere's column solve
// (patch_vmix.cu). (The planar solve, vmix.cu, eliminates in chunks
// instead.)
//
// A block takes CW columns (threadIdx.x) and walks their K levels with
// blockDim.y threads. A staged array holds N = K CW elements, [k][CW] with k
// slowest. The system of a column is the diffusion form of ops/tridiag.py
// (TriDiagSolvers.h PCRDiffusionSolver):
//   -G_{k-1} x_{k-1} + (H_k + G_k + G_{k-1}) x_k - G_k x_{k+1} = H_k phi_k,
// with the coupling G = dt kappa / dz above the bottom interface and 0 at
// it, and it is solved exactly as ops/tridiag.pcr does: ceil(log2 K)
// levels, out-of-range neighbour rows read as identity equations (1 for the
// diagonal, 0 for the rest), one set of alpha / beta factors per level
// shared by all right-hand sides.
#pragma once

#include <cuda_runtime.h>

namespace omega {

// a, b, c of the diffusion-form matrix into the first three arrays of
// `buf` from the thickness HS and the coupling G ([k][CW] each, G = 0 at
// k = K-1). No barrier: the caller stages the right-hand sides into
// buf[(3 + l) N ...] and synchronises before pcr_levels.
template <typename T>
__device__ __forceinline__ void pcr_matrix(T* buf, const T* HS, const T* G,
                                           int K, int CW) {
  const int N = K * CW;
  for (int k = threadIdx.y; k < K; k += blockDim.y) {
    const int i = k * CW + threadIdx.x;
    const T gk = G[i], gm = k > 0 ? G[i - CW] : T(0), h = HS[i];
    buf[i] = -gm;                    // a
    buf[N + i] = h + gk + gm;        // b
    buf[2 * N + i] = -gk;            // c
  }
}

// The reduction levels on a, b, c and n right-hand sides, from `cur` into
// the other buffer and back, one barrier per level. Returns the buffer that
// holds the last level: the solution of right-hand side l at row i is
// ret[(3 + l) N + i] / ret[N + i].
template <typename T>
__device__ __forceinline__ T* pcr_levels(T* cur, T* nxt, int K, int CW,
                                         int n, int levels) {
  const int N = K * CW;
  for (int lev = 0, sh = 1; lev < levels; ++lev, sh <<= 1) {
    for (int k = threadIdx.y; k < K; k += blockDim.y) {
      const int i = k * CW + threadIdx.x;
      const bool hm = k - sh >= 0, hp = k + sh < K;
      const int im = i - sh * CW, ip = i + sh * CW;
      const T a = cur[i], b = cur[N + i], c = cur[2 * N + i];
      const T alpha = -a / (hm ? cur[N + im] : T(1));
      const T beta = -c / (hp ? cur[N + ip] : T(1));
      nxt[i] = alpha * (hm ? cur[im] : T(0));
      nxt[2 * N + i] = beta * (hp ? cur[2 * N + ip] : T(0));
      nxt[N + i] = b + alpha * (hm ? cur[2 * N + im] : T(0)) +
                   beta * (hp ? cur[ip] : T(0));
      for (int l = 0; l < n; ++l) {
        const T* const X = cur + (3 + l) * N;
        nxt[(3 + l) * N + i] = X[i] + alpha * (hm ? X[im] : T(0)) +
                               beta * (hp ? X[ip] : T(0));
      }
    }
    __syncthreads();
    T* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace omega
