// Backward-Euler vertical diffusion of a block's columns by elimination in
// chunks (the partition method): what the planar column solve (vmix.cu) and
// the sphere's (patch_vmix.cu) share. Each kernel says where row k of its
// thread's column lies (ColumnRows: (ch K + k) plane + g on the stacked
// plane, (k (4+L) + ch) P + p on the sphere's frames) and where the
// thickness and the coefficients are read; the staging, the sweeps, the
// reduced system and the finish are here.
//
// The system of a column is the diffusion form of ops/tridiag.py
//   -G_{k-1} x_{k-1} + (H_k + G_k + G_{k-1}) x_k - G_k x_{k+1} = H_k phi_k,
// G = dt kappa / dz above the bottom interface and 0 at it, H the cell
// thickness (tracers) or an edge's cmean of two cells (u). The plain
// versions solve it by parallel cyclic reduction (ops/tridiag.pcr, the TPU
// kernels' _pcr_diffusion: ceil(log2 K) levels over every row, a layout for
// the TPU's lanes); here it is solved by elimination, O(K) work, split into
// chunks. A block takes CW = blockDim.x ADJACENT columns (threadIdx.x:
// every load and store of a row k is one coalesced segment) and
// blockDim.y k-lanes; lane j takes the contiguous rows [j K / lanes,
// (j+1) K / lanes) of its column (at most kChunk, at least 2). A pass
//   1. stages the block's columns (thickness, coefficients, right-hand
//      sides; [k][CW] arrays) in shared memory by cp.async, every copy in
//      flight at once and none held in a register;
//   2. lets each lane eliminate inside its chunk (the modified Thomas
//      sweeps, in place in the staged arrays), which leaves every row
//      coupled only to the chunk's first and last rows and those two to
//      the neighbouring chunks' last and first;
//   3. solves the chunks' first and last rows, a tridiagonal system of
//      2 lanes rows per column, by Thomas in lane 0;
//   4. finishes every row from its chunk's two end values and stores it.
// The matrix is diagonally dominant (H > 0, G >= 0), so elimination needs
// no pivoting, and it solves the same system as the plain PCR: the two
// agree to the rounding of either. A row costs one reciprocal and some ten
// operations and a few shared accesses, where PCR took two divisions and
// 9 + 3n shared loads per row and level (n right-hand sides). What the
// design does about the card: the staging keeps registers low while every
// load is in flight (loads held in registers behind the divisions, an
// earlier form of the planar solve, left each block waiting on one round
// trip after another). Up to `lc` right-hand sides (at most kRhs, the
// width the sweeps' registers are compiled for) go in one pass; the
// columns are restaged per pass.
#pragma once

#include "stencil_common.cuh"

namespace omega {

// rows a k-lane takes at most
constexpr int kChunk = 25;

// a global -> shared copy of one element, in flight until copies_done()
// (cp.async: no register holds it); a plain copy where no card compiles it
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}
// the copies issued since the last commit become one group; wait until at
// most N groups are in flight (the coefficient kernels' layer pipelines)
__device__ __forceinline__ void copies_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// elements of shared memory a block stages: per pass the thickness, the
// coefficients, and max(lc, 2) more [K][CW] arrays (an edge's second cell
// and its u, or lc right-hand sides), then the reduced system, 2 lanes rows
// of a, c and lc right-hand sides
__host__ __device__ constexpr long long column_smem_elems(int K, int cw,
                                                          int lanes, int lc) {
  return (static_cast<long long>(2 + (lc > 2 ? lc : 2)) * K +
          static_cast<long long>(2 + lc) * 2 * lanes) *
         cw;
}

// where row k of channel ch of this thread's column lies: base + ch * chan
// + k * row
struct ColumnRows {
  long long base, chan, row;
  __device__ __forceinline__ long long at(int ch, int k) const {
    return base + ch * chan + k * row;
  }
};

// the systems of this thread's column
template <typename T>
struct ColumnSystem {
  ColumnRows rows;
  // the thickness of row k: channel 0 at the column (cells), or the edge's
  // cmean w0 h[d0] + w1 h[d1], d0 and d1 relative to rows.at(0, k)
  bool cells;
  long long d0, d1;
  T w0, w1;
  // G's coefficient at interface k: coef[k * cstride], or coef0 where coef
  // is null
  const T* coef;
  long long cstride;
  T coef0, dt;
  int K;
  int ch0, nrhs, lc;   // first value channel, values in all, per pass
  bool live;           // false: compute, store nothing (a ragged group)
};

// The whole solve of a block's columns, in place on `s`: kRhs is the width
// the sweeps are compiled for (c.lc <= kRhs per pass); kRoundW rounds the
// edge thickness's two products on their own (the sphere's cmean, as its
// plain version rounds them); kHoles leaves a column whose thickness is not
// positive at every layer as it was (ok: one flag per column in shared
// memory).
template <typename T, int kRhs, bool kRoundW, bool kHoles>
__device__ __forceinline__ void solve_columns(T* __restrict__ s,
                                              const ColumnSystem<T>& c,
                                              T* sm, int* ok) {
  const int K = c.K, CW = blockDim.x, P = blockDim.y, R = 2 * P;
  const int tx = threadIdx.x, lane = threadIdx.y;
  // the staged columns, [K][CW] arrays (k slowest): the thickness (edges:
  // of the first cell), the coefficients, then the right-hand sides'
  // values (edges: the second cell's thickness, then u). The sweeps
  // overwrite a row's thickness with a', its coefficient with c' and its
  // values with d'. Then the reduced system: [R rows][CW] of a, c and the
  // right-hand sides.
  const int N = K * CW;
  T* const SH = sm;
  T* const SC = sm + N;
  T* const SH1 = sm + 2 * N;
  T* const SV = sm + (c.cells ? 2 : 3) * N;
  T* const RA = sm + (2 + (c.lc > 2 ? c.lc : 2)) * N;
  T* const RC = RA + R * CW;
  T* const RD = RC + R * CW;
  if (kHoles && lane == 0) ok[tx] = 1;

  // the lane's rows [k0, k0 + m), 2 <= m <= kChunk
  const int k0 = lane * K / P, m = (lane + 1) * K / P - k0;
  const auto thick = [&](int k) {
    const int e = k * CW + tx;
    if (c.cells) return SH[e];
    if constexpr (kRoundW) {
      return mul_rn(c.w0, SH[e]) + mul_rn(c.w1, SH1[e]);
    } else {
      return c.w0 * SH[e] + c.w1 * SH1[e];
    }
  };
  // G of interface k from the thickness of rows k and k+1; 0 at the bottom
  const auto coupling = [&](int k, T hk, T hk1) {
    if (k >= K - 1) return T(0);
    const T kap = c.coef ? SC[k * CW + tx] : c.coef0;
    return c.dt * kap / (T(0.5) * (hk + hk1));
  };

  for (int l0 = 0; l0 < c.nrhs; l0 += c.lc) {
    const int n = c.lc < c.nrhs - l0 ? c.lc : c.nrhs - l0;
    // stage the pass's columns, every row once (rows strided over the
    // lanes), all copies in flight together
    for (int k = lane; k < K; k += P) {
      const long long r0 = c.rows.at(0, k);
      const int e = k * CW + tx;
      if (c.cells) {
        copy_async(&SH[e], &s[r0]);
      } else {
        copy_async(&SH[e], &s[r0 + c.d0]);
        copy_async(&SH1[e], &s[r0 + c.d1]);
      }
      if (c.coef && k < K - 1) copy_async(&SC[e], &c.coef[k * c.cstride]);
      for (int q = 0; q < n; ++q)
        copy_async(&SV[q * N + e], &s[c.rows.at(c.ch0 + l0 + q, k)]);
    }
    copies_done();
    __syncthreads();
    // what the chunk reads of its neighbours' rows, before they rewrite
    // them: G of interface k0-1, the thickness of row k0+m
    T gm = k0 > 0 ? coupling(k0 - 1, thick(k0 - 1), thick(k0)) : T(0);
    const T hlast = k0 + m < K ? thick(k0 + m) : T(1);
    __syncthreads();

    // the rows a x_{k-1} + b x_k + c x_{k+1} = d, d = H phi, a = -G_{k-1},
    // c = -G_k, b = H + G_k + G_{k-1}. Forward sweep: rows 0 and 1
    // normalised, row i >= 2 made a'_i x_0 + x_i + c'_i x_{i+1} = d'_i
    T a0 = T(0), c0 = T(0), d0[kRhs];   // row 0, kept for its step
    T ap = T(0), cp = T(0), dp[kRhs];   // the row before
#pragma unroll
    for (int q = 0; q < kRhs; ++q) d0[q] = dp[q] = T(0);
    bool holes = false;
    T hk = thick(k0);
    for (int i = 0; i < m; ++i) {
      const int k = k0 + i, e = k * CW + tx;
      const T hk1 = i + 1 < m ? thick(k + 1) : hlast;
      if (kHoles && !(hk > T(0))) holes = true;
      const T gk = coupling(k, hk, hk1);
      const T b = hk + gk + gm;
      T a = -gm, cc = -gk, d[kRhs];
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        d[q] = q < n ? hk * SV[q * N + e] : T(0);
      if (i < 2) {
        const T r = T(1) / b;
        a *= r;
        cc *= r;
#pragma unroll
        for (int q = 0; q < kRhs; ++q) d[q] *= r;
      } else {
        const T r = T(1) / (b - a * cp);
#pragma unroll
        for (int q = 0; q < kRhs; ++q) d[q] = r * (d[q] - a * dp[q]);
        cc = r * cc;
        a = -r * a * ap;
      }
      SH[e] = a;
      SC[e] = cc;
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < n) SV[q * N + e] = d[q];
      if (i == 0) {
        a0 = a;
        c0 = cc;
#pragma unroll
        for (int q = 0; q < kRhs; ++q) d0[q] = d[q];
      }
      ap = a;
      cp = cc;
#pragma unroll
      for (int q = 0; q < kRhs; ++q) dp[q] = d[q];
      gm = gk;
      hk = hk1;
    }
    if (kHoles && holes) ok[tx] = 0;
    // (ap, cp, dp) is the last row now. Backward sweep: row i in [1, m-3]
    // becomes a'_i x_0 + x_i + c'_i x_{m-1} = d'_i (rows m-2, m-1 already
    // are); (an, cn, dn) is the row after
    T an = T(0), cn = T(0), dn[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) dn[q] = T(0);
    if (m >= 3) {
      const int e = (k0 + m - 2) * CW + tx;
      an = SH[e];
      cn = SC[e];
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < n) dn[q] = SV[q * N + e];
    }
    for (int i = m - 3; i >= 1; --i) {
      const int e = (k0 + i) * CW + tx;
      const T cc = SC[e];
      const T a = SH[e] - cc * an;
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < n) dn[q] = SV[q * N + e] - cc * dn[q];
      cn = -cc * cn;
      an = a;
      SH[e] = an;
      SC[e] = cn;
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < n) SV[q * N + e] = dn[q];
    }
    // row 0: a'_0 x_{k0-1} + x_0 + c'_0 x_{m-1} = d'_0 (already so for
    // m = 2); (an, cn, dn) is row 1 now
    if (m >= 3) {
      const T r = T(1) / (T(1) - c0 * an);
#pragma unroll
      for (int q = 0; q < kRhs; ++q) d0[q] = r * (d0[q] - c0 * dn[q]);
      a0 = r * a0;
      c0 = -r * c0 * cn;
    }

    // the reduced system: the lane's first and last rows
    const int r0 = 2 * lane * CW + tx, r1 = r0 + CW;
    RA[r0] = a0;
    RC[r0] = c0;
    RA[r1] = ap;
    RC[r1] = cp;
#pragma unroll
    for (int q = 0; q < kRhs; ++q) {
      if (q < n) {
        RD[q * R * CW + r0] = d0[q];
        RD[q * R * CW + r1] = dp[q];
      }
    }
    __syncthreads();
    if (lane == 0) {
      // Thomas on the R rows (unit diagonal), the solution into RD
      for (int j = 1; j < R; ++j) {
        const int i = j * CW + tx, im = i - CW;
        const T r = T(1) / (T(1) - RA[i] * RC[im]);
        RC[i] = r * RC[i];
#pragma unroll
        for (int q = 0; q < kRhs; ++q)
          if (q < n)
            RD[q * R * CW + i] =
                r * (RD[q * R * CW + i] - RA[i] * RD[q * R * CW + im]);
      }
      for (int j = R - 2; j >= 0; --j) {
        const int i = j * CW + tx;
#pragma unroll
        for (int q = 0; q < kRhs; ++q)
          if (q < n) RD[q * R * CW + i] -= RC[i] * RD[q * R * CW + i + CW];
      }
    }
    __syncthreads();

    // back-substitution inside the chunk, and the stores
    const bool store = c.live && (!kHoles || ok[tx] != 0);
#pragma unroll
    for (int q = 0; q < kRhs; ++q) {
      if (q < n && store) {
        const T xf = RD[q * R * CW + r0], xl = RD[q * R * CW + r1];
        for (int i = 0; i < m; ++i) {
          const int e = (k0 + i) * CW + tx;
          s[c.rows.at(c.ch0 + l0 + q, k0 + i)] =
              i == 0       ? xf
              : i == m - 1 ? xl
                           : SV[q * N + e] - SH[e] * xf - SC[e] * xl;
        }
      }
    }
    __syncthreads();   // the next pass restages the columns
  }
}

}  // namespace omega
