// What the planar chain kernels share: the shift tables as compile-time
// entry layouts with their offsets and weights in the kernel's parameter
// space (FbParams, which every chain kernel reads), and the slab's shared
// memory and grid. The FB step, the RK stage, the split step's chain and
// splitpost and the barotropic subcycles walk their chains on a compiled
// slab geometry and entry pattern (hex_slab.cuh).
//
// A block is one layer k x one (by, bx) horizontal tile of the stacked state
// (4+L, K, ny, nx), x fastest; it holds a (by+2ry) x (bx+2rx) slab of every
// value it needs in shared memory ("slots" of S = YY * XX elements), walks a
// chain level by level with a block-wide barrier between levels, and writes
// only the owned centre. Every level is evaluated on the whole slab, and a
// shifted read that leaves the slab returns some other in-bounds value, so
// wrong values creep in from the slab edge by one stencil radius per level;
// the host derives the ring that keeps the centre exact from each chain
// itself (ops/megastep.py:chain_radius).
#pragma once

#include "stencil_common.cuh"

namespace omega {

enum FbTable {
  T_DIV = 0, T_KE, T_CURL, T_KITE, T_TANG, T_CDIFF, T_CMEAN, T_VDIFF,
  T_VMEAN, T_SDIV, T_C0, T_C1, T_DIVP, T_DIVN, T_COC0, T_COUNT = T_COC0 + 6
};

constexpr int kFbMaxEntries = 96;

// Entries per destination class of each table on the planar hex mesh (a
// cell has 6 edges, a vertex 3 edges and 3 cells, an edge 2 cells, 2 vertices
// and 8 non-zero tangential weights; c0 and c1 name an edge's first and
// second cell, coc0..coc5 a cell's six neighbours; div_pos and div_neg keep
// the three edges of a cell whose divergence weight has that sign), and the
// classes per table. The layout of the entry arrays is fixed at compile
// time, so every stencil loop unrolls and each offset and weight is an
// immediate operand from the kernel's parameter space; the launchers refuse
// tables that do not have these counts (the host then runs the composed
// step).
__host__ __device__ constexpr int tab_count(int b) {
  return (b == T_C0 || b == T_C1 || b >= T_COC0) ? 1
         : (b == T_CURL || b == T_KITE || b == T_DIVP || b == T_DIVN) ? 3
         : b == T_TANG                                                ? 8
         : (b == T_DIV || b == T_KE || b == T_SDIV)                   ? 6
                                                                      : 2;
}
__host__ __device__ constexpr int tab_classes(int b) {
  return (b == T_DIV || b == T_KE || b == T_SDIV || b == T_DIVP ||
          b == T_DIVN || b >= T_COC0)
             ? 1
         : (b == T_CURL || b == T_KITE) ? 2
                                        : 3;
}
// first entry of table b: tables in enum order, classes in order within
__host__ __device__ constexpr int tab_base(int b) {
  int n = 0;
  for (int i = 0; i < b; ++i) n += tab_count(i) * tab_classes(i);
  return n;
}
static_assert(tab_base(T_COUNT) <= kFbMaxEntries, "entry arrays too small");

template <typename T>
struct FbParams {
  // entry i reads slab element q + off[parity of q's row][i] (a flat offset
  // class * S + dj * XX + di, computed on the host for this tile) times w[i]
  int off[2][kFbMaxEntries];
  T w[kFbMaxEntries];
  // entries of table b, destination class t, as the host packed them:
  // [start[b][t], start[b][t+1]) — checked against the layout above
  short start[T_COUNT][4];
  // constants folded in float64 on the host and rounded to T once:
  // nu2s = nu2*scal2, nu4s = nu4*scal4, ed2s = ed2*scal2, geo4 = geo*scal4;
  // rho0 and cd (0 = no drag) are read by the TAILS variants only
  T dt, grav, nu2s, nu4s, div_factor, ed2s, ed4, inv_dc, inv_dv, inv_dv_floor,
      geo, geo4, f0v, rho0, cd;
  // guard: elements of slack before the first and after the last slab array,
  // at least max|dj| * (bx + 2 rx) + max|di| over all entries
  int L, K, ny, nx, by, bx, ry, rx, guard;
};

// the host's packing matches the compile-time layout
template <typename T>
bool layout_ok(const FbParams<T>& p) {
  for (int b = 0; b < T_COUNT; ++b)
    for (int t = 0; t <= tab_classes(b); ++t)
      if (p.start[b][t] != tab_base(b) + t * tab_count(b)) return false;
  return p.guard >= 2 * (p.bx + 2 * p.rx) + 2;
}

// the reference's upwind selection: a where u > 0, b where u < 0, the larger
// of the two at rest
template <typename T>
__device__ __forceinline__ T upwind_sel(T u, T a, T b) {
  return u > T(0) ? a : (u < T(0) ? b : (a > b ? a : b));
}

// a[r] as a read for AP
template <typename T>
struct At {
  const T* a;
  __device__ __forceinline__ T operator()(int r) const { return a[r]; }
};
template <typename T>
__device__ __forceinline__ At<T> at(const T* a) {
  return At<T>{a};
}

// bytes of dynamic shared memory for `slots` slab arrays and the guards
template <typename T>
size_t slab_smem_bytes(const FbParams<T>& p, int slots) {
  const size_t S = static_cast<size_t>(p.by + 2 * p.ry) * (p.bx + 2 * p.rx);
  return (slots * S + 2 * static_cast<size_t>(p.guard)) * sizeof(T);
}

// the grid of a chain kernel: tiles x layers
template <typename T>
dim3 slab_grid(const FbParams<T>& p) {
  return dim3((p.nx + p.bx - 1) / p.bx, (p.ny + p.by - 1) / p.by, p.K);
}

}  // namespace omega
