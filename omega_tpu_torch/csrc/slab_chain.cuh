// What the planar chain kernels share: the shift tables as compile-time
// entry layouts with their offsets and weights in the kernel's parameter
// space (FbParams, which every chain kernel reads), and the one-layer x
// (by, bx) slab with the periodic wrap as index arithmetic and run-time
// offsets, on which the barotropic subcycles (barotropic.cu) run. The FB
// step, the RK stage and the split step's chain and splitpost walk their
// chains on a compiled slab geometry and entry pattern instead
// (hex_slab.cuh).
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

// sum_i w[i] * read(q + off[i]) over the entries of (table B, class t) for a
// point q on a row of the given parity. With t a compile-time value (the
// callers' loops over t are unrolled) every index below is a constant.
template <int B, typename T, typename Read>
__device__ __forceinline__ T apply(const FbParams<T>& p, int t, bool odd,
                                   int q, Read read) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < tab_count(B); ++i) {
    const int e = tab_base(B) + t * tab_count(B) + i;
    acc += p.w[e] * read(q + (odd ? p.off[1][e] : p.off[0][e]));
  }
  return acc;
}

// apply table B (destination class t) at point q of row parity `odd`
#define AP(B, t, read) apply<B>(p, t, odd, q, read)

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

// The block's slab: layer k, tile origin (y0, x0), slab origin (gy0, gx0)
// with the ring, S points in rows of XX; each thread walks the slab from
// (sy0, sx0) in strides of (dy, dx).
struct Slab {
  int YY, XX, S, y0, x0, k, gy0, gx0, par0, nown, sy0, sx0, dy, dx;
  long long plane;

  template <typename T>
  __device__ explicit Slab(const FbParams<T>& p) {
    YY = p.by + 2 * p.ry;
    XX = p.bx + 2 * p.rx;
    S = YY * XX;
    y0 = blockIdx.y * p.by;
    x0 = blockIdx.x * p.bx;
    k = blockIdx.z;
    gy0 = y0 - p.ry;
    gx0 = x0 - p.rx;
    par0 = gy0 & 1;  // ny is even, so parity survives the wrap
    plane = static_cast<long long>(p.ny) * p.nx;
    nown = p.by * p.bx;
    sy0 = threadIdx.x / XX;
    sx0 = threadIdx.x - sy0 * XX;
    dy = blockDim.x / XX;
    dx = blockDim.x - dy * XX;
  }
  // device-memory offset (within a channel plane) of slab point q
  template <typename T>
  __device__ long long gofs(const FbParams<T>& p, int q) const {
    const int sy = q / XX, sx = q - sy * XX;
    return static_cast<long long>(wrap_any(gy0 + sy, p.ny)) * p.nx +
           wrap_any(gx0 + sx, p.nx);
  }
  // parity of slab row sy's global row
  __device__ bool is_odd(int sy) const { return ((par0 + sy) & 1) != 0; }
  // owned point o of the tile: its slab point q, plane offset g and row
  // parity; false where a ragged tile leaves the domain
  template <typename T>
  __device__ bool owned(const FbParams<T>& p, int o, int& q, long long& g,
                        bool& odd) const {
    const int oy = o / p.bx, ox = o - oy * p.bx;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= p.ny || gx >= p.nx) return false;
    q = (oy + p.ry) * XX + ox + p.rx;
    g = static_cast<long long>(gy) * p.nx + gx;
    odd = is_odd(oy + p.ry);
    return true;
  }
};

// every slab point q of this thread, with its row sy kept by increments
#define FOR_SLAB(q, sy)                                                     \
  for (int q = threadIdx.x, sy = sl.sy0, sx_ = sl.sx0; q < sl.S;            \
       q += blockDim.x, sy += sl.dy, sx_ += sl.dx,                          \
           (sx_ >= sl.XX ? (sx_ -= sl.XX, ++sy) : 0))

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
