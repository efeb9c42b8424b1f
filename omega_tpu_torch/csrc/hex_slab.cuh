// The planar hex mesh's table-entry pattern and a slab geometry compiled in:
// what the fused FB step (fb_step.cuh, splitpost among its instantiations),
// the RK stage (rk_stage.cuh) and splitpre's chain (split.cu) share, so
// that every shared-memory read of a stencil is one load at an immediate
// offset from the point's own index, with no parity select and no address
// arithmetic, and its weight an operand from the kernel's parameter space
// (FbParams::w).
//
// A kernel names its geometry, HexSlab<BY, BX, RY, RX, THREADS>: a block is
// one layer x one BY x BX tile with a (RY, RX) ring, THREADS threads, and
// each thread owns a pair of rows (even, odd) of one column of the tile
// (THREADS == the tile's row pairs x columns). The tile's first row is even
// (BY is even, ny is even), so the parity of every slab row is known at
// compile time: even for the slab's first row when RY is even, odd when it
// is odd. On the slab a thread evaluates a column of four rows at a time,
// and where the slab's rows are not whole quads, the last two rows' columns
// go to the threads the quads left idle.
#pragma once

#include <array>
#include <utility>

#include "slab_chain.cuh"

namespace omega {

// Field f of the planar hex mesh's table entry e, in the packed order of
// ops/megastep.pack_params (tables in FbTable order, destination classes in
// order, table order within a class): source class, dj, di on even rows, di
// on odd rows. ops/megastep.HEX_PATTERN is the same list. (A local array:
// device code may read no host variable.)
__host__ __device__ constexpr int hex_ent(int e, int f) {
  constexpr signed char t[kFbMaxEntries][4] = {
    {0, 0, 0, 0},   {1, 0, 0, 0},   {2, 0, 0, 0},   {0, 0, -1, -1},  // div
    {1, -1, -1, 0}, {2, -1, 0, 1},
    {0, 0, 0, 0},   {1, 0, 0, 0},   {2, 0, 0, 0},   {0, 0, -1, -1},  // ke
    {1, -1, -1, 0}, {2, -1, 0, 1},
    {0, 0, 0, 0},   {1, 0, 0, 0},   {2, 0, 1, 1},                    // curl
    {1, 0, 0, 0},   {2, 0, 0, 0},   {0, 1, -1, 0},
    {0, 0, 0, 0},   {0, 0, 1, 1},   {0, 1, 0, 1},                    // kite
    {0, 0, 0, 0},   {0, 1, 0, 1},   {0, 1, -1, 0},
    {1, 0, 0, 0},   {2, 0, 0, 0},   {1, -1, -1, 0}, {2, -1, 0, 1},   // tang
    {1, -1, 0, 1},  {2, -1, 1, 2},  {1, 0, 1, 1},   {2, 0, 1, 1},
    {2, 0, 0, 0},   {0, 0, -1, -1}, {2, -1, 0, 1},  {0, 0, 0, 0},
    {2, 0, 1, 1},   {0, 1, 0, 1},   {2, 1, 0, 1},   {0, 1, -1, 0},
    {0, 0, -1, -1}, {1, -1, -1, 0}, {0, 0, 0, 0},   {1, 0, 0, 0},
    {0, 1, -1, 0},  {1, 1, -1, 0},  {0, 1, -2, -1}, {1, 0, -1, -1},
    {0, 0, 0, 0},   {0, 0, 1, 1},   {0, 0, 0, 0},   {0, 1, 0, 1},    // cdiff
    {0, 0, 0, 0},   {0, 1, -1, 0},
    {0, 0, 0, 0},   {0, 0, 1, 1},   {0, 0, 0, 0},   {0, 1, 0, 1},    // cmean
    {0, 0, 0, 0},   {0, 1, -1, 0},
    {1, -1, 0, 1},  {0, 0, 0, 0},   {0, 0, 0, 0},   {1, 0, 0, 0},    // vdiff
    {1, 0, 0, 0},   {0, 0, -1, -1},
    {1, -1, 0, 1},  {0, 0, 0, 0},   {0, 0, 0, 0},   {1, 0, 0, 0},    // vmean
    {1, 0, 0, 0},   {0, 0, -1, -1},
    {0, 0, 0, 0},   {1, 0, 0, 0},   {2, 0, 0, 0},   {0, 0, -1, -1},  // sdiv
    {1, -1, -1, 0}, {2, -1, 0, 1},
    {0, 0, 0, 0},   {0, 0, 0, 0},   {0, 0, 0, 0},                    // c0
    {0, 0, 1, 1},   {0, 1, 0, 1},   {0, 1, -1, 0},                   // c1
    {0, 0, 0, 0},   {1, 0, 0, 0},   {2, 0, 0, 0},                    // div_pos
    {0, 0, -1, -1}, {1, -1, -1, 0}, {2, -1, 0, 1},                   // div_neg
    {0, 0, 1, 1},   {0, 1, 0, 1},   {0, 1, -1, 0},                   // coc
    {0, 0, -1, -1}, {0, -1, -1, 0}, {0, -1, 0, 1}};
  return t[e][f];
}

template <int V>
using ic = std::integral_constant<int, V>;

template <typename F, int... I>
__device__ __forceinline__ void static_for_(F&& f,
                                            std::integer_sequence<int, I...>) {
  (f(ic<I>{}), ...);
}
// f(ic<0>), ..., f(ic<N-1>) in order
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_(f, std::make_integer_sequence<int, N>{});
}

template <int BY, int BX, int RY, int RX, int THREADS>
struct HexSlab {
  static constexpr int kBY = BY, kBX = BX, kRY = RY, kRX = RX;
  static constexpr int kXX = BX + 2 * RX, kYY = BY + 2 * RY, kS = kXX * kYY;
  static constexpr int kGuard = 2 * kXX + 2;   // guard_elems of megastep.py
  static constexpr int kThreads = THREADS;
  static constexpr int kPar0 = RY & 1;         // parity of the slab's row 0
  static constexpr int kQuadJobs = (kYY / 4) * kXX;   // row quads x columns
  static constexpr int kOwnJobs = (BY / 2) * BX;
  static_assert(BY % 2 == 0, "the tile's first row is even");
  static_assert(kYY % 2 == 0, "the slab is whole row pairs");
  static_assert(kOwnJobs == THREADS, "one owned pair per thread");

  // flat slab offset of entry e for a point on a row of parity par
  __host__ __device__ static constexpr int off(int e, int par) {
    return hex_ent(e, 0) * kS + hex_ent(e, 1) * kXX + hex_ent(e, 2 + par);
  }
  // the offset of the one entry of pair table B (T_C0 or T_C1), class t
  template <int B, int t, int PAR>
  static constexpr int kPair = off(tab_base(B) + t, PAR);

  template <int B, int t, int PAR, typename T, typename Rd, int... I>
  static __device__ __forceinline__ T ap_(const FbParams<T>& p, int q,
                                          const Rd& rd,
                                          std::integer_sequence<int, I...>) {
    constexpr int e0 = tab_base(B) + t * tab_count(B);
    T acc = T(0);
    ((acc += p.w[e0 + I] * rd(q + std::integral_constant<
                                      int, off(e0 + I, PAR)>::value)),
     ...);
    return acc;
  }
  // sum_i w[i] * rd(q + off[i]) over the entries of (table B, class t), in
  // entry order, for a point q on a row of parity PAR, with every offset an
  // immediate
  template <int B, int t, int PAR, typename T, typename Rd>
  static __device__ __forceinline__ T ap(const FbParams<T>& p, int q,
                                         const Rd& rd) {
    return ap_<B, t, PAR>(p, q, rd,
                          std::make_integer_sequence<int, tab_count(B)>{});
  }

  // f(ic<parity>, q) for every slab point q: for every row quad and column,
  // q on the quad's first row, then the rows below it; where the slab ends
  // on half a quad, its last two rows' columns on the threads after the
  // quads' last
  template <typename F>
  static __device__ __forceinline__ void rows(F&& f) {
    for (int j = threadIdx.x; j < kQuadJobs; j += THREADS) {
      const int pr = j / kXX, q = 4 * pr * kXX + (j - pr * kXX);
      f(ic<kPar0>{}, q);
      f(ic<1 - kPar0>{}, q + kXX);
      f(ic<kPar0>{}, q + 2 * kXX);
      f(ic<1 - kPar0>{}, q + 3 * kXX);
    }
    if constexpr (kYY % 4 == 2) {
      constexpr int first = kQuadJobs % THREADS;
      for (int j = (threadIdx.x + THREADS - first) % THREADS; j < kXX;
           j += THREADS) {
        const int q = (kYY - 2) * kXX + j;
        f(ic<kPar0>{}, q);
        f(ic<1 - kPar0>{}, q + kXX);
      }
    }
  }

  // the host's plan is the tile, ring and entry pattern compiled here (the
  // pattern's offsets worked out once: a launch checks them every call)
  template <typename T>
  static bool geometry_ok(const FbParams<T>& p) {
    if (p.by != kBY || p.bx != kBX || p.ry != kRY || p.rx != kRX ||
        p.guard != kGuard || p.ny % 2 != 0)
      return false;
    static const std::array<std::array<int, kFbMaxEntries>, 2> offs = [] {
      std::array<std::array<int, kFbMaxEntries>, 2> o{};
      for (int e = 0; e < tab_base(T_COUNT); ++e)
        for (int par = 0; par < 2; ++par) o[par][e] = off(e, par);
      return o;
    }();
    for (int e = 0; e < tab_base(T_COUNT); ++e)
      for (int par = 0; par < 2; ++par)
        if (p.off[par][e] != offs[par][e]) return false;
    return true;
  }
};

}  // namespace omega
