// The whole forward-backward time step as one kernel.
//
// Replaces the TPU kernel omega_tpu/ops/megastep.py:_kernel with the chain
// _fb_compute (stacked ssh; center or upwind thickness and tracer fluxes,
// _h_fluxes / _htr_flux; the wind and bottom-drag tail _wind_drag). The
// vertical-mixing tail of that kernel is csrc/vmix.cu; the FCT tail is not
// ported yet. It computes the chain expression for expression:
//
//   thickness:  h_new = h + dt * (-div(flux_h * u)), flux_h = cmean(h) or the
//               upwind pick of the edge's two cells
//   tracers:    adv + del2 + del4, thickness weighted (fluxes on the OLD h)
//   velocity:   KE, divergence, curl, kite h_v, edge PV on h_new; PV flux,
//               KE and ssh gradients (ssh = h_new, uniform depth), del2 and
//               del4 momentum diffusion, wind stress on the top layer and
//               quadratic drag on the bottom layer -> u_new
//
// Variants are compile-time (template flags UPH, UPT, TAILS), so that the
// flagship instantiation <false, false, false> is the center-flux chain and
// nothing else. An upwind pick needs no slab array of its own: the pair
// tables c0 / c1 have ONE entry per edge class, so h0 and h1 are two shifted
// reads of the thickness slab. Wind and drag touch one layer each and a
// block is one layer, so both are branches uniform over the block (wind for
// blockIdx.z == 0, drag for blockIdx.z == K-1); which of the two a TAILS
// instantiation applies is a run-time matter (wind pointer, cd != 0).
//
// State layout (the port's own): one stacked array (4+L, K, ny, nx), x
// fastest; channel 0 = h, 1..3 = the three edge classes of u, 4.. = tracers.
// The chain couples no two layers, so a block is one layer k x one (by, bx)
// horizontal tile.
//
// Bound on this card: bytes in principle, 2 * (4+L) * K * ny * nx * sizeof(T)
// (state read once, written once); the chain's ~10 stencil levels add a few
// hundred operations per point, far under the card's float rate. What the
// design does about it: a block loads the (by+2ry) x (bx+2rx) slab of its
// 4+L channels into shared memory ONCE, with the periodic wrap as index
// arithmetic, then walks the chain level by level with a block-wide barrier
// between levels, every intermediate living in a shared array of slab size
// (21 arrays, reused between the tracer and velocity phases), and writes
// only the owned centre. No intermediate touches device memory.
//
// The instruction rate and shared-memory loads, not device memory, are what
// the stencil loops cost. So the host turns every table entry into a flat slab
// offset per row parity (class * S + dj * XX + di) and the entry layout is
// fixed at compile time: a shifted read is one select, one add and one shared
// load, with offset and weight as immediate operands from the parameter
// space, no per-entry decode and no index wrap.
//
// Validity: every level is evaluated on the whole slab, and a shifted read
// that leaves the slab returns some other in-bounds value, so wrong values
// creep in from the slab edge by one stencil radius per level. The host
// planner derives the ring that keeps the owned centre exact from the chain
// itself (ops/megastep.py:chain_radius; 3 rows and 3 columns for the hex
// mesh's tables, fewer than the summed table radii because class shifts
// partly cancel). The tiled mode of the plain PyTorch version evaluates its
// slabs under the same rule, and the CPU tests hold it against the
// whole-grid form.
#pragma once

#include "stencil_common.cuh"

namespace omega {

enum FbTable {
  T_DIV = 0, T_KE, T_CURL, T_KITE, T_TANG, T_CDIFF, T_CMEAN, T_VDIFF,
  T_VMEAN, T_SDIV, T_C0, T_C1, T_COUNT
};

constexpr int kFbMaxEntries = 96;
constexpr int kFbSlots = 21;

// Entries per destination class of each table on the planar hex mesh (a
// cell has 6 edges, a vertex 3 edges and 3 cells, an edge 2 cells, 2 vertices
// and 8 non-zero tangential weights; c0 and c1 name an edge's first and
// second cell), and the classes per table. The layout of the entry arrays is
// fixed at compile time, so every stencil loop unrolls and each offset and
// weight is an immediate operand from the kernel's parameter space; the
// launcher refuses tables that do not have these counts (the host then runs
// the composed step).
__host__ __device__ constexpr int tab_count(int b) {
  return (b == T_C0 || b == T_C1)     ? 1
         : (b == T_CURL || b == T_KITE) ? 3
         : b == T_TANG                ? 8
         : (b == T_DIV || b == T_KE || b == T_SDIV) ? 6
                                                    : 2;
}
__host__ __device__ constexpr int tab_classes(int b) {
  return (b == T_DIV || b == T_KE || b == T_SDIV) ? 1
         : (b == T_CURL || b == T_KITE)           ? 2
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

// flat offset of the one entry of pair table B (T_C0 or T_C1), class t
template <int B, typename T>
__device__ __forceinline__ int pair_ofs(const FbParams<T>& p, int t,
                                        bool odd) {
  const int e = tab_base(B) + t * tab_count(B);
  return odd ? p.off[1][e] : p.off[0][e];
}

// the reference's upwind selection: a where u > 0, b where u < 0, the larger
// of the two at rest
template <typename T>
__device__ __forceinline__ T upwind_sel(T u, T a, T b) {
  return u > T(0) ? a : (u < T(0) ? b : (a > b ? a : b));
}

// every slab point q of this thread, with its row sy kept by increments
#define FOR_SLAB(q, sy)                                                     \
  for (int q = threadIdx.x, sy = sy0, sx_ = sx0; q < S;                     \
       q += blockDim.x, sy += dy, sx_ += dx,                                \
           (sx_ >= XX ? (sx_ -= XX, ++sy) : 0))

// UPH / UPT: upwind thickness / tracer flux; TAILS: wind and drag compiled
// in. `wind` is the (3, ny, nx) edge-normal stress plane or null.
template <typename T, bool UPH, bool UPT, bool TAILS>
__global__ void __launch_bounds__(512)
fb_step_kernel(const T* __restrict__ in, T* __restrict__ out,
               const T* __restrict__ wind,
               const __grid_constant__ FbParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int YY = p.by + 2 * p.ry, XX = p.bx + 2 * p.rx, S = YY * XX;
  const int y0 = blockIdx.y * p.by, x0 = blockIdx.x * p.bx, k = blockIdx.z;
  const int gy0 = y0 - p.ry, gx0 = x0 - p.rx;
  const int par0 = gy0 & 1;  // ny is even, so parity survives the wrap
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const int nown = p.by * p.bx;

  // shared memory: [guard | kFbSlots slab arrays | guard]. A shifted read
  // that leaves the slab lands in a neighbouring row, slot or guard: a wrong
  // but harmless value, which only ever reaches the ring.
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;

  // slab arrays; the velocity phase reuses the tracer phase's slots
  T* const H = sm;              // old thickness          (tracer phase)
  T* const U = sm + 1 * S;      // 3 edge classes
  T* const MH = sm + 4 * S;     // mean_h: cmean(h) or 0.5*(h0+h1), 3
  T* const HN = sm + 7 * S;     // new thickness
  T* const TR = sm + 8 * S;     // current tracer
  T* const HTR = sm + 9 * S;    // h*tr on edges (center or upwind), 3
  T* const FH = sm + 9 * S;     // upwind flux_h, 3 (dead before the tracers)
  T* const G = sm + 12 * S;     // geo*mean_h*cdiff(tr), 3
  T* const ADV = sm + 15 * S;
  T* const D2 = sm + 16 * S;
  T* const CD2 = sm + 17 * S;   // geo4*cdiff(d2tr), 3
  T* const KE = sm;             //                        (velocity phase)
  T* const MHN = sm + 4 * S;    // flux_h of h_new: cmean or upwind pick, 3
  T* const DIVU = sm + 8 * S;
  T* const RV = sm + 9 * S;     // curl(u), 2
  T* const NRV = sm + 11 * S;   // rvort / h_v, 2
  T* const NPV = sm + 13 * S;   // f / h_v, 2
  T* const Q = sm + 15 * S;     // edge PV, 3
  T* const D2E = sm + 18 * S;   // del2 of u on edges, 3
  T* const D2DIV = sm + 11 * S; // div(del2_e)   (after NRV/NPV are dead)
  T* const D2RV = sm + 12 * S;  // curl(del2_e), 2

  auto chan = [&](int ch) {
    return (static_cast<long long>(ch) * p.K + k) * plane;
  };
  // device-memory offset (within a channel plane) of slab point q
  auto gofs = [&](int q) {
    const int sy = q / XX, sx = q - sy * XX;
    return static_cast<long long>(wrap_any(gy0 + sy, p.ny)) * p.nx +
           wrap_any(gx0 + sx, p.nx);
  };
  // parity of slab row sy's global row
  auto is_odd = [&](int sy) { return ((par0 + sy) & 1) != 0; };
  // this thread's walk over the slab: start point and stride as (row, column)
  const int sy0 = threadIdx.x / XX, sx0 = threadIdx.x - sy0 * XX;
  const int dy = blockDim.x / XX, dx = blockDim.x - dy * XX;
  auto at = [](const T* a) { return [a](int r) { return a[r]; }; };

  // ---- load h and u with the periodic wrap
  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const long long g = gofs(q);
    H[q] = in[chan(0) + g];
    U[q] = in[chan(1) + g];
    U[S + q] = in[chan(2) + g];
    U[2 * S + q] = in[chan(3) + g];
  }
  __syncthreads();

  // ---- mean_h = cmean(h); upwind: mean_h = 0.5*(h0+h1), flux_h = the pick
  FOR_SLAB(q, sy) {
    const bool odd = is_odd(sy);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      if constexpr (UPH) {
        const T h0 = H[q + pair_ofs<T_C0>(p, t, odd)];
        const T h1 = H[q + pair_ofs<T_C1>(p, t, odd)];
        MH[t * S + q] = T(0.5) * (h0 + h1);
        FH[t * S + q] = upwind_sel(U[t * S + q], h0, h1);
      } else {
        MH[t * S + q] = AP(T_CMEAN, t, at(H));
      }
    }
  }
  __syncthreads();

  // ---- h_new = h + dt * (-div(flux_h * u))
  FOR_SLAB(q, sy) {
    const bool odd = is_odd(sy);
    const T dh = AP(T_DIV, 0, [&](int r) {
      return (UPH ? FH[r] : MH[r]) * U[r];
    });
    HN[q] = H[q] + p.dt * (-dh);
  }
  __syncthreads();

  // ---- tracers, one at a time through the same slab arrays
  for (int l = 0; l < p.L; ++l) {
    for (int q = threadIdx.x; q < S; q += blockDim.x)
      TR[q] = in[chan(4 + l) + gofs(q)];
    __syncthreads();

    FOR_SLAB(q, sy) {
      const bool odd = is_odd(sy);
      _Pragma("unroll") for (int t = 0; t < 3; ++t) {
        if constexpr (UPT) {
          const int o0 = pair_ofs<T_C0>(p, t, odd);
          const int o1 = pair_ofs<T_C1>(p, t, odd);
          HTR[t * S + q] = upwind_sel(U[t * S + q], H[q + o0] * TR[q + o0],
                                      H[q + o1] * TR[q + o1]);
        } else {
          HTR[t * S + q] =
              AP(T_CMEAN, t, [&](int r) { return H[r] * TR[r]; });
        }
        const T ctr = AP(T_CDIFF, t, at(TR));
        G[t * S + q] = p.geo * MH[t * S + q] * ctr;
      }
    }
    __syncthreads();

    FOR_SLAB(q, sy) {
      const bool odd = is_odd(sy);
      ADV[q] = -AP(T_DIV, 0, [&](int r) { return HTR[r] * U[r]; });
      D2[q] = AP(T_SDIV, 0, at(G));
    }
    __syncthreads();

    FOR_SLAB(q, sy) {
      const bool odd = is_odd(sy);
      _Pragma("unroll") for (int t = 0; t < 3; ++t)
        CD2[t * S + q] = p.geo4 * AP(T_CDIFF, t, at(D2));
    }
    __syncthreads();

    // owned centre only: del4 = signed_div(geo4 * cdiff(d2tr)), then the
    // thickness-weighted update
    for (int o = threadIdx.x; o < nown; o += blockDim.x) {
      const int oy = o / p.bx, ox = o - oy * p.bx;
      const int gy = y0 + oy, gx = x0 + ox;
      if (gy >= p.ny || gx >= p.nx) continue;
      const int q = (oy + p.ry) * XX + ox + p.rx;
      const bool odd = is_odd(oy + p.ry);
      const T hyp = AP(T_SDIV, 0, at(CD2));
      const T dtr = ADV[q] + p.ed2s * D2[q] - p.ed4 * hyp;
      out[chan(4 + l) + static_cast<long long>(gy) * p.nx + gx] =
          (TR[q] * H[q] + p.dt * dtr) / HN[q];
    }
    __syncthreads();
  }

  // ---- velocity aux on h_new: ke, div, curl, h_v, normalized vorticities
  FOR_SLAB(q, sy) {
    const bool odd = is_odd(sy);
    KE[q] = AP(T_KE, 0, [&](int r) { return U[r] * U[r]; });
    DIVU[q] = AP(T_DIV, 0, at(U));
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      if constexpr (UPH) {
        MHN[t * S + q] = upwind_sel(U[t * S + q],
                                    HN[q + pair_ofs<T_C0>(p, t, odd)],
                                    HN[q + pair_ofs<T_C1>(p, t, odd)]);
      } else {
        MHN[t * S + q] = AP(T_CMEAN, t, at(HN));
      }
    }
    _Pragma("unroll") for (int t = 0; t < 2; ++t) {
      const T rv = AP(T_CURL, t, at(U));
      const T hv = AP(T_KITE, t, at(HN));
      RV[t * S + q] = rv;
      NRV[t * S + q] = rv / hv;
      NPV[t * S + q] = p.f0v / hv;
    }
  }
  __syncthreads();

  // ---- edge PV and the del2 of u on edges
  FOR_SLAB(q, sy) {
    const bool odd = is_odd(sy);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T nrv_e = AP(T_VMEAN, t, at(NRV));
      const T npv_e = AP(T_VMEAN, t, at(NPV));
      Q[t * S + q] = nrv_e + npv_e;
      const T cdd = AP(T_CDIFF, t, at(DIVU));
      const T vdr = AP(T_VDIFF, t, at(RV));
      D2E[t * S + q] = cdd * p.inv_dc - vdr * p.inv_dv_floor;
    }
  }
  __syncthreads();

  // ---- div and curl of del2_e (into the dead NRV/NPV slots)
  FOR_SLAB(q, sy) {
    const bool odd = is_odd(sy);
    D2DIV[q] = AP(T_DIV, 0, at(D2E));
    _Pragma("unroll") for (int t = 0; t < 2; ++t) D2RV[t * S + q] = AP(T_CURL, t, at(D2E));
  }
  __syncthreads();

  // ---- owned centre: write h_new, assemble du, write u_new
  // wind on the top layer, drag on the bottom one: uniform over the block
  const bool top = TAILS && wind != nullptr && k == 0;
  const bool bottom = TAILS && p.cd != T(0) && k == p.K - 1;
  for (int o = threadIdx.x; o < nown; o += blockDim.x) {
    const int oy = o / p.bx, ox = o - oy * p.bx;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= p.ny || gx >= p.nx) continue;
    const int q = (oy + p.ry) * XX + ox + p.rx;
    const long long g = static_cast<long long>(gy) * p.nx + gx;
    out[chan(0) + g] = HN[q];

    const bool odd = is_odd(oy + p.ry);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      // tang(F) and tang(F*q) share the walk; F = flux_hn * u on the fly
      T tf = T(0), tfq = T(0);
#pragma unroll
      for (int i = 0; i < tab_count(T_TANG); ++i) {
        const int e = tab_base(T_TANG) + t * tab_count(T_TANG) + i;
        const int r = q + (odd ? p.off[1][e] : p.off[0][e]);
        const T F = MHN[r] * U[r];
        tf += p.w[e] * F;
        tfq += p.w[e] * (F * Q[r]);
      }
      const T qe = Q[t * S + q];
      const T pv = T(0.5) * (qe * tf + tfq);

      const T gke = AP(T_CDIFF, t, at(KE));
      const T gssh = AP(T_CDIFF, t, at(HN));
      const T cd4 = AP(T_CDIFF, t, at(D2DIV));
      const T vd4 = AP(T_VDIFF, t, at(D2RV));
      const T cdd = AP(T_CDIFF, t, at(DIVU));
      const T vdr = AP(T_VDIFF, t, at(RV));

      // the du diffusion terms use plain 1/dv, del2_e above the floored one
      T du = pv - gke * p.inv_dc - p.grav * gssh * p.inv_dc +
             p.nu2s * (cdd * p.inv_dc - vdr * p.inv_dv) -
             p.nu4s * (p.div_factor * cd4 * p.inv_dc - vd4 * p.inv_dv);
      if constexpr (TAILS) {
        if (top || bottom) {
          // both use mean_h of h_new (the FB momentum-aux level)
          T mh;
          if constexpr (UPH) {
            mh = T(0.5) * (HN[q + pair_ofs<T_C0>(p, t, odd)] +
                           HN[q + pair_ofs<T_C1>(p, t, odd)]);
          } else {
            mh = MHN[t * S + q];
          }
          if (top) du = du + wind[t * plane + g] / (p.rho0 * mh);
          if (bottom) {
            // 2*cmean(ke) == ke0 + ke1 bit for bit (halving and doubling
            // are exact), the composed step's sqrt(ke0 + ke1)
            const T kee = AP(T_CMEAN, t, at(KE));
            const T twice = T(2) * kee;
            const T speed = sqrt(twice > T(0) ? twice : T(0));
            du = du + (-(p.cd * speed * U[t * S + q] / mh));
          }
        }
      }
      out[chan(1 + t) + g] = U[t * S + q] + p.dt * du;
    }
  }
}

// bytes of dynamic shared memory the kernel needs for these parameters
template <typename T>
size_t fb_smem_bytes(const FbParams<T>& p) {
  const size_t S = static_cast<size_t>(p.by + 2 * p.ry) * (p.bx + 2 * p.rx);
  return (kFbSlots * S + 2 * static_cast<size_t>(p.guard)) * sizeof(T);
}

template <typename T, bool UPH, bool UPT, bool TAILS>
int launch_fb_step(const void* in, void* out, const void* wind,
                   const FbParams<T>* hp, int threads, cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads < 32 || threads > 512) return cudaErrorInvalidConfiguration;
  // a variant without the tails must not be handed wind or drag
  if (!TAILS && (wind != nullptr || p.cd != T(0))) return cudaErrorInvalidValue;
  if (p.guard < 2 * (p.bx + 2 * p.rx) + 2) return cudaErrorInvalidValue;
  for (int b = 0; b < T_COUNT; ++b)
    for (int t = 0; t <= tab_classes(b); ++t)
      if (p.start[b][t] != tab_base(b) + t * tab_count(b))
        return cudaErrorInvalidValue;
  const size_t smem = fb_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      fb_step_kernel<T, UPH, UPT, TAILS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nx + p.bx - 1) / p.bx, (p.ny + p.by - 1) / p.by, p.K);
  fb_step_kernel<T, UPH, UPT, TAILS><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const T*>(wind), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omega

// The C interface of one (UPH, UPT) pair, with and without the tails, in both
// precisions: omega_fb_step_<NAME>_<plain|tails>_<f32|f64>. `params` points at a host
// FbParams<T>; in and out are distinct stacked (4+L, K, ny, nx) arrays; `wind`
// is the (3, ny, nx) stress plane or null. Each returns the launch's error
// code. One source file per pair, so that the pairs compile side by side.
#define OMEGA_FB_ENTRY(NAME, UPH, UPT, TAILS, SUF, T)                        \
  int omega_fb_step_##NAME##SUF(const void* in, void* out, const void* wind, \
                                const void* params, int threads,             \
                                void* stream) {                              \
    return omega::launch_fb_step<T, UPH, UPT, TAILS>(                        \
        in, out, wind, static_cast<const omega::FbParams<T>*>(params),       \
        threads, static_cast<cudaStream_t>(stream));                         \
  }
#define OMEGA_FB_VARIANTS(NAME, UPH, UPT)                   \
  extern "C" {                                              \
  OMEGA_FB_ENTRY(NAME, UPH, UPT, false, _plain_f32, float)  \
  OMEGA_FB_ENTRY(NAME, UPH, UPT, false, _plain_f64, double) \
  OMEGA_FB_ENTRY(NAME, UPH, UPT, true, _tails_f32, float)   \
  OMEGA_FB_ENTRY(NAME, UPH, UPT, true, _tails_f64, double)  \
  }
