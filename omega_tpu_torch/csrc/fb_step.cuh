// The whole forward-backward time step as one kernel.
//
// Replaces the TPU kernel omega_tpu/ops/megastep.py:_kernel with the chain
// _fb_compute (stacked ssh; center or upwind thickness flux, _h_fluxes;
// center, upwind or flux-corrected tracer flux, _htr_flux / _fct_adv; the wind
// and bottom-drag tail _wind_drag). The vertical-mixing tail of that kernel is
// csrc/vmix.cu. It computes the chain expression for expression:
//
//   thickness:  h_new = h + dt * (-div(flux_h * u)), flux_h = cmean(h) or the
//               upwind pick of the edge's two cells
//   tracers:    adv + del2 + del4, thickness weighted (fluxes on the OLD h);
//               with FCT the advective term is Zalesak's limited flux on the
//               thickness equation's own mass flux flux_h * u
//   velocity:   KE, divergence, curl, kite h_v, edge PV on h_new; PV flux,
//               KE and ssh gradients (ssh = h_new, uniform depth), del2 and
//               del4 momentum diffusion, wind stress on the top layer and
//               quadratic drag on the bottom layer -> u_new
//
// Variants are compile-time (UPH; the tracer flux TRF: center, upwind, FCT;
// TAILS), so that the flagship instantiation <false, TR_CENTER, false> is the
// center-flux chain and nothing else. An upwind pick needs no slab array of
// its own: the pair tables c0 / c1 have ONE entry per edge class, so h0 and
// h1 are two shifted reads of the thickness slab. Wind and drag touch one
// layer each and a block is one layer, so both are branches uniform over the
// block (wind for blockIdx.z == 0, drag for blockIdx.z == K-1); which of the
// two a TAILS instantiation applies is a run-time matter (wind pointer,
// cd != 0). The levels the RK stage kernel shares are in slab_chain.cuh.
//
// FCT keeps on the slab what later levels read at neighbours: the low-order
// flux and the antidiffusive flux per edge class, the transported field, the
// in/out budgets (overwritten in place by the ratios r_in / r_out) and, with
// the upwind thickness flux, that flux; the high-order flux and the relu'd
// parts are recomputed where they are read. The limiter picks branches
// (sign of the antidiffusive flux, clip, the 1e-30 floor, min / max), so
// every product that the plain version rounds before an add is rounded
// here too (mul_rn): a fused multiply-add would move a pick's operands.
//
// Bound on this card: bytes in principle, 2 * (4+L) * K * ny * nx * sizeof(T)
// (state read once, written once); the chain's ~10 stencil levels add a few
// hundred operations per point, far under the card's float rate. What the
// design does about it: a block loads the (by+2ry) x (bx+2rx) slab of its
// 4+L channels into shared memory ONCE, with the periodic wrap as index
// arithmetic, then walks the chain level by level, every intermediate living
// in a shared array of slab size (21 arrays, reused between the tracer and
// velocity phases; 22 with FCT, 25 with FCT and the upwind thickness flux),
// and writes only the owned centre. No intermediate touches device memory.
//
// The instruction rate and shared-memory loads, not device memory, are what
// the stencil loops cost. So the host turns every table entry into a flat slab
// offset per row parity (class * S + dj * XX + di) and the entry layout is
// fixed at compile time: a shifted read is one select, one add and one shared
// load, with offset and weight as immediate operands from the parameter
// space, no per-entry decode and no index wrap.
//
// Validity: the host planner derives the ring that keeps the owned centre
// exact from the chain itself (ops/megastep.py:chain_radius; 3 rows and 3
// columns for the hex mesh's tables, fewer than the summed table radii
// because class shifts partly cancel). The tiled mode of the plain PyTorch
// version evaluates its slabs under the same rule, and the CPU tests hold it
// against the whole-grid form.
#pragma once

#include "slab_chain.cuh"

namespace omega {

// the tracer flux of a variant
enum TrFlux { TR_CENTER = 0, TR_UPWIND = 1, TR_FCT = 2 };

// slab arrays of a variant: FCT's arrays follow the upwind flux_h, which
// then stays live through the tracers
template <bool UPH, int TRF>
constexpr int fb_slots() {
  return TRF == TR_FCT ? (UPH ? 25 : 22) : 21;
}

// The Zalesak-limited advective tendency of the tracer in TR (the JAX
// kernel's _fct_adv), left as the corrected edge flux in FLO: the levels
// after the tracer's load, ending on a barrier. Also the del2 levels the
// other flux types run in tracer_levels: G, D2 and CD2 (in G's slots).
template <bool UPH, typename T>
__device__ __forceinline__ void fct_levels(const Slab& sl,
                                           const FbParams<T>& p, const T* H,
                                           const T* U, const T* MH,
                                           const T* FH, const T* HN,
                                           const T* TR, T* FLO, T* AA, T* G,
                                           T* TD, T* D2, T* PIN, T* POUT) {
  const int S = sl.S;
  const T* FLX = UPH ? FH : MH;          // flux_h: the mass flux is FLX * u
  // low-order (upwind; the mean at rest) and antidiffusive flux per edge;
  // geo * mean_h * cdiff(tr) for del2
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T t0 = TR[q + pair_ofs<T_C0>(p, t, odd)];
      const T t1 = TR[q + pair_ofs<T_C1>(p, t, odd)];
      const T u = U[t * S + q];
      const T mf = FLX[t * S + q] * u;
      const T mean = T(0.5) * (t0 + t1);
      const T lo = mul_rn(u > T(0) ? t0 : (u < T(0) ? t1 : mean), mf);
      FLO[t * S + q] = lo;
      AA[t * S + q] = mul_rn(mean, mf) - lo;
      const T ctr = AP(T_CDIFF, t, at(TR));
      G[t * S + q] = p.geo * MH[t * S + q] * ctr;
    }
  }
  __syncthreads();

  // transported field, its budgets from the relu'd antidiffusive fluxes
  // (p_in = dt (div_neg(a+) + div_pos(a-)), p_out the other pairing), D2
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    const T div_lo = AP(T_DIV, 0, at(FLO));
    TD[q] = (mul_rn(TR[q], H[q]) - mul_rn(p.dt, div_lo)) / HN[q];
    auto pos = [&](int r) { return AA[r] > T(0) ? AA[r] : T(0); };
    auto neg = [&](int r) { return -AA[r] > T(0) ? -AA[r] : T(0); };
    PIN[q] = p.dt * (AP(T_DIVN, 0, pos) + AP(T_DIVP, 0, neg));
    POUT[q] = p.dt * (AP(T_DIVP, 0, pos) + AP(T_DIVN, 0, neg));
    D2[q] = AP(T_SDIV, 0, at(G));
  }
  __syncthreads();

  // admissible bounds over the cell and its six neighbours, old and
  // transported fields; the ratios in place of the budgets; CD2 into G
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    T tmax = TR[q], tmin = TR[q], dmax = TD[q], dmin = TD[q];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int r = q + entry_ofs(p, tab_base(T_COC0) + j, odd);
      tmax = TR[r] > tmax ? TR[r] : tmax;
      tmin = TR[r] < tmin ? TR[r] : tmin;
      dmax = TD[r] > dmax ? TD[r] : dmax;
      dmin = TD[r] < dmin ? TD[r] : dmin;
    }
    tmax = dmax > tmax ? dmax : tmax;
    tmin = dmin < tmin ? dmin : tmin;
    const T q_in = (tmax - TD[q]) * HN[q];
    const T q_out = (TD[q] - tmin) * HN[q];
    const T p_in = PIN[q] > T(1e-30) ? PIN[q] : T(1e-30);
    const T p_out = POUT[q] > T(1e-30) ? POUT[q] : T(1e-30);
    const T r_in = q_in / p_in, r_out = q_out / p_out;
    PIN[q] = r_in < T(0) ? T(0) : (r_in > T(1) ? T(1) : r_in);
    POUT[q] = r_out < T(0) ? T(0) : (r_out > T(1) ? T(1) : r_out);
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      G[t * S + q] = p.geo4 * AP(T_CDIFF, t, at(D2));
  }
  __syncthreads();

  // the limited flux: a >= 0 moves mass from c0 to c1, so it takes c1's
  // r_in and c0's r_out, else the other pair
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const int o0 = pair_ofs<T_C0>(p, t, odd);
      const int o1 = pair_ofs<T_C1>(p, t, odd);
      const T a = AA[t * S + q];
      const T x = PIN[q + o1] < POUT[q + o0] ? PIN[q + o1] : POUT[q + o0];
      const T y = PIN[q + o0] < POUT[q + o1] ? PIN[q + o0] : POUT[q + o1];
      FLO[t * S + q] = FLO[t * S + q] + mul_rn(a >= T(0) ? x : y, a);
    }
  }
  __syncthreads();
}

// UPH: upwind thickness flux; TRF: tracer flux; TAILS: wind and drag
// compiled in. `wind` is the (3, ny, nx) edge-normal stress plane or null.
template <typename T, bool UPH, int TRF, bool TAILS>
__global__ void __launch_bounds__(512)
fb_step_kernel(const T* __restrict__ in, T* __restrict__ out,
               const T* __restrict__ wind,
               const __grid_constant__ FbParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;

  // shared memory: [guard | slab arrays | guard]. A shifted read that leaves
  // the slab lands in a neighbouring row, slot or guard: a wrong but
  // harmless value, which only ever reaches the ring.
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;

  // slab arrays; the velocity phase reuses the tracer phase's slots
  T* const H = sm;              // old thickness          (tracer phase)
  T* const U = sm + 1 * S;      // 3 edge classes
  T* const MH = sm + 4 * S;     // mean_h: cmean(h) or 0.5*(h0+h1), 3
  T* const HN = sm + 7 * S;     // new thickness
  T* const TR = sm + 8 * S;     // current tracer
  T* const HTR = sm + 9 * S;    // h*tr on edges (center or upwind), 3
  T* const FH = sm + 9 * S;     // upwind flux_h, 3 (dead before the tracers
                                // unless FCT reads it as its mass flux)
  T* const G = sm + 12 * S;     // geo*mean_h*cdiff(tr), 3
  T* const ADV = sm + 15 * S;
  T* const D2 = sm + 16 * S;
  T* const CD2 = sm + 17 * S;   // geo4*cdiff(d2tr), 3
  // FCT: low-order then corrected flux (3), antidiffusive flux (3), del2
  // G then CD2 (3), transported field, D2, budgets then ratios (2)
  constexpr int f0 = UPH ? 12 : 9;
  T* const FLO = sm + f0 * S;
  T* const AA = sm + (f0 + 3) * S;
  T* const FG = sm + (f0 + 6) * S;
  T* const TD = sm + (f0 + 9) * S;
  T* const FD2 = sm + (f0 + 10) * S;
  T* const PIN = sm + (f0 + 11) * S;
  T* const POUT = sm + (f0 + 12) * S;
  // velocity phase (momentum aux on h_new)
  const MomSlots<T> m{HN,
                      sm + 4 * S,    // FL: flux_h of h_new, 3
                      sm,            // KE
                      sm + 8 * S,    // DIVU
                      sm + 9 * S,    // RV: curl(u), 2
                      sm + 11 * S,   // NRV: rvort / h_v, 2
                      sm + 13 * S,   // NPV: f / h_v, 2
                      sm + 15 * S,   // Q: edge PV, 3
                      sm + 18 * S,   // D2E: del2 of u on edges, 3
                      sm + 11 * S,   // D2DIV (after NRV/NPV are dead)
                      sm + 12 * S};  // D2RV: curl(del2_e), 2

  // ---- h and u with the periodic wrap; mean_h (and the upwind flux_h)
  load_hu(sl, p, in, H, U);
  __syncthreads();
  thickness_level<UPH>(sl, p, H, U, MH, FH);
  __syncthreads();

  // ---- h_new = h + dt * (-div(flux_h * u))
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    const T dh = AP(T_DIV, 0, [&](int r) {
      return (UPH ? FH[r] : MH[r]) * U[r];
    });
    HN[q] = H[q] + p.dt * (-dh);
  }
  __syncthreads();

  // ---- tracers, one at a time through the same slab arrays
  for (int l = 0; l < p.L; ++l) {
    for (int q = threadIdx.x; q < S; q += blockDim.x)
      TR[q] = in[sl.chan(p, 4 + l) + sl.gofs(p, q)];
    __syncthreads();
    if constexpr (TRF == TR_FCT) {
      fct_levels<UPH>(sl, p, H, U, MH, FH, HN, TR, FLO, AA, FG, TD, FD2, PIN,
                      POUT);
    } else {
      tracer_levels<TRF == TR_UPWIND>(sl, p, H, U, MH, TR, HTR, G, ADV, D2,
                                      CD2);
    }

    // owned centre only: del4, then the thickness-weighted update
    for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
      int q;
      long long g;
      bool odd;
      if (!sl.owned(p, o, q, g, odd)) continue;
      T num;
      if constexpr (TRF == TR_FCT) {
        // rounded as the plain version rounds: the limited update's
        // rounding is what a bound sees
        const T adv = -AP(T_DIV, 0, at(FLO));
        const T hyp = AP(T_SDIV, 0, at(FG));
        const T dtr = adv + mul_rn(p.ed2s, FD2[q]) - mul_rn(p.ed4, hyp);
        num = mul_rn(TR[q], H[q]) + mul_rn(p.dt, dtr);
      } else {
        const T dtr = tracer_dtr(p, q, odd, ADV, D2, CD2);
        num = TR[q] * H[q] + p.dt * dtr;
      }
      out[sl.chan(p, 4 + l) + g] = num / HN[q];
    }
    __syncthreads();
  }

  // ---- velocity: momentum aux on h_new, then u_new at the owned centre
  momentum_levels<UPH>(sl, p, U, m);
  // wind on the top layer, drag on the bottom one: uniform over the block
  const bool top = TAILS && wind != nullptr && sl.k == 0;
  const bool bottom = TAILS && p.cd != T(0) && sl.k == p.K - 1;
  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    out[sl.chan(p, 0) + g] = HN[q];
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T du = momentum_du<UPH, TAILS>(sl, p, q, odd, t, g, U, m, wind,
                                           top, bottom);
      out[sl.chan(p, 1 + t) + g] = U[t * S + q] + p.dt * du;
    }
  }
}

template <typename T, bool UPH, int TRF, bool TAILS>
int launch_fb_step(const void* in, void* out, const void* wind,
                   const FbParams<T>* hp, int threads, cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads < 32 || threads > 512) return cudaErrorInvalidConfiguration;
  // a variant without the tails must not be handed wind or drag
  if (!TAILS && (wind != nullptr || p.cd != T(0))) return cudaErrorInvalidValue;
  if (!layout_ok(p)) return cudaErrorInvalidValue;
  const size_t smem = slab_smem_bytes(p, fb_slots<UPH, TRF>());
  cudaError_t err = cudaFuncSetAttribute(
      fb_step_kernel<T, UPH, TRF, TAILS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_step_kernel<T, UPH, TRF, TAILS><<<slab_grid(p), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const T*>(wind), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace omega

// The C interface of one (UPH, TRF) pair, with and without the tails, in both
// precisions: omega_fb_step_<NAME>_<plain|tails>_<f32|f64>. `params` points at
// a host FbParams<T>; in and out are distinct stacked (4+L, K, ny, nx)
// arrays; `wind` is the (3, ny, nx) stress plane or null. Each returns the
// launch's error code. One source file per pair, so that the pairs compile
// side by side.
#define OMEGA_FB_ENTRY(NAME, UPH, TRF, TAILS, SUF, T)                        \
  int omega_fb_step_##NAME##SUF(const void* in, void* out, const void* wind, \
                                const void* params, int threads,             \
                                void* stream) {                              \
    return omega::launch_fb_step<T, UPH, TRF, TAILS>(                        \
        in, out, wind, static_cast<const omega::FbParams<T>*>(params),       \
        threads, static_cast<cudaStream_t>(stream));                         \
  }
#define OMEGA_FB_VARIANTS(NAME, UPH, TRF)                   \
  extern "C" {                                              \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, false, _plain_f32, float)  \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, false, _plain_f64, double) \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, true, _tails_f32, float)   \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, true, _tails_f64, double)  \
  }
