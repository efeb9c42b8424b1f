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
// cd != 0).
//
// FCT keeps on the slab what later levels read at neighbours: the low-order
// flux and the antidiffusive flux per edge class, the transported field and
// the in/out budgets (overwritten in place by the ratios r_in / r_out); the
// mass flux (flux_h u, read at the edge itself: the upwind flux_h re-picked
// there), the high-order flux and the relu'd parts are recomputed where they
// are read. The limiter picks branches
// (sign of the antidiffusive flux, clip, the 1e-30 floor, min / max), so
// every product that the plain version rounds before an add is rounded
// here too (mul_rn): a fused multiply-add would move a pick's operands.
//
// Bound on this card: bytes, 2 * (4+L) * K * ny * nx * sizeof(T) (state read
// once, written once); the chain's ~10 stencil levels add a few hundred
// operations per point, far under the card's float rate. A block loads the
// slab of its 4+L channels into shared memory once, with the periodic wrap as
// index arithmetic, walks the chain level by level with every intermediate
// in a shared array of slab size, and writes only the owned centre: no
// intermediate touches device memory. What the time goes to is instructions
// around the shared loads, the loads themselves and the barriers between
// levels; the design, the RK stage's (rk_stage.cuh):
//   * the tile (16 x 32), the ring (3, 3: megastep.chain_radius of every FB
//     variant on the hex mesh), the block (256 threads) and the planar hex
//     mesh's entry pattern are compile-time constants (hex_slab.cuh): every
//     stencil read is one shared load at an immediate offset, its weight an
//     operand from the parameter space. The ring's 3 rows make the slab's
//     first row odd and its 22 rows five quads and a pair: the quads' and
//     the pair's parities are compile-time all the same;
//   * a thread evaluates a column of four rows (or, on the last two rows,
//     two) on the slab, and owns a row pair of the tile for the whole step,
//     so h_new, h and the tracer at the owned pair stay in registers, and
//     the next tracer's slab is loaded into registers a tracer ahead;
//   * flux_h(h_new) u is formed once on the slab for the PV walk (its 8
//     tangential entries read F and q, not flux_h, u and q);
//   * the momentum phase takes u at the owned pair into registers and puts
//     the edge PV in u's slots; du's del2 term stays in registers; so the
//     center and upwind tracer fluxes need 16 slab arrays (54.1 KB in
//     float32: 4 blocks per SM), FCT 22 (3 blocks).
// The launcher refuses any other tile, ring, entry pattern or block size
// (the host then runs the composed step: megastep.hex_pattern_fits).
//
// The split-explicit step's splitpost (split.cu) is this kernel with the
// switch SPLIT: center fluxes, no tails, the momentum phase compiled out.
// Its slab holds the transport velocity u_trans = (u - ubar) + <ubar>,
// formed as the slab loads, in U's slots, so the thickness and tracer
// levels run as they are; the owned pair then takes u_new = (u - ubar) +
// dt (du_full - du_bar) + ub_final in the reference's order. Its ring is
// splitpost's own chain radius (2, 2), so it has its own compiled geometry.
#pragma once

#include <type_traits>

#include "hex_slab.cuh"

namespace omega {

// the tracer flux of a variant
enum TrFlux { TR_CENTER = 0, TR_UPWIND = 1, TR_FCT = 2 };

// slab arrays of a variant
template <int TRF>
constexpr int fb_slots() {
  return TRF == TR_FCT ? 22 : 16;
}

// where splitpost's (ny, nx) planes lie in its `planes` argument: kUbar,
// kDubar, kUbf and kUavg, the first of three planes each. split.cu, the one
// user of the switch SPLIT, defines SplitPlanes<true> from its plane layout
template <bool SPLIT>
struct SplitPlanes;

namespace fb {

// the tile, its ring and the block the FB step is compiled for
using Geo = HexSlab<16, 32, 3, 3, 256>;
// splitpost's: the same tile and block, its chain's ring (2, 2)
using PostGeo = HexSlab<16, 32, 2, 2, 256>;
template <bool SPLIT>
using GeoOf = std::conditional_t<SPLIT, PostGeo, Geo>;
// blocks an SM must hold (the register budget): 16 float32 slabs take 54,128
// bytes a block, 4 blocks an SM; FCT's 22 take 74,192, 3; float64 2 and 1
template <typename T, int TRF>
constexpr int kMinBlocks = sizeof(T) == 4 ? (TRF == TR_FCT ? 3 : 4)
                                          : (TRF == TR_FCT ? 1 : 2);

}  // namespace fb

// UPH: upwind thickness flux; TRF: tracer flux; TAILS: wind and drag
// compiled in; SPLIT: splitpost. `wind` is the (3, ny, nx) edge-normal
// stress plane or null; splitpost reads du_full (3, K, ny, nx) and the
// split step's planes (null for the FB step).
template <typename T, bool UPH, int TRF, bool TAILS, bool SPLIT = false>
__global__ void __launch_bounds__(fb::GeoOf<SPLIT>::kThreads,
                                  fb::kMinBlocks<T, TRF>)
fb_step_kernel(const T* __restrict__ in, T* __restrict__ out,
               const T* __restrict__ wind, const T* __restrict__ du,
               const T* __restrict__ planes,
               const __grid_constant__ FbParams<T> p) {
  using Geo = fb::GeoOf<SPLIT>;
  static_assert(!SPLIT || (!UPH && TRF == TR_CENTER && !TAILS),
                "splitpost: center fluxes, no tails");
  constexpr int kS = Geo::kS, kXX = Geo::kXX, kThreads = Geo::kThreads;
  constexpr bool FCT = TRF == TR_FCT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [guard | slab arrays | guard]: a shifted read that leaves the slab lands
  // in a neighbouring row, slot or guard, a wrong but harmless value, which
  // only ever reaches the ring
  T* const sm = reinterpret_cast<T*>(smem_raw) + Geo::kGuard;
  // slab arrays ("slots", kS elements each; a class-strided array's class
  // is part of every entry offset). Throughout: H (old h), U (3), HN (h_new)
  T* const H = sm;
  T* const U = sm + 1 * kS;
  T* const HN = sm + 4 * kS;
  // thickness and tracer phases
  T* const MH = sm + 5 * kS;    // mean_h of h, 3
  T* const FH = sm + 8 * kS;    // upwind flux_h, 3, until h_new
  T* const TR = sm + 8 * kS;    // current tracer (center / upwind: then ADV)
  T* const ADV = sm + 8 * kS;
  T* const HTR = sm + 9 * kS;   // h*tr on edges, 3, then CD2
  T* const CD2 = sm + 9 * kS;   // geo4*cdiff(d2tr), 3
  T* const G = sm + 12 * kS;    // geo*mean_h*cdiff(tr), 3
  T* const D2 = sm + 15 * kS;
  // FCT: low-order then corrected flux (3), antidiffusive flux (3), del2 G
  // then CD2 (3), transported field, D2, budgets then ratios (2)
  T* const FLO = sm + 9 * kS;
  T* const AA = sm + 12 * kS;
  T* const FG = sm + 15 * kS;
  T* const TD = sm + 18 * kS;
  T* const FD2 = sm + 19 * kS;
  T* const PIN = sm + 20 * kS;
  T* const POUT = sm + 21 * kS;
  // momentum phase (aux on h_new)
  T* const Q = sm + 1 * kS;     // edge PV, 3, in u's slots
  T* const F = sm + 5 * kS;     // flux_h(h_new) * u, 3
  T* const KE = sm + 8 * kS;
  T* const DIVU = sm + 9 * kS;  // then D2DIV
  T* const RV = sm + 10 * kS;   // 2, then D2RV
  T* const NRV = sm + 12 * kS;  // 2, then D2E (3)
  T* const NPV = sm + 14 * kS;  // 2
  T* const D2E = sm + 12 * kS;
  T* const D2DIV = sm + 9 * kS;
  T* const D2RV = sm + 10 * kS;

  const int y0 = blockIdx.y * Geo::kBY, x0 = blockIdx.x * Geo::kBX;
  const int k = blockIdx.z;
  const int gy0 = y0 - Geo::kRY, gx0 = x0 - Geo::kRX;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const auto chan = [&](int ch) {
    return (static_cast<long long>(ch) * p.K + k) * plane;
  };
  const auto gofs = [&](int q) {
    const int sy = q / kXX, sx = q - sy * kXX;
    return static_cast<long long>(wrap_any(gy0 + sy, p.ny)) * p.nx +
           wrap_any(gx0 + sx, p.nx);
  };
  const auto at = [](const T* a) { return [a](int r) { return a[r]; }; };

  // the thread's owned pair: column ox, rows oy (even) and oy + 1 of the tile
  const int oy = 2 * (threadIdx.x / Geo::kBX), ox = threadIdx.x % Geo::kBX;
  const bool own = y0 + oy < p.ny && x0 + ox < p.nx;
  const int qo = (oy + Geo::kRY) * kXX + ox + Geo::kRX;
  const long long go = static_cast<long long>(y0 + oy) * p.nx + x0 + ox;
  // f(ic<0>, q, g) and f(ic<1>, ...) at the owned pair's slab points and
  // plane offsets
  const auto owned = [&](auto&& f) {
    if (!own) return;
    f(ic<0>{}, qo, go);
    f(ic<1>{}, qo + kXX, go + p.nx);
  };

  // the slab of a tracer channel, a thread's points in registers: loaded a
  // tracer ahead, stored when its slot is free
  constexpr int kPer = (kS + kThreads - 1) / kThreads;
  T trs[kPer];
  const auto load_tr = [&](int l) {
    _Pragma("unroll") for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q < kS) trs[i] = in[chan(4 + l) + gofs(q)];
    }
  };

  for (int q = threadIdx.x; q < kS; q += kThreads) {
    const long long g = gofs(q);
    H[q] = in[chan(0) + g];
    if constexpr (SPLIT) {
      // the transport velocity u' + <ubar>, u' = u - ubar
      using SP = SplitPlanes<SPLIT>;
      _Pragma("unroll") for (int t = 0; t < 3; ++t) {
        const T uprime = in[chan(1 + t) + g] -
                         planes[(SP::kUbar + t) * plane + g];
        U[t * kS + q] = uprime + planes[(SP::kUavg + t) * plane + g];
      }
    } else {
      U[q] = in[chan(1) + g];
      U[kS + q] = in[chan(2) + g];
      U[2 * kS + q] = in[chan(3) + g];
    }
  }
  if (p.L > 0) load_tr(0);
  __syncthreads();

  // ---- mean_h of h (and the upwind flux_h) on the slab
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      if constexpr (UPH) {
        const T h0 = H[q + Geo::template kPair<T_C0, t, PAR>];
        const T h1 = H[q + Geo::template kPair<T_C1, t, PAR>];
        MH[t * kS + q] = T(0.5) * (h0 + h1);
        FH[t * kS + q] = upwind_sel(U[t * kS + q], h0, h1);
      } else {
        MH[t * kS + q] = Geo::template ap<T_CMEAN, t, PAR>(p, q, at(H));
      }
    });
  });
  __syncthreads();

  // ---- h_new = h + dt * (-div(flux_h * u)) on the slab
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    const T dh = Geo::template ap<T_DIV, 0, PAR>(p, q, [&](int r) {
      return (UPH ? FH[r] : MH[r]) * U[r];
    });
    HN[q] = H[q] + p.dt * (-dh);
  });
  __syncthreads();
  // h_new and h at the owned pair, in registers from here on
  T hn[2] = {T(1), T(1)}, ho[2] = {T(0), T(0)};
  owned([&](auto par, int q, long long g) {
    constexpr int PAR = decltype(par)::value;
    hn[PAR] = HN[q];
    ho[PAR] = H[q];
    out[chan(0) + g] = hn[PAR];
  });

  // ---- tracers, one at a time through the same slab arrays
  for (int l = 0; l < p.L; ++l) {
    _Pragma("unroll") for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q < kS) TR[q] = trs[i];
    }
    if (l + 1 < p.L) load_tr(l + 1);
    __syncthreads();
    T to[2] = {T(0), T(0)};     // the tracer at the owned pair
    owned([&](auto par, int q, long long) {
      to[decltype(par)::value] = TR[q];
    });
    if constexpr (FCT) {
      // Zalesak's limited advective flux (the JAX kernel's _fct_adv) and
      // the del2 levels. Low-order (upwind; the mean at rest) and
      // antidiffusive flux per edge on the mass flux flux_h * u;
      // G = geo * mean_h * cdiff(tr)
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          constexpr int o0 = Geo::template kPair<T_C0, t, PAR>;
          constexpr int o1 = Geo::template kPair<T_C1, t, PAR>;
          const T t0 = TR[q + o0], t1 = TR[q + o1];
          const T u = U[t * kS + q];
          T fh;
          if constexpr (UPH) {
            fh = upwind_sel(u, H[q + o0], H[q + o1]);
          } else {
            fh = MH[t * kS + q];
          }
          const T mf = fh * u;
          const T mean = T(0.5) * (t0 + t1);
          const T lo = mul_rn(u > T(0) ? t0 : (u < T(0) ? t1 : mean), mf);
          FLO[t * kS + q] = lo;
          AA[t * kS + q] = mul_rn(mean, mf) - lo;
          const T ctr = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(TR));
          FG[t * kS + q] = p.geo * MH[t * kS + q] * ctr;
        });
      });
      __syncthreads();
      // transported field, its budgets from the relu'd antidiffusive fluxes
      // (p_in = dt (div_neg(a+) + div_pos(a-)), p_out the other pairing), D2
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        const T div_lo = Geo::template ap<T_DIV, 0, PAR>(p, q, at(FLO));
        TD[q] = (mul_rn(TR[q], H[q]) - mul_rn(p.dt, div_lo)) / HN[q];
        const auto pos = [&](int r) { return AA[r] > T(0) ? AA[r] : T(0); };
        const auto neg = [&](int r) { return -AA[r] > T(0) ? -AA[r] : T(0); };
        PIN[q] = p.dt * (Geo::template ap<T_DIVN, 0, PAR>(p, q, pos) +
                         Geo::template ap<T_DIVP, 0, PAR>(p, q, neg));
        POUT[q] = p.dt * (Geo::template ap<T_DIVP, 0, PAR>(p, q, pos) +
                          Geo::template ap<T_DIVN, 0, PAR>(p, q, neg));
        FD2[q] = Geo::template ap<T_SDIV, 0, PAR>(p, q, at(FG));
      });
      __syncthreads();
      // admissible bounds over the cell and its six neighbours, old and
      // transported fields; the ratios in place of the budgets; CD2 into G
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        T tmax = TR[q], tmin = TR[q], dmax = TD[q], dmin = TD[q];
        static_for<6>([&](auto jc) {
          constexpr int o =
              Geo::off(tab_base(T_COC0) + decltype(jc)::value, PAR);
          const int r = q + o;
          tmax = TR[r] > tmax ? TR[r] : tmax;
          tmin = TR[r] < tmin ? TR[r] : tmin;
          dmax = TD[r] > dmax ? TD[r] : dmax;
          dmin = TD[r] < dmin ? TD[r] : dmin;
        });
        tmax = dmax > tmax ? dmax : tmax;
        tmin = dmin < tmin ? dmin : tmin;
        const T q_in = (tmax - TD[q]) * HN[q];
        const T q_out = (TD[q] - tmin) * HN[q];
        const T p_in = PIN[q] > T(1e-30) ? PIN[q] : T(1e-30);
        const T p_out = POUT[q] > T(1e-30) ? POUT[q] : T(1e-30);
        const T r_in = q_in / p_in, r_out = q_out / p_out;
        PIN[q] = r_in < T(0) ? T(0) : (r_in > T(1) ? T(1) : r_in);
        POUT[q] = r_out < T(0) ? T(0) : (r_out > T(1) ? T(1) : r_out);
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          FG[t * kS + q] =
              p.geo4 * Geo::template ap<T_CDIFF, t, PAR>(p, q, at(FD2));
        });
      });
      __syncthreads();
      // the limited flux: a >= 0 moves mass from c0 to c1, so it takes c1's
      // r_in and c0's r_out, else the other pair
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          constexpr int o0 = Geo::template kPair<T_C0, t, PAR>;
          constexpr int o1 = Geo::template kPair<T_C1, t, PAR>;
          const T a = AA[t * kS + q];
          const T x = PIN[q + o1] < POUT[q + o0] ? PIN[q + o1] : POUT[q + o0];
          const T y = PIN[q + o0] < POUT[q + o1] ? PIN[q + o0] : POUT[q + o1];
          FLO[t * kS + q] = FLO[t * kS + q] + mul_rn(a >= T(0) ? x : y, a);
        });
      });
      __syncthreads();
      // owned pair: del4, then the thickness-weighted update, rounded as
      // the plain version rounds (the limited update's rounding is what a
      // bound sees)
      owned([&](auto par, int q, long long g) {
        constexpr int PAR = decltype(par)::value;
        const T adv = -Geo::template ap<T_DIV, 0, PAR>(p, q, at(FLO));
        const T hyp = Geo::template ap<T_SDIV, 0, PAR>(p, q, at(FG));
        const T dtr = adv + mul_rn(p.ed2s, FD2[q]) - mul_rn(p.ed4, hyp);
        const T num = mul_rn(to[PAR], ho[PAR]) + mul_rn(p.dt, dtr);
        out[chan(4 + l) + g] = num / hn[PAR];
      });
    } else {
      // HTR = h*tr on edges (center or upwind), G = geo*mean_h*cdiff(tr)
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          if constexpr (TRF == TR_UPWIND) {
            constexpr int o0 = Geo::template kPair<T_C0, t, PAR>;
            constexpr int o1 = Geo::template kPair<T_C1, t, PAR>;
            HTR[t * kS + q] = upwind_sel(U[t * kS + q], H[q + o0] * TR[q + o0],
                                         H[q + o1] * TR[q + o1]);
          } else {
            HTR[t * kS + q] = Geo::template ap<T_CMEAN, t, PAR>(
                p, q, [&](int r) { return H[r] * TR[r]; });
          }
          const T ctr = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(TR));
          G[t * kS + q] = p.geo * MH[t * kS + q] * ctr;
        });
      });
      __syncthreads();
      // ADV = -div(HTR*u) (into TR's slot), D2 = signed_div(G)
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        const T adv = -Geo::template ap<T_DIV, 0, PAR>(p, q, [&](int r) {
          return HTR[r] * U[r];
        });
        const T d2 = Geo::template ap<T_SDIV, 0, PAR>(p, q, at(G));
        ADV[q] = adv;
        D2[q] = d2;
      });
      __syncthreads();
      // CD2 = geo4*cdiff(D2) (into HTR's slots)
      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          CD2[t * kS + q] =
              p.geo4 * Geo::template ap<T_CDIFF, t, PAR>(p, q, at(D2));
        });
      });
      __syncthreads();
      // owned pair: del4, then the thickness-weighted update
      owned([&](auto par, int q, long long g) {
        constexpr int PAR = decltype(par)::value;
        const T hyp = Geo::template ap<T_SDIV, 0, PAR>(p, q, at(CD2));
        const T dtr = ADV[q] + p.ed2s * D2[q] - p.ed4 * hyp;
        out[chan(4 + l) + g] = (to[PAR] * ho[PAR] + p.dt * dtr) / hn[PAR];
      });
    }
    __syncthreads();
  }

  if constexpr (SPLIT) {
    // ---- splitpost: u_new = u' + dt (du_full - du_bar) + ub_final
    using SP = SplitPlanes<SPLIT>;
    owned([&](auto, int, long long g) {
      _Pragma("unroll") for (int t = 0; t < 3; ++t) {
        const long long c = chan(1 + t) + g;
        const T uprime = in[c] - planes[(SP::kUbar + t) * plane + g];
        const T du_slow =
            du[chan(t) + g] - planes[(SP::kDubar + t) * plane + g];
        out[c] = (uprime + mul_rn(p.dt, du_slow)) +
                 planes[(SP::kUbf + t) * plane + g];
      }
    });
    return;
  }

  // ---- momentum aux on h_new: F, ke, div, curl, the normalized
  // vorticities (the tracer phase's slots are free now); u at the owned
  // pair into registers
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    KE[q] = Geo::template ap<T_KE, 0, PAR>(
        p, q, [&](int r) { return U[r] * U[r]; });
    DIVU[q] = Geo::template ap<T_DIV, 0, PAR>(p, q, at(U));
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      T fl;
      if constexpr (UPH) {
        fl = upwind_sel(U[t * kS + q],
                        HN[q + Geo::template kPair<T_C0, t, PAR>],
                        HN[q + Geo::template kPair<T_C1, t, PAR>]);
      } else {
        fl = Geo::template ap<T_CMEAN, t, PAR>(p, q, at(HN));
      }
      F[t * kS + q] = fl * U[t * kS + q];
    });
    static_for<2>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T rv = Geo::template ap<T_CURL, t, PAR>(p, q, at(U));
      const T hv = Geo::template ap<T_KITE, t, PAR>(p, q, at(HN));
      RV[t * kS + q] = rv;
      NRV[t * kS + q] = rv / hv;
      NPV[t * kS + q] = p.f0v / hv;
    });
  });
  T uo[3][2];
  owned([&](auto par, int q, long long) {
    constexpr int PAR = decltype(par)::value;
    _Pragma("unroll") for (int t = 0; t < 3; ++t) uo[t][PAR] = U[t * kS + q];
  });
  __syncthreads();
  // edge PV (into u's slots); and du's del2 term at the owned pair, in
  // registers (the du diffusion terms use plain 1/dv, del2_e the floored)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T nrv_e = Geo::template ap<T_VMEAN, t, PAR>(p, q, at(NRV));
      const T npv_e = Geo::template ap<T_VMEAN, t, PAR>(p, q, at(NPV));
      Q[t * kS + q] = nrv_e + npv_e;
    });
  });
  T del2[3][2];
  owned([&](auto par, int q, long long) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::template ap<T_VDIFF, t, PAR>(p, q, at(RV));
      del2[t][PAR] = cdd * p.inv_dc - vdr * p.inv_dv;
    });
  });
  __syncthreads();
  // del2 of u on edges (into the normalized vorticities' slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::template ap<T_VDIFF, t, PAR>(p, q, at(RV));
      D2E[t * kS + q] = cdd * p.inv_dc - vdr * p.inv_dv_floor;
    });
  });
  __syncthreads();
  // div and curl of del2 on edges (into div u's and curl u's slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    const T dd = Geo::template ap<T_DIV, 0, PAR>(p, q, at(D2E));
    const T r0 = Geo::template ap<T_CURL, 0, PAR>(p, q, at(D2E));
    const T r1 = Geo::template ap<T_CURL, 1, PAR>(p, q, at(D2E));
    D2DIV[q] = dd;
    D2RV[q] = r0;
    D2RV[kS + q] = r1;
  });
  __syncthreads();

  // ---- du at the owned pair (PV flux on F, gradients, del2 and del4), then u
  const bool top = TAILS && wind != nullptr && k == 0;
  const bool bottom = TAILS && p.cd != T(0) && k == p.K - 1;
  owned([&](auto par, int q, long long g) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      // tang(F) and tang(F*q) share the walk
      T tf = T(0), tfq = T(0);
      static_for<tab_count(T_TANG)>([&](auto ic_) {
        constexpr int e =
            tab_base(T_TANG) + t * tab_count(T_TANG) + decltype(ic_)::value;
        constexpr int o = Geo::off(e, PAR);
        const T f = F[q + o];
        tf += p.w[e] * f;
        tfq += p.w[e] * (f * Q[q + o]);
      });
      const T qe = Q[t * kS + q];
      const T pv = T(0.5) * (qe * tf + tfq);
      const T gke = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(KE));
      const T gssh = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(HN));
      const T cd4 = Geo::template ap<T_CDIFF, t, PAR>(p, q, at(D2DIV));
      const T vd4 = Geo::template ap<T_VDIFF, t, PAR>(p, q, at(D2RV));
      T du = pv - gke * p.inv_dc - p.grav * gssh * p.inv_dc +
             p.nu2s * del2[t][PAR] -
             p.nu4s * (p.div_factor * cd4 * p.inv_dc - vd4 * p.inv_dv);
      if constexpr (TAILS) {
        if (top || bottom) {
          T mh;   // mean_h of h_new
          if constexpr (UPH) {
            mh = T(0.5) * (HN[q + Geo::template kPair<T_C0, t, PAR>] +
                           HN[q + Geo::template kPair<T_C1, t, PAR>]);
          } else {
            mh = Geo::template ap<T_CMEAN, t, PAR>(p, q, at(HN));
          }
          if (top) du = du + wind[t * plane + g] / (p.rho0 * mh);
          if (bottom) {
            // 2*cmean(ke) == ke0 + ke1 bit for bit (halving and doubling
            // are exact), the composed step's sqrt(ke0 + ke1)
            const T kee = Geo::template ap<T_CMEAN, t, PAR>(p, q, at(KE));
            const T twice = T(2) * kee;
            const T speed = sqrt(twice > T(0) ? twice : T(0));
            du = du + (-(p.cd * speed * uo[t][PAR] / mh));
          }
        }
      }
      out[chan(1 + t) + g] = uo[t][PAR] + p.dt * du;
    });
  });
}

template <typename T, bool UPH, int TRF, bool TAILS>
int launch_fb_step(const void* in, void* out, const void* wind,
                   const FbParams<T>* hp, int threads, cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads != fb::Geo::kThreads) return cudaErrorInvalidConfiguration;
  // a variant without the tails must not be handed wind or drag
  if (!TAILS && (wind != nullptr || p.cd != T(0))) return cudaErrorInvalidValue;
  if (!layout_ok(p) || !fb::Geo::geometry_ok(p)) return cudaErrorInvalidValue;
  // out of place: neighbours read the input through the ring
  if (in == nullptr || out == nullptr || in == out)
    return cudaErrorInvalidValue;
  const size_t smem = slab_smem_bytes(p, fb_slots<TRF>());
  cudaError_t err = cudaFuncSetAttribute(
      fb_step_kernel<T, UPH, TRF, TAILS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fb_step_kernel<T, UPH, TRF, TAILS><<<slab_grid(p), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const T*>(wind), nullptr, nullptr, p);
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of the FB step kernel (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) and, for its dynamic shared memory, the
// blocks an SM holds (out[3], cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T, bool UPH, int TRF, bool TAILS>
int fb_step_attrs(int* out) {
  using Geo = fb::Geo;
  if (out == nullptr) return cudaErrorInvalidValue;
  auto* const k = &fb_step_kernel<T, UPH, TRF, TAILS>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (fb_slots<TRF>() * static_cast<size_t>(Geo::kS) + 2 * Geo::kGuard) *
      sizeof(T);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      Geo::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace omega

// The C interface of one (UPH, TRF) pair, with and without the tails, in both
// precisions: omega_fb_step_<NAME>_<plain|tails>_<f32|f64>. `params` points at
// a host FbParams<T> packed for the tile, ring and entry pattern of omega::fb
// (the launch is refused otherwise); in and out are distinct stacked
// (4+L, K, ny, nx) arrays; `wind` is the (3, ny, nx) stress plane or null;
// `threads` must be fb::Geo::kThreads. Each returns the launch's error code.
// omega_fb_step_attrs_<NAME>_<plain|tails>_<f32|f64>(out): registers, local
// (spill) bytes, static shared bytes and blocks per SM. One source file per
// pair, so that the pairs compile side by side.
#define OMEGA_FB_ENTRY(NAME, UPH, TRF, TAILS, SUF, T)                        \
  int omega_fb_step_##NAME##SUF(const void* in, void* out, const void* wind, \
                                const void* params, int threads,             \
                                void* stream) {                              \
    return omega::launch_fb_step<T, UPH, TRF, TAILS>(                        \
        in, out, wind, static_cast<const omega::FbParams<T>*>(params),       \
        threads, static_cast<cudaStream_t>(stream));                         \
  }                                                                          \
  int omega_fb_step_attrs_##NAME##SUF(int* out) {                            \
    return omega::fb_step_attrs<T, UPH, TRF, TAILS>(out);                    \
  }
#define OMEGA_FB_VARIANTS(NAME, UPH, TRF)                   \
  extern "C" {                                              \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, false, _plain_f32, float)  \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, false, _plain_f64, double) \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, true, _tails_f32, float)   \
  OMEGA_FB_ENTRY(NAME, UPH, TRF, true, _tails_f64, double)  \
  }
