// One stage of a Runge-Kutta step as one kernel: the tendency chain on one
// level, and what the stage makes of it at the owned centre.
//
// Replaces the TPU kernel omega_tpu/ops/megastep.py:_kernel with the chain
// _tend_compute in the stage kinds rk4s1 (_rk4_s1), rk4s2 / rk4s3 (_rk4_mid),
// rk4s4 (_rk4_s4) and rk2 (_rk2_compute). The chain is compute_all_tendencies:
// every aux variable at the SAME level (h, u, tr) of the stacked array `ev`:
//
//   dh  = -div(flux_h * u)                       (center or upwind flux_h)
//   dtr = adv + del2 + del4 of h*tr              (center or upwind flux)
//   du  = PV flux, KE and ssh gradients, del2 and del4 momentum diffusion on
//         (h, u), wind on the top layer and drag on the bottom one with
//         mean_h of that level
//
// with the FB step's arithmetic (slab_chain.cuh) and the same compile-time
// variants <UPH, UPT, TAILS>. The epilogue at the owned centre is a run-time
// branch uniform over the launch (`mode`, enum RkMode), with ca = a*dt and
// cb = b*dt folded in float64 on the host and rounded to T once, as the JAX
// code does with python floats:
//
//   RK_PROV   out = base + ca k                       (RK2: both launches)
//   RK_FIRST  acc = (h, u, tr*h)(base) + cb k ; out = base + ca k   (RK4 s1)
//   RK_MID    acc = acc + cb k ; out = base + ca k               (s2, s3)
//   RK_LAST   out = acc + cb k, tracers (acc_tr + cb dtr) / out_h   (s4)
//
// where the accumulator holds thickness-weighted tracers tr*h, and out's
// tracers are (tr*h of base + ca dtr) / out_h (TimeStepper.h:205-237). Each
// stage writes `out` out of place: a neighbour's value of the evaluated level
// is read through the ring. The accumulator is read and written at the same
// point only, so acc_out may be acc. RK2 runs as two launches, not as one
// with a doubled ring: two chains back to back would need a ring about twice
// as deep and shared memory for the midpoint state, on a card whose block has
// 227 KB, not the TPU's 128 MB.
//
// Design for this card. A block is one layer x one kBY x kBX tile with the
// chain's (kRY, kRX) ring, as in the FB step, and the slab geometry and the
// planar hex mesh's entry pattern (source class, dj, and di per row parity
// of every table entry, hex_ent) are compile-time constants (hex_slab.cuh,
// which the FB step shares): every
// shared-memory read of a stencil is one load at an immediate offset from
// the point's own index, with no parity select and no address arithmetic,
// and its weight is an operand from the kernel's parameter space. On the
// slab a thread evaluates a column of four rows (even, odd, even, odd; at
// the owned centre two): the slab's first row is even (kBY and kRY are even,
// ny is even), so every parity is compile-time and a warp never diverges on
// it, and the points share the loads their stencils have in common. The
// thread that owns a pair of the tile keeps it for the whole stage
// (kRkThreads == the tile's row pairs x columns), so
// out's h stays in registers across the tracers, and the epilogue's base
// and accumulator values (and the next tracer's slab) are loaded a level
// before they are used. The flux F = flux_h * u is formed once on the slab
// and serves dh and the PV walk (its 8 tangential entries read F and q, not
// flux_h, u and q). The edge PV level is split in two (q, then del2 of u)
// and du's del2 term is kept in registers, so that 18 slab arrays suffice:
// 4 blocks per SM in float32. The launcher refuses any other tile, ring,
// entry pattern or block size (the host then runs the composed step:
// megastep.hex_pattern_fits).
//
// Bound: bytes, per launch the evaluated level (4+L channels), the base and
// accumulator read at the owned centre, and the outputs written; the chain's
// stencil arithmetic runs out of shared memory, whose loads (about 344 per
// owned point and stage as written, 1.48 slab points per owned point) and
// the barriers between the chain's levels are what the time goes to.
#pragma once

#include "hex_slab.cuh"

namespace omega {

enum RkMode { RK_PROV = 0, RK_FIRST = 1, RK_MID = 2, RK_LAST = 3 };

constexpr int kRkSlots = 18;

namespace rk {

// the tile, its ring and the block the RK stage is compiled for
using Geo = HexSlab<16, 32, 2, 3, 256>;
constexpr int kBY = Geo::kBY, kBX = Geo::kBX, kRY = Geo::kRY, kRX = Geo::kRX;
constexpr int kXX = Geo::kXX, kS = Geo::kS, kGuard = Geo::kGuard;
constexpr int kRkThreads = Geo::kThreads;
// blocks an SM must hold (the register budget): 18 float32 slabs take
// 55,344 bytes a block, 4 blocks an SM; float64 ones 2
template <typename T>
constexpr int kRkMinBlocks = sizeof(T) == 4 ? 4 : 2;
static_assert(kRY % 2 == 0, "the slab's first row is even");
static_assert(Geo::kYY % 4 == 0, "the slab is whole row quads");

}  // namespace rk

template <typename T, bool UPH, bool UPT, bool TAILS>
__global__ void __launch_bounds__(rk::kRkThreads, rk::kRkMinBlocks<T>)
rk_stage_kernel(const T* __restrict__ ev, const T* __restrict__ base,
                const T* acc, T* acc_out, T* __restrict__ out,
                const T* __restrict__ wind,
                const __grid_constant__ FbParams<T> p, T ca, T cb, int mode) {
  using namespace rk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw) + kGuard;
  // slab arrays ("slots", kS elements each; a class-strided array's class
  // is part of every entry offset). Throughout: H, U (3), F = flux_h u (3)
  T* const H = sm;
  T* const U = sm + 1 * kS;
  T* const F = sm + 4 * kS;
  // tracer phase
  T* const MH = sm + 7 * kS;    // mean_h, 3
  T* const TR = sm + 10 * kS;   // current tracer, then ADV
  T* const ADV = sm + 10 * kS;
  T* const HTR = sm + 11 * kS;  // h*tr on edges, 3, then CD2
  T* const CD2 = sm + 11 * kS;  // geo4*cdiff(d2tr), 3
  T* const G = sm + 14 * kS;    // geo*mean_h*cdiff(tr), 3
  T* const D2 = sm + 17 * kS;
  // momentum phase
  T* const KE = sm + 7 * kS;
  T* const DIVU = sm + 8 * kS;  // then D2DIV
  T* const RV = sm + 9 * kS;    // 2, then D2RV
  T* const NRV = sm + 11 * kS;  // 2, then D2E (3)
  T* const NPV = sm + 13 * kS;  // 2
  T* const Q = sm + 15 * kS;    // 3
  T* const D2E = sm + 11 * kS;
  T* const D2DIV = sm + 8 * kS;
  T* const D2RV = sm + 9 * kS;

  const int y0 = blockIdx.y * kBY, x0 = blockIdx.x * kBX, k = blockIdx.z;
  const int gy0 = y0 - kRY, gx0 = x0 - kRX;
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
  const int oy = 2 * (threadIdx.x / kBX), ox = threadIdx.x % kBX;
  const bool own = y0 + oy < p.ny && x0 + ox < p.nx;
  const int qo = (oy + kRY) * kXX + ox + kRX;
  const long long go = static_cast<long long>(y0 + oy) * p.nx + x0 + ox;
  // f(ic<0>, q, g) and f(ic<1>, ...) at the owned pair's slab points and
  // plane offsets
  const auto owned = [&](auto&& f) {
    if (!own) return;
    f(ic<0>{}, qo, go);
    f(ic<1>{}, qo + kXX, go + p.nx);
  };

  // the epilogue's inputs of channel ch at the owned pair, fetched a level
  // or more before they are used: base (not read by RK_LAST) and acc
  // (RK_MID, RK_LAST)
  const auto fetch = [&](int ch, T(&b)[2], T(&a)[2]) {
    owned([&](auto par, int, long long g) {
      constexpr int PAR = decltype(par)::value;
      const long long c = chan(ch) + g;
      b[PAR] = mode != RK_LAST ? base[c] : T(0);
      a[PAR] = mode == RK_MID || mode == RK_LAST ? acc[c] : T(0);
    });
  };
  // the slab of a tracer channel, a thread's points in registers: loaded a
  // tracer ahead, stored when its slot is free
  constexpr int kPer = (kS + kRkThreads - 1) / kRkThreads;
  T trs[kPer];
  const auto load_tr = [&](int l) {
    _Pragma("unroll") for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kRkThreads;
      if (q < kS) trs[i] = ev[chan(4 + l) + gofs(q)];
    }
  };

  for (int q = threadIdx.x; q < kS; q += kRkThreads) {
    const long long g = gofs(q);
    H[q] = ev[chan(0) + g];
    U[q] = ev[chan(1) + g];
    U[kS + q] = ev[chan(2) + g];
    U[2 * kS + q] = ev[chan(3) + g];
  }
  T hb[2], ha[2];
  fetch(0, hb, ha);
  if (p.L > 0) load_tr(0);
  __syncthreads();

  // ---- mean_h and the thickness flux F = flux_h * u on the slab
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T u = U[t * kS + q];
      T mh, fh;
      if constexpr (UPH) {
        const T h0 = H[q + Geo::kPair<T_C0, t, PAR>];
        const T h1 = H[q + Geo::kPair<T_C1, t, PAR>];
        mh = T(0.5) * (h0 + h1);
        fh = upwind_sel(u, h0, h1);
      } else {
        mh = Geo::ap<T_CMEAN, t, PAR>(p, q, at(H));
        fh = mh;
      }
      MH[t * kS + q] = mh;
      F[t * kS + q] = fh * u;
    });
  });
  __syncthreads();

  // ---- dh = -div(F) at the owned pair: out's and acc's h (ho in registers)
  T ho[2] = {T(0), T(0)};
  owned([&](auto par, int q, long long g) {
    constexpr int PAR = decltype(par)::value;
    const T dh = -Geo::ap<T_DIV, 0, PAR>(p, q, at(F));
    const long long c = chan(0) + g;
    T h;
    if (mode == RK_LAST) {
      h = ha[PAR] + cb * dh;
    } else {
      h = hb[PAR] + ca * dh;
      if (mode != RK_PROV)
        acc_out[c] = (mode == RK_FIRST ? hb[PAR] : ha[PAR]) + cb * dh;
    }
    ho[PAR] = h;
    out[c] = h;
  });

  // ---- tracers, one at a time through the same slab arrays
  for (int l = 0; l < p.L; ++l) {
    _Pragma("unroll") for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kRkThreads;
      if (q < kS) TR[q] = trs[i];
    }
    T tb[2], ta[2];
    fetch(4 + l, tb, ta);
    if (l + 1 < p.L) load_tr(l + 1);
    __syncthreads();
    // HTR = h*tr on edges (center or upwind), G = geo*mean_h*cdiff(tr)
    Geo::rows([&](auto par, int q) {
      constexpr int PAR = decltype(par)::value;
      static_for<3>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        if constexpr (UPT) {
          constexpr int o0 = Geo::kPair<T_C0, t, PAR>;
          constexpr int o1 = Geo::kPair<T_C1, t, PAR>;
          HTR[t * kS + q] = upwind_sel(U[t * kS + q], H[q + o0] * TR[q + o0],
                                       H[q + o1] * TR[q + o1]);
        } else {
          HTR[t * kS + q] = Geo::ap<T_CMEAN, t, PAR>(
              p, q, [&](int r) { return H[r] * TR[r]; });
        }
        const T ctr = Geo::ap<T_CDIFF, t, PAR>(p, q, at(TR));
        G[t * kS + q] = p.geo * MH[t * kS + q] * ctr;
      });
    });
    __syncthreads();
    // ADV = -div(HTR*u) (into TR's slot), D2 = signed_div(G)
    Geo::rows([&](auto par, int q) {
      constexpr int PAR = decltype(par)::value;
      const T adv = -Geo::ap<T_DIV, 0, PAR>(p, q, [&](int r) {
        return HTR[r] * U[r];
      });
      const T d2 = Geo::ap<T_SDIV, 0, PAR>(p, q, at(G));
      ADV[q] = adv;
      D2[q] = d2;
    });
    __syncthreads();
    // CD2 = geo4*cdiff(D2) (into HTR's slots)
    Geo::rows([&](auto par, int q) {
      constexpr int PAR = decltype(par)::value;
      static_for<3>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        CD2[t * kS + q] = p.geo4 * Geo::ap<T_CDIFF, t, PAR>(p, q, at(D2));
      });
    });
    __syncthreads();
    owned([&](auto par, int q, long long g) {
      constexpr int PAR = decltype(par)::value;
      const T hyp = Geo::ap<T_SDIV, 0, PAR>(p, q, at(CD2));
      const T dtr = ADV[q] + p.ed2s * D2[q] - p.ed4 * hyp;
      const long long c = chan(4 + l) + g;
      if (mode == RK_LAST) {
        out[c] = (ta[PAR] + cb * dtr) / ho[PAR];
      } else {
        const T trh = tb[PAR] * hb[PAR];
        if (mode != RK_PROV)
          acc_out[c] = (mode == RK_FIRST ? trh : ta[PAR]) + cb * dtr;
        out[c] = (trh + ca * dtr) / ho[PAR];
      }
    });
    __syncthreads();
  }

  // ---- momentum aux on the level: ke, div, curl, the normalized
  // vorticities (MH's and the tracers' slots are free now)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    KE[q] = Geo::ap<T_KE, 0, PAR>(p, q, [&](int r) { return U[r] * U[r]; });
    DIVU[q] = Geo::ap<T_DIV, 0, PAR>(p, q, at(U));
    static_for<2>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T rv = Geo::ap<T_CURL, t, PAR>(p, q, at(U));
      const T hv = Geo::ap<T_KITE, t, PAR>(p, q, at(H));
      RV[t * kS + q] = rv;
      NRV[t * kS + q] = rv / hv;
      NPV[t * kS + q] = p.f0v / hv;
    });
  });
  __syncthreads();
  // edge PV; and du's del2 term at the owned pair, in registers
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T nrv_e = Geo::ap<T_VMEAN, t, PAR>(p, q, at(NRV));
      const T npv_e = Geo::ap<T_VMEAN, t, PAR>(p, q, at(NPV));
      Q[t * kS + q] = nrv_e + npv_e;
    });
  });
  // the du diffusion terms use plain 1/dv, del2_e the floored one
  T del2[3][2];
  owned([&](auto par, int q, long long) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::ap<T_VDIFF, t, PAR>(p, q, at(RV));
      del2[t][PAR] = cdd * p.inv_dc - vdr * p.inv_dv;
    });
  });
  __syncthreads();
  // del2 of u on edges (into the normalized vorticities' slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::ap<T_VDIFF, t, PAR>(p, q, at(RV));
      D2E[t * kS + q] = cdd * p.inv_dc - vdr * p.inv_dv_floor;
    });
  });
  __syncthreads();
  T ub[3][2], ua[3][2];
  _Pragma("unroll") for (int t = 0; t < 3; ++t) fetch(1 + t, ub[t], ua[t]);
  // div and curl of del2 on edges (into div u's and curl u's slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    const T dd = Geo::ap<T_DIV, 0, PAR>(p, q, at(D2E));
    const T r0 = Geo::ap<T_CURL, 0, PAR>(p, q, at(D2E));
    const T r1 = Geo::ap<T_CURL, 1, PAR>(p, q, at(D2E));
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
      const T gke = Geo::ap<T_CDIFF, t, PAR>(p, q, at(KE));
      const T gssh = Geo::ap<T_CDIFF, t, PAR>(p, q, at(H));
      const T cd4 = Geo::ap<T_CDIFF, t, PAR>(p, q, at(D2DIV));
      const T vd4 = Geo::ap<T_VDIFF, t, PAR>(p, q, at(D2RV));
      T du = pv - gke * p.inv_dc - p.grav * gssh * p.inv_dc +
             p.nu2s * del2[t][PAR] -
             p.nu4s * (p.div_factor * cd4 * p.inv_dc - vd4 * p.inv_dv);
      if constexpr (TAILS) {
        if (top || bottom) {
          T mh;   // mean_h of the level
          if constexpr (UPH) {
            mh = T(0.5) * (H[q + Geo::kPair<T_C0, t, PAR>] +
                           H[q + Geo::kPair<T_C1, t, PAR>]);
          } else {
            mh = Geo::ap<T_CMEAN, t, PAR>(p, q, at(H));
          }
          if (top) du = du + wind[t * plane + g] / (p.rho0 * mh);
          if (bottom) {
            // 2*cmean(ke) == ke0 + ke1 bit for bit (halving and doubling
            // are exact), the composed step's sqrt(ke0 + ke1)
            const T kee = Geo::ap<T_CMEAN, t, PAR>(p, q, at(KE));
            const T twice = T(2) * kee;
            const T speed = sqrt(twice > T(0) ? twice : T(0));
            du = du + (-(p.cd * speed * U[t * kS + q] / mh));
          }
        }
      }
      const long long c = chan(1 + t) + g;
      if (mode == RK_LAST) {
        out[c] = ua[t][PAR] + cb * du;
      } else {
        out[c] = ub[t][PAR] + ca * du;
        if (mode != RK_PROV)
          acc_out[c] = (mode == RK_FIRST ? ub[t][PAR] : ua[t][PAR]) + cb * du;
      }
    });
  });
}

template <typename T, bool UPH, bool UPT, bool TAILS>
int launch_rk_stage(const void* ev, const void* base, const void* acc,
                    void* acc_out, void* out, const void* wind,
                    const FbParams<T>* hp, double ca, double cb, int mode,
                    int threads, cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads != rk::kRkThreads) return cudaErrorInvalidConfiguration;
  if (!TAILS && (wind != nullptr || p.cd != T(0))) return cudaErrorInvalidValue;
  if (!layout_ok(p) || !rk::Geo::geometry_ok(p)) return cudaErrorInvalidValue;
  // the arrays each mode reads and writes; out never aliases the level
  const bool ok = out != nullptr && out != ev &&
                  (mode == RK_LAST ? acc != nullptr
                                   : base != nullptr && base != out) &&
                  (mode == RK_PROV || mode == RK_LAST || acc_out != nullptr) &&
                  (mode != RK_MID || acc != nullptr) &&
                  mode >= RK_PROV && mode <= RK_LAST;
  if (!ok) return cudaErrorInvalidValue;
  const size_t smem = slab_smem_bytes(p, kRkSlots);
  cudaError_t err = cudaFuncSetAttribute(
      rk_stage_kernel<T, UPH, UPT, TAILS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rk_stage_kernel<T, UPH, UPT, TAILS><<<slab_grid(p), threads, smem, stream>>>(
      static_cast<const T*>(ev), static_cast<const T*>(base),
      static_cast<const T*>(acc), static_cast<T*>(acc_out),
      static_cast<T*>(out), static_cast<const T*>(wind), p,
      static_cast<T>(ca), static_cast<T>(cb), mode);
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of the stage kernel (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) and, for its dynamic shared memory, the
// blocks an SM holds (out[3], cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T, bool UPH, bool UPT, bool TAILS>
int rk_stage_attrs(int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  auto* const k = &rk_stage_kernel<T, UPH, UPT, TAILS>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (kRkSlots * static_cast<size_t>(rk::kS) + 2 * rk::kGuard) * sizeof(T);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      rk::kRkThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace omega

// The C interface of one (UPH, UPT) pair, with and without the tails, in both
// precisions: omega_rk_stage_<NAME>_<plain|tails>_<f32|f64>. `params` points
// at a host FbParams<T> packed for the tile, ring and entry pattern of
// omega::rk (the launch is refused otherwise); ev, base, acc, acc_out and
// out are stacked (4+L, K, ny, nx) arrays (null where the mode reads or
// writes none); ca and cb are a*dt and b*dt, rounded to T once here;
// `threads` must be rk::kRkThreads. Each returns the launch's error code.
// omega_rk_stage_attrs_<NAME>_<plain|tails>_<f32|f64>(out): registers,
// local (spill) bytes, static shared bytes and blocks per SM.
#define OMEGA_RK_ENTRY(NAME, UPH, UPT, TAILS, SUF, T)                         \
  int omega_rk_stage_##NAME##SUF(const void* ev, const void* base,            \
                                 const void* acc, void* acc_out, void* out,   \
                                 const void* wind, const void* params,        \
                                 double ca, double cb, int mode, int threads, \
                                 void* stream) {                              \
    return omega::launch_rk_stage<T, UPH, UPT, TAILS>(                        \
        ev, base, acc, acc_out, out, wind,                                    \
        static_cast<const omega::FbParams<T>*>(params), ca, cb, mode,         \
        threads, static_cast<cudaStream_t>(stream));                          \
  }                                                                           \
  int omega_rk_stage_attrs_##NAME##SUF(int* out) {                            \
    return omega::rk_stage_attrs<T, UPH, UPT, TAILS>(out);                    \
  }
#define OMEGA_RK_VARIANTS(NAME, UPH, UPT)                   \
  extern "C" {                                              \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, false, _plain_f32, float)  \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, false, _plain_f64, double) \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, true, _tails_f32, float)   \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, true, _tails_f64, double)  \
  }
