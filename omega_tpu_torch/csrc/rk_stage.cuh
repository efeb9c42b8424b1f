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
// with the levels the FB step shares (slab_chain.cuh) and the same
// compile-time variants <UPH, UPT, TAILS>. The epilogue at the owned centre
// is a run-time branch uniform over the launch (`mode`, enum RkMode), with
// ca = a*dt and cb = b*dt folded in float64 on the host and rounded to T
// once, as the JAX code does with python floats:
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
// Bound: bytes, per launch the evaluated level (4+L channels), the base and
// accumulator read at the owned centre, and the outputs written; the chain's
// stencil arithmetic is the FB step's, and like it what the time goes to.
#pragma once

#include "slab_chain.cuh"

namespace omega {

enum RkMode { RK_PROV = 0, RK_FIRST = 1, RK_MID = 2, RK_LAST = 3 };

constexpr int kRkSlots = 21;

template <typename T, bool UPH, bool UPT, bool TAILS>
__global__ void __launch_bounds__(512)
rk_stage_kernel(const T* __restrict__ ev, const T* __restrict__ base,
                const T* acc, T* acc_out, T* __restrict__ out,
                const T* __restrict__ wind,
                const __grid_constant__ FbParams<T> p, T ca, T cb, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;

  // tracer phase
  T* const H = sm;              // thickness of the level (the whole stage)
  T* const U = sm + 1 * S;      // 3 edge classes
  T* const MH = sm + 4 * S;     // mean_h, 3
  T* const HO = sm + 7 * S;     // out's h (owned centre only)
  T* const TR = sm + 8 * S;     // current tracer
  T* const HTR = sm + 9 * S;    // h*tr on edges, 3
  T* const FH = sm + 9 * S;     // upwind flux_h, 3 (dead before the tracers)
  T* const G = sm + 12 * S;     // geo*mean_h*cdiff(tr), 3
  T* const ADV = sm + 15 * S;
  T* const D2 = sm + 16 * S;
  T* const CD2 = sm + 17 * S;   // geo4*cdiff(d2tr), 3
  // momentum phase: as the FB step's, on H, with KE in HO's slot
  const MomSlots<T> m{H,
                      sm + 4 * S,    // FL: flux_h of h, 3
                      sm + 7 * S,    // KE
                      sm + 8 * S,    // DIVU
                      sm + 9 * S,    // RV, 2
                      sm + 11 * S,   // NRV, 2
                      sm + 13 * S,   // NPV, 2
                      sm + 15 * S,   // Q, 3
                      sm + 18 * S,   // D2E, 3
                      sm + 11 * S,   // D2DIV
                      sm + 12 * S};  // D2RV, 2

  load_hu(sl, p, ev, H, U);
  __syncthreads();
  thickness_level<UPH>(sl, p, H, U, MH, FH);
  __syncthreads();

  // ---- dh = -div(flux_h * u) at the owned centre: out's and acc's h
  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    const T dh = -AP(T_DIV, 0, [&](int r) {
      return (UPH ? FH[r] : MH[r]) * U[r];
    });
    const long long c = sl.chan(p, 0) + g;
    T h;
    if (mode == RK_LAST) {
      h = acc[c] + cb * dh;
    } else {
      h = base[c] + ca * dh;
      if (mode != RK_PROV)
        acc_out[c] = (mode == RK_FIRST ? base[c] : acc[c]) + cb * dh;
    }
    HO[q] = h;
    out[c] = h;
  }
  __syncthreads();

  // ---- tracers, one at a time through the same slab arrays
  for (int l = 0; l < p.L; ++l) {
    for (int q = threadIdx.x; q < S; q += blockDim.x)
      TR[q] = ev[sl.chan(p, 4 + l) + sl.gofs(p, q)];
    __syncthreads();
    tracer_levels<UPT>(sl, p, H, U, MH, TR, HTR, G, ADV, D2, CD2);
    for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
      int q;
      long long g;
      bool odd;
      if (!sl.owned(p, o, q, g, odd)) continue;
      const T dtr = tracer_dtr(p, q, odd, ADV, D2, CD2);
      const long long c = sl.chan(p, 4 + l) + g;
      if (mode == RK_LAST) {
        out[c] = (acc[c] + cb * dtr) / HO[q];
      } else {
        const T trh = base[c] * base[sl.chan(p, 0) + g];
        if (mode != RK_PROV)
          acc_out[c] = (mode == RK_FIRST ? trh : acc[c]) + cb * dtr;
        out[c] = (trh + ca * dtr) / HO[q];
      }
    }
    __syncthreads();
  }

  // ---- momentum aux on the level, then u at the owned centre
  momentum_levels<UPH>(sl, p, U, m);
  const bool top = TAILS && wind != nullptr && sl.k == 0;
  const bool bottom = TAILS && p.cd != T(0) && sl.k == p.K - 1;
  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T du = momentum_du<UPH, TAILS>(sl, p, q, odd, t, g, U, m, wind,
                                           top, bottom);
      const long long c = sl.chan(p, 1 + t) + g;
      if (mode == RK_LAST) {
        out[c] = acc[c] + cb * du;
      } else {
        out[c] = base[c] + ca * du;
        if (mode != RK_PROV)
          acc_out[c] = (mode == RK_FIRST ? base[c] : acc[c]) + cb * du;
      }
    }
  }
}

template <typename T, bool UPH, bool UPT, bool TAILS>
int launch_rk_stage(const void* ev, const void* base, const void* acc,
                    void* acc_out, void* out, const void* wind,
                    const FbParams<T>* hp, double ca, double cb, int mode,
                    int threads, cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads < 32 || threads > 512) return cudaErrorInvalidConfiguration;
  if (!TAILS && (wind != nullptr || p.cd != T(0))) return cudaErrorInvalidValue;
  if (!layout_ok(p)) return cudaErrorInvalidValue;
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

}  // namespace omega

// The C interface of one (UPH, UPT) pair, with and without the tails, in both
// precisions: omega_rk_stage_<NAME>_<plain|tails>_<f32|f64>. `params` points
// at a host FbParams<T>; ev, base, acc, acc_out and out are stacked
// (4+L, K, ny, nx) arrays (null where the mode reads or writes none); ca and
// cb are a*dt and b*dt, rounded to T once here. Each returns the launch's
// error code.
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
  }
#define OMEGA_RK_VARIANTS(NAME, UPH, UPT)                   \
  extern "C" {                                              \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, false, _plain_f32, float)  \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, false, _plain_f64, double) \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, true, _tails_f32, float)   \
  OMEGA_RK_ENTRY(NAME, UPH, UPT, true, _tails_f64, double)  \
  }
