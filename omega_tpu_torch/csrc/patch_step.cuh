// The forward-backward step on the icosahedral sphere: the horizontal part
// of the FB chain of mesh/icos_mega.fb_chain on the persistent halo frames,
// in six launches made by one C call. One source per pair of flux types
// instantiates this template (patch_step_cc.cu, _uc, _cu, _uu; with FCT
// tracer fluxes _cf, _uf), each with and without the wind / drag tails, in
// both precisions.
//
// Replaces the TPU kernel omega_tpu/ops/patch_megastep.py:_kernel (kind
// `fb`, the chain of _eval_chain, with the upwind options of _pre_ops and
// the wind / drag ops of _phys_ops; its staged kinds fb2a / fb2b exist to
// fit that chip's memory and are the same chain; and kind `fcta`, stage A
// of FCT, icos_mega.fct_stage_a_chain), called at patch_megastep.py:1425.
// The vertical-mixing tail of that chain is csrc/patch_vmix.cu, FCT's stage
// B csrc/patch_fct.cu. State and outputs are the frames of
// ops/patch_megastep.py, (K, 4+L, P) with P = 10 S S positions (10 rhombi,
// S = n + 2 MH); the table layout is patch_common.cuh's.
//
// FCT (TR = kTrFct, stage A): the thickness and velocity sections are the
// FB passes as they are; the tracer section emits, in place of trn{l}, the
// low-order provisional field trtd{l} = (tr h - dt div(flo)) / h_new (pass
// B) with flo = upwind_mean(u, c0(tr), c1(tr)) mask flux (pass A, into
// hflux's field), and the numerator facc{l} = tr h + dt (ed2 diff2 - ed4
// hyp) (pass D). The output is the reference's (K, 4+2L, P) layout:
// h_new, u_new x3, then trtd{l} at 4+2l and facc{l} at 5+2l.
//
// Weights. The TPU kernel reads a lane-major plane stack (10, SS, SS, npl),
// 164 MB at icos48 in float32 and ~85% zeros, once per tile, and applies a
// plane to all 128 lanes of K. Here a position's stencil rows come from the
// compact table built on the host (ops/patch_megastep.py:compact_table).
// Every layer uses the same weights, so a thread loads the slots of its
// position once into registers and walks a group of layers with them (each
// pass its own group, kFbPassLayers): the table (60 offset and 120 weight
// rows of P, 29.5 MB at icos48 in float32) is read once per layer group and
// pass, not once per layer. Neighbouring threads are neighbouring
// positions, so field reads are coalesced along x.
//
// Levels. The chain has six stencil levels; a launch evaluates a group of
// them at every frame position, the intermediates of one launch going
// through device memory to the next (the fields a level reads at
// neighbours must be complete before it runs). The whole frame is
// evaluated, so the reference's tiled validity masks are sufficient (an
// untiled evaluation is exact wherever the tiled one is); the refresh that
// follows (ops/patch_megastep.py) rewrites every position they do not
// trust.
//   A: mean_h, flux = flux_h u, per tracer hflux = htre u_m and
//      mc = mean_h cdiff(tr); ke(u^2); div(u); curl(u)
//   B: h_new = h - dt div(flux); per tracer trp = -div(hflux) +
//      ed2 sdiv_geo2(mc) and d2aux = sdiv_geo(mc); at edges
//      dup = nu2 s2 (cgrad(div u) - vgrad(curl u)) - cgrad(ke) and
//      del2e = mask cgrad(div u) - vgrad_floor(curl u)
//   C: per tracer cd2 = cdiff(d2aux); F = flux_hn u;
//      qv = (curl u + f) / kite(h_new); dr2 = curl(del2e); dd2 = div(del2e)
//   D1 (cells): trn = (tr h + dt (trp - ed4 sdiv_geo4(cd2))) / h_new
//   D2 (edges, one edge class per grid z): Fq = F vmean(qv);
//      dup += -g (cgrad(h_new) - gdepth) - nu4 s4 (df cgrad(dd2) -
//      vgrad(dr2)) + 0.5 vmean(qv) tang(F); the tails: on layer 0
//      dup += stress / (rho0 mean_hn), on layer K-1
//      dup -= cd sqrt(2 cmean(ke)) u / mean_hn
//   E: u_new = u + dt mask (dup + 0.5 tang(Fq))
// D is split by section and edge class, as the RK stage's is
// (patch_rk.cuh), so that a D2 thread holds one edge class's slots, its
// tangential ones in shared memory; the pressure gradient, a read of h_new,
// is taken in D2 and not in C, so that dup goes through device memory once
// less (C wrote it back).
// Center fluxes: mean_h = flux_h = cmean(h), htre = cmean(h tr), mean_hn =
// flux_hn = cmean(h_new). Upwind (either flux): the pair tables c0 / c1
// give the edge's two cells, hp0 / hp1, and mean_h = 0.5 (hp0 + hp1); an
// upwind thickness flux picks flux_h = sel(u, hp0, hp1) (hp0 where u > 0,
// hp1 where u < 0, the larger at rest) and likewise flux_hn from h_new, an
// upwind tracer flux htre = sel(u, hp0 c0(tr), hp1 c1(tr)). Wind and drag
// touch one layer each; which of the two a tails instantiation applies is
// a run-time matter (the wind rows of the const planes, cd != 0), uniform
// over the launch. The momentum tendency's terms are summed in this order,
// not the chain's; every product is rounded on its own (mul_rn), as the
// plain version rounds it, and stencil sums run in the same order as its.
//
// The split-explicit stepper's splitpost (csrc/patch_split.cu) is passes A,
// B, C and D1 with the compile-time switch MOM off: the thickness and tracer
// work alone (center fluxes), the u channels of `in` holding the transport
// velocity and those of `out` left to the caller.
//
// Holes and NaN: lattice holes hold zeros in the frames; the divisions by
// h_v, h_new and mean_hn are guarded (a zero divisor gives 0), as
// _safe_div does.
//
// Bound on this card: device memory. One step must read the state and
// write it once and read the weights, plus the wind rows with wind
// (port_bounds.patch_fb / patch_science: 117 MB at icos48 x 100 x 2 in
// float32, 0.035 ms); the six launches also write and read the
// intermediates: each pass as a function of its own moves 113-287 MB, the
// six 1.16 GB (port_bounds.patch_fb_passes: 0.35 ms), since a pass reads
// its inputs at the neighbours of every position of the whole frames.
#pragma once

#include "patch_common.cuh"

namespace omega {
namespace patch {

enum { kFv = 0, kGd, kS2, kS4, kEm, kNConst };
// the tracer flux of an instantiation
enum { kTrCenter = 0, kTrUpwind = 1, kTrFct = 2 };

template <typename T>
struct Args {
  const T* in;     // frames (K, CH, P)
  T* out;          // next frames (K, CH, P)
  const int* off;  // (kOffRows, P)
  const T* w;      // (kWRows, P)
  const T* cpl;    // (kCRows, P)
  // work fields, each (K, T, P)
  T *flux, *ke, *divu, *rvort, *hflux, *mc, *trp, *d2aux, *dup, *del2e,
      *qv, *dr2;
  T dt, grav, nu2, nu4, dfac, ed2, ed4;
  T cs[kNConst];   // a const plane's value where it is uniform
  int cf[kNConst];  // 1: the const is a plane of cpl
  T rho0, cd;       // the tails: reference density, bottom drag coefficient
  int wind, drag;   // 1: the tails instantiation applies wind / drag
  int P, K, L, CH, kg;
};

// the output's layer stride: the frames' own, or stage A's 4 + 2L channels
// with FCT (a compile-time choice, so an FB pass keeps no second stride)
template <int TR, typename T>
__device__ __forceinline__ long long out_layer(const Args<T>& a) {
  return (TR == kTrFct ? 4LL + 2 * a.L : static_cast<long long>(a.CH)) * a.P;
}

// the thread's position and layer range; false past the frame
template <typename T>
__device__ __forceinline__ bool where(const Args<T>& a, int& p, int& k0,
                                      int& k1) {
  p = blockIdx.x * blockDim.x + threadIdx.x;
  k0 = blockIdx.y * a.kg;
  k1 = min(a.K, k0 + a.kg);
  return p < a.P;
}

template <typename T>
__device__ __forceinline__ T cval(const Args<T>& a, int which, int row,
                                  int p) {
  return a.cf[which] ? a.cpl[static_cast<long long>(row) * a.P + p]
                     : a.cs[which];
}

// x * mask, where a uniform mask of 1 is the identity (the chain's alias)
template <typename T>
__device__ __forceinline__ T masked(const Args<T>& a, T m, T x) {
  return (!a.cf[kEm] && a.cs[kEm] == T(1)) ? x : mul_rn(m, x);
}

// the reference's upwind pick (aux upwind flux): a where u > 0, b where
// u < 0, the larger at rest
template <typename T>
__device__ __forceinline__ T upwind(T u, T a, T b) {
  return u > T(0) ? a : (u < T(0) ? b : (a < b ? b : a));
}

// ------------------------------------------------------------- pass A
template <typename T, bool UH, int TR, bool MOM = true>
__global__ void __launch_bounds__(256) pass_a(const Args<T> a) {
  // mean_h from the pair picks hp0 / hp1 where the chain forms them (an
  // upwind flux), else cmean; FCT reads the pair weights for its tracer
  // picks either way
  constexpr bool kPair = UH || TR == kTrUpwind;
  constexpr bool kPick = kPair || TR == kTrFct;
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const int L = a.L;
  // edges: mean_h, flux, and per tracer hflux, mc
  for (int t = 0; t < 3; ++t) {
    int o[2];
    T wm[2], wd[2], w0[2], w1[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, o);
    load_w(a.w, kWCmean + 2 * t, a.P, p, wm);
    load_w(a.w, kWCdiff + 2 * t, a.P, p, wd);
    if constexpr (kPick) {
      load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
      load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    }
    const T em = cval(a, kEm, kCEm + t, p);
    for (int k = k0; k < k1; ++k) {
      const T* h = a.in + k * lay;
      const T u = h[(1 + t) * P + p];
      T mean_h, flux_h, hp0 = T(0), hp1 = T(0);
      if constexpr (kPair) {
        hp0 = sten(w0, o, h, p);
        hp1 = sten(w1, o, h, p);
        mean_h = mul_rn(T(0.5), hp0 + hp1);
      } else {
        mean_h = sten(wm, o, h, p);
      }
      if constexpr (UH) {
        flux_h = upwind(u, hp0, hp1);
      } else {
        flux_h = mean_h;
      }
      const T flux = mul_rn(flux_h, u);
      a.flux[(k * 3LL + t) * P + p] = flux;
      const T um = masked(a, em, u);
      for (int l = 0; l < L; ++l) {
        const T* tr = h + (4 + l) * P;
        const long long q = (k * 3LL * L + 3 * l + t) * P + p;
        if constexpr (TR == kTrFct) {
          // flo: the low-order pick (the mean at rest) times the masked
          // mass flux
          const T t0 = sten(w0, o, tr, p), t1 = sten(w1, o, tr, p);
          const T lo = u > T(0) ? t0
                                : (u < T(0) ? t1 : mul_rn(T(0.5), t0 + t1));
          a.hflux[q] = mul_rn(lo, masked(a, em, flux));
        } else {
          T htre = T(0);
          if constexpr (TR == kTrUpwind) {
            htre = upwind(u, mul_rn(hp0, sten(w0, o, tr, p)),
                          mul_rn(hp1, sten(w1, o, tr, p)));
          } else {
            _Pragma("unroll") for (int s = 0; s < 2; ++s)
              htre = htre + mul_rn(wm[s], mul_rn(h[p + o[s]], tr[p + o[s]]));
          }
          a.hflux[q] = mul_rn(htre, um);
        }
        a.mc[q] = mul_rn(mean_h, sten(wd, o, tr, p));
      }
    }
  }
  if constexpr (!MOM) return;
  // cells: ke(u^2), div(u)
  {
    int o[6];
    T wk[6], wv[6];
    load_off(a.off, kOffDiv, a.P, p, o);
    load_w(a.w, kWKe, a.P, p, wk);
    load_w(a.w, kWDiv, a.P, p, wv);
    for (int k = k0; k < k1; ++k) {
      const T* u = a.in + k * lay + P;
      T ke = T(0);
      _Pragma("unroll") for (int s = 0; s < 6; ++s) {
        const T x = u[p + o[s]];
        ke = ke + mul_rn(wk[s], mul_rn(x, x));
      }
      a.ke[k * P + p] = ke;
      a.divu[k * P + p] = sten(wv, o, u, p);
    }
  }
  // vertices: curl(u)
  for (int t = 0; t < 2; ++t) {
    int o[3];
    T wc[3];
    load_off(a.off, kOffCurl + 3 * t, a.P, p, o);
    load_w(a.w, kWCurl + 3 * t, a.P, p, wc);
    for (int k = k0; k < k1; ++k)
      a.rvort[(k * 2LL + t) * P + p] = sten(wc, o, a.in + k * lay + P, p);
  }
}

// ------------------------------------------------------------- pass B
template <typename T, int TR, bool MOM = true>
__global__ void __launch_bounds__(256) pass_b(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P,
                  layo = out_layer<TR>(a);
  const int L = a.L;
  // cells: h_new, and per tracer trp, d2aux (FCT: trtd, and trp = ed2 diff2)
  {
    int o[6];
    T wv[6], wg[6], wg2[6];
    load_off(a.off, kOffDiv, a.P, p, o);
    load_w(a.w, kWDiv, a.P, p, wv);
    load_w(a.w, kWSg, a.P, p, wg);
    load_w(a.w, kWSg2, a.P, p, wg2);
    for (int k = k0; k < k1; ++k) {
      const T dh = sten(wv, o, a.flux + k * 3LL * P, p);
      const T h = a.in[k * lay + p];
      const T hn = h + mul_rn(-a.dt, dh);
      a.out[k * layo + p] = hn;
      for (int l = 0; l < L; ++l) {
        const long long b = (k * 3LL * L + 3 * l) * P;
        const T adv = sten(wv, o, a.hflux + b, p);
        const T* mc = a.mc + b;
        const long long q = (k * static_cast<long long>(L) + l) * P + p;
        const T diff2 = mul_rn(a.ed2, sten(wg2, o, mc, p));
        if constexpr (TR == kTrFct) {
          // adv is the low-order flux's divergence
          const T tr = a.in[k * lay + (4 + l) * P + p];
          a.out[k * layo + (4 + 2 * l) * P + p] =
              safe_div(mul_rn(tr, h) + mul_rn(-a.dt, adv), hn);
          a.trp[q] = diff2;
        } else {
          a.trp[q] = -adv + diff2;
        }
        a.d2aux[q] = sten(wg, o, mc, p);
      }
    }
  }
  if constexpr (!MOM) return;
  // edges: dup, del2e
  for (int t = 0; t < 3; ++t) {
    int oc[2], ov[2];
    T wg[2], wvg[2], wvf[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, oc);
    load_w(a.w, kWCgrad + 2 * t, a.P, p, wg);
    load_off(a.off, kOffVm + 2 * t, a.P, p, ov);
    load_w(a.w, kWVgrad + 2 * t, a.P, p, wvg);
    load_w(a.w, kWVgf + 2 * t, a.P, p, wvf);
    const T nu2s = mul_rn(a.nu2, cval(a, kS2, kCS2 + t, p));
    const T em = cval(a, kEm, kCEm + t, p);
    for (int k = k0; k < k1; ++k) {
      const T gke = sten(wg, oc, a.ke + k * P, p);
      const T cdd = sten(wg, oc, a.divu + k * P, p);
      const T* rv = a.rvort + k * 2LL * P;
      const T vdr = sten(wvg, ov, rv, p);
      const T vdrf = sten(wvf, ov, rv, p);
      const long long q = (k * 3LL + t) * P + p;
      a.dup[q] = mul_rn(nu2s, cdd - vdr) - gke;
      a.del2e[q] = masked(a, em, cdd) - vdrf;
    }
  }
}

// ------------------------------------------------------------- pass C
template <typename T, bool UH, int TR, bool MOM = true>
__global__ void __launch_bounds__(256) pass_c(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P,
                  layo = out_layer<TR>(a);
  const int L = a.L;
  // edges: cd2 (into mc's field), F (into flux's)
  for (int t = 0; t < 3; ++t) {
    int o[2];
    T wd[2], wm[2], w0[2], w1[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, o);
    load_w(a.w, kWCdiff + 2 * t, a.P, p, wd);
    load_w(a.w, kWCmean + 2 * t, a.P, p, wm);
    if constexpr (UH) {
      load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
      load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    }
    for (int k = k0; k < k1; ++k) {
      for (int l = 0; l < L; ++l)
        a.mc[(k * 3LL * L + 3 * l + t) * P + p] =
            sten(wd, o, a.d2aux + (k * static_cast<long long>(L) + l) * P,
                 p);
      if constexpr (!MOM) continue;
      const T* hn = a.out + k * layo;
      const long long q = (k * 3LL + t) * P + p;
      const T u = a.in[k * lay + (1 + t) * P + p];
      T flux_hn;
      if constexpr (UH) {
        flux_hn = upwind(u, sten(w0, o, hn, p), sten(w1, o, hn, p));
      } else {
        flux_hn = sten(wm, o, hn, p);
      }
      a.flux[q] = mul_rn(flux_hn, u);
    }
  }
  if constexpr (!MOM) return;
  // vertices: qv, dr2
  for (int t = 0; t < 2; ++t) {
    int ok[3], oc[3];
    T wk[3], wc[3];
    load_off(a.off, kOffKite + 3 * t, a.P, p, ok);
    load_w(a.w, kWKite + 3 * t, a.P, p, wk);
    load_off(a.off, kOffCurl + 3 * t, a.P, p, oc);
    load_w(a.w, kWCurl + 3 * t, a.P, p, wc);
    const T fv = cval(a, kFv, kCFv + t, p);
    for (int k = k0; k < k1; ++k) {
      const long long q = (k * 2LL + t) * P + p;
      const T hv = sten(wk, ok, a.out + k * layo, p);
      a.qv[q] = safe_div(a.rvort[q] + fv, hv);
      a.dr2[q] = sten(wc, oc, a.del2e + k * 3LL * P, p);
    }
  }
  // cells: dd2 (into div_u's field)
  {
    int o[6];
    T wv[6];
    load_off(a.off, kOffDiv, a.P, p, o);
    load_w(a.w, kWDiv, a.P, p, wv);
    for (int k = k0; k < k1; ++k)
      a.divu[k * P + p] = sten(wv, o, a.del2e + k * 3LL * P, p);
  }
}

// ------------------------------------------------------------- pass D
// D is split by section, so that no thread holds the slots of more than one
// edge class: D1 the cells (the new tracers; FCT: the numerators facc), D2
// the edges (Fq and du), one edge class per grid z. The two write disjoint
// fields and read none the other writes.
template <typename T, int TR>
__global__ void __launch_bounds__(256) pass_d_cells(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P,
                  layo = out_layer<TR>(a);
  const int L = a.L;
  int o[6];
  T w4[6];
  load_off(a.off, kOffDiv, a.P, p, o);
  load_w(a.w, kWSg4, a.P, p, w4);
  for (int k = k0; k < k1; ++k) {
    const T h = a.in[k * lay + p];
    const T hn = a.out[k * layo + p];
    for (int l = 0; l < L; ++l) {
      const T hyp = sten(w4, o, a.mc + (k * 3LL * L + 3 * l) * P, p);
      const T dtr =
          a.trp[(k * static_cast<long long>(L) + l) * P + p] -
          mul_rn(a.ed4, hyp);
      const T tr = a.in[k * lay + (4 + l) * P + p];
      const T acc = mul_rn(tr, h) + mul_rn(a.dt, dtr);
      if constexpr (TR == kTrFct) {
        a.out[k * layo + (5 + 2 * l) * P + p] = acc;
      } else {
        a.out[k * layo + (4 + l) * P + p] = safe_div(acc, hn);
      }
    }
  }
}

// D2: Fq (into del2e's field), and into dup the pressure gradient g
// (cgrad(h_new) - gdepth), the PV and del4 terms and the tails. Its register
// budget: at least 4 blocks of 256 threads resident per SM (64 registers);
// the tangential slots in shared memory, each thread's own column, read
// through a volatile pointer at every use (as patch_rk.cuh's D2)
template <typename T, bool UH, int TR, bool TAILS>
__global__ void __launch_bounds__(256, 4) pass_d_edges(const Args<T> a) {
  __shared__ int s_ot[10][256];
  __shared__ T s_wt[10][256];
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const int t = blockIdx.z;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P,
                  layo = out_layer<TR>(a);
  int ov[2], oc[2], ot[10];
  T wvm[2], wvg[2], wg[2], wt[10], wm[2], w0[2], w1[2];
  load_off(a.off, kOffVm + 2 * t, a.P, p, ov);
  load_w(a.w, kWVmean + 2 * t, a.P, p, wvm);
  load_w(a.w, kWVgrad + 2 * t, a.P, p, wvg);
  load_off(a.off, kOffCm + 2 * t, a.P, p, oc);
  load_w(a.w, kWCgrad + 2 * t, a.P, p, wg);
  load_off(a.off, kOffTang + 10 * t, a.P, p, ot);
  load_w(a.w, kWTang + 10 * t, a.P, p, wt);
  const int tid = threadIdx.x;
  _Pragma("unroll") for (int s = 0; s < 10; ++s) {
    s_ot[s][tid] = ot[s];
    s_wt[s][tid] = wt[s];
  }
  if constexpr (TAILS) {
    load_w(a.w, kWCmean + 2 * t, a.P, p, wm);
    if constexpr (UH) {
      load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
      load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    }
  }
  const T nu4s = mul_rn(a.nu4, cval(a, kS4, kCS4 + t, p));
  const T gd = cval(a, kGd, kCGd + t, p);
  const volatile int* so = &s_ot[0][tid];
  const volatile T* sw = &s_wt[0][tid];
  for (int k = k0; k < k1; ++k) {
    const long long q = (k * 3LL + t) * P + p;
    const T* hn = a.out + k * layo;
    const T qe = sten(wvm, ov, a.qv + k * 2LL * P, p);
    a.del2e[q] = mul_rn(a.flux[q], qe);
    const T* fl = a.flux + k * 3LL * P;
    T tf = T(0);
    _Pragma("unroll") for (int s = 0; s < 10; ++s)
      tf = tf + mul_rn(static_cast<T>(sw[s * 256]), fl[p + so[s * 256]]);
    const T cd4 = sten(wg, oc, a.divu + k * P, p);
    const T vd4 = sten(wvg, ov, a.dr2 + k * 2LL * P, p);
    const T pg = mul_rn(a.grav, sten(wg, oc, hn, p) - gd);
    T du = ((a.dup[q] - pg) - mul_rn(nu4s, mul_rn(a.dfac, cd4) - vd4)) +
           mul_rn(T(0.5), mul_rn(qe, tf));
    if constexpr (TAILS) {
      const bool top = a.wind && k == 0, bottom = a.drag && k == a.K - 1;
      if (top || bottom) {
        T mean_hn;
        if constexpr (UH) {
          mean_hn = mul_rn(T(0.5), sten(w0, oc, hn, p) +
                                       sten(w1, oc, hn, p));
        } else {
          mean_hn = sten(wm, oc, hn, p);
        }
        if (top)
          du = du + safe_div(a.cpl[(kCWind + t) * P + p],
                             mul_rn(a.rho0, mean_hn));
        if (bottom) {
          const T kee = sten(wm, oc, a.ke + k * P, p);
          const T two = T(2) * kee;
          const T speed = sqrt(two > T(0) ? two : T(0));
          du = du - safe_div(mul_rn(mul_rn(a.cd, speed),
                                    a.in[k * lay + (1 + t) * P + p]),
                             mean_hn);
        }
      }
    }
    a.dup[q] = du;
  }
}

// ------------------------------------------------------------- pass E
template <typename T, int TR>
__global__ void __launch_bounds__(256) pass_e(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P,
                  layo = out_layer<TR>(a);
  for (int t = 0; t < 3; ++t) {
    int ot[10];
    T wt[10];
    load_off(a.off, kOffTang + 10 * t, a.P, p, ot);
    load_w(a.w, kWTang + 10 * t, a.P, p, wt);
    const T em = cval(a, kEm, kCEm + t, p);
    for (int k = k0; k < k1; ++k) {
      const long long q = (k * 3LL + t) * P + p;
      const T tfq = sten(wt, ot, a.del2e + k * 3LL * P, p);
      const T du = a.dup[q] + mul_rn(T(0.5), tfq);
      a.out[k * layo + (1 + t) * P + p] =
          a.in[k * lay + (1 + t) * P + p] + mul_rn(a.dt, masked(a, em, du));
    }
  }
}

// The FB step's passes: A, B, C, D1 (cells), D2 (edges, one launch of grid
// z = 3), E, each walking its own group of layers per thread
// (kFbPassLayers; splitpost, passes A-D1, walks the same groups): the
// fastest of 4, 8 and 16 for each pass at icos48 x 100 x 2 in float32 on an
// H100 (PERF.md, row 5), though none moves a pass by more than 10%.
enum { kFbPassA = 0, kFbPassB, kFbPassC, kFbPassD1, kFbPassD2, kFbPassE,
       kFbPasses };
constexpr int kFbPassLayers[kFbPasses] = {4, 8, 4, 8, 16, 4};

// pass i's arguments (its layer group) and grid
template <typename T>
void fb_pass_args(const Args<T>& a, int threads, int i, Args<T>& ai,
                  dim3& grid) {
  ai = a;
  ai.kg = kFbPassLayers[i];
  grid = dim3((a.P + threads - 1) / threads,
              (a.K + kFbPassLayers[i] - 1) / kFbPassLayers[i],
              i == kFbPassD2 ? 3 : 1);
}

// the kernel of pass `pass`, or null
template <typename T, bool UH, int TR, bool TAILS>
const void* fb_pass_kernel(int pass) {
  switch (pass) {
    case kFbPassA: return reinterpret_cast<const void*>(pass_a<T, UH, TR>);
    case kFbPassB: return reinterpret_cast<const void*>(pass_b<T, TR>);
    case kFbPassC: return reinterpret_cast<const void*>(pass_c<T, UH, TR>);
    case kFbPassD1: return reinterpret_cast<const void*>(pass_d_cells<T, TR>);
    case kFbPassD2:
      return reinterpret_cast<const void*>(pass_d_edges<T, UH, TR, TAILS>);
    case kFbPassE: return reinterpret_cast<const void*>(pass_e<T, TR>);
    default: return nullptr;
  }
}

// kernel_attrs of the FB step's pass `pass`
template <typename T, bool UH, int TR, bool TAILS>
int fb_pass_attrs(int pass, int threads, int* out) {
  return kernel_attrs(fb_pass_kernel<T, UH, TR, TAILS>(pass), threads, out);
}

template <typename T, bool UH, int TR, bool TAILS>
int launch(const void* in, void* out, const void* off, const void* w,
           const void* cpl, void* work, const double* c, const int* n,
           cudaStream_t stream) {
  Args<T> a;
  a.P = n[0];
  a.K = n[2];
  a.L = n[3];
  a.CH = 4 + a.L;
  const int threads = n[5];
  if (a.P < 1 || a.K < 1 || a.L < 0 || threads < 32 || threads > 256 ||
      threads % 32) {
    return cudaErrorInvalidValue;
  }
  if (in == nullptr || out == nullptr || off == nullptr || w == nullptr ||
      cpl == nullptr || work == nullptr || in == out) {
    return cudaErrorInvalidValue;
  }
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.off = static_cast<const int*>(off);
  a.w = static_cast<const T*>(w);
  a.cpl = static_cast<const T*>(cpl);
  // work fields in the order of ops/patch_megastep.py:work_fields
  const long long f = static_cast<long long>(a.K) * a.P;
  T* wp = static_cast<T*>(work);
  T** fields[] = {&a.flux, &a.ke,  &a.divu, &a.rvort, &a.hflux, &a.mc,
                  &a.trp,  &a.d2aux, &a.dup, &a.del2e, &a.qv,   &a.dr2};
  const int width[] = {3, 1, 1, 2, 3 * a.L, 3 * a.L, a.L, a.L, 3, 3, 2, 2};
  for (int i = 0; i < 12; ++i) {
    *fields[i] = wp;
    wp += width[i] * f;
  }
  a.dt = static_cast<T>(c[0]);
  a.grav = static_cast<T>(c[1]);
  a.nu2 = static_cast<T>(c[2]);
  a.nu4 = static_cast<T>(c[3]);
  a.dfac = static_cast<T>(c[4]);
  a.ed2 = static_cast<T>(c[5]);
  a.ed4 = static_cast<T>(c[6]);
  for (int i = 0; i < kNConst; ++i) {
    a.cs[i] = static_cast<T>(c[7 + i]);
    a.cf[i] = n[6 + i];
  }
  a.rho0 = static_cast<T>(c[7 + kNConst]);
  a.cd = static_cast<T>(c[8 + kNConst]);
  a.wind = n[6 + kNConst];
  a.drag = n[7 + kNConst];
  if (!TAILS && (a.wind || a.drag)) return cudaErrorInvalidValue;
  Args<T> ap[kFbPasses];
  dim3 grid[kFbPasses];
  for (int i = 0; i < kFbPasses; ++i) fb_pass_args(a, threads, i, ap[i], grid[i]);
  cudaError_t err;
#define OMEGA_PASS(I, ...)                                     \
  __VA_ARGS__<<<grid[I], threads, 0, stream>>>(ap[I]);         \
  err = cudaGetLastError();                                    \
  if (err != cudaSuccess) return static_cast<int>(err);
  OMEGA_PASS(kFbPassA, pass_a<T, UH, TR>)
  OMEGA_PASS(kFbPassB, pass_b<T, TR>)
  OMEGA_PASS(kFbPassC, pass_c<T, UH, TR>)
  OMEGA_PASS(kFbPassD1, pass_d_cells<T, TR>)
  OMEGA_PASS(kFbPassD2, pass_d_edges<T, UH, TR, TAILS>)
  OMEGA_PASS(kFbPassE, pass_e<T, TR>)
#undef OMEGA_PASS
  return 0;
}

}  // namespace patch
}  // namespace omega

// The C interface of one pair of flux types (FL: cc, uc, cu, uu, cf, uf =
// thickness then tracer flux, center, upwind or FCT), without and with the
// tails, in both precisions: omega_patch_fb_<FL>_<plain|tails>_<f32|f64>.
// `in` is (K, 4+L, P) frames, `out` the same (FCT: (K, 4+2L, P), stage A's
// layout), `off` / `w` / `cpl` the compact table and the
// const planes, `work` the scratch of work_fields(L) (K, 1, P) fields;
// `consts` = dt, g, nu2, nu4, div_factor, eddy_diff2, eddy_diff4, the
// uniform values of f_vertex, gdepth, scal2, scal4, edge_mask, then rho0 and
// the drag coefficient; `ints` = P, S, K, L, layers per thread (not read:
// each pass walks kFbPassLayers), threads per block, one flag per const (1:
// a plane of `cpl`), then wind and drag on (1) or off (0). Returns the
// first refused launch's error code, or 0.
// omega_patch_fb_attrs_<FL>_<plain|tails>_<f32|f64>(pass, threads, out):
// pass A ... E's (0 ... 5) numRegs, localSizeBytes, sharedSizeBytes and
// blocks per SM at `threads` threads a block.
#define OMEGA_PATCH_ENTRY(FL, TL, SUF, T, UH, TR, TAILS)                    \
  int omega_patch_fb_##FL##_##TL##_##SUF(                                    \
      const void* in, void* out, const void* off, const void* w,             \
      const void* cpl, void* work, const double* consts, const int* ints,    \
      void* stream) {                                                        \
    return omega::patch::launch<T, UH, TR, TAILS>(                           \
        in, out, off, w, cpl, work, consts, ints,                            \
        static_cast<cudaStream_t>(stream));                                  \
  }                                                                          \
  int omega_patch_fb_attrs_##FL##_##TL##_##SUF(int pass, int threads,        \
                                              int* out) {                    \
    return omega::patch::fb_pass_attrs<T, UH, TR, TAILS>(pass, threads,      \
                                                         out);              \
  }

#define OMEGA_PATCH_VARIANTS(FL, UH, TR)                                    \
  extern "C" {                                                               \
  OMEGA_PATCH_ENTRY(FL, plain, f32, float, UH, TR, false)                    \
  OMEGA_PATCH_ENTRY(FL, tails, f32, float, UH, TR, true)                     \
  OMEGA_PATCH_ENTRY(FL, plain, f64, double, UH, TR, false)                   \
  OMEGA_PATCH_ENTRY(FL, tails, f64, double, UH, TR, true)                    \
  }
