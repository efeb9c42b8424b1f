// One stage of the Runge-Kutta steppers on the icosahedral sphere: every
// tendency at one level of the persistent halo frames, then what the stage
// makes of it, in five launches made by one C call. One source per pair of
// flux types instantiates this template (patch_rk_cc.cu, _uc, _cu, _uu), each
// with and without the wind / drag tails, in both precisions.
//
// Replaces the TPU kernel omega_tpu/ops/patch_megastep.py:_kernel in the
// kinds `rk2a` / `rk2b` (rk2_patch_megastep_framed) and `rk4s1`-`rk4s4`
// (rk4_patch_megastep_framed), the chains mesh/icos_mega.rk2_stage_chain and
// rk4_stage_chain, called at patch_megastep.py:1425. The chain is
// compute_all_tendencies at the level `in` (K, 4+L, P): the FB chain of
// patch_step.cuh one level shallower, since its momentum section reads h and
// not h_new (the chain's mean_hn and flux_hn are aliases of mean_h and
// flux_h, so F is flux and the tails' mean_hn is mean_h). The
// vertical-mixing tail of the last stage is csrc/patch_vmix.cu, launched
// after it.
//
// The stage's update is a run-time branch uniform over the launch (`mode`,
// the port's RK_PROV ... RK_LAST), with ca = a dt (Args::dt) and cb = b dt
// folded in float64 on the host and rounded to T once, as the chain's
// literals are (ops/patch_megastep.rk_stage_plain):
//
//   RK_PROV   out = base + ca k                       (RK2: both stages)
//   RK_FIRST  acc = (h, u, tr h)(base) + cb k ; out = base + ca k  (RK4 s1)
//   RK_MID    acc = acc + cb k ; out = base + ca k              (s2, s3)
//   RK_LAST   out = acc + cb k, tracers (acc_tr + cb dtr) / out_h   (s4)
//
// where the accumulator holds thickness-weighted tracers tr h and out's
// tracers are (tr h of base + ca dtr) / out_h (TimeStepper.h:205-237); k is
// (-div(flux), du, dtr), so h takes -ca and -cb. `in` is read at neighbours
// and `out` is written out of place; base and the accumulator are read only
// at the position a thread writes, so acc_out may be acc.
//
// Levels. The frames stay whole, as in patch_step.cuh: a thread walks a
// group of layers of its position (kRkPassLayers, per pass) with the
// position's table slots in registers, and a launch evaluates one group of
// stencil levels at every frame position, the intermediates going through
// device memory:
//   A (level 1): mean_h (cmean or the pair picks), flux = flux_h u, per
//      tracer hflux = htre mask u and mc = mean_h cdiff(tr); ke(u^2),
//      div(u); curl(u) and qv = (curl u + f) / kite(h)
//   B (level 2): dh = div(flux); per tracer trp = -div(hflux) +
//      ed2 sdiv_geo2(mc) and d2aux = sdiv_geo(mc); at edges
//      dup = nu2 s2 (cgrad(div u) - vgrad(curl u)) - cgrad(ke)
//      - g (cgrad(h) - gdepth), del2e = mask cgrad(div u) - vgrad_floor(curl
//      u), Fq = flux vmean(qv)
//   C (level 3): per tracer cd2 = cdiff(d2aux) (into mc's field);
//      dr2 = curl(del2e) (into curl u's), dd2 = div(del2e) (into div u's)
//   D (level 4, then the update), two launches by section:
//   D1 (cells): dtr = trp - ed4 sdiv_geo4(cd2); then h and the tracers of
//      out (and of acc_out) from dh and dtr
//   D2 (edges, one edge class per grid z): du = dup - nu4 s4 (df cgrad(dd2)
//      - vgrad(dr2)) + 0.5 vmean(qv) tang(flux)
//      [+ stress / (rho0 mean_hn) on layer 0] [- cd sqrt(2 cmean(ke)) u /
//      mean_hn on layer K-1] + 0.5 tang(Fq); then u of out (and acc_out)
//      from mask du
// Every momentum stencil reads the level's own fields (the FB step's reads
// h_new, a level-2 value). The momentum terms are summed in the FB kernel's
// order, not the chain's; every product is rounded on its own (mul_rn), as
// the plain version rounds it, and stencil sums run in the plain version's
// order. Divisions are guarded against lattice-hole zeros (safe_div).
//
// Pass D is split by section and edge class because one thread for all of
// D holds the slots of the cells and of the three edge classes (tang's 10
// offsets and 10 weights per class among them): 123 registers with the
// tails, 16 of 64 warps per SM for a chain of dependent L2 gathers. A D2
// thread holds one edge class's slots; __launch_bounds__ caps it at 64
// registers (32 warps per SM), and the tangential slots sit in shared
// memory, which keeps the tails' variants from spilling. The other forms
// timed on an H100 (registers at 48 / 64 / 80 / unbounded, shared slots at
// 48 / 128 registers) were no faster (PERF.md, row 5c).
//
// The split-explicit stepper's splitpre (csrc/patch_split.cu) is passes A,
// B, C and D2 with the compile-time switch SP: no thickness or tracer work,
// the pressure gradient g cgrad(sshc) of the column free surface (a field
// of its own, written by a pass before A) in place of g (cgrad(h) -
// gdepth), and an epilogue that writes du, ungated, and no stage update.
//
// Bound on this card: device memory. A stage must read its level, the base
// and the accumulator it takes and the weights, and write its outputs once
// (port_bounds.patch_rk: 117-283 MB per stage at icos48 x 100 x 2 in
// float32, 0.035-0.084 ms); the five launches also write and read the
// intermediates (about 35 state-field volumes at L = 2; each pass's own
// bytes in port_bounds.patch_rk_passes), which this version does not keep
// on chip.
#pragma once

#include "patch_step.cuh"

namespace omega {
namespace patch {

// what a stage writes (RK_PROV ... RK_LAST of ops/patch_megastep.py)
enum { kRkProv = 0, kRkFirst = 1, kRkMid = 2, kRkLast = 3 };

// the patch step's arguments (Args::in is the evaluated level, Args::dt is
// ca), and the stage's own
template <typename T>
struct RkArgs : Args<T> {
  const T* base;   // the step's initial frames (not read by RK_LAST)
  const T* acc;    // the accumulator read (RK_MID, RK_LAST)
  T* acc_out;      // the accumulator written (RK_FIRST, RK_MID)
  T *dh, *Fq;      // work fields (K, 1 | 3, P)
  T* sshc;         // splitpre: the column free surface (1, P)
  T cb;
  int mode;
};

// ------------------------------------------------------------- pass A
template <typename T, bool UH, int TR, bool SP = false>
__global__ void __launch_bounds__(256) rk_pass_a(const RkArgs<T> a) {
  constexpr bool kPair = UH || TR == kTrUpwind;
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
    if constexpr (kPair) {
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
      const long long q = (k * 3LL + t) * P + p;
      a.flux[q] = mul_rn(flux_h, u);
      if constexpr (SP) continue;
      const T um = masked(a, em, u);
      for (int l = 0; l < L; ++l) {
        const T* tr = h + (4 + l) * P;
        const long long ql = (k * 3LL * L + 3 * l + t) * P + p;
        T htre = T(0);
        if constexpr (TR == kTrUpwind) {
          htre = upwind(u, mul_rn(hp0, sten(w0, o, tr, p)),
                        mul_rn(hp1, sten(w1, o, tr, p)));
        } else {
          _Pragma("unroll") for (int s = 0; s < 2; ++s)
            htre = htre + mul_rn(wm[s], mul_rn(h[p + o[s]], tr[p + o[s]]));
        }
        a.hflux[ql] = mul_rn(htre, um);
        a.mc[ql] = mul_rn(mean_h, sten(wd, o, tr, p));
      }
    }
  }
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
  // vertices: curl(u), qv
  for (int t = 0; t < 2; ++t) {
    int oc[3], ok[3];
    T wc[3], wk[3];
    load_off(a.off, kOffCurl + 3 * t, a.P, p, oc);
    load_w(a.w, kWCurl + 3 * t, a.P, p, wc);
    load_off(a.off, kOffKite + 3 * t, a.P, p, ok);
    load_w(a.w, kWKite + 3 * t, a.P, p, wk);
    const T fv = cval(a, kFv, kCFv + t, p);
    for (int k = k0; k < k1; ++k) {
      const T* h = a.in + k * lay;
      const long long q = (k * 2LL + t) * P + p;
      const T rv = sten(wc, oc, h + P, p);
      a.rvort[q] = rv;
      a.qv[q] = safe_div(rv + fv, sten(wk, ok, h, p));
    }
  }
}

// ------------------------------------------------------------- pass B
template <typename T, bool SP = false>
__global__ void __launch_bounds__(256) rk_pass_b(const RkArgs<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const int L = a.L;
  // cells: dh, and per tracer trp, d2aux
  if constexpr (!SP) {
    int o[6];
    T wv[6], wg[6], wg2[6];
    load_off(a.off, kOffDiv, a.P, p, o);
    load_w(a.w, kWDiv, a.P, p, wv);
    load_w(a.w, kWSg, a.P, p, wg);
    load_w(a.w, kWSg2, a.P, p, wg2);
    for (int k = k0; k < k1; ++k) {
      a.dh[k * P + p] = sten(wv, o, a.flux + k * 3LL * P, p);
      for (int l = 0; l < L; ++l) {
        const long long b = (k * 3LL * L + 3 * l) * P;
        const T adv = sten(wv, o, a.hflux + b, p);
        const T* mc = a.mc + b;
        const long long q = (k * static_cast<long long>(L) + l) * P + p;
        a.trp[q] = -adv + mul_rn(a.ed2, sten(wg2, o, mc, p));
        a.d2aux[q] = sten(wg, o, mc, p);
      }
    }
  }
  // edges: dup, del2e, Fq
  for (int t = 0; t < 3; ++t) {
    int oc[2], ov[2];
    T wg[2], wvg[2], wvf[2], wvm[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, oc);
    load_w(a.w, kWCgrad + 2 * t, a.P, p, wg);
    load_off(a.off, kOffVm + 2 * t, a.P, p, ov);
    load_w(a.w, kWVgrad + 2 * t, a.P, p, wvg);
    load_w(a.w, kWVgf + 2 * t, a.P, p, wvf);
    load_w(a.w, kWVmean + 2 * t, a.P, p, wvm);
    const T nu2s = mul_rn(a.nu2, cval(a, kS2, kCS2 + t, p));
    const T em = cval(a, kEm, kCEm + t, p);
    const T gd = cval(a, kGd, kCGd + t, p);
    for (int k = k0; k < k1; ++k) {
      const T gke = sten(wg, oc, a.ke + k * P, p);
      const T cdd = sten(wg, oc, a.divu + k * P, p);
      const T* rv = a.rvort + k * 2LL * P;
      const T vdr = sten(wvg, ov, rv, p);
      const T vdrf = sten(wvf, ov, rv, p);
      const T qe = sten(wvm, ov, a.qv + k * 2LL * P, p);
      const long long q = (k * 3LL + t) * P + p;
      // the pressure gradient: g (cgrad(h) - gdepth), or with the column
      // free surface g cgrad(sshc)
      T pg;
      if constexpr (SP) {
        pg = mul_rn(a.grav, sten(wg, oc, a.sshc, p));
      } else {
        pg = mul_rn(a.grav, sten(wg, oc, a.in + k * lay, p) - gd);
      }
      a.dup[q] = (mul_rn(nu2s, cdd - vdr) - gke) - pg;
      a.del2e[q] = masked(a, em, cdd) - vdrf;
      a.Fq[q] = mul_rn(a.flux[q], qe);
    }
  }
}

// ------------------------------------------------------------- pass C
template <typename T, bool SP = false>
__global__ void __launch_bounds__(256) rk_pass_c(const RkArgs<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P;
  const int L = a.L;
  // edges: cd2 (into mc's field)
  if constexpr (!SP) for (int t = 0; t < 3; ++t) {
    int o[2];
    T wd[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, o);
    load_w(a.w, kWCdiff + 2 * t, a.P, p, wd);
    for (int k = k0; k < k1; ++k)
      for (int l = 0; l < L; ++l)
        a.mc[(k * 3LL * L + 3 * l + t) * P + p] =
            sten(wd, o, a.d2aux + (k * static_cast<long long>(L) + l) * P,
                 p);
  }
  // vertices: dr2 (into rvort's field: pass B was its last reader)
  for (int t = 0; t < 2; ++t) {
    int oc[3];
    T wc[3];
    load_off(a.off, kOffCurl + 3 * t, a.P, p, oc);
    load_w(a.w, kWCurl + 3 * t, a.P, p, wc);
    for (int k = k0; k < k1; ++k)
      a.rvort[(k * 2LL + t) * P + p] = sten(wc, oc, a.del2e + k * 3LL * P, p);
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
// edge class: D1 the cells (h and the tracers of out and acc_out), D2 the
// edges (du, then u), one edge class per grid z. The two write disjoint
// channels, and D2's tails read `in` and ke, not `out`, so the split changes
// no output's arithmetic.
template <typename T>
__global__ void __launch_bounds__(256) rk_pass_d_cells(const RkArgs<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const int L = a.L, mode = a.mode;
  const T ca = a.dt, cb = a.cb;
  int o[6];
  T w4[6];
  load_off(a.off, kOffDiv, a.P, p, o);
  load_w(a.w, kWSg4, a.P, p, w4);
  for (int k = k0; k < k1; ++k) {
    const long long c = k * lay + p;
    const T dh = a.dh[k * P + p];
    T hb = T(0), hn;
    if (mode == kRkLast) {
      hn = a.acc[c] + mul_rn(-cb, dh);
    } else {
      hb = a.base[c];
      hn = hb + mul_rn(-ca, dh);
      if (mode == kRkFirst) a.acc_out[c] = hb + mul_rn(-cb, dh);
      if (mode == kRkMid) a.acc_out[c] = a.acc[c] + mul_rn(-cb, dh);
    }
    a.out[c] = hn;
    for (int l = 0; l < L; ++l) {
      const T hyp = sten(w4, o, a.mc + (k * 3LL * L + 3 * l) * P, p);
      const T dtr =
          a.trp[(k * static_cast<long long>(L) + l) * P + p] -
          mul_rn(a.ed4, hyp);
      const long long cl = c + (4 + l) * P;
      if (mode == kRkLast) {
        a.out[cl] = safe_div(a.acc[cl] + mul_rn(cb, dtr), hn);
      } else {
        const T trh = mul_rn(a.base[cl], hb);
        if (mode == kRkFirst) a.acc_out[cl] = trh + mul_rn(cb, dtr);
        if (mode == kRkMid) a.acc_out[cl] = a.acc[cl] + mul_rn(cb, dtr);
        a.out[cl] = safe_div(trh + mul_rn(ca, dtr), hn);
      }
    }
  }
}

// D2's register budget: at least 4 blocks of 256 threads resident per SM
// (64 registers); the tangential slots in shared memory, each thread's own
// column, read through a volatile pointer at every use
template <typename T, bool UH, int TR, bool TAILS, bool SP>
__global__ void __launch_bounds__(256, 4) rk_pass_d_edges(
    const RkArgs<T> a) {
  constexpr bool kPair = UH || TR == kTrUpwind;
  __shared__ int s_ot[10][256];
  __shared__ T s_wt[10][256];
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const int t = blockIdx.z;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const int mode = a.mode;
  const T ca = a.dt, cb = a.cb;
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
  // tang(x) from the slots in shared memory
  const auto tang = [&](const T* x) {
    const volatile int* so = &s_ot[0][tid];
    const volatile T* sw = &s_wt[0][tid];
    T acc = T(0);
    _Pragma("unroll") for (int s = 0; s < 10; ++s)
      acc = acc + mul_rn(static_cast<T>(sw[s * 256]), x[p + so[s * 256]]);
    return acc;
  };
  if constexpr (TAILS) {
    load_w(a.w, kWCmean + 2 * t, a.P, p, wm);
    if constexpr (kPair) {
      load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
      load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    }
  }
  const T nu4s = mul_rn(a.nu4, cval(a, kS4, kCS4 + t, p));
  const T em = cval(a, kEm, kCEm + t, p);
  for (int k = k0; k < k1; ++k) {
    const long long q = (k * 3LL + t) * P + p;
    const T qe = sten(wvm, ov, a.qv + k * 2LL * P, p);
    const T tf = tang(a.flux + k * 3LL * P);
    const T cd4 = sten(wg, oc, a.divu + k * P, p);
    const T vd4 = sten(wvg, ov, a.rvort + k * 2LL * P, p);
    T du = (a.dup[q] - mul_rn(nu4s, mul_rn(a.dfac, cd4) - vd4)) +
           mul_rn(T(0.5), mul_rn(qe, tf));
    const T* ev = a.in + k * lay;
    if constexpr (TAILS) {
      const bool top = a.wind && k == 0, bottom = a.drag && k == a.K - 1;
      if (top || bottom) {
        T mean_hn;   // mean_h of pass A
        if constexpr (kPair) {
          mean_hn = mul_rn(T(0.5), sten(w0, oc, ev, p) +
                                       sten(w1, oc, ev, p));
        } else {
          mean_hn = sten(wm, oc, ev, p);
        }
        if (top)
          du = du + safe_div(a.cpl[(kCWind + t) * P + p],
                             mul_rn(a.rho0, mean_hn));
        if (bottom) {
          const T kee = sten(wm, oc, a.ke + k * P, p);
          const T two = T(2) * kee;
          const T speed = sqrt(two > T(0) ? two : T(0));
          du = du - safe_div(mul_rn(mul_rn(a.cd, speed),
                                    ev[(1 + t) * P + p]),
                             mean_hn);
        }
      }
    }
    du = du + mul_rn(T(0.5), tang(a.Fq + k * 3LL * P));
    if constexpr (SP) {
      a.out[q] = du;   // splitpre's du_out (K, 3, P), ungated
      continue;
    }
    const T md = masked(a, em, du);
    const long long c = k * lay + (1 + t) * P + p;
    if (mode == kRkLast) {
      a.out[c] = a.acc[c] + mul_rn(cb, md);
    } else {
      const T ub = a.base[c];
      if (mode == kRkFirst) a.acc_out[c] = ub + mul_rn(cb, md);
      if (mode == kRkMid) a.acc_out[c] = a.acc[c] + mul_rn(cb, md);
      a.out[c] = ub + mul_rn(ca, md);
    }
  }
}

// The stage's passes: A, B, C, D1 (cells; not with SP), D2 (edges, one
// launch of grid z = 3), each walking its own group of layers per thread
// (the fastest of 4, 8 and 16 for each pass at icos48 x 100 x 2 in float32
// on an H100: PERF.md, row 5c).
enum { kRkPassA = 0, kRkPassB, kRkPassC, kRkPassD1, kRkPassD2, kRkPasses };
constexpr int kRkPassLayers[kRkPasses] = {4, 4, 4, 8, 16};

// the kernel of pass `pass`, or null
template <typename T, bool UH, int TR, bool TAILS, bool SP>
const void* rk_pass_kernel(int pass) {
  switch (pass) {
    case kRkPassA:
      return reinterpret_cast<const void*>(rk_pass_a<T, UH, TR, SP>);
    case kRkPassB: return reinterpret_cast<const void*>(rk_pass_b<T, SP>);
    case kRkPassC: return reinterpret_cast<const void*>(rk_pass_c<T, SP>);
    case kRkPassD1:
      return SP ? nullptr
                : reinterpret_cast<const void*>(rk_pass_d_cells<T>);
    case kRkPassD2:
      return reinterpret_cast<const void*>(
          rk_pass_d_edges<T, UH, TR, TAILS, SP>);
    default: return nullptr;
  }
}

template <typename T, bool UH, int TR, bool TAILS, bool SP>
int rk_passes(const RkArgs<T>& a, int threads, cudaStream_t stream) {
  RkArgs<T> ap[kRkPasses];
  dim3 grid[kRkPasses];
  for (int i = 0; i < kRkPasses; ++i) {
    ap[i] = a;
    ap[i].kg = kRkPassLayers[i];
    grid[i] = dim3((a.P + threads - 1) / threads,
                   (a.K + kRkPassLayers[i] - 1) / kRkPassLayers[i],
                   i == kRkPassD2 ? 3 : 1);
  }
  cudaError_t err;
#define OMEGA_RK_CHECK()                                  \
  err = cudaGetLastError();                               \
  if (err != cudaSuccess) return static_cast<int>(err);
  rk_pass_a<T, UH, TR, SP><<<grid[0], threads, 0, stream>>>(ap[0]);
  OMEGA_RK_CHECK()
  rk_pass_b<T, SP><<<grid[1], threads, 0, stream>>>(ap[1]);
  OMEGA_RK_CHECK()
  rk_pass_c<T, SP><<<grid[2], threads, 0, stream>>>(ap[2]);
  OMEGA_RK_CHECK()
  if constexpr (!SP) {
    rk_pass_d_cells<T><<<grid[3], threads, 0, stream>>>(ap[3]);
    OMEGA_RK_CHECK()
  }
  rk_pass_d_edges<T, UH, TR, TAILS, SP><<<grid[4], threads, 0, stream>>>(
      ap[4]);
  OMEGA_RK_CHECK()
#undef OMEGA_RK_CHECK
  return 0;
}

// cudaFuncGetAttributes of pass `pass`: numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]
template <typename T, bool UH, int TR, bool TAILS, bool SP>
int rk_pass_attrs(int pass, int* out) {
  const void* k = rk_pass_kernel<T, UH, TR, TAILS, SP>(pass);
  if (k == nullptr || out == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

template <typename T, bool UH, int TR, bool TAILS>
int launch_rk(const void* ev, const void* base, const void* acc,
              void* acc_out, void* out, const void* off, const void* w,
              const void* cpl, void* work, const double* c, const int* n,
              cudaStream_t stream) {
  RkArgs<T> a;
  a.P = n[0];
  a.K = n[2];
  a.L = n[3];
  a.CH = 4 + a.L;
  const int threads = n[5];
  a.mode = n[8 + kNConst];
  if (a.P < 1 || a.K < 1 || a.L < 0 || threads < 32 ||
      threads > 256 || threads % 32 || a.mode < kRkProv || a.mode > kRkLast) {
    return cudaErrorInvalidValue;
  }
  // what each mode reads and writes; `out` is written out of place
  const bool need_base = a.mode != kRkLast;
  const bool need_acc = a.mode == kRkMid || a.mode == kRkLast;
  const bool need_acc_out = a.mode == kRkFirst || a.mode == kRkMid;
  if (ev == nullptr || out == nullptr || off == nullptr || w == nullptr ||
      cpl == nullptr || work == nullptr || (need_base && base == nullptr) ||
      (need_acc && acc == nullptr) || (need_acc_out && acc_out == nullptr) ||
      out == ev || out == base || out == acc || out == acc_out) {
    return cudaErrorInvalidValue;
  }
  a.in = static_cast<const T*>(ev);
  a.out = static_cast<T*>(out);
  a.base = static_cast<const T*>(base);
  a.acc = static_cast<const T*>(acc);
  a.acc_out = static_cast<T*>(acc_out);
  a.off = static_cast<const int*>(off);
  a.w = static_cast<const T*>(w);
  a.cpl = static_cast<const T*>(cpl);
  // work fields in the order of ops/patch_megastep.py:rk_work_fields
  const long long f = static_cast<long long>(a.K) * a.P;
  T* wp = static_cast<T*>(work);
  T** fields[] = {&a.flux, &a.hflux, &a.mc,    &a.ke,  &a.divu,
                  &a.rvort, &a.qv,   &a.dh,    &a.trp, &a.d2aux,
                  &a.dup,  &a.del2e, &a.Fq};
  const int width[] = {3, 3 * a.L, 3 * a.L, 1, 1, 2, 2, 1, a.L, a.L, 3, 3, 3};
  for (int i = 0; i < 13; ++i) {
    *fields[i] = wp;
    wp += width[i] * f;
  }
  a.dr2 = a.rvort;                               // pass C's reuse
  a.dt = static_cast<T>(c[0]);                   // ca
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
  a.cb = static_cast<T>(c[9 + kNConst]);
  a.wind = n[6 + kNConst];
  a.drag = n[7 + kNConst];
  if (!TAILS && (a.wind || a.drag)) return cudaErrorInvalidValue;
  return rk_passes<T, UH, TR, TAILS, false>(a, threads, stream);
}

}  // namespace patch
}  // namespace omega

// The C interface of one pair of flux types (FL: cc, uc, cu, uu = thickness
// then tracer flux, center or upwind), without and with the tails, in both
// precisions: omega_patch_rk_<FL>_<plain|tails>_<f32|f64>. `ev`, `base`,
// `acc`, `acc_out` and `out` are (K, 4+L, P) frames (base, acc, acc_out null
// where the mode does not take them), `off` / `w` / `cpl` the compact table
// and the const planes, `work` the scratch of rk_work_fields(L) (K, 1, P)
// fields; `consts` = ca, g, nu2, nu4, div_factor, eddy_diff2, eddy_diff4, the
// uniform values of f_vertex, gdepth, scal2, scal4, edge_mask, rho0, the
// drag coefficient, then cb; `ints` = P, S, K, L, layers per thread (the
// patch step's, not read: each pass walks kRkPassLayers), threads per
// block, one flag per const (1: a plane of `cpl`), wind and drag on (1) or
// off (0), then the mode. Returns the first refused launch's error code, or
// 0. omega_patch_rk_attrs_<FL>_<plain|tails>_<f32|f64>(pass, out): pass
// A ... D2's (0 ... 4) numRegs, localSizeBytes and sharedSizeBytes.
#define OMEGA_PATCH_RK_ENTRY(FL, TL, SUF, T, UH, TR, TAILS)                 \
  int omega_patch_rk_##FL##_##TL##_##SUF(                                    \
      const void* ev, const void* base, const void* acc, void* acc_out,      \
      void* out, const void* off, const void* w, const void* cpl,            \
      void* work, const double* consts, const int* ints, void* stream) {     \
    return omega::patch::launch_rk<T, UH, TR, TAILS>(                        \
        ev, base, acc, acc_out, out, off, w, cpl, work, consts, ints,        \
        static_cast<cudaStream_t>(stream));                                  \
  }                                                                          \
  int omega_patch_rk_attrs_##FL##_##TL##_##SUF(int pass, int* out) {       \
    return omega::patch::rk_pass_attrs<T, UH, TR, TAILS, false>(pass, out);  \
  }

#define OMEGA_PATCH_RK_VARIANTS(FL, UH, TR)                                 \
  extern "C" {                                                               \
  OMEGA_PATCH_RK_ENTRY(FL, plain, f32, float, UH, TR, false)                 \
  OMEGA_PATCH_RK_ENTRY(FL, tails, f32, float, UH, TR, true)                  \
  OMEGA_PATCH_RK_ENTRY(FL, plain, f64, double, UH, TR, false)                \
  OMEGA_PATCH_RK_ENTRY(FL, tails, f64, double, UH, TR, true)                 \
  }
