// FCT on the icosahedral sphere, stage B: the Zalesak limiter of
// mesh/icos_mega.fct_stage_b_chain on the persistent halo frames, in four
// launches made by one C call, with center or upwind thickness flux, in both
// precisions.
//
// Replaces the TPU kernel omega_tpu/ops/patch_megastep.py:_kernel, kind
// `fctb` (called at patch_megastep.py:1425 from fct_patch_megastep_framed
// :1797). Inputs: `mid`, stage A's output after the refresh (K, 4+2L, P):
// h_new at channel 0, trtd{l} at 4+2l, facc{l} at 5+2l; and the original
// frames `in` (K, 4+L, P) for h, u and the tracers (the reference
// concatenates the two; here they stay two arrays). Output: trn{l} into
// channel 4+l of `out` (K, 4+L, P); its other channels are not touched. The
// table layout is patch_common.cuh's, with an FCT prep's appended rows.
//
// Passes (a level that reads a neighbour's value waits for the pass that
// wrote it; the whole frame is evaluated, exact wherever the reference's
// tiled masks say, mesh/icos_mega.ensure_fct):
//   1 edges: mflux = mask flux_h u (flux_h = cmean(h), or the upwind pick
//     of c0(h), c1(h)); per tracer t0, t1 = c0(tr), c1(tr),
//     flo = upwind_mean(u, t0, t1) mflux, fa = 0.5 (t0 + t1) mflux - flo
//   2 cells: p_in = dt (div_neg(fa+) + div_pos(fa-)), p_out = dt
//     (div_pos(fa+) + div_neg(fa-)) (fa+- the relu'd parts, taken as the
//     budgets read them); tmax / tmin over the cell and its six picks of tr
//     and trtd; r_in = clip((tmax - trtd) h_new / max(p_in, 1e-30), 0, 1),
//     r_out from (trtd - tmin) h_new and p_out
//   3 edges: fc = flo + C fa, C = min(r_in(c1), r_out(c0)) where fa >= 0,
//     else min(r_in(c0), r_out(c1)) (into flo's field)
//   4 cells: trn = (facc - dt div(fc)) / h_new
// The picks coc{j} are single-slot stencils: weight 1 at every position the
// pick resolves (a pentagon's padded slot is the cell itself), 0 where it
// does not, read as w x[p + o] like the plain version reads them, so a pick
// that does not resolve gives 0 in kernel and plain version alike (such a
// position is not exact, and the refresh rewrites it). Every product the
// plain version rounds is rounded on its own (mul_rn), stencil sums run in
// its order, and the divisions by h_new are guarded (a zero h_new, a
// lattice hole, gives 0), as _safe_div does.
//
// Bound on this card: device memory. The call must read h, u and the
// tracers, h_new, trtd and facc once and write the tracers once, plus the
// table rows it reads (port_bounds.patch_fct); this first version also
// writes and reads its intermediates (8 L fields of K P: fa, flo / fc,
// r_in, r_out) through device memory.
#include "patch_common.cuh"

namespace omega {
namespace patch {
namespace fct {

template <typename T>
struct Args {
  const T* mid;   // (K, 4+2L, P): h_new, ., ., ., trtd0, facc0, trtd1, ...
  const T* in;    // (K, 4+L, P): h, u x3, tracers
  T* out;         // (K, 4+L, P): trn{l} into channel 4+l
  const int* off;
  const T* w;
  T *fa, *flo, *rin, *rout;   // work: (K, 3L, P) x2, (K, L, P) x2
  T dt, em;       // the edge mask where it is uniform
  const T* empl;  // else its (3, P) rows
  int P, K, L, kg;
};

template <typename T>
__device__ __forceinline__ bool where(const Args<T>& a, int& p, int& k0,
                                      int& k1) {
  p = blockIdx.x * blockDim.x + threadIdx.x;
  k0 = blockIdx.y * a.kg;
  k1 = min(a.K, k0 + a.kg);
  return p < a.P;
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return b > a ? b : a; }
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }

// ------------------------------------------------------ pass 1 (edges)
template <typename T, bool UH>
__global__ void __launch_bounds__(256) pass_flux(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = (4LL + a.L) * P;
  const int L = a.L;
  for (int t = 0; t < 3; ++t) {
    int o[2];
    T wm[2], w0[2], w1[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, o);
    load_w(a.w, kWCmean + 2 * t, a.P, p, wm);
    load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
    load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    const T em = a.empl ? a.empl[t * P + p] : a.em;
    const bool unmasked = !a.empl && a.em == T(1);
    for (int k = k0; k < k1; ++k) {
      const T* h = a.in + k * lay;
      const T u = h[(1 + t) * P + p];
      T flux_h;
      if constexpr (UH) {
        const T hp0 = sten(w0, o, h, p), hp1 = sten(w1, o, h, p);
        flux_h = u > T(0) ? hp0 : (u < T(0) ? hp1 : (hp0 < hp1 ? hp1 : hp0));
      } else {
        flux_h = sten(wm, o, h, p);
      }
      const T flux = mul_rn(flux_h, u);
      const T mflux = unmasked ? flux : mul_rn(flux, em);
      for (int l = 0; l < L; ++l) {
        const T* tr = h + (4 + l) * P;
        const T t0 = sten(w0, o, tr, p), t1 = sten(w1, o, tr, p);
        const T mean = mul_rn(T(0.5), t0 + t1);
        const T lo = mul_rn(u > T(0) ? t0 : (u < T(0) ? t1 : mean), mflux);
        const long long q = (k * 3LL * L + 3 * l + t) * P + p;
        a.fa[q] = mul_rn(mean, mflux) - lo;
        a.flo[q] = lo;
      }
    }
  }
}

// ------------------------------------------------------ pass 2 (cells)
template <typename T>
__global__ void __launch_bounds__(256) pass_ratios(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = (4LL + a.L) * P, laym = (4LL + 2 * a.L) * P;
  const int L = a.L;
  int od[6], oc[6];
  T wp[6], wn[6], wc[6];
  load_off(a.off, kOffFdiv, a.P, p, od);
  load_w(a.w, kWDpos, a.P, p, wp);
  load_w(a.w, kWDneg, a.P, p, wn);
  load_off(a.off, kOffCoc, a.P, p, oc);
  load_w(a.w, kWCoc, a.P, p, wc);
  for (int k = k0; k < k1; ++k) {
    const T hn = a.mid[k * laym + p];
    for (int l = 0; l < L; ++l) {
      // the budgets from the relu'd antidiffusive flux, slot by slot in the
      // plain version's order: div_neg(fa+), div_pos(fa-), div_pos(fa+),
      // div_neg(fa-)
      const T* fa = a.fa + (k * 3LL * L + 3 * l) * P;
      T nbp = T(0), pbn = T(0), pbp = T(0), nbn = T(0);
      _Pragma("unroll") for (int s = 0; s < 6; ++s) {
        const T x = fa[p + od[s]];
        const T bp = x > T(0) ? x : T(0), bn = -x > T(0) ? -x : T(0);
        nbp = nbp + mul_rn(wn[s], bp);
        pbn = pbn + mul_rn(wp[s], bn);
        pbp = pbp + mul_rn(wp[s], bp);
        nbn = nbn + mul_rn(wn[s], bn);
      }
      const T p_in = mul_rn(a.dt, nbp + pbn);
      const T p_out = mul_rn(a.dt, pbp + nbn);
      // the bounds: the fold of the reference's chain, self first, then per
      // neighbour slot the old field's pick and the transported field's
      const T* tr = a.in + k * lay + (4 + l) * P;
      const T* td = a.mid + k * laym + (4 + 2 * l) * P;
      T tmax = vmax(tr[p], td[p]), tmin = vmin(tr[p], td[p]);
      _Pragma("unroll") for (int j = 0; j < 6; ++j) {
        const T nt = mul_rn(wc[j], tr[p + oc[j]]);
        tmax = vmax(tmax, nt);
        tmin = vmin(tmin, nt);
        const T nd = mul_rn(wc[j], td[p + oc[j]]);
        tmax = vmax(tmax, nd);
        tmin = vmin(tmin, nd);
      }
      const T q_in = mul_rn(tmax - td[p], hn);
      const T q_out = mul_rn(td[p] - tmin, hn);
      const T r_in = q_in / (p_in > T(1e-30) ? p_in : T(1e-30));
      const T r_out = q_out / (p_out > T(1e-30) ? p_out : T(1e-30));
      const long long q = (k * static_cast<long long>(L) + l) * P + p;
      a.rin[q] = r_in < T(0) ? T(0) : (r_in > T(1) ? T(1) : r_in);
      a.rout[q] = r_out < T(0) ? T(0) : (r_out > T(1) ? T(1) : r_out);
    }
  }
}

// ------------------------------------------------------ pass 3 (edges)
template <typename T>
__global__ void __launch_bounds__(256) pass_limit(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P;
  const int L = a.L;
  for (int t = 0; t < 3; ++t) {
    int o[2];
    T w0[2], w1[2];
    load_off(a.off, kOffCm + 2 * t, a.P, p, o);
    load_w(a.w, kWC0 + 2 * t, a.P, p, w0);
    load_w(a.w, kWC1 + 2 * t, a.P, p, w1);
    for (int k = k0; k < k1; ++k) {
      for (int l = 0; l < L; ++l) {
        // fa >= 0 moves mass from c0 to c1: c1's r_in and c0's r_out
        const long long c = (k * static_cast<long long>(L) + l) * P;
        const T ri0 = sten(w0, o, a.rin + c, p);
        const T ri1 = sten(w1, o, a.rin + c, p);
        const T ro0 = sten(w0, o, a.rout + c, p);
        const T ro1 = sten(w1, o, a.rout + c, p);
        const long long q = (k * 3LL * L + 3 * l + t) * P + p;
        const T fa = a.fa[q];
        const T lim = fa >= T(0) ? vmin(ri1, ro0) : vmin(ri0, ro1);
        a.flo[q] = a.flo[q] + mul_rn(lim, fa);
      }
    }
  }
}

// ------------------------------------------------------ pass 4 (cells)
template <typename T>
__global__ void __launch_bounds__(256) pass_tracers(const Args<T> a) {
  int p, k0, k1;
  if (!where(a, p, k0, k1)) return;
  const long long P = a.P, lay = (4LL + a.L) * P, laym = (4LL + 2 * a.L) * P;
  const int L = a.L;
  int o[6];
  T wv[6];
  load_off(a.off, kOffDiv, a.P, p, o);
  load_w(a.w, kWDiv, a.P, p, wv);
  for (int k = k0; k < k1; ++k) {
    const T hn = a.mid[k * laym + p];
    for (int l = 0; l < L; ++l) {
      const T adv = sten(wv, o, a.flo + (k * 3LL * L + 3 * l) * P, p);
      const T facc = a.mid[k * laym + (5 + 2 * l) * P + p];
      a.out[k * lay + (4 + l) * P + p] =
          safe_div(facc + mul_rn(-a.dt, adv), hn);
    }
  }
}

template <typename T, bool UH>
int launch(const void* mid, const void* in, void* out, const void* off,
           const void* w, const void* cpl, void* work, const double* c,
           const int* n, cudaStream_t stream) {
  Args<T> a;
  a.P = n[0];
  a.K = n[2];
  a.L = n[3];
  a.kg = n[4];
  const int threads = n[5];
  if (a.P < 1 || a.K < 1 || a.L < 1 || a.kg < 1 || threads < 32 ||
      threads > 256 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  if (mid == nullptr || in == nullptr || out == nullptr || off == nullptr ||
      w == nullptr || cpl == nullptr || work == nullptr || out == mid ||
      out == in) {
    return cudaErrorInvalidValue;
  }
  a.mid = static_cast<const T*>(mid);
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.off = static_cast<const int*>(off);
  a.w = static_cast<const T*>(w);
  a.dt = static_cast<T>(c[0]);
  a.em = static_cast<T>(c[1]);
  a.empl = n[6] ? static_cast<const T*>(cpl) + static_cast<long long>(kCEm) *
                                                    a.P
                : nullptr;
  // work fields in the order of ops/patch_megastep.py:fct_b_work_fields
  const long long f = static_cast<long long>(a.K) * a.P;
  T* wp = static_cast<T*>(work);
  a.fa = wp;
  a.flo = wp + 3 * a.L * f;
  a.rin = wp + 6 * a.L * f;
  a.rout = wp + 7 * a.L * f;
  const dim3 grid((a.P + threads - 1) / threads, (a.K + a.kg - 1) / a.kg);
  cudaError_t err;
#define OMEGA_PASS(...)                                 \
  __VA_ARGS__<<<grid, threads, 0, stream>>>(a);         \
  err = cudaGetLastError();                             \
  if (err != cudaSuccess) return static_cast<int>(err);
  OMEGA_PASS(pass_flux<T, UH>)
  OMEGA_PASS(pass_ratios<T>)
  OMEGA_PASS(pass_limit<T>)
  OMEGA_PASS(pass_tracers<T>)
#undef OMEGA_PASS
  return 0;
}

// kernel_attrs of pass `pass` (flux, ratios, limit, tracers: 0 ... 3)
template <typename T, bool UH>
int pass_attrs(int pass, int threads, int* out) {
  const void* k =
      pass == 0   ? reinterpret_cast<const void*>(pass_flux<T, UH>)
      : pass == 1 ? reinterpret_cast<const void*>(pass_ratios<T>)
      : pass == 2 ? reinterpret_cast<const void*>(pass_limit<T>)
      : pass == 3 ? reinterpret_cast<const void*>(pass_tracers<T>)
                  : nullptr;
  return kernel_attrs(k, threads, out);
}

}  // namespace fct
}  // namespace patch
}  // namespace omega

// The C interface: omega_patch_fct_b_<c|u>_<f32|f64> (center or upwind
// thickness flux). `mid` is stage A's refreshed (K, 4+2L, P) output, `in`
// the original (K, 4+L, P) frames, `out` the next frames (channels 4.. are
// written), `off` / `w` / `cpl` the compact table of an FCT prep and the
// const planes, `work` the scratch of fct_b_work_fields(L) (K, 1, P) fields;
// `consts` = dt, the edge mask's value where it is uniform; `ints` = P, S,
// K, L, layers per thread, threads per block, 1 when the edge mask is a
// plane of `cpl`. Returns the first refused launch's error code, or 0.
// omega_patch_fct_b_attrs_<c|u>_<f32|f64>(pass, threads, out): registers,
// local (spill) and static shared bytes of pass `pass` and the blocks of
// `threads` threads an SM holds (out[0..3]). omega_patch_fct_rows(0 | 1)
// gives the row counts of an FCT prep's compact offsets and weights.
#define OMEGA_FCT_ENTRY(FL, SUF, T, UH)                                      \
  int omega_patch_fct_b_##FL##_##SUF(                                        \
      const void* mid, const void* in, void* out, const void* off,           \
      const void* w, const void* cpl, void* work, const double* consts,      \
      const int* ints, void* stream) {                                       \
    return omega::patch::fct::launch<T, UH>(                                 \
        mid, in, out, off, w, cpl, work, consts, ints,                       \
        static_cast<cudaStream_t>(stream));                                  \
  }                                                                          \
  int omega_patch_fct_b_attrs_##FL##_##SUF(int pass, int threads, int* out) { \
    return omega::patch::fct::pass_attrs<T, UH>(pass, threads, out);         \
  }

extern "C" {
OMEGA_FCT_ENTRY(c, f32, float, false)
OMEGA_FCT_ENTRY(u, f32, float, true)
OMEGA_FCT_ENTRY(c, f64, double, false)
OMEGA_FCT_ENTRY(u, f64, double, true)

int omega_patch_fct_rows(int which) {
  return which == 0 ? omega::patch::kOffFctRows : omega::patch::kWFctRows;
}
}  // extern "C"
