// The split-explicit step's two patch kernels on the icosahedral sphere,
// splitpre and splitpost, each a group of launches made by one C call, in
// both precisions, center fluxes (the configurations of
// ops/patch_megastep.split_patch_supported).
//
// Replaces the TPU kernel omega_tpu/ops/patch_megastep.py:_kernel in the
// kinds `splitpre` and `splitpost` (split_patch_megastep_framed, :2131; the
// chains mesh/icos_mega.split_pre_chain and split_post_chain), called at
// patch_megastep.py:1411-1413. State and outputs are the frames of
// ops/patch_megastep.py, (K, 4+L, P) with P = 10 S S positions; the table
// layout is patch_common.cuh's.
//
// splitpre (five launches): the full 3-D velocity tendency at the level `in`
// with the column free surface, written whole and ungated into `out` (K, 3,
// P), as the reference's kernel emits du_out. The pressure gradient reads
// g cgrad(sshc) with sshc = sum_k h - depth, which couples all K layers of a
// column while a thread of the patch passes walks a group of them;
// so a pass of its own (one thread per position, the column summed layer by
// layer from the top, as ops/patch_megastep._eval sums it) writes the (1, P)
// field first, as the planar port's split_columns pass does (split.cu). Then
// the momentum passes of the RK stage (patch_rk.cuh, switch SP): A the level-1
// stencils, B the gradients and the column pressure gradient, C dd2 / dr2, D
// the deepest stencils and du.
//
// splitpost (four launches): passes A, B, C and D1 of the FB step
// (patch_step.cuh, switch MOM off; D1 is D's cell section): h_new and the
// tracers, with the transport velocity in the u channels of `in`, into
// channels 0 and 4.. of `out`; its u channels are the caller's.
//
// Bound on this card: device memory. splitpre must read h, u and the
// momentum weights and write du (port_bounds.patch_split: 88.7 MB at icos48
// x 100 x 2 in float32, 0.0265 ms), splitpost read h, u, the tracers and the
// thickness and tracer weights and write h and the tracers (84.3 MB, 0.0252
// ms); the launches also write and read the intermediates, which this first
// version does not keep on chip.
#include "patch_rk.cuh"

namespace omega {
namespace patch {

// sshc[p] = sum_k h[k, p] - depth (the layer sum from k = 0 up)
template <typename T>
__global__ void __launch_bounds__(256)
ssh_column(const T* __restrict__ in, T* __restrict__ sshc,
           const T* __restrict__ depth_row, T depth, int P, int K, int CH) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long lay = static_cast<long long>(CH) * P;
  T s = in[p];
  for (int k = 1; k < K; ++k) s = s + in[k * lay + p];
  sshc[p] = s - (depth_row != nullptr ? depth_row[p] : depth);
}

// the patch step's scalars and sizes (Args) from the C call's consts and ints
// (ops/patch_megastep._fb_args); false where a size is refused
template <typename T>
bool fill_args(Args<T>& a, const void* in, void* out, const void* off,
               const void* w, const void* cpl, const double* c, const int* n,
               int& threads) {
  a.P = n[0];
  a.K = n[2];
  a.L = n[3];
  a.CH = 4 + a.L;
  threads = n[5];
  if (a.P < 1 || a.K < 1 || a.L < 0 || threads < 32 ||
      threads > 256 || threads % 32 || in == nullptr || out == nullptr ||
      off == nullptr || w == nullptr || cpl == nullptr || in == out) {
    return false;
  }
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.off = static_cast<const int*>(off);
  a.w = static_cast<const T*>(w);
  a.cpl = static_cast<const T*>(cpl);
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
  return a.wind == 0 && a.drag == 0;
}

#define OMEGA_SPLIT_PASS(I, ...)                              \
  __VA_ARGS__<<<grid[I], threads, 0, stream>>>(ap[I]);         \
  err = cudaGetLastError();                                    \
  if (err != cudaSuccess) return static_cast<int>(err);

template <typename T>
int launch_split_pre(const void* in, void* out, const void* off,
                     const void* w, const void* cpl, const void* depth_row,
                     void* work, const double* c, const int* n,
                     cudaStream_t stream) {
  RkArgs<T> a{};
  int threads;
  if (!fill_args<T>(a, in, out, off, w, cpl, c, n, threads) ||
      work == nullptr || (n[8 + kNConst] != 0) != (depth_row != nullptr)) {
    return cudaErrorInvalidValue;
  }
  // work fields in the order of ops/patch_megastep.py:split_work_fields
  const long long f = static_cast<long long>(a.K) * a.P;
  T* wp = static_cast<T*>(work);
  T** fields[] = {&a.flux, &a.ke, &a.divu, &a.rvort, &a.qv,
                  &a.dup,  &a.del2e, &a.Fq, &a.sshc};
  const int width[] = {3, 1, 1, 2, 2, 3, 3, 3, 1};
  for (int i = 0; i < 9; ++i) {
    *fields[i] = wp;
    wp += width[i] * f;
  }
  a.dr2 = a.rvort;                               // pass C's reuse
  const int blocks = (a.P + threads - 1) / threads;
  ssh_column<T><<<blocks, threads, 0, stream>>>(
      a.in, a.sshc, static_cast<const T*>(depth_row),
      static_cast<T>(c[9 + kNConst]), a.P, a.K, a.CH);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return rk_passes<T, false, kTrCenter, false, true>(a, threads, stream);
}

// cudaFuncGetAttributes of splitpre's pass `pass` (0 the column pass, 1 + i
// the RK stage's pass i; D1 refused): numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]
template <typename T>
int split_pre_attrs(int pass, int* out) {
  if (pass == 0) {
    if (out == nullptr) return cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(
        &fa, reinterpret_cast<const void*>(ssh_column<T>));
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = static_cast<int>(fa.localSizeBytes);
    out[2] = static_cast<int>(fa.sharedSizeBytes);
    return 0;
  }
  return rk_pass_attrs<T, false, kTrCenter, false, true>(pass - 1, out);
}

template <typename T>
int launch_split_post(const void* in, void* out, const void* off,
                      const void* w, const void* cpl, void* work,
                      const double* c, const int* n, cudaStream_t stream) {
  Args<T> a{};
  int threads;
  if (!fill_args<T>(a, in, out, off, w, cpl, c, n, threads) ||
      work == nullptr) {
    return cudaErrorInvalidValue;
  }
  // work fields in the order of ops/patch_megastep.py:split_work_fields
  const long long f = static_cast<long long>(a.K) * a.P;
  T* wp = static_cast<T*>(work);
  T** fields[] = {&a.flux, &a.hflux, &a.mc, &a.trp, &a.d2aux};
  const int width[] = {3, 3 * a.L, 3 * a.L, a.L, a.L};
  for (int i = 0; i < 5; ++i) {
    *fields[i] = wp;
    wp += width[i] * f;
  }
  Args<T> ap[kFbPassD1 + 1];
  dim3 grid[kFbPassD1 + 1];
  for (int i = 0; i <= kFbPassD1; ++i)
    fb_pass_args(a, threads, i, ap[i], grid[i]);
  cudaError_t err;
  OMEGA_SPLIT_PASS(kFbPassA, pass_a<T, false, kTrCenter, false>)
  OMEGA_SPLIT_PASS(kFbPassB, pass_b<T, kTrCenter, false>)
  OMEGA_SPLIT_PASS(kFbPassC, pass_c<T, false, kTrCenter, false>)
  OMEGA_SPLIT_PASS(kFbPassD1, pass_d_cells<T, kTrCenter>)
  return 0;
}

#undef OMEGA_SPLIT_PASS

// kernel_attrs of splitpost's pass `pass` (A, B, C, D1: 0 ... 3)
template <typename T>
int split_post_attrs(int pass, int threads, int* out) {
  const void* k =
      pass == kFbPassA
          ? reinterpret_cast<const void*>(pass_a<T, false, kTrCenter, false>)
      : pass == kFbPassB
          ? reinterpret_cast<const void*>(pass_b<T, kTrCenter, false>)
      : pass == kFbPassC
          ? reinterpret_cast<const void*>(pass_c<T, false, kTrCenter, false>)
      : pass == kFbPassD1
          ? reinterpret_cast<const void*>(pass_d_cells<T, kTrCenter>)
          : nullptr;
  return kernel_attrs(k, threads, out);
}

}  // namespace patch
}  // namespace omega

// omega_patch_split_pre_<f32|f64>(in, out, off, w, cpl, depth_row, work,
// consts, ints, stream): `in` the (K, 4+L, P) frames, `out` du_out (K, 3,
// P), `depth_row` the (P,) depth plane or null where the depth is uniform;
// omega_patch_split_post_<f32|f64>(in, out, off, w, cpl, work, consts, ints,
// stream): `in` the frames with the transport velocity in their u channels,
// `out` the next frames (channels 0 and 4.. written). `work` the scratch of
// split_work_fields(L) (K, 1, P) fields; `consts` and `ints` the patch
// step's (ops/patch_megastep._fb_args: dt, g, nu2, nu4, div_factor,
// eddy_diff2, eddy_diff4, the uniform consts, rho0, the drag coefficient;
// P, S, K, L, layers per thread, threads per block, the const flags, wind
// and drag off) followed by the uniform depth and its flag (1: `depth_row`;
// the layers per thread are not read: splitpre's RK passes walk
// patch_rk.cuh's kRkPassLayers, splitpost's passes patch_step.cuh's
// kFbPassLayers). Returns the first refused launch's error code, or 0.
// omega_patch_split_pre_attrs_<f32|f64>(pass, out): see split_pre_attrs;
// omega_patch_split_post_attrs_<f32|f64>(pass, threads, out): see
// split_post_attrs.
extern "C" {
#define OMEGA_SPLIT_ENTRIES(SUF, T)                                           \
  int omega_patch_split_pre_##SUF(                                            \
      const void* in, void* out, const void* off, const void* w,              \
      const void* cpl, const void* depth_row, void* work,                     \
      const double* consts, const int* ints, void* stream) {                  \
    return omega::patch::launch_split_pre<T>(                                 \
        in, out, off, w, cpl, depth_row, work, consts, ints,                  \
        static_cast<cudaStream_t>(stream));                                   \
  }                                                                           \
  int omega_patch_split_pre_attrs_##SUF(int pass, int* out) {                 \
    return omega::patch::split_pre_attrs<T>(pass, out);                       \
  }                                                                           \
  int omega_patch_split_post_attrs_##SUF(int pass, int threads, int* out) {   \
    return omega::patch::split_post_attrs<T>(pass, threads, out);             \
  }                                                                           \
  int omega_patch_split_post_##SUF(                                           \
      const void* in, void* out, const void* off, const void* w,              \
      const void* cpl, void* work, const double* consts, const int* ints,     \
      void* stream) {                                                         \
    return omega::patch::launch_split_post<T>(                                \
        in, out, off, w, cpl, work, consts, ints,                             \
        static_cast<cudaStream_t>(stream));                                   \
  }
OMEGA_SPLIT_ENTRIES(f32, float)
OMEGA_SPLIT_ENTRIES(f64, double)
#undef OMEGA_SPLIT_ENTRIES
}
