// Implicit vertical mixing on the sphere's frames: the PP81 coefficient pass
// and the column solves, after the horizontal passes of the patch step
// (patch_step.cuh) on the frames it wrote.
//
// Replaces the vertical-mixing tail of the TPU kernel
// omega_tpu/ops/patch_megastep.py:_kernel (kind `fb` with
// mesh/icos_mega._vmix_ops: the PP81 ops lanediff, dzhalf, pp_n2, pp_kc,
// pp_ne with their cmean and ke sweeps, and vmix_u / vmix_c / vmix_u_arr /
// vmix_c_arr, the lane-axis PCR of _pcr_diffusion; the reference runs them
// in its staged kind fb2b, called at patch_megastep.py:1425). That kernel
// holds all K of a tile on chip, on 128 lanes; here a thread of the
// horizontal passes walks a few layers and cannot see a column, so the tail
// is two kernels of its own. Frames are (K, 4+L, P); the compact table is
// patch_common.cuh's.
//
// patch_pp81_coeffs: one thread per frame position and group of layers, as
// the horizontal passes. At interface k (layers k and k+1) it evaluates
// core/vmix.pp81_coefficients expression for expression: kappa at the cell
// from N^2 (the linear EOS on T and S, the hole guard of pp_n2: 0 where
// dz = 0) and the shear of ke(du^2); nu at each edge class from cmean(N^2)
// and du / cmean(dz). The neighbours' dz and N^2 and the edges' du are
// recomputed where they are read, from h_new, the tracers and u_new, so the
// pass writes only its result, coef (K, 4, P): channel 0 kappa, 1..3 nu;
// layer K-1 is not written. f^n_exp is n_exp repeated multiplications, and
// every product the plain version rounds before an add is rounded here
// (mul_rn): the two products of the buoyancy difference above all, whose
// difference cancels where the column is near neutral (a fused
// multiply-add there moved nu by 1.6e-4 of its range in float32 on the
// plane). Bound: bytes, h_new, u_new, T and S read and the 4 coefficient
// fields written.
//
// patch_vmix_solve: backward-Euler diffusion of every column, in place on
// the frames: system 0 of a position is the L tracers against h_new,
// systems 1..3 the edge classes of u against cmean(h_new) (two reads
// through the compact table, each product rounded as the plain version
// rounds it). Solved by elimination in chunks (column_solve.cuh, which the
// planar solve shares; the plain version is the reference's PCR): a block
// takes cw adjacent positions (32 where the staging fits: a column has
// stride (4+L) P, neighbouring positions are contiguous, so every row's
// load and store is one 128-byte segment of a frame channel) and `lanes`
// k-lanes of at most kChunk rows; it stages the thickness (for an edge
// class h_new at both cmean sources), the coefficient channel and the
// right-hand sides in shared memory by cp.async; each lane eliminates its
// chunk in place, lane 0 solves the chunks' end rows by Thomas, and every
// row is finished from its chunk's two ends. All L tracers go in one pass
// where the staging fits (lc per pass, the sweeps compiled for kRhs = 2 or
// kFrameRhs values). Frames hold lattice holes (zeros) and positions no
// exact value depends on: a column whose thickness is not positive at
// every layer (dz = 0 would make G infinite) is left as it was, as the
// plain version leaves it. (PCR over every row, two divisions and 9 + 3n
// shared loads per row and level with 8 positions a block, took 26x its
// bytes on an H100.) Bound: bytes (h_new, u, tracers and coefficients read
// once, u and tracers written once).
#include "patch_common.cuh"
#include "column_solve.cuh"

namespace omega {
namespace patch {

// the solve: positions a block takes at most, and the widths its sweeps are
// compiled for (values per pass: 2, or up to kFrameRhs)
constexpr int kMaxColumns = 32;
constexpr int kSolveRhs = 2;
constexpr int kFrameRhs = 8;
template <typename T>
constexpr int kSolveMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <typename T>
struct VmixArgs {
  T dt, grav, nu0, alpha, a_t, b_s, kt0, km0;
  int P, K, L, CH, ti, si, n_exp, kg, cw, lanes, lc, rhs;
};

// NaN-propagating max(x, lo), as torch.clamp(min=lo) has it
template <typename T>
__device__ __forceinline__ T floor_at(T x, T lo) {
  return x < lo ? lo : x;
}

// nu0 / f^n_exp with f = 1 + alpha max(ri, 0); returns nu, sets f
template <typename T>
__device__ __forceinline__ T pp81_nu(const VmixArgs<T>& a, T ri, T& f) {
  f = T(1) + mul_rn(a.alpha, floor_at(ri, T(0)));
  T pw = T(1);
  for (int i = 0; i < a.n_exp; ++i) pw = pw * f;
  return a.nu0 / pw;
}

template <typename T>
__global__ void __launch_bounds__(256)
patch_pp81_coeffs(const T* __restrict__ fr, const int* __restrict__ off,
                  const T* __restrict__ w, T* __restrict__ coef,
                  const VmixArgs<T> a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.y * a.kg;
  const int k1 = min(a.K - 1, k0 + a.kg);
  if (p >= a.P) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const bool strat = a.ti >= 0 && a.si >= 0;
  const T eps = T(1.0e-16);
  int od[6], oc[3][2];
  T wk[6], wm[3][2];
  load_off(off, kOffDiv, a.P, p, od);
  load_w(w, kWKe, a.P, p, wk);
  for (int t = 0; t < 3; ++t) {
    load_off(off, kOffCm + 2 * t, a.P, p, oc[t]);
    load_w(w, kWCmean + 2 * t, a.P, p, wm[t]);
  }
  for (int k = k0; k < k1; ++k) {
    const T* const h0 = fr + k * lay;   // layer k: h_new, u_new, trn
    const T* const h1 = h0 + lay;       // layer k + 1
    // the cell's dz and N^2 at position q
    auto dz_at = [&](long long q) { return T(0.5) * (h0[q] + h1[q]); };
    auto n2_at = [&](long long q, T dz) {
      if (!strat) return T(0);
      const long long cT = (4 + a.ti) * P + q, cS = (4 + a.si) * P + q;
      const T db = a.grav * (mul_rn(a.a_t, h0[cT] - h1[cT]) -
                             mul_rn(a.b_s, h0[cS] - h1[cS]));
      const T n2 = safe_div(db, dz);
      return n2 > T(0) ? n2 : T(0);
    };
    // cell: kappa from N^2 and the shear of the KE average of du^2
    const T dz = dz_at(p);
    T ke = T(0);
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const long long q = P + p + od[s];
      const T d = h0[q] - h1[q];
      ke = ke + mul_rn(wk[s], mul_rn(d, d));
    }
    const T shear2_cell = T(2) * ke / mul_rn(dz, dz);
    T f;
    const T nu_c =
        pp81_nu(a, n2_at(p, dz) / floor_at(shear2_cell, eps), f);
    coef[(k * 4LL) * P + p] = nu_c / f + a.kt0;
    // edges: dz and N^2 averaged from the edge's two cells
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      T dz_e = T(0), n2_e = T(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const long long q = p + oc[t][s];
        const T dzq = dz_at(q);
        dz_e = dz_e + mul_rn(wm[t][s], dzq);
        n2_e = n2_e + mul_rn(wm[t][s], n2_at(q, dzq));
      }
      const long long e = (1 + t) * P + p;
      const T sh = (h0[e] - h1[e]) / dz_e;
      const T nu_e = pp81_nu(a, n2_e / floor_at(mul_rn(sh, sh), eps), f);
      coef[(k * 4LL + 1 + t) * P + p] = nu_e + a.km0;
    }
  }
}

template <typename T, int kRhs>
__global__ void __launch_bounds__(256, kSolveMinBlocks<T>)
patch_vmix_solve(T* __restrict__ fr, const int* __restrict__ off,
                 const T* __restrict__ w, const T* __restrict__ coef,
                 const VmixArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ok[kMaxColumns];
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const int sys = blockIdx.y;         // 0: tracers on cells, 1..3: u classes
  const int p = pos < a.P ? pos : a.P - 1;
  const long long P = a.P;
  ColumnSystem<T> c;
  // row k of channel ch at (k (4+L) + ch) P + p
  c.rows = ColumnRows{p, P, a.CH * P};
  c.cells = sys == 0;
  // thickness of the system: h_new, or cmean(h_new) for the edge class
  int o[2] = {0, 0};
  T wm[2] = {T(1), T(0)};
  if (sys > 0) {
    load_off(off, kOffCm + 2 * (sys - 1), a.P, p, o);
    load_w(w, kWCmean + 2 * (sys - 1), a.P, p, wm);
  }
  c.d0 = o[0];
  c.d1 = o[1];
  c.w0 = wm[0];
  c.w1 = wm[1];
  c.coef = coef ? coef + sys * P + p : nullptr;
  c.cstride = 4 * P;
  c.coef0 = sys == 0 ? a.kt0 : a.km0;
  c.dt = a.dt;
  c.K = a.K;
  c.ch0 = sys == 0 ? 4 : sys;
  c.nrhs = sys == 0 ? a.L : 1;
  c.lc = a.lc;
  c.live = pos < a.P;                 // ragged last group: compute, no store
  solve_columns<T, kRhs, true, true>(fr, c, reinterpret_cast<T*>(smem_raw),
                                     ok);
}

template <typename T>
bool unpack(const double* c, const int* n, VmixArgs<T>& a) {
  a.dt = static_cast<T>(c[0]);
  a.grav = static_cast<T>(c[1]);
  a.nu0 = static_cast<T>(c[2]);
  a.alpha = static_cast<T>(c[3]);
  a.a_t = static_cast<T>(c[4]);
  a.b_s = static_cast<T>(c[5]);
  a.kt0 = static_cast<T>(c[6]);
  a.km0 = static_cast<T>(c[7]);
  a.P = n[0];
  a.K = n[1];
  a.L = n[2];
  a.CH = 4 + a.L;
  a.ti = n[3];
  a.si = n[4];
  a.n_exp = n[5];
  a.kg = n[6];
  a.cw = n[8];
  a.lanes = n[9];
  a.lc = n[10];
  a.rhs = n[11];
  return a.P >= 1 && a.K >= 2 && a.L >= 0 && a.ti < a.L && a.si < a.L &&
         a.n_exp >= 0 && a.kg >= 1;
}

template <typename T>
int launch_coeffs(const void* fr, const void* off, const void* w, void* coef,
                  const double* c, const int* n, cudaStream_t stream) {
  VmixArgs<T> a;
  const int threads = n[7];
  if (!unpack(c, n, a) || threads < 32 || threads > 256 || threads % 32 ||
      fr == nullptr || off == nullptr || w == nullptr || coef == nullptr)
    return cudaErrorInvalidValue;
  const dim3 grid((a.P + threads - 1) / threads,
                  (a.K - 1 + a.kg - 1) / a.kg);
  patch_pp81_coeffs<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(fr), static_cast<const int*>(off),
      static_cast<const T*>(w), static_cast<T*>(coef), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
size_t solve_smem_bytes(const VmixArgs<T>& a) {
  return static_cast<size_t>(column_smem_elems(a.K, a.cw, a.lanes, a.lc)) *
         sizeof(T);
}

// the solve's plan: cw x lanes threads, every lane 2 .. kChunk rows, lc
// values per pass within the compiled width rhs (2 or kFrameRhs)
template <typename T>
bool solve_plan_ok(const VmixArgs<T>& a) {
  return a.cw >= 1 && a.cw <= kMaxColumns && a.lanes >= 1 &&
         a.cw * a.lanes <= 256 && 2 * a.lanes <= a.K &&
         a.lanes * kChunk >= a.K && a.lc >= 1 &&
         (a.rhs == kSolveRhs || a.rhs == kFrameRhs) && a.lc <= a.rhs;
}

template <typename T, int kRhs>
int launch_solve_as(void* fr, const void* off, const void* w,
                    const void* coef, const VmixArgs<T>& a,
                    cudaStream_t stream) {
  const size_t smem = solve_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      patch_vmix_solve<T, kRhs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.P + a.cw - 1) / a.cw, 4);
  const dim3 block(a.cw, a.lanes);
  patch_vmix_solve<T, kRhs><<<grid, block, smem, stream>>>(
      static_cast<T*>(fr), static_cast<const int*>(off),
      static_cast<const T*>(w), static_cast<const T*>(coef), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(void* fr, const void* off, const void* w, const void* coef,
                 const double* c, const int* n, cudaStream_t stream) {
  VmixArgs<T> a;
  if (!unpack(c, n, a) || !solve_plan_ok(a) || fr == nullptr ||
      off == nullptr || w == nullptr)
    return cudaErrorInvalidValue;
  return a.rhs == kSolveRhs
             ? launch_solve_as<T, kSolveRhs>(fr, off, w, coef, a, stream)
             : launch_solve_as<T, kFrameRhs>(fr, off, w, coef, a, stream);
}

// cudaFuncGetAttributes of the solve kernel the plan in `n` launches
// (numRegs, localSizeBytes, sharedSizeBytes into out[0..2]) and the blocks
// an SM holds for it (out[3], cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T, int kRhs>
int solve_attrs_as(const VmixArgs<T>& a, int* out) {
  auto* const k = &patch_vmix_solve<T, kRhs>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = solve_smem_bytes(a);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      a.cw * a.lanes, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

template <typename T>
int solve_attrs(const double* c, const int* n, int* out) {
  VmixArgs<T> a;
  if (c == nullptr || n == nullptr || out == nullptr || !unpack(c, n, a) ||
      !solve_plan_ok(a))
    return cudaErrorInvalidValue;
  return a.rhs == kSolveRhs ? solve_attrs_as<T, kSolveRhs>(a, out)
                            : solve_attrs_as<T, kFrameRhs>(a, out);
}

}  // namespace patch
}  // namespace omega

// The C interface, in both precisions. `frames` are the (K, 4+L, P) frames
// the horizontal passes wrote, `off` / `w` the compact table, `coef` the
// (K, 4, P) coefficients (null in the solve for constant coefficients);
// `consts` = dt, g, nu0, alpha, eos_alpha_t, eos_beta_s, kappa_tracer,
// kappa_momentum; `ints` = P, K, L, temp_index, salt_index, n_exp, layers
// per thread, threads per block (coefficients), then cw, lanes, lc, rhs
// (solve: positions per block, k-lanes, values per pass, the compiled
// width 2 or 8). Each returns the launch's error code, or 0.
// omega_patch_vmix_solve_attrs_*(consts, ints, out): registers, local
// (spill) bytes, static shared bytes and blocks per SM of the solve kernel
// for that plan.
// omega_patch_rows(0 | 1 | 2) gives the row counts of the compact table's
// offsets and weights and of the const planes.
extern "C" {

int omega_patch_pp81_f32(const void* frames, const void* off, const void* w,
                         void* coef, const double* consts, const int* ints,
                         void* stream) {
  return omega::patch::launch_coeffs<float>(
      frames, off, w, coef, consts, ints, static_cast<cudaStream_t>(stream));
}
int omega_patch_pp81_f64(const void* frames, const void* off, const void* w,
                         void* coef, const double* consts, const int* ints,
                         void* stream) {
  return omega::patch::launch_coeffs<double>(
      frames, off, w, coef, consts, ints, static_cast<cudaStream_t>(stream));
}
int omega_patch_vmix_solve_f32(void* frames, const void* off, const void* w,
                               const void* coef, const double* consts,
                               const int* ints, void* stream) {
  return omega::patch::launch_solve<float>(
      frames, off, w, coef, consts, ints, static_cast<cudaStream_t>(stream));
}
int omega_patch_vmix_solve_f64(void* frames, const void* off, const void* w,
                               const void* coef, const double* consts,
                               const int* ints, void* stream) {
  return omega::patch::launch_solve<double>(
      frames, off, w, coef, consts, ints, static_cast<cudaStream_t>(stream));
}

int omega_patch_vmix_solve_attrs_f32(const double* consts, const int* ints,
                                     int* out) {
  return omega::patch::solve_attrs<float>(consts, ints, out);
}
int omega_patch_vmix_solve_attrs_f64(const double* consts, const int* ints,
                                     int* out) {
  return omega::patch::solve_attrs<double>(consts, ints, out);
}

int omega_patch_rows(int which) {
  return which == 0   ? omega::patch::kOffRows
         : which == 1 ? omega::patch::kWRows
                      : omega::patch::kCRows;
}

}  // extern "C"
