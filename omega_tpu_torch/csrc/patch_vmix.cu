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
// patch_pp81_coeffs: one thread per frame position and group of
// kCoefLayers interfaces. At interface k (layers k and k+1) it evaluates
// core/vmix.pp81_coefficients expression for expression: kappa at the cell
// from N^2 (the linear EOS on T and S, the hole guard of pp_n2: 0 where
// dz = 0) and the shear of ke(du^2); nu at each edge class from cmean(N^2)
// and du / cmean(dz). The neighbours' dz and N^2 and the edges' du are
// formed where they are read, from h_new, the tracers and u_new, so the
// pass writes only its result, coef (K, 4, P): channel 0 kappa, 1..3 nu;
// layer K-1 is not written. Design for this card: the thread walks its
// position's column and loads every value it reads once per layer (about
// 18 loads an interface, where forming every source's dz and N^2 anew
// from memory took 60): its own h, T, S and three u, u at the ke slots
// that name no edge of its own, and h, T, S at the other cmean source of
// each edge class. It stages them by cp.async into its own column of the
// block's shared memory a layer ahead of the interface that reads them
// (layers k and k+1 read, k+2 in flight; no other thread reads them, so
// no barrier), which holds no register while the loads are in flight:
// carried in registers instead, the layers took 128 registers and spilled.
// The cell's dz and N^2 are formed once per interface and serve every
// cmean slot whose offset is 0 (almost everywhere one of an edge's two); a
// slot that is neither the position nor the staged source (none on the
// meshes built here) reads both layers from memory. The table's offsets
// stay per position, so seams and pentagons take the same code. f^n_exp is
// n_exp repeated multiplications (compiled in for PP81's default 2), and
// every product the plain version rounds before an add is rounded here
// (mul_rn): the two products of the buoyancy difference above all, whose
// difference cancels where the column is near neutral (a fused
// multiply-add there moved nu by 1.6e-4 of its range in float32 on the
// plane). Bound: bytes, h_new, u_new, T and S read and the 4 coefficient
// fields written; its time goes mostly to its arithmetic, some 17 IEEE
// divisions an interface, rounded as the plain version rounds them
// (PERF.md).
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

// nu0 / f^n_exp with f = 1 + alpha max(ri, 0); returns nu, sets f.
// kNexp >= 0 is the exponent compiled in (the products unrolled), -1 reads
// a.n_exp
template <int kNexp, typename T>
__device__ __forceinline__ T pp81_nu(const VmixArgs<T>& a, T ri, T& f) {
  f = T(1) + mul_rn(a.alpha, floor_at(ri, T(0)));
  T pw = T(1);
  if constexpr (kNexp >= 0) {
#pragma unroll
    for (int i = 0; i < kNexp; ++i) pw = pw * f;
  } else {
    for (int i = 0; i < a.n_exp; ++i) pw = pw * f;
  }
  return a.nu0 / pw;
}

// interfaces a thread of the coefficient kernel walks (the call's layers
// per thread, ints[6], is FCT's stage B's and not read here)
constexpr int kCoefLayers = 8;
// what the coefficient kernel stages of one layer at its position (slots):
// h, the three edge classes' u, T and S at the position itself; u at the
// six ke slots (those that name no edge of its own); h, T and S at the
// other cmean source of each edge class. Layers k and k+1 of the
// interface and k+2 in flight.
constexpr int kCoefSlots = 21;
constexpr int kCoefBufs = 3;
// the exponent the kernel is compiled for besides the run-time one (PP81's
// default, the science configuration's)
constexpr int kNexpCompiled = 2;
enum CoefSlot { kSlH = 0, kSlU = 1, kSlT = 4, kSlS = 5, kSlKe = 6,
                kSlOh = 12, kSlOt = 15, kSlOs = 18 };

// the class c of a ke slot's offset o when it names the position's own
// edge of class c (offset c P), else -1: that u is staged already
__device__ __forceinline__ int own_class(int o, int P) {
  return o == 0 ? 0 : o == P ? 1 : o == 2 * P ? 2 : -1;
}

template <typename T, int kNexp>
__global__ void __launch_bounds__(256, 3)
patch_pp81_coeffs(const T* __restrict__ fr, const int* __restrict__ off,
                  const T* __restrict__ w, T* __restrict__ coef,
                  const VmixArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int k0 = blockIdx.y * kCoefLayers;
  const int k1 = min(a.K - 1, k0 + kCoefLayers);
  if (p >= a.P) return;
  const long long P = a.P, lay = static_cast<long long>(a.CH) * P;
  const bool strat = a.ti >= 0 && a.si >= 0;
  const long long cT = (4 + a.ti) * P, cS = (4 + a.si) * P;
  const T eps = T(1.0e-16);
  int od[6], oc[3][2], ot[3];
  T wk[6], wm[3][2];
  load_off(off, kOffDiv, a.P, p, od);
  load_w(w, kWKe, a.P, p, wk);
  for (int t = 0; t < 3; ++t) {
    load_off(off, kOffCm + 2 * t, a.P, p, oc[t]);
    load_w(w, kWCmean + 2 * t, a.P, p, wm[t]);
    // the source that is not the position itself (0 where both are)
    ot[t] = oc[t][0] != 0 ? oc[t][0] : oc[t][1];
  }
  // layer k's buffer: slot j at [j * blockDim.x], this thread's own column
  // of the block's staging, read only by this thread (no barrier)
  const int n = blockDim.x;
  T* const sm = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const auto buf = [&](int k) {
    return sm + (k % kCoefBufs) * kCoefSlots * n;
  };
  const auto slot = [&](int k, int j) { return buf(k) + j * n; };
  // layer k's values into its buffer, each loaded once, one copy group
  const auto stage = [&](int k) {
    const T* const f = fr + k * lay;
    copy_async(slot(k, kSlH), f + p);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      copy_async(slot(k, kSlU + c), f + (1 + c) * P + p);
    if (strat) {
      copy_async(slot(k, kSlT), f + cT + p);
      copy_async(slot(k, kSlS), f + cS + p);
    }
#pragma unroll
    for (int s = 0; s < 6; ++s)
      if (own_class(od[s], a.P) < 0)
        copy_async(slot(k, kSlKe + s), f + P + p + od[s]);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (ot[t] == 0) continue;
      const long long q = p + ot[t];
      copy_async(slot(k, kSlOh + t), f + q);
      if (strat) {
        copy_async(slot(k, kSlOt + t), f + cT + q);
        copy_async(slot(k, kSlOs + t), f + cS + q);
      }
    }
    copies_commit();
  };
  // a cell's dz and N^2 from its h, T and S at layers k and k + 1 (N^2 of
  // a stratified column only)
  const auto dz_of = [](T h0, T h1) { return T(0.5) * (h0 + h1); };
  const auto n2_of = [&](T t0, T t1, T s0, T s1, T dz) {
    const T db = a.grav * (mul_rn(a.a_t, t0 - t1) - mul_rn(a.b_s, s0 - s1));
    const T n2 = safe_div(db, dz);
    return n2 > T(0) ? n2 : T(0);
  };
  stage(k0);
  stage(k0 + 1);
  for (int k = k0; k < k1; ++k) {
    if (k + 2 <= k1)
      stage(k + 2);
    else
      copies_commit();                // an empty group keeps the count
    copies_wait<1>();                 // layers k and k + 1 have landed
    const T* const b0 = buf(k);
    const T* const b1 = buf(k + 1);
    const auto v0 = [&](int j) { return b0[j * n]; };
    const auto v1 = [&](int j) { return b1[j * n]; };
    const auto v = [&](int j) { return v0(j) - v1(j); };
    // cell: kappa from N^2 and the shear of the KE average of du^2
    const T dz = dz_of(v0(kSlH), v1(kSlH));
    const T n2 = strat ? n2_of(v0(kSlT), v1(kSlT), v0(kSlS), v1(kSlS), dz)
                       : T(0);
    T du[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) du[c] = v(kSlU + c);
    T ke = T(0);
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int c = own_class(od[s], a.P);
      const T d = c == 0   ? du[0]
                  : c == 1 ? du[1]
                  : c == 2 ? du[2]
                           : v(kSlKe + s);
      ke = ke + mul_rn(wk[s], mul_rn(d, d));
    }
    const T shear2_cell = T(2) * ke / mul_rn(dz, dz);
    T f;
    const T nu_c = pp81_nu<kNexp>(a, n2 / floor_at(shear2_cell, eps), f);
    T* const out = coef + k * 4LL * P + p;
    out[0] = nu_c / f + a.kt0;
    // edges: dz and N^2 averaged from the edge's two cells: the position's
    // own (offset 0), the other source staged, any third read here
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      T dz_e = T(0), n2_e = T(0);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int o = oc[t][s];
        T dzq = dz, n2q = n2;
        if (o != 0) {
          if (o == ot[t]) {
            dzq = dz_of(v0(kSlOh + t), v1(kSlOh + t));
            n2q = strat ? n2_of(v0(kSlOt + t), v1(kSlOt + t),
                                v0(kSlOs + t), v1(kSlOs + t), dzq)
                        : T(0);
          } else {
            const T* const f0 = fr + k * lay + p + o;
            const T* const f1 = f0 + lay;
            dzq = dz_of(f0[0], f1[0]);
            n2q = strat ? n2_of(f0[cT], f1[cT], f0[cS], f1[cS], dzq) : T(0);
          }
        }
        dz_e = dz_e + mul_rn(wm[t][s], dzq);
        n2_e = n2_e + mul_rn(wm[t][s], n2q);
      }
      const T sh = du[t] / dz_e;
      const T nu_e =
          pp81_nu<kNexp>(a, n2_e / floor_at(mul_rn(sh, sh), eps), f);
      out[(1 + t) * P] = nu_e + a.km0;
    }
  }
}

template <typename T>
size_t coeffs_smem_bytes(int threads) {
  return static_cast<size_t>(kCoefBufs) * kCoefSlots * threads * sizeof(T);
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

template <typename T, int kNexp>
int launch_coeffs_as(const void* fr, const void* off, const void* w,
                     void* coef, const VmixArgs<T>& a, int threads,
                     cudaStream_t stream) {
  const size_t smem = coeffs_smem_bytes<T>(threads);
  const cudaError_t err = cudaFuncSetAttribute(
      patch_pp81_coeffs<T, kNexp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.P + threads - 1) / threads,
                  (a.K - 1 + kCoefLayers - 1) / kCoefLayers);
  patch_pp81_coeffs<T, kNexp><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(fr), static_cast<const int*>(off),
      static_cast<const T*>(w), static_cast<T*>(coef), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coeffs(const void* fr, const void* off, const void* w, void* coef,
                  const double* c, const int* n, cudaStream_t stream) {
  VmixArgs<T> a;
  const int threads = n[7];
  if (!unpack(c, n, a) || threads < 32 || threads > 256 || threads % 32 ||
      fr == nullptr || off == nullptr || w == nullptr || coef == nullptr)
    return cudaErrorInvalidValue;
  return a.n_exp == kNexpCompiled
             ? launch_coeffs_as<T, kNexpCompiled>(fr, off, w, coef, a,
                                                  threads, stream)
             : launch_coeffs_as<T, -1>(fr, off, w, coef, a, threads, stream);
}

// registers, local (spill) bytes, static shared bytes and blocks per SM of
// the coefficient kernel as the science configuration (n_exp 2) launches it
// at the call's threads per block (ints[7])
template <typename T>
int coeffs_attrs(const double* c, const int* n, int* out) {
  VmixArgs<T> a;
  if (c == nullptr || n == nullptr || out == nullptr || !unpack(c, n, a) ||
      n[7] < 32 || n[7] > 256)
    return cudaErrorInvalidValue;
  const int threads = n[7];
  auto* const k = &patch_pp81_coeffs<T, kNexpCompiled>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = coeffs_smem_bytes<T>(threads);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
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
// omega_patch_pp81_attrs_* and omega_patch_vmix_solve_attrs_*(consts,
// ints, out): registers, local (spill) bytes, static shared bytes and
// blocks per SM of the coefficient kernel at that block size and of the
// solve kernel for that plan.
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

int omega_patch_pp81_attrs_f32(const double* consts, const int* ints,
                               int* out) {
  return omega::patch::coeffs_attrs<float>(consts, ints, out);
}
int omega_patch_pp81_attrs_f64(const double* consts, const int* ints,
                               int* out) {
  return omega::patch::coeffs_attrs<double>(consts, ints, out);
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
