// Implicit vertical mixing on the stacked state: the Richardson-number
// (PP81) coefficient pass and the column solves.
//
// Replaces the vertical-mixing tail of the TPU kernel
// omega_tpu/ops/megastep.py:_kernel, i.e. _vmix_apply with _pcr_diffusion
// (vmix_solve_kernel) and _pp81_coeffs (pp81_coeffs_kernel). That kernel keeps
// all K of a tile on chip and runs the tail in the body of the horizontal
// chain; here a block of the horizontal kernel (fb_step.cuh) is one layer and
// cannot see a column, so the tail is two kernels of its own that run after
// it on the same stacked (4+L, K, ny, nx) array, x fastest.
//
// pp81_coeffs_kernel: a block owns one 16 x 32 tile with a (1, 1) ring
// (the reach of the `ke` and `cmean` tables) and walks a group of
// interfaces in order (grid z = the groups, VmixParams::groups, the host's
// choice that fills the card). Each layer's six channels (h, 3 u, T, S) are
// staged into shared memory by cp.async once, a layer ahead of the
// interface that needs them; a thread stages and reads only its own slab
// points, so the copies need no barrier. At interface k (layers k and
// k+1) the slab's dz, N^2 and the three classes of du are formed into
// shared memory, and every owned point evaluates
// core/vmix.pp81_coefficients expression for expression and writes
// kappa_cell (K-1, ny, nx) and nu_edge (3, K-1, ny, nx). The slab
// geometry and the planar hex mesh's `ke` and `cmean` entries are compiled
// in (hex_slab.cuh, the chain kernels' pattern): every stencil read is one
// shared load at an immediate offset, with no parity select, and its
// weight an operand from the parameter space. The launcher refuses any
// other tile, ring or entry pattern (the host checks
// megastep.hex_pattern_fits first). f ** n_exp is n_exp repeated
// multiplications (as the plain version does; compiled in for PP81's
// default 2); the two products of the buoyancy difference are kept out of
// a fused multiply-add, because their difference cancels. 3 blocks per SM
// in float32 (80 registers, 56 KB). Bound: bytes, the 6 channels it reads
// (h, 3 u, T, S; each group reads its first layer once more) and the 4
// planes it writes per interface; its time goes mostly to its arithmetic,
// 13 IEEE divisions an owned point and interface (PERF.md).
//
// vmix_solve_kernel: backward-Euler diffusion of every column, in place.
// System 0 of a cell column is the L tracers against the cell thickness,
// systems 1..3 are the edge classes of u against cmean(h) (two reads through
// the cmean table's shifts, the periodic wrap as index arithmetic). It is
// solved by elimination in chunks (column_solve.cuh, which the sphere's
// solve shares): a block takes cw ADJACENT columns of one row y and `lanes`
// k-lanes of at most kChunk rows, stages the columns in shared memory by
// cp.async, and solves kSolveRhs tracers per pass. The plain version is the
// reference's PCR; the two agree to the rounding of either (float64 within
// 1e-10 in chip_smoke.py). 4 blocks of 128 threads per SM in float32 at K =
// 100 (4 lanes of 25 rows). Bound: bytes (h, u, tracers and coefficients
// read once, u and tracers written once).
#include "column_solve.cuh"
#include "hex_slab.cuh"

namespace omega {

constexpr int kVmixMaxEntries = 16;

template <typename T>
struct VmixParams {
  // `ke` entries (one destination class) at [0, nke), then the `cmean`
  // entries of edge class t at [cm_start[t], cm_start[t+1])
  Entry<T> e[kVmixMaxEntries];
  int nke;
  int cm_start[4];
  // dt; then the closure's constants (PP81), kt0 / km0 = background (PP81)
  // or constant coefficients of tracers / momentum
  T dt, grav, nu0, alpha, a_t, b_s, kt0, km0;
  int n_exp, ti, si;         // PP81 exponent, T and S tracer rows (or -1)
  int L, K, ny, nx;
  int by, bx, ry, rx;        // coefficient kernel: tile and ring
  int cw, lanes;             // solve: columns x k-lanes per block
  int groups;                // coefficient kernel: groups of interfaces
};

// the solve: right-hand sides per pass, and the blocks an SM must hold (the
// register budget)
constexpr int kSolveRhs = 2;
template <typename T>
constexpr int kSolveMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <typename T>
__device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }

// nu = nu0 / f^n_exp with f = 1 + alpha * max(ri, 0); returns nu, sets f.
// kNexp >= 0 is the exponent compiled in (the products unrolled), -1 reads
// p.n_exp
template <int kNexp, typename T>
__device__ __forceinline__ T pp81_nu(const VmixParams<T>& p, T ri, T& f) {
  f = T(1) + p.alpha * pos(ri);
  T pw = T(1);
  if constexpr (kNexp >= 0) {
#pragma unroll
    for (int i = 0; i < kNexp; ++i) pw *= f;
  } else {
    for (int i = 0; i < p.n_exp; ++i) pw *= f;
  }
  return p.nu0 / pw;
}

namespace coef {

// the tile, ring and block the coefficient kernel is compiled for
using Geo = HexSlab<16, 32, 1, 1, 256>;
constexpr int kBY = Geo::kBY, kBX = Geo::kBX, kRY = Geo::kRY, kRX = Geo::kRX;
constexpr int kXX = Geo::kXX, kS = Geo::kS, kThreads = Geo::kThreads;
// slab points a thread stages, and the layers staged at once: k and k+1
// of the interface, k+2 in flight
constexpr int kPer = (kS + kThreads - 1) / kThreads;
constexpr int kBufs = 3;
// the entries read: the cell's ke (hex_ent 6-11) and the edge classes'
// cmean (54-59), packed in that order as the record's 12 entries
constexpr int kKe = tab_base(T_KE), kCm = tab_base(T_CMEAN);
constexpr int kKeN = tab_count(T_KE), kCmN = tab_count(T_CMEAN);
// shared memory: kBufs layers of 6 channels, then dz, N^2 and 3 du
constexpr int kSlabs = kBufs * 6 + 5;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
// the exponent the kernel is compiled for besides the run-time one (PP81's
// default, the science configuration's)
constexpr int kNexpCompiled = 2;

}  // namespace coef

template <typename T, int kNexp>
__global__ void __launch_bounds__(coef::kThreads, coef::kMinBlocks<T>)
pp81_coeffs_kernel(const T* __restrict__ s, T* __restrict__ kappa,
                   T* __restrict__ nu,
                   const __grid_constant__ VmixParams<T> p) {
  using namespace coef;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const raw = reinterpret_cast<T*>(smem_raw);  // [kBufs][6][kS]
  T* const DZ = raw + kBufs * 6 * kS;             // 0.5 * (h_k + h_{k+1})
  T* const N2 = DZ + kS;                          // max(db / dz, 0)
  T* const DU = DZ + 2 * kS;                      // u_k - u_{k+1}, 3 classes
  const int per = (p.K - 1 + gridDim.z - 1) / gridDim.z;
  const int k0 = blockIdx.z * per, k1 = min(p.K - 1, k0 + per);
  if (k0 >= k1) return;
  const int y0 = blockIdx.y * kBY, x0 = blockIdx.x * kBX;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const long long nu_class = (p.K - 1) * plane;   // one edge class of nu
  const T eps = T(1.0e-16);
  const bool strat = p.ti >= 0 && p.si >= 0;
  // the six channels' rows of the stacked state (T and S only stratified)
  const int chs[6] = {0, 1, 2, 3, 4 + p.ti, 4 + p.si};

  // plane offsets of this thread's slab points
  int gq[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int sy = q / kXX, sx = q - sy * kXX;
    gq[i] = wrap_any(y0 - kRY + sy, p.ny) * p.nx +
            wrap_any(x0 - kRX + sx, p.nx);
  }
  // layer k's channels at this thread's slab points into buffer k % kBufs,
  // one group of copies
  const auto stage = [&](int k) {
    T* const b = raw + (k % kBufs) * 6 * kS;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (c >= 4 && !strat) break;
      const T* const src =
          s + (static_cast<long long>(chs[c]) * p.K + k) * plane;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int q = threadIdx.x + i * kThreads;
        if (q < kS) copy_async(b + c * kS + q, src + gq[i]);
      }
    }
    copies_commit();
  };

  // the thread's owned pair: column ox, rows oy (even) and oy + 1 of the tile
  const int oy = 2 * (threadIdx.x / kBX), ox = threadIdx.x % kBX;
  const bool own = y0 + oy < p.ny && x0 + ox < p.nx;
  const int qo = (oy + kRY) * kXX + ox + kRX;
  const long long go = static_cast<long long>(y0 + oy) * p.nx + x0 + ox;

  stage(k0);
  stage(k0 + 1);
  for (int k = k0; k < k1; ++k) {
    if (k + 2 <= k1)
      stage(k + 2);
    else
      copies_commit();                // an empty group keeps the count
    copies_wait<1>();                 // layers k and k + 1 have landed
    const T* const b0 = raw + (k % kBufs) * 6 * kS;
    const T* const b1 = raw + ((k + 1) % kBufs) * 6 * kS;
    __syncthreads();                  // the last interface's reads are done
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (q >= kS) continue;
      const T dz = T(0.5) * (b0[q] + b1[q]);
      DZ[q] = dz;
      T n2 = T(0);
      if (strat) {
        const T dT = b0[4 * kS + q] - b1[4 * kS + q];
        const T dS = b0[5 * kS + q] - b1[5 * kS + q];
        // The thermal and haline parts cancel where the column is near
        // neutral, and a small shear then divides what is left: each
        // product is rounded on its own, as the plain version rounds it,
        // so that N^2 is the same number in both (a fused multiply-add
        // here moved nu by 1.6e-4 of its range in float32).
        const T db = p.grav * (mul_rn(p.a_t, dT) - mul_rn(p.b_s, dS));
        n2 = pos(db / dz);
      }
      N2[q] = n2;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        DU[t * kS + q] = b0[(1 + t) * kS + q] - b1[(1 + t) * kS + q];
    }
    __syncthreads();
    if (!own) continue;
    T* const kap_k = kappa + k * plane + go;
    T* const nu_k = nu + k * plane + go;
    static_for<2>([&](auto par) {
      constexpr int PAR = decltype(par)::value;
      const int q = qo + PAR * kXX;
      const int g = PAR * p.nx;
      // cell: shear^2 from the KE average of du^2
      T ke = T(0);
      static_for<kKeN>([&](auto ic_) {
        constexpr int i = decltype(ic_)::value;
        constexpr int r = Geo::off(kKe + i, PAR);
        const T d = DU[q + r];
        ke += p.e[i].w * (d * d);
      });
      const T dz = DZ[q];
      const T shear2_cell = T(2) * ke / (dz * dz);
      const T ri_cell = N2[q] / (shear2_cell > eps ? shear2_cell : eps);
      T f;
      const T nu_c = pp81_nu<kNexp>(p, ri_cell, f);
      kap_k[g] = nu_c / f + p.kt0;
      // edges: dz and N^2 averaged from the edge's two cells
      static_for<3>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        T dz_e = T(0), n2_e = T(0);
        static_for<kCmN>([&](auto ic_) {
          constexpr int i = decltype(ic_)::value;
          constexpr int r = Geo::off(kCm + t * kCmN + i, PAR);
          const T wt = p.e[kKeN + t * kCmN + i].w;
          dz_e += wt * DZ[q + r];
          n2_e += wt * N2[q + r];
        });
        const T sh = DU[t * kS + q] / dz_e;
        const T shear2_edge = sh * sh;
        const T ri_edge = n2_e / (shear2_edge > eps ? shear2_edge : eps);
        const T nu_e = pp81_nu<kNexp>(p, ri_edge, f);
        nu_k[t * nu_class + g] = nu_e + p.km0;
      });
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(256, kSolveMinBlocks<T>)
vmix_solve_kernel(T* __restrict__ s, const T* __restrict__ kappa,
                  const T* __restrict__ nu,
                  const __grid_constant__ VmixParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = p.K, CW = blockDim.x;
  const int x = blockIdx.x * CW + threadIdx.x, y = blockIdx.y;
  const int sys = blockIdx.z;         // 0: tracers on cells, 1..3: u classes
  const bool cells = sys == 0;
  const int xc = x < p.nx ? x : p.nx - 1;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const long long g = static_cast<long long>(y) * p.nx + xc;
  ColumnSystem<T> c;
  // row k of channel ch at (ch K + k) plane + g
  c.rows = ColumnRows{g, K * plane, plane};
  c.cells = cells;
  // thickness of the system: the cell's own, or the edge's cmean of two
  // cells (w0 h[g0] + w1 h[g1]; a one-cell table gives w1 = 0)
  c.d0 = c.d1 = 0;
  c.w0 = T(1);
  c.w1 = T(0);
  if (!cells) {
    const bool odd = (y & 1) != 0;
    const int e0 = p.cm_start[sys - 1], ne = p.cm_start[sys] - e0;
    const auto cell = [&](const Entry<T>& e) {
      return static_cast<long long>(wrap_near(y + e.dj, p.ny)) * p.nx +
             wrap_near(xc + (odd ? e.di_o : e.di_e), p.nx);
    };
    const long long g0 = cell(p.e[e0]);
    c.d0 = g0 - g;
    c.w0 = p.e[e0].w;
    c.d1 = (ne > 1 ? cell(p.e[e0 + 1]) : g0) - g;
    c.w1 = ne > 1 ? p.e[e0 + 1].w : T(0);
  }
  const T* const coef =
      cells ? kappa
            : (nu ? nu + static_cast<long long>(sys - 1) * (K - 1) * plane
                  : nullptr);
  c.coef = coef ? coef + g : nullptr;
  c.cstride = plane;
  c.coef0 = cells ? p.kt0 : p.km0;
  c.dt = p.dt;
  c.K = K;
  c.ch0 = cells ? 4 : sys;
  c.nrhs = cells ? p.L : 1;
  c.lc = kSolveRhs;
  c.live = x < p.nx;                  // ragged last group: compute, no store
  solve_columns<T, kSolveRhs, false, false>(
      s, c, reinterpret_cast<T*>(smem_raw), nullptr);
}

template <typename T>
constexpr size_t coeffs_smem_bytes() {
  return static_cast<size_t>(coef::kSlabs) * coef::kS * sizeof(T);
}

template <typename T>
size_t solve_smem_bytes(const VmixParams<T>& p) {
  return static_cast<size_t>(column_smem_elems(p.K, p.cw, p.lanes,
                                               kSolveRhs)) *
         sizeof(T);
}

// the larger of |a| and |b|
inline int reach(int a, int b) {
  a = a < 0 ? -a : a;
  b = b < 0 ? -b : b;
  return a > b ? a : b;
}

template <typename T>
bool tables_ok(const VmixParams<T>& p) {
  if (p.nke < 1 || p.nke != p.cm_start[0]) return false;
  for (int t = 0; t < 3; ++t)
    if (p.cm_start[t + 1] < p.cm_start[t]) return false;
  if (p.cm_start[3] > kVmixMaxEntries) return false;
  for (int i = 0; i < p.cm_start[3]; ++i) {
    const Entry<T>& e = p.e[i];
    if (reach(e.dj, 0) >= p.ny || reach(e.di_e, e.di_o) >= p.nx) return false;
  }
  return true;
}

// the record's plan and tables are what the coefficient kernel is compiled
// for: the tile and ring, an even number of rows, and the hex mesh's ke and
// cmean entries in order (hex_ent)
template <typename T>
bool coeffs_plan_ok(const VmixParams<T>& p) {
  using namespace coef;
  if (p.K < 2 || p.groups < 1 || p.by != kBY || p.bx != kBX ||
      p.ry != kRY || p.rx != kRX || p.ny % 2 != 0 || !tables_ok(p) ||
      p.n_exp < 0 || p.ti >= p.L || p.si >= p.L || p.nke != kKeN ||
      p.cm_start[3] != kKeN + 3 * kCmN)
    return false;
  for (int t = 0; t < 3; ++t)
    if (p.cm_start[t] != kKeN + t * kCmN) return false;
  for (int i = 0; i < kKeN + 3 * kCmN; ++i) {
    const int h = i < kKeN ? kKe + i : kCm + i - kKeN;
    const Entry<T>& e = p.e[i];
    if (e.ts != hex_ent(h, 0) || e.dj != hex_ent(h, 1) ||
        e.di_e != hex_ent(h, 2) || e.di_o != hex_ent(h, 3))
      return false;
  }
  return true;
}

template <typename T, int kNexp>
int launch_pp81_coeffs_as(const void* s, void* kappa, void* nu,
                          const VmixParams<T>& p, cudaStream_t stream) {
  const size_t smem = coeffs_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      pp81_coeffs_kernel<T, kNexp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nx + coef::kBX - 1) / coef::kBX,
            (p.ny + coef::kBY - 1) / coef::kBY, p.groups);
  pp81_coeffs_kernel<T, kNexp><<<grid, coef::kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(kappa), static_cast<T*>(nu),
      p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pp81_coeffs(const void* s, void* kappa, void* nu,
                       const VmixParams<T>* hp, cudaStream_t stream) {
  const VmixParams<T>& p = *hp;
  if (!coeffs_plan_ok(p)) return cudaErrorInvalidValue;
  return p.n_exp == coef::kNexpCompiled
             ? launch_pp81_coeffs_as<T, coef::kNexpCompiled>(s, kappa, nu, p,
                                                             stream)
             : launch_pp81_coeffs_as<T, -1>(s, kappa, nu, p, stream);
}

template <typename T>
int launch_vmix_solve(void* s, const void* kappa, const void* nu,
                      const VmixParams<T>* hp, cudaStream_t stream) {
  const VmixParams<T>& p = *hp;
  // every lane takes 2 .. kChunk rows
  if (p.K < 2 || p.cw < 1 || p.lanes < 1 || p.cw * p.lanes > 256 ||
      2 * p.lanes > p.K || p.lanes * kChunk < p.K || !tables_ok(p) ||
      (kappa == nullptr) != (nu == nullptr))
    return cudaErrorInvalidValue;
  for (int t = 0; t < 3; ++t)       // an edge thickness is a two-cell mean
    if (p.cm_start[t + 1] - p.cm_start[t] > 2) return cudaErrorInvalidValue;
  const size_t smem = solve_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      vmix_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nx + p.cw - 1) / p.cw, p.ny, 4);
  dim3 block(p.cw, p.lanes);
  vmix_solve_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<T*>(s), static_cast<const T*>(kappa),
      static_cast<const T*>(nu), p);
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of the coefficient kernel as the science
// configuration launches it (numRegs, localSizeBytes, sharedSizeBytes into
// out[0..2]) and the blocks an SM holds (out[3],
// cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T>
int pp81_coeffs_attrs(int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  auto* const k = &pp81_coeffs_kernel<T, coef::kNexpCompiled>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = coeffs_smem_bytes<T>();
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      coef::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// cudaFuncGetAttributes of the solve kernel (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) and the blocks an SM holds for the plan
// in `hp` (out[3], cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T>
int vmix_solve_attrs(const VmixParams<T>* hp, int* out) {
  if (hp == nullptr || out == nullptr) return cudaErrorInvalidValue;
  auto* const k = &vmix_solve_kernel<T>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = solve_smem_bytes(*hp);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, hp->cw * hp->lanes, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace omega

extern "C" {

int omega_vmix_params_size_f32() {
  return static_cast<int>(sizeof(omega::VmixParams<float>));
}
int omega_vmix_params_size_f64() {
  return static_cast<int>(sizeof(omega::VmixParams<double>));
}

// `params` points at a host VmixParams<T>; `state` is the stacked
// (4+L, K, ny, nx) array; kappa is (K-1, ny, nx) and nu (3, K-1, ny, nx).
// Each returns the launch's error code.
int omega_pp81_coeffs_f32(const void* state, void* kappa, void* nu,
                          const void* params, void* stream) {
  return omega::launch_pp81_coeffs<float>(
      state, kappa, nu, static_cast<const omega::VmixParams<float>*>(params),
      static_cast<cudaStream_t>(stream));
}
int omega_pp81_coeffs_f64(const void* state, void* kappa, void* nu,
                          const void* params, void* stream) {
  return omega::launch_pp81_coeffs<double>(
      state, kappa, nu, static_cast<const omega::VmixParams<double>*>(params),
      static_cast<cudaStream_t>(stream));
}
// the solve is in place; kappa and nu are both null for constant coefficients
int omega_vmix_solve_f32(void* state, const void* kappa, const void* nu,
                         const void* params, void* stream) {
  return omega::launch_vmix_solve<float>(
      state, kappa, nu, static_cast<const omega::VmixParams<float>*>(params),
      static_cast<cudaStream_t>(stream));
}
int omega_vmix_solve_f64(void* state, const void* kappa, const void* nu,
                         const void* params, void* stream) {
  return omega::launch_vmix_solve<double>(
      state, kappa, nu, static_cast<const omega::VmixParams<double>*>(params),
      static_cast<cudaStream_t>(stream));
}
// registers, local (spill) bytes, static shared bytes and blocks per SM of
// the coefficient kernel, and of the solve kernel for the plan in `params`
int omega_pp81_coeffs_attrs_f32(int* out) {
  return omega::pp81_coeffs_attrs<float>(out);
}
int omega_pp81_coeffs_attrs_f64(int* out) {
  return omega::pp81_coeffs_attrs<double>(out);
}
int omega_vmix_solve_attrs_f32(const void* params, int* out) {
  return omega::vmix_solve_attrs<float>(
      static_cast<const omega::VmixParams<float>*>(params), out);
}
int omega_vmix_solve_attrs_f64(const void* params, int* out) {
  return omega::vmix_solve_attrs<double>(
      static_cast<const omega::VmixParams<double>*>(params), out);
}

}  // extern "C"
