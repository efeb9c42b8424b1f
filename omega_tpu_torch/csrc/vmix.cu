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
// pp81_coeffs_kernel: one interface k (layers k and k+1) x one (by, bx) tile
// per block, with a ring as wide as the `ke` and `cmean` tables reach (1 on
// the hex mesh). The block loads dz, N^2 and the three classes of du for its
// slab into shared memory once, then every owned point evaluates
// core/vmix.pp81_coefficients expression for expression and writes
// kappa_cell (K-1, ny, nx) and nu_edge (3, K-1, ny, nx). f ** n_exp is n_exp
// repeated multiplications (as the plain version does); the two products of
// the buoyancy difference are kept out of a fused multiply-add, because
// their difference cancels. Bound: bytes, the 6
// channels it reads (h, 3 u, T, S) and the 4 planes it writes per interface.
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
};

// the solve: right-hand sides per pass, and the blocks an SM must hold (the
// register budget)
constexpr int kSolveRhs = 2;
template <typename T>
constexpr int kSolveMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <typename T>
__device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }

// nu = nu0 / f^n_exp with f = 1 + alpha * max(ri, 0); returns nu, sets f
template <typename T>
__device__ __forceinline__ T pp81_nu(const VmixParams<T>& p, T ri, T& f) {
  f = T(1) + p.alpha * pos(ri);
  T pw = T(1);
  for (int i = 0; i < p.n_exp; ++i) pw *= f;
  return p.nu0 / pw;
}

template <typename T>
__global__ void __launch_bounds__(256)
pp81_coeffs_kernel(const T* __restrict__ s, T* __restrict__ kappa,
                   T* __restrict__ nu,
                   const __grid_constant__ VmixParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int YY = p.by + 2 * p.ry, XX = p.bx + 2 * p.rx, S = YY * XX;
  T* const DZ = sm;           // 0.5 * (h_k + h_{k+1})
  T* const N2 = sm + S;       // max(db / dz, 0)
  T* const DU = sm + 2 * S;   // u_k - u_{k+1}, 3 edge classes
  const int y0 = blockIdx.y * p.by, x0 = blockIdx.x * p.bx, k = blockIdx.z;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const T eps = T(1.0e-16);
  auto chan = [&](int ch, int kk) {
    return (static_cast<long long>(ch) * p.K + kk) * plane;
  };
  const bool strat = p.ti >= 0 && p.si >= 0;

  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const int sy = q / XX, sx = q - sy * XX;
    const long long g =
        static_cast<long long>(wrap_any(y0 - p.ry + sy, p.ny)) * p.nx +
        wrap_any(x0 - p.rx + sx, p.nx);
    const T dz = T(0.5) * (s[chan(0, k) + g] + s[chan(0, k + 1) + g]);
    DZ[q] = dz;
    T n2 = T(0);
    if (strat) {
      const T dT = s[chan(4 + p.ti, k) + g] - s[chan(4 + p.ti, k + 1) + g];
      const T dS = s[chan(4 + p.si, k) + g] - s[chan(4 + p.si, k + 1) + g];
      // The thermal and haline parts cancel where the column is near
      // neutral, and a small shear then divides what is left: each product
      // is rounded on its own, as the plain version rounds it, so that N^2
      // is the same number in both (a fused multiply-add here moved nu by
      // 1.6e-4 of its range in float32).
      const T db = p.grav * (mul_rn(p.a_t, dT) - mul_rn(p.b_s, dS));
      n2 = pos(db / dz);
    }
    N2[q] = n2;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      DU[t * S + q] = s[chan(1 + t, k) + g] - s[chan(1 + t, k + 1) + g];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < p.by * p.bx; o += blockDim.x) {
    const int oy = o / p.bx, ox = o - oy * p.bx;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= p.ny || gx >= p.nx) continue;
    const int sy = oy + p.ry, sx = ox + p.rx, q = sy * XX + sx;
    const bool odd = (gy & 1) != 0;
    auto src = [&](const Entry<T>& e) {
      return e.ts * S + (sy + e.dj) * XX + sx + (odd ? e.di_o : e.di_e);
    };
    const long long g = static_cast<long long>(gy) * p.nx + gx;

    // cell: shear^2 from the KE average of du^2
    T ke = T(0);
    for (int i = 0; i < p.nke; ++i) {
      const T d = DU[src(p.e[i])];
      ke += p.e[i].w * (d * d);
    }
    const T dz = DZ[q];
    const T shear2_cell = T(2) * ke / (dz * dz);
    const T ri_cell = N2[q] / (shear2_cell > eps ? shear2_cell : eps);
    T f;
    const T nu_c = pp81_nu(p, ri_cell, f);
    kappa[static_cast<long long>(k) * plane + g] = nu_c / f + p.kt0;

    // edges: dz and N^2 averaged from the edge's two cells
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      T dz_e = T(0), n2_e = T(0);
      for (int i = p.cm_start[t]; i < p.cm_start[t + 1]; ++i) {
        const int r = src(p.e[i]);
        dz_e += p.e[i].w * DZ[r];
        n2_e += p.e[i].w * N2[r];
      }
      const T sh = DU[t * S + q] / dz_e;
      const T shear2_edge = sh * sh;
      const T ri_edge = n2_e / (shear2_edge > eps ? shear2_edge : eps);
      const T nu_e = pp81_nu(p, ri_edge, f);
      nu[(static_cast<long long>(t) * (p.K - 1) + k) * plane + g] =
          nu_e + p.km0;
    }
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
size_t coeffs_smem_bytes(const VmixParams<T>& p) {
  return static_cast<size_t>(5) * (p.by + 2 * p.ry) * (p.bx + 2 * p.rx) *
         sizeof(T);
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

template <typename T>
int launch_pp81_coeffs(const void* s, void* kappa, void* nu,
                       const VmixParams<T>* hp, cudaStream_t stream) {
  const VmixParams<T>& p = *hp;
  if (p.K < 2 || p.by < 1 || p.bx < 1 || !tables_ok(p) || p.n_exp < 0 ||
      p.ti >= p.L || p.si >= p.L)
    return cudaErrorInvalidValue;
  for (int i = 0; i < p.cm_start[3]; ++i) {   // the ring covers every shift
    const Entry<T>& e = p.e[i];
    if (reach(e.dj, 0) > p.ry || reach(e.di_e, e.di_o) > p.rx)
      return cudaErrorInvalidValue;
  }
  const size_t smem = coeffs_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      pp81_coeffs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nx + p.bx - 1) / p.bx, (p.ny + p.by - 1) / p.by, p.K - 1);
  pp81_coeffs_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(kappa), static_cast<T*>(nu),
      p);
  return static_cast<int>(cudaGetLastError());
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
// the solve kernel for the plan in `params`
int omega_vmix_solve_attrs_f32(const void* params, int* out) {
  return omega::vmix_solve_attrs<float>(
      static_cast<const omega::VmixParams<float>*>(params), out);
}
int omega_vmix_solve_attrs_f64(const void* params, int* out) {
  return omega::vmix_solve_attrs<double>(
      static_cast<const omega::VmixParams<double>*>(params), out);
}

}  // extern "C"
