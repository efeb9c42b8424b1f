// The split-explicit step's baroclinic kernels: splitpre as three passes and
// splitpost. The barotropic subcycles between them are barotropic.cu.
//
// Replaces the TPU kernel omega_tpu/ops/megastep.py:_kernel in the kinds
// splitpre (_split_pre with _vel_tend_column) and splitpost (_split_post).
// The TPU kernel carries one column per lane row, so it sums over the layers
// inside a tile. A block of the port's chain kernels is one layer x one tile
// (slab_chain.cuh) and sees no column, so splitpre is three launches from one
// C call:
//
//   split_columns  per cell and edge column, summing in layer order inside
//                  one thread: sshc = sum_k h - depth, het = sum_k mean_h,
//                  ubar = sum_k mean_h u / het (planes)
//   split_chain    the column-ssh momentum chain at (h, u): the momentum
//                  levels of slab_chain.cuh with the ssh gradient read from
//                  the sshc plane -> du_full (3 volumes)
//   split_slow     du_bar = sum_k mean_h du_full / het and the slow forcing
//                  g_slow = du_bar - (-g/dc cdiff(sshc) + f_e tang(ubar)
//                  - r ubar) (planes; the last term a radius-1 2-D stencil)
//
// and splitpost is one launch: the FB step's thickness and tracer levels
// (slab_chain.cuh) with the transport velocity u_trans = (u - ubar) + <ubar>
// formed while the slab loads, and u_new = (u - ubar) + dt (du_full - du_bar)
// + ub_final at the owned centre. uprime and du_slow are formed where
// splitpost reads them, in the reference's order of operations, and never
// stored. No float atomics: every sum over k runs in layer order in one
// thread, so the kernels agree with their plain versions run after run.
//
// The column passes walk the layers kSplitKB at a time: a block loads the
// slabs of kSplitKB layers of h, then each thread adds their terms to its
// owned points' sums, which live in slab-sized shared arrays indexed by the
// owned point. Every product that the plain version rounds before an add is
// rounded here too (mul_rn).
//
// Bound on this card: bytes. splitpre reads h and u (4 of the 4+L state
// volumes) and writes du_full (3 volumes) and 13 planes; splitpost reads the
// state, du_full and 12 planes and writes the state. The chain's stencil
// arithmetic (the momentum half of an RK stage's) is what the time goes to,
// as in the other chain kernels.
#include "slab_chain.cuh"

namespace omega {

// the (ny, nx) planes of a split step (ops/megastep.py: P_*)
enum SplitPlane {
  P_UBAR = 0, P_SSH = 3, P_GSLOW = 4, P_HET = 7, P_DUBAR = 10, P_UBF = 13,
  P_SSHF = 16, P_UAVG = 17
};

// layers of h a column pass keeps on its slab at once
constexpr int kSplitKB = 4;
// slab arrays of each pass (ops/megastep.py: SPLIT_SLOTS)
constexpr int kSplitColSlots = kSplitKB + 7;
constexpr int kSplitChainSlots = 21;
constexpr int kSplitSlowSlots = kSplitKB + 7;
constexpr int kSplitPostSlots = 20;

// layers k0 .. k0+nk-1 of channel ch into the slab arrays HB[j], with the
// periodic wrap (a column kernel's Slab has k = 0)
template <typename T>
__device__ __forceinline__ void load_layers(const Slab& sl,
                                            const FbParams<T>& p,
                                            const T* __restrict__ in, int ch,
                                            int k0, int nk, T* HB) {
  const long long base = sl.chan(p, ch) + static_cast<long long>(k0) * sl.plane;
  for (int q = threadIdx.x; q < sl.S; q += blockDim.x) {
    const long long g = sl.gofs(p, q);
#pragma unroll
    for (int j = 0; j < kSplitKB; ++j)
      if (j < nk) HB[j * sl.S + q] = in[base + j * sl.plane + g];
  }
}

// pass 1: the column sums of the mode split
template <typename T>
__global__ void __launch_bounds__(512)
split_columns_kernel(const T* __restrict__ in, T* __restrict__ planes,
                     const __grid_constant__ FbParams<T> p, T depth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;
  T* const HB = sm;                   // kSplitKB layers of h
  T* const SH = sm + kSplitKB * S;    // per owned point: sum_k h
  T* const HE = SH + S;               // sum_k mean_h, 3
  T* const UH = HE + 3 * S;           // sum_k mean_h * u, 3

  for (int k0 = 0; k0 < p.K; k0 += kSplitKB) {
    const int nk = min(kSplitKB, p.K - k0);
    load_layers(sl, p, in, 0, k0, nk, HB);
    __syncthreads();
    for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
      int q;
      long long g;
      bool odd;
      if (!sl.owned(p, o, q, g, odd)) continue;
      for (int j = 0; j < nk; ++j) {
        const T* const H = HB + j * S;
        const long long lay = static_cast<long long>(k0 + j) * sl.plane + g;
        const bool first = k0 + j == 0;
        SH[o] = first ? H[q] : SH[o] + H[q];
        _Pragma("unroll") for (int t = 0; t < 3; ++t) {
          const T mh = AP(T_CMEAN, t, at(H));
          const T uh = mul_rn(mh, in[sl.chan(p, 1 + t) + lay]);
          HE[t * S + o] = first ? mh : HE[t * S + o] + mh;
          UH[t * S + o] = first ? uh : UH[t * S + o] + uh;
        }
      }
    }
    __syncthreads();
  }

  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    planes[P_SSH * sl.plane + g] = SH[o] - depth;
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      planes[(P_HET + t) * sl.plane + g] = HE[t * S + o];
      planes[(P_UBAR + t) * sl.plane + g] = UH[t * S + o] / HE[t * S + o];
    }
  }
}

// pass 2: du_full of one layer, the momentum levels with the column ssh
template <typename T>
__global__ void __launch_bounds__(512)
split_chain_kernel(const T* __restrict__ in, const T* __restrict__ planes,
                   T* __restrict__ du, const __grid_constant__ FbParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;
  T* const H = sm;
  T* const U = sm + 1 * S;           // 3 edge classes
  // the RK stage's momentum slots
  const MomSlots<T> m{H,
                      sm + 4 * S,    // FL: cmean(h), 3
                      sm + 7 * S,    // KE
                      sm + 8 * S,    // DIVU
                      sm + 9 * S,    // RV, 2
                      sm + 11 * S,   // NRV, 2
                      sm + 13 * S,   // NPV, 2
                      sm + 15 * S,   // Q, 3
                      sm + 18 * S,   // D2E, 3
                      sm + 11 * S,   // D2DIV (after NRV / NPV are dead)
                      sm + 12 * S};  // D2RV, 2

  load_hu(sl, p, in, H, U);
  __syncthreads();
  momentum_levels<false>(sl, p, U, m);
  const T* const sshc = planes + P_SSH * sl.plane;
  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      du[sl.chan(p, t) + g] = momentum_du<false, false, true>(
          sl, p, q, odd, t, g, U, m, static_cast<const T*>(nullptr), false,
          false, sshc);
  }
}

// pass 3: the depth average of du_full and the slow forcing
template <typename T>
__global__ void __launch_bounds__(512)
split_slow_kernel(const T* __restrict__ in, const T* __restrict__ du,
                  T* __restrict__ planes, const __grid_constant__ FbParams<T> p,
                  T ggrad, T fe, T r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;
  T* const HB = sm;                   // kSplitKB layers of h
  T* const SS = sm + kSplitKB * S;    // sshc
  T* const UB = SS + S;               // ubar, 3
  T* const AC = UB + 3 * S;           // per owned point: sum_k mean_h du, 3

  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const long long g = sl.gofs(p, q);
    SS[q] = planes[P_SSH * sl.plane + g];
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      UB[t * S + q] = planes[(P_UBAR + t) * sl.plane + g];
  }
  for (int k0 = 0; k0 < p.K; k0 += kSplitKB) {
    const int nk = min(kSplitKB, p.K - k0);
    load_layers(sl, p, in, 0, k0, nk, HB);
    __syncthreads();
    for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
      int q;
      long long g;
      bool odd;
      if (!sl.owned(p, o, q, g, odd)) continue;
      for (int j = 0; j < nk; ++j) {
        const T* const H = HB + j * S;
        const long long lay = static_cast<long long>(k0 + j) * sl.plane + g;
        _Pragma("unroll") for (int t = 0; t < 3; ++t) {
          const T x = mul_rn(AP(T_CMEAN, t, at(H)), du[sl.chan(p, t) + lay]);
          AC[t * S + o] = k0 + j == 0 ? x : AC[t * S + o] + x;
        }
      }
    }
    __syncthreads();
  }

  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T dubar = AC[t * S + o] / planes[(P_HET + t) * sl.plane + g];
      const T fast0 = mul_rn(ggrad, AP(T_CDIFF, t, at(SS))) +
                      mul_rn(fe, AP(T_TANG, t, at(UB))) -
                      mul_rn(r, UB[t * S + q]);
      planes[(P_GSLOW + t) * sl.plane + g] = dubar - fast0;
      planes[(P_DUBAR + t) * sl.plane + g] = dubar;
    }
  }
}

// splitpost: h and the tracers with u_trans, u_new at the owned centre
template <typename T>
__global__ void __launch_bounds__(512)
split_post_kernel(const T* __restrict__ in, const T* __restrict__ du,
                  const T* __restrict__ planes, T* __restrict__ out,
                  const __grid_constant__ FbParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;
  // the FB step's tracer-phase slots
  T* const H = sm;              // old thickness
  T* const U = sm + 1 * S;      // u_trans, 3 edge classes
  T* const MH = sm + 4 * S;     // mean_h = cmean(h), 3
  T* const HN = sm + 7 * S;     // new thickness
  T* const TR = sm + 8 * S;     // current tracer
  T* const HTR = sm + 9 * S;    // h*tr on edges, 3
  T* const G = sm + 12 * S;     // geo*mean_h*cdiff(tr), 3
  T* const ADV = sm + 15 * S;
  T* const D2 = sm + 16 * S;
  T* const CD2 = sm + 17 * S;   // geo4*cdiff(d2tr), 3
  const long long plane = sl.plane;

  // h, and the transport velocity u' + <ubar> with u' = u - ubar
  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const long long g = sl.gofs(p, q);
    H[q] = in[sl.chan(p, 0) + g];
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      U[t * S + q] = (in[sl.chan(p, 1 + t) + g] - planes[(P_UBAR + t) * plane + g]) +
                     planes[(P_UAVG + t) * plane + g];
  }
  __syncthreads();
  thickness_level<false>(sl, p, H, U, MH, MH);
  __syncthreads();

  // h_new = h + dt * (-div(mean_h * u_trans))
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    const T dh = AP(T_DIV, 0, [&](int r) { return MH[r] * U[r]; });
    HN[q] = H[q] + p.dt * (-dh);
  }
  __syncthreads();

  // tracers, one at a time, fluxes on the old h with u_trans
  for (int l = 0; l < p.L; ++l) {
    for (int q = threadIdx.x; q < S; q += blockDim.x)
      TR[q] = in[sl.chan(p, 4 + l) + sl.gofs(p, q)];
    __syncthreads();
    tracer_levels<false>(sl, p, H, U, MH, TR, HTR, G, ADV, D2, CD2);
    for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
      int q;
      long long g;
      bool odd;
      if (!sl.owned(p, o, q, g, odd)) continue;
      const T dtr = tracer_dtr(p, q, odd, ADV, D2, CD2);
      out[sl.chan(p, 4 + l) + g] = (TR[q] * H[q] + p.dt * dtr) / HN[q];
    }
    __syncthreads();
  }

  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    out[sl.chan(p, 0) + g] = HN[q];
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const long long c = sl.chan(p, 1 + t) + g;
      const T uprime = in[c] - planes[(P_UBAR + t) * plane + g];
      const T du_slow = du[sl.chan(p, t) + g] - planes[(P_DUBAR + t) * plane + g];
      out[c] = (uprime + mul_rn(p.dt, du_slow)) + planes[(P_UBF + t) * plane + g];
    }
  }
}

// the grid of a column pass: tiles only, the layers walked inside
template <typename T>
dim3 column_grid(const FbParams<T>& p) {
  return dim3((p.nx + p.bx - 1) / p.bx, (p.ny + p.by - 1) / p.by, 1);
}

// check, size the shared memory of and launch one split kernel; returns
// from the enclosing launcher with the error code of a refused launch
#define OMEGA_SPLIT_LAUNCH(KERN, P, SLOTS, GRID, THREADS, STREAM, ...)        \
  do {                                                                        \
    if ((THREADS) < 32 || (THREADS) > 512)                                    \
      return cudaErrorInvalidConfiguration;                                   \
    if (!layout_ok(P) || (P).K < 1) return cudaErrorInvalidValue;             \
    const size_t smem_ = slab_smem_bytes(P, SLOTS);                           \
    cudaError_t err_ = cudaFuncSetAttribute(                                  \
        KERN, cudaFuncAttributeMaxDynamicSharedMemorySize,                    \
        static_cast<int>(smem_));                                             \
    if (err_ != cudaSuccess) return static_cast<int>(err_);                   \
    KERN<<<GRID, THREADS, smem_, STREAM>>>(__VA_ARGS__);                      \
    err_ = cudaGetLastError();                                                \
    if (err_ != cudaSuccess) return static_cast<int>(err_);                   \
  } while (0)

template <typename T>
int launch_split_pre(const void* in, void* du, void* planes,
                     const FbParams<T>* pc, const FbParams<T>* pm,
                     const FbParams<T>* ps, double depth, double ggrad,
                     double fe, double r, int tc, int tm, int ts,
                     cudaStream_t stream) {
  if (in == nullptr || du == nullptr || planes == nullptr) {
    return cudaErrorInvalidValue;
  }
  const T* s = static_cast<const T*>(in);
  T* d = static_cast<T*>(du);
  T* pl = static_cast<T*>(planes);
  OMEGA_SPLIT_LAUNCH(split_columns_kernel<T>, *pc, kSplitColSlots,
                     column_grid(*pc), tc, stream, s, pl, *pc,
                     static_cast<T>(depth));
  OMEGA_SPLIT_LAUNCH(split_chain_kernel<T>, *pm, kSplitChainSlots,
                     slab_grid(*pm), tm, stream, s, pl, d, *pm);
  OMEGA_SPLIT_LAUNCH(split_slow_kernel<T>, *ps, kSplitSlowSlots,
                     column_grid(*ps), ts, stream, s, d, pl, *ps,
                     static_cast<T>(ggrad), static_cast<T>(fe),
                     static_cast<T>(r));
  return 0;
}

template <typename T>
int launch_split_post(const void* in, const void* du, const void* planes,
                      void* out, const FbParams<T>* hp, int threads,
                      cudaStream_t stream) {
  if (in == nullptr || du == nullptr || planes == nullptr || out == nullptr ||
      out == in) {
    return cudaErrorInvalidValue;
  }
  OMEGA_SPLIT_LAUNCH(split_post_kernel<T>, *hp, kSplitPostSlots,
                     slab_grid(*hp), threads, stream,
                     static_cast<const T*>(in), static_cast<const T*>(du),
                     static_cast<const T*>(planes), static_cast<T*>(out), *hp);
  return 0;
}

}  // namespace omega

// The C interface, in both precisions. `params` (one record per pass) point
// at host FbParams<T>; `in` and `out` are stacked (4+L, K, ny, nx) states,
// `du` a (3, K, ny, nx) array, `planes` the (24, ny, nx) planes. depth,
// ggrad = -g/dc, fe = f_edge and r = the linear drag are rounded to T once
// here. Each returns the first refused launch's error code, or 0.
#define OMEGA_SPLIT_ENTRIES(SUF, T)                                           \
  int omega_split_pre_##SUF(const void* in, void* du, void* planes,           \
                            const void* pc, const void* pm, const void* ps,   \
                            double depth, double ggrad, double fe, double r,  \
                            int tc, int tm, int ts, void* stream) {           \
    return omega::launch_split_pre<T>(                                        \
        in, du, planes, static_cast<const omega::FbParams<T>*>(pc),           \
        static_cast<const omega::FbParams<T>*>(pm),                           \
        static_cast<const omega::FbParams<T>*>(ps), depth, ggrad, fe, r, tc,  \
        tm, ts, static_cast<cudaStream_t>(stream));                           \
  }                                                                           \
  int omega_split_post_##SUF(const void* in, const void* du,                  \
                             const void* planes, void* out,                   \
                             const void* params, int threads, void* stream) { \
    return omega::launch_split_post<T>(                                       \
        in, du, planes, out, static_cast<const omega::FbParams<T>*>(params),  \
        threads, static_cast<cudaStream_t>(stream));                          \
  }

extern "C" {

OMEGA_SPLIT_ENTRIES(f32, float)
OMEGA_SPLIT_ENTRIES(f64, double)

// slab arrays of a split pass: 0 columns, 1 chain, 2 slow forcing, 3 post
int omega_split_slots(int pass) {
  switch (pass) {
    case 0: return omega::kSplitColSlots;
    case 1: return omega::kSplitChainSlots;
    case 2: return omega::kSplitSlowSlots;
    case 3: return omega::kSplitPostSlots;
    default: return -1;
  }
}

}  // extern "C"
