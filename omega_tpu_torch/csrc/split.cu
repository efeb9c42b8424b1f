// The split-explicit step's baroclinic kernels: splitpre as two passes and
// splitpost. The barotropic subcycles between them are barotropic.cu.
//
// Replaces the TPU kernel omega_tpu/ops/megastep.py:_kernel in the kinds
// splitpre (_split_pre with _vel_tend_column) and splitpost (_split_post).
// The TPU kernel carries one column per lane row, so it sums over the layers
// inside a tile. A block of the port's chain kernels is one layer x one tile
// and sees no column, so splitpre is two launches from one C call:
//
//   split_columns  a thread per cell column and its three edges, walking K
//                  with the next layer's loads issued a layer ahead and the
//                  sums in registers, in layer order: sshc = sum_k h -
//                  depth, het = sum_k mean_h, ubar = sum_k mean_h u / het
//                  (planes)
//   split_chain    the column-ssh momentum chain at (h, u) on the compiled
//                  hex slab (hex_slab.cuh: the RK stage's momentum half,
//                  the ssh gradient that of the sshc plane) -> du_full (3
//                  volumes); and the depth average du_bar = sum_k mean_h
//                  du_full / het, carried from layer to layer of a tile in
//                  layer order, with the slow forcing g_slow = du_bar -
//                  (-g/dc cdiff(sshc) + f_e tang(ubar) - r ubar) in the last
//                  layer's block (planes)
//
// and splitpost is one launch: the FB step's kernel (fb_step.cuh) with its
// switch SPLIT, on the compiled slab of hex_slab.cuh with splitpost's ring
// (2, 2): the FB step's thickness and tracer levels with the transport
// velocity u_trans = (u - ubar) + <ubar> formed while the slab loads, a
// thread a row pair of the tile holding h, h_new and the tracer there in
// registers, the next tracer's slab fetched a tracer ahead, and u_new =
// (u - ubar) + dt (du_full - du_bar) + ub_final at the owned pair. uprime
// and du_slow are formed where splitpost reads them, in the reference's
// order of operations, and never stored. No float atomics: every sum over
// k runs in layer order, so the kernels agree with their plain versions run
// after run; every product that the plain version rounds before an add is
// rounded here too (mul_rn).
//
// The chain's depth average. A block takes a ticket at its start (an
// integer atomic on a counter the column pass zeroed) and works the tile
// and layer the ticket names, tiles fastest: every block with a smaller
// ticket is already running. Its owned points' partial sums over layers
// 0..k-1 wait in three scratch planes; the block of layer k waits for its
// tile's flag to say k (the block of layer k-1 has stored its sums), adds
// mean_h du_full of layer k in layer order and stores the sums (or, at
// k = K-1, divides by het and forms g_slow) and raises the flag, so no
// third pass reads h and du_full again (4 volumes) to sum the columns.
//
// Bound on this card: bytes. splitpre reads h and u twice (the column pass
// and the chain; 8 of the 4+L state volumes) and writes du_full (3 volumes)
// and 13 planes; splitpost reads the state, du_full and 12 planes and writes
// the state. The chain's stencil arithmetic (the momentum half of an RK
// stage's) out of shared memory is what the time goes to; splitpost's, the
// FB step's thickness and tracer levels'.
#include "fb_step.cuh"

namespace omega {

// the (ny, nx) planes of a split step (ops/megastep.py: P_*)
enum SplitPlane {
  P_UBAR = 0, P_SSH = 3, P_GSLOW = 4, P_HET = 7, P_DUBAR = 10, P_UBF = 13,
  P_SSHF = 16, P_UAVG = 17, P_WORK = 20
};
// where splitpost, the FB step's kernel with SPLIT, reads them
template <>
struct SplitPlanes<true> {
  static constexpr int kUbar = P_UBAR, kDubar = P_DUBAR, kUbf = P_UBF,
                       kUavg = P_UAVG;
};

// slab arrays of the chain and of splitpost (ops/megastep.py: SPLIT_SLOTS;
// splitpost: the FB step's center-flux slots)
constexpr int kSplitChainSlots = 18;
constexpr int kSplitPostSlots = fb_slots<TR_CENTER>();

namespace split {

// the chain's tile, ring and block (the RK stage's: its momentum half)
using Geo = HexSlab<16, 32, 2, 3, 256>;
constexpr int kBY = Geo::kBY, kBX = Geo::kBX, kRY = Geo::kRY, kRX = Geo::kRX;
constexpr int kXX = Geo::kXX, kS = Geo::kS, kGuard = Geo::kGuard;
constexpr int kThreads = Geo::kThreads;
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
// the column pass's block
constexpr int kColThreads = 256;
static_assert(kRY % 2 == 0, "the slab's first row is even");
static_assert(Geo::kYY % 4 == 0, "the slab is whole row quads");

// the chain's counters during splitpre, in the last work plane (the
// barotropic kernel's ping-pong buffer, free until the subcycles): the
// ticket counter, then one flag per tile
template <typename T>
__device__ __forceinline__ int* counters(T* planes, long long plane) {
  return reinterpret_cast<int*>(planes + (P_WORK + 3) * plane);
}

// a load that bypasses the SM's L1 (another block on the SM may have read
// the line before the block that wrote it stored it)
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

}  // namespace split

// pass 1: the column sums of the mode split, a thread per cell column and
// its three edge columns; zeroes the chain's ticket counter and flags
template <typename T>
__global__ void __launch_bounds__(split::kColThreads)
split_columns_kernel(const T* __restrict__ in, T* __restrict__ planes,
                     const __grid_constant__ FbParams<T> p, T depth,
                     int ntiles) {
  using namespace split;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const int tid = blockIdx.x * kColThreads + threadIdx.x;
  int* const cnt = counters(planes, plane);
  for (int i = tid; i <= ntiles; i += gridDim.x * kColThreads) cnt[i] = 0;
  if (tid >= plane) return;
  const int y = tid / p.nx, x = tid - y * p.nx;
  const bool odd = (y & 1) != 0;
  // the cells of edge class t's cmean entries (hex_ent, the compiled
  // pattern), as plane offsets with the periodic wrap
  long long nb[3][2];
  T w[3][2];
  static_for<3>([&](auto tc) {
    constexpr int t = decltype(tc)::value;
    static_for<2>([&](auto ic_) {
      constexpr int i = decltype(ic_)::value;
      constexpr int e = tab_base(T_CMEAN) + t * tab_count(T_CMEAN) + i;
      constexpr int dy = hex_ent(e, 1), dxe = hex_ent(e, 2),
                    dxo = hex_ent(e, 3);
      const int dx = odd ? dxo : dxe;
      nb[t][i] = static_cast<long long>(wrap_near(y + dy, p.ny)) * p.nx +
                 wrap_near(x + dx, p.nx);
      w[t][i] = p.w[e];
    });
  });
  const long long chan = static_cast<long long>(p.K) * plane;
  const T* const h = in;
  const T* const u = in + chan;
  // layer k's loads: h at the cell, at the edges' cells, u of the edges
  struct Layer {
    T hc, hn[3][2], u[3];
  };
  const auto load = [&](int k, Layer& v) {
    const long long lay = k * plane;
    v.hc = h[lay + tid];
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      v.hn[t][0] = h[lay + nb[t][0]];
      v.hn[t][1] = h[lay + nb[t][1]];
      v.u[t] = u[t * chan + lay + tid];
    }
  };
  T sh = T(0), he[3], uh[3];
  Layer cur, nxt;
  load(0, cur);
  for (int k = 0; k < p.K; ++k) {
    if (k + 1 < p.K) load(k + 1, nxt);
    sh = k == 0 ? cur.hc : sh + cur.hc;
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      T mh = T(0);   // cmean(h) in entry order, as apply() sums it
      mh += w[t][0] * cur.hn[t][0];
      mh += w[t][1] * cur.hn[t][1];
      const T x = mul_rn(mh, cur.u[t]);
      he[t] = k == 0 ? mh : he[t] + mh;
      uh[t] = k == 0 ? x : uh[t] + x;
    }
    cur = nxt;
  }
  planes[P_SSH * plane + tid] = sh - depth;
  _Pragma("unroll") for (int t = 0; t < 3; ++t) {
    planes[(P_HET + t) * plane + tid] = he[t];
    planes[(P_UBAR + t) * plane + tid] = uh[t] / he[t];
  }
}

// pass 2: du_full of one layer and tile, the momentum half of the RK stage
// (rk_stage.cuh) with the column ssh; the depth average carried from layer
// to layer in layer order, and the slow forcing at the last layer
template <typename T>
__global__ void __launch_bounds__(split::kThreads, split::kMinBlocks<T>)
split_chain_kernel(const T* __restrict__ in, T* __restrict__ planes,
                   T* __restrict__ du, const __grid_constant__ FbParams<T> p,
                   T ggrad, T fe, T r) {
  using namespace split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ticket;
  T* const sm = reinterpret_cast<T*>(smem_raw) + kGuard;
  // slab arrays (kS elements each): H (then the sshc plane), U (3), F =
  // cmean(h) u (3, then ubar at the last layer), KE, DIVU (then D2DIV), RV
  // (2, then D2RV), NRV (2) and NPV (2) (then D2E, 3), Q (3)
  T* const H = sm;
  T* const SSH = sm;
  T* const U = sm + 1 * kS;
  T* const F = sm + 4 * kS;
  T* const UB = sm + 4 * kS;
  T* const KE = sm + 7 * kS;
  T* const DIVU = sm + 8 * kS;
  T* const RV = sm + 9 * kS;
  T* const NRV = sm + 11 * kS;
  T* const NPV = sm + 13 * kS;
  T* const Q = sm + 15 * kS;
  T* const D2E = sm + 11 * kS;
  T* const D2DIV = sm + 8 * kS;
  T* const D2RV = sm + 9 * kS;

  const long long plane = static_cast<long long>(p.ny) * p.nx;
  int* const cnt = counters(planes, plane);
  if (threadIdx.x == 0) ticket = atomicAdd(cnt, 1);
  __syncthreads();
  const int gx = (p.nx + kBX - 1) / kBX;
  const int ntiles = gx * ((p.ny + kBY - 1) / kBY);
  const int tile = ticket % ntiles, k = ticket / ntiles;
  const int y0 = (tile / gx) * kBY, x0 = (tile % gx) * kBX;
  const int gy0 = y0 - kRY, gx0 = x0 - kRX;
  const auto chan = [&](int ch) {
    return (static_cast<long long>(ch) * p.K + k) * plane;
  };
  const auto gofs = [&](int q) {
    const int sy = q / kXX, sx = q - sy * kXX;
    return static_cast<long long>(wrap_any(gy0 + sy, p.ny)) * p.nx +
           wrap_any(gx0 + sx, p.nx);
  };
  const auto at = [](const T* a) { return [a](int r) { return a[r]; }; };

  // the thread's owned pair: column ox, rows oy (even) and oy + 1 of the tile
  const int oy = 2 * (threadIdx.x / kBX), ox = threadIdx.x % kBX;
  const bool own = y0 + oy < p.ny && x0 + ox < p.nx;
  const int qo = (oy + kRY) * kXX + ox + kRX;
  const long long go = static_cast<long long>(y0 + oy) * p.nx + x0 + ox;
  const auto owned = [&](auto&& f) {
    if (!own) return;
    f(ic<0>{}, qo, go);
    f(ic<1>{}, qo + kXX, go + p.nx);
  };

  for (int q = threadIdx.x; q < kS; q += kThreads) {
    const long long g = gofs(q);
    H[q] = in[chan(0) + g];
    U[q] = in[chan(1) + g];
    U[kS + q] = in[chan(2) + g];
    U[2 * kS + q] = in[chan(3) + g];
  }
  __syncthreads();

  // ---- F = cmean(h) u on the slab; mean_h at the owned pair
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      F[t * kS + q] = Geo::ap<T_CMEAN, t, PAR>(p, q, at(H)) * U[t * kS + q];
    });
  });
  T mho[3][2];
  owned([&](auto par, int q, long long) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      mho[t][PAR] = Geo::ap<T_CMEAN, t, PAR>(p, q, at(H));
    });
  });
  // ---- momentum aux: ke, div, curl, the normalized vorticities
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    KE[q] = Geo::ap<T_KE, 0, PAR>(p, q, [&](int r) { return U[r] * U[r]; });
    DIVU[q] = Geo::ap<T_DIV, 0, PAR>(p, q, at(U));
    static_for<2>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T rv = Geo::ap<T_CURL, t, PAR>(p, q, at(U));
      const T hv = Geo::ap<T_KITE, t, PAR>(p, q, at(H));
      RV[t * kS + q] = rv;
      NRV[t * kS + q] = rv / hv;
      NPV[t * kS + q] = p.f0v / hv;
    });
  });
  __syncthreads();
  // edge PV; the sshc plane into H's slot; du's del2 term at the owned
  // pair, in registers
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T nrv_e = Geo::ap<T_VMEAN, t, PAR>(p, q, at(NRV));
      const T npv_e = Geo::ap<T_VMEAN, t, PAR>(p, q, at(NPV));
      Q[t * kS + q] = nrv_e + npv_e;
    });
  });
  for (int q = threadIdx.x; q < kS; q += kThreads)
    SSH[q] = planes[P_SSH * plane + gofs(q)];
  // the du diffusion terms use plain 1/dv, del2_e the floored one
  T del2[3][2];
  owned([&](auto par, int q, long long) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::ap<T_VDIFF, t, PAR>(p, q, at(RV));
      del2[t][PAR] = cdd * p.inv_dc - vdr * p.inv_dv;
    });
  });
  __syncthreads();
  // del2 of u on edges (into the normalized vorticities' slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T cdd = Geo::ap<T_CDIFF, t, PAR>(p, q, at(DIVU));
      const T vdr = Geo::ap<T_VDIFF, t, PAR>(p, q, at(RV));
      D2E[t * kS + q] = cdd * p.inv_dc - vdr * p.inv_dv_floor;
    });
  });
  __syncthreads();
  // div and curl of del2 on edges (into div u's and curl u's slots)
  Geo::rows([&](auto par, int q) {
    constexpr int PAR = decltype(par)::value;
    const T dd = Geo::ap<T_DIV, 0, PAR>(p, q, at(D2E));
    const T r0 = Geo::ap<T_CURL, 0, PAR>(p, q, at(D2E));
    const T r1 = Geo::ap<T_CURL, 1, PAR>(p, q, at(D2E));
    D2DIV[q] = dd;
    D2RV[q] = r0;
    D2RV[kS + q] = r1;
  });
  __syncthreads();

  // ---- du_full at the owned pair (rk_stage.cuh's du with the gradient of
  // the sshc plane), and what it adds to the depth average
  T x[3][2];
  owned([&](auto par, int q, long long g) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      // tang(F) and tang(F*q) share the walk
      T tf = T(0), tfq = T(0);
      static_for<tab_count(T_TANG)>([&](auto ic_) {
        constexpr int e =
            tab_base(T_TANG) + t * tab_count(T_TANG) + decltype(ic_)::value;
        constexpr int o = Geo::off(e, PAR);
        const T f = F[q + o];
        tf += p.w[e] * f;
        tfq += p.w[e] * (f * Q[q + o]);
      });
      const T qe = Q[t * kS + q];
      const T pv = T(0.5) * (qe * tf + tfq);
      const T gke = Geo::ap<T_CDIFF, t, PAR>(p, q, at(KE));
      const T gssh = Geo::ap<T_CDIFF, t, PAR>(p, q, at(SSH));
      const T cd4 = Geo::ap<T_CDIFF, t, PAR>(p, q, at(D2DIV));
      const T vd4 = Geo::ap<T_VDIFF, t, PAR>(p, q, at(D2RV));
      const T d = pv - gke * p.inv_dc - p.grav * gssh * p.inv_dc +
                  p.nu2s * del2[t][PAR] -
                  p.nu4s * (p.div_factor * cd4 * p.inv_dc - vd4 * p.inv_dv);
      du[(static_cast<long long>(t) * p.K + k) * plane + g] = d;
      x[t][PAR] = mul_rn(mho[t][PAR], d);
    });
  });

  // ---- the depth average: wait for layer k-1 of this tile, add layer k
  T* const acc = planes + P_WORK * plane;
  int* const flag = cnt + 1 + tile;
  if (threadIdx.x == 0 && k > 0) {
    while (*static_cast<volatile int*>(flag) != k) {
    }
    __threadfence();
  }
  __syncthreads();
  owned([&](auto par, int, long long g) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      T* const a = acc + t * plane + g;
      x[t][PAR] = k == 0 ? x[t][PAR] : load_cg(a) + x[t][PAR];
      if (k < p.K - 1) *a = x[t][PAR];
    });
  });
  if (k < p.K - 1) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(flag, k + 1);
    return;
  }

  // ---- the last layer: du_bar and the slow forcing at the owned pair
  for (int q = threadIdx.x; q < kS; q += kThreads) {
    const long long g = gofs(q);
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      UB[t * kS + q] = planes[(P_UBAR + t) * plane + g];
  }
  __syncthreads();
  owned([&](auto par, int q, long long g) {
    constexpr int PAR = decltype(par)::value;
    static_for<3>([&](auto tc) {
      constexpr int t = decltype(tc)::value;
      const T dubar = x[t][PAR] / planes[(P_HET + t) * plane + g];
      const T fast0 = mul_rn(ggrad, Geo::ap<T_CDIFF, t, PAR>(p, q, at(SSH))) +
                      mul_rn(fe, Geo::ap<T_TANG, t, PAR>(p, q, at(UB))) -
                      mul_rn(r, UB[t * kS + q]);
      planes[(P_GSLOW + t) * plane + g] = dubar - fast0;
      planes[(P_DUBAR + t) * plane + g] = dubar;
    });
  });
}

// splitpre: the column pass, then the chain (whose record is packed for the
// compiled tile, ring and entry pattern); `threads` must be the chain's
// block
template <typename T>
int launch_split_pre(const void* in, void* du, void* planes,
                     const FbParams<T>* hp, double depth, double ggrad,
                     double fe, double r, int threads, cudaStream_t stream) {
  using namespace split;
  if (in == nullptr || du == nullptr || planes == nullptr || hp == nullptr)
    return cudaErrorInvalidValue;
  const FbParams<T>& p = *hp;
  if (threads != kThreads) return cudaErrorInvalidConfiguration;
  if (!layout_ok(p) || !Geo::geometry_ok(p) || p.K < 1)
    return cudaErrorInvalidValue;
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const long long ntiles = static_cast<long long>((p.nx + kBX - 1) / kBX) *
                           ((p.ny + kBY - 1) / kBY);
  if (ntiles * p.K >= (1LL << 31)) return cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(in);
  T* pl = static_cast<T*>(planes);
  split_columns_kernel<T><<<static_cast<unsigned>((plane + kColThreads - 1) /
                                                  kColThreads),
                            kColThreads, 0, stream>>>(
      s, pl, p, static_cast<T>(depth), static_cast<int>(ntiles));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = slab_smem_bytes(p, kSplitChainSlots);
  err = cudaFuncSetAttribute(split_chain_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split_chain_kernel<T><<<static_cast<unsigned>(ntiles * p.K), kThreads, smem,
                          stream>>>(s, pl, static_cast<T*>(du), p,
                                    static_cast<T>(ggrad), static_cast<T>(fe),
                                    static_cast<T>(r));
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of splitpre's kernels (pass 0 the column pass, 1
// the chain): numRegs, localSizeBytes, sharedSizeBytes into out[0..2], and
// the blocks an SM holds at the launch's block and dynamic shared memory
// (out[3])
template <typename T>
int split_pre_attrs(int pass, int* out) {
  using namespace split;
  if (out == nullptr || pass < 0 || pass > 1) return cudaErrorInvalidValue;
  const void* k = pass == 0 ? reinterpret_cast<const void*>(
                                  &split_columns_kernel<T>)
                            : reinterpret_cast<const void*>(
                                  &split_chain_kernel<T>);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      pass == 0 ? 0
                : (kSplitChainSlots * static_cast<size_t>(kS) + 2 * kGuard) *
                      sizeof(T);
  if (pass == 1) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, pass == 0 ? kColThreads : kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

// splitpost: one launch of the FB step's kernel with the switch SPLIT
// (fb_step.cuh), whose record is packed for its compiled tile, ring (2, 2)
// and entry pattern; `threads` must be its block
template <typename T>
int launch_split_post(const void* in, const void* du, const void* planes,
                      void* out, const FbParams<T>* hp, int threads,
                      cudaStream_t stream) {
  using Geo = fb::PostGeo;
  if (in == nullptr || du == nullptr || planes == nullptr || out == nullptr ||
      hp == nullptr || out == in) {
    return cudaErrorInvalidValue;
  }
  const FbParams<T>& p = *hp;
  if (threads != Geo::kThreads) return cudaErrorInvalidConfiguration;
  if (!layout_ok(p) || !Geo::geometry_ok(p) || p.K < 1)
    return cudaErrorInvalidValue;
  auto* const k = &fb_step_kernel<T, false, TR_CENTER, false, true>;
  const size_t smem = slab_smem_bytes(p, kSplitPostSlots);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<slab_grid(p), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), nullptr,
      static_cast<const T*>(du), static_cast<const T*>(planes), p);
  return static_cast<int>(cudaGetLastError());
}

// cudaFuncGetAttributes of splitpost's kernel: numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2], and the blocks an SM holds at its block
// and dynamic shared memory (out[3])
template <typename T>
int split_post_attrs(int* out) {
  using Geo = fb::PostGeo;
  if (out == nullptr) return cudaErrorInvalidValue;
  const void* k = reinterpret_cast<const void*>(
      &fb_step_kernel<T, false, TR_CENTER, false, true>);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      (kSplitPostSlots * static_cast<size_t>(Geo::kS) + 2 * Geo::kGuard) *
      sizeof(T);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                      Geo::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace omega

// The C interface, in both precisions. `params` point at host FbParams<T>
// (splitpre: the chain's, packed for the compiled tile, ring (2, 3) and
// entry pattern of split::Geo; splitpost: its own, for the tile, ring
// (2, 2) and entry pattern of fb::PostGeo); `in` and `out` are
// stacked (4+L, K, ny, nx) states, `du` a (3, K, ny, nx) array, `planes` the
// (24, ny, nx) planes (splitpre keeps its counters and partial sums in the
// work planes 20..23). depth, ggrad = -g/dc, fe = f_edge and r = the linear
// drag are rounded to T once here. Each returns the first refused launch's
// error code, or 0. omega_split_pre_attrs_*(pass, out): registers, local
// (spill) bytes, static shared bytes and blocks per SM of the column pass
// (0) or the chain (1); omega_split_post_attrs_*(out): the same of
// splitpost's kernel.
#define OMEGA_SPLIT_ENTRIES(SUF, T)                                           \
  int omega_split_pre_##SUF(const void* in, void* du, void* planes,           \
                            const void* params, double depth, double ggrad,   \
                            double fe, double r, int threads, void* stream) { \
    return omega::launch_split_pre<T>(                                        \
        in, du, planes, static_cast<const omega::FbParams<T>*>(params),       \
        depth, ggrad, fe, r, threads, static_cast<cudaStream_t>(stream));     \
  }                                                                           \
  int omega_split_pre_attrs_##SUF(int pass, int* out) {                       \
    return omega::split_pre_attrs<T>(pass, out);                              \
  }                                                                           \
  int omega_split_post_##SUF(const void* in, const void* du,                  \
                             const void* planes, void* out,                   \
                             const void* params, int threads, void* stream) { \
    return omega::launch_split_post<T>(                                       \
        in, du, planes, out, static_cast<const omega::FbParams<T>*>(params),  \
        threads, static_cast<cudaStream_t>(stream));                          \
  }                                                                           \
  int omega_split_post_attrs_##SUF(int* out) {                                \
    return omega::split_post_attrs<T>(out);                                   \
  }

extern "C" {

OMEGA_SPLIT_ENTRIES(f32, float)
OMEGA_SPLIT_ENTRIES(f64, double)

// slab arrays of a split slab kernel: 1 the chain, 3 splitpost
int omega_split_slots(int pass) {
  switch (pass) {
    case 1: return omega::kSplitChainSlots;
    case 3: return omega::kSplitPostSlots;
    default: return -1;
  }
}

}  // extern "C"
