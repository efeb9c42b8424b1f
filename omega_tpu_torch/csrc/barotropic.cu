// All barotropic forward-backward subcycles of a split-explicit step as ONE
// cooperative launch: the subcycles meet at a grid-wide barrier, not at a
// kernel boundary.
//
// Replaces the TPU kernel omega_tpu/ops/barotropic_kernel.py:_kernel. Each
// subcycle, on the 2-D planes of the step (ub x3 edge classes, ssh; the
// frozen forcing g_slow x3 and the column edge thickness het x3):
//
//   ub_new  = ub + dt_bt ((ggrad cdiff(ssh) + f_e tang(ub) - r ub) + g_slow)
//   ssh_new = ssh - dt_bt div(het ub_new)
//   acc     = acc + ub_new;  after the last subcycle <ubar> = acc / M
//
// with ggrad = -g/dc, folded in float64 and rounded once, as the JAX kernel
// folds -g * inv_dc; every product that the plain version rounds is rounded
// here too (mul_rn).
//
// The TPU kernel keeps the whole domain (ten 256 x 256 planes) resident in
// VMEM for all M subcycles. Here a block owns a 16 x 32 tile with the (2, 2)
// ring of ONE subcycle (ops/barotropic_kernel.py:ring), on the compiled
// geometry and entry pattern of hex_slab.cuh (every stencil read one shared
// load at an immediate offset). A subcycle loads the (ub x3, ssh) slab from
// the current ping-pong buffer (L2-resident), forms ub_new and het * ub_new
// on the slab and writes ssh_new and ub_new at the owned points to the other
// buffer; then every block meets at grid.sync(), whose release and acquire
// at device scope make those writes visible to the plain loads of the next
// subcycle. Nothing is recomputed across subcycles, so the result is exact
// for any M. The buffers are `work` and `out`, chosen so that the last
// subcycle writes `out`.
//
// Resident form (every tile a block of its own, as at 256 x 256: 128 tiles):
// the frozen planes' slab (g_slow x3, het x3) is staged in shared memory
// once for all M, and the accumulator of the thread's owned pair stays in
// registers, written once as acc / M. Where the mesh has more tiles than
// the card holds blocks, each block walks several tiles a subcycle, stages
// the frozen slab with each, and keeps the accumulator in `out` (the
// streamed form). The launcher sizes the grid from the occupancy query and
// the SM count; a grid the card cannot make co-resident is refused.
//
// Bound on this card: the M grid barriers, not the bytes. The ten planes
// read and seven written take about 1.3 us at 3.35 TB/s, a subcycle's
// arithmetic about a microsecond, and all of it stays in the 50 MB L2.
#include <cooperative_groups.h>

#include "coop.cuh"
#include "hex_slab.cuh"

namespace omega {
namespace bt {

// the tile, ring and block the kernel is compiled for
using Geo = HexSlab<16, 32, 2, 2, 256>;
constexpr int kBY = Geo::kBY, kBX = Geo::kBX, kRY = Geo::kRY, kRX = Geo::kRX;
constexpr int kXX = Geo::kXX, kS = Geo::kS, kGuard = Geo::kGuard;
constexpr int kThreads = Geo::kThreads;
// slab arrays: ub x3, ssh, ub_new x3, het * ub_new x3, g_slow x3, het x3
constexpr int kSlots = 16;
static_assert(kRY % 2 == 0, "the slab's first row is even");

template <typename T>
struct Args {
  const T* in;   // (10, ny, nx): ub x3, ssh, g_slow x3, het x3
  T* out;        // (7, ny, nx): ub x3, ssh, <ubar> x3
  T* work;       // (4, ny, nx): the other ub / ssh buffer
  T dt_bt, ggrad, fe, r, m;
  int M, gx, ntiles;
};

}  // namespace bt

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(bt::kThreads)
bt_kernel(const __grid_constant__ FbParams<T> p,
          const __grid_constant__ bt::Args<T> a) {
  using namespace bt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw) + kGuard;
  T* const UB = sm;             // ub, 3 edge classes
  T* const SSH = sm + 3 * kS;
  T* const UBN = sm + 4 * kS;   // ub_new, 3
  T* const HU = sm + 7 * kS;    // het * ub_new, 3
  T* const GS = sm + 10 * kS;   // g_slow, 3
  T* const HET = sm + 13 * kS;  // het, 3
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  const auto at = [](const T* x) { return [x](int r) { return x[r]; }; };
  // the thread's owned pair: column ox, rows oy (even) and oy + 1 of a tile
  const int oy = 2 * (threadIdx.x / kBX), ox = threadIdx.x % kBX;
  const int qo = (oy + kRY) * kXX + ox + kRX;
  T acc[3][2];
  // the plane offsets of the thread's slab points q = threadIdx.x +
  // k kThreads of a tile (with the periodic wrap); once, where the block
  // keeps its tile
  constexpr int kLoads = (kS + kThreads - 1) / kThreads;
  long long gq[kLoads];
  const auto offsets = [&](int tile) {
    const int gy0 = (tile / a.gx) * kBY - kRY, gx0 = (tile % a.gx) * kBX - kRX;
    _Pragma("unroll") for (int k = 0; k < kLoads; ++k) {
      const int q = threadIdx.x + k * kThreads;
      const int sy = q / kXX, sx = q - sy * kXX;
      gq[k] = static_cast<long long>(wrap_any(gy0 + sy, p.ny)) * p.nx +
              wrap_any(gx0 + sx, p.nx);
    }
  };
  if (RESIDENT) offsets(blockIdx.x);

  for (int i = 0; i < a.M; ++i) {
    // subcycle i reads what subcycle i-1 wrote; the last one writes `out`
    const T* const src =
        i == 0 ? a.in : ((a.M - i) % 2 == 0 ? a.out : a.work);
    T* const dst = (a.M - 1 - i) % 2 == 0 ? a.out : a.work;
    for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
      const int y0 = (tile / a.gx) * kBY, x0 = (tile % a.gx) * kBX;
      if (!RESIDENT) offsets(tile);
      _Pragma("unroll") for (int k = 0; k < kLoads; ++k) {
        const int q = threadIdx.x + k * kThreads;
        if (q >= kS) break;
        const long long g = gq[k];
        if (!RESIDENT || i == 0) {
          _Pragma("unroll") for (int t = 0; t < 3; ++t) {
            GS[t * kS + q] = a.in[(4 + t) * plane + g];
            HET[t * kS + q] = a.in[(7 + t) * plane + g];
          }
        }
        _Pragma("unroll") for (int t = 0; t < 3; ++t)
          UB[t * kS + q] = src[t * plane + g];
        SSH[q] = src[3 * plane + g];
      }
      __syncthreads();

      Geo::rows([&](auto par, int q) {
        constexpr int PAR = decltype(par)::value;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          const T u = UB[t * kS + q];
          const T f =
              ((mul_rn(a.ggrad, Geo::ap<T_CDIFF, t, PAR>(p, q, at(SSH))) +
                mul_rn(a.fe, Geo::ap<T_TANG, t, PAR>(p, q, at(UB)))) -
               mul_rn(a.r, u)) +
              GS[t * kS + q];
          const T un = u + mul_rn(a.dt_bt, f);
          UBN[t * kS + q] = un;
          HU[t * kS + q] = mul_rn(HET[t * kS + q], un);
        });
      });
      __syncthreads();

      // ny is even and a tile's first row is, so a pair is whole or out
      if (y0 + oy < p.ny && x0 + ox < p.nx) {
        static_for<2>([&](auto par) {
          constexpr int PAR = decltype(par)::value;
          const int q = qo + PAR * kXX;
          const long long g =
              static_cast<long long>(y0 + oy + PAR) * p.nx + x0 + ox;
          dst[3 * plane + g] =
              SSH[q] -
              mul_rn(a.dt_bt, Geo::ap<T_DIV, 0, PAR>(p, q, at(HU)));
          static_for<3>([&](auto tc) {
            constexpr int t = decltype(tc)::value;
            const T un = UBN[t * kS + q];
            dst[t * plane + g] = un;
            if (RESIDENT) {
              acc[t][PAR] = i == 0 ? un : acc[t][PAR] + un;
            } else {
              T* const av = a.out + (4 + t) * plane + g;
              const T s = i == 0 ? un : *av + un;
              *av = i == a.M - 1 ? s / a.m : s;
            }
          });
        });
      }
      if (!RESIDENT) __syncthreads();   // the next tile reloads the slab
    }
    if (i + 1 < a.M) cooperative_groups::this_grid().sync();
  }

  if (RESIDENT && blockIdx.x < a.ntiles) {
    const int y0 = (blockIdx.x / a.gx) * kBY, x0 = (blockIdx.x % a.gx) * kBX;
    if (y0 + oy < p.ny && x0 + ox < p.nx) {
      static_for<2>([&](auto par) {
        constexpr int PAR = decltype(par)::value;
        const long long g =
            static_cast<long long>(y0 + oy + PAR) * p.nx + x0 + ox;
        static_for<3>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          a.out[(4 + t) * plane + g] = acc[t][PAR] / a.m;
        });
      });
    }
  }
}

namespace bt {

inline size_t smem_bytes(size_t itemsize) {
  return (kSlots * static_cast<size_t>(kS) + 2 * kGuard) * itemsize;
}

}  // namespace bt

// All M subcycles in one cooperative launch of `grid` blocks (0: one block
// a tile where the card holds that many, else as many as it holds); the
// resident form where every tile has a block of its own
template <typename T>
int launch_barotropic(const void* in, void* out, void* work,
                      const FbParams<T>* hp, double dt_bt, double ggrad,
                      double fe, double r, int M, int grid,
                      cudaStream_t stream) {
  using namespace bt;
  if (hp == nullptr || in == nullptr || out == nullptr || work == nullptr ||
      in == out || in == work || out == work || M < 1 || grid < 0) {
    return cudaErrorInvalidValue;
  }
  const FbParams<T>& p = *hp;
  if (!layout_ok(p) || !Geo::geometry_ok(p) || p.K != 1)
    return cudaErrorInvalidValue;
  Args<T> a;
  a.in = static_cast<const T*>(in);
  a.out = static_cast<T*>(out);
  a.work = static_cast<T*>(work);
  a.dt_bt = static_cast<T>(dt_bt);
  a.ggrad = static_cast<T>(ggrad);
  a.fe = static_cast<T>(fe);
  a.r = static_cast<T>(r);
  a.m = static_cast<T>(M);
  a.M = M;
  a.gx = (p.nx + kBX - 1) / kBX;
  a.ntiles = a.gx * ((p.ny + kBY - 1) / kBY);
  const size_t smem = smem_bytes(sizeof(T));
  auto* const kr = &bt_kernel<T, true>;
  auto* const ks = &bt_kernel<T, false>;
  int sms = 0, occ_r = 0, occ_s = 0;
  int err = coop_blocks(kr, kThreads, smem, &occ_r, &sms);
  if (err == 0) err = coop_blocks(ks, kThreads, smem, &occ_s, &sms);
  if (err != 0) return err;
  if (grid == 0)
    grid = a.ntiles <= occ_r * sms ? a.ntiles : occ_s * sms;
  grid = grid < a.ntiles ? grid : a.ntiles;
  const bool resident = grid == a.ntiles && a.ntiles <= occ_r * sms;
  if (grid < 1 || grid > (resident ? occ_r : occ_s) * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<FbParams<T>*>(&p), &a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      resident ? kr : ks, dim3(grid), dim3(kThreads), args, smem, stream));
}

// cudaFuncGetAttributes of the resident (1) or streamed (0) form: numRegs,
// localSizeBytes, sharedSizeBytes into out[0..2], the blocks an SM holds at
// its block and dynamic shared memory (out[3]) and the SM count (out[4])
template <typename T>
int barotropic_attrs(int resident, int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  auto* const k = resident ? &bt_kernel<T, true> : &bt_kernel<T, false>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = coop_blocks(k, bt::kThreads, bt::smem_bytes(sizeof(T)),
                            &out[3], &out[4]);
  if (e != 0) return e;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

}  // namespace omega

// The C interface, in both precisions: omega_barotropic_<f32|f64>. `in` is
// the (10, ny, nx) stack (ubar x3, ssh, g_slow x3, het x3), `out` (7, ny, nx)
// receives (ub_final x3, ssh_final, <ubar> x3), `work` is a (4, ny, nx)
// buffer; `params` points at a host FbParams<T> with K = 1, packed for the
// compiled tile, ring (2, 2) and entry pattern; `grid` the blocks (0: the
// launcher's choice). Returns the launch's error code (a grid the card
// cannot make co-resident: cudaErrorCooperativeLaunchTooLarge), or 0.
// omega_barotropic_attrs_<f32|f64>(resident, out): registers, local (spill)
// bytes, static shared bytes, blocks per SM and the SM count.
#define OMEGA_BT_ENTRY(SUF, T)                                               \
  int omega_barotropic_##SUF(const void* in, void* out, void* work,          \
                             const void* params, double dt_bt, double ggrad, \
                             double fe, double r, int M, int grid,           \
                             void* stream) {                                 \
    return omega::launch_barotropic<T>(                                      \
        in, out, work, static_cast<const omega::FbParams<T>*>(params),       \
        dt_bt, ggrad, fe, r, M, grid, static_cast<cudaStream_t>(stream));   \
  }                                                                          \
  int omega_barotropic_attrs_##SUF(int resident, int* out) {                 \
    return omega::barotropic_attrs<T>(resident, out);                        \
  }

extern "C" {

OMEGA_BT_ENTRY(f32, float)
OMEGA_BT_ENTRY(f64, double)

int omega_bt_slots() { return omega::bt::kSlots; }

}  // extern "C"
