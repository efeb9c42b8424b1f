// All barotropic forward-backward subcycles of a split-explicit step, one
// launch per subcycle, every launch made by one C call.
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
// The TPU kernel keeps the whole domain (ten 256 x 256 planes, 2.6 MB)
// resident in VMEM for all M subcycles, exact for any M. A Hopper block has
// 227 KB of shared memory, so here a launch is one subcycle: a block loads
// its (by+2ry) x (bx+2rx) slab of (ub, ssh) with the ring of ONE subcycle
// (ops/barotropic_kernel.py:ring, probed from the plain chain: 2 x 2 on the
// hex mesh), evaluates ub_new and het*ub_new on the slab, then writes
// ub_new, ssh_new and acc at its owned points to the other of two buffers.
// Nothing is recomputed across subcycles, so the result is exact for any M.
// The C call ping-pongs between `work` and `out` so that the last subcycle
// writes `out`; the planes (4.5 MB) stay in the 50 MB L2 between launches.
//
// Bound on this card: the launches. The bytes (ten planes read, seven
// written) take about 1.3 us at 3.35 TB/s; M launches of a small kernel take
// some microseconds each. One cooperative launch with grid-wide syncs, or a
// cluster holding the state in distributed shared memory, would cut that.
#include "slab_chain.cuh"

namespace omega {

// slab arrays: ub x3, ssh, ub_new x3, het * ub_new x3
constexpr int kBtSlots = 10;

template <typename T>
__global__ void __launch_bounds__(512)
bt_subcycle_kernel(const T* __restrict__ src, T* __restrict__ dst,
                   const T* __restrict__ forcing, T* __restrict__ avg,
                   const __grid_constant__ FbParams<T> p, T dt_bt, T ggrad,
                   T fe, T r, int first, int last, T m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Slab sl(p);
  const int S = sl.S;
  T* const sm = reinterpret_cast<T*>(smem_raw) + p.guard;
  T* const UB = sm;             // ub, 3 edge classes
  T* const SSH = sm + 3 * S;
  T* const UBN = sm + 4 * S;    // ub_new, 3
  T* const HU = sm + 7 * S;     // het * ub_new, 3
  const long long plane = sl.plane;

  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    const long long g = sl.gofs(p, q);
    _Pragma("unroll") for (int t = 0; t < 3; ++t)
      UB[t * S + q] = src[t * plane + g];
    SSH[q] = src[3 * plane + g];
  }
  __syncthreads();

  // forcing: g_slow x3 then het x3, read where the slab point is evaluated
  FOR_SLAB(q, sy) {
    const bool odd = sl.is_odd(sy);
    const long long g = sl.gofs(p, q);
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T u = UB[t * S + q];
      const T f = ((mul_rn(ggrad, AP(T_CDIFF, t, at(SSH))) +
                    mul_rn(fe, AP(T_TANG, t, at(UB)))) -
                   mul_rn(r, u)) +
                  forcing[t * plane + g];
      const T un = u + mul_rn(dt_bt, f);
      UBN[t * S + q] = un;
      HU[t * S + q] = mul_rn(forcing[(3 + t) * plane + g], un);
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < sl.nown; o += blockDim.x) {
    int q;
    long long g;
    bool odd;
    if (!sl.owned(p, o, q, g, odd)) continue;
    dst[3 * plane + g] = SSH[q] - mul_rn(dt_bt, AP(T_DIV, 0, at(HU)));
    _Pragma("unroll") for (int t = 0; t < 3; ++t) {
      const T un = UBN[t * S + q];
      dst[t * plane + g] = un;
      const T a = first ? un : avg[t * plane + g] + un;
      avg[t * plane + g] = last ? a / m : a;
    }
  }
}

template <typename T>
int launch_barotropic(const void* in, void* out, void* work,
                      const FbParams<T>* hp, double dt_bt, double ggrad,
                      double fe, double r, int M, int threads,
                      cudaStream_t stream) {
  const FbParams<T>& p = *hp;
  if (threads < 32 || threads > 512) return cudaErrorInvalidConfiguration;
  if (!layout_ok(p) || p.K != 1 || M < 1) return cudaErrorInvalidValue;
  if (in == nullptr || out == nullptr || work == nullptr || in == out ||
      in == work || out == work) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = slab_smem_bytes(p, kBtSlots);
  cudaError_t err = cudaFuncSetAttribute(
      bt_subcycle_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long plane = static_cast<long long>(p.ny) * p.nx;
  // in: ub x3, ssh, g_slow x3, het x3; out: ub x3, ssh, <ubar> x3
  const T* const planes_in = static_cast<const T*>(in);
  T* const o = static_cast<T*>(out);
  T* const w = static_cast<T*>(work);
  const T* src = planes_in;
  for (int i = 0; i < M; ++i) {
    T* const dst = (M - 1 - i) % 2 == 0 ? o : w;
    bt_subcycle_kernel<T><<<slab_grid(p), threads, smem, stream>>>(
        src, dst, planes_in + 4 * plane, o + 4 * plane, p,
        static_cast<T>(dt_bt), static_cast<T>(ggrad), static_cast<T>(fe),
        static_cast<T>(r), i == 0, i == M - 1, static_cast<T>(M));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace omega

// The C interface, in both precisions: omega_barotropic_<f32|f64>. `in` is
// the (10, ny, nx) stack (ubar x3, ssh, g_slow x3, het x3), `out` (7, ny, nx)
// receives (ub_final x3, ssh_final, <ubar> x3), `work` is a (4, ny, nx)
// buffer; `params` points at a host FbParams<T> with K = 1. Returns the first
// refused launch's error code, or 0.
#define OMEGA_BT_ENTRY(SUF, T)                                               \
  int omega_barotropic_##SUF(const void* in, void* out, void* work,          \
                             const void* params, double dt_bt, double ggrad, \
                             double fe, double r, int M, int threads,        \
                             void* stream) {                                 \
    return omega::launch_barotropic<T>(                                      \
        in, out, work, static_cast<const omega::FbParams<T>*>(params),       \
        dt_bt, ggrad, fe, r, M, threads, static_cast<cudaStream_t>(stream)); \
  }

extern "C" {

OMEGA_BT_ENTRY(f32, float)
OMEGA_BT_ENTRY(f64, double)

int omega_bt_slots() { return omega::kBtSlots; }

}  // extern "C"
