// One weighted gather pass over a host-built table (ops/gather_kernel.py):
//
//   out[l, n, k] = sum_j w[n, j] * field[l, idx[n, j], k]
//
// for n < N, every leading index l < L and k < K, the slots summed in slot
// order with every product rounded on its own (mul_rn), as the plain version
// (gather_kernel.apply_plain) does, so the two agree bit for bit.
//
// Replaces the JAX package's windowed Pallas gather
// (omega_tpu/ops/pallas_gather.py:_kernel, pallas_call at :160). That kernel
// DMAs each 256-row block's window of source rows into VMEM and computes the
// block as a one-hot matrix product on the MXU, one call per leading index.
//
// Here the gather is direct, one launch over every leading index: a group of
// threads takes one row, each thread one 16-byte vector of K (VW = 4 floats
// or 2 doubles; narrower where K or the pointers do not allow it), loads the
// row's slots once into registers (rows of up to kMaxSlots slots; a wider
// row reads its slots from the table at every leading index), and reads its
// sources through the L2 with 16-byte loads, reusing the slots for every
// leading index; no 64-bit division per element.
//
// Bound on this card: bytes (port_bounds.gather: 0.0347 ms for the
// tangential table with two leading indices at icos48 x 100, 0.0114 for the
// divergence with one). A form that staged each 256-row block's distinct
// source rows in shared memory (cp.async, double-buffered K-tiles) read the
// L2 up to three times less but ran 3.5-11x slower than this one on every
// table at icos48 x 100 in float32 on an H100 (PERF.md, row 6).
#include "stencil_common.cuh"

#include <cstdint>

namespace omega {
namespace gather {

constexpr int kThreads = 256;   // threads per block
constexpr int kMaxSlots = 16;   // the widest row whose slots sit in registers

// VW consecutive values of K, loaded and stored as one access
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

template <typename T, int VW>
__device__ __forceinline__ Pack<T, VW> mul(T w, const Pack<T, VW>& x) {
  Pack<T, VW> r;
  _Pragma("unroll") for (int i = 0; i < VW; ++i) r.v[i] = mul_rn(w, x.v[i]);
  return r;
}

template <typename T, int VW>
__device__ __forceinline__ void add(Pack<T, VW>& s, const Pack<T, VW>& x) {
  _Pragma("unroll") for (int i = 0; i < VW; ++i) s.v[i] = s.v[i] + x.v[i];
}

// ------------------------------------------------------------- direct
// thread g -> row n = g / nv, vector v = g % nv of K. MC > 0: the row's
// slots (at most MC) in registers, as element offsets into one leading
// index's field; MC = 0: a row of any width, its slots read from the table
// at every leading index
template <typename T, int VW, int MC>
__global__ void __launch_bounds__(kThreads)
gather_direct(const T* __restrict__ field, T* __restrict__ out,
              const int* __restrict__ idx, const T* __restrict__ w, int N,
              int M, int K, int nsrc, int L) {
  using P = Pack<T, VW>;
  const int nv = K / VW;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= N * nv) return;
  const int n = g / nv;
  const int v = g - n * nv;
  const long long fs = static_cast<long long>(nsrc) * K;
  const long long os = static_cast<long long>(N) * K;
  const auto at = [&](const T* f, int off) {
    return *reinterpret_cast<const P*>(f + off);
  };
  if constexpr (MC == 0) {
    const int* ir = idx + static_cast<long long>(n) * M;
    const T* wr = w + static_cast<long long>(n) * M;
    for (int l = 0; l < L; ++l) {
      const T* f = field + l * fs + v * VW;
      P s = mul(wr[0], at(f, ir[0] * K));
      for (int j = 1; j < M; ++j) add(s, mul(wr[j], at(f, ir[j] * K)));
      *reinterpret_cast<P*>(out + l * os + n * K + v * VW) = s;
    }
  } else {
    int ix[MC];
    T wr[MC];
    _Pragma("unroll") for (int j = 0; j < MC; ++j) {
      if (j < M) {
        ix[j] = idx[n * M + j] * K + v * VW;
        wr[j] = w[n * M + j];
      }
    }
    for (int l = 0; l < L; ++l) {
      const T* f = field + l * fs;
      P s = mul(wr[0], at(f, ix[0]));
      _Pragma("unroll") for (int j = 1; j < MC; ++j) {
        if (j < M) add(s, mul(wr[j], at(f, ix[j])));
      }
      *reinterpret_cast<P*>(out + l * os + n * K + v * VW) = s;
    }
  }
}

// the launch for a slot capacity MC >= M (0: any M)
template <typename T, int MC>
int launch_mc(const T* field, T* out, const int* idx, const T* w, int N,
              int M, int K, int nsrc, int L, cudaStream_t stream) {
  // the widest vector that K and both pointers allow
  const auto fits = [&](int vw) {
    const auto a = static_cast<std::uintptr_t>(vw * sizeof(T));
    return K % vw == 0 && reinterpret_cast<std::uintptr_t>(field) % a == 0 &&
           reinterpret_cast<std::uintptr_t>(out) % a == 0;
  };
  constexpr int kWide = 16 / sizeof(T);
  const int vw = fits(kWide) ? kWide : fits(2) ? 2 : 1;
  const long long rows = static_cast<long long>(N) * (K / vw);
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
#define OMEGA_GATHER_DIRECT(VW)                                           \
  gather_direct<T, VW, MC><<<blocks, kThreads, 0, stream>>>(              \
      field, out, idx, w, N, M, K, nsrc, L);
  if (vw == kWide) {
    OMEGA_GATHER_DIRECT(kWide)
  } else if (vw == 2) {
    OMEGA_GATHER_DIRECT(2)
  } else {
    OMEGA_GATHER_DIRECT(1)
  }
#undef OMEGA_GATHER_DIRECT
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* field, void* out, const void* idx, const void* w,
           const int* n, cudaStream_t stream) {
  const int N = n[0], M = n[1], K = n[2], nsrc = n[3], L = n[4];
  // element offsets (source row x K, row x K, row x M) stay within int
  if (N < 1 || M < 1 || K < 1 || nsrc < 1 || L < 1 ||
      static_cast<long long>(nsrc) * K > 2147483647LL ||
      static_cast<long long>(N) * K > 2147483647LL ||
      static_cast<long long>(N) * M > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  if (field == nullptr || out == nullptr || idx == nullptr || w == nullptr ||
      field == out) {
    return cudaErrorInvalidValue;
  }
  const T* f = static_cast<const T*>(field);
  T* o = static_cast<T*>(out);
  const int* ix = static_cast<const int*>(idx);
  const T* wt = static_cast<const T*>(w);
#define OMEGA_GATHER_MC(MC) \
  if (M <= MC) return launch_mc<T, MC>(f, o, ix, wt, N, M, K, nsrc, L, stream);
  OMEGA_GATHER_MC(1)
  OMEGA_GATHER_MC(2)
  OMEGA_GATHER_MC(3)
  OMEGA_GATHER_MC(6)
  OMEGA_GATHER_MC(12)
  OMEGA_GATHER_MC(kMaxSlots)
#undef OMEGA_GATHER_MC
  return launch_mc<T, 0>(f, o, ix, wt, N, M, K, nsrc, L, stream);
}

}  // namespace gather
}  // namespace omega

// omega_gather_<f32|f64>: out (L, N, K) from field (L, nsrc, K), both
// contiguous, over a table of rows of M slots, the first N rows read: `idx`
// (int32, source rows) and `w` (the field's type). `ints` = N, M, K, nsrc,
// L. Returns the launch's error code, or 0.
#define OMEGA_GATHER_ENTRY(SUF, T)                                           \
  int omega_gather_##SUF(const void* field, void* out, const void* idx,      \
                         const void* w, const int* ints, void* stream) {     \
    return omega::gather::launch<T>(field, out, idx, w, ints,                \
                                    static_cast<cudaStream_t>(stream));      \
  }

extern "C" {
OMEGA_GATHER_ENTRY(f32, float)
OMEGA_GATHER_ENTRY(f64, double)
}
