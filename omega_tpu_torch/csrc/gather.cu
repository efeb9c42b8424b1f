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
// Here the gather is direct: one thread per (l, n, k), k fastest, so the
// threads of a row read K contiguous values of each source row (coalesced),
// and the row's idx and w are the same few words for all of them (served by
// the L1). One launch covers every leading index (grid y).
//
// Bound on this card: bytes. A pass reads the field and the table once and
// writes the output once (port_bounds.gather: 0.0182 ms for the tangential
// reconstruction at icos48 x 100, 0.0113 for the divergence); each field of
// a step fits in the 50 MB L2, so this first version reads its sources
// through the L2 without staging the window in shared memory (a later
// design: the table's per-block `window` bounds that staging).
#include "stencil_common.cuh"

namespace omega {
namespace gather {

template <typename T>
__global__ void __launch_bounds__(256)
gather_kernel(const T* __restrict__ field, T* __restrict__ out,
              const int* __restrict__ idx, const T* __restrict__ w, int N,
              int M, int K, int nsrc) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long nk = static_cast<long long>(N) * K;
  if (t >= nk) return;
  const int n = static_cast<int>(t / K);
  const int k = static_cast<int>(t - static_cast<long long>(n) * K);
  const long long l = blockIdx.y;
  const T* f = field + l * nsrc * K + k;
  const int* ix = idx + static_cast<long long>(n) * M;
  const T* wr = w + static_cast<long long>(n) * M;
  T s = mul_rn(wr[0], f[static_cast<long long>(ix[0]) * K]);
  for (int j = 1; j < M; ++j)
    s = s + mul_rn(wr[j], f[static_cast<long long>(ix[j]) * K]);
  out[l * nk + t] = s;
}

template <typename T>
int launch(const void* field, void* out, const void* idx, const void* w,
           const int* n, cudaStream_t stream) {
  const int N = n[0], M = n[1], K = n[2], nsrc = n[3], L = n[4],
            threads = n[5];
  if (N < 1 || M < 1 || K < 1 || nsrc < 1 || L < 1 || L > 65535 ||
      threads < 32 || threads > 256 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  if (field == nullptr || out == nullptr || idx == nullptr || w == nullptr ||
      field == out) {
    return cudaErrorInvalidValue;
  }
  const long long blocks =
      (static_cast<long long>(N) * K + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(L));
  gather_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(field), static_cast<T*>(out),
      static_cast<const int*>(idx), static_cast<const T*>(w), N, M, K, nsrc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gather
}  // namespace omega

// omega_gather_<f32|f64>: out (L, N, K) from field (L, nsrc, K), both
// contiguous, over the table idx (int32) / w (the field's type), rows of M
// slots, the first N rows read. `ints` = N, M, K, nsrc, L, threads per block.
// Returns the launch's error code, or 0.
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
