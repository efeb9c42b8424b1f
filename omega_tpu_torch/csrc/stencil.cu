// Structured stencil pass on the doubly periodic planar hex mesh.
//
// Replaces the TPU kernels omega_tpu/ops/pallas_stencil_dma.py:_kernel and
// omega_tpu/ops/pallas_stencil.py:_stencil_kernel (one function in two
// layouts):
//
//   out[b, t_dst, y, x, k] = sum_e w_e * in[b, ts_e, y + dj_e, x + di_e(y), k]
//
// with periodic wrap in y and x and the column shift chosen by the parity of
// the DESTINATION row. in is (B*ps, ny, nx, K) contiguous, out (B*pd, ny, nx,
// K): free reshapes of the model's class-major (..., N, K) fields.
//
// Bound on this card: bytes. Each output element costs a handful of
// multiply-adds against (ps + pd)/pd elements of traffic, so the least time
// is (ps + pd) * B * ny * nx * K * sizeof(T) over the memory rate. Design:
// threads run fastest along k, each owning 16 bytes of consecutive layers
// (one element where K or the pointers do not allow that), so a warp reads
// and writes consecutive addresses for every table entry and the per-entry
// index arithmetic is paid once per 16 bytes; the wrap is index arithmetic
// (no padded copy of the input), K is not padded, and the shifted re-reads
// of a source row by neighbouring destinations are served by the caches.
// The table rides in the kernel's parameter space, where every thread of a
// warp reads the same entry at the same time.
#include "stencil_common.cuh"

namespace omega {

constexpr int kStencilMaxEntries = 32;

template <typename T>
struct StencilParams {
  Entry<T> e[kStencilMaxEntries];
  int start[4];  // entries of destination class t are e[start[t] .. start[t+1])
  int ps, pd, nb, ny, nx, K;
};

// V consecutive layers handled by one thread as one 16-byte access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                               const __grid_constant__ StencilParams<T> p) {
  // blockIdx.x walks (b, t_dst, y); blockIdx.y * blockDim.x + threadIdx.x
  // walks the contiguous (x, k) plane of that row, V layers at a time
  // (K divides by V, so a vector never straddles two columns).
  const int row = blockIdx.x;
  const int y = row % p.ny;
  const int bt = row / p.ny;
  const int td = bt % p.pd;
  const int b = bt / p.pd;
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (j >= p.nx * p.K) return;
  const int x = j / p.K;
  const int k = j - x * p.K;
  const bool odd = (y & 1) != 0;

  Vec<T, V> acc;
#pragma unroll
  for (int c = 0; c < V; ++c) acc.v[c] = T(0);
  for (int i = p.start[td]; i < p.start[td + 1]; ++i) {
    const Entry<T>& e = p.e[i];
    const int yy = wrap_near(y + e.dj, p.ny);
    const int xx = wrap_near(x + (odd ? e.di_o : e.di_e), p.nx);
    const long long src =
        ((static_cast<long long>(b * p.ps + e.ts) * p.ny + yy) * p.nx + xx) *
            p.K + k;
    const Vec<T, V> val = *reinterpret_cast<const Vec<T, V>*>(in + src);
#pragma unroll
    for (int c = 0; c < V; ++c) acc.v[c] += e.w * val.v[c];
  }
  *reinterpret_cast<Vec<T, V>*>(
      out + static_cast<long long>(row) * p.nx * p.K + j) = acc;
}

template <typename T, int V>
int launch_stencil_v(const T* in, T* out, const StencilParams<T>& p,
                     cudaStream_t stream) {
  const int threads = 256;
  const long long rows = static_cast<long long>(p.nb) * p.pd * p.ny;
  const long long plane = static_cast<long long>(p.nx) * p.K / V;
  const long long by = (plane + threads - 1) / threads;
  if (rows <= 0 || plane <= 0) return 0;
  // out of place: neighbours read the input
  if (in == out) return cudaErrorInvalidValue;
  if (rows > 2147483647LL || by > 65535LL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(by), 1);
  stencil_kernel<T, V><<<grid, threads, 0, stream>>>(in, out, p);
  return static_cast<int>(cudaGetLastError());
}

// a record the kernels take: 1-3 classes each side, entries grouped by
// destination class within the cap, source classes in range, shifts
// within the domain
template <typename T>
bool stencil_record_ok(const StencilParams<T>& p) {
  if (p.ps < 1 || p.ps > 3 || p.pd < 1 || p.pd > 3 || p.nb < 0 ||
      p.ny < 1 || p.nx < 1 || p.K < 0 || p.start[0] != 0)
    return false;
  for (int t = 0; t < p.pd; ++t)
    if (p.start[t + 1] < p.start[t]) return false;
  if (p.start[p.pd] > kStencilMaxEntries) return false;
  for (int i = 0; i < p.start[p.pd]; ++i) {
    const Entry<T>& e = p.e[i];
    if (e.ts < 0 || e.ts >= p.ps || e.dj <= -p.ny || e.dj >= p.ny ||
        e.di_e <= -p.nx || e.di_e >= p.nx || e.di_o <= -p.nx ||
        e.di_o >= p.nx)
      return false;
  }
  return true;
}

template <typename T>
int launch_stencil(const void* in_, void* out_, const StencilParams<T>* hp,
                   cudaStream_t stream) {
  if (hp == nullptr || !stencil_record_ok(*hp)) return cudaErrorInvalidValue;
  const StencilParams<T>& p = *hp;
  const T* in = static_cast<const T*>(in_);
  T* out = static_cast<T*>(out_);
  // 16-byte accesses where the layer count and both pointers allow them
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<size_t>(in) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned && p.K % V == 0) return launch_stencil_v<T, V>(in, out, p, stream);
  return launch_stencil_v<T, 1>(in, out, p, stream);
}

// cudaFuncGetAttributes of the kernel (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) and the blocks of 256 threads an SM holds
// (out[3]); `vec` picks the 16-byte instance
template <typename T>
int stencil_attrs(int vec, int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  auto* const k = vec ? &stencil_kernel<T, V> : &stencil_kernel<T, 1>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, 256, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace omega

extern "C" {

int omega_stencil_params_size_f32() {
  return static_cast<int>(sizeof(omega::StencilParams<float>));
}
int omega_stencil_params_size_f64() {
  return static_cast<int>(sizeof(omega::StencilParams<double>));
}

// `params` points at a host StencilParams<T>; returns the launch's error code.
int omega_stencil_f32(const void* in, void* out, const void* params,
                      void* stream) {
  return omega::launch_stencil<float>(
      in, out, static_cast<const omega::StencilParams<float>*>(params),
      static_cast<cudaStream_t>(stream));
}
int omega_stencil_f64(const void* in, void* out, const void* params,
                      void* stream) {
  return omega::launch_stencil<double>(
      in, out, static_cast<const omega::StencilParams<double>*>(params),
      static_cast<cudaStream_t>(stream));
}

int omega_stencil_attrs_f32(int vec, int* out) {
  return omega::stencil_attrs<float>(vec, out);
}
int omega_stencil_attrs_f64(int vec, int* out) {
  return omega::stencil_attrs<double>(vec, out);
}

const char* omega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
