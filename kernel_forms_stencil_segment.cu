// A form of omega_tpu_torch/csrc/stencil.cu for kernel_forms.py
// (kernel_forms_stencil.json): its tiled form in row bands by segments of
// the (x, K) plane, with the first design kept as the direct form; built in
// place of stencil.cu, its C entry points are stencil.cu's.
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
// K): free reshapes of the model's class-major (..., N, K) fields. Each
// output is `acc += w * value` over its entries in table order from zero, in
// both forms below, so the two give the same bits.
//
// Bound on this card: bytes. Each output element costs a handful of
// multiply-adds against (ps + pd)/pd elements of traffic, so the least time
// is (ps + pd) * B * ny * nx * K * sizeof(T) over the memory rate.
//
// Tiled form (every table the mesh has). A source value is named by up to
// 8 entries; read once an entry from global memory (the first design) it
// crossed L2 several times, since rows y +- 1 belong to other blocks. Here a
// block owns `rows` consecutive destination rows of one leading index and a
// segment of kSegVec vectors of their contiguous (x, K) plane (16 bytes a
// vector where K and both pointers allow, else one element), for every
// destination class. It stages each source class's rows with the table's
// ring (the rows its shifts reach above and below) and the segment with
// the columns its shifts reach left and right (di * K elements of the
// plane: a column shift of the (x, K) plane is a shift by di * K, wrapped
// at the plane's ends) into shared memory by cp.async, every staged row one
// contiguous run of global memory; the host picks `rows` (8, 4, 2 or 1) so
// that a block's shared memory stays within kSmemBudget. A thread then
// forms one vector of each destination row and class from shared memory,
// one shared load an entry, at an offset the block works out once an
// entry and row parity; its loads and its stores are consecutive 16-byte
// words across a warp. A source value crosses L2 about
// (rows + ry)/rows x (kSegVec V + rx K)/(kSegVec V) times, ry and rx the
// ring's rows and columns. (A first tiled form staged 8 x 32 lattice tiles
// in K chunks of two vectors: its 32-byte runs a column, 400 bytes apart at
// K = 100, made it two to four times slower than the first design; it is
// kernel_forms_stencil_chunked.cu.)
//
// Direct form (a ring too wide for shared memory, which no table of the
// hex mesh has): the first design, a block a destination row and a thread
// a vector of its (x, K) plane, each entry one global load.
#include "stencil_common.cuh"

namespace omega {

constexpr int kStencilMaxEntries = 32;

template <typename T>
struct StencilParams {
  Entry<T> e[kStencilMaxEntries];
  int start[4];  // entries of destination class t are e[start[t] .. start[t+1])
  int ps, pd, nb, ny, nx, K;
};

// V consecutive layers handled by one thread as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

namespace stencil {

constexpr int kThreads = 256;
// vectors of the (x, K) plane a block owns: a thread one of each row
constexpr int kSegVec = kThreads;
// shared memory a block keeps within where it can (two blocks an SM), and
// what a block may opt into on sm_90
constexpr size_t kSmemBudget = 112 * 1024;
constexpr size_t kMaxSmem = 232448;

// the tiled form's cut beyond the record: the ring's rows above the
// block's rows and its columns left of the segment (ylo, xlo), the staged
// rows (sy) and vectors a staged row (swv), destination rows a block
// (rows), row bands and segments
struct Seg {
  int ylo, xlo, sy, swv, rows, bands, segs;
};

// dynamic shared memory of a block of `rows` rows on a table of ps source
// classes whose ring adds ry rows and rx columns, K layers, `elem` bytes an
// element, V elements a vector
__host__ __device__ constexpr size_t smem_bytes(int ps, int rows, int ry,
                                                int rx, int K, int V,
                                                size_t elem) {
  return static_cast<size_t>(ps) * (rows + ry) *
             (static_cast<size_t>(kSegVec) * V + static_cast<size_t>(rx) * K) *
             elem +
         2 * kStencilMaxEntries * sizeof(int);
}

// a global -> shared copy of one vector, in flight until wait(); a plain
// copy where no card compiles it
template <typename VT>
__device__ __forceinline__ void stage_copy(VT* dst, const VT* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(VT) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(VT)));
#else
  *dst = *src;
#endif
}
// every copy this thread issued has landed
__device__ __forceinline__ void wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}

}  // namespace stencil

template <typename T, int V>
__global__ void __launch_bounds__(stencil::kThreads)
    stencil_tiled_kernel(const T* __restrict__ in, T* __restrict__ out,
                         const __grid_constant__ StencilParams<T> p,
                         const stencil::Seg g) {
  using namespace stencil;
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  VT* const buf = reinterpret_cast<VT*>(stencil_smem);
  int* const ent_at =
      reinterpret_cast<int*>(buf + static_cast<long long>(p.ps) * g.sy * g.swv);

  // blockIdx.x walks (b, row band, segment), the segment fastest
  const int seg = blockIdx.x % g.segs;
  const int band = blockIdx.x / g.segs % g.bands;
  const int b = blockIdx.x / g.segs / g.bands;
  const int y0 = band * g.rows;
  const long long plane = static_cast<long long>(p.nx) * p.K;  // elements
  const int kv = p.K / V;                                      // vectors a column
  // the first staged element of a row: the segment's start less the ring's
  // columns on the left, wrapped into the plane
  long long g0 = static_cast<long long>(seg) * kSegVec * V -
                 static_cast<long long>(g.xlo) * p.K;
  g0 = (g0 % plane + plane) % plane;

  for (int i = threadIdx.x; i < 2 * p.start[p.pd]; i += kThreads) {
    const Entry<T>& e = p.e[i >> 1];
    ent_at[i] = (e.ts * g.sy + e.dj) * g.swv +
                ((i & 1) ? e.di_o : e.di_e) * kv;
  }
  // every staged row one run of the plane from g0, wrapped at its end
  for (int r = 0; r < p.ps * g.sy; ++r) {
    const int s = r / g.sy;
    const T* const row =
        in + (static_cast<long long>(b * p.ps + s) * p.ny +
              wrap_any(y0 - g.ylo + r - s * g.sy, p.ny)) *
                 plane;
    VT* const d = buf + static_cast<long long>(r) * g.swv;
    long long at = g0 + static_cast<long long>(threadIdx.x) * V;
    at %= plane;
    const long long step = (static_cast<long long>(kThreads) * V) % plane;
    for (int i = threadIdx.x; i < g.swv; i += kThreads) {
      stage_copy(d + i, reinterpret_cast<const VT*>(row + at));
      at += step;
      at -= at >= plane ? plane : 0;
    }
  }
  wait_all();
  __syncthreads();

  // this thread's vector of the segment
  const long long j = (static_cast<long long>(seg) * kSegVec + threadIdx.x) * V;
  if (j >= plane) return;
  const int col = g.xlo * kv + threadIdx.x;
  for (int ly = 0; ly < g.rows; ++ly) {
    const int y = y0 + ly;
    if (y >= p.ny) break;
    const int par = y & 1;
    const VT* const src = buf + (g.ylo + ly) * g.swv + col;
    for (int td = 0; td < p.pd; ++td) {
      VT acc;
#pragma unroll
      for (int c = 0; c < V; ++c) acc.v[c] = T(0);
      for (int i = p.start[td]; i < p.start[td + 1]; ++i) {
        const T w = p.e[i].w;
        const VT val = src[ent_at[2 * i + par]];
#pragma unroll
        for (int c = 0; c < V; ++c) acc.v[c] += w * val.v[c];
      }
      *reinterpret_cast<VT*>(
          out + (static_cast<long long>(b * p.pd + td) * p.ny + y) * plane +
          j) = acc;
    }
  }
}

template <typename T, int V>
__global__ void stencil_direct_kernel(const T* __restrict__ in,
                                      T* __restrict__ out,
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

// the ring a table needs: the rows its shifts reach above and below a
// tile (r[0], r[1]) and the columns left and right of it (r[2], r[3])
template <typename T>
void stencil_ring(const StencilParams<T>& p, int* r) {
  r[0] = r[1] = r[2] = r[3] = 0;
  auto reach = [](int* lo, int* hi, int d) {
    *lo = d < -*lo ? -d : *lo;
    *hi = d > *hi ? d : *hi;
  };
  for (int i = 0; i < p.start[p.pd]; ++i) {
    const Entry<T>& e = p.e[i];
    reach(r, r + 1, e.dj);
    reach(r + 2, r + 3, e.di_e);
    reach(r + 2, r + 3, e.di_o);
  }
}

// the rows a block of the tiled form owns on a table: the most of 8, 4, 2
// that keep its shared memory within kSmemBudget, else 1 if it fits at all
// (0: the table's ring is too wide for shared memory)
template <typename T, int V>
int stencil_rows(const StencilParams<T>& p, const int* r) {
  using namespace stencil;
  for (int rows = 8; rows >= 1; rows /= 2) {
    const size_t smem = smem_bytes(p.ps, rows, r[0] + r[1], r[2] + r[3], p.K,
                                   V, sizeof(T));
    if (smem <= kSmemBudget || (rows == 1 && smem <= kMaxSmem)) return rows;
  }
  return 0;
}

template <typename T, int V>
int launch_stencil_v(const T* in, T* out, const StencilParams<T>& p,
                     cudaStream_t stream) {
  using namespace stencil;
  int r[4];
  stencil_ring(p, r);
  const int rows = stencil_rows<T, V>(p, r);
  if (rows > 0) {
    const size_t smem = smem_bytes(p.ps, rows, r[0] + r[1], r[2] + r[3],
                                   p.K, V, sizeof(T));
    const long long plane_v = static_cast<long long>(p.nx) * p.K / V;
    const int segs = static_cast<int>((plane_v + kSegVec - 1) / kSegVec);
    const int bands = (p.ny + rows - 1) / rows;
    const long long blocks = static_cast<long long>(segs) * bands * p.nb;
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    auto* const k = &stencil_tiled_kernel<T, V>;
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int swv = kSegVec + (r[2] + r[3]) * (p.K / V);
    k<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        in, out, p, Seg{r[0], r[2], rows + r[0] + r[1], swv, rows, bands,
                        segs});
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 256;
  const long long rows_all = static_cast<long long>(p.nb) * p.pd * p.ny;
  const long long plane = static_cast<long long>(p.nx) * p.K / V;
  const long long by = (plane + threads - 1) / threads;
  if (rows_all > 2147483647LL || by > 65535LL)
    return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(rows_all), static_cast<unsigned>(by), 1);
  stencil_direct_kernel<T, V><<<grid, threads, 0, stream>>>(in, out, p);
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
  if (static_cast<long long>(p.nb) * p.ny * p.nx * p.K == 0) return 0;
  // out of place: neighbours read the input
  if (in == nullptr || out == nullptr || in == out)
    return cudaErrorInvalidValue;
  // 16-byte accesses where the layer count and both pointers allow them
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<size_t>(in) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  if (aligned && p.K % V == 0) return launch_stencil_v<T, V>(in, out, p, stream);
  return launch_stencil_v<T, 1>(in, out, p, stream);
}

// cudaFuncGetAttributes of the tiled form (numRegs, localSizeBytes,
// sharedSizeBytes into out[0..2]) on the record's table at its K, the
// blocks an SM holds at the dynamic shared memory it takes there (out[3]),
// those bytes (out[4]) and the rows a block owns (out[5]); `vec` picks the
// 16-byte instance
template <typename T>
int stencil_attrs(const StencilParams<T>* hp, int vec, int* out) {
  using namespace stencil;
  if (out == nullptr || hp == nullptr || !stencil_record_ok(*hp))
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  int r[4];
  stencil_ring(*hp, r);
  const int rows = vec ? stencil_rows<T, V>(*hp, r) : stencil_rows<T, 1>(*hp, r);
  if (rows == 0 || (vec && hp->K % V != 0)) return cudaErrorInvalidValue;
  auto* const k =
      vec ? &stencil_tiled_kernel<T, V> : &stencil_tiled_kernel<T, 1>;
  const size_t smem = smem_bytes(hp->ps, rows, r[0] + r[1], r[2] + r[3],
                                 hp->K, vec ? V : 1, sizeof(T));
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  out[4] = static_cast<int>(smem);
  out[5] = rows;
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

// `params` a record as omega_stencil_* takes it; see stencil_attrs
int omega_stencil_attrs_f32(const void* params, int vec, int* out) {
  return omega::stencil_attrs<float>(
      static_cast<const omega::StencilParams<float>*>(params), vec, out);
}
int omega_stencil_attrs_f64(const void* params, int vec, int* out) {
  return omega::stencil_attrs<double>(
      static_cast<const omega::StencilParams<double>*>(params), vec, out);
}

const char* omega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
