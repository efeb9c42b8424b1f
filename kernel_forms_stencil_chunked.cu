// A form of omega_tpu_torch/csrc/stencil.cu for kernel_forms.py
// (kernel_forms_stencil.json): its tiled form in 8 x 32 lattice tiles with K
// in chunks of two vectors, the first design kept as the direct form; its
// record ends in the grid size the launch aims at (`blocks`).
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
// block owns a kTY x kTX tile of the lattice for one leading index, a range
// of K chunks and every destination class. For each chunk (kCV vectors of
// consecutive layers: 16 bytes each where K and both pointers allow, else
// one element) it stages every source class's tile with the table's ring
// (the rows and columns its shifts reach on each side) into shared memory by
// cp.async, the next chunk's copies in flight while this one is summed (two
// buffers). The wrapped row and column of each staged row and column are
// worked out once a block, so a tile larger than the domain needs nothing
// special; each entry's offset into a staged tile, once a block for both
// row parities. A thread then forms kRowsPerThread output vectors of one
// column and vector slot for each destination class, one shared load an
// entry and row; a warp lies within one tile row, so the entry's offset is
// the same across it and its loads are consecutive 16-byte words. A source
// value now crosses L2 about (kTY + ry)(kTX + rx) / (kTY kTX) times, ry and
// rx the ring's rows and columns.
// The grid splits each tile's chunks into ranges until it has about
// `blocks` blocks (the record's, set by the host).
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
  int blocks;    // the tiled form's grid aims at this many blocks
};

// V consecutive layers handled by one thread as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

namespace stencil {

constexpr int kThreads = 256;
constexpr int kTY = 8, kTX = 32;  // tile rows and columns
constexpr int kCV = 2;            // vectors of consecutive layers a chunk
constexpr int kSlots = kTX * kCV; // (column, vector) slots of a tile row
constexpr int kRowStep = kThreads / kSlots;
constexpr int kRowsPerThread = kTY / kRowStep;
static_assert(kThreads % kSlots == 0 && kTY % kRowStep == 0, "tile cut");
static_assert(kSlots % 32 == 0, "a warp lies within one tile row");
static_assert(kTY % 2 == 0 && kRowStep % 2 == 0,
              "a tile starts on an even row and a thread's rows share one "
              "parity");
// dynamic shared memory a block may opt into on sm_90
constexpr size_t kMaxSmem = 232448;

// the tiled form's grid beyond the record: the ring's rows above and
// columns left of the tile (ylo, xlo), the staged tile's rows and columns
// (sy, sx), the tiles and the K chunk ranges
struct Grid {
  int ylo, xlo, sy, sx, tiles_x, tiles, groups, per;
};

// dynamic shared memory of a table of ps source classes whose ring adds ry
// rows and rx columns to the tile
__host__ __device__ constexpr size_t smem_bytes(int ps, int ry, int rx,
                                                size_t vec_bytes) {
  return 2 * static_cast<size_t>(ps) * (kTY + ry) * (kTX + rx) * kCV *
             vec_bytes +
         static_cast<size_t>(ps) * (kTY + ry) * sizeof(long long) +
         static_cast<size_t>(kTX + rx) * sizeof(int) +
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
__device__ __forceinline__ void commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// every copy group but the newest one has landed
__device__ __forceinline__ void wait_all_but_one() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

}  // namespace stencil

template <typename T, int V>
__global__ void __launch_bounds__(stencil::kThreads)
    stencil_tiled_kernel(const T* __restrict__ in, T* __restrict__ out,
                         const __grid_constant__ StencilParams<T> p,
                         const stencil::Grid g) {
  using namespace stencil;
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  const int SY = g.sy, SX = g.sx;
  const int staged = p.ps * SY * SX * kCV;  // vector slots of one chunk
  VT* const buf = reinterpret_cast<VT*>(stencil_smem);
  long long* const row_at = reinterpret_cast<long long*>(buf + 2 * staged);
  int* const col_at = reinterpret_cast<int*>(row_at + p.ps * SY);
  int* const ent_at = col_at + SX;

  // blockIdx.x walks (b, K range, tile), the tile fastest
  const int tile = blockIdx.x % g.tiles;
  const int range = blockIdx.x / g.tiles % g.groups;
  const int b = blockIdx.x / g.tiles / g.groups;
  const int x0 = tile % g.tiles_x * kTX, y0 = tile / g.tiles_x * kTY;
  const int KV = p.K / V;
  const int c_begin = range * g.per;
  const int c_end = min((KV + kCV - 1) / kCV, c_begin + g.per);

  for (int i = threadIdx.x; i < p.ps * SY; i += kThreads) {
    const int s = i / SY;
    row_at[i] = (static_cast<long long>(b * p.ps + s) * p.ny +
                 wrap_any(y0 - g.ylo + i - s * SY, p.ny)) *
                p.nx * p.K;
  }
  for (int c = threadIdx.x; c < SX; c += kThreads)
    col_at[c] = wrap_any(x0 - g.xlo + c, p.nx) * p.K;
  for (int i = threadIdx.x; i < 2 * p.start[p.pd]; i += kThreads) {
    const Entry<T>& e = p.e[i >> 1];
    ent_at[i] = ((e.ts * SY + e.dj) * SX + ((i & 1) ? e.di_o : e.di_e)) * kCV;
  }
  __syncthreads();

  // a warp a staged row at a time, its lanes along the row's (column,
  // vector) slots
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = p.ps * SY;
  auto stage = [=](int ch, VT* dst) {
    const int kv0 = ch * kCV;
    const int cw = min(kCV, KV - kv0);
    for (int row = warp; row < rows; row += kThreads / 32) {
      const T* const src = in + row_at[row] + static_cast<long long>(kv0) * V;
      VT* const d = dst + row * SX * kCV;
      for (int j = lane; j < SX * kCV; j += 32) {
        const int c = j / kCV, v = j % kCV;
        if (v < cw)
          stage_copy(d + j,
                     reinterpret_cast<const VT*>(src + col_at[c] + v * V));
      }
    }
  };

  // this thread's column, vector slot and rows ly0, ly0 + kRowStep, ...
  const int slot = threadIdx.x % kSlots;
  const int lx = slot / kCV, v = slot % kCV;
  const int ly0 = threadIdx.x / kSlots;
  const int par = (y0 + ly0) & 1;
  int base[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    base[j] = ((g.ylo + ly0 + j * kRowStep) * SX + g.xlo + lx) * kCV + v;
  const bool col_live = x0 + lx < p.nx;

  stage(c_begin, buf);
  commit();
  for (int ch = c_begin; ch < c_end; ++ch) {
    const bool odd = ((ch - c_begin) & 1) != 0;
    if (ch + 1 < c_end) stage(ch + 1, odd ? buf : buf + staged);
    commit();
    wait_all_but_one();
    __syncthreads();  // every thread's copies of chunk ch have landed

    const VT* const src = odd ? buf + staged : buf;
    const int kv0 = ch * kCV;
    const bool live = col_live && v < KV - kv0;
    for (int td = 0; td < p.pd; ++td) {
      VT acc[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
        for (int c = 0; c < V; ++c) acc[j].v[c] = T(0);
      for (int i = p.start[td]; i < p.start[td + 1]; ++i) {
        const T w = p.e[i].w;
        const int o = ent_at[2 * i + par];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const VT val = src[base[j] + o];
#pragma unroll
          for (int c = 0; c < V; ++c) acc[j].v[c] += w * val.v[c];
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int y = y0 + ly0 + j * kRowStep;
          if (y < p.ny)
            *reinterpret_cast<VT*>(
                out +
                ((static_cast<long long>(b * p.pd + td) * p.ny + y) * p.nx +
                 x0 + lx) *
                    p.K +
                (kv0 + v) * V) = acc[j];
        }
      }
    }
    __syncthreads();  // before the next iteration restages this buffer
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

template <typename T, int V>
int launch_stencil_v(const T* in, T* out, const StencilParams<T>& p,
                     cudaStream_t stream) {
  using namespace stencil;
  int r[4];
  stencil_ring(p, r);
  const size_t smem =
      smem_bytes(p.ps, r[0] + r[1], r[2] + r[3], sizeof(Vec<T, V>));
  if (smem <= kMaxSmem) {
    const int tiles_x = (p.nx + kTX - 1) / kTX;
    const int tiles = tiles_x * ((p.ny + kTY - 1) / kTY);
    const int nch = (p.K / V + kCV - 1) / kCV;
    const long long tb = static_cast<long long>(tiles) * p.nb;
    long long want = (static_cast<long long>(p.blocks) + tb - 1) / tb;
    want = want < 1 ? 1 : (want > nch ? nch : want);
    const int per = static_cast<int>((nch + want - 1) / want);
    const int groups = (nch + per - 1) / per;  // no range left empty
    const long long blocks = tb * groups;
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    auto* const k = &stencil_tiled_kernel<T, V>;
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        in, out, p,
        Grid{r[0], r[2], kTY + r[0] + r[1], kTX + r[2] + r[3], tiles_x, tiles,
             groups, per});
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 256;
  const long long rows = static_cast<long long>(p.nb) * p.pd * p.ny;
  const long long plane = static_cast<long long>(p.nx) * p.K / V;
  const long long by = (plane + threads - 1) / threads;
  if (rows > 2147483647LL || by > 65535LL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(by), 1);
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
// sharedSizeBytes into out[0..2]), the blocks an SM holds at the dynamic
// shared memory a table of ps source classes whose ring adds ry rows and
// rx columns takes (out[3]) and those bytes (out[4]); `vec` picks the
// 16-byte instance
template <typename T>
int stencil_attrs(int ps, int ry, int rx, int vec, int* out) {
  using namespace stencil;
  if (out == nullptr || ps < 1 || ps > 3 || ry < 0 || rx < 0)
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  auto* const k = vec ? &stencil_tiled_kernel<T, V> : &stencil_tiled_kernel<T, 1>;
  const size_t smem = smem_bytes(ps, ry, rx, vec ? 16 : sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
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

int omega_stencil_attrs_f32(int ps, int ry, int rx, int vec, int* out) {
  return omega::stencil_attrs<float>(ps, ry, rx, vec, out);
}
int omega_stencil_attrs_f64(int ps, int ry, int rx, int vec, int* out) {
  return omega::stencil_attrs<double>(ps, ry, rx, vec, out);
}

const char* omega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
