// All barotropic forward-backward subcycles of a split-explicit step on an
// unstructured mesh (the icosahedral sphere, the gather layout, carved
// meshes), in gather form, as ONE cooperative launch with one grid-wide
// barrier per subcycle.
//
// Replaces the reference's `lax.scan` over the composed operators in
// omega_tpu/ops/patch_megastep.py:split_patch_megastep_framed (:2205-2226),
// which is not a Pallas kernel; the planar Pallas kernel
// (omega_tpu/ops/barotropic_kernel.py:_kernel, csrc/barotropic.cu here) takes
// structured meshes only. Each subcycle, on the flat (E, 1) / (C, 1) arrays:
//
//   ub_new  = ub + dt_bt (mask ((-g) grad(ssh) + f_e tang(ub) - r ub)
//                         + g_slow)
//   ssh_new = ssh - dt_bt div(het ub_new)
//   acc     = acc + ub_new;   after the last subcycle <ubar> = acc / M
//
// with grad(ssh)_e = (ssh[c1] - ssh[c0]) / dc_e, tang(ub)_e = sum_j
// weights_on_edge[e, j] ub[edges_on_edge[e, j]] and div(x)_c = sum_j
// w_div_cell[c, j] x[edges_on_cell[c, j]], in slot order; every product the
// plain version (ops/bt_gather.subcycles_plain) rounds is rounded here too
// (mul_rn). Padded slots point at element 0 with weight 0; the dead seam
// slots of a patch mesh have cells (0, 0), zero weights and edge_mask 0, so
// their ub stays 0.
//
// The cells are cut into groups, each a contiguous range (the patch and RCM
// numberings keep a range compact), with the list of every edge its cells
// name (and a share of the edges no cell names: the dead seam slots); each
// edge is owned by one group (ops/bt_gather.groups).
// A block takes a group and, every subcycle, evaluates ub_new on EVERY edge
// of its list, so an edge two groups share is computed by both, from the
// same old values in the same slot order, and therefore bit-equal; only its
// owner writes it. het * ub_new goes to shared memory, and the block forms
// ssh_new of its cells from it, so a subcycle needs one grid barrier, not
// two: the next subcycle reads the new ub and ssh of other groups with
// plain loads (through L1: neighbouring slots gather the same edges), made
// visible by grid.sync()'s release and acquire at device scope. Both ub
// and ssh ping-pong between two buffers (a neighbour still reads the old
// values while this block writes the new), chosen so that the last
// subcycle writes `ub_out` / `ssh_out`.
//
// Resident form (a block a group and a thread a list slot and a cell, as at
// icos48 with a group an SM): everything of a slot that no subcycle changes
// is loaded once for all M: the edge, its cells, g_slow, het, f_e,
// edge_mask, dc_edge and the accumulator of an owned edge in the thread's
// registers, the slot's tangential edges and weights in shared memory, so
// that a subcycle's loads are the old ub and ssh it gathers, all issued
// together (the slot counts compiled in as bounds, kME and kMC), and the
// het * ub_new of the list. Otherwise (more groups than the card holds
// blocks, a list longer than a block, more slots than kME / kMC) each block
// walks its groups and slots a subcycle and reads everything from memory,
// the accumulator kept in `avg` (the streamed form). The launcher sizes the
// grid from the occupancy query and the SM count (coop.cuh); a grid the
// card cannot make co-resident is refused.
//
// Bound on this card: the M grid barriers and the gathers' latency, not the
// bytes. A subcycle moves about 10 MB at icos48 (the five fields and the
// gather tables; port_bounds.sphere_bt), 3 us at 3.35 TB/s, and all of it
// stays in the 50 MB L2.
#include <cooperative_groups.h>

#include "coop.cuh"
#include "stencil_common.cuh"

namespace omega {
namespace bt_gather {

constexpr int kMaxThreads = 1024;
// the resident form's bounds on edges_on_edge's and edges_on_cell's slots
constexpr int kME = 12, kMC = 8;

template <typename T>
struct Args {
  const T *ubar, *ssh, *g_slow, *het;
  T *ub_out, *ub_work, *ssh_out, *ssh_work, *avg;
  const T *dc, *woe, *wdiv, *f_e, *mask;
  const int *coe, *eoe;
  // group g: cells [cell_start[g], cell_start[g+1]), list slots
  // [edge_start[g], edge_start[g+1]) of edge_list (e where g owns edge e,
  // ~e where it does not); lslot[c * MC + j] the slot of edges_on_cell[c, j]
  // in its cell's group's list
  const int *cell_start, *edge_start, *edge_list, *lslot;
  T dt_bt, mg, r, m;   // mg = -g
  int ME, MC, M, ngroups, max_list, max_cells;
};

// shared memory of a block: het * ub_new a list slot; resident also the
// slots' tangential weights and edges, kME of each a slot
template <typename T>
size_t smem_bytes(bool resident, int max_list) {
  return static_cast<size_t>(max_list) *
         (sizeof(T) + (resident ? kME * (sizeof(T) + sizeof(int)) : 0));
}

// a value no thread writes during the launch (through the read-only cache)
template <typename T>
__device__ __forceinline__ T load_ro(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

}  // namespace bt_gather

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(bt_gather::kMaxThreads)
bt_gather_kernel(const __grid_constant__ bt_gather::Args<T> a) {
  using namespace bt_gather;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nl = a.max_list;
  T* const HU = reinterpret_cast<T*>(smem_raw);   // het * ub_new, a slot
  T* const WOE = HU + nl;                         // resident: kME x nl
  int* const EOE = reinterpret_cast<int*>(WOE + kME * nl);

  if (RESIDENT) {
    // the block's group; the thread's list slot l and cell c
    const int l = threadIdx.x;
    const int e0 = a.edge_start[blockIdx.x];
    const bool has = l < a.edge_start[blockIdx.x + 1] - e0;
    const int c = a.cell_start[blockIdx.x] + threadIdx.x;
    const bool has_c = c < a.cell_start[blockIdx.x + 1];
    const int code = has ? a.edge_list[e0 + l] : 0;
    const int e = code >= 0 ? code : ~code;
    int c0 = 0, c1 = 0;
    T gs = T(0), het = T(0), fe = T(0), mask = T(0), dc = T(1), acc = T(0);
    if (has) {
      c0 = a.coe[2 * e];
      c1 = a.coe[2 * e + 1];
      gs = a.g_slow[e];
      het = a.het[e];
      fe = a.f_e[e];
      mask = a.mask[e];
      dc = a.dc[e];
      const long long b = static_cast<long long>(e) * a.ME;
      for (int k = 0; k < a.ME; ++k) {
        WOE[k * nl + l] = a.woe[b + k];
        EOE[k * nl + l] = a.eoe[b + k];
      }
    }
    for (int i = 0; i < a.M; ++i) {
      const bool to_out = (a.M - 1 - i) % 2 == 0;
      const T* const ub =
          i == 0 ? a.ubar : (to_out ? a.ub_work : a.ub_out);
      const T* const ssh =
          i == 0 ? a.ssh : (to_out ? a.ssh_work : a.ssh_out);
      if (has) {
        T v[kME];
        _Pragma("unroll") for (int k = 0; k < kME; ++k)
          if (k < a.ME) v[k] = ub[EOE[k * nl + l]];
        const T s1 = ssh[c1], s0 = ssh[c0];
        const T u = ub[e];
        const T gr = (s1 - s0) / dc;
        T tg = T(0);
        _Pragma("unroll") for (int k = 0; k < kME; ++k)
          if (k < a.ME) tg = tg + mul_rn(WOE[k * nl + l], v[k]);
        T o = mul_rn(a.mg, gr) + mul_rn(fe, tg);
        if (a.r != T(0)) o = o - mul_rn(a.r, u);
        const T un = u + mul_rn(a.dt_bt, mul_rn(mask, o) + gs);
        HU[l] = mul_rn(het, un);
        if (code >= 0) {
          (to_out ? a.ub_out : a.ub_work)[e] = un;
          acc = i == 0 ? un : acc + un;
        }
      }
      __syncthreads();
      if (has_c) {
        const long long b = static_cast<long long>(c) * a.MC;
        int ls[kMC];
        T wd[kMC];
        _Pragma("unroll") for (int k = 0; k < kMC; ++k) if (k < a.MC) {
          ls[k] = load_ro(a.lslot + b + k);
          wd[k] = load_ro(a.wdiv + b + k);
        }
        const T s = ssh[c];
        T d = T(0);
        _Pragma("unroll") for (int k = 0; k < kMC; ++k)
          if (k < a.MC) d = d + mul_rn(wd[k], HU[ls[k]]);
        (to_out ? a.ssh_out : a.ssh_work)[c] = s - mul_rn(a.dt_bt, d);
      }
      if (i + 1 < a.M) cooperative_groups::this_grid().sync();
    }
    if (has && code >= 0) a.avg[e] = acc / a.m;
    return;
  }

  for (int i = 0; i < a.M; ++i) {
    // subcycle i reads what subcycle i-1 wrote; the last one writes the
    // outputs
    const bool to_out = (a.M - 1 - i) % 2 == 0;
    const T* const ub =
        i == 0 ? a.ubar : (to_out ? a.ub_work : a.ub_out);
    const T* const ssh = i == 0 ? a.ssh : (to_out ? a.ssh_work : a.ssh_out);
    T* const ub_new = to_out ? a.ub_out : a.ub_work;
    T* const ssh_new = to_out ? a.ssh_out : a.ssh_work;
    for (int g = blockIdx.x; g < a.ngroups; g += gridDim.x) {
      const int e0 = a.edge_start[g];
      const int n = a.edge_start[g + 1] - e0;
      for (int l = threadIdx.x; l < n; l += blockDim.x) {
        const int code = load_ro(a.edge_list + e0 + l);
        const int e = code >= 0 ? code : ~code;
        const T gr = (ssh[load_ro(a.coe + 2 * e + 1)] -
                      ssh[load_ro(a.coe + 2 * e)]) /
                     load_ro(a.dc + e);
        const long long b = static_cast<long long>(e) * a.ME;
        T tg = T(0);
#pragma unroll 4
        for (int j = 0; j < a.ME; ++j)
          tg = tg + mul_rn(load_ro(a.woe + b + j),
                           ub[load_ro(a.eoe + b + j)]);
        const T u = ub[e];
        T o = mul_rn(a.mg, gr) + mul_rn(load_ro(a.f_e + e), tg);
        if (a.r != T(0)) o = o - mul_rn(a.r, u);
        const T un =
            u + mul_rn(a.dt_bt, mul_rn(load_ro(a.mask + e), o) +
                                    load_ro(a.g_slow + e));
        HU[l] = mul_rn(load_ro(a.het + e), un);
        if (code >= 0) {
          ub_new[e] = un;
          const T s = i == 0 ? un : a.avg[e] + un;
          a.avg[e] = i == a.M - 1 ? s / a.m : s;
        }
      }
      __syncthreads();
      const int c1 = a.cell_start[g + 1];
      for (int c = a.cell_start[g] + threadIdx.x; c < c1; c += blockDim.x) {
        const long long b = static_cast<long long>(c) * a.MC;
        T d = T(0);
        for (int j = 0; j < a.MC; ++j)
          d = d + mul_rn(load_ro(a.wdiv + b + j), HU[load_ro(a.lslot + b + j)]);
        ssh_new[c] = ssh[c] - mul_rn(a.dt_bt, d);
      }
      __syncthreads();   // the next group rewrites HU
    }
    if (i + 1 < a.M) cooperative_groups::this_grid().sync();
  }
}

namespace bt_gather {

// ptrs: ubar, ssh, g_slow, het, ub_out, ub_work, ssh_out, ssh_work, avg,
// cells_on_edge, dc_edge, edges_on_edge, weights_on_edge, w_div_cell,
// f_edge, edge_mask, cell_start, edge_start, edge_list, lslot;
// ints: ME, MC, M, ngroups, max_list, max_cells (the most cells of a
// group), threads, grid (0: the launcher's choice); consts: dt_bt, -g, r
template <typename T>
int launch(const void* const* ptrs, const double* c, const int* n,
           cudaStream_t stream) {
  if (ptrs == nullptr || c == nullptr || n == nullptr)
    return cudaErrorInvalidValue;
  for (int k = 0; k < 20; ++k)
    if (ptrs[k] == nullptr) return cudaErrorInvalidValue;
  // the ping-pong buffers and the outputs are distinct from each other and
  // from the inputs
  for (int x = 0; x < 9; ++x)
    for (int y = (x < 4 ? 4 : x + 1); y < 9; ++y)
      if (ptrs[x] == ptrs[y]) return cudaErrorInvalidValue;
  Args<T> a;
  a.ubar = static_cast<const T*>(ptrs[0]);
  a.ssh = static_cast<const T*>(ptrs[1]);
  a.g_slow = static_cast<const T*>(ptrs[2]);
  a.het = static_cast<const T*>(ptrs[3]);
  a.ub_out = static_cast<T*>(const_cast<void*>(ptrs[4]));
  a.ub_work = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.ssh_out = static_cast<T*>(const_cast<void*>(ptrs[6]));
  a.ssh_work = static_cast<T*>(const_cast<void*>(ptrs[7]));
  a.avg = static_cast<T*>(const_cast<void*>(ptrs[8]));
  a.coe = static_cast<const int*>(ptrs[9]);
  a.dc = static_cast<const T*>(ptrs[10]);
  a.eoe = static_cast<const int*>(ptrs[11]);
  a.woe = static_cast<const T*>(ptrs[12]);
  a.wdiv = static_cast<const T*>(ptrs[13]);
  a.f_e = static_cast<const T*>(ptrs[14]);
  a.mask = static_cast<const T*>(ptrs[15]);
  a.cell_start = static_cast<const int*>(ptrs[16]);
  a.edge_start = static_cast<const int*>(ptrs[17]);
  a.edge_list = static_cast<const int*>(ptrs[18]);
  a.lslot = static_cast<const int*>(ptrs[19]);
  a.ME = n[0];
  a.MC = n[1];
  a.M = n[2];
  a.ngroups = n[3];
  a.max_list = n[4];
  a.max_cells = n[5];
  const int threads = n[6];
  int grid = n[7];
  if (a.ME < 1 || a.MC < 1 || a.M < 1 || a.ngroups < 1 || a.max_list < 1 ||
      a.max_cells < 1 || grid < 0) {
    return cudaErrorInvalidValue;
  }
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return cudaErrorInvalidConfiguration;
  a.dt_bt = static_cast<T>(c[0]);
  a.mg = static_cast<T>(c[1]);
  a.r = static_cast<T>(c[2]);
  a.m = static_cast<T>(a.M);
  const size_t smem_r = smem_bytes<T>(true, a.max_list);
  const size_t smem_s = smem_bytes<T>(false, a.max_list);
  auto* const kr = &bt_gather_kernel<T, true>;
  auto* const ks = &bt_gather_kernel<T, false>;
  int sms = 0, occ_r = 0, occ_s = 0;
  int err = coop_blocks(kr, threads, smem_r, &occ_r, &sms);
  if (err == 0) err = coop_blocks(ks, threads, smem_s, &occ_s, &sms);
  if (err != 0) return err;
  // resident: a block a group, a thread a slot and a cell, the slot counts
  // within the compiled bounds
  const bool fits = a.max_list <= threads && a.max_cells <= threads &&
                    a.ME <= kME && a.MC <= kMC;
  if (grid == 0)
    grid = fits && a.ngroups <= occ_r * sms ? a.ngroups : occ_s * sms;
  grid = grid < a.ngroups ? grid : a.ngroups;
  const bool resident = fits && grid == a.ngroups && a.ngroups <= occ_r * sms;
  if (grid < 1 || grid > (resident ? occ_r : occ_s) * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      resident ? kr : ks, dim3(grid), dim3(threads), args,
      resident ? smem_r : smem_s, stream));
}

// cudaFuncGetAttributes of the resident (1) or streamed (0) form: numRegs,
// localSizeBytes, sharedSizeBytes into out[0..2], the blocks an SM holds at
// `threads` and a list of `max_list` slots (out[3]) and the SM count (out[4])
template <typename T>
int attrs(int resident, int threads, int max_list, int* out) {
  if (out == nullptr || threads < 32 || threads > kMaxThreads ||
      max_list < 1) {
    return cudaErrorInvalidValue;
  }
  auto* const k =
      resident ? &bt_gather_kernel<T, true> : &bt_gather_kernel<T, false>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = coop_blocks(k, threads, smem_bytes<T>(resident, max_list),
                            &out[3], &out[4]);
  if (e != 0) return e;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

}  // namespace bt_gather
}  // namespace omega

// omega_bt_gather_<f32|f64>(ptrs, consts, ints, stream): M subcycles from
// ubar / ssh / g_slow / het ((E, 1), (C, 1), (E, 1), (E, 1)) into ub_out
// (E, 1), ssh_out (C, 1) and avg = <ubar> (E, 1), with ub_work (E, 1) and
// ssh_work (C, 1) the second buffers; the mesh's cells_on_edge (E, 2),
// dc_edge (E), edges_on_edge (E, ME), weights_on_edge (E, ME), w_div_cell
// (C, MC), f_edge (E), edge_mask (E) and the groups (cell_start, edge_start
// (ngroups + 1), edge_list, lslot (C, MC)); int32 indices; `ptrs` the 20 in
// that order, `consts` = dt_bt, -g, r, `ints` = ME, MC, M, ngroups, the
// longest list, the most cells of a group, threads per block, grid (0: the
// launcher's choice). Returns
// the launch's error code (a grid the card cannot make co-resident:
// cudaErrorCooperativeLaunchTooLarge), or 0.
// omega_bt_gather_attrs_<f32|f64>(resident, threads, max_list, out):
// registers, local (spill) bytes, static shared bytes, blocks per SM, SMs.
#define OMEGA_BT_GATHER_ENTRY(SUF, T)                                         \
  int omega_bt_gather_##SUF(const void* const* ptrs, const double* consts,   \
                            const int* ints, void* stream) {                  \
    return omega::bt_gather::launch<T>(ptrs, consts, ints,                    \
                                       static_cast<cudaStream_t>(stream));    \
  }                                                                           \
  int omega_bt_gather_attrs_##SUF(int resident, int threads, int max_list,   \
                                  int* out) {                                 \
    return omega::bt_gather::attrs<T>(resident, threads, max_list, out);     \
  }

extern "C" {
OMEGA_BT_GATHER_ENTRY(f32, float)
OMEGA_BT_GATHER_ENTRY(f64, double)
}
