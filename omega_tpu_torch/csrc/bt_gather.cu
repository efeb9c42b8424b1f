// All barotropic forward-backward subcycles of a split-explicit step on an
// unstructured mesh (the icosahedral sphere), in gather form: two launches
// per subcycle, every launch made by one C call.
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
// The cell update reads the new ub of all its edges, which other blocks
// write, so a subcycle is two launches on the stream, edges then cells: no
// cooperative launch (its residency limits and grid syncs), and the two
// kernels stay trivially correct. ub ping-pongs between two buffers (the
// edge kernel reads its neighbours' old values) so that the last subcycle
// writes `ub_out`; ssh is updated in place after the first subcycle (a cell
// reads and writes only its own value).
//
// Bound on this card: the launches. A subcycle moves about 10 MB at icos48
// (the five fields and the gather tables; port_bounds.sphere_bt), 3 us at
// 3.35 TB/s, and all of it stays in the 50 MB L2 between launches; 2 M
// launches of a few microseconds each take longer.
#include "stencil_common.cuh"

namespace omega {
namespace bt_gather {

template <typename T>
struct Args {
  const T *g_slow, *het, *f_e, *mask, *dc, *woe, *wdiv;
  const int *coe, *eoe, *eoc;
  T dt_bt, mg, r, m;   // mg = -g
  int E, C, ME, MC;
};

template <typename T>
__global__ void __launch_bounds__(256)
edge_kernel(const Args<T> a, const T* __restrict__ ub,
            const T* __restrict__ ssh, T* __restrict__ ub_new,
            T* __restrict__ acc, int first, int last) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.E) return;
  const T gr = (ssh[a.coe[2 * e + 1]] - ssh[a.coe[2 * e]]) / a.dc[e];
  const long long b = static_cast<long long>(e) * a.ME;
  T tg = T(0);
  for (int j = 0; j < a.ME; ++j)
    tg = tg + mul_rn(a.woe[b + j], ub[a.eoe[b + j]]);
  T o = mul_rn(a.mg, gr) + mul_rn(a.f_e[e], tg);
  if (a.r != T(0)) o = o - mul_rn(a.r, ub[e]);
  const T un = ub[e] + mul_rn(a.dt_bt, mul_rn(a.mask[e], o) + a.g_slow[e]);
  ub_new[e] = un;
  const T s = first ? un : acc[e] + un;
  acc[e] = last ? s / a.m : s;
}

template <typename T>
__global__ void __launch_bounds__(256)
cell_kernel(const Args<T> a, const T* __restrict__ ub_new,
            const T* ssh, T* ssh_new) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const long long b = static_cast<long long>(c) * a.MC;
  T d = T(0);
  for (int j = 0; j < a.MC; ++j) {
    const int e = a.eoc[b + j];
    d = d + mul_rn(a.wdiv[b + j], mul_rn(a.het[e], ub_new[e]));
  }
  ssh_new[c] = ssh[c] - mul_rn(a.dt_bt, d);
}

template <typename T>
int launch(const void* ubar, const void* ssh, const void* g_slow,
           const void* het, void* ub_out, void* ub_work, void* ssh_out,
           void* avg, const void* coe, const void* dc, const void* eoe,
           const void* woe, const void* eoc, const void* wdiv,
           const void* f_e, const void* mask, const double* c, const int* n,
           cudaStream_t stream) {
  Args<T> a;
  a.E = n[0];
  a.C = n[1];
  a.ME = n[2];
  a.MC = n[3];
  const int M = n[4], threads = n[5];
  if (a.E < 1 || a.C < 1 || a.ME < 1 || a.MC < 1 || M < 1 || threads < 32 ||
      threads > 256 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  const void* need[] = {ubar, ssh, g_slow, het, ub_out, ub_work, ssh_out,
                        avg, coe, dc, eoe, woe, eoc, wdiv, f_e, mask};
  for (const void* q : need)
    if (q == nullptr) return cudaErrorInvalidValue;
  if (ub_out == ub_work || ub_out == ubar || ub_work == ubar ||
      ssh_out == ssh) {
    return cudaErrorInvalidValue;
  }
  a.g_slow = static_cast<const T*>(g_slow);
  a.het = static_cast<const T*>(het);
  a.f_e = static_cast<const T*>(f_e);
  a.mask = static_cast<const T*>(mask);
  a.dc = static_cast<const T*>(dc);
  a.woe = static_cast<const T*>(woe);
  a.wdiv = static_cast<const T*>(wdiv);
  a.coe = static_cast<const int*>(coe);
  a.eoe = static_cast<const int*>(eoe);
  a.eoc = static_cast<const int*>(eoc);
  a.dt_bt = static_cast<T>(c[0]);
  a.mg = static_cast<T>(c[1]);
  a.r = static_cast<T>(c[2]);
  a.m = static_cast<T>(M);
  T* const out = static_cast<T*>(ub_out);
  T* const work = static_cast<T*>(ub_work);
  T* const acc = static_cast<T*>(avg);
  T* const sn = static_cast<T*>(ssh_out);
  const int ge = (a.E + threads - 1) / threads;
  const int gc = (a.C + threads - 1) / threads;
  const T* src = static_cast<const T*>(ubar);
  const T* s = static_cast<const T*>(ssh);
  for (int i = 0; i < M; ++i) {
    // the buffer of subcycle i: `out` for the last one, alternating back
    T* dst = ((M - 1 - i) % 2 == 0) ? out : work;
    edge_kernel<T><<<ge, threads, 0, stream>>>(a, src, s, dst, acc, i == 0,
                                               i == M - 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cell_kernel<T><<<gc, threads, 0, stream>>>(a, dst, s, sn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    s = sn;
  }
  return 0;
}

}  // namespace bt_gather
}  // namespace omega

// omega_bt_gather_<f32|f64>: M subcycles from ubar / ssh / g_slow / het
// (E, 1), (C, 1), (E, 1), (E, 1) into ub_out (E, 1), ssh_out (C, 1) and avg =
// <ubar> (E, 1), with ub_work (E, 1) as the second ub buffer; the mesh's
// cells_on_edge (E, 2), dc_edge (E), edges_on_edge (E, ME), weights_on_edge
// (E, ME), edges_on_cell (C, MC), w_div_cell (C, MC), f_edge (E), edge_mask
// (E); connectivity int32. `consts` = dt_bt, -g, r; `ints` = E, C, ME, MC,
// M, threads per block. Returns the first refused launch's error code, or 0.
#define OMEGA_BT_GATHER_ENTRY(SUF, T)                                         \
  int omega_bt_gather_##SUF(                                                  \
      const void* ubar, const void* ssh, const void* g_slow, const void* het, \
      void* ub_out, void* ub_work, void* ssh_out, void* avg,                  \
      const void* coe, const void* dc, const void* eoe, const void* woe,      \
      const void* eoc, const void* wdiv, const void* f_e, const void* mask,   \
      const double* consts, const int* ints, void* stream) {                  \
    return omega::bt_gather::launch<T>(                                       \
        ubar, ssh, g_slow, het, ub_out, ub_work, ssh_out, avg, coe, dc, eoe,  \
        woe, eoc, wdiv, f_e, mask, consts, ints,                              \
        static_cast<cudaStream_t>(stream));                                   \
  }

extern "C" {
OMEGA_BT_GATHER_ENTRY(f32, float)
OMEGA_BT_GATHER_ENTRY(f64, double)
}
