"""The sphere's split kernels (csrc/patch_split.cu: splitpre, splitpost;
csrc/bt_gather.cu: the barotropic subcycles) compiled for the CPU by g++
against a stand-in for the CUDA runtime, and run on CPU tensors against
their plain versions, float64 and float32, icosahedral subdivision 8, 10
layers (two layer groups of the patch passes), 2 tracers.

The stand-in maps `__global__` / `__device__` to nothing, `__fmul_rn` /
`__dmul_rn` to a product stored through a volatile (never fused), a
`__shared__` array to a static one, and a launch
`kern<<<grid, block, smem, stream>>>(args)` to a loop that runs the grid's
threads one after another. That is exact for these kernels: they meet at no
barrier, a thread reads only the part of a `__shared__` array it wrote
itself (the RK stage's pass D2), and no launch reads at a neighbour what it
writes. What the card alone can show (the build by nvcc, the launch, the
times) is chip_smoke.py's `kernel_patch_split`.

Limits: splitpre's du_out per channel max|diff| <= 1e-14 max|ref| in
float64 and 1e-6 in float32 (its momentum terms are summed in another order
than the chain's); splitpost and the subcycles 1e-14 / 1e-6 of each output's
largest value (the subcycles' tangential and divergence sums run in slot
order, the plain loop's patch stencils in their entry order)."""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import patch_icos_mesh, spherical_icos_mesh
from omega_tpu_torch.ops import bt_gather
from omega_tpu_torch.ops import patch_megastep as pm

CSRC = Path(pm.__file__).resolve().parent.parent / "csrc"
N, K, L, DT, M = 8, 10, 2, 120.0, 10
TOL = {torch.float64: 1e-14, torch.float32: 1e-6}

RUNTIME = r"""
#pragma once
#include <algorithm>
#include <cmath>
using std::min;
using std::max;
using std::sqrt;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0, sharedSizeBytes = 0;
};
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  *a = cudaFuncAttributes();
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dmul_rn(double a, double b) {
  volatile double r = a * b;
  return r;
}
namespace shim {
struct Grid {  // every thread of a launch, one after another
  dim3 g, b;
  long long i = -1, n;
  Grid(dim3 g_, dim3 b_) : g(g_), b(b_) {
    n = (long long)g.x * g.y * g.z * b.x * b.y * b.z;
    gridDim = g;
    blockDim = b;
  }
  bool next() {
    if (++i >= n) return false;
    long long t = i;
    threadIdx.x = t % b.x; t /= b.x;
    threadIdx.y = t % b.y; t /= b.y;
    threadIdx.z = t % b.z; t /= b.z;
    blockIdx.x = t % g.x; t /= g.x;
    blockIdx.y = t % g.y; t /= g.y;
    blockIdx.z = t;
    return true;
  }
};
}  // namespace shim
"""
LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<([^;]+?)>>>")


def _launch_loop(m):
    grid, block = [a.strip() for a in m.group(2).split(",")][:2]
    return f"for (shim::Grid _g({grid}, {block}); _g.next();) {m.group(1)}"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """patch_split.cu and bt_gather.cu built by g++ into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("split_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(LAUNCH.sub(_launch_loop, f.read_text()))
    so = d / "libsplit_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "patch_split.cu"),
         str(d / "bt_gather.cu"), "-o", str(so)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    for suf in ("f32", "f64"):
        for name, n in (("omega_patch_split_pre", 10),
                        ("omega_patch_split_post", 9),
                        ("omega_bt_gather", 19)):
            fn = getattr(out, f"{name}_{suf}")
            fn.argtypes = [vp] * n
            fn.restype = ctypes.c_int
    return out


def _mesh(varying_depth):
    ms = spherical_icos_mesh(N)
    if varying_depth:
        ms = dataclasses.replace(ms, bottom_depth=4000.0 + 500.0 * np.cos(
            np.asarray(ms.lat_cell)))
    return patch_icos_mesh(ms, N)


@pytest.fixture(scope="module")
def meshes():
    return {v: _mesh(v) for v in (False, True)}


def _setup(mnp, dtype):
    mesh = mnp.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, ssh_formulation="column",
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    rng = np.random.default_rng(3)
    lat, lon = np.asarray(mnp.lat_cell), np.asarray(mnp.lon_cell)
    depth = np.asarray(mnp.bottom_depth)
    h = (depth + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * (1.0 + 1e-3 * rng.standard_normal((mnp.ncells, K)))
    u = 0.1 * rng.standard_normal((mnp.nedges, K)) \
        * np.asarray(mnp.edge_mask)[:, None]
    tr = 10.0 + rng.standard_normal((L, mnp.ncells, K))
    st = ModelState(*(torch.as_tensor(a, dtype=dtype) for a in (h, u, tr)))
    p = pm.prep(mesh, dtype, "cpu")
    return mesh, cfg, st, p, pm.stack_frames(mesh, cfg, st)[0]


def _call_args(p, cfg, fr):
    _, cpl, consts, ints = pm._fb_args(p, cfg, fr, DT, None, "c")
    dv = p.consts["depth"]
    consts = np.append(consts, dv if isinstance(dv, float) else 0.0)
    ints = np.append(ints, int(p.depth_row is not None)).astype(np.int32)
    return cpl, consts, ints


def _chan(got, ref):
    return max(((got[:, c] - ref[:, c]).abs().max()
                / ref[:, c].abs().max()).item() for c in range(ref.shape[1]))


DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.mark.parametrize("varying_depth", [False, True])
@pytest.mark.parametrize("suf", list(DTYPES))
def test_split_pre_against_plain(lib, meshes, suf, varying_depth):
    """splitpre's five passes against split_pre_plain: the uniform depth
    as the scalar, a varying one as the kernel's depth row."""
    dtype = DTYPES[suf]
    _, cfg, _, p, fr = _setup(meshes[varying_depth], dtype)
    assert (p.depth_row is not None) == varying_depth
    cpl, consts, ints = _call_args(p, cfg, fr)
    work = fr.new_zeros(pm.split_work_fields(L) * K * p.P)
    du = fr.new_zeros((K, 3, p.P))
    code = getattr(lib, f"omega_patch_split_pre_{suf}")(
        fr.data_ptr(), du.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
        cpl.data_ptr(), None if p.depth_row is None
        else p.depth_row.data_ptr(), work.data_ptr(), consts.ctypes.data,
        ints.ctypes.data, None)
    assert code == 0
    assert _chan(du, pm.split_pre_plain(p, cfg, fr)) <= TOL[dtype]


@pytest.mark.parametrize("suf", list(DTYPES))
def test_split_post_against_plain(lib, meshes, suf):
    """splitpost's four passes against split_post_plain, with a transport
    velocity in the u channels; the u channels of `out` are left alone."""
    dtype = DTYPES[suf]
    _, cfg, _, p, fr = _setup(meshes[False], dtype)
    ft = fr.clone()
    ft[:, 1:4] *= 0.7
    cpl, consts, ints = _call_args(p, cfg, ft)
    work = fr.new_zeros(pm.split_work_fields(L) * K * p.P)
    out = torch.full_like(fr, 7.0)
    code = getattr(lib, f"omega_patch_split_post_{suf}")(
        ft.data_ptr(), out.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
        cpl.data_ptr(), work.data_ptr(), consts.ctypes.data,
        ints.ctypes.data, None)
    assert code == 0
    ref = pm.split_post_plain(p, cfg, ft, DT)
    assert _chan(torch.cat([out[:, :1], out[:, 4:]], 1), ref) <= TOL[dtype]
    assert bool((out[:, 1:4] == 7.0).all())


@pytest.mark.parametrize("bt_drag", [0.0, 1e-4])
@pytest.mark.parametrize("suf", list(DTYPES))
def test_subcycles_against_plain(lib, meshes, suf, bt_drag):
    """M = 10 subcycles of the gather-form kernel (two launches each)
    against subcycles_plain; dead seam edges stay 0."""
    dtype = DTYPES[suf]
    mesh = meshes[False].to("cpu", dtype)
    E, C = mesh.nedges, mesh.ncells
    rng = np.random.default_rng(5)
    em = mesh.edge_mask[:, None]
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    ins = (t(0.01 * rng.standard_normal((E, 1))) * em,
           t(rng.standard_normal((C, 1))),
           t(1e-6 * rng.standard_normal((E, 1))) * em,
           t(4000.0 + rng.standard_normal((E, 1))))
    ref = bt_gather.subcycles_plain(mesh, *ins, gravity=9.80616,
                                    dt_bt=DT / M, n_subcycles=M,
                                    bt_drag=bt_drag)
    m = bt_gather._mesh_arrays(mesh, dtype, torch.device("cpu"))
    ub, work, ssh, avg = (torch.zeros_like(ins[0]), torch.zeros_like(ins[0]),
                          torch.zeros_like(ins[1]), torch.zeros_like(ins[0]))
    consts = np.array([DT / M, -9.80616, bt_drag])
    ints = np.array([E, C, m["eoe"].shape[1], m["eoc"].shape[1], M, 256],
                    np.int32)
    code = getattr(lib, f"omega_bt_gather_{suf}")(
        *(a.data_ptr() for a in ins + (ub, work, ssh, avg)),
        *(m[k].data_ptr() for k in ("coe", "dc", "eoe", "woe", "eoc",
                                    "wdiv", "f_e", "mask")),
        consts.ctypes.data, ints.ctypes.data, None)
    assert code == 0
    for got, want in zip((ub, ssh, avg), ref):
        assert ((got - want).abs().max() / want.abs().max()).item() \
            <= TOL[dtype]
    assert bool((ub[mesh.edge_mask == 0] == 0).all())
