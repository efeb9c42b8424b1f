"""The sphere's split kernels (csrc/patch_split.cu: splitpre, splitpost;
csrc/bt_gather.cu: the barotropic subcycles) compiled for the CPU by g++
against a stand-in for the CUDA runtime, and run on CPU tensors against
their plain versions, float64 and float32, icosahedral subdivision 8, 10
layers (two layer groups of the patch passes), 2 tracers.

The stand-in maps `__global__` / `__device__` to nothing, `__fmul_rn` /
`__dmul_rn` to a product stored through a volatile (never fused), a
`__shared__` array to a static one, and a launch
`kern<<<grid, block, smem, stream>>>(args)` to a loop that runs the grid's
threads one after another. That is exact for the patch kernels: they meet
at no barrier, a thread reads only the part of a `__shared__` array it
wrote itself (the RK stage's pass D2), and no launch reads at a neighbour
what it writes. The subcycles are one cooperative launch whose blocks meet
at grid barriers: they run on the grid-level stand-in of
tests/grid_shim.py, with a block a cell group and a thread a list slot
(resident) and with two blocks walking several groups and slots
(streamed), also on a carved mesh (a coast). What the card alone can show
(the build by nvcc, the launch, the times) is chip_smoke.py's
`kernel_patch_split`.

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
    """patch_split.cu built by g++."""
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
         "-o", str(so)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    for suf in ("f32", "f64"):
        for name, n in (("omega_patch_split_pre", 10),
                        ("omega_patch_split_post", 9)):
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


@pytest.fixture(scope="module")
def bt_lib(tmp_path_factory):
    """bt_gather.cu built by g++ against the grid runtime."""
    import grid_shim
    out = grid_shim.build(tmp_path_factory.mktemp("bt_gather_shim"),
                          ["bt_gather.cu"], "bt_gather_shim")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for suf in ("f32", "f64"):
        fn = getattr(out, f"omega_bt_gather_{suf}")
        fn.argtypes = [vp] * 4
        fn.restype = ci
        fn = getattr(out, f"omega_bt_gather_attrs_{suf}")
        fn.argtypes = [ci] * 3 + [vp]
        fn.restype = ci
    return out


@pytest.fixture(scope="module")
def coast():
    """icos8 carved by a continent (|lat| < 60 deg, 0 <= lon < 60 deg)"""
    from omega_tpu_torch.mesh import carve_mesh
    ms = spherical_icos_mesh(N)
    lat = np.asarray(ms.lat_cell)
    lon = np.mod(np.asarray(ms.lon_cell), 2 * np.pi)
    return carve_mesh(ms, ~((np.abs(lat) < np.deg2rad(60.0))
                            & (lon < np.deg2rad(60.0))))


# mesh, groups, the shim's SMs (1 block an SM), threads a block (None: a
# thread a list slot, the resident form; fewer: the streamed form, each
# thread walking several slots)
BT_FORMS = {"resident": ("patch", 8, 8, None),
            "streamed": ("patch", 6, 2, 64),
            "coast_resident": ("coast", 6, 6, None),
            "coast_streamed": ("coast", 5, 2, 96)}
SMEM = 232448


def _bt_inputs(mesh, dtype, seed=5):
    E, C = mesh.nedges, mesh.ncells
    rng = np.random.default_rng(seed)
    em = mesh.edge_mask[:, None]
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return (t(0.01 * rng.standard_normal((E, 1))) * em,
            t(rng.standard_normal((C, 1))),
            t(1e-6 * rng.standard_normal((E, 1))) * em,
            t(4000.0 + rng.standard_normal((E, 1))))


def _bt_call(bt_lib, mesh, ins, ngroups, M, bt_drag, threads, grid=0,
             out=None, work=None):
    """one C call on NaN-filled outputs: (code, out)"""
    dtype = ins[0].dtype
    view = bt_gather.mesh_view(mesh, dtype, "cpu", ngroups)
    nan = lambda a: torch.full_like(a, float("nan"))
    out = out or (nan(ins[0]), nan(ins[1]), nan(ins[0]))
    work = work or (nan(ins[0]), nan(ins[1]))
    ptrs, consts, ints = bt_gather.call_args(
        view, ins, out, work, gravity=9.80616, dt_bt=DT / max(M, 1),
        n_subcycles=M,
        bt_drag=bt_drag, threads=threads, grid=grid)
    suf = "f64" if dtype == torch.float64 else "f32"
    code = getattr(bt_lib, f"omega_bt_gather_{suf}")(
        ptrs.ctypes.data, consts.ctypes.data, ints.ctypes.data, None)
    return code, out


@pytest.mark.parametrize("form", list(BT_FORMS))
@pytest.mark.parametrize("bt_drag", [0.0, 1e-4])
@pytest.mark.parametrize("suf", list(DTYPES))
def test_subcycles_against_plain(bt_lib, meshes, coast, suf, bt_drag, form):
    """M = 10 subcycles of the gather-form kernel (one cooperative launch)
    against subcycles_plain; dead seam and coast edges stay 0."""
    dtype = DTYPES[suf]
    which, ngroups, sms, threads = BT_FORMS[form]
    mesh = (meshes[False] if which == "patch" else coast).to("cpu", dtype)
    bt_lib.shim_set_device(sms, 1, SMEM)
    ins = _bt_inputs(mesh, dtype)
    ref = bt_gather.subcycles_plain(mesh, *ins, gravity=9.80616,
                                    dt_bt=DT / M, n_subcycles=M,
                                    bt_drag=bt_drag)
    code, got = _bt_call(bt_lib, mesh, ins, ngroups, M, bt_drag, threads)
    assert code == 0
    for g, want in zip(got, ref):
        assert ((g - want).abs().max() / want.abs().max()).item() \
            <= TOL[dtype]
    assert bool((mesh.edge_mask == 0).any())
    assert bool((got[0][mesh.edge_mask == 0] == 0).all())


def test_subcycles_one_group_and_one_subcycle(bt_lib, meshes):
    """M = 1 and M = 2, one group (every edge its own, one block walking
    all slots), float64; the resident form (a block a group, a thread a
    slot) and the streamed one (one block walking three groups) give the
    same bits."""
    mesh = meshes[False].to("cpu", torch.float64)
    ins = _bt_inputs(mesh, torch.float64, seed=7)
    for M in (1, 2):
        ref = bt_gather.subcycles_plain(mesh, *ins, gravity=9.80616,
                                        dt_bt=DT / M, n_subcycles=M)
        bt_lib.shim_set_device(1, 1, SMEM)
        code, got = _bt_call(bt_lib, mesh, ins, 1, M, 0.0, 128)
        assert code == 0
        for g, want in zip(got, ref):
            assert ((g - want).abs().max() / want.abs().max()).item() \
                <= TOL[torch.float64]
    bt_lib.shim_set_device(3, 1, SMEM)
    _, res = _bt_call(bt_lib, mesh, ins, 3, 4, 1e-4, None)
    bt_lib.shim_set_device(1, 1, SMEM)
    _, strm = _bt_call(bt_lib, mesh, ins, 3, 4, 1e-4, None)
    assert all(torch.equal(a, b) for a, b in zip(res, strm))


def test_groups_cover_the_mesh(meshes, coast):
    """Every cell in one group, every edge in the list of each group whose
    cells name it and owned by exactly one, lslot pointing at the edge
    each slot names; the carved mesh's stored connectivity has no -1, and
    -1 in it is refused."""
    for mesh, ng in ((meshes[False], 7), (coast, 5)):
        cs, es, el, ls = bt_gather.groups(mesh, ng)
        eoc = np.asarray(mesh.edges_on_cell)
        E, C = mesh.nedges, mesh.ncells
        assert cs[0] == 0 and cs[-1] == C and np.all(np.diff(cs) > 0)
        assert np.bincount(el[el >= 0], minlength=E).tolist() == [1] * E
        for g in range(ng):
            lst = el[es[g]:es[g + 1]]
            edges = np.where(lst >= 0, lst, ~lst)
            assert np.all(np.diff(edges) > 0)
            cells = slice(cs[g], cs[g + 1])
            assert np.array_equal(edges[ls[cells]], eoc[cells])
    bad = dataclasses.replace(coast, edges_on_cell=np.where(
        np.asarray(coast.edges_on_cell) == 0, -1, coast.edges_on_cell))
    with pytest.raises(ValueError, match="edges_on_cell"):
        bt_gather.groups(bad, 3)


# case -> what it changes in a valid float64 call with 6 groups on a card
# of 2 SMs x 1 block
BT_REFUSED = {
    "no_subcycle": dict(M=0),
    "grid_beyond_the_card": dict(grid=3),
    "threads_1056": dict(threads=1056),
    "threads_odd": dict(threads=100),
    "ub_out_is_work": dict(alias=("ub", 0)),
    "ssh_out_is_ssh": dict(alias=("ssh", 1)),
    "avg_is_ub_out": dict(alias=("avg", 0)),
}


@pytest.mark.parametrize("case", list(BT_REFUSED))
def test_subcycles_refuse_bad_arguments(bt_lib, meshes, case):
    """A call the launcher does not take returns an error code and writes
    nothing: no subcycle, a grid larger than the card holds co-resident
    (cudaErrorCooperativeLaunchTooLarge), a block of more than 1024 threads
    or not of whole warps, a ping-pong buffer or output aliasing another
    or an input."""
    mesh = meshes[False].to("cpu", torch.float64)
    bt_lib.shim_set_device(2, 1, SMEM)
    bad = BT_REFUSED[case]
    ins = _bt_inputs(mesh, torch.float64)
    z = lambda a: torch.zeros_like(a)
    out, work = (z(ins[0]), z(ins[1]), z(ins[0])), (z(ins[0]), z(ins[1]))
    if "alias" in bad:
        what, _ = bad["alias"]
        if what == "ub":
            work = (out[0], work[1])
        elif what == "ssh":
            out = (out[0], ins[1], out[2])
        else:
            out = (out[0], out[1], out[0])
    code, _ = _bt_call(bt_lib, mesh, ins, 6, bad.get("M", 3), 0.0,
                       bad.get("threads", 64), grid=bad.get("grid", 0),
                       out=out, work=work)
    assert code != 0
    if case == "grid_beyond_the_card":
        assert code == 720          # cudaErrorCooperativeLaunchTooLarge
    if case != "ssh_out_is_ssh":
        assert all(bool((a == 0).all()) for a in out + work)


def test_mesh_view_is_built_once_per_mesh(meshes):
    """The kernel's view of the mesh (int32 connectivity, weights in the
    working type, the groups) is built once per mesh, type, device and
    group count and dropped with the mesh; a mesh made by replace() gets
    its own. On the CPU bt_subcycles writes the plain loop into `out`."""
    import gc
    mesh = meshes[False].to("cpu", torch.float64)
    v = bt_gather.mesh_view(mesh, torch.float64, "cpu", 5)
    assert bt_gather.mesh_view(mesh, torch.float64, "cpu", 5) is v
    assert bt_gather.mesh_view(mesh, torch.float32, "cpu", 5) is not v
    assert v["coe"].dtype == torch.int32 and v["dc"].dtype == torch.float64
    assert v["ptrs"] == [v[k].data_ptr() for k in bt_gather._MESH_PTRS]
    other = dataclasses.replace(mesh, f_edge=2.0 * mesh.f_edge)
    w = bt_gather.mesh_view(other, torch.float64, "cpu", 5)
    assert torch.equal(w["f_e"], 2.0 * v["f_e"])
    key = id(other)
    del other, w
    gc.collect()
    assert key not in bt_gather._VIEWS
    ins = _bt_inputs(mesh, torch.float64)
    out = tuple(torch.empty_like(a) for a in (ins[0], ins[1], ins[0]))
    got = bt_gather.bt_subcycles(mesh, *ins, gravity=9.80616, dt_bt=DT / M,
                                 n_subcycles=M, out=out)
    ref = bt_gather.subcycles_plain(mesh, *ins, gravity=9.80616,
                                    dt_bt=DT / M, n_subcycles=M)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
