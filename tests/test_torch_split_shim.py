"""The planar split step's kernels (csrc/split.cu: splitpre's column pass and
chain, splitpost) compiled for the CPU by g++ against the block-level
stand-in for the CUDA runtime of tests/test_torch_rk_shim.py (a block's
threads as fibers meeting at `__syncthreads()`, its dynamic shared array
one NaN-filled buffer; blocks one after another, so the chain's tickets
come in block order and no block waits on its tile's flag), and run on CPU
tensors against the plain versions (ops/megastep.split_pre_plain,
split_post_plain) on planar hex meshes of 32 x 16 x 3 (one tile) and 48 x 20
x 5 (four tiles, ragged), 2 tracers, bt_drag 1e-4: float64 and float32; then
the arguments splitpre's launcher refuses.

Limits (chip_smoke.py's `kernel_split`): float64 per channel max|diff| <=
1e-12 max|ref| of du_full and of every plane splitpre writes, and of
splitpost's state; float32 per channel max|diff| <= SPLIT_PRE_ERR max|ref|
for splitpre (g_slow is a difference of near-equal terms) and the error of
splitpost's increment <= POST_INCR of the largest increment. What the card
alone can show (the build by nvcc, the launch, the times) is chip_smoke.py's
`kernel_split`."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_rk_shim import BLOCK_RUNTIME, _block_source
from test_torch_sphere_split_shim import CSRC

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import megastep

L, DT, R = 2, 120.0, 1e-4
MESHES = {"32x16x3": (32, 16, 3), "48x20x5": (48, 20, 5)}
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SPLIT_PRE_ERR, POST_INCR = 5e-5, 5e-3
PRE_NAMES = (["du0", "du1", "du2"] + [f"ubar{t}" for t in range(3)]
             + ["sshc"] + [f"g_slow{t}" for t in range(3)]
             + [f"het{t}" for t in range(3)]
             + [f"du_bar{t}" for t in range(3)])
# the integer atomics and the fence of the chain's depth average, on one
# thread (a block's fibers take turns)
SPLIT_RUNTIME = BLOCK_RUNTIME + r"""
inline int atomicAdd(int* a, int v) { const int o = *a; *a = o + v; return o; }
inline int atomicExch(int* a, int v) { const int o = *a; *a = v; return o; }
inline void __threadfence() {}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """split.cu built by g++ into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("split_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(SPLIT_RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    so = d / "libsplit_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "split.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp, cd, ci = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for suf in DTYPES:
        fn = getattr(out, f"omega_split_pre_{suf}")
        fn.argtypes = [vp] * 4 + [cd] * 4 + [ci, vp]
        fn.restype = ci
        fn = getattr(out, f"omega_split_post_{suf}")
        fn.argtypes = [vp] * 5 + [ci, vp]
        fn.restype = ci
    return out


@pytest.fixture(scope="module")
def meshes():
    return {k: planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                               bottom_depth=1000.0)
            for k, (nx, ny, _) in MESHES.items()}


def _setup(mesh_np, K, dtype):
    """(mesh, cfg, stacked state): chip_smoke.py's noisy state with the
    column free surface, tracer hyperdiffusion on."""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, ssh_formulation="column",
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9,
                                                eddy_diff4=1e6))
    assert megastep.split_supported(mesh, cfg)
    rng = np.random.default_rng(13 + K)
    kx, ky = 2 * np.pi / mesh_np.x_period, 2 * np.pi / mesh_np.y_period
    x, y = np.asarray(mesh_np.x_cell), np.asarray(mesh_np.y_cell)
    h = (1000.0 + np.sin(kx * x) * np.sin(ky * y))[:, None] / K \
        * (1.0 + 1e-3 * rng.standard_normal((mesh_np.ncells, K)))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    st = ModelState(t(h), t(0.01 * rng.standard_normal((mesh_np.nedges, K))),
                    t(10.0 + rng.standard_normal((L, mesh_np.ncells, K))))
    return mesh, cfg, megastep.stack_state(mesh, st)


def _pre(lib, mesh, cfg, s, du, planes, rec=None, threads=None,
         ptrs=None):
    """one splitpre call (the chain's record unless `rec`); its code"""
    r, th, (depth, ggrad, f_e) = megastep._split_rec(mesh, cfg, 0.0, s,
                                                     "splitpre")
    suf = "f64" if s.dtype == torch.float64 else "f32"
    a = ptrs or (s.data_ptr(), du.data_ptr(), planes.data_ptr())
    return getattr(lib, f"omega_split_pre_{suf}")(
        *a, (r if rec is None else rec).ctypes.data, depth, ggrad, f_e, R,
        th if threads is None else threads, None)


@pytest.fixture(autouse=True)
def _records_without_the_card(monkeypatch):
    """_split_rec checks the record against the loaded library; here the
    library is the g++ one, so the check reads it from there."""
    monkeypatch.setattr(megastep._build, "load", lambda: _ShimLib())


class _ShimLib:
    """the two queries _split_rec makes of the library"""

    @staticmethod
    def omega_fb_params_size_f64():
        return megastep._params_dtype(np.float64).itemsize

    @staticmethod
    def omega_fb_params_size_f32():
        return megastep._params_dtype(np.float32).itemsize

    @staticmethod
    def omega_split_slots(kind):
        return {1: 18, 3: 16}[kind]


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("shape", list(MESHES))
def test_split_pre_against_plain(lib, meshes, shape, suf):
    """The column pass and the chain (with the depth average and the slow
    forcing) against split_pre_plain, output channel by channel; the
    planes past du_bar are the kernel's scratch."""
    dtype = DTYPES[suf]
    mesh, cfg, s = _setup(meshes[shape], MESHES[shape][2], dtype)
    du, planes = megastep.split_work(s)
    du.fill_(float("nan"))
    planes.fill_(float("nan"))
    assert _pre(lib, mesh, cfg, s, du, planes) == 0
    du_p, pl_p = megastep.split_pre_plain(mesh, cfg, s, R)
    got = list(du) + list(planes[:megastep.P_DUBAR + 3])
    ref = list(du_p) + list(pl_p)
    limit = 1e-12 if dtype == torch.float64 else SPLIT_PRE_ERR
    for name, a, b in zip(PRE_NAMES, got, ref):
        assert bool(torch.isfinite(a).all()), name
        e = ((a - b).abs().max() / b.abs().max()).item()
        assert e <= limit, (name, e)


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("shape", list(MESHES))
def test_split_post_against_plain(lib, meshes, shape, suf):
    """splitpost (on its own record, plan_tile's) against
    split_post_plain on the plain splitpre's outputs and made-up subcycle
    results."""
    dtype = DTYPES[suf]
    mesh, cfg, s = _setup(meshes[shape], MESHES[shape][2], dtype)
    du_p, pl_p = megastep.split_pre_plain(mesh, cfg, s, R)
    planes = s.new_zeros((megastep.NPLANES,) + tuple(s.shape[2:]))
    planes[:pl_p.shape[0]] = pl_p
    rng = np.random.default_rng(3)
    planes[megastep.P_UBF:megastep.P_UAVG + 3] = torch.as_tensor(
        0.01 * rng.standard_normal((7,) + tuple(s.shape[2:])), dtype=dtype)
    rec, th, _ = megastep._split_rec(mesh, cfg, DT, s, "splitpost")
    out = torch.zeros_like(s)
    assert getattr(lib, f"omega_split_post_{suf}")(
        s.data_ptr(), du_p.data_ptr(), planes.data_ptr(), out.data_ptr(),
        rec.ctypes.data, th, None) == 0
    ref = megastep.split_post_plain(mesh, cfg, s, du_p, planes, DT)
    for c in range(ref.shape[0]):
        if dtype == torch.float64:
            e = ((out[c] - ref[c]).abs().max() / ref[c].abs().max()).item()
            assert e <= 1e-12, (c, e)
        else:
            e = ((out[c] - ref[c]).abs().max()
                 / (ref[c] - s[c]).abs().max()).item()
            assert e <= POST_INCR, (c, e)


# case -> what it changes in a valid float64 call on 48 x 20 x 5
REFUSED = {
    "threads_128": dict(threads=128),
    "threads_512": dict(threads=512),
    "another_tile": dict(tile=(8, 32)),
    "another_ring": dict(ring=(3, 3)),
    "another_entry_pattern": dict(pattern=True),
    "no_layers": dict(K=0),
    "no_planes": dict(null=True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_split_pre_refuses_bad_arguments(lib, meshes, case):
    """A call splitpre's launcher does not take returns an error code and
    writes nothing: a block of other than 256 threads, a record packed for
    another tile, ring or entry pattern than the chain's compiled ones, no
    layers, a null array."""
    mesh, cfg, s = _setup(meshes["48x20x5"], 5, torch.float64)
    bad = REFUSED[case]
    rec = megastep._split_rec(mesh, cfg, 0.0, s, "splitpre")[0].copy()
    if "tile" in bad or "ring" in bad:
        tabs, c = megastep._split_args(mesh, cfg, 0.0)
        ring = bad.get("ring", megastep.split_ring(tabs, "splitpre"))
        plan = megastep.plan_tile(20, 48, 8, ring, bad.get("tile", (16, 32)),
                                  megastep.SPLIT_SLOTS["splitpre"])
        rec = megastep.pack_params(tabs, c, np.float64, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, 5, 20, 48
    if bad.get("pattern"):
        rec["off"][1, 3] += 1
    if "K" in bad:
        rec["K"] = bad["K"]
    du, planes = megastep.split_work(s)
    du.fill_(7.0)
    planes.fill_(7.0)
    ptrs = (s.data_ptr(), du.data_ptr(), None) if bad.get("null") else None
    assert _pre(lib, mesh, cfg, s, du, planes, rec, bad.get("threads"),
                ptrs) != 0
    assert bool((du == 7.0).all()) and bool((planes == 7.0).all())
