"""The sphere's forward-backward patch step (csrc/patch_step.cuh through
patch_step_cc.cu, patch_step_uu.cu and patch_step_cf.cu: the passes A, B,
C, D1 the cells, D2 the edges and E) compiled for the CPU by g++ against the
stand-in for the CUDA runtime of tests/test_torch_sphere_split_shim.py, and
run on CPU tensors against its plain versions (ops/patch_megastep.chain_plain
for the FB chain, fct_a_plain for FCT's stage A): icosahedral subdivision
8, 10 layers (each pass's group of layers per thread, kFbPassLayers, ends
part-filled or is the whole column), 2 tracers; center fluxes with and
without the wind / drag tails, upwind fluxes with them, FCT's stage A with
center thickness fluxes, float64 and float32; and the arguments a call
refuses.

Limits (the card's, chip_smoke.py's `kernel_patch` and `kernel_patch_fct`):
float64 per channel max|diff| <= 1e-12 max|ref|; float32 per channel the
error of the increment (what the step changed against what it starts
from: h, u and the tracers, FCT's trtd against the tracer and facc against
tr h) <= PATCH_INCR = 5e-4 of the largest increment. What the card alone
can show (the build by nvcc, the launch, the times) is chip_smoke.py."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_sphere_split_shim import CSRC, LAUNCH, RUNTIME, _launch_loop

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import patch_icos_mesh, spherical_icos_mesh
from omega_tpu_torch.ops import patch_megastep as pm

N, K, L, DT = 8, 10, 2, 60.0
F64_TOL, PATCH_INCR = 1e-12, 5e-4
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# source -> configuration keywords
FLUX = {"cc": {}, "uu": dict(flux_thickness_type="upwind",
                             flux_tracer_type="upwind"),
        "cf": dict(flux_tracer_type="fct")}
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)
CASES = [("cc", False), ("cc", True), ("uu", True), ("cf", False)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """patch_step_cc.cu, _uu.cu and _cf.cu built by g++ (side by side) into
    one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("fb_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(LAUNCH.sub(_launch_loop, f.read_text()))
    procs = [subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-c", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / f"patch_step_{fl}.cu"),
         "-o", str(d / f"{fl}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for fl in FLUX]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
    so = d / "libfb_shim.so"
    r = subprocess.run([gxx, "-shared", "-o", str(so)]
                       + [str(d / f"{fl}.o") for fl in FLUX],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for fl in FLUX:
        for tl in ("plain", "tails"):
            for suf in DTYPES:
                fn = getattr(out, f"omega_patch_fb_{fl}_{tl}_{suf}")
                fn.argtypes = [ctypes.c_void_p] * 9
                fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return patch_icos_mesh(spherical_icos_mesh(N), N)


def _setup(mesh_np, fl, tails, dtype):
    """(prep, cfg, wind bundle, frames): the sphere state of
    tests/test_torch_sphere_rk_shim.py; FCT with tracer 0 a 0/1 cap"""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, **FLUX[fl],
                      tendencies=TendencyConfig(
                          visc_del2=1e3, visc_del4=1e9, eddy_diff4=1e9,
                          **(WIND_DRAG if tails else {})))
    rng = np.random.default_rng(31)
    lat, lon = np.asarray(mesh_np.lat_cell), np.asarray(mesh_np.lon_cell)
    em = np.asarray(mesh_np.edge_mask)[:, None]
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * (1.0 + 1e-3 * rng.standard_normal((mesh_np.ncells, K)))
    u = 0.1 * rng.standard_normal((mesh_np.nedges, K)) * em
    tr = 10.0 + rng.standard_normal((L, mesh_np.ncells, K))
    if fl == "cf":
        tr[0] = (np.cos(lat) * np.cos(lon) > 0.7)[:, None] * np.ones((1, K))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    st = ModelState(t(h), t(u), t(tr))
    p = pm.prep(mesh, dtype, "cpu", fct=fl == "cf")
    wind = None
    if tails:
        wind = pm.make_wind(mesh, cfg, (t(0.1 * np.cos(lat)),
                                        t(0.05 * np.sin(lat))), dtype)
    return p, cfg, wind, pm.stack_frames(mesh, cfg, st)[0]


def _run(lib, p, cfg, wind, fr, fl, threads=None, out=None):
    """one call of the kernel's C entry; (return code, out, work)"""
    name, cpl, consts, ints = pm._fb_args(p, cfg, fr, DT, wind, fl[1])
    if threads is not None:
        ints[5] = threads
    K_, CH, P = fr.shape
    if out is None:
        out = torch.full((K_, 2 * CH - 4 if fl == "cf" else CH, P),
                         float("nan"), dtype=fr.dtype)
    work = fr.new_zeros(pm.work_fields(L) * K_ * P)
    code = getattr(lib, name)(
        fr.data_ptr(), out.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
        cpl.data_ptr(), work.data_ptr(), consts.ctypes.data,
        ints.ctypes.data, None)
    return code, out, work


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("fl,tails", CASES, ids=[
    f"{fl}_{'tails' if tl else 'plain'}" for fl, tl in CASES])
def test_fb_step_against_plain(lib, mesh_np, fl, tails, suf):
    """One call's six passes against the plain chain, every channel."""
    dtype = DTYPES[suf]
    p, cfg, wind, fr = _setup(mesh_np, fl, tails, dtype)
    code, got, _ = _run(lib, p, cfg, wind, fr, fl)
    assert code == 0
    if fl == "cf":
        ref = pm.fct_a_plain(p, cfg, fr, DT, wind=wind)
        # trtd{l} starts from tr{l}, facc{l} from tr{l} h
        start = torch.cat([fr[:, :4]] + [
            x for l in range(L) for x in (fr[:, 4 + l:5 + l],
                                          fr[:, 4 + l:5 + l] * fr[:, :1])],
            1)
    else:
        ref = pm.chain_plain(p, cfg, fr, DT, wind=wind)
        start = fr
    assert bool(torch.isfinite(got).all())
    for c in range(ref.shape[1]):
        err = (got[:, c] - ref[:, c]).abs().max()
        if dtype == torch.float64:
            assert err <= F64_TOL * ref[:, c].abs().max(), c
        else:
            assert err <= PATCH_INCR * (ref[:, c] - start[:, c]).abs().max(), c


# case -> what it changes in a valid call of the center-flux float64 step
REFUSED = {"threads_300": dict(threads=300), "threads_48": dict(threads=48),
           "wind_without_tails": dict(wind=True),
           "out_is_in": dict(alias=True)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_fb_step_refuses_bad_arguments(lib, mesh_np, case):
    """A call the step does not take returns an error code and launches
    nothing: a block of more than 256 threads or not a multiple of 32, the
    wind asked of the instantiation without tails, `out` aliasing the
    frames it reads at neighbours."""
    p, cfg, _, fr = _setup(mesh_np, "cc", False, torch.float64)
    bad = REFUSED[case]
    before = fr.clone()
    name, cpl, consts, ints = pm._fb_args(p, cfg, fr, DT, None, "c")
    if "threads" in bad:
        ints[5] = bad["threads"]
    if bad.get("wind"):
        ints[-2] = 1
    out = fr if bad.get("alias") else torch.zeros_like(fr)
    work = fr.new_zeros(pm.work_fields(L) * K * p.P)
    assert getattr(lib, name)(
        fr.data_ptr(), out.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
        cpl.data_ptr(), work.data_ptr(), consts.ctypes.data,
        ints.ctypes.data, None) != 0
    assert torch.equal(fr, before) and (work == 0).all()
    if not bad.get("alias"):
        assert (out == 0).all()
