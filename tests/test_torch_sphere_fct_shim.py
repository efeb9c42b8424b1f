"""FCT's stage B on the sphere (csrc/patch_fct.cu: the flux, ratios, limit
and tracers passes of one call) compiled for the CPU by g++ against the
stand-in for the CUDA runtime of tests/test_torch_sphere_split_shim.py (a
launch runs the grid's threads one after another: exact here, since the
passes meet at no barrier and no pass reads at a neighbour what it writes
itself), and run on CPU tensors against its plain version
(ops/patch_megastep.fct_b_plain): icosahedral subdivision 8, 9 layers (a
layer group of 8 ends part-filled), 2 tracers (tracer 0 a 0/1 cap), center
and upwind thickness flux, float64 and float32. Stage B reads stage A's
output after the refresh, made as chip_smoke.py's `kernel_patch_fct` makes
it (the plain stage A, the FCT fix submesh's composed stage A,
fct_refresh_mid). Then other blocks and layer groups, the arguments the
call refuses, and the passes' attribute reader.

Limits (the card's, chip_smoke.py's `kernel_patch_fct`, and the patch
kernels' float32 rule of tests/test_torch_sphere_fb_shim.py): float64 per
channel max|diff| <= 1e-12 max|ref|; float32 per channel the error of the
increment (trn against the tracer it starts from) <= PATCH_INCR = 5e-4 of
the largest increment. What the card alone can show (the build by nvcc, the
launch, the times) is chip_smoke.py."""

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

N, K, L, DT = 8, 9, 2, 60.0
F64_TOL, PATCH_INCR = 1e-12, 5e-4
DTYPES = {"f64": torch.float64, "f32": torch.float32}
FLUX = {"c": {}, "u": dict(flux_thickness_type="upwind")}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """patch_fct.cu built by g++ into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("fct_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(LAUNCH.sub(_launch_loop, f.read_text()))
    so = d / "libfct_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "patch_fct.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for fl in FLUX:
        for suf in DTYPES:
            fn = getattr(out, f"omega_patch_fct_b_{fl}_{suf}")
            fn.argtypes = [ctypes.c_void_p] * 10
            fn.restype = ctypes.c_int
            fn = getattr(out, f"omega_patch_fct_b_attrs_{fl}_{suf}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return patch_icos_mesh(spherical_icos_mesh(N), N)


_SETUPS: dict = {}


def _setup(mesh_np, fl, dtype):
    """(prep, cfg, frames, mid): the sphere state of
    tests/test_torch_sphere_fb_shim.py with tracer 0 a 0/1 cap, and stage
    A's refreshed output; once per flux and type"""
    key = (fl, dtype)
    if key in _SETUPS:
        return _SETUPS[key]
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, flux_tracer_type="fct",
                      **FLUX[fl], tendencies=TendencyConfig(
                          visc_del2=1e3, visc_del4=1e9, eddy_diff4=1e9))
    rng = np.random.default_rng(37)
    lat, lon = np.asarray(mesh_np.lat_cell), np.asarray(mesh_np.lon_cell)
    em = np.asarray(mesh_np.edge_mask)[:, None]
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * (1.0 + 1e-3 * rng.standard_normal((mesh_np.ncells, K)))
    u = 0.5 * rng.standard_normal((mesh_np.nedges, K)) * em
    tr = 10.0 + rng.standard_normal((L, mesh_np.ncells, K))
    tr[0] = (np.cos(lat) * np.cos(lon) > 0.7)[:, None] * np.ones((1, K))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    p = pm.prep(mesh, dtype, "cpu", fct=True)
    fr, fix = pm.stack_frames(mesh, cfg, ModelState(t(h), t(u), t(tr)))
    mid_fix, _ = pm.fct_sub_a(p, cfg, fr, fix, 0.0, DT)
    mid = pm.fct_refresh_mid(p, pm.fct_a_plain(p, cfg, fr, DT), mid_fix)
    _SETUPS[key] = p, cfg, fr, mid
    return _SETUPS[key]


def _call(lib, name, p, fr, mid, out, work, consts, ints):
    return getattr(lib, name)(
        mid.data_ptr(), fr.data_ptr(), out.data_ptr(), p.offs.data_ptr(),
        p.wts.data_ptr(), p.cpl.data_ptr(), work.data_ptr(),
        consts.ctypes.data, ints.ctypes.data, None)


def _check_against_plain(lib, mesh_np, fl, dtype, threads=None, kg=None):
    """One call against fct_b_plain, tracer by tracer; the other channels
    of `out` are not written."""
    p, cfg, fr, mid = _setup(mesh_np, fl, dtype)
    out = torch.full_like(fr, float("nan"))
    name, consts, ints, work = pm._fct_b_args(p, cfg, mid, fr, DT, out,
                                              None)
    assert work.numel() == 8 * L * K * p.P
    if threads is not None:
        ints[4], ints[5] = kg, threads
    assert _call(lib, name, p, fr, mid, out, work, consts, ints) == 0
    ref = pm.fct_b_plain(p, cfg, mid, fr, DT)
    assert bool(torch.isnan(out[:, :4]).all())
    got = out[:, 4:]
    assert bool(torch.isfinite(got).all())
    for l in range(L):
        err = (got[:, l] - ref[:, l]).abs().max()
        if dtype == torch.float64:
            assert err <= F64_TOL * ref[:, l].abs().max(), l
        else:
            incr = (ref[:, l] - fr[:, 4 + l]).abs().max()
            assert err <= PATCH_INCR * incr, l


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("fl", list(FLUX))
def test_fct_b_against_plain(lib, mesh_np, fl, suf):
    """The call the wrapper makes (LAYERS_PER_THREAD, THREADS) against
    fct_b_plain."""
    _check_against_plain(lib, mesh_np, fl, DTYPES[suf])


@pytest.mark.parametrize("threads,kg", [(32, 1), (96, 3), (256, 9)])
@pytest.mark.parametrize("fl", list(FLUX))
def test_fct_b_any_block_and_layer_group(lib, mesh_np, fl, threads, kg):
    """The passes cover every position and layer for other blocks and
    layer groups too (a last block ending past the frame, one group of
    every layer), float64, center and upwind thickness flux."""
    _check_against_plain(lib, mesh_np, fl, torch.float64, threads, kg)


# case -> what it changes in a valid call of the center-flux float64 stage
REFUSED = {"threads_16": dict(threads=16), "threads_512": dict(threads=512),
           "threads_100": dict(threads=100), "no_layers": dict(K=0),
           "no_tracers": dict(L=0), "no_layer_group": dict(kg=0),
           "out_is_mid": dict(alias="mid"), "out_is_in": dict(alias="in"),
           "no_work": dict(work=None), "no_table": dict(table=None)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_fct_b_refuses_bad_arguments(lib, mesh_np, case):
    """A call the stage does not take returns an error code and writes
    nothing: a block of fewer than 32, more than 256 or not a multiple of
    32 threads, no layers, tracers or layers per thread, `out` aliasing an
    input, no scratch, no table."""
    p, cfg, fr, mid = _setup(mesh_np, "c", torch.float64)
    bad = REFUSED[case]
    out = torch.zeros_like(fr)
    name, consts, ints, work = pm._fct_b_args(p, cfg, mid, fr, DT, out,
                                              None)
    work.zero_()
    for i, f in ((5, "threads"), (2, "K"), (3, "L"), (4, "kg")):
        if f in bad:
            ints[i] = bad[f]
    before = fr.clone(), mid.clone()
    target = {"mid": mid, "in": fr}.get(bad.get("alias"), out)
    code = getattr(lib, name)(
        mid.data_ptr(), fr.data_ptr(), target.data_ptr(),
        None if "table" in bad else p.offs.data_ptr(), p.wts.data_ptr(),
        p.cpl.data_ptr(), None if "work" in bad else work.data_ptr(),
        consts.ctypes.data, ints.ctypes.data, None)
    assert code != 0
    assert torch.equal(fr, before[0]) and torch.equal(mid, before[1])
    assert (out == 0).all() and (work == 0).all()


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("fl", list(FLUX))
def test_fct_b_attrs_names_four_passes(lib, fl, suf):
    """The attribute reader answers for passes 0 ... 3 (FCT_B_PASS_NAMES)
    at the wrapper's block and refuses another pass or block."""
    got = np.zeros(4, np.int32)
    fn = getattr(lib, f"omega_patch_fct_b_attrs_{fl}_{suf}")
    for i in range(len(pm.FCT_B_PASS_NAMES)):
        assert fn(i, pm.THREADS, got.ctypes.data) == 0
    assert fn(len(pm.FCT_B_PASS_NAMES), pm.THREADS, got.ctypes.data) != 0
    assert fn(0, 16, got.ctypes.data) != 0
    assert pm.FCT_B_PASSES == len(pm.FCT_B_PASS_NAMES)
