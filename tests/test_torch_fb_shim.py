"""The planar FB step kernel (csrc/fb_step.cuh through fb_step.cu and the
five other fb_step_*.cu, one per flux pair) compiled for the CPU by g++
against the block-level stand-in for the CUDA runtime of
tests/test_torch_rk_shim.py (a block's threads as fibers meeting at
`__syncthreads()`, its dynamic shared array one NaN-filled buffer, so a read
of a slot no level wrote shows), and run on CPU tensors against the
kernel's plain version (ops/megastep.fb_megastep_plain) on a 32 x 16 planar
hex mesh, 3 layers, 2 tracers: every pairing of the thickness flux (center,
upwind) and the tracer flux (center, upwind, FCT), without and with the
wind / drag tails, float64 and float32; then the arguments a launch
refuses, and the host's check of the entry pattern. No JAX here:
tests/test_torch_megastep.py and tests/test_torch_fct.py hold the plain
version against the JAX package.

Limits (chip_smoke.py's `kernel_fb_step`): float64 per channel max|diff| <=
1e-12 max|ref| after one step; float32 max|diff| <= 1e-4 max|ref| over h,
u and the tracers, and per channel the error of the step's increment <=
FB_INCR = 0.01 of the largest increment."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_rk_shim import BLOCK_RUNTIME, _block_source
from test_torch_sphere_split_shim import CSRC

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import megastep, structured

NX, NY, K, L, DT = 32, 16, 3, 2, 30.0
F64_TOL, FB_INCR = 1e-12, 0.01
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# source file -> (thickness flux, tracer flux) of its pair
PAIRS = {"fb_step": ("center", "center"), "fb_step_uc": ("upwind", "center"),
         "fb_step_cu": ("center", "upwind"), "fb_step_uu": ("upwind", "upwind"),
         "fb_step_cf": ("center", "fct"), "fb_step_uf": ("upwind", "fct")}
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The six fb_step*.cu built by g++ (side by side) into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("planar_fb_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(BLOCK_RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    procs = [subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-c", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / f"{src}.cu"),
         "-o", str(d / f"{src}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in PAIRS]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
    so = d / "libplanar_fb_shim.so"
    r = subprocess.run([gxx, "-shared", "-pthread", "-o", str(so)]
                       + [str(d / f"{src}.o") for src in PAIRS],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for th, tr in PAIRS.values():
        for tl in ("plain", "tails"):
            for suf in DTYPES:
                fn = getattr(out, f"omega_fb_step_{th[0]}{tr[0]}_{tl}_{suf}")
                fn.argtypes = [vp] * 4 + [ci, vp]
                fn.restype = ci
    out.omega_chain_slots.argtypes = [ci, ci]
    out.omega_chain_slots.restype = ci
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)


def _setup(mesh_np, pair, tails, dtype):
    """(mesh, cfg, wind plane, state): chip_smoke.py's noisy state; with
    FCT tracer 0 a 0/1 step in x, so that the limiter acts."""
    th, tr = PAIRS[pair]
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, flux_thickness_type=th,
                      flux_tracer_type=tr,
                      tendencies=TendencyConfig(
                          visc_del2=1e3, visc_del4=1e9,
                          **(WIND_DRAG if tails else {})))
    rng = np.random.default_rng(13)
    kx, ky = 2 * np.pi / mesh_np.x_period, 2 * np.pi / mesh_np.y_period
    x, y = np.asarray(mesh_np.x_cell), np.asarray(mesh_np.y_cell)
    h = (1000.0 + np.sin(kx * x) * np.sin(ky * y))[:, None] / K \
        * np.ones((1, K))
    trs = 10.0 + rng.standard_normal((L, mesh_np.ncells, K))
    if tr == "fct":
        trs[0] = (x > mesh_np.x_period / 2)[:, None]
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    st = ModelState(t(h), t(0.05 * rng.standard_normal((mesh_np.nedges, K))),
                    t(trs))
    plane = None
    if tails:
        plane = megastep.stack_wind(mesh, cfg, (
            t(0.1 * np.sin(ky * y)), t(0.05 * np.ones(mesh_np.ncells))),
            dtype)
    return mesh, cfg, plane, megastep.stack_state(mesh, st)


def _call(lib, mesh, cfg, s, out, plane, threads=None, rec=None, name=None):
    r, th, nm, _, _ = megastep.launch_record(mesh, cfg, DT, s, plane, "fb")
    return getattr(lib, name or nm)(
        s.data_ptr(), out.data_ptr(),
        None if plane is None else plane.data_ptr(),
        (r if rec is None else rec).ctypes.data,
        th if threads is None else threads, None)


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("tails", [False, True], ids=["plain", "tails"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_fb_step_against_plain(lib, mesh_np, pair, tails, suf):
    """One launch against fb_megastep_plain on the same state."""
    dtype = DTYPES[suf]
    mesh, cfg, plane, s = _setup(mesh_np, pair, tails, dtype)
    assert megastep.supported(mesh, cfg)
    ref = megastep.fb_megastep_plain(mesh, cfg, s, DT, wind=plane)
    out = torch.full_like(s, float("nan"))
    assert _call(lib, mesh, cfg, s, out, plane) == 0
    assert bool(torch.isfinite(out).all())
    chan = [((out[c] - ref[c]).abs().max()
             / ref[c].abs().max().clamp(min=1e-300)).item()
            for c in range(ref.shape[0])]
    if dtype == torch.float64:
        assert max(chan) <= F64_TOL, chan
        return
    for what in (slice(0, 1), slice(1, 4), slice(4, None)):
        assert (out[what] - ref[what]).abs().max() \
            <= 1e-4 * ref[what].abs().max()
    incr = [((out[c] - ref[c]).abs().max()
             / (ref[c] - s[c]).abs().max().clamp(min=1e-300)).item()
            for c in range(ref.shape[0])]
    assert max(incr) <= FB_INCR, incr


def test_tiled_plain_is_the_kernel_cut(mesh_np):
    """fb_megastep_plain tiled as the kernel cuts (HEX_TILE with the FB
    ring, (3, 3) for every variant) equals the whole grid, here and on a
    domain smaller than the tile (ragged: wrapped reads, masked writes)."""
    small = planar_hex_mesh(16, 8, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    for m_np in (mesh_np, small):
        for pair, tails in (("fb_step_uf", True), ("fb_step_cu", False)):
            mesh, cfg, plane, s = _setup(m_np, pair, tails, torch.float64)
            tabs, consts = megastep._mega_args(mesh, cfg, DT)
            assert megastep._ring(tabs, consts, plane) == (3, 3)
            whole = megastep.fb_megastep_plain(mesh, cfg, s, DT, wind=plane)
            assert torch.equal(megastep.fb_megastep_plain(
                mesh, cfg, s, DT, tile=megastep.HEX_TILE[:2], wind=plane),
                whole)


def test_records_are_the_compiled_plan(lib, mesh_np):
    """The host packs every FB record for the compiled tile, ring, block
    and slab count (hex_plan, megastep.SLOTS / FCT_SLOTS), as the library
    reports them."""
    for pair in PAIRS:
        for dtype in DTYPES.values():
            mesh, cfg, plane, s = _setup(mesh_np, pair, True, dtype)
            rec, threads, _, nslots, variant = megastep.launch_record(
                mesh, cfg, DT, s, plane, "fb")
            assert threads == megastep.HEX_TILE[2] == 256
            assert (rec["by"], rec["bx"], rec["ry"], rec["rx"]) \
                == megastep.HEX_TILE[:2] + (3, 3)
            assert nslots == lib.omega_chain_slots(*variant) \
                == (22 if PAIRS[pair][1] == "fct" else 16)


# case -> what it changes in a valid call of the center-flux float64 kernel
# without tails
REFUSED = {
    "threads_128": dict(threads=128),
    "threads_512": dict(threads=512),
    "wind_without_tails": dict(wind=True),
    "drag_without_tails": dict(cd=True),
    "out_is_in": dict(alias=True),
    "other_tile": dict(tile=(8, 32)),
    "other_ring": dict(ring=(4, 3)),
    "other_pattern": dict(pattern=True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_fb_step_refuses_bad_arguments(lib, mesh_np, case):
    """A call the step does not take returns an error code and writes
    nothing: a block of other than 256 threads, wind or drag handed to the
    instantiation without tails, `out` aliasing its input, a record packed
    for another tile, ring or entry pattern than the compiled ones."""
    mesh, cfg, _, s = _setup(mesh_np, "fb_step", False, torch.float64)
    bad = REFUSED[case]
    rec = megastep.launch_record(mesh, cfg, DT, s, None, "fb")[0].copy()
    if "tile" in bad or "ring" in bad:
        tabs, consts = megastep._mega_args(mesh, cfg, DT)
        ring = bad.get("ring", megastep._ring(tabs, consts, None))
        plan = megastep.plan_tile(NY, NX, 8, ring, bad.get("tile", (16, 32)),
                                  megastep.SLOTS)
        rec = megastep.pack_params(tabs, consts, np.float64, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, NY, NX
    if bad.get("pattern"):
        rec["off"][1, 3] += 1
    if bad.get("cd"):
        rec["cd"] = 3e-3
    wind = torch.zeros((3, NY, NX), dtype=torch.float64) \
        if bad.get("wind") else None
    src = s.clone()
    out = src if bad.get("alias") else torch.zeros_like(s)
    code = lib.omega_fb_step_cc_plain_f64(
        src.data_ptr(), out.data_ptr(),
        None if wind is None else wind.data_ptr(), rec.ctypes.data,
        bad.get("threads", 256), None)
    assert code != 0
    assert torch.equal(src, s)
    assert bad.get("alias") or (out == 0).all()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_supported_needs_the_compiled_entry_pattern(mesh_np, monkeypatch,
                                                    pair):
    """Every FB variant fuses only where the tables pack into the compiled
    pattern (megastep.HEX_PATTERN); a mesh whose tables hold the same
    counts in another order runs the composed step."""
    mesh, cfg, _, _ = _setup(mesh_np, pair, True, torch.float64)
    assert megastep.supported(mesh, cfg)
    real = structured.cached_table

    def swapped(m, name):
        tab = real(m, name)
        if name != "tang":
            return tab
        # two entries of class 0: the same counts, another order
        return (tab[3],) + tab[1:3] + (tab[0],) + tab[4:]
    monkeypatch.setattr(structured, "cached_table", swapped)
    assert megastep.tables_fit(mesh) and not megastep.hex_pattern_fits(mesh)
    assert not megastep.supported(mesh, cfg)
    assert not megastep.supported(mesh, dataclasses.replace(
        cfg, tendencies=dataclasses.replace(cfg.tendencies,
                                            wind_forcing=False)))
