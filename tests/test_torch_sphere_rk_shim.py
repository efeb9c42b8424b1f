"""The sphere's RK stage kernel (csrc/patch_rk.cuh through patch_rk_cc.cu and
patch_rk_uu.cu: the passes A, B, C, D1 and D2) compiled for the CPU by g++
against the stand-in for the CUDA runtime of
tests/test_torch_sphere_split_shim.py, and run on CPU tensors against its
plain version (ops/patch_megastep.rk_stage_plain): icosahedral subdivision 8,
10 layers (each pass's group of layers per thread, kRkPassLayers, ends
part-filled or is the whole column), 2 tracers, every stage mode (RK_PROV,
RK_FIRST, RK_MID, RK_LAST), center and upwind fluxes, with and without the
wind / drag tails, float64 and float32; and the arguments a call refuses.

Limits (the card's, chip_smoke.py's `kernel_patch_rk`): float64 per channel
max|diff| <= 1e-12 max|ref| of `out` and of the accumulator; float32 per
channel the error of the increment (what the stage changed against the
level it starts from) <= PATCH_INCR = 5e-4 of the largest increment. What
the card alone can show (the build by nvcc, the launch, the times) is
chip_smoke.py's `kernel_patch_rk`."""

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
FLUX = {"cc": {}, "uu": dict(flux_thickness_type="upwind",
                             flux_tracer_type="upwind")}
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)
# mode name -> (mode, a, b, the level is the base)
MODES = {"prov": (pm.RK_PROV, 0.5, 0.0, True),
         "first": (pm.RK_FIRST, 0.5, 1.0 / 6.0, True),
         "mid": (pm.RK_MID, 0.5, 1.0 / 3.0, False),
         "last": (pm.RK_LAST, 0.0, 1.0 / 6.0, False)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """patch_rk_cc.cu and patch_rk_uu.cu built by g++ (side by side) into
    one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("rk_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(LAUNCH.sub(_launch_loop, f.read_text()))
    procs = [subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-c", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / f"patch_rk_{fl}.cu"),
         "-o", str(d / f"{fl}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for fl in FLUX]
    for p in procs:
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
    so = d / "librk_shim.so"
    r = subprocess.run([gxx, "-shared", "-o", str(so)]
                       + [str(d / f"{fl}.o") for fl in FLUX],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for fl in FLUX:
        for tl in ("plain", "tails"):
            for suf in DTYPES:
                fn = getattr(out, f"omega_patch_rk_{fl}_{tl}_{suf}")
                fn.argtypes = [ctypes.c_void_p] * 12
                fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return patch_icos_mesh(spherical_icos_mesh(N), N)


def _setup(mesh_np, fl, tails, dtype):
    """(prep, cfg, wind bundle, level, base, accumulator) frames: the
    sphere state of tests/test_torch_sphere_rk.py, a perturbed level and an
    accumulator like the one RK4's first stage makes."""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, **FLUX[fl],
                      tendencies=TendencyConfig(
                          visc_del2=1e3, visc_del4=1e9, eddy_diff4=1e9,
                          **(WIND_DRAG if tails else {})))
    rng = np.random.default_rng(29)
    lat, lon = np.asarray(mesh_np.lat_cell), np.asarray(mesh_np.lon_cell)
    em = np.asarray(mesh_np.edge_mask)[:, None]
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * (1.0 + 1e-3 * rng.standard_normal((mesh_np.ncells, K)))
    u = 0.1 * rng.standard_normal((mesh_np.nedges, K)) * em
    tr = 10.0 + rng.standard_normal((L, mesh_np.ncells, K))
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    base = ModelState(t(h), t(u), t(tr))
    ev = ModelState(t(h * (1.0 + 1e-3 * rng.standard_normal(h.shape))),
                    t(u + 0.01 * rng.standard_normal(u.shape) * em),
                    t(tr + 0.1))
    acc = ModelState(t(0.9 * h), t(0.5 * u), t(1.1 * tr * h[None]))
    p = pm.prep(mesh, dtype, "cpu")
    wind = None
    if tails:
        wind = pm.make_wind(mesh, cfg, (t(0.1 * np.cos(lat)),
                                        t(0.05 * np.sin(lat))), dtype)
    fr = lambda st: pm.stack_frames(mesh, cfg, st)[0]
    return p, cfg, wind, fr(ev), fr(base), fr(acc)


def _increment_errors(got, ref, start):
    """per channel max|got - ref| / max|ref - start|"""
    return [((got[:, c] - ref[:, c]).abs().max()
             / (ref[:, c] - start[:, c]).abs().max().clamp(min=1e-300)).item()
            for c in range(ref.shape[1])]


def _chan(got, ref):
    return max(((got[:, c] - ref[:, c]).abs().max()
                / ref[:, c].abs().max().clamp(min=1e-300)).item()
               for c in range(ref.shape[1]))


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("tails", [False, True], ids=["plain", "tails"])
@pytest.mark.parametrize("fl", list(FLUX))
def test_rk_stage_against_plain(lib, mesh_np, fl, tails, mode, suf):
    """One stage's five passes against rk_stage_plain: `out` and, for
    RK_FIRST / RK_MID, the accumulator."""
    dtype = DTYPES[suf]
    p, cfg, wind, ev, base, acc = _setup(mesh_np, fl, tails, dtype)
    md, a, b, on_base = MODES[mode]
    level = base if on_base else ev
    ca, cb = a * DT, b * DT
    _, cpl, consts, ints = pm._fb_args(p, cfg, level, ca, wind, fl[1])
    consts = np.append(consts, cb)
    ints = np.append(ints, md).astype(np.int32)
    out = torch.full_like(level, float("nan"))
    acc_out = torch.full_like(level, float("nan"))
    work = level.new_zeros(pm.rk_work_fields(L) * K * p.P)
    ptr = lambda x, ok: x.data_ptr() if ok else None
    code = getattr(lib, f"omega_patch_rk_{fl}_"
                        f"{'tails' if tails else 'plain'}_{suf}")(
        level.data_ptr(), ptr(base, md != pm.RK_LAST),
        ptr(acc, md in (pm.RK_MID, pm.RK_LAST)),
        ptr(acc_out, md in (pm.RK_FIRST, pm.RK_MID)), out.data_ptr(),
        p.offs.data_ptr(), p.wts.data_ptr(), cpl.data_ptr(), work.data_ptr(),
        consts.ctypes.data, ints.ctypes.data, None)
    assert code == 0
    ref_acc, ref = pm.rk_stage_plain(p, cfg, md, ca, cb, level, base, acc,
                                     wind)
    start = base
    if md == pm.RK_LAST:   # the accumulator's h, u and tracers tr h / h
        start = acc.clone()
        h = acc[:, :1]
        start[:, 4:] = torch.where(h != 0, acc[:, 4:] / torch.where(
            h != 0, h, torch.ones_like(h)), torch.zeros_like(acc[:, 4:]))
    pairs = [(out, ref, start)]
    if ref_acc is not None:
        trh = base.clone()
        trh[:, 4:] *= base[:, :1]
        pairs.append((acc_out, ref_acc, trh if md == pm.RK_FIRST else acc))
    for got, want, start in pairs:
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float64:
            assert _chan(got, want) <= F64_TOL
        else:
            assert max(_increment_errors(got, want, start)) <= PATCH_INCR


# case -> what it changes in a valid RK_MID call of the plain center-flux
# float64 kernel: ints entries, or pointers set to null / aliased
REFUSED = {
    "mode_below": dict(ints={-1: -1}),
    "mode_above": dict(ints={-1: pm.RK_LAST + 1}),
    "threads_300": dict(ints={5: 300}),
    "threads_48": dict(ints={5: 48}),
    "wind_without_tails": dict(ints={-3: 1}),
    "no_acc": dict(null=("acc",)),
    "no_acc_out": dict(null=("acc_out",)),
    "out_is_level": dict(alias="ev"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_rk_stage_refuses_bad_arguments(lib, mesh_np, case):
    """A call the stage does not take returns an error code and launches
    nothing: a mode out of range, a block of more than 256 threads or not a
    multiple of 32, the wind tail asked of the instantiation without tails,
    a missing accumulator the mode reads or writes, `out` aliasing the
    level it reads at neighbours."""
    p, cfg, wind, ev, base, acc = _setup(mesh_np, "cc", False, torch.float64)
    _, cpl, consts, ints = pm._fb_args(p, cfg, ev, 0.5 * DT, None, "c")
    consts = np.append(consts, DT / 3.0)
    ints = np.append(ints, pm.RK_MID).astype(np.int32)
    bad = REFUSED[case]
    for i, v in bad.get("ints", {}).items():
        ints[i] = v
    args = dict(ev=ev, base=base, acc=acc, acc_out=torch.zeros_like(ev),
                out=torch.zeros_like(ev))
    for name in bad.get("null", ()):
        args[name] = None
    if "alias" in bad:
        args["out"] = args[bad["alias"]]
    before = {n: None if t is None else t.clone() for n, t in args.items()}
    work = ev.new_zeros(pm.rk_work_fields(L) * K * p.P)
    ptr = lambda t: None if t is None else t.data_ptr()
    assert lib.omega_patch_rk_cc_plain_f64(
        ptr(args["ev"]), ptr(args["base"]), ptr(args["acc"]),
        ptr(args["acc_out"]), ptr(args["out"]), p.offs.data_ptr(),
        p.wts.data_ptr(), cpl.data_ptr(), work.data_ptr(),
        consts.ctypes.data, ints.ctypes.data, None) != 0
    for n, t in args.items():
        if t is not None:
            assert torch.equal(t, before[n]), n
    assert (work == 0).all()
