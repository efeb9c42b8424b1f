"""The planar column kernels (csrc/vmix.cu: the chunked column solve and the
PP81 coefficient pass) compiled for the CPU by g++ against the block-level
stand-in for the CUDA runtime of tests/test_torch_rk_shim.py (a block's
threads as fibers meeting at `__syncthreads()`, its dynamic shared
array one NaN-filled buffer), and run on CPU tensors against the kernels'
plain versions (ops/vmix_kernel.vmix_solve_plain, the reference's PCR, and
pp81_coeffs_plain) on a 16 x 8 planar hex mesh with 2 tracers: constant
and PP81 coefficients, K in {2, 3, 7, 33, 100} (one k-lane of 2, 3 and 7
rows; two lanes of 16 and 17; four of 25), float64 and float32; then the
arguments the launcher refuses. The coefficient pass also on a 64 x 32
mesh (tiles that meet and wrap) with groups of several interfaces,
stratified and not, and the meshes and records it refuses: off the
compiled hex pattern, another tile or ring, an odd row count, no group.
No JAX here: tests/test_torch_vmix.py holds the plain versions against the
JAX package.

Limits (chip_smoke.py's `kernel_vmix`): float64 rtol = atol = 1e-10 against
plain; float32 max|diff| <= 1e-4 max|ref| per output, per channel the error
of the solve's increment <= 0.05 of the largest increment at the science
coefficients and 1e-3 at 1 m2/s, column content sum_k h tr to 1e-5, h
untouched. Layers are 10 m thick at every K, as on the main path (100 x
10 m), so that the increments stand clear of float32 roundoff."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_rk_shim import BLOCK_RUNTIME, _block_source
from test_torch_sphere_split_shim import CSRC

from omega_tpu_torch.core import (ModelConfig, ModelState, TendencyConfig,
                                  VertMixConfig)
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import megastep, structured, vmix_kernel

NX, NY, L, DT = 16, 8, 2, 30.0
KS = (2, 3, 7, 33, 100)
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# coefficient case -> (vertical mixing, float32 increment limit)
COEFFS = {
    "constant": (VertMixConfig(enabled=True, kappa_tracer=1.0e-3,
                               kappa_momentum=1.0e-2), 0.05),
    "pp81": (VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                           salt_index=1), 0.05),
    "strong_constant": (VertMixConfig(enabled=True, kappa_tracer=1.0,
                                      kappa_momentum=1.0), 1e-3),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """vmix.cu built by g++ into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("vmix_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(BLOCK_RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    so = d / "libvmix_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "vmix.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    for suf in DTYPES:
        for name in ("vmix_solve", "pp81_coeffs"):
            fn = getattr(out, f"omega_{name}_{suf}")
            fn.argtypes = [vp] * 5     # state, kappa, nu, params, stream
            fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return planar_hex_mesh(NX, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)


def _setup(mesh_np, K, name, dtype, seed=5):
    """(mesh, cfg, stacked state): 10 m layers, T decreasing downward, S
    near 35, u noise, so the Richardson number spans stable and unstable
    interfaces."""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=L, vert_mix=COEFFS[name][0],
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    rng = np.random.default_rng(seed + K)
    C, E = mesh_np.ncells, mesh_np.nedges
    kx = 2 * np.pi / mesh_np.x_period
    h = 10.0 + 0.01 * np.sin(kx * np.asarray(mesh_np.x_cell))[:, None] \
        * np.ones((1, K))
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((C, K))
    S = 35.0 + 0.1 * rng.standard_normal((C, K))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    st = ModelState(t(h), t(0.1 * rng.standard_normal((E, K))),
                    t(np.stack([T, S])))
    return mesh, cfg, megastep.stack_state(mesh, st)


def _rec(mesh, cfg, s):
    ft = np.float64 if s.dtype == torch.float64 else np.float32
    return vmix_kernel.pack_params(mesh, cfg, DT, ft, L, s.shape[1])


def _solve(lib, rec, s, coeffs):
    kap, nu = coeffs if coeffs is not None else (None, None)
    ptr = lambda a: None if a is None else a.data_ptr()
    suf = "f64" if s.dtype == torch.float64 else "f32"
    return getattr(lib, f"omega_vmix_solve_{suf}")(
        s.data_ptr(), ptr(kap), ptr(nu), rec.ctypes.data, None)


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("name", list(COEFFS))
@pytest.mark.parametrize("K", KS)
def test_solve_against_plain(lib, mesh_np, K, name, suf):
    """One launch against vmix_solve_plain (the plain PCR) on the same
    state and coefficients."""
    dtype = DTYPES[suf]
    mesh, cfg, s = _setup(mesh_np, K, name, dtype)
    coeffs = vmix_kernel.pp81_coeffs_plain(mesh, cfg, s) \
        if cfg.vert_mix.scheme == "pp81" else None
    ref = vmix_kernel.vmix_solve_plain(mesh, cfg, s, DT, coeffs)
    got = s.clone()
    assert _solve(lib, _rec(mesh, cfg, s), got, coeffs) == 0
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[0], s[0])                 # h is only read
    if dtype == torch.float64:
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)
        return
    limit = COEFFS[name][1]
    for what in (slice(1, 4), slice(4, None)):
        off = (got[what] - ref[what]).abs().max().item()
        assert off <= 1e-4 * ref[what].abs().max().item()
    for c in range(1, 4 + L):
        moved = (ref[c] - s[c]).abs().max().item()
        off = ((got[c] - s[c]) - (ref[c] - s[c])).abs().max().item()
        assert moved > 0 and off <= limit * moved, (c, moved, off)
    content = lambda a: (a[0].double()[None] * a[4:].double()).sum(1)
    c0, c1 = content(s), content(got)
    assert ((c1 - c0).abs() / c0.abs()).max().item() <= 1e-5


# case -> (K, mesh (nx, ny), groups of interfaces or None for the plan's,
# vertical mixing)
UNSTRATIFIED = VertMixConfig(enabled=True, scheme="pp81", n_exp=3)
COEFF_CASES = {
    "2": (2, (NX, NY), None, None),
    "33": (33, (NX, NY), None, None),
    "64x32-7-g3": (7, (64, 32), 3, None),
    "64x32-100-g4": (100, (64, 32), 4, None),
    "64x32-33-g5-unstratified": (33, (64, 32), 5, UNSTRATIFIED),
}


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("case", list(COEFF_CASES))
def test_pp81_coeffs_against_plain(lib, mesh_np, case, suf):
    """The coefficient pass (a tile walking its group of interfaces, each
    layer staged once, a barrier between the slab's dz, N^2, du and its
    points) against pp81_coeffs_plain."""
    dtype = DTYPES[suf]
    K, shape, groups, vm = COEFF_CASES[case]
    m = mesh_np if shape == (NX, NY) else planar_hex_mesh(
        *shape, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    mesh, cfg, s = _setup(m, K, "pp81", dtype)
    if vm is not None:
        cfg = dataclasses.replace(cfg, vert_mix=vm)
    kp, npl = vmix_kernel.pp81_coeffs_plain(mesh, cfg, s)
    kap = torch.full_like(kp, float("nan"))
    nu = torch.full_like(npl, float("nan"))
    rec = _rec(mesh, cfg, s)
    if groups is not None:
        rec["groups"] = groups
    assert getattr(lib, f"omega_pp81_coeffs_{suf}")(
        s.data_ptr(), kap.data_ptr(), nu.data_ptr(), rec.ctypes.data,
        None) == 0
    for got, ref in ((kap, kp), (nu, npl)):
        if dtype == torch.float64:
            torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)
        else:
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_plan_coeffs_fills_the_card_with_whole_groups():
    """At 256 x 256 (128 tiles) the plan takes 6 groups of 17 interfaces
    (768 blocks); no plan leaves a group empty, and a small mesh takes a
    group per interface."""
    assert vmix_kernel.plan_coeffs(256, 256, 100) == dict(
        by=16, bx=32, ry=1, rx=1, groups=6)
    for ny, nx in ((8, 16), (32, 64), (256, 256), (512, 512)):
        for K in (2, 3, 7, 10, 33, 100, 800):
            g = vmix_kernel.plan_coeffs(ny, nx, K)["groups"]
            per = -(-(K - 1) // g)
            assert 1 <= g <= K - 1 and (g - 1) * per < K - 1
    assert vmix_kernel.plan_coeffs(NY, NX, 33)["groups"] == 32


# case -> what it changes in the record of a valid call at K = 7
COEFF_REFUSED = {
    "other_tile": dict(by=8),
    "other_ring": dict(ry=2),
    "odd_rows": dict(ny=NY - 1),
    "no_group": dict(groups=0),
    "one_layer": dict(K=1),
    "other_entry_pattern": dict(swap=True),
}


@pytest.mark.parametrize("case", list(COEFF_REFUSED))
def test_pp81_coeffs_refuse_bad_arguments(lib, mesh_np, case):
    """A record the coefficient launcher does not take returns an error
    code and writes nothing: another tile or ring than the compiled ones,
    an odd number of rows, no group of interfaces, a single layer, ke
    entries in another order than the compiled pattern."""
    mesh, cfg, s = _setup(mesh_np, 7, "pp81", torch.float64)
    rec = _rec(mesh, cfg, s).copy()
    bad = COEFF_REFUSED[case]
    for k, v in bad.items():
        if k != "swap":
            rec[k] = v
    if bad.get("swap"):
        rec["e"][[0, 3]] = rec["e"][[3, 0]]
    kap = torch.zeros((6, NY, NX), dtype=torch.float64)
    nu = torch.zeros((3, 6, NY, NX), dtype=torch.float64)
    assert lib.omega_pp81_coeffs_f64(s.data_ptr(), kap.data_ptr(),
                                     nu.data_ptr(), rec.ctypes.data,
                                     None) != 0
    assert not kap.any() and not nu.any()


def test_pp81_coeffs_refuse_a_mesh_off_the_hex_pattern(lib, mesh_np,
                                                      monkeypatch):
    """The host raises, before it builds or launches anything, for a CUDA
    array on a mesh whose tables do not pack into the compiled pattern:
    a 4-column mesh, and the 16 x 8 mesh with two ke entries swapped,
    whose record the launcher refuses too."""
    m4 = planar_hex_mesh(4, NY, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    mesh4, cfg, s4 = _setup(m4, 7, "pp81", torch.float64)
    mesh, _, s = _setup(mesh_np, 7, "pp81", torch.float64)
    assert megastep.hex_pattern_fits(mesh)
    real = structured.cached_table

    def swapped(m, name):
        tab = real(m, name)
        if name != "ke" or m is not mesh:
            return tab
        return (tab[3],) + tab[1:3] + (tab[0],) + tab[4:]
    monkeypatch.setattr(structured, "cached_table", swapped)
    assert not megastep.hex_pattern_fits(mesh4)
    assert not megastep.hex_pattern_fits(mesh)
    kap = torch.zeros((6, NY, NX), dtype=torch.float64)
    nu = torch.zeros((3, 6, NY, NX), dtype=torch.float64)
    assert lib.omega_pp81_coeffs_f64(s.data_ptr(), kap.data_ptr(),
                                     nu.data_ptr(),
                                     _rec(mesh, cfg, s).ctypes.data,
                                     None) != 0
    assert not kap.any() and not nu.any()
    loaded = []
    monkeypatch.setattr(vmix_kernel._build, "load",
                        lambda: loaded.append(1))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for m, st in ((mesh4, s4), (mesh, s)):
        with pytest.raises(ValueError, match="entry pattern"):
            vmix_kernel.pp81_coeffs(m, cfg, st)
    assert not loaded


# case -> what it changes in a valid constant-coefficient call at K = 33
REFUSED = {
    "too_few_lanes": dict(lanes=1),        # 1 x 25 rows < 33
    "lanes_over_half_the_rows": dict(K=5, lanes=3),
    "block_over_256": dict(cw=64, lanes=8),
    "kappa_without_nu": dict(kappa_only=True),
    "one_layer": dict(K=1),
    "three_cell_edge_mean": dict(cm3=True),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_solve_refuses_bad_arguments(lib, mesh_np, case):
    """A call the launcher does not take returns an error code and changes
    nothing: fewer lanes than hold the column, a lane of fewer than two
    rows, more than 256 threads, one coefficient array without the other,
    a single layer, an edge thickness that is not a two-cell mean."""
    mesh, cfg, s = _setup(mesh_np, 33, "constant", torch.float64)
    bad = REFUSED[case]
    rec = _rec(mesh, cfg, s).copy()
    for k in ("lanes", "cw", "K"):
        if k in bad:
            rec[k] = bad[k]
    if bad.get("cm3"):
        rec["cm_start"][1] += 1
    kap = torch.zeros((32, NY, NX), dtype=torch.float64)
    got = s.clone()
    code = lib.omega_vmix_solve_f64(
        got.data_ptr(), kap.data_ptr() if bad.get("kappa_only") else None,
        None, rec.ctypes.data, None)
    assert code != 0
    assert torch.equal(got, s)
