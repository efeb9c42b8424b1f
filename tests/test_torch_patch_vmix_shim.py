"""The sphere's column solve (csrc/patch_vmix.cu: elimination in chunks,
csrc/column_solve.cuh) compiled for the CPU by g++ against the block-level
stand-in for the CUDA runtime of tests/test_torch_rk_shim.py (a block's
threads as fibers meeting at `__syncthreads()`, its dynamic shared
array one NaN-filled buffer; cp.async a plain copy), and run on CPU
tensors against its plain version (ops/patch_megastep.vmix_solve_plain,
the reference's PCR) on the frames of icosahedral subdivision 8 with 2
tracers: constant, PP81 and 1 m2/s coefficients, K in {2, 3, 7, 33, 100}
(one k-lane of 2, 3 and 7 rows; two lanes of 16 and 17; four of 25),
float64 and float32; a column with a zero thickness, left as it was; the
plan for more tracers than one pass of two; then the arguments the
launcher refuses. No JAX here: tests/test_torch_sphere_science.py holds the
plain version against the JAX package.

Limits: float64 rtol = atol = 1e-10 against plain; float32 (chip_smoke.py's
`kernel_patch_science`) per channel max|diff| <= SCI_SOLVE max|ref| at the
science coefficients, and the error of the solve's increment <=
SCI_SOLVE_STRONG of the largest increment at 1 m2/s; h_new untouched.
Layers are 10 m thick at every K, so that the increments stand clear of
float32 roundoff."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_rk_shim import BLOCK_RUNTIME, _block_source
from test_torch_sphere_split_shim import CSRC

from omega_tpu_torch.core import (ModelConfig, ModelState, TendencyConfig,
                                  VertMixConfig)
from omega_tpu_torch.mesh import patch_icos_mesh, spherical_icos_mesh
from omega_tpu_torch.ops import patch_megastep as pm
from omega_tpu_torch.ops import vmix_kernel

N, L, DT = 8, 2, 30.0
KS = (2, 3, 7, 33, 100)
DTYPES = {"f64": torch.float64, "f32": torch.float32}
SCI_SOLVE, SCI_SOLVE_STRONG = 1.1e-6, 5.3e-3
# coefficient case -> (vertical mixing, float32 increment limit or None)
COEFFS = {
    "constant": (VertMixConfig(enabled=True, kappa_tracer=1.0e-3,
                               kappa_momentum=1.0e-2), None),
    "pp81": (VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                           salt_index=1), None),
    "strong_constant": (VertMixConfig(enabled=True, kappa_tracer=1.0,
                                      kappa_momentum=1.0), SCI_SOLVE_STRONG),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """patch_vmix.cu built by g++ into one library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    d = tmp_path_factory.mktemp("patch_vmix_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(BLOCK_RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    so = d / "libpatch_vmix_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "patch_vmix.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for suf in DTYPES:
        fn = getattr(out, f"omega_patch_vmix_solve_{suf}")
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh_np():
    return patch_icos_mesh(spherical_icos_mesh(N), N)


@pytest.fixture(scope="module")
def preps(mesh_np):
    return {suf: pm.prep(mesh_np.to("cpu", dt), dt, "cpu")
            for suf, dt in DTYPES.items()}


def _setup(mesh_np, K, name, dtype, ntr=L):
    """(cfg, frames): 10 m layers, T decreasing downward, S near 35, u
    noise, so the Richardson number spans stable and unstable interfaces."""
    mesh = mesh_np.to("cpu", dtype)
    cfg = ModelConfig(nvertlayers=K, ntracers=ntr, vert_mix=COEFFS[name][0],
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    rng = np.random.default_rng(7 + K)
    C, E = mesh_np.ncells, mesh_np.nedges
    lat, lon = np.asarray(mesh_np.lat_cell), np.asarray(mesh_np.lon_cell)
    h = 10.0 * (1.0 + 0.01 * np.sin(2 * lat) * np.cos(lon))[:, None] \
        * np.ones((1, K))
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((C, K))
    S = 35.0 + 0.1 * rng.standard_normal((C, K))
    extra = [10.0 + rng.standard_normal((C, K)) for _ in range(ntr - 2)]
    u = 0.1 * rng.standard_normal((E, K)) \
        * np.asarray(mesh_np.edge_mask)[:, None]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    st = ModelState(t(h), t(u), t(np.stack([T, S] + extra)))
    return cfg, pm.stack_frames(mesh, cfg, st)[0]


def _solve(lib, p, cfg, fr, coef, ints=None):
    consts, ints0 = pm._vmix_args(p, cfg, fr, DT)
    ints = ints0 if ints is None else ints
    suf = "f64" if fr.dtype == torch.float64 else "f32"
    return getattr(lib, f"omega_patch_vmix_solve_{suf}")(
        fr.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
        None if coef is None else coef.data_ptr(), consts.ctypes.data,
        ints.ctypes.data, None)


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("name", list(COEFFS))
@pytest.mark.parametrize("K", KS)
def test_solve_against_plain(lib, mesh_np, preps, K, name, suf):
    """One launch against vmix_solve_plain (the plain PCR) on the same
    frames and coefficients; the lattice holes of the frames stay as they
    were in both."""
    dtype, p = DTYPES[suf], preps[suf]
    cfg, fr = _setup(mesh_np, K, name, dtype)
    coef = pm.vmix_coeffs_plain(p, cfg, fr) \
        if cfg.vert_mix.scheme == "pp81" else None
    ref = pm.vmix_solve_plain(p, cfg, fr, DT, coef)
    got = fr.clone()
    assert _solve(lib, p, cfg, got, coef) == 0
    assert torch.equal(got[:, 0], fr[:, 0])          # h_new is only read
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)
        return
    limit = COEFFS[name][1]
    for c in range(1, 4 + L):
        moved = (ref[:, c] - fr[:, c]).abs().max().item()
        off = (got[:, c] - ref[:, c]).abs().max().item()
        assert moved > 0, c
        if limit is None:
            assert off <= SCI_SOLVE * ref[:, c].abs().max().item(), (c, off)
        else:
            assert off <= limit * moved, (c, moved, off)


@pytest.mark.parametrize("suf", list(DTYPES))
def test_solve_leaves_a_column_with_zero_thickness(lib, mesh_np, preps,
                                                   suf):
    """A live cell whose thickness is 0 at one layer keeps its tracers in
    every layer (the plain version's hole guard), and its neighbours move;
    the plain version agrees everywhere."""
    dtype, p = DTYPES[suf], preps[suf]
    cfg, fr = _setup(mesh_np, 33, "strong_constant", dtype)
    live = torch.nonzero(fr[0, 0] > 0).flatten()
    q = int(live[len(live) // 2])
    fr[7, 0, q] = 0.0
    ref = pm.vmix_solve_plain(p, cfg, fr, DT)
    got = fr.clone()
    assert _solve(lib, p, cfg, got, None) == 0
    assert torch.equal(got[:, 4:, q], fr[:, 4:, q])
    assert bool((got[:, 4:, q + 1] != fr[:, 4:, q + 1]).any())
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


def test_solve_takes_every_tracer_in_one_pass_where_it_fits(lib, mesh_np,
                                                            preps):
    """Five tracers run through the wider kernel (FRAME_RHS) in one pass;
    ten take two passes of it; both against plain in float64."""
    p = preps["f64"]
    for ntr, lc in ((5, 5), (10, vmix_kernel.FRAME_RHS)):
        cfg, fr = _setup(mesh_np, 33, "constant", torch.float64, ntr)
        plan = vmix_kernel.plan_frames(33, ntr, 8)
        assert (plan["lc"], plan["rhs"]) == (lc, vmix_kernel.FRAME_RHS)
        got = fr.clone()
        assert _solve(lib, p, cfg, got, None) == 0
        torch.testing.assert_close(got, pm.vmix_solve_plain(p, cfg, fr, DT),
                                   rtol=1e-10, atol=1e-10)


# case -> the ints index and value that a valid call at K = 33 changes
# (ints: P, K, L, ti, si, n_exp, kg, threads, cw, lanes, lc, rhs)
REFUSED = {
    "too_few_lanes": (9, 1),            # 1 x 25 rows < 33
    "lanes_over_half_the_rows": (9, 17),
    "block_over_256": (8, 32, 9, 16),
    "columns_over_a_warp": (8, 64),
    "more_values_than_the_width": (10, 3),
    "width_not_compiled": (11, 4),
    "one_layer": (1, 1),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_solve_refuses_bad_arguments(lib, mesh_np, preps, case):
    """A call the launcher does not take returns an error code and changes
    nothing: fewer lanes than hold the column, a lane of fewer than two
    rows, more than 256 threads, more than 32 positions a block, more
    values per pass than the compiled width, a width not compiled, a
    single layer."""
    p = preps["f64"]
    cfg, fr = _setup(mesh_np, 33, "constant", torch.float64)
    ints = pm._vmix_args(p, cfg, fr, DT)[1].copy()
    bad = REFUSED[case]
    for i in range(0, len(bad), 2):
        ints[bad[i]] = bad[i + 1]
    got = fr.clone()
    assert _solve(lib, p, cfg, got, None, ints) != 0
    assert torch.equal(got, fr)
