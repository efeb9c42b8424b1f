"""The sphere's column kernels (csrc/patch_vmix.cu: the column solve by
elimination in chunks, csrc/column_solve.cuh, and the PP81 coefficient
kernel) compiled for the CPU by g++ against the block-level
stand-in for the CUDA runtime of tests/test_torch_rk_shim.py (a block's
threads as fibers meeting at `__syncthreads()`, its dynamic shared
array one NaN-filled buffer; cp.async a plain copy), and run on CPU
tensors against its plain version (ops/patch_megastep.vmix_solve_plain,
the reference's PCR) on the frames of icosahedral subdivision 8 with 2
tracers: constant, PP81 and 1 m2/s coefficients, K in {2, 3, 7, 33, 100}
(one k-lane of 2, 3 and 7 rows; two lanes of 16 and 17; four of 25),
float64 and float32; a column with a zero thickness, left as it was; the
plan for more tracers than one pass of two; then the arguments the
launcher refuses. The coefficient kernel against its plain version
(ops/patch_megastep.vmix_coeffs_plain) at the same K (its groups of
interfaces end inside the column and at its end), stratified and
unstratified, float64 and float32; a column with a zero thickness; the
arguments its launcher refuses. No JAX here:
tests/test_torch_sphere_science.py holds the plain versions against the
JAX package.

Limits: float64 rtol = atol = 1e-10 against plain; float32 (chip_smoke.py's
`kernel_patch_science`) per channel max|diff| <= SCI_SOLVE max|ref| at the
science coefficients, and the error of the solve's increment <=
SCI_SOLVE_STRONG of the largest increment at 1 m2/s; h_new untouched.
Layers are 10 m thick at every K, so that the increments stand clear of
float32 roundoff. Coefficients (layer K-1 is not written): float64 per
channel max|diff| <= 1e-12 max|ref| over the finite values, NaN where the
plain version has NaN (lattice holes); float32 max|diff| <= 1e-4 max|ref|
(chip_smoke.py's `kernel_patch_science` holds icos48 to SCI_COEF)."""

import copy
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
        for name in ("vmix_solve", "pp81"):
            fn = getattr(out, f"omega_patch_{name}_{suf}")
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


# the coefficient kernel's cases: PP81 on T and S, and unstratified (no T or
# S row: N^2 = 0)
PP81_CASES = {
    "pp81": VertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                          salt_index=1),
    "unstratified": VertMixConfig(enabled=True, scheme="pp81", n_exp=3)}


def _coeffs(lib, p, cfg, fr, ints=None):
    """(code, coef) of one launch into a NaN-filled (K, 4, P) array."""
    consts, ints0 = pm._vmix_args(p, cfg, fr, 0.0)
    ints = ints0 if ints is None else ints
    K, _, P = fr.shape
    coef = torch.full((K, 4, P), float("nan"), dtype=fr.dtype)
    suf = "f64" if fr.dtype == torch.float64 else "f32"
    code = getattr(lib, f"omega_patch_pp81_{suf}")(
        fr.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(), coef.data_ptr(),
        consts.ctypes.data, ints.ctypes.data, None)
    return code, coef


def _coeff_errs(got, ref):
    """per channel max|diff| / max|ref| over the interfaces' finite values
    of ref; inf where the two have NaN in other places"""
    out = []
    for c in range(4):
        a, b = got[:-1, c], ref[:-1, c]
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            out.append(float("inf"))
            continue
        fin = torch.isfinite(b)
        out.append(((a - b).abs()[fin].max()
                    / b.abs()[fin].max()).item())
    return out


def _state(mesh_np, K, dtype):
    """_setup's state with u noise on top of a shear, so that the
    Richardson number spans stable and unstable interfaces."""
    rng = np.random.default_rng(11 + K)
    C, E = mesh_np.ncells, mesh_np.nedges
    lat, lon = np.asarray(mesh_np.lat_cell), np.asarray(mesh_np.lon_cell)
    h = 10.0 * (1.0 + 0.01 * np.sin(2 * lat) * np.cos(lon))[:, None] \
        * np.ones((1, K))
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((C, K))
    S = 35.0 + 0.1 * rng.standard_normal((C, K))
    u = (0.05 * np.linspace(1.0, 0.0, K)[None]
         + 0.01 * rng.standard_normal((E, K))) \
        * np.asarray(mesh_np.edge_mask)[:, None]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    return ModelState(t(h), t(u), t(np.stack([T, S])))


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("name", list(PP81_CASES))
@pytest.mark.parametrize("K", KS)
def test_coeffs_against_plain(lib, mesh_np, preps, K, name, suf):
    """One launch against vmix_coeffs_plain on the same frames: every
    interface of groups that end inside the column and at its end."""
    dtype, p = DTYPES[suf], preps[suf]
    cfg = ModelConfig(nvertlayers=K, ntracers=L, vert_mix=PP81_CASES[name],
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    fr = pm.stack_frames(mesh_np.to("cpu", dtype), cfg,
                         _state(mesh_np, K, dtype))[0]
    ref = pm.vmix_coeffs_plain(p, cfg, fr)
    code, got = _coeffs(lib, p, cfg, fr)
    assert code == 0
    assert bool(torch.isnan(got[-1]).all())           # layer K-1 untouched
    errs = _coeff_errs(got, ref)
    assert max(errs) <= (1e-12 if dtype == torch.float64 else 1e-4), errs
    if name == "pp81":                                # the closure varies
        nu = ref[:-1, 1:][torch.isfinite(ref[:-1, 1:])]
        assert nu.min() < 0.5 * nu.max()


@pytest.mark.parametrize("suf", list(DTYPES))
def test_coeffs_at_a_column_with_zero_thickness(lib, mesh_np, preps, suf):
    """A live cell whose column has no thickness: N^2 = 0 there (the hole
    guard), so its Richardson number is 0 and kappa = nu0 + kappa_tracer,
    as in the plain version, which agrees everywhere."""
    dtype, p = DTYPES[suf], preps[suf]
    cfg, fr = _setup(mesh_np, 33, "pp81", dtype)
    live = torch.nonzero(fr[0, 0] > 0).flatten()
    q = int(live[len(live) // 3])
    fr[:, 0, q] = 0.0
    ref = pm.vmix_coeffs_plain(p, cfg, fr)
    code, got = _coeffs(lib, p, cfg, fr)
    assert code == 0
    vm = cfg.vert_mix
    want = torch.full((32,), vm.nu0 + vm.kappa_tracer, dtype=dtype)
    torch.testing.assert_close(ref[:-1, 0, q], want)
    torch.testing.assert_close(got[:-1, 0, q], want)
    errs = _coeff_errs(got, ref)
    assert max(errs) <= (1e-12 if dtype == torch.float64 else 1e-4), errs


# case -> the ints index and value that a valid call at K = 33 changes
# (ints: P, K, L, ti, si, n_exp, kg, threads, cw, lanes, lc, rhs), or None
# for no coefficient array
COEF_REFUSED = {
    "one_layer": (1, 1),
    "threads_off_a_warp": (7, 48),
    "threads_over_256": (7, 512),
    "temperature_row_past_the_tracers": (3, L),
    "negative_exponent": (5, -1),
    "no_position": (0, 0),
    "no_coefficient_array": None,
}


@pytest.mark.parametrize("case", list(COEF_REFUSED))
def test_coeffs_refuse_bad_arguments(lib, mesh_np, preps, case):
    """A call the launcher does not take returns an error code and writes
    nothing: a single layer, a block that is not whole warps or is over
    256 threads, a T row past the tracers, a negative exponent, no
    positions, no coefficient array."""
    p = preps["f64"]
    cfg, fr = _setup(mesh_np, 33, "pp81", torch.float64)
    ints = pm._vmix_args(p, cfg, fr, 0.0)[1].copy()
    bad = COEF_REFUSED[case]
    if bad is None:
        consts = pm._vmix_args(p, cfg, fr, 0.0)[0]
        assert lib.omega_patch_pp81_f64(
            fr.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(), None,
            consts.ctypes.data, ints.ctypes.data, None) != 0
        return
    ints[bad[0]] = bad[1]
    code, got = _coeffs(lib, p, cfg, fr, ints)
    assert code != 0
    assert bool(torch.isnan(got).all())


def _coeffs_by_table(p, cfg, fr):
    """The coefficients read through the compact table (p.offs, p.wts) in
    slot order, each product rounded on its own: what the kernel computes
    for any offsets, in torch, (K, 4, P) with layer K-1 NaN."""
    vm, K, P = cfg.vert_mix, fr.shape[0], fr.shape[2]
    offs = p.offs.long()
    pos = torch.arange(P)
    h, u = fr[:, 0], fr[:, 1:4]
    dz = 0.5 * (h[:-1] + h[1:])
    if vm.temp_index >= 0 and vm.salt_index >= 0:
        T, S = fr[:, 4 + vm.temp_index], fr[:, 4 + vm.salt_index]
        db = cfg.gravity * (vm.eos_alpha_t * (T[:-1] - T[1:])
                            - vm.eos_beta_s * (S[:-1] - S[1:]))
        n2 = torch.clamp(torch.where(dz != 0, db / dz, 0.0), min=0.0)
    else:
        n2 = torch.zeros_like(dz)
    du = (u[:-1] - u[1:]).reshape(K - 1, 3 * P)
    ke = torch.zeros_like(dz)
    for s in range(6):
        d = du[:, pos + offs[s]]
        ke = ke + p.wts[6 + s] * (d * d)

    def pp81(ri):
        f = 1.0 + vm.alpha * torch.clamp(ri, min=0.0)
        return vm.nu0 / vmix_kernel._ipow(f, vm.n_exp), f

    nu_c, f = pp81(n2 / torch.clamp(2.0 * ke / (dz * dz), min=vmix_kernel.EPS))
    out = [nu_c / f + vm.kappa_tracer]
    for t in range(3):
        dze = n2e = 0.0
        for s in range(2):
            q = pos + offs[48 + 2 * t + s]
            dze = dze + p.wts[72 + 2 * t + s] * dz[:, q]
            n2e = n2e + p.wts[72 + 2 * t + s] * n2[:, q]
        sh = du[:, t * P:(t + 1) * P] / dze
        out.append(pp81(n2e / torch.clamp(sh * sh, min=vmix_kernel.EPS))[0]
                   + vm.kappa_momentum)
    out = torch.stack(out, 1)
    return torch.cat([out, torch.full_like(out[:1], float("nan"))])


@pytest.mark.parametrize("suf", list(DTYPES))
def test_coeffs_read_a_third_cmean_source_from_memory(lib, mesh_np, preps,
                                                      suf):
    """Where neither cmean source of an edge class is the position itself
    and the two differ, the kernel reads the second from memory: against
    the compact table's own sums (which the unchanged table matches with
    the plain version), at positions whose class-0 sources are moved to
    (+1, +S) and whose class-1 sources are swapped."""
    dtype, p0 = DTYPES[suf], preps[suf]
    cfg, fr = _setup(mesh_np, 33, "pp81", dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert max(_coeff_errs(_coeffs_by_table(p0, cfg, fr).to(dtype),
                           pm.vmix_coeffs_plain(p0, cfg, fr))) <= tol
    p = copy.copy(p0)
    offs = p0.offs.clone()
    live = torch.nonzero((fr[0, 0] > 0) & (offs[48] == 0) & (offs[49] == 1)
                         & (offs[50] == 0)).flatten()
    live = live[(live + p0.S < p0.P)][::5]
    assert len(live) > 100
    offs[48, live], offs[49, live] = 1, p0.S
    offs[50, live], offs[51, live] = offs[51, live], 0
    p.offs = offs
    ref = _coeffs_by_table(p, cfg, fr)
    code, got = _coeffs(lib, p, cfg, fr)
    assert code == 0
    assert max(_coeff_errs(got, ref)) <= tol
