"""The planar barotropic subcycle kernel (csrc/barotropic.cu: all M
subcycles in one cooperative launch, its blocks meeting at a grid barrier
between subcycles) compiled for the CPU by g++ against the grid-level
stand-in for the CUDA runtime of tests/grid_shim.py (every thread of every
block a fiber; `__syncthreads()` and `grid.sync()` passed when the block's
or the grid's threads have all reached them), and run on CPU tensors
against its plain version (ops/barotropic_kernel.bt_plain) on the planes
splitpre's plain version makes of a noisy state: planar hex meshes of
32 x 16 (one tile) and 48 x 20 (four tiles, ragged), M = 1, 2, 7, r = 0
and 1e-4, float64 and float32, in the resident form (a block a tile) and
on a grid of two blocks that walk two tiles each (the streamed form); then
the arguments the launcher refuses and its attribute query.

Limits (chip_smoke.py's `kernel_split`): float64 per channel max|diff| <=
1e-12 max|ref|; float32 per channel the error of the increment (ub_final
and <ubar> over ubar, ssh over the starting ssh) <= BT_INCR of the largest
increment. What the card alone can show (the build by nvcc, the launch,
the times) is chip_smoke.py's `kernel_split`."""

import ctypes

import numpy as np
import pytest
import torch

import grid_shim
from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import barotropic_kernel as btk
from omega_tpu_torch.ops import megastep

L, K, DT, G = 2, 3, 120.0, 9.80616
F64_TOL, BT_INCR = 1e-12, 5e-5
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# mesh, and the shim's SMs x blocks per SM: 4 x 1 holds a block per tile
# (resident), 2 x 1 makes each of two blocks walk two tiles (streamed)
CASES = {"32x16": ((32, 16), 4), "48x20_resident": ((48, 20), 4),
         "48x20_streamed": ((48, 20), 2)}
SMEM_OPTIN = 232448


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """barotropic.cu built by g++ against the grid runtime"""
    out = grid_shim.build(tmp_path_factory.mktemp("bt_shim"),
                          ["barotropic.cu"], "bt_shim")
    vp, cd, ci = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for suf in DTYPES:
        fn = getattr(out, f"omega_barotropic_{suf}")
        fn.argtypes = [vp] * 4 + [cd] * 4 + [ci, ci, vp]
        fn.restype = ci
        fn = getattr(out, f"omega_barotropic_attrs_{suf}")
        fn.argtypes = [ci, vp]
        fn.restype = ci
    return out


@pytest.fixture(scope="module")
def stacks():
    """(nx, ny) -> (mesh_np, the float64 planes (10, ny, nx) of splitpre's
    plain version on a noisy state with the column free surface)"""
    out = {}
    for nx, ny in {c[0] for c in CASES.values()}:
        mesh_np = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4,
                                  bottom_depth=1000.0)
        mesh = mesh_np.to("cpu", torch.float64)
        cfg = ModelConfig(nvertlayers=K, ntracers=L, ssh_formulation="column",
                          tendencies=TendencyConfig(visc_del2=1e3,
                                                    visc_del4=1e9))
        rng = np.random.default_rng(nx + ny)
        kx = 2 * np.pi / mesh_np.x_period
        x = np.asarray(mesh_np.x_cell)
        h = (1000.0 + np.sin(kx * x))[:, None] / K \
            * (1.0 + 1e-3 * rng.standard_normal((mesh_np.ncells, K)))
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)
        st = ModelState(t(h), t(0.01 * rng.standard_normal(
            (mesh_np.nedges, K))), t(10.0 + rng.standard_normal(
                (L, mesh_np.ncells, K))))
        _, pl = megastep.split_pre_plain(mesh, cfg,
                                         megastep.stack_state(mesh, st))
        out[nx, ny] = mesh_np, pl[:10].contiguous()
    return out


def _call(lib, mesh, stack, out, work, M, r, rec=None, grid=0, ptrs=None):
    c = btk._consts(mesh, G, DT / max(M, 1), r)
    suf = "f64" if stack.dtype == torch.float64 else "f32"
    rec = btk.record(mesh, stack.dtype) if rec is None else rec
    a = ptrs or (stack.data_ptr(), out.data_ptr(), work.data_ptr())
    return getattr(lib, f"omega_barotropic_{suf}")(
        *a, rec.ctypes.data, c["dt_bt"], c["ggrad"], c["f_e"], c["r"], M,
        grid, None)


def _chan(got, ref):
    return max(((got[c] - ref[c]).abs().max()
                / ref[c].abs().max().clamp(min=1e-300)).item()
               for c in range(ref.shape[0]))


def _incr(got, ref, start):
    return max(((got[c] - ref[c]).abs().max()
                / (ref[c] - start[c]).abs().max().clamp(min=1e-300)).item()
               for c in range(ref.shape[0]))


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("r", [0.0, 1e-4])
@pytest.mark.parametrize("M", [1, 2, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_subcycles_against_plain(lib, stacks, case, M, r, suf):
    """One call (all M subcycles) against bt_plain; out and work NaN
    before it, so a point the kernel leaves unwritten shows."""
    dtype = DTYPES[suf]
    shape, sms = CASES[case]
    lib.shim_set_device(sms, 1, SMEM_OPTIN)
    mesh_np, stack64 = stacks[shape]
    mesh = mesh_np.to("cpu", dtype)
    stack = stack64.to(dtype)
    nx, ny = shape
    out = torch.full((7, ny, nx), float("nan"), dtype=dtype)
    work = torch.full((4, ny, nx), float("nan"), dtype=dtype)
    assert _call(lib, mesh, stack, out, work, M, r) == 0
    ref = btk.bt_plain(mesh, stack, gravity=G, dt_bt=DT / M, n_subcycles=M,
                       bt_drag=r)
    assert bool(torch.isfinite(out).all())
    if dtype == torch.float64:
        assert _chan(out, ref) <= F64_TOL
    else:
        start = torch.cat([stack[:4], stack[:3]])
        assert _incr(out, ref, start) <= BT_INCR


# case -> what it changes in a valid float64 call on 48 x 20 (4 tiles) on
# a card of 2 SMs x 1 block
REFUSED = {
    "no_subcycle": dict(M=0),
    "grid_beyond_the_card": dict(grid=3),
    "out_is_work": dict(alias="work"),
    "out_is_in": dict(alias="in"),
    "no_record": dict(rec=False),
    "layers": dict(field=("K", 2)),
    "other_ring": dict(field=("rx", 3)),
    "other_pattern": dict(pattern=True),
    "odd_rows": dict(field=("ny", 19)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refuses_bad_arguments(lib, stacks, case):
    """A call the launcher does not take returns an error code and writes
    nothing: no subcycle, a grid larger than the card holds co-resident
    (cudaErrorCooperativeLaunchTooLarge), `out` aliasing `work` or the
    input, no record, a record of several layers, another ring than the
    compiled (2, 2), another entry pattern, an odd row count."""
    lib.shim_set_device(2, 1, SMEM_OPTIN)
    mesh_np, stack = stacks[48, 20]
    mesh = mesh_np.to("cpu", torch.float64)
    bad = REFUSED[case]
    rec = btk.record(mesh, torch.float64).copy()
    if "field" in bad:
        rec[bad["field"][0]] = bad["field"][1]
    if bad.get("pattern"):
        rec["off"][1, 3] += 1
    out = torch.zeros((7, 20, 48), dtype=torch.float64)
    work = torch.zeros((4, 20, 48), dtype=torch.float64)
    ptrs = None
    if "alias" in bad:
        ptrs = (stack.data_ptr(), out.data_ptr(),
                out.data_ptr() if bad["alias"] == "work"
                else stack.data_ptr())
    M = bad.get("M", 3)
    if bad.get("rec") is False:
        c = btk._consts(mesh, G, DT / 3, 0.0)
        code = lib.omega_barotropic_f64(
            stack.data_ptr(), out.data_ptr(), work.data_ptr(), None,
            c["dt_bt"], c["ggrad"], c["f_e"], c["r"], M, 0, None)
    else:
        code = _call(lib, mesh, stack, out, work, M, 0.0, rec=rec,
                     grid=bad.get("grid", 0), ptrs=ptrs)
    assert code != 0
    if case == "grid_beyond_the_card":
        assert code == 720          # cudaErrorCooperativeLaunchTooLarge
    assert bool((out == 0).all()) and bool((work == 0).all())


def test_grid_and_attributes(lib, stacks):
    """The launcher's grid: a block a tile where the card holds them
    (resident, bit for bit the same result as the streamed form on one
    block that walks all four tiles); the attribute query reads the blocks
    an SM holds and the SM count, and none where the shared memory is more
    than a block may opt into."""
    mesh_np, stack = stacks[48, 20]
    mesh = mesh_np.to("cpu", torch.float64)
    outs = []
    for sms in (4, 1):
        lib.shim_set_device(sms, 1, SMEM_OPTIN)
        out = torch.zeros((7, 20, 48), dtype=torch.float64)
        work = torch.zeros((4, 20, 48), dtype=torch.float64)
        assert _call(lib, mesh, stack, out, work, 5, 1e-4) == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    lib.shim_set_device(3, 2, SMEM_OPTIN)
    got = np.zeros(5, np.int32)
    assert lib.omega_barotropic_attrs_f64(1, got.ctypes.data) == 0
    assert list(got[3:]) == [2, 3]
    lib.shim_set_device(3, 2, 1000)
    assert lib.omega_barotropic_attrs_f32(0, got.ctypes.data) == 0
    assert got[3] == 0
    lib.shim_set_device(3, 2, 1000)
    out = torch.zeros((7, 20, 48), dtype=torch.float64)
    work = torch.zeros((4, 20, 48), dtype=torch.float64)
    assert _call(lib, mesh, stack, out, work, 2, 0.0) == 720
