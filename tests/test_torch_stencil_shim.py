"""The structured stencil kernel (csrc/stencil.cu) compiled for the CPU by
g++ against the block-level stand-in for the CUDA runtime of
tests/test_torch_rk_shim.py: a block's threads run as fibers (`ucontext`)
on the calling thread, one after another up to the next `__syncthreads()`,
the block's dynamic shared array is one buffer filled with NaN bytes before
the block starts, and `cp.async` is a plain copy (a slot read before the
copy that fills it, or never staged, shows). Run on CPU tensors against
the kernel's plain version (`stencil_kernel.apply_stencil_plain`) through
the C entry the wrapper calls, with the record the wrapper packs
(`stencil_kernel.launch_record`):

- every table of the planar hex mesh at 16 x 8 (nx x ny), leading dims ()
  and (2,), float64 with K = 5 (the one-element form) and float32 with
  K = 100 (the 16-byte form, a ragged last segment of the plane);
- tang, cmean and div at 16 x 8, 32 x 16 and 4 x 4 (a domain of fewer
  columns than a block's threads), K = 1, 3, 5, 100, float32 and float64,
  one and two leading indices;
- an unaligned field (the one-element form at K = 100), tables whose
  shifts reach 7 and 40 columns;
- the refusals: a table of 33 entries and a shift exceeding the domain (the
  wrapper raises), and records the C entry refuses (more entries than the
  cap, a shift or a source class out of range, out aliasing in), writing
  nothing.

Limits: float64 rtol 0, atol 1e-12 (tests/test_torch_stencil.py's); float32
rtol 0, atol 8 float32 epsilons of max|ref| (the plain version's own
rounding over at most 8 entries a destination). What the card alone can
show (the build by nvcc, the launch, the times, the outputs bit for bit the
first design's) is chip_smoke.py's `kernel_stencil` and pass_times.py's
`stencil` part."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_rk_shim import BLOCK_RUNTIME, _block_source
from test_torch_sphere_split_shim import CSRC

from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import stencil_kernel, structured

DTYPES = {"f64": (torch.float64, np.float64),
          "f32": (torch.float32, np.float32)}
TABLES = ("div_pos", "div_neg", "div", "ke", "signed_div", "curl", "kite",
          "tang", "c0", "c1", "v0", "v1", "cdiff", "cmean", "vdiff",
          "vmean") + tuple(f"coc{j}" for j in range(6))
MESHES = {"16x8": (16, 8), "32x16": (32, 16), "4x4": (4, 4)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """stencil.cu built by g++ into a library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel for the CPU")
    d = tmp_path_factory.mktemp("stencil_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(
        BLOCK_RUNTIME + "\ninline const char* cudaGetErrorString(int) "
        "{ return \"shim\"; }\n")
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(_block_source(f.read_text()))
    so = d / "libstencil_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "stencil.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for suf in DTYPES:
        fn = getattr(out, f"omega_stencil_{suf}")
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        fn = getattr(out, f"omega_stencil_attrs_{suf}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(out, f"omega_stencil_params_size_{suf}")
        fn.argtypes, fn.restype = [], ctypes.c_int
    return out


@pytest.fixture(scope="module")
def tables():
    """(nx, ny) -> {name: (table, ps, pd)} of the planar hex mesh."""
    out = {}
    for nx, ny in MESHES.values():
        m = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
        out[(nx, ny)] = {
            k[3]: (tab, structured._NPER[src], structured._NPER[dst])
            for k, (tab, dst, src) in structured._TABLE_CACHE.items()
            if k[:3] == (nx, ny, m.structured_dc)}
    return out


def _run(lib, tab, ps, pd, nx, ny, field, rec=None, out=None):
    """One call of the C entry on `field` (..., ps*ny*nx, K): (return
    code, output)."""
    suf = "f64" if field.dtype == torch.float64 else "f32"
    lead, K = field.shape[:-2], field.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    if rec is None:
        rec = stencil_kernel.launch_record(tab, ps, pd, nx, ny, nb, K,
                                           DTYPES[suf][1])
    assert rec.dtype.itemsize == getattr(
        lib, f"omega_stencil_params_size_{suf}")()
    if out is None:
        out = torch.full(lead + (pd * ny * nx, K), float("nan"),
                         dtype=field.dtype)
    code = getattr(lib, f"omega_stencil_{suf}")(
        field.data_ptr(), out.data_ptr(), rec.ctypes.data, None)
    return code, out


def _check(got, ref):
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    tol = 1e-12 if ref.dtype == torch.float64 \
        else 8 * np.finfo(np.float32).eps * ref.abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)


def _field(shape, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                           dtype=dtype)


@pytest.mark.parametrize("suf,K", [("f64", 5), ("f32", 100)])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["lead0", "lead2"])
@pytest.mark.parametrize("name", TABLES)
def test_every_table(lib, tables, name, lead, suf, K):
    nx, ny = MESHES["16x8"]
    tab, ps, pd = tables[(nx, ny)][name]
    f = _field(lead + (ps * ny * nx, K), DTYPES[suf][0], len(name))
    code, got = _run(lib, tab, ps, pd, nx, ny, f)
    assert code == 0
    _check(got, stencil_kernel.apply_stencil_plain(tab, ps, pd, nx, ny, f))


@pytest.mark.parametrize("lead", [(1,), (2,)], ids=["lead1", "lead2"])
@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("K", [1, 3, 5, 100])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shapes(lib, tables, mesh, K, suf, lead):
    """tang (ring (1, 2) each side, 3 -> 3 classes), cmean (1 -> 3) and div
    (3 -> 1)."""
    nx, ny = MESHES[mesh]
    for name in ("tang", "cmean", "div"):
        tab, ps, pd = tables[(nx, ny)][name]
        f = _field(lead + (ps * ny * nx, K), DTYPES[suf][0], K + nx)
        code, got = _run(lib, tab, ps, pd, nx, ny, f)
        assert code == 0
        _check(got, stencil_kernel.apply_stencil_plain(tab, ps, pd, nx, ny,
                                                       f))


@pytest.mark.parametrize("suf", list(DTYPES))
def test_unaligned_field_takes_the_one_element_form(lib, tables, suf):
    nx, ny = MESHES["32x16"]
    tab, ps, pd = tables[(nx, ny)]["tang"]
    dtype = DTYPES[suf][0]
    flat = _field((2 * ps * ny * nx * 100 + 1,), dtype, 5)
    f = flat[1:].view(2, ps * ny * nx, 100)
    assert f.data_ptr() % 16 != 0
    code, got = _run(lib, tab, ps, pd, nx, ny, f)
    assert code == 0
    _check(got, stencil_kernel.apply_stencil_plain(tab, ps, pd, nx, ny, f))


# (t_dst, t_src, dj, di_e, di_o, w): two classes each way, shifts of up to
# 5 rows and 7 columns, and of up to 20 rows and 40 columns on a 64 x 64
# domain
WIDE = ((0, 0, 0, 0, 0, 0.5), (0, 1, 5, -7, 6, -1.25), (0, 1, -3, 2, 2, 2.0),
        (1, 0, 1, 1, 0, 0.75), (1, 1, -5, 7, -7, 1.0), (1, 0, 2, -1, 3, 3.0))
WIDER = WIDE + ((1, 1, 20, -40, 39, 0.25), (0, 0, -19, 33, -40, -0.5))


@pytest.mark.parametrize("suf", list(DTYPES))
@pytest.mark.parametrize("case", ["wide_ring", "direct_form"])
def test_wide_rings(lib, case, suf):
    tab, (nx, ny) = ((WIDE, (32, 16)) if case == "wide_ring"
                     else (WIDER, (64, 64)))
    f = _field((2 * ny * nx, 4), DTYPES[suf][0], 9)
    code, got = _run(lib, tab, 2, 2, nx, ny, f)
    assert code == 0
    _check(got, stencil_kernel.apply_stencil_plain(tab, 2, 2, nx, ny, f))


def test_wrapper_refuses_what_the_kernel_does_not_take(tables):
    nx, ny = MESHES["16x8"]
    tab, ps, pd = tables[(nx, ny)]["tang"]
    with pytest.raises(ValueError, match="at most 32"):
        stencil_kernel.launch_record(tab + tab[:9], ps, pd, nx, ny, 1, 5,
                                     np.float64)
    far = ((0, 0, 0, nx, nx, 1.0),)
    with pytest.raises(ValueError, match="exceeds the domain"):
        stencil_kernel.launch_record(far, 1, 1, nx, ny, 1, 5, np.float64)
    far = ((0, 0, -ny, 0, 0, 1.0),)
    with pytest.raises(ValueError, match="exceeds the domain"):
        stencil_kernel.launch_record(far, 1, 1, nx, ny, 1, 5, np.float64)


# case -> what it changes in a valid record of cmean (1 -> 3 classes)
REFUSED = {
    "entries_above_cap": lambda r: r["start"].__setitem__(3, 33),
    "start_not_grouped": lambda r: r["start"].__setitem__(1, 5),
    "row_shift_is_domain": lambda r: r["e"][0].__setitem__("dj", 8),
    "column_shift_is_domain": lambda r: r["e"][1].__setitem__("di_o", -16),
    "source_class_out_of_range": lambda r: r["e"][2].__setitem__("ts", 1),
    "no_classes": lambda r: r.__setitem__("pd", 0),
    "out_is_in": None,
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_refuses_bad_records(lib, tables, case):
    nx, ny = MESHES["16x8"]
    tab, ps, pd = tables[(nx, ny)]["cmean"]
    f = _field((ps * ny * nx, 4), torch.float64, 3)
    rec = stencil_kernel.launch_record(tab, ps, pd, nx, ny, 1, 4, np.float64)
    out = torch.zeros((pd * ny * nx, 4), dtype=torch.float64)
    if REFUSED[case] is None:
        rec2 = rec.copy()
        code = lib.omega_stencil_f64(f.data_ptr(), f.data_ptr(),
                                     rec2.ctypes.data, None)
    else:
        REFUSED[case](rec)
        code, _ = _run(lib, tab, ps, pd, nx, ny, f, rec=rec, out=out)
    assert code != 0
    assert (out == 0).all()
