"""The gather kernel (csrc/gather.cu) compiled for the CPU by g++ against the
stand-in for the CUDA runtime of tests/test_torch_sphere_split_shim.py, and
run on CPU tensors against its plain version (ops/gather_kernel.apply_plain)
over the tables of a reordered icosahedral mesh of subdivision 8: float64
and float32, K = 1 and 5, one and two leading indices; every table at
K = 12, 6 and 3 with two leading indices (each width of vector a thread
takes: 4, 2 and 1 floats, 2 and 1 doubles), and a field that is not
16-byte aligned; rows wider than the slots a thread holds in registers
(17 and 20 slots, a synthetic table); the edge and cell tables' row counts
(1,920 edges, 642 cells) are not multiples of 256, the vertex tables'
(1,280) is.

Limits: max|diff| <= 1e-14 max|ref| in float64 and 1e-6 in float32 on the
first set; bit for bit on the others (both sum the slots in slot order,
every product rounded on its own). What the card alone can show (the build
by nvcc, the launch, the times) is chip_smoke.py's `kernel_gather`."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_sphere_split_shim import CSRC, LAUNCH, RUNTIME, _launch_loop

from omega_tpu_torch.mesh import reorder_mesh, spherical_icos_mesh
from omega_tpu_torch.ops import gather_kernel

TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
TABLES = ("tang", "div", "curl", "kite", "cmean", "vdiff", "c1")
NAMES = ("div", "div_pos", "div_neg", "ke", "signed_div", "curl", "kite",
         "tang", "cdiff", "cmean", "vdiff", "vmean", "c0", "c1", "v0", "v1")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """gather.cu built by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel for the CPU")
    d = tmp_path_factory.mktemp("gather_shim")
    (d / "include").mkdir()
    (d / "include" / "cuda_runtime.h").write_text(RUNTIME)
    for f in CSRC.glob("*.cu*"):
        (d / f.name).write_text(LAUNCH.sub(_launch_loop, f.read_text()))
    so = d / "libgather_shim.so"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-w",
         f"-I{d / 'include'}", "-x", "c++", str(d / "gather.cu"), "-o",
         str(so)], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for suf in SUFFIX.values():
        fn = getattr(out, f"omega_gather_{suf}")
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def mesh():
    return reorder_mesh(spherical_icos_mesh(8))


def _run(lib, table, field, out=None):
    """The kernel on a CPU field, as `gather_kernel.apply` calls it on the
    card (into `out` when given, else a new NaN-filled array)."""
    lead, K = field.shape[:-2], field.shape[-1]
    idx, w = table.on("cpu", field.dtype)
    if out is None:
        out = torch.full(lead + (table.n, K), float("nan"),
                         dtype=field.dtype)
    ints = np.array([table.n, table.m, K, table.nsrc,
                     int(np.prod(lead, dtype=np.int64))], np.int32)
    code = getattr(lib, f"omega_gather_{SUFFIX[field.dtype]}")(
        field.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(),
        ints.ctypes.data, None)
    assert code == 0
    return out


@pytest.mark.parametrize("lead,K", [((), 1), ((2,), 5)],
                         ids=["K1", "L2K5"])
@pytest.mark.parametrize("dtype", list(SUFFIX), ids=list(SUFFIX.values()))
@pytest.mark.parametrize("name", TABLES)
def test_gather_against_plain(lib, mesh, name, dtype, lead, K):
    t = mesh.gather_info[name]
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.standard_normal(lead + (t.nsrc, K)), dtype=dtype)
    got, ref = _run(lib, t, f), gather_kernel.apply_plain(t, f)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= TOL[dtype] * ref.abs().max()


@pytest.mark.parametrize("K", [12, 6, 3])
@pytest.mark.parametrize("dtype", list(SUFFIX), ids=list(SUFFIX.values()))
@pytest.mark.parametrize("name", NAMES)
def test_gather_vectors_against_plain(lib, mesh, name, dtype, K):
    """All 16 tables, two leading indices, at a K that gives each width of
    vector a thread takes: bit for bit."""
    t = mesh.gather_info[name]
    rng = np.random.default_rng(6)
    f = torch.as_tensor(rng.standard_normal((2, t.nsrc, K)), dtype=dtype)
    assert torch.equal(_run(lib, t, f), gather_kernel.apply_plain(t, f))


@pytest.mark.parametrize("dtype", list(SUFFIX), ids=list(SUFFIX.values()))
def test_gather_unaligned_field(lib, mesh, dtype):
    """A field and an output one element past a 16-byte boundary (K = 12
    would take whole vectors): the kernel falls to narrower loads, bit for
    bit."""
    t = mesh.gather_info["tang"]
    rng = np.random.default_rng(8)
    K = 12
    buf = torch.as_tensor(rng.standard_normal(2 * t.nsrc * K + 1),
                          dtype=dtype)
    f = buf[1:].view(2, t.nsrc, K)
    obuf = torch.full((2 * t.n * K + 1,), float("nan"), dtype=dtype)
    out = obuf[1:].view(2, t.n, K)
    _run(lib, t, f, out)
    assert torch.equal(out, gather_kernel.apply_plain(t, f))


@pytest.mark.parametrize("M", [17, 20])
@pytest.mark.parametrize("dtype", list(SUFFIX), ids=list(SUFFIX.values()))
def test_gather_wide_rows_against_plain(lib, dtype, M):
    """A table wider than the slots a thread holds in registers (the slots
    read from the table at every leading index), a third of its weights 0,
    600 rows over 300 sources, K = 12 and 5: bit for bit."""
    rng = np.random.default_rng(M)
    nsrc = 300
    w = rng.standard_normal((600, M))
    w[rng.random(w.shape) < 1 / 3] = 0.0
    t = gather_kernel.GatherTable(rng.integers(0, nsrc, w.shape), w, nsrc)
    for K in (12, 5):
        f = torch.as_tensor(rng.standard_normal((2, nsrc, K)), dtype=dtype)
        assert torch.equal(_run(lib, t, f), gather_kernel.apply_plain(t, f))


def test_gather_refuses_bad_arguments(lib, mesh):
    """A call the kernel does not take returns an error code and writes
    nothing: K = 0, no leading index, no slot, no row."""
    t = mesh.gather_info["div"]
    idx, w = t.on("cpu", torch.float64)
    f = torch.ones((t.nsrc, 3), dtype=torch.float64)
    out = torch.zeros((t.n, 3), dtype=torch.float64)
    for bad in ([t.n, t.m, 0, t.nsrc, 1], [t.n, t.m, 3, t.nsrc, 0],
                [t.n, 0, 3, t.nsrc, 1], [0, t.m, 3, t.nsrc, 1]):
        ints = np.array(bad, np.int32)
        assert lib.omega_gather_f64(
            f.data_ptr(), out.data_ptr(), idx.data_ptr(), w.data_ptr(),
            ints.ctypes.data, None) != 0
    assert (out == 0).all()
