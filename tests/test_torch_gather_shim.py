"""The gather kernel (csrc/gather.cu) compiled for the CPU by g++ against the
stand-in for the CUDA runtime of tests/test_torch_sphere_split_shim.py, and
run on CPU tensors against its plain version (ops/gather_kernel.apply_plain)
over the tables of a reordered icosahedral mesh of subdivision 8: float64
and float32, K = 1 and 5, one and two leading indices; the edge and cell
tables' row counts (1,920 edges, 642 cells) are not multiples of 256, the
vertex tables' (1,280) is.

The kernel uses no shared memory and no barrier, so running the grid's
threads one after another is exact. Limits: max|diff| <= 1e-14 max|ref| in
float64 and 1e-6 in float32 (both sum the slots in slot order, every product
rounded on its own). What the card alone can show (the build by nvcc, the
launch, the times) is chip_smoke.py's `kernel_gather`."""

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


def _run(lib, table, field):
    """The kernel on a contiguous CPU field, as `gather_kernel.apply` calls
    it on the card."""
    idx, w = table.on("cpu", field.dtype)
    lead, K = field.shape[:-2], field.shape[-1]
    out = torch.full(lead + (table.n, K), float("nan"), dtype=field.dtype)
    ints = np.array([table.n, table.m, K, table.nsrc,
                     int(np.prod(lead, dtype=np.int64)),
                     gather_kernel.THREADS], np.int32)
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


def test_gather_refuses_bad_arguments(lib, mesh):
    """A call the kernel does not take returns an error code and writes
    nothing."""
    t = mesh.gather_info["div"]
    idx, w = t.on("cpu", torch.float64)
    f = torch.ones((t.nsrc, 3), dtype=torch.float64)
    out = torch.zeros((t.n, 3), dtype=torch.float64)
    for bad in ([t.n, t.m, 0, t.nsrc, 1, 256], [t.n, t.m, 3, t.nsrc, 0, 256],
                [t.n, t.m, 3, t.nsrc, 1, 100]):
        ints = np.array(bad, np.int32)
        assert lib.omega_gather_f64(f.data_ptr(), out.data_ptr(),
                                    idx.data_ptr(), w.data_ptr(),
                                    ints.ctypes.data, None) != 0
    assert (out == 0).all()
