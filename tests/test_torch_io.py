"""The port's IO (omega_tpu_torch.io.netcdf, io.stream, mesh.mpas_io)
against the JAX package's: NetCDF3 and HDF5 files written by either
package and read by both, the stream schedule (which stream writes when,
to which file and frame) of both StreamManagers on the same config and
clock, and MPAS mesh files of generated planar and icos8 meshes (the repo
ships no .nc file)."""

import os
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

from omega_tpu import infra as j_infra
from omega_tpu.infra import errors as j_errors
from omega_tpu.infra.config import Config as JConfig
from omega_tpu.io import netcdf as j_nc
from omega_tpu.io import stream as j_stream
from omega_tpu.mesh import mpas_io as j_mpas
from omega_tpu.mesh import planar_hex_mesh as j_planar
from omega_tpu.mesh.spherical import spherical_icos_mesh as j_sphere
from omega_tpu_torch import infra as p_infra
from omega_tpu_torch.infra.config import Config as PConfig
from omega_tpu_torch.infra.errors import IOError_, OmegaError
from omega_tpu_torch.io import netcdf as p_nc
from omega_tpu_torch.io import stream as p_stream
from omega_tpu_torch.mesh import mpas_io as p_mpas
from omega_tpu_torch.mesh import planar_hex_mesh as p_planar
from omega_tpu_torch.mesh import spherical_icos_mesh as p_sphere
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS

FORMATS = ["netcdf3", "hdf5"]


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        dims={"Time": 2, "nCells": 7, "nLev": 3},
        variables={"h": rng.standard_normal((2, 7, 3)),
                   "depth": rng.random(7),
                   "idx": np.arange(7, dtype=np.int32),
                   "f32": rng.random((7, 3)).astype(np.float32)},
        var_dims={"h": ("Time", "nCells", "nLev"), "depth": ("nCells",),
                  "idx": ("nCells",), "f32": ("nCells", "nLev")},
        var_attrs={"h": {"units": "m", "long_name": "thickness"},
                   "depth": {"valid_min": 0.0}},
        attrs={"SimulationTime": "0001-01-01_00:10:00", "n": 3, "x": 2.5})


def _same_file(a, b):
    assert a.dims == b.dims
    assert sorted(a.variables) == sorted(b.variables)
    for k in a.variables:
        np.testing.assert_array_equal(a.variables[k], b.variables[k], k)
        assert a.variables[k].dtype == b.variables[k].dtype, k
    assert a.var_dims == b.var_dims
    assert a.var_attrs == b.var_attrs
    assert a.attrs == b.attrs


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_netcdf_round_trip_across_packages(tmp_path, fmt, writer):
    path = str(tmp_path / f"f.{fmt}.nc")
    w = j_nc if writer == "jax" else p_nc
    w.write_netcdf(path, fmt=fmt, unlimited="Time", **_payload())
    a, b = j_nc.read_netcdf(path), p_nc.read_netcdf(path)
    _same_file(b, a)
    assert b.has("h") and not b.has("nope")
    np.testing.assert_array_equal(b.get("h"), _payload()["variables"]["h"])
    with pytest.raises(IOError_):
        b.get("nope")


@pytest.mark.parametrize("fmt", FORMATS)
def test_append_frames_same_bytes_as_jax(tmp_path, fmt):
    for pkg, nc in (("j", j_nc), ("p", p_nc)):
        path = str(tmp_path / f"{pkg}.nc")
        nc.write_netcdf(path, fmt=fmt, unlimited="Time", **_payload())
        extra = np.full((1, 7, 3), 4.5)
        assert nc.append_netcdf(path, variables={"h": extra},
                                var_dims={"h": ("Time", "nCells", "nLev")},
                                attrs={"SimulationTime": "later"})
    a = j_nc.read_netcdf(str(tmp_path / "j.nc"))
    b = p_nc.read_netcdf(str(tmp_path / "p.nc"))
    _same_file(b, a)
    assert b.variables["h"].shape[0] == 3


def test_not_netcdf_and_unknown_format(tmp_path):
    path = str(tmp_path / "junk.nc")
    open(path, "wb").write(b"junkjunkjunk")
    with pytest.raises(IOError_):
        p_nc.read_netcdf(path)
    with pytest.raises(IOError_):
        p_nc.write_netcdf(path, fmt="grib", **_payload())


def test_hdf5_without_h5py_raises_naming_the_format(tmp_path, monkeypatch):
    path = str(tmp_path / "a.nc")
    p_nc.write_netcdf(path, fmt="hdf5", **_payload())
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: p_nc.read_netcdf(path),
                 lambda: p_nc.write_netcdf(str(tmp_path / "b.nc"),
                                           fmt="hdf5", **_payload())):
        with pytest.raises(OmegaError, match="HDF5"):
            call()
    p_nc.write_netcdf(str(tmp_path / "c.nc"), **_payload())   # NetCDF3 ok
    assert p_nc.read_netcdf(str(tmp_path / "c.nc")).has("h")


# ------------------------------------------------------------ streams

STREAMS = {
    "History": {"Filename": "hist.$SimTime", "Mode": "write",
                "Freq": 10, "FreqUnits": "minutes",
                "Contents": ["State", "Ssh"]},
    "Single": {"Filename": "single.$Y-$M-$D_$h.$m.$s", "Mode": "write",
               "Precision": "single", "Freq": 20, "FreqUnits": "minutes",
               "Format": "hdf5", "Contents": ["LayerThickness"]},
    "Window": {"Filename": "win.$SimTime", "Mode": "write", "Freq": 5,
               "FreqUnits": "minutes", "UseStartEnd": True,
               "StartTime": "0001-01-01_00:15:00",
               "EndTime": "0001-01-01_00:30:00", "Contents": ["Ssh"]},
    "Multi": {"Filename": "multi.$h.$m", "Mode": "write",
              "IfExists": "append", "Freq": 5, "FreqUnits": "minutes",
              "FileFreq": 15, "FileFreqUnits": "minutes",
              "Contents": ["Ssh"]},
    "Restart": {"UsePointerFile": True, "PointerFilename": "ptr",
                "Filename": "rst.$Y-$M-$D_$h.$m.$s", "Mode": "write",
                "Freq": 15, "FreqUnits": "minutes",
                "Contents": ["Restart"]},
    "Shutdown": {"Filename": "final", "Mode": "write",
                 "FreqUnits": "OnShutdown", "Contents": ["Ssh"]},
    "Never": {"Filename": "never", "Mode": "write", "FreqUnits": "never",
              "Contents": ["Ssh"]},
    "Init": {"Filename": "init.nc", "Mode": "read", "FreqUnits": "OnStartup",
             "Contents": ["State"]},
}


def _manager(pkg, tmp, data):
    I = j_infra if pkg == "j" else p_infra
    Config = JConfig if pkg == "j" else PConfig
    SM = j_stream.StreamManager if pkg == "j" else p_stream.StreamManager
    cal = I.Calendar(I.CalendarKind.NO_LEAP)
    start = I.TimeInstant.from_string(cal, "0001-01-01_00:00:00")
    clock = I.Clock(start, I.TimeInterval.from_string("0000_00:05:00"))
    fields, dims = I.FieldRegistry(), I.DimensionRegistry()
    dims.create("NCells", 6)
    dims.create("NVertLayers", 2)
    fields.create("LayerThickness", units="m", time_dependent=True,
                  dim_names=("NCells", "NVertLayers"))
    fields.create("NormalVelocity", units="m s-1", time_dependent=True,
                  dim_names=("NCells", "NVertLayers"))
    fields.create("Ssh", units="m", time_dependent=True,
                  dim_names=("NCells",))
    fields.create_group("State")
    fields.add_to_group("State", "LayerThickness", "NormalVelocity")
    fields.create_group("Restart")
    fields.add_to_group("Restart", "LayerThickness", "NormalVelocity")
    fields.create_meta("code", model="m")
    fields.create_meta("simulation", StartTime=str(start))
    sm = SM(Config("IOStreams", {k: dict(v) for k, v in STREAMS.items()}),
            clock, cal, fields, dims, str(tmp))
    sm.validate_all()
    return sm, clock, fields


def _attach(pkg, fields, data):
    conv = (lambda a: a) if pkg == "j" else torch.as_tensor
    for k, v in data.items():
        fields.attach(k, conv(v))


def _run_schedule(pkg, tmp):
    rng = np.random.default_rng(1)
    p_nc.write_netcdf(str(tmp / "init.nc"),
                      dims={"NCells": 6, "NVertLayers": 2},
                      variables={"LayerThickness": rng.random((6, 2)),
                                 "NormalVelocity": rng.random((6, 2))},
                      var_dims={"LayerThickness": ("NCells", "NVertLayers"),
                                "NormalVelocity": ("NCells",
                                                   "NVertLayers")})
    sm, clock, fields = _manager(pkg, tmp, None)
    meta = sm.read_on_startup()
    log = [("startup", sorted(meta), np.asarray(
        fields.get("LayerThickness").data).tolist())]
    for step in range(8):
        clock.advance()
        data = {"LayerThickness": rng.random((6, 2)) + step,
                "NormalVelocity": rng.random((6, 2)),
                "Ssh": rng.random(6)}
        _attach(pkg, fields, data)
        fields.update_meta("simulation",
                           SimulationTime=str(clock.get_current_time()))
        written = sm.write_all()
        log.append((str(clock.get_current_time()),
                    [os.path.basename(w) for w in written],
                    {n: s.frame for n, s in sm.streams.items()}))
        for a in clock.alarms:
            if a.is_ringing():
                a.reset(clock.get_current_time())
    log.append(("shutdown", [os.path.basename(w) for w in sm.finalize()]))
    sm.streams["Shutdown"].spec.if_exists = "fail"
    sm.streams["Shutdown"].frame = 0
    err = j_errors.OmegaError if pkg == "j" else OmegaError
    for call in (lambda: sm.write("Shutdown", force=True),
                 lambda: sm.get("Nope"),
                 lambda: sm.read("History", force=True),
                 lambda: sm.write("Init", force=True)):
        with pytest.raises(err):
            call()
    return log


def test_stream_schedule_and_files_match_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _run_schedule("j", tmp_path / "j")
    got = _run_schedule("p", tmp_path / "p")
    assert got == want
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == files
    assert "ptr" in files and "final.nc" in files
    assert open(tmp_path / "p" / "ptr").read() == \
        open(tmp_path / "j" / "ptr").read()
    for f in files:
        if f.endswith(".nc"):
            _same_file(p_nc.read_netcdf(str(tmp_path / "p" / f)),
                       j_nc.read_netcdf(str(tmp_path / "j" / f)))
    single = [f for f in files if f.startswith("single")]
    assert p_nc.read_netcdf(str(tmp_path / "p" / single[0])).get(
        "LayerThickness").dtype == np.float32


def test_stream_precision_double_writes_float32_as_float64(tmp_path):
    sm, clock, fields = _manager("p", tmp_path, None)
    h = torch.rand((6, 2), dtype=torch.float32)
    fields.attach("LayerThickness", h)
    fields.attach("NormalVelocity", torch.zeros((6, 2), dtype=torch.float32))
    path = sm.write("Restart", force=True)
    back = p_nc.read_netcdf(path).get("LayerThickness")[0]
    assert back.dtype.kind == "f" and back.dtype.itemsize == 8
    assert torch.equal(torch.as_tensor(back.astype(np.float64),
                                       dtype=torch.float32), h)


def test_stream_spec_and_filename_match_jax():
    for name, c in STREAMS.items():
        a = j_stream.StreamSpec.from_config(name, JConfig(name, dict(c)))
        b = p_stream.StreamSpec.from_config(name, PConfig(name, dict(c)))
        assert a.__dict__ == b.__dict__
    for pkg, I, bf in (("j", j_infra, j_stream.build_filename),
                       ("p", p_infra, p_stream.build_filename)):
        cal = I.Calendar(I.CalendarKind.GREGORIAN)
        clock = I.Clock(I.TimeInstant.from_string(cal, "2000-02-29_01:02:03"),
                        I.TimeInterval.from_string("00:00:01"))
        out = bf("a.$Y.$M.$D.$h.$m.$s.$SimTime", clock)
        assert out == "a.2000.02.29.01.02.03.2000-02-29_01:02:03", pkg


# --------------------------------------------------------- MPAS meshes

def _mesh_pair(which):
    if which == "planar":
        return (j_planar(12, 8, dc=5000.0, f0=1e-4, bottom_depth=500.0),
                p_planar(12, 8, dc=5000.0, f0=1e-4, bottom_depth=500.0))
    return j_sphere(8), p_sphere(8)


def _same_mesh(a, b, exact=True):
    for n in ARRAY_FIELDS:
        x, y = np.asarray(getattr(a, n)), np.asarray(getattr(b, n))
        if exact:
            np.testing.assert_array_equal(x, y, n)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12,
                                       err_msg=n)
    for n in ("ncells", "nedges", "nvertices", "max_edges",
              "vertex_degree", "on_sphere", "sphere_radius", "x_period",
              "y_period"):
        assert getattr(a, n) == getattr(b, n), n


@pytest.mark.parametrize("which", ["planar", "icos8"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_mpas_mesh_files_across_packages(tmp_path, which, fmt):
    jm, pm = _mesh_pair(which)
    pj, pp = str(tmp_path / "j.nc"), str(tmp_path / "p.nc")
    j_mpas.write_mpas_mesh(jm, pj, fmt=fmt)
    p_mpas.write_mpas_mesh(pm, pp, fmt=fmt)
    a, b = p_nc.read_netcdf(pj), p_nc.read_netcdf(pp)
    assert sorted(a.variables) == sorted(b.variables)
    for k in a.variables:
        np.testing.assert_allclose(b.variables[k], a.variables[k],
                                   rtol=1e-12, atol=1e-9, err_msg=k)
    assert {k: v for k, v in b.attrs.items() if k != "source"} == \
        {k: v for k, v in a.attrs.items() if k != "source"}
    # each package reads the other's file: the same mesh
    rp, rj = p_mpas.read_mpas_mesh(pj), j_mpas.read_mpas_mesh(pp)
    assert isinstance(rp.x_cell, np.ndarray)
    _same_mesh(rp, rj, exact=False)
    _same_mesh(p_mpas.read_mpas_mesh(pp), j_mpas.read_mpas_mesh(pj),
               exact=False)
    # a mesh on a device writes the same file as on the host
    p_mpas.write_mpas_mesh(pm.to("cpu", torch.float64),
                           str(tmp_path / "t.nc"), fmt=fmt)
    _same_file(p_nc.read_netcdf(str(tmp_path / "t.nc")), b)


def test_mpas_reader_defaults():
    """Optional variables absent from the file take the reader's
    defaults in both packages."""
    import tempfile
    jm, _ = _mesh_pair("planar")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.nc")
        j_mpas.write_mpas_mesh(jm, path)
        nc = j_nc.read_netcdf(path)
        drop = {"fCell", "bottomDepth", "lonCell", "meshScalingDel2"}
        j_nc.write_netcdf(
            path, dims=nc.dims,
            variables={k: v for k, v in nc.variables.items()
                       if k not in drop},
            var_dims={k: v for k, v in nc.var_dims.items() if k not in drop},
            attrs=nc.attrs)
        a = j_mpas.read_mpas_mesh(path, defaults={"fCell": 2e-4})
        b = p_mpas.read_mpas_mesh(path, defaults={"fCell": 2e-4})
    _same_mesh(b, a, exact=False)
    assert float(np.asarray(b.bottom_depth)[0]) == 1000.0
    assert float(np.asarray(b.f_cell)[0]) == 2e-4
