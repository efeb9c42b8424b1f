"""The port's standalone driver (omega_tpu_torch.driver) against the JAX
package's (omega_tpu.driver) on tests/test_driver.py's 8 x 8 x 3 planar
configuration, float64 on the CPU: the final state at rtol 1e-12; the
history, multi-frame, windowed (UseStartEnd), diagnostics and restart files
(names, attributes, variables at 1e-12); the energetics CSV; constant and
time-varying wind; the p-star phase; a restart chain bit for bit an unbroken
port run. Then what only the port has to show: PatchLayout on icos8
against the plain sphere, a changed BottomDepth dropping the patch layout,
the Decomp group (sharded runs bit for bit the unsharded ones on the
structured and SFC decompositions and the patch layout, p-star on SFC, bad
configurations refused), `main` with --device / --dtype, and
the CUDA default.

Each JAX reference runs once per module (module-scoped fixtures)."""

import copy
import os

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import jax.numpy as jnp

from omega_tpu import driver as jdrv
from omega_tpu.infra.config import Config as JConfig
from omega_tpu.io.netcdf import read_netcdf as j_read
from omega_tpu_torch import driver as pdrv
from omega_tpu_torch.infra.config import Config as PConfig
from omega_tpu_torch.infra.errors import ConfigError
from omega_tpu_torch.io.netcdf import read_netcdf, write_netcdf

RTOL = 1e-12
F64 = dict(device="cpu", dtype=torch.float64)


def base_doc(stop="0001-01-01_00:30:00", streams=None,
             start="0001-01-01_00:00:00", **extra):
    doc = {
        "TimeIntegration": {
            "CalendarType": "No Leap", "TimeStepper": "Forward-Backward",
            "TimeStep": "0000_00:01:00", "StartTime": start,
            "StopTime": stop, "RunDuration": "none"},
        "Mesh": {"Generate": {"Kind": "planar", "Nx": 8, "Ny": 8,
                              "Dc": 25000.0, "F0": 1.0e-4,
                              "BottomDepth": 1000.0}},
        "VertCoord": {"NVertLayers": 3},
        "Tracers": {"Base": ["Temperature", "Salinity"]},
        "Tendencies": {
            "ThicknessFluxTendencyEnable": True, "PVTendencyEnable": True,
            "KETendencyEnable": True, "SSHTendencyEnable": True,
            "VelDiffTendencyEnable": False,
            "VelHyperDiffTendencyEnable": False,
            "TracerHorzAdvTendencyEnable": True,
            "TracerDiffTendencyEnable": False,
            "TracerHyperDiffTendencyEnable": False},
        "IOStreams": streams or {}}
    doc.update(extra)
    return doc


def perturbation(mesh, K):
    """tests/test_driver.py's wave in the initial ssh, and tracers."""
    x = np.asarray(mesh.x_cell)
    ssh = np.sin(2 * np.pi / mesh.x_period * x)
    tr = np.stack([10.0 + np.cos(2 * np.pi / mesh.x_period * x),
                   35.0 + 0.1 * np.sin(2 * np.pi / mesh.y_period
                                       * np.asarray(mesh.y_cell))])
    return ssh[:, None] / K, np.repeat(tr[:, :, None], K, axis=2)


def run_jax(doc, directory, perturb=True):
    m = jdrv.ocn_init(JConfig("Omega", copy.deepcopy(doc)),
                      directory=directory)
    if perturb:
        dh, tr = perturbation(m.mesh, m.model_cfg.nvertlayers)
        m.state = m.state._replace(h=m.state.h + jnp.asarray(dh),
                                   tracers=jnp.asarray(tr))
    return m, jdrv.ocn_finalize(jdrv.ocn_run(m))


def port_init(doc, directory, perturb=True, **kw):
    m = pdrv.ocn_init(PConfig("Omega", copy.deepcopy(doc)),
                      directory=directory, **{**F64, **kw})
    if perturb:
        dh, tr = perturbation(m.mesh, m.model_cfg.nvertlayers)
        m.state = m.state._replace(
            h=m.state.h + torch.as_tensor(dh, dtype=m.dtype),
            tracers=torch.as_tensor(tr, dtype=m.dtype))
    return m


def run_port(doc, directory, perturb=True, **kw):
    m = port_init(doc, directory, perturb, **kw)
    return m, pdrv.ocn_finalize(pdrv.ocn_run(m))


def assert_state_close(got, want, rtol=RTOL, atol=1e-12):
    for name, a, b in zip(("h", "u", "tracers"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


def assert_state_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def assert_files_close(pa, pj, skip_attrs=("model",)):
    a, b = read_netcdf(pa), j_read(pj)
    assert a.dims == b.dims
    assert sorted(a.variables) == sorted(b.variables)
    assert a.var_dims == b.var_dims and a.var_attrs == b.var_attrs
    assert ({k: v for k, v in a.attrs.items() if k not in skip_attrs}
            == {k: v for k, v in b.attrs.items() if k not in skip_attrs})
    for k in a.variables:
        np.testing.assert_allclose(a.variables[k], b.variables[k],
                                   rtol=RTOL, atol=1e-10, err_msg=k)


# ------------------------------------------------- one run, every stream

STREAMS = {
    "History": {"Filename": "ocn.hist.$SimTime", "Mode": "write",
                "IfExists": "replace", "Precision": "double", "Freq": 10,
                "FreqUnits": "minutes",
                "Contents": ["State", "SshCell", "Tracers"]},
    "Highfreq": {"Filename": "ocn.hifreq.$SimTime", "Mode": "write",
                 "Freq": 10, "FreqUnits": "minutes", "UseStartEnd": True,
                 "StartTime": "0001-01-01_00:15:00",
                 "EndTime": "0001-01-01_00:30:00", "Contents": ["SshCell"]},
    "Multi": {"Filename": "ocn.multi.$Y-$M-$D_$h.$m", "Mode": "write",
              "IfExists": "append", "Freq": 5, "FreqUnits": "minutes",
              "FileFreq": 15, "FileFreqUnits": "minutes",
              "Contents": ["SshCell"]},
    "Diag": {"Filename": "ocn.diag.$SimTime", "Mode": "write",
             "Precision": "single", "Freq": 15, "FreqUnits": "minutes",
             "Contents": ["Diagnostics"]},
    "RestartWrite": {"UsePointerFile": True, "PointerFilename": "ocn.pointer",
                     "Filename": "ocn.restart.$Y-$M-$D_$h.$m.$s",
                     "Mode": "write", "Precision": "double", "Freq": 15,
                     "FreqUnits": "minutes", "Contents": ["Restart"]},
    "RestartRead": {"UsePointerFile": True, "PointerFilename": "ocn.pointer",
                    "Mode": "read", "FreqUnits": "OnStartup",
                    "UseStartEnd": True,
                    "StartTime": "0001-01-01_00:00:01",
                    "EndTime": "9999-12-31_00:00:00",
                    "Contents": ["Restart"]},
}
ANALYSIS = {"Enabled": True, "Freq": 10, "FreqUnits": "minutes",
            "Filename": "energetics.csv"}


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    dj = str(tmp_path_factory.mktemp("jax_run"))
    dp = str(tmp_path_factory.mktemp("port_run"))
    doc = base_doc(streams=STREAMS, Analysis=ANALYSIS,
                   Eos={"EosType": "teos10"})
    mj, sj = run_jax(doc, dj)
    mp, sp = run_port(doc, dp)
    return dict(dj=dj, dp=dp, mj=mj, sj=sj, mp=mp, sp=sp)


def test_final_state_matches_jax(full_run):
    r = full_run
    assert r["mp"].step_count == r["mj"].step_count == 30
    assert str(r["mp"].clock.get_current_time()) == "0001-01-01_00:30:00"
    assert r["mp"].model_cfg.nvertlayers == 3
    assert r["mp"].tracers.names == r["mj"].tracers.names
    assert r["sp"].h.dtype == torch.float64
    assert_state_close(r["sp"], r["sj"])
    assert np.abs(r["sp"].u.numpy()).max() > 0
    area = r["mp"].mesh.area_cell[:, None]
    h0 = (r["mp"].mesh.bottom_depth[:, None] / 3 + torch.as_tensor(
        perturbation(r["mp"].mesh, 3)[0])).expand(-1, 3)
    vol0 = float((area * h0).sum())
    vol1 = float((area * r["sp"].h).sum())
    assert abs(vol1 - vol0) / vol0 < 1e-13


def test_output_files_match_jax(full_run):
    """The same files, each with the same dims, variables (1e-12),
    variable attributes and global attributes (the code's name aside)."""
    r = full_run
    files = sorted(os.listdir(r["dj"]))
    assert sorted(os.listdir(r["dp"])) == files
    hist = [f for f in files if f.startswith("ocn.hist.")]
    assert len(hist) == 3                               # 10, 20, 30 min
    for f in files:
        if f.endswith(".nc"):
            assert_files_close(os.path.join(r["dp"], f),
                               os.path.join(r["dj"], f))
    assert open(os.path.join(r["dp"], "ocn.pointer")).read() == \
        open(os.path.join(r["dj"], "ocn.pointer")).read()
    nc = read_netcdf(os.path.join(r["dp"], hist[-1]))
    assert nc.attrs["SimulationTime"].startswith("0001-01-01_00:30:00")
    assert nc.attrs["model"] == "omega_tpu_torch"
    np.testing.assert_array_equal(nc.get("LayerThickness")[0],
                                  r["sp"].h.numpy())


def test_use_start_end_window(full_run):
    """Start inclusive, end exclusive: of the rings at 10, 20, 30 only 20
    lies in [15, 30)."""
    files = [f for f in os.listdir(full_run["dp"])
             if f.startswith("ocn.hifreq")]
    assert len(files) == 1 and "00:20:00" in files[0]


def test_multiframe_stream(full_run):
    """FileFreq opens a new file on its own alarm; frames [5, 10] |
    [15, 20, 25] | [30]."""
    d = full_run["dp"]
    files = sorted(f for f in os.listdir(d) if f.startswith("ocn.multi"))
    frames = [read_netcdf(os.path.join(d, f)).get("SshCell").shape[0]
              for f in files]
    assert frames == [2, 3, 1]


def test_diagnostics_single_precision(full_run):
    d = full_run["dp"]
    files = sorted(f for f in os.listdir(d) if f.startswith("ocn.diag"))
    assert len(files) == 2
    nc = read_netcdf(os.path.join(d, files[0]))
    assert {"PressureMid", "ZMid", "SpecVol"} <= set(nc.variables)
    assert nc.get("SpecVol").dtype.itemsize == 4


def test_energetics_csv_matches_jax(full_run):
    r = full_run
    lj = open(os.path.join(r["dj"], "energetics.csv")).read().splitlines()
    lp = open(os.path.join(r["dp"], "energetics.csv")).read().splitlines()
    assert lp[0] == lj[0] and len(lp) == len(lj) == 5   # t = 0, 10, 20, 30
    for a, b in zip(lj[1:], lp[1:]):
        va, vb = a.split(","), b.split(",")
        assert va[0] == vb[0]
        np.testing.assert_allclose(np.float64(vb[1:]), np.float64(va[1:]),
                                   rtol=RTOL, atol=1e-6)


def test_restart_chain_bit_for_bit(full_run, tmp_path):
    """Job 1 (0-15 min) writes a restart through the pointer file; job 2
    (a continuation config starting at 15 min) reads it, resets the clock
    and runs to 30 min: bit for bit the unbroken port run, and the JAX
    package's unbroken run at 1e-12."""
    d = str(tmp_path)
    m1, _ = run_port(base_doc(stop="0001-01-01_00:15:00", streams=STREAMS,
                              Analysis=ANALYSIS, Eos={"EosType": "teos10"}),
                     d)
    assert os.path.exists(os.path.join(d, "ocn.pointer"))
    assert len([f for f in os.listdir(d) if "restart" in f]) == 1
    m2 = port_init(base_doc(streams=STREAMS, start="0001-01-01_00:15:00"),
                   d, perturb=False)
    assert str(m2.sim_start) == "0001-01-01_00:00:00"
    assert str(m2.clock.get_current_time()) == "0001-01-01_00:15:00"
    s2 = pdrv.ocn_finalize(pdrv.ocn_run(m2))
    assert str(m2.clock.get_current_time()) == "0001-01-01_00:30:00"
    assert_state_equal(s2, full_run["sp"])
    assert_state_close(s2, full_run["sj"])


def test_restart_chain_float32_bit_for_bit(tmp_path):
    """The restart is written in double precision: a float32 state goes
    through float64 and back exactly."""
    d = str(tmp_path)
    f32 = dict(dtype=torch.float32)
    _, ref = run_port(base_doc(), d, **f32)
    run_port(base_doc(stop="0001-01-01_00:15:00", streams=STREAMS), d,
             **f32)
    m2 = port_init(base_doc(streams=STREAMS, start="0001-01-01_00:15:00"),
                   d, perturb=False, **f32)
    s2 = pdrv.ocn_finalize(pdrv.ocn_run(m2))
    assert s2.h.dtype == torch.float32
    assert_state_equal(s2, ref)


# ------------------------------------------------------------- forcing

def _write_wind(path, ncells, frames, times):
    tz = np.asarray(frames)
    write_netcdf(path, dims={"Time": tz.shape[0], "nCells": ncells},
                 variables={"Time": np.asarray(times, np.float64),
                            "ZonalStressCell": tz,
                            "MeridionalStressCell": 0.5 * tz},
                 var_dims={"Time": ("Time",),
                           "ZonalStressCell": ("Time", "nCells"),
                           "MeridionalStressCell": ("Time", "nCells")},
                 unlimited="Time")


WIND_STREAM = {"WindForcing": {"Mode": "read", "Filename": "wind.nc",
                               "Freq": 5, "FreqUnits": "minutes",
                               "Contents": ["ZonalStressCell",
                                            "MeridionalStressCell"]}}
WIND_TEND = {"WindForcingTendencyEnable": True, "Density0": 1026.0}


def _wind_doc(**kw):
    doc = base_doc(stop="0001-01-01_00:20:00", **kw)
    doc["Tendencies"].update(WIND_TEND)
    return doc


@pytest.fixture(scope="module")
def wind_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("wind"))
    const = _wind_doc(WindStress={"ConstantZonal": 0.1,
                                  "ConstantMeridional": 0.05})
    ramp = _wind_doc(streams=WIND_STREAM)
    _write_wind(os.path.join(d, "wind.nc"), 64,
                [0.0 * np.ones(64), 0.2 * np.ones(64)], [0.0, 1200.0])
    _, cj = run_jax(const, d)
    _, rj = run_jax(ramp, d)
    return d, const, ramp, cj, rj


def test_constant_wind_matches_jax(wind_runs):
    d, const, _, cj, _ = wind_runs
    m, cp = run_port(const, d)
    assert m.wind_stress is not None and m.wind_forcing is None
    assert_state_close(cp, cj)
    assert np.abs(cp.u.numpy()).max() > 0


def test_time_varying_wind_matches_jax(wind_runs):
    d, _, ramp, _, rj = wind_runs
    m = port_init(ramp, d)
    assert m.wind_forcing is not None
    wz0, wm0 = pdrv._wind_at(m, 0.0)
    wz6, _ = pdrv._wind_at(m, 600.0)
    assert np.allclose(wz0, 0.0) and np.allclose(wz6, 0.1)
    rp = pdrv.ocn_finalize(pdrv.ocn_run(m))
    assert_state_close(rp, rj)


def test_wind_stream_of_identical_frames_is_the_constant(tmp_path):
    d = str(tmp_path)
    _write_wind(os.path.join(d, "wind.nc"), 64, [0.1 * np.ones(64)] * 2,
                [0.0, 600.0])
    _, a = run_port(_wind_doc(WindStress={"ConstantZonal": 0.1,
                                          "ConstantMeridional": 0.05}), d)
    _, b = run_port(_wind_doc(streams=WIND_STREAM), d)
    assert_state_equal(a, b)


def test_pstar_driver_run_matches_jax(tmp_path):
    """VertCoord.PStarEnable wraps the stepper (composed steps, as in the
    JAX package): tests/test_vertical.py's configuration."""
    doc = base_doc(stop="0001-01-01_00:10:00", SshFormulation="Column")
    doc["TimeIntegration"]["TimeStep"] = "0000_00:00:30"
    doc["Mesh"]["Generate"].update(Nx=12, Ny=12, Dc=5000.0)
    doc["VertCoord"] = {"NVertLayers": 4, "PStarEnable": True,
                        "MovementWeightType": "Uniform"}
    doc["Tendencies"] = {"ViscDel2": 1.0e3,
                         "VelHyperDiffTendencyEnable": False,
                         "TracerDiffTendencyEnable": False,
                         "TracerHyperDiffTendencyEnable": False}
    _, sj = run_jax(doc, str(tmp_path))
    m, sp = run_port(doc, str(tmp_path))
    assert m.stepper is not pdrv.make_stepper("Forward-Backward")
    assert_state_close(sp, sj, atol=1e-11)
    area = m.mesh.area_cell[:, None]
    h0 = (m.mesh.bottom_depth[:, None] / 4 + torch.as_tensor(
        perturbation(m.mesh, 4)[0])).expand(-1, 4)
    assert abs(float((area * sp.h).sum()) / float((area * h0).sum())
               - 1.0) < 1e-12
    with pytest.raises(ConfigError):
        doc2 = copy.deepcopy(doc)
        doc2["SshFormulation"] = "Stacked"
        port_init(doc2, str(tmp_path))


def test_initial_vert_coord_stream_matches_jax(tmp_path):
    """InitialVertCoord: 1-based layer bounds and the bottom depth from a
    file override the mesh; the uniform-scalar table follows."""
    d = str(tmp_path)
    C, K = 64, 3
    min_c = np.ones(C, np.int32)
    max_c = np.full(C, K, np.int32)
    max_c[:10] = 2
    min_c[5:8] = 2
    depth = np.full(C, 800.0)
    depth[:10] = 400.0
    write_netcdf(os.path.join(d, "vcoord.nc"), dims={"nCells": C},
                 variables={"minLevelCell": min_c, "maxLevelCell": max_c,
                            "bottomDepth": depth},
                 var_dims={k: ("nCells",) for k in
                           ("minLevelCell", "maxLevelCell", "bottomDepth")})
    doc = base_doc(stop="0001-01-01_00:05:00", streams={"InitialVertCoord": {
        "Filename": "vcoord.nc", "Mode": "read", "FreqUnits": "OnStartup",
        "Contents": ["InitVertCoord"]}})
    mj = jdrv.ocn_init(JConfig("Omega", copy.deepcopy(doc)), directory=d)
    mp = port_init(doc, d, perturb=False)
    for a, b in zip(mp.layer_bounds, mj.layer_bounds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(mp.mesh.bottom_depth.numpy(), depth)
    assert dict(mp.mesh.structured_scalars).get("bottom_depth") is None
    assert_state_close(mp.state, mj.state)
    np.testing.assert_allclose(mp.state.h[20].numpy(), 800.0 / K)
    assert mp.state.h[0, 2] == 0.0 and mp.state.h[6, 0] == 0.0
    # the empty layers' tracers come out NaN (0 / 0) in both packages
    assert_state_close(pdrv.ocn_finalize(pdrv.ocn_run(mp)),
                       jdrv.ocn_finalize(jdrv.ocn_run(mj)))


# ------------------------------------------------------------ the sphere

def _sphere_doc(patch, flagship, stop="0001-01-01_00:10:00", streams=None):
    doc = base_doc(stop=stop, streams=streams)
    doc["Mesh"] = {"Generate": {"Kind": "sphere", "Subdivisions": 8,
                                "BottomDepth": 1000.0,
                                "PatchLayout": patch}}
    if flagship:
        doc["Tendencies"].update(
            VelDiffTendencyEnable=True, ViscDel2=1.0e3,
            VelHyperDiffTendencyEnable=True, ViscDel4=1.0e7,
            TracerDiffTendencyEnable=True, EddyDiff2=10.0,
            TracerHyperDiffTendencyEnable=True, EddyDiff4=1.0e7)
    return doc


def _sphere_run(doc, d):
    m = pdrv.ocn_init(PConfig("Omega", copy.deepcopy(doc)), directory=d,
                      **F64)
    ssh = torch.sin(2 * m.mesh.lat_cell) * torch.cos(m.mesh.lon_cell)
    m.state = m.state._replace(h=m.state.h + ssh[:, None] / 3)
    mesh = m.mesh
    return mesh, m, pdrv.ocn_finalize(pdrv.ocn_run(m))


@pytest.mark.parametrize("flagship", [False, True],
                         ids=["composed", "framed"])
def test_patch_layout_matches_plain_sphere(tmp_path, flagship):
    """Mesh.Generate.PatchLayout renumbers the icos mesh onto the patch
    lattice (the framed fused path where the configuration allows it, its
    plain versions on the CPU); the physics matches the plain generator's
    sphere cell for cell, matched by coordinates (tests/test_driver.py's
    atol 1e-11)."""
    from omega_tpu_torch.ops import patch_megastep
    d = str(tmp_path)
    ma, mod_a, sa = _sphere_run(_sphere_doc(True, flagship), d)
    assert ma.patch_info is not None
    assert patch_megastep.supported(ma, mod_a.model_cfg,
                                    framed=True) == flagship
    mb, _, sb = _sphere_run(_sphere_doc(False, flagship), d)
    assert mb.patch_info is None

    def key(m):
        return {(round(float(la), 9), round(float(lo), 9)): i
                for i, (la, lo) in enumerate(zip(m.lat_cell.numpy(),
                                                 m.lon_cell.numpy()))}
    ka, kb = key(ma), key(mb)
    rows_a = [ka[k] for k in kb]
    np.testing.assert_allclose(sa.h.numpy()[rows_a], sb.h.numpy(), rtol=0,
                               atol=1e-11)
    assert np.abs(sa.u.numpy()).max() > 0


def test_sharded_patch_layout_bit_for_bit(tmp_path):
    """Decomp.Method patch with 2 and 5 shards on the PatchLayout icos8
    (whole patches a shard, their kernels' plain versions on the CPU):
    bit for bit the unsharded framed run."""
    d = str(tmp_path)
    _, _, ref = _sphere_run(_sphere_doc(True, True), d)
    for n in (2, 5):
        doc = dict(_sphere_doc(True, True),
                   Decomp={"NShards": n, "Method": "patch"})
        _, m, out = _sphere_run(doc, d)
        assert m._decomp[0] == "patch"
        assert_state_equal(out, ref)


def test_framed_sphere_segments_equal_run_steps(tmp_path):
    """The driver's segments are run_steps calls: the same segments of
    run_steps give the driver's state bit for bit."""
    from omega_tpu_torch.stepping import run_steps
    doc = _sphere_doc(True, True, stop="0001-01-01_00:06:00", streams={
        "H": {"Filename": "h.$SimTime", "Mode": "write", "Freq": 3,
              "FreqUnits": "minutes", "Contents": ["SshCell"]}})
    m = pdrv.ocn_init(PConfig("Omega", copy.deepcopy(doc)),
                      directory=str(tmp_path), **F64)
    ssh = torch.sin(2 * m.mesh.lat_cell) * torch.cos(m.mesh.lon_cell)
    s0 = m.state._replace(h=m.state.h + ssh[:, None] / 3)
    m.state = s0
    out = pdrv.ocn_finalize(pdrv.ocn_run(m))
    ref = run_steps(m.mesh, m.model_cfg, s0, 0.0, 60.0, 3)
    ref = run_steps(m.mesh, m.model_cfg, ref, 180.0, 60.0, 3)
    assert_state_equal(out, ref)


@pytest.mark.parametrize("changed", [True, False])
def test_changed_bottom_depth_drops_patch_layout(tmp_path, changed):
    """The patch tables and weights are built from the host mesh's depth:
    a BottomDepth that differs from it sends the mesh to the general path
    (patch_info None); an unchanged one keeps the layout."""
    d = str(tmp_path)
    host = pdrv._build_mesh(PConfig("Omega", _sphere_doc(True, True)), d)
    depth = np.asarray(host.bottom_depth, np.float64).copy()
    if changed:
        depth[::7] = 900.0
    C, K = host.ncells, 3
    write_netcdf(os.path.join(d, "vcoord.nc"), dims={"nCells": C},
                 variables={"minLevelCell": np.ones(C, np.int32),
                            "maxLevelCell": np.full(C, K, np.int32),
                            "bottomDepth": depth},
                 var_dims={k: ("nCells",) for k in
                           ("minLevelCell", "maxLevelCell", "bottomDepth")})
    doc = _sphere_doc(True, True, streams={"InitialVertCoord": {
        "Filename": "vcoord.nc", "Mode": "read", "FreqUnits": "OnStartup",
        "Contents": ["InitVertCoord"]}})
    m = pdrv.ocn_init(PConfig("Omega", doc), directory=d, **F64)
    np.testing.assert_array_equal(m.mesh.bottom_depth.numpy(), depth)
    assert (m.mesh.patch_info is None) == changed
    from omega_tpu_torch.ops import patch_megastep
    assert patch_megastep.supported(m.mesh, m.model_cfg,
                                    framed=True) == (not changed)
    out = pdrv.ocn_finalize(pdrv.ocn_run(m))
    assert all(bool(torch.isfinite(x).all()) for x in out)


# ------------------------------------------------- refusals, entry points

@pytest.mark.parametrize("decomp,at", [
    ({"Method": "metis"}, "init"), ({"HaloWidth": 0}, "init"),
    ({"NShards": 0}, "init"), ({"NShards": 2, "Method": "patch"}, "run"),
    ({"NShards": 3, "Method": "structured"}, "run")])
def test_multi_device_configuration_raises(tmp_path, decomp, at):
    """The Decomp group's checks (the JAX driver's): an unknown method, a
    halo width or shard count below 1 at init; at the first ocn_run the
    patch method off a PatchLayout sphere, and a structured decomposition
    with no valid block layout (3 row bands of the 8 x 8 mesh)."""
    doc = base_doc(Decomp=decomp)
    if at == "init":
        with pytest.raises(ConfigError, match="Decomp"):
            pdrv.ocn_init(PConfig("Omega", doc), directory=str(tmp_path),
                          **F64)
        return
    m = pdrv.ocn_init(PConfig("Omega", doc), directory=str(tmp_path), **F64)
    with pytest.raises((ConfigError, ValueError), match="patch|layout"):
        pdrv.ocn_run(m)


@pytest.mark.parametrize("method", ["structured", "sfc"])
def test_sharded_run_bit_for_bit(tmp_path, method):
    """Decomp.NShards 4 (every shard on the CPU): the state after the run
    and the History files equal the unsharded run's bit for bit, for the
    structured blocks and the SFC decomposition."""
    d1, d2 = str(tmp_path / "one"), str(tmp_path / "four")
    os.makedirs(d1)
    os.makedirs(d2)
    _, ref = run_port(base_doc(streams={"History": STREAMS["History"]}), d1)
    m, out = run_port(base_doc(streams={"History": STREAMS["History"]},
                               Decomp={"NShards": 4, "Method": method}), d2)
    assert m._decomp[0] == method and not m._state_is_sharded
    assert_state_equal(out, ref)
    for f in sorted(os.listdir(d1)):
        a, b = read_netcdf(os.path.join(d1, f)), read_netcdf(
            os.path.join(d2, f))
        for k in a.variables:
            assert np.array_equal(a.variables[k], b.variables[k]), (f, k)


def test_sharded_pstar_runs_on_sfc(tmp_path):
    """p-star under sharding: the phase per shard on the SFC
    decomposition (the halo widened to 4), against the unsharded p-star
    run at 1e-12; an explicit structured method is refused."""
    doc = base_doc(stop="0001-01-01_00:05:00", SshFormulation="Column")
    doc["TimeIntegration"]["TimeStep"] = "0000_00:00:30"
    doc["Mesh"]["Generate"].update(Nx=12, Ny=12, Dc=5000.0)
    doc["VertCoord"] = {"NVertLayers": 4, "PStarEnable": True,
                        "MovementWeightType": "Uniform"}
    doc["Tendencies"] = {"ViscDel2": 1.0e3,
                         "VelHyperDiffTendencyEnable": False,
                         "TracerDiffTendencyEnable": False,
                         "TracerHyperDiffTendencyEnable": False}
    _, ref = run_port(doc, str(tmp_path))
    m, out = run_port(dict(doc, Decomp={"NShards": 4}), str(tmp_path))
    assert m._decomp[0] == "sfc" and m.halo_width == 4
    assert_state_close(out, ref, rtol=1e-12, atol=1e-12)
    m2 = port_init(dict(doc, Decomp={"NShards": 4, "Method": "structured"}),
                   str(tmp_path))
    with pytest.raises(ConfigError, match="PStarEnable"):
        pdrv.ocn_run(m2)


def test_single_device_decomp_group_accepted(tmp_path):
    m = pdrv.ocn_init(PConfig("Omega", base_doc(
        Decomp={"NShards": 1, "Method": "auto", "HaloWidth": 3,
                "DecompMethod": "SFC"})), directory=str(tmp_path), **F64)
    assert m.state.h.shape == (64, 3)


def test_main_runs_on_the_cpu(tmp_path):
    import yaml
    d = str(tmp_path)
    doc = {"Omega": base_doc(stop="0001-01-01_00:05:00", streams={
        "History": dict(STREAMS["History"], Freq=5)})}
    path = os.path.join(d, "omega.yml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    assert pdrv.main(["--config", path, "--dir", d, "--device", "cpu",
                      "--dtype", "float64"]) == 0
    files = [f for f in os.listdir(d) if f.startswith("ocn.hist.")]
    assert len(files) == 1
    assert read_netcdf(os.path.join(d, files[0])).get(
        "LayerThickness").dtype.itemsize == 8


def test_ocn_init_defaults_to_cuda(tmp_path):
    cfg = PConfig("Omega", base_doc())
    if torch.cuda.is_available():
        m = pdrv.ocn_init(cfg, directory=str(tmp_path))
        assert m.state.h.is_cuda and m.state.h.dtype == torch.float32
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pdrv.ocn_init(cfg, directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        pdrv.main(["--config", "nowhere.yml"])


def test_default_config_needs_a_mesh(tmp_path):
    with pytest.raises(ConfigError, match="Mesh"):
        pdrv.ocn_init(directory=str(tmp_path), **F64)
    doc = base_doc()
    doc["Mesh"] = {"Generate": {"Kind": "torus"}}
    with pytest.raises(ConfigError):
        pdrv.ocn_init(PConfig("Omega", doc), directory=str(tmp_path), **F64)


def test_mesh_from_file_matches_jax(tmp_path):
    """Mesh.MeshFileName reads an MPAS file (relative to the run
    directory) into an unstructured mesh; the run matches the JAX
    driver's on the same file."""
    from omega_tpu_torch.mesh.mpas_io import write_mpas_mesh
    d = str(tmp_path)
    doc = base_doc(stop="0001-01-01_00:05:00")
    host = pdrv._build_mesh(PConfig("Omega", doc), d)
    write_mpas_mesh(host, os.path.join(d, "mesh.nc"))
    doc["Mesh"] = {"MeshFileName": "mesh.nc"}
    _, sj = run_jax(doc, d)
    m, sp = run_port(doc, d)
    assert m.mesh.structured_nx == 0
    assert_state_close(sp, sj)
