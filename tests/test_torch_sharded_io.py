"""The port's sharded IO (io/stream.ShardedFieldData, io/netcdf.
write_sharded_frame and RegionReader, the driver's ShardedIO) on the CPU,
float64, mirroring tests/test_sharded_io.py: region writes of per-shard
owned rows reassemble the global array in both formats (NetCDF3 through a
memory map at the variable's offset, HDF5 through h5py), the JAX
package's readers agree; RegionReader pulls exactly the requested rows of
the latest frame in both formats; the restart chain through the deferred
region read (the state never global on the host) bit for bit the unbroken
run; and a ShardedIO driver run's History and Restart files equal the
gathered run's in both formats and the JAX package's ShardedIO run's
(1e-12)."""

import copy
import os

import numpy as np
import pytest
import torch


from omega_tpu.io.netcdf import RegionReader as JRegionReader
from omega_tpu.io.netcdf import read_netcdf as j_read

from omega_tpu_torch import driver as pdrv
from omega_tpu_torch.infra.config import Config as PConfig
from omega_tpu_torch.io.netcdf import (RegionReader, append_netcdf,
                                       read_netcdf, write_netcdf,
                                       write_sharded_frame)
from omega_tpu_torch.io.stream import ShardedFieldData

from test_torch_driver import base_doc, perturbation, run_port

FMTS = ["netcdf3", "hdf5"]


def _shards(C=40, K=3, S=4, seed=1):
    """Shard s owns rows [10s, 10s+10) of a local window [10s-2, 10s+12),
    wrapped (tests/test_sharded_io.py's overlapping halos)."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((C, K))
    l2g = np.stack([(10 * s - 2 + np.arange(14)) % C for s in range(S)])
    owned = np.zeros((S, 14), bool)
    owned[:, 2:12] = True
    local = [torch.as_tensor(np.where(owned[s][:, None], full[l2g[s]],
                                      -1.0)) for s in range(S)]
    return full, ShardedFieldData(local, l2g, owned, C)


@pytest.mark.parametrize("fmt", FMTS)
def test_region_writes_reassemble(tmp_path, fmt):
    """Two frames of region writes (NetCDF3: each into the zero record
    the frame was written with) read back as the global arrays, by the
    port's reader and the JAX package's."""
    full, sfd = _shards()
    back = np.zeros_like(full)
    for rows, vals in sfd.iter_owned():
        back[rows] = vals
    assert np.array_equal(back, full)
    assert sfd.global_shape == (40, 3) and sfd.dtype == np.float64
    path = str(tmp_path / f"sh.{fmt}")
    frames = [full, 2.0 * full]
    for i, want in enumerate(frames):
        sfd_i = ShardedFieldData([2.0 ** i * x for x in sfd.shards],
                                 sfd.l2g, sfd.owned, 40)
        var = dict(vdims=("C", "K"), shape=(40, 3), dtype=np.float64,
                   shards=sfd_i.iter_owned(), time_dependent=True)
        zero = {} if fmt == "hdf5" else {"x": np.zeros((1, 40, 3))}
        vd = {} if fmt == "hdf5" else {"x": ("Time", "C", "K")}
        if i == 0:
            write_netcdf(path, dims={"Time": 1, "C": 40, "K": 3},
                         variables=zero, var_dims=vd,
                         attrs={"SimulationTime": "t0"}, fmt=fmt,
                         unlimited="Time")
        elif zero:
            assert append_netcdf(path, variables=zero, var_dims=vd,
                                 attrs={"SimulationTime": "t1"})
        write_sharded_frame(path, {"x": var})
    for nc in (read_netcdf(path), j_read(path)):
        got = np.asarray(nc.get("x"))
        assert got.shape == (2, 40, 3)
        for i, want in enumerate(frames):
            assert np.array_equal(got[i], want)


@pytest.mark.parametrize("fmt", FMTS)
def test_region_reader_rows(tmp_path, fmt):
    """RegionReader reads exactly the requested rows (duplicates and any
    order) of the latest frame, and a static variable's rows, as the JAX
    package's RegionReader does on the same file."""
    rng = np.random.default_rng(7)
    C, K = 30, 4
    x0, x1 = rng.standard_normal((2, C, K))
    static = rng.standard_normal((C,))
    path = str(tmp_path / f"rr.{fmt}")
    write_netcdf(path, dims={"Time": 1, "C": C, "K": K},
                 variables={"x": x0[None], "s": static},
                 var_dims={"x": ("Time", "C", "K"), "s": ("C",)},
                 attrs={"SimulationTime": "t0"}, unlimited="Time", fmt=fmt)
    append_netcdf(path, variables={"x": x1[None]},
                  var_dims={"x": ("Time", "C", "K")},
                  attrs={"SimulationTime": "t1"}, unlimited="Time")
    rows = np.array([17, 3, 3, 29, 0])
    with RegionReader(path) as r, JRegionReader(path) as j:
        assert r.attrs["SimulationTime"] == "t1" == j.attrs["SimulationTime"]
        assert r.has("x") and not r.has("nope")
        assert r.var_dims("x") == j.var_dims("x")
        for v, want in (("x", x1[rows]), ("s", static[rows])):
            got = r.read_rows(v, rows)
            assert np.array_equal(got, want)
            assert np.array_equal(got, j.read_rows(v, rows))


RESTART = {
    "RestartWrite": {"Filename": "restart.$SimTime", "Mode": "write",
                     "UsePointerFile": True,
                     "PointerFilename": "ocn.pointer", "IfExists": "replace",
                     "Freq": 10, "FreqUnits": "minutes",
                     "Contents": ["Restart"]},
    "RestartRead": {"Mode": "read", "UsePointerFile": True,
                    "PointerFilename": "ocn.pointer", "Freq": 1,
                    "FreqUnits": "OnStartup", "Contents": ["Restart"]}}


def _sharded_doc(stop, streams, fmt, **decomp):
    streams = copy.deepcopy(streams)
    for s in streams.values():
        if s["Mode"] == "write":
            s["Format"] = fmt
    doc = base_doc(stop=stop, streams=streams)
    doc["Mesh"]["Generate"].update(Nx=8, Ny=16)
    doc["Decomp"] = {"NShards": 4, "ShardedIO": True,
                     "Method": "structured", **decomp}
    return doc


@pytest.mark.parametrize("fmt", FMTS)
def test_region_read_restart_chain(tmp_path, fmt):
    """Run 1 writes sharded restarts; run 2 (ShardedIO, structured) leaves
    the state unread at init and region-reads each shard's rows in ocn_run;
    the chain equals an unbroken sharded run bit for bit."""
    d = str(tmp_path)
    m1 = pdrv.ocn_init(PConfig("Omega", _sharded_doc(
        "0001-01-01_00:20:00", RESTART, fmt)), directory=d, device="cpu",
        dtype=torch.float64)
    assert m1._deferred_state_stream is None     # no pointer file yet
    dh, tr = perturbation(m1.mesh, 3)
    st0 = m1.state._replace(h=m1.state.h + torch.as_tensor(dh),
                            tracers=torch.as_tensor(tr))
    m1.state = st0
    pdrv.ocn_finalize(pdrv.ocn_run(m1))
    m2 = pdrv.ocn_init(PConfig("Omega", _sharded_doc(
        "0001-01-01_00:40:00", RESTART, fmt)), directory=d, device="cpu",
        dtype=torch.float64)
    assert m2._deferred_state_stream == "RestartRead"
    assert m2.state is None                      # nothing global on host
    assert str(m2.clock.get_current_time()) == "0001-01-01_00:20:00"
    chain = pdrv.ocn_finalize(pdrv.ocn_run(m2))
    ctl_dir = os.path.join(d, "ctl")
    os.makedirs(ctl_dir)
    mc = pdrv.ocn_init(PConfig("Omega", _sharded_doc(
        "0001-01-01_00:40:00", RESTART, fmt)), directory=ctl_dir,
        device="cpu", dtype=torch.float64)
    mc.state = st0
    ctl = pdrv.ocn_finalize(pdrv.ocn_run(mc))
    assert all(torch.equal(a, b) for a, b in zip(chain, ctl))


HISTORY = {"History": {"Filename": "hist.$SimTime", "Mode": "write",
                       "IfExists": "replace", "Freq": 10,
                       "FreqUnits": "minutes", "Precision": "double",
                       "Contents": ["State", "SshCell", "Tracers"]},
           "RestartWrite": RESTART["RestartWrite"]}


@pytest.fixture(scope="module")
def jax_sharded_io(tmp_path_factory):
    """The JAX package's ShardedIO run of the same configuration (its
    streams go to HDF5), once."""
    from omega_tpu import driver as jdrv
    from omega_tpu.infra.config import Config as JConfig
    import jax.numpy as jnp
    d = str(tmp_path_factory.mktemp("jax_sharded_io"))
    doc = _sharded_doc("0001-01-01_00:20:00", HISTORY, "hdf5")
    doc["Decomp"].pop("Method")
    m = jdrv.ocn_init(JConfig("Omega", doc), directory=d)
    dh, tr = perturbation(m.mesh, 3)
    m.state = m.state._replace(h=m.state.h + jnp.asarray(dh),
                               tracers=jnp.asarray(tr))
    jdrv.ocn_finalize(jdrv.ocn_run(m))
    return d


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("method", ["structured", "sfc"])
def test_driver_sharded_io_matches_gathered(tmp_path, fmt, method,
                                            jax_sharded_io):
    """History and Restart written shard by shard equal the gathered run's
    files (every variable bit for bit) and the JAX package's ShardedIO
    run's (1e-12)."""
    d1, d2 = str(tmp_path / "sharded"), str(tmp_path / "gathered")
    os.makedirs(d1)
    os.makedirs(d2)
    doc = _sharded_doc("0001-01-01_00:20:00", HISTORY, fmt, Method=method)
    _, out = run_port(doc, d1)
    doc2 = copy.deepcopy(doc)
    doc2["Decomp"]["ShardedIO"] = False
    _, ref = run_port(doc2, d2)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    files = sorted(f for f in os.listdir(d1) if not f.endswith("pointer"))
    assert files == sorted(f for f in os.listdir(d2)
                           if not f.endswith("pointer"))
    assert len(files) == 4
    for f in files:
        a, b = read_netcdf(os.path.join(d1, f)), read_netcdf(
            os.path.join(d2, f))
        assert sorted(a.variables) == sorted(b.variables)
        for k in a.variables:
            assert np.array_equal(a.variables[k], b.variables[k]), (f, k)
        j = j_read(os.path.join(jax_sharded_io, f))
        for k in ("LayerThickness", "NormalVelocity", "Temperature",
                  "Salinity"):
            np.testing.assert_allclose(a.variables[k], np.asarray(j.get(k)),
                                       rtol=1e-12, atol=1e-10, err_msg=k)
