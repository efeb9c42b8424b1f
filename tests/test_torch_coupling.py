"""The port's coupled-mode component (omega_tpu_torch/coupling.py) against
the JAX package's, float64 on the CPU, mirroring tests/test_coupling.py:
the cell-velocity reconstruction (exact for uniform flow; on icos8 equal to
the JAX package's at 1e-12); four coupling intervals with wind imports
against one uninterrupted run (1e-12, and the JAX component's at 1e-12);
the import checks; and with Decomp.NShards the state kept sharded across
intervals, the exports computed from owned rows without a global gather,
equal to the one-shard run's at 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omega_tpu.coupling import OmegaComponent as JComponent
from omega_tpu.coupling import reconstruct_cell_velocity as jrecon
from omega_tpu.infra.config import Config as JConfig
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere

from omega_tpu_torch.coupling import (OmegaComponent,
                                      reconstruct_cell_velocity)
from omega_tpu_torch.infra.config import Config as PConfig
from omega_tpu_torch.mesh import planar_hex_mesh, spherical_icos_mesh

F64 = dict(device="cpu", dtype=torch.float64)
IMPORTS = {"zonal_wind_stress": 0.05, "merid_wind_stress": 0.01}


def test_reconstruct_uniform_flow_exact():
    mesh = planar_hex_mesh(16, 16, dc=1000.0).to("cpu", torch.float64)
    V = np.array([0.3, -0.7])
    ang = mesh.angle_edge.numpy()
    un = torch.as_tensor(V[0] * np.cos(ang) + V[1] * np.sin(ang))[:, None]
    uz, vm = reconstruct_cell_velocity(mesh, un)
    np.testing.assert_allclose(uz.numpy(), V[0], rtol=1e-12)
    np.testing.assert_allclose(vm.numpy(), V[1], rtol=1e-12)


def test_reconstruct_sphere_against_jax():
    """Solid-body rotation on icos8: the JAX package's reconstruction at
    1e-12, within a few percent of the zonal flow (the 12 pentagons
    worst)."""
    js, ps = jsphere(8), spherical_icos_mesh(8).to("cpu", torch.float64)
    un = (np.cos(np.asarray(js.lat_edge))
          * np.cos(np.asarray(js.angle_edge)))[:, None]
    uz, vm = reconstruct_cell_velocity(ps, torch.as_tensor(un))
    juz, jvm = jrecon(js, jnp.asarray(un))
    np.testing.assert_allclose(uz.numpy(), np.asarray(juz), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(vm.numpy(), np.asarray(jvm), rtol=1e-12,
                               atol=1e-14)
    assert np.abs(uz.numpy()[:, 0] - np.cos(ps.lat_cell.numpy())).max() < 0.1


def _doc(stop_minutes=40, **extra):
    """tests/test_coupling.py's coupled configuration (16 x 16, wind,
    drag, del2)."""
    doc = {
        "TimeIntegration": {
            "CalendarType": "No Leap", "TimeStepper": "Forward-Backward",
            "TimeStep": "0000_00:02:00",
            "StartTime": "0001-01-01_00:00:00",
            "StopTime": f"0001-01-01_00:{stop_minutes}:00",
            "RunDuration": "none"},
        "Mesh": {"Generate": {"Kind": "planar", "Nx": 16, "Ny": 16,
                              "Dc": 5000.0, "F0": 1.0e-4,
                              "BottomDepth": 1000.0}},
        "VertCoord": {"NVertLayers": 3},
        "Tracers": {"Base": ["Temperature", "Salinity"]},
        "Tendencies": {
            "WindForcingTendencyEnable": True,
            "BottomDragTendencyEnable": True, "BottomDragCoeff": 1.0e-3,
            "VelDiffTendencyEnable": True, "ViscDel2": 1.0e3,
            "VelHyperDiffTendencyEnable": False,
            "TracerDiffTendencyEnable": False,
            "TracerHyperDiffTendencyEnable": False},
        "IOStreams": {}}
    doc.update(extra)
    return doc


def test_intervals_match_uninterrupted_run(tmp_path):
    """Four 10-minute intervals with constant wind imports: the state of
    one 40-minute run with the same constant wind (1e-12), the clock on
    StopTime, exports consistent with the final state, and the JAX
    component's exports at 1e-12."""
    d = str(tmp_path)
    comp = OmegaComponent(config=PConfig("Omega", _doc()), directory=d, **F64)
    for _ in range(4):
        ex = comp.run(600.0, IMPORTS)
    assert comp.clock_time.startswith("0001-01-01_00:40:00")
    state_c = comp.finalize()

    from omega_tpu_torch.driver import ocn_finalize, ocn_init, ocn_run
    model = ocn_init(PConfig("Omega", _doc(WindStress={
        "InterpType": "Isotropic", "ConstantZonal": 0.05,
        "ConstantMeridional": 0.01})), directory=d, **F64)
    state_r = ocn_finalize(ocn_run(model))
    for a, b in zip(state_c, state_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    assert set(ex) == {"ssh", "sst", "sss", "u_zonal", "v_merid"}
    np.testing.assert_allclose(ex["ssh"], state_c.h.sum(1).numpy() - 1000.0,
                               atol=1e-10)
    assert np.abs(ex["u_zonal"]).max() > 0

    jcomp = JComponent(config=JConfig("Omega", _doc()), directory=d)
    for _ in range(4):
        jex = jcomp.run(600.0, IMPORTS)
    for k in jex:
        np.testing.assert_allclose(ex[k], np.asarray(jex[k]), rtol=0,
                                   atol=1e-12, err_msg=k)


def test_import_validation(tmp_path):
    doc = _doc()
    doc["Tendencies"]["WindForcingTendencyEnable"] = False
    comp = OmegaComponent(config=PConfig("Omega", doc), directory=str(
        tmp_path), **F64)
    with pytest.raises(ValueError, match="WindForcing"):
        comp.run(600.0, {"zonal_wind_stress": 0.05})
    with pytest.raises(ValueError, match="unknown import"):
        comp.run(600.0, {"sea_ice_fraction": 0.5})
    comp.run(600.0)          # no imports: plain advance works
    assert comp.clock_time.startswith("0001-01-01_00:10:00")


@pytest.mark.parametrize("method", ["sfc", "structured"])
def test_sharded_exports_no_gather(tmp_path, method):
    """NShards = 4: the state stays a list of shards across two coupling
    intervals (the gather is never called), and the owned-row exports
    equal the one-shard run's at 1e-12 (tests/test_coupling.py:137)."""
    d = str(tmp_path)
    comp = OmegaComponent(config=PConfig("Omega", _doc(
        20, Decomp={"NShards": 4, "Method": method})), directory=d, **F64)
    ex4 = comp.run(600.0, IMPORTS)
    model = comp.model
    assert model._state_is_sharded and isinstance(model.state, list)
    assert len(model.state) == 4 and model._decomp[0] == method

    def no_gather(st):
        raise AssertionError("the exports gathered the state")
    real_gather, model._gather = model._gather, no_gather
    ex4b = comp.run(600.0, IMPORTS)
    assert model._state_is_sharded
    model._gather = real_gather
    comp.finalize()

    comp1 = OmegaComponent(config=PConfig("Omega", _doc(20)), directory=d,
                           **F64)
    ex1 = comp1.run(600.0, IMPORTS)
    ex1b = comp1.run(600.0, IMPORTS)
    assert set(ex4) == set(ex1)
    for k in ex1:
        np.testing.assert_allclose(ex4[k], ex1[k], rtol=0, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(ex4b[k], ex1b[k], rtol=0, atol=1e-12,
                                   err_msg=k)
