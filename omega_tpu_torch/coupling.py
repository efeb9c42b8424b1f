"""Coupled-mode component interface (the E3SM coupler analogue).

The reference is designed to run as an E3SM component — `MachEnv::init`
accepts a coupler-supplied communicator (base/MachEnv.h:136-142) and the
Omega-2 roadmap is the coupled configuration — but its own MCT/MOAB wiring
does not exist yet (SURVEY.md section 2.5). This module is the equivalent
of that component contract: a host "coupler" (atmosphere model, test
harness, ESM driver) constructs an `OmegaComponent`, then alternates

    exports = comp.run(coupling_interval_seconds, imports)

calls with its own physics. Imports/exports are plain global cell arrays
(the attribute-vector analogue); the component advances its own
exact-rational clock, fires its IO streams, and keeps the driver's run
context (the sharded step, when Decomp.NShards > 1) across intervals.

Import fields (all optional, (ncells,) float):
  zonal_wind_stress / merid_wind_stress   [N m-2] surface stress
    (requires Tendencies.WindForcingTendencyEnable in the config)

Export fields ((ncells,) host numpy):
  ssh            sea surface height = sum_k h_k - bottom_depth  [m]
  sst / sss      surface Temperature / Salinity (when in the catalog)
  u_zonal, v_merid   surface velocity reconstructed at cell centers
  frazil/melt fluxes etc. have no analogue in the layered SW core.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional

import numpy as np
import torch

from omega_tpu_torch.driver import column_ssh
from omega_tpu_torch.infra.time_manager import Alarm, TimeInterval
from omega_tpu_torch.mesh.horz_mesh import unclamped_connectivity
from omega_tpu_torch.ops import trisk
from omega_tpu_torch.parallel.decomp import host, host_mesh


def reconstruct_cell_velocity(mesh, u):
    """Edge-normal velocity -> (zonal, meridional) vectors at cells.

    Each edge's full vector is rebuilt from its normal component and the
    TRiSK tangential reconstruction (ocn/HorzOperators.h:104-133), then
    averaged to cells with dc*dv/4 edge-area weights. Exact for uniform
    flow (both projections are exact there and the weights normalize).
    Returns (u_zonal, v_merid), each (C, K) for (E, K) input."""
    w, idx = _cell_edge_avg_weights(mesh)
    w = torch.as_tensor(w, dtype=u.dtype, device=u.device)
    idx = torch.as_tensor(idx, device=u.device)
    ve, vn = _edge_vectors(mesh, u)
    return _avg(w, idx, ve), _avg(w, idx, vn)


def _edge_vectors(mesh, u):
    ut = trisk.tangential_edge(mesh, u)
    ang = mesh.angle_edge[:, None]
    # n-hat = (cos a, sin a), t-hat = (-sin a, cos a) in (east, north)
    ve = u * torch.cos(ang) - ut * torch.sin(ang)
    vn = u * torch.sin(ang) + ut * torch.cos(ang)
    return ve, vn


def _avg(w, idx, x):
    wj = w[:, :, None]                                   # (C, M, 1)
    return torch.sum(wj * x[idx], dim=1) / torch.sum(wj, dim=1)


def _cell_edge_avg_weights(mesh_l):
    """Host-side dc*dv/4 edge-area weights of one (local) mesh (the
    reconstruct_cell_velocity averaging), as (w (C, M), idx (C, M))."""
    m = host_mesh(mesh_l)
    eoc = unclamped_connectivity(m)["edges_on_cell"]
    dc = np.asarray(m.dc_edge, np.float64)
    dv = np.asarray(m.dv_edge, np.float64)
    w = np.where(eoc >= 0, (dc * dv / 4.0)[np.maximum(eoc, 0)], 0.0)
    return w, np.maximum(eoc, 0)


def _local_exports(mesh_l, st, w, idx, temp_idx, salt_idx):
    """Export fields on one (local) mesh — the same arithmetic as the
    gathered `OmegaComponent.exports`, so owned rows match bit for bit."""
    h, u = st.h, st.u
    depth = torch.as_tensor(trisk.col(mesh_l, "bottom_depth"),
                            dtype=h.dtype, device=h.device)
    out = {"ssh": column_ssh(h, torch.broadcast_to(
        depth, (h.shape[0], 1)).reshape(-1))}
    if temp_idx is not None:
        out["sst"] = st.tracers[temp_idx][:, 0]
    if salt_idx is not None:
        out["sss"] = st.tracers[salt_idx][:, 0]
    ve, vn = _edge_vectors(mesh_l, u)
    out["u_zonal"] = _avg(w, idx, ve)[:, 0]
    out["v_merid"] = _avg(w, idx, vn)[:, 0]
    return out


def make_sharded_exports(model, temp_idx=None, salt_idx=None):
    """Exports computed shard by shard: each shard computes its owned
    surface rows on its local mesh and only those rows leave its device,
    landing in the global (C,) host arrays — no global state gather at
    coupling intervals. Returns exports(per-shard states) -> dict of host
    arrays, or None when the decomposition keeps a global state (the patch
    path)."""
    kind, dec, devices = model._decomp
    if kind == "patch":
        return None                      # the state is already global
    if kind == "sfc":
        meshes = dec.meshes
        c_l2g = dec.cell_local_to_global
        c_own = dec.owned_cell_mask > 0
    else:
        from omega_tpu_torch.parallel import structured_shard as sshard
        meshes = dec.local_meshes(devices, model.dtype)
        c_l2g, c_own = sshard.element_maps(dec, "cell")
    wts = []
    for m, dev in zip(meshes, devices):
        w, i = _cell_edge_avg_weights(m)
        wts.append((torch.as_tensor(w, dtype=model.dtype, device=dev),
                    torch.as_tensor(i, device=dev)))
    ncells = model.mesh.ncells

    def exports(states):
        out = {}
        for s, (m, st) in enumerate(zip(meshes, states)):
            loc = _local_exports(m, st, *wts[s], temp_idx, salt_idx)
            rows = c_l2g[s][c_own[s]]
            sel = torch.as_tensor(np.flatnonzero(c_own[s]),
                                  device=st.h.device)
            for k, v in loc.items():
                g = out.setdefault(k, np.zeros(ncells, host(v[:0]).dtype))
                g[rows] = host(v[sel])
        return dict(sorted(out.items()))

    return exports


class OmegaComponent:
    """Omega as a drivable component with import/export states.

    The init/run/finalize triplet of an E3SM component
    (ocn/OceanDriver.h:26-35): `__init__` = ocnInit from a config,
    `run(interval)` = ocnRun until a one-shot coupling alarm,
    `finalize()` = ocnFinalize. The model's own IO streams (history,
    restart + pointer files) stay active underneath the coupler. `device`
    and `dtype` as for driver.ocn_init (None: the CUDA device)."""

    def __init__(self, config_file: Optional[str] = None, *,
                 config=None, directory: str = ".", device=None,
                 dtype: torch.dtype = torch.float32):
        from omega_tpu_torch.driver import ocn_init
        self.model = ocn_init(config=config, config_file=config_file,
                              directory=directory, device=device,
                              dtype=dtype)
        self._temp_idx = self._tracer_index("Temperature")
        self._salt_idx = self._tracer_index("Salinity")
        if self.model.nshards > 1:
            # hold the state sharded across coupling intervals; exports
            # are computed shard by shard from owned rows (no global
            # gather)
            self.model._keep_sharded = True
        self._sharded_exports = None

    def _tracer_index(self, name: str) -> Optional[int]:
        names = list(self.model.tracers.names)
        return names.index(name) if name in names else None

    # ---- component contract ----

    def run(self, interval_seconds: float,
            imports: Optional[Dict[str, np.ndarray]] = None) -> Dict:
        """Advance the ocean by one coupling interval and return exports.

        The interval must be a whole number of time steps (the coupler
        sets the alarm cadence, exactly like an IOStream alarm)."""
        model = self.model
        if imports:
            wz = imports.get("zonal_wind_stress")
            wm = imports.get("merid_wind_stress")
            if wz is not None or wm is not None:
                if not model.model_cfg.tendencies.wind_forcing:
                    raise ValueError(
                        "wind imports need Tendencies."
                        "WindForcingTendencyEnable: true in the config")
                C = model.mesh.ncells
                put = lambda x: torch.as_tensor(np.broadcast_to(
                    np.asarray(0.0 if x is None else x, np.float64),
                    (C,)).copy(), dtype=model.dtype, device=model.device)
                model.wind_stress = (put(wz), put(wm))
            unknown = set(imports) - {"zonal_wind_stress",
                                      "merid_wind_stress"}
            if unknown:
                raise ValueError(f"unknown import fields: {sorted(unknown)}")

        from omega_tpu_torch.driver import ocn_run
        now = model.clock.get_current_time()
        ring = now + TimeInterval(seconds=Fraction(interval_seconds))
        cpl = Alarm("CouplingAlarm", ring_time=ring)
        model.clock.attach_alarm(cpl)
        saved = model.end_alarm
        model.end_alarm = cpl
        try:
            ocn_run(model)
        finally:
            model.end_alarm = saved
            model.clock.alarms.remove(cpl)
        return self.exports()

    def exports(self) -> Dict[str, np.ndarray]:
        model = self.model
        if getattr(model, "_state_is_sharded", False):
            if self._sharded_exports is None:
                self._sharded_exports = make_sharded_exports(
                    model, self._temp_idx, self._salt_idx)
            if self._sharded_exports is not None:
                return self._sharded_exports(model.state)
        mesh = model.mesh
        h = model.state.h
        out = {"ssh": host(column_ssh(h, mesh.bottom_depth))}
        tr = model.state.tracers
        if self._temp_idx is not None:
            out["sst"] = host(tr[self._temp_idx][:, 0])
        if self._salt_idx is not None:
            out["sss"] = host(tr[self._salt_idx][:, 0])
        uz, vm = reconstruct_cell_velocity(mesh, model.state.u)
        out["u_zonal"] = host(uz[:, 0])
        out["v_merid"] = host(vm[:, 0])
        return out

    def finalize(self):
        from omega_tpu_torch.driver import ocn_finalize
        return ocn_finalize(self.model)

    @property
    def clock_time(self) -> str:
        return str(self.model.clock.get_current_time())
