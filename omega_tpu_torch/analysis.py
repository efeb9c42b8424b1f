"""Online analysis: global energetics and tracer budget time series.

The reference reserves an `analysis` layer but ships it empty
(src/analysis/README.md); its science diagnostics live in the external
Polaris suites.  This module brings the core budget diagnostics
in-model, computed with the order-invariant sums of
parallel/reductions.py (bit for bit the JAX package's on the same
numbers) and written as a CSV time series on an alarm cadence (driver
config group `Analysis`). The sums run on the state's device; only the
scalars come back to the host.

Conservation facts the monitors rest on (Ringler et al. 2010):
  * volume and thickness-weighted tracer content are conserved to
    roundoff by the flux-form updates;
  * total energy  E = sum_k sum_c A_c [ h ke + g/2 (ssh - <ssh>_0)^2 ]
    is conserved by the TRiSK spatial discretization (the momentum
    force is -g grad ssh, so ssh is the energy's surface elevation in
    BOTH ssh formulations) up to time-discretization error;
  * potential enstrophy  Z = 1/2 sum_v A_v (xi + f)^2 / h_v  is NOT
    conserved by the reference's energy-conserving PV flux — it is
    reported as a boundedness diagnostic, not a budget.
"""

from __future__ import annotations

from typing import Dict

import torch

from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import trisk
from omega_tpu_torch.parallel.reductions import (global_max, global_min,
                                                 global_sum)


def energetics(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
               ssh_ref: float = 0.0) -> Dict[str, float]:
    """Global budget scalars for one state (host-returned floats).

    ssh_ref: constant reference elevation subtracted from ssh before
    squaring (use the initial area-mean; volume conservation keeps the
    mean constant, so the subtraction changes PE by a constant and
    keeps d(KE+PE)/dt = 0 while avoiding catastrophic cancellation)."""
    h, u = state.h, state.u
    area = mesh.area_cell[:, None]
    area_v = mesh.area_triangle[:, None]

    ke_cell = trisk.ke_cell(mesh, u)                       # (C, K)
    if cfg.ssh_formulation == "column":
        ssh = (torch.sum(h, dim=-1, keepdim=True)
               - trisk.col(mesh, "bottom_depth"))
    else:
        ssh = h - trisk.col(mesh, "bottom_depth")
    eta = ssh - ssh_ref

    xi = trisk.curl_vertex(mesh, u)                        # (V, K)
    h_v = trisk.cell_to_vertex_kite(mesh, h)
    f_v = mesh.f_vertex[:, None]
    absv = xi + f_v

    out = {
        "volume": global_sum(area * h),
        "kinetic_energy": global_sum(area * h * ke_cell),
        "potential_energy": 0.5 * cfg.gravity * global_sum(area * eta * eta),
        "potential_enstrophy": 0.5 * global_sum(
            area_v * absv * absv / h_v),
    }
    for l in range(state.tracers.shape[0]):
        tr = state.tracers[l]
        out[f"tracer{l}_mass"] = global_sum(area * h * tr)
        out[f"tracer{l}_min"] = torch.min(tr).item()
        out[f"tracer{l}_max"] = torch.max(tr).item()
    out = {k: float(v) for k, v in out.items()}
    # the total from the hosted parts (the JAX package's order)
    out["total_energy"] = out["kinetic_energy"] + out["potential_energy"]
    return out


def _ssh(mesh, cfg, h):
    if cfg.ssh_formulation == "column":
        return (torch.sum(h, dim=-1, keepdim=True)
                - trisk.col(mesh, "bottom_depth"))
    return h - trisk.col(mesh, "bottom_depth")


def energetics_local(meshes, cfg: ModelConfig, states, own_c, own_v,
                     ssh_ref):
    """The sharded counterpart of `energetics` (no global gather): each
    shard computes its owned-masked partial terms on its local mesh, halos
    fresh from the last exchange, and the cross-shard reductions of
    parallel/reductions.py combine them — the per-rank norms plus MPI
    reduction of the reference (test/ocn/OceanTestCommon.h:396-560).

    meshes, states, own_c (Cl,) and own_v (Vl,) bool masks: one entry a
    shard. Returns a dict of 0-d tensors (on the first shard's device)."""
    area, mc, mv, ke, eta, ens, trs = [], [], [], [], [], [], []
    for m, st, oc, ov in zip(meshes, states, own_c, own_v):
        h, u = st.h, st.u
        a = m.area_cell[:, None]
        area.append(a)
        mc.append(oc[:, None])
        mv.append(ov[:, None])
        ke.append(a * h * trisk.ke_cell(m, u))
        e = _ssh(m, cfg, h) - ssh_ref
        eta.append(a * e * e)
        absv = trisk.curl_vertex(m, u) + m.f_vertex[:, None]
        ens.append(m.area_triangle[:, None] * absv * absv
                   / trisk.cell_to_vertex_kite(m, h))
    gs = lambda v, mk: global_sum(v, mask=mk)
    out = {
        "volume": gs([a * st.h for a, st in zip(area, states)], mc),
        "kinetic_energy": gs(ke, mc),
        "potential_energy": 0.5 * cfg.gravity * gs(eta, mc),
        "potential_enstrophy": 0.5 * gs(ens, mv),
    }
    for l in range(states[0].tracers.shape[0]):
        tr = [st.tracers[l] for st in states]
        out[f"tracer{l}_mass"] = gs([a * st.h * t for a, st, t in
                                     zip(area, states, tr)], mc)
        out[f"tracer{l}_min"] = global_min(tr, mask=mc)
        out[f"tracer{l}_max"] = global_max(tr, mask=mc)
    return out


def mean_ssh_local(meshes, cfg: ModelConfig, states, own_c):
    """Sharded area-mean ssh (see mean_ssh): one entry a shard in each
    list; a 0-d tensor."""
    num, den, mc = [], [], []
    for m, st, oc in zip(meshes, states, own_c):
        a = m.area_cell[:, None]
        ssh = _ssh(m, cfg, st.h)
        num.append(a * ssh)
        # the area broadcast over ssh's lanes: the same total-area (x K in
        # stacked form) factor as mean_ssh's
        den.append(torch.broadcast_to(a, ssh.shape))
        mc.append(oc[:, None])
    return global_sum(num, mask=mc) / global_sum(den, mask=mc)


def mean_ssh(mesh: HorzMesh, cfg: ModelConfig, state: ModelState) -> float:
    """Area-mean ssh (the natural ssh_ref, fixed at t=0 by volume
    conservation)."""
    area = mesh.area_cell[:, None]
    h = state.h
    if cfg.ssh_formulation == "column":
        ssh = (torch.sum(h, dim=-1, keepdim=True)
               - trisk.col(mesh, "bottom_depth"))
    else:
        ssh = h - trisk.col(mesh, "bottom_depth")
    # the denominator through the same order-invariant sum (the area
    # broadcast over ssh's lanes: x K in stacked form)
    denom = float(global_sum(torch.broadcast_to(area, ssh.shape)))
    return float(global_sum(area * ssh)) / denom


class EnergeticsMonitor:
    """Alarm-driven CSV writer of the energetics time series.

    Created by the driver from the `Analysis` config group; `sample`
    is called at segment boundaries when its alarm rings (the analysis
    cadence chunks the run loop exactly like an IOStream alarm)."""

    def __init__(self, mesh, cfg, path: str):
        self.mesh, self.cfg, self.path = mesh, cfg, path
        self.ssh_ref = None
        self._wrote_header = False

    def sample(self, state: ModelState, time_str: str) -> Dict[str, float]:
        if self.ssh_ref is None:
            self.ssh_ref = mean_ssh(self.mesh, self.cfg, state)
        # sorted keys: the JAX package's CSV schema
        row = dict(sorted(energetics(self.mesh, self.cfg, state,
                                     self.ssh_ref).items()))
        self.write_row(row, time_str)
        return row

    def write_row(self, row: Dict[str, float], time_str: str) -> None:
        """Append one precomputed row, its columns in sorted key order."""
        row = dict(sorted(row.items()))
        mode = "a" if self._wrote_header else "w"
        with open(self.path, mode) as f:
            if not self._wrote_header:
                f.write("time," + ",".join(row) + "\n")
                self._wrote_header = True
            f.write(time_str + ","
                    + ",".join(repr(v) for v in row.values()) + "\n")
