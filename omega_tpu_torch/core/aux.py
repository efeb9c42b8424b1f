"""Auxiliary (diagnostic) variables, recomputed each RHS evaluation.

Counterpart of ocn/AuxiliaryState.cpp:60-185 and the aux-var groups under
ocn/auxiliaryVars/. Each reference Kokkos kernel becomes a whole-array
stencil expression over (element, K) tensors.

`MomentumAux` / `TracerAux` bundles mirror the reference's AuxiliaryState
members so tendencies can consume one object.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import trisk


class ThicknessAux(NamedTuple):
    flux_h_edge: torch.Tensor   # (E, K) FluxLayerThickEdge
    mean_h_edge: torch.Tensor   # (E, K) MeanLayerThickEdge
    ssh_cell: torch.Tensor      # (C, K) SshCell


class VorticityAux(NamedTuple):
    rel_vort_vertex: torch.Tensor          # (V, K)
    norm_rel_vort_vertex: torch.Tensor     # (V, K)
    norm_planet_vort_vertex: torch.Tensor  # (V, K)
    norm_rel_vort_edge: torch.Tensor       # (E, K)
    norm_planet_vort_edge: torch.Tensor    # (E, K)


class KineticAux(NamedTuple):
    ke_cell: torch.Tensor       # (C, K) KineticEnergyCell
    div_cell: torch.Tensor      # (C, K) VelocityDivCell


class Del2Aux(NamedTuple):
    del2_edge: torch.Tensor         # (E, K)
    del2_div_cell: torch.Tensor     # (C, K)
    del2_rvort_vertex: torch.Tensor # (V, K)


class MomentumAux(NamedTuple):
    thickness: ThicknessAux
    vorticity: VorticityAux
    kinetic: KineticAux
    del2: Del2Aux
    normal_stress_edge: Optional[torch.Tensor]  # (E,) or None


class TracerAux(NamedTuple):
    h_tracers_edge: torch.Tensor     # (L, E, K)
    del2_tracers_cell: torch.Tensor  # (L, C, K)


def _upwind(u, a, b):
    """a where u > 0, b where u < 0, max(a, b) at rest."""
    return torch.where(u > 0, a, torch.where(u < 0, b, torch.maximum(a, b)))


def thickness_aux_edge(mesh: HorzMesh, cfg: ModelConfig, h, u) -> ThicknessAux:
    """FluxLayerThickEdge / MeanLayerThickEdge / SshCell
    (auxiliaryVars/LayerThicknessAux.h:12-92)."""
    if cfg.flux_thickness_type == "center":
        mean_h = trisk.cell_mean_on_edge(mesh, h)    # one fused pass
        flux_h = mean_h
    elif cfg.flux_thickness_type == "upwind":
        h0, h1 = trisk.cell_pair_on_edge(mesh, h)    # select needs both
        mean_h = 0.5 * (h0 + h1)
        flux_h = _upwind(u, h0, h1)
    else:
        raise ValueError(cfg.flux_thickness_type)
    if cfg.ssh_formulation == "column":
        ssh = (torch.sum(h, dim=-1, keepdim=True)
               - trisk.col(mesh, "bottom_depth"))
    else:   # "stacked": reference parity (LayerThicknessAuxVars.h:71)
        ssh = h - trisk.col(mesh, "bottom_depth")
    return ThicknessAux(flux_h_edge=flux_h, mean_h_edge=mean_h, ssh_cell=ssh)


def vorticity_aux(mesh: HorzMesh, h, u) -> VorticityAux:
    """Relative/normalized vorticities (auxiliaryVars/VorticityAuxVars.h:12-95)."""
    rel_vort = trisk.curl_vertex(mesh, u)                        # (V, K)
    h_vertex = trisk.cell_to_vertex_kite(mesh, h)                # (V, K)
    inv_hv = 1.0 / h_vertex
    nrv_v = rel_vort * inv_hv
    npv_v = trisk.col(mesh, "f_vertex") * inv_hv
    # both vorticities ride ONE fused vertex-mean pass as a stacked pair
    q_e = trisk.vertex_mean_on_edge(mesh, torch.stack([nrv_v, npv_v]))
    return VorticityAux(rel_vort, nrv_v, npv_v, q_e[0], q_e[1])


def kinetic_aux(mesh: HorzMesh, u) -> KineticAux:
    """KE and velocity divergence at cells (auxiliaryVars/KineticAuxVars.h:12-60)."""
    ke = trisk.ke_cell(mesh, u)
    div = trisk.div_cell(mesh, u)
    return KineticAux(ke_cell=ke, div_cell=div)


def del2_aux(mesh: HorzMesh, div_cell, rel_vort_vertex) -> Del2Aux:
    """Laplacian building blocks for biharmonic mixing
    (auxiliaryVars/VelocityDel2AuxVars.h:12-75).

    Replicates the reference exactly, including applying EdgeMask only to
    the grad-div part of Del2Edge (VelocityDel2AuxVars.h:40-45) and the
    dv >= 0.25*dc floor on the vorticity difference.
    """
    dc_c = trisk.col(mesh, "dc_edge")
    dv_c = trisk.col(mesh, "dv_edge")
    inv_dv = 1.0 / (torch.maximum(dv_c, 0.25 * dc_c) if not (
        isinstance(dv_c, float) and isinstance(dc_c, float))
        else max(dv_c, 0.25 * dc_c))
    grad_div = trisk.cell_diff_on_edge(mesh, div_cell) / dc_c
    curl_vort = -trisk.vertex_diff_on_edge(mesh, rel_vort_vertex) * inv_dv
    del2_edge = trisk.col(mesh, "edge_mask") * grad_div + curl_vort

    del2_div = trisk.div_cell(mesh, del2_edge)
    del2_rvort = trisk.curl_vertex(mesh, del2_edge)
    return Del2Aux(del2_edge, del2_div, del2_rvort)


def wind_normal_stress(mesh: HorzMesh, cfg: ModelConfig,
                       zonal_stress_cell, merid_stress_cell) -> torch.Tensor:
    """Rotate cell wind stress onto edge normals
    (auxiliaryVars/WindForcingAuxVars.h:13-40)."""
    if cfg.wind_interp_type == "isotropic":
        zonal = trisk.interp_cell_to_edge_iso(mesh, zonal_stress_cell)
        merid = trisk.interp_cell_to_edge_iso(mesh, merid_stress_cell)
    else:
        zonal = trisk.interp_cell_to_edge_aniso(mesh, zonal_stress_cell)
        merid = trisk.interp_cell_to_edge_aniso(mesh, merid_stress_cell)
    return (torch.cos(mesh.angle_edge) * zonal
            + torch.sin(mesh.angle_edge) * merid)


def compute_momentum_aux(mesh: HorzMesh, cfg: ModelConfig, h, u,
                         wind_stress=None) -> MomentumAux:
    """The computeMomAux sweep (ocn/AuxiliaryState.cpp:60-143)."""
    vort = vorticity_aux(mesh, h, u)
    kin = kinetic_aux(mesh, u)
    thick = thickness_aux_edge(mesh, cfg, h, u)
    d2 = del2_aux(mesh, kin.div_cell, vort.rel_vort_vertex)
    stress = None
    if cfg.tendencies.wind_forcing and wind_stress is not None:
        stress = wind_normal_stress(mesh, cfg, wind_stress[0], wind_stress[1])
    return MomentumAux(thickness=thick, vorticity=vort, kinetic=kin,
                       del2=d2, normal_stress_edge=stress)


def _weighted_cell_laplacian(mesh: HorzMesh, edge_factor, field):
    """(1/A_c) sum_e -mask_e sign(c,e) edge_factor_e (dv/dc)_e d(field)_e.

    Shared form of Del2TracersCell (auxiliaryVars/TracerAuxVars.h:70-105),
    TracerDiffOnCell and TracerHyperDiffOnCell (TendencyTerms.h:386-492).
    `field` is (..., C, K); `edge_factor` broadcasts against (E, K).
    """
    geo = (trisk.col(mesh, "edge_mask") * trisk.col(mesh, "dv_edge")
           / trisk.col(mesh, "dc_edge"))
    g = geo * edge_factor * trisk.cell_diff_on_edge(mesh, field)
    return trisk.edge_to_cell_signed(mesh, g)


def tracer_aux(mesh: HorzMesh, cfg: ModelConfig, h, u, tracers,
               mean_h_edge) -> TracerAux:
    """HTracersEdge and Del2TracersCell (auxiliaryVars/TracerAuxVars.h:13-108)."""
    if cfg.flux_tracer_type in ("center", "fct"):
        # fct computes its own limited flux (core/fct.py); the centered
        # value here only feeds the del2 diagnostics — one fused pass
        # over the stacked (L, C, K) product
        h_tr_edge = trisk.cell_mean_on_edge(mesh, h[None] * tracers)
    elif cfg.flux_tracer_type == "upwind":
        h0, h1 = trisk.cell_pair_on_edge(mesh, h)
        tr0, tr1 = trisk.cell_pair_on_edge(mesh, tracers)
        htr0 = h0 * tr0                                # (L, E, K)
        htr1 = h1 * tr1
        h_tr_edge = _upwind(u, htr0, htr1)
    else:
        raise ValueError(cfg.flux_tracer_type)
    del2_tr = _weighted_cell_laplacian(mesh, mean_h_edge, tracers)
    return TracerAux(h_tracers_edge=h_tr_edge, del2_tracers_cell=del2_tr)
