"""Tendency (RHS) terms and their orchestration.

Counterpart of ocn/TendencyTerms.h:26-492 and ocn/Tendencies.cpp. Each
reference per-element functor becomes a whole-array expression over
(element, K) tensors; enable flags are static configuration, so only the
enabled terms are computed. The three compute groups mirror the reference
wrappers:

  compute_thickness_tendency   <- Tendencies::computeThicknessTendencies
  compute_velocity_tendency    <- Tendencies::computeVelocityTendencies
  compute_tracer_tendency      <- Tendencies::computeTracerTendencies
  compute_all_tendencies       <- Tendencies::computeAllTendencies

With `use_custom_tendency` and `manufactured_tendency` the manufactured-
solution forcing (core/manufactured.py) is added to the h and u tendencies.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from omega_tpu_torch.core import aux as auxmod
from omega_tpu_torch.core import manufactured
from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import trisk


class Tendencies(NamedTuple):
    dh: Optional[torch.Tensor] = None   # (C, K)
    du: Optional[torch.Tensor] = None   # (E, K)
    dtr: Optional[torch.Tensor] = None  # (L, C, K)


def _custom_hooks(mesh: HorzMesh, cfg: ModelConfig):
    """Resolve custom tendency hooks (ocn/Tendencies.cpp:40-66)."""
    if cfg.tendencies.use_custom_tendency and cfg.tendencies.manufactured_tendency:
        # resting thickness assumed horizontally uniform (CustomTendencyTerms.cpp:80-84)
        h0 = float(mesh.bottom_depth[0])
        p = manufactured.make_params(cfg, h0)
        return (lambda t: manufactured.thickness_tendency(p, mesh, t),
                lambda t: manufactured.velocity_tendency(p, mesh, cfg, t))
    return None, None


def thickness_tendency(mesh: HorzMesh, cfg: ModelConfig,
                       thick_aux: auxmod.ThicknessAux, u, t) -> torch.Tensor:
    """tend_h = -div(flux_h u)  (TendencyTerms.h:26-66)."""
    tc = cfg.tendencies
    K = u.shape[-1]
    tend = torch.zeros((mesh.ncells, K), dtype=u.dtype, device=u.device)
    if tc.thickness_flux_div:
        tend = tend - trisk.div_cell(mesh, thick_aux.flux_h_edge * u)
    custom_h, _ = _custom_hooks(mesh, cfg)
    if custom_h is not None:
        tend = tend + custom_h(t)
    return tend


def velocity_tendency(mesh: HorzMesh, cfg: ModelConfig,
                      mom: auxmod.MomentumAux, u, t) -> torch.Tensor:
    """Momentum RHS (TendencyTerms.h:70-340, Tendencies.cpp:301-425)."""
    tc = cfg.tendencies
    K = u.shape[-1]
    mask = trisk.col(mesh, "edge_mask")
    tend = torch.zeros((mesh.nedges, K), dtype=u.dtype, device=u.device)

    if tc.pv_advection:
        # q(e,e') = 0.5*(q_e + q_e'), with q = nrv + npv. Split the sum:
        # sum_j W_j F_j q(e,j) = 0.5*(q_e * T[F] + T[F q])  where T = tangential
        # Both reconstructions ride ONE stencil pass over a stacked (2, E, K)
        # field — the 24-term tangential walk is the most expensive stencil
        # in the step, so halving its invocations matters.
        q = mom.vorticity.norm_rel_vort_edge + mom.vorticity.norm_planet_vort_edge
        F = mom.thickness.flux_h_edge * u
        tf, tfq = trisk.tangential_edge(mesh, torch.stack([F, F * q]))
        pv = 0.5 * (q * tf + tfq)
        tend = tend + mask * pv

    if tc.ke_gradient:
        tend = tend - mask * trisk.grad_edge(mesh, mom.kinetic.ke_cell)

    if tc.ssh_gradient:
        tend = tend - mask * cfg.gravity * trisk.grad_edge(mesh, mom.thickness.ssh_cell)

    inv_dc = 1.0 / trisk.col(mesh, "dc_edge")
    inv_dv = 1.0 / trisk.col(mesh, "dv_edge")

    if tc.velocity_diffusion:
        del2u = (trisk.cell_diff_on_edge(mesh, mom.kinetic.div_cell) * inv_dc
                 - trisk.vertex_diff_on_edge(
                     mesh, mom.vorticity.rel_vort_vertex) * inv_dv)
        tend = tend + mask * tc.visc_del2 * \
            trisk.col(mesh, "mesh_scaling_del2") * del2u

    if tc.velocity_hyperdiff:
        del2u = (tc.div_factor * inv_dc
                 * trisk.cell_diff_on_edge(mesh, mom.del2.del2_div_cell)
                 - trisk.vertex_diff_on_edge(
                     mesh, mom.del2.del2_rvort_vertex) * inv_dv)
        tend = tend - mask * tc.visc_del4 * \
            trisk.col(mesh, "mesh_scaling_del4") * del2u

    mask0 = mask if isinstance(mask, (int, float)) else mask[:, 0]

    if tc.wind_forcing and mom.normal_stress_edge is not None:
        top = (mask0 * mom.normal_stress_edge
               / (tc.density0 * mom.thickness.mean_h_edge[:, 0]))
        tend[:, 0] += top           # `tend` is this function's own tensor

    if tc.bottom_drag:
        ke0, ke1 = trisk.cell_pair_on_edge(mesh, mom.kinetic.ke_cell[:, -1:])
        speed = torch.sqrt(ke0[:, 0] + ke1[:, 0])
        drag = (mask0 * tc.bottom_drag_coeff * speed * u[:, -1]
                / mom.thickness.mean_h_edge[:, -1])
        tend[:, -1] -= drag

    _, custom_u = _custom_hooks(mesh, cfg)
    if custom_u is not None:
        tend = tend + custom_u(t)
    return tend


def compute_thickness_tendency(mesh, cfg, h, u, t):
    """Wrapper mirroring Tendencies::computeThicknessTendencies
    (Tendencies.cpp:489-520): computes thickness aux on edges, then flux div."""
    thick_aux = auxmod.thickness_aux_edge(mesh, cfg, h, u)
    return thickness_tendency(mesh, cfg, thick_aux, u, t), thick_aux


def compute_velocity_tendency(mesh, cfg, h_thick, u, t, wind_stress=None):
    """Wrapper mirroring Tendencies::computeVelocityTendencies
    (Tendencies.cpp:523-538): computeMomAux then the edge terms.
    `h_thick` is the thickness time level used for aux vars (new h in FB)."""
    mom = auxmod.compute_momentum_aux(mesh, cfg, h_thick, u, wind_stress)
    return velocity_tendency(mesh, cfg, mom, u, t), mom


def compute_tracer_tendency(mesh, cfg, h, u, tracers, mean_h_edge, t,
                            h_new=None, dt=None, flux_h_edge=None):
    """Wrapper mirroring Tendencies::computeTracerTendencies
    (Tendencies.cpp:540-580). With FluxTracerType 'fct' (an extension
    beyond the reference's center/upwind options) the advective term is
    Zalesak flux-corrected and needs the updated thickness h_new and dt
    (available in the forward-backward stepper)."""
    tc = cfg.tendencies
    tr_aux = auxmod.tracer_aux(mesh, cfg, h, u, tracers, mean_h_edge)
    tend = torch.zeros_like(tracers)
    mask = trisk.col(mesh, "edge_mask")

    if tc.tracer_horz_adv:
        if cfg.flux_tracer_type == "fct":
            if h_new is None or dt is None:
                raise ValueError(
                    "FluxTracerType 'fct' requires the thickness-first "
                    "update order of the forward-backward stepper")
            from omega_tpu_torch.core import fct
            if flux_h_edge is None:
                flux_h_edge = auxmod.thickness_aux_edge(
                    mesh, cfg, h, u).flux_h_edge
            tend = tend + fct.fct_tracer_tendency(
                mesh, h, h_new, u, tracers, dt, flux_h_edge)
        else:
            flux = tr_aux.h_tracers_edge * (mask * u)
            tend = tend - trisk.div_cell(mesh, flux)

    if tc.tracer_diffusion:
        tend = tend + tc.eddy_diff2 * auxmod._weighted_cell_laplacian(
            mesh, trisk.col(mesh, "mesh_scaling_del2") * mean_h_edge, tracers)

    if tc.tracer_hyperdiff:
        tend = tend - tc.eddy_diff4 * auxmod._weighted_cell_laplacian(
            mesh, trisk.col(mesh, "mesh_scaling_del4"),
            tr_aux.del2_tracers_cell)

    return tend, tr_aux


def compute_all_tendencies(mesh, cfg, h, u, tracers, t, wind_stress=None):
    """Mirrors Tendencies::computeAllTendencies (Tendencies.cpp:585-604):
    aux computeAll + thickness + velocity + tracer groups at one time level."""
    mom = auxmod.compute_momentum_aux(mesh, cfg, h, u, wind_stress)
    dh = thickness_tendency(mesh, cfg, mom.thickness, u, t)
    du = velocity_tendency(mesh, cfg, mom, u, t)
    dtr, _ = compute_tracer_tendency(mesh, cfg, h, u, tracers,
                                     mom.thickness.mean_h_edge, t)
    return Tendencies(dh=dh, du=du, dtr=dtr)
