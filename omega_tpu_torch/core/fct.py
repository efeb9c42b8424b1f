"""Flux-corrected (monotone) tracer transport — Zalesak limiter.

The reference currently offers only centered and upwind tracer fluxes
(ocn/auxiliaryVars/TracerAuxVars.h:13-66); monotone/FCT advection is a
stated requirement of the Omega design (doc/design/OmegaV0ShallowWater.md
tracer suite). This module implements the classic Zalesak (1979) two-flux
limiter on the TRiSK C-grid:

  1. low-order edge flux  F_lo = upwind(h tr) u          (monotone)
  2. high-order edge flux F_hi = centered(h tr) u        (2nd order)
  3. provisional transported-diffused field from F_lo
  4. per-cell admissible bounds from the old field and its neighbors
  5. antidiffusive fluxes A = F_hi - F_lo limited by the Zalesak R+/R-
     factors so the final update cannot create new extrema

`fct_tracer_tendency` returns a tendency d(h tr)/dt such that the
standard thickness-weighted update of TimeStepper.h:205-237,

    tr_new = (tr h_old + dt * tend) / h_new,

is monotone: min_nbr(tr) <= tr_new <= max_nbr(tr) for pure advection.
It therefore needs dt and the updated thickness h_new — both available
in the forward-backward stepper where thickness is advanced first.

Composed only: every stencil below is one pass of the structured-stencil
kernel on a CUDA field.
"""

from __future__ import annotations

import torch

from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import trisk


def _edge_fluxes(mesh, mass_flux, u, tracers):
    """Low (upwind) and high (centered) order tracer fluxes per edge,
    both built on the SAME mass flux the thickness equation used
    (F = mass_flux * tr_edge) so a constant tracer advects exactly with
    the flow — the compatibility requirement of flux-form FCT."""
    tr0, tr1 = trisk.cell_pair_on_edge(mesh, tracers)
    f_hi = 0.5 * (tr0 + tr1) * mass_flux
    tr_up = torch.where(u > 0, tr0,
                        torch.where(u < 0, tr1, 0.5 * (tr0 + tr1)))
    f_lo = tr_up * mass_flux
    return f_lo, f_hi


def fct_provisional(mesh: HorzMesh, h_old, h_new, u, tracers, dt,
                    flux_h_edge):
    """The low-order (monotone) provisional transported-diffused field
    tr_td (steps 1-3 of fct_tracer_tendency)."""
    mass_flux = trisk.col(mesh, "edge_mask") * flux_h_edge * u
    f_lo, _ = _edge_fluxes(mesh, mass_flux, u, tracers)
    div_lo = trisk.div_cell(mesh, f_lo)                  # (L, C, K)
    return (tracers * h_old[None] - dt * div_lo) / h_new[None]


def fct_limited_tendency(mesh: HorzMesh, h_new, u, tracers, tr_td, dt,
                         flux_h_edge, fluxes=None):
    """The Zalesak limiter (steps 4-5) given the provisional field:
    returns the monotone advective tendency -div(f_corr).  `fluxes`
    optionally carries precomputed (f_lo, f_hi) so the composed
    fct_tracer_tendency doesn't evaluate the edge fluxes twice."""
    eps = 1e-30
    if fluxes is None:
        mass_flux = trisk.col(mesh, "edge_mask") * flux_h_edge * u
        f_lo, f_hi = _edge_fluxes(mesh, mass_flux, u, tracers)
    else:
        f_lo, f_hi = fluxes

    # admissible bounds: extrema of old and transported fields over the
    # cell and its neighbors (Zalesak eq. 17-18)
    tr_max_o, tr_min_o = trisk.cell_neighbor_extrema(mesh, tracers)
    tr_max_t, tr_min_t = trisk.cell_neighbor_extrema(mesh, tr_td)
    tr_max = torch.maximum(tr_max_o, tr_max_t)
    tr_min = torch.minimum(tr_min_o, tr_min_t)

    # antidiffusive fluxes and their per-cell in/out budgets. The update
    # d(h tr)/dt at cell c receives sum_j -w_div[c,j] * A[eoc[c,j]], so
    # incoming = relu(-w A), outgoing = relu(w A) per slot. Splitting
    # A = B+ - B- (exclusive positive/negative parts) makes the per-slot
    # relu separable into two fixed NONNEGATIVE weight stencils:
    #   relu(-w A) = relu(-w) B+ + relu(w) B-
    #   relu( w A) = relu( w) B+ + relu(-w) B-
    # (Zalesak eq. 7-10 on the TRiSK C-grid.)
    a = f_hi - f_lo                                      # (L, E, K)
    b_pos = torch.clamp(a, min=0.0)
    b_neg = torch.clamp(-a, min=0.0)
    p_in = dt * (trisk.div_cell_neg(mesh, b_pos)
                 + trisk.div_cell_pos(mesh, b_neg))
    p_out = dt * (trisk.div_cell_pos(mesh, b_pos)
                  + trisk.div_cell_neg(mesh, b_neg))

    q_in = (tr_max - tr_td) * h_new[None]
    q_out = (tr_td - tr_min) * h_new[None]

    r_in = torch.clamp(q_in / torch.clamp(p_in, min=eps), 0.0, 1.0)
    r_out = torch.clamp(q_out / torch.clamp(p_out, min=eps), 0.0, 1.0)

    # limiter per edge: the receiving cell's R_in and giving cell's R_out.
    # For edge e with w_div[c0] > 0 the flux A > 0 moves mass from c0
    # to c1 (normal points c0 -> c1, div adds +A/A_c0 out of c0).
    r_in0, r_in1 = trisk.cell_pair_on_edge(mesh, r_in)
    r_out0, r_out1 = trisk.cell_pair_on_edge(mesh, r_out)
    c_e = torch.where(a >= 0,
                      torch.minimum(r_in1, r_out0),   # A>0: c0 gives, c1 gets
                      torch.minimum(r_in0, r_out1))
    f_corr = f_lo + c_e * a
    return -trisk.div_cell(mesh, f_corr)


def fct_tracer_tendency(mesh: HorzMesh, h_old, h_new, u, tracers, dt,
                        flux_h_edge):
    """Monotone advective tendency d(h tr)/dt (L, C, K) via Zalesak FCT.

    flux_h_edge: the FluxLayerThickEdge used in the thickness update, so
    that div(mass_flux) reproduces (h_old - h_new)/dt exactly."""
    mass_flux = trisk.col(mesh, "edge_mask") * flux_h_edge * u
    f_lo, f_hi = _edge_fluxes(mesh, mass_flux, u, tracers)
    div_lo = trisk.div_cell(mesh, f_lo)
    tr_td = (tracers * h_old[None] - dt * div_lo) / h_new[None]
    return fct_limited_tendency(mesh, h_new, u, tracers, tr_td, dt,
                                flux_h_edge, fluxes=(f_lo, f_hi))
