"""Vertical coordinate (p-star) computations.

Rewrite of ocn/VertCoord.h/.cpp: per-column pressure (top-down mass sum),
z-height (bottom-up specific-volume sum), geopotential (with
tidal-potential and self-attraction/loading hooks), and the p-star target
layer thickness redistribution.

The reference uses hierarchical Kokkos team scans per column
(VertCoord.cpp:654-735); here each becomes one `torch.cumsum` along the
layer (K) axis of a (C, K) tensor.

Variable active-layer bounds (MinLayerCell/MaxLayerCell, VertCoord.h:85-106)
are handled by masking instead of ragged loops: inactive (cell, layer)
entries contribute zero thickness to the scans, and derived edge/vertex
bounds follow the reference's min/max rules (VertCoord.cpp:486-527).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from omega_tpu_torch import constants

GRAVITY = 9.80616   # the reference's hard-wired value (VertCoord.cpp:659)


@dataclasses.dataclass(frozen=True)
class VertCoordConfig:
    """``VertCoord:`` config group."""
    nvertlayers: int = 1
    movement_weight_type: str = "uniform"   # uniform | fixed
    rho0: float = constants.RHO0_SEAWATER

    @classmethod
    def from_yaml(cls, cfg, nvertlayers: int) -> "VertCoordConfig":
        if not cfg.exists("VertCoord"):
            return cls(nvertlayers=nvertlayers)
        v = cfg.get_group("VertCoord")
        return cls(
            nvertlayers=nvertlayers,
            movement_weight_type=v.get_str("MovementWeightType",
                                           "Uniform").lower(),
        )


class LayerBounds(NamedTuple):
    """Active-layer index bounds per element (VertCoord.h:85-106).
    max == -1 marks a fully inactive column."""
    min_cell: torch.Tensor        # (C,)
    max_cell: torch.Tensor        # (C,)
    min_edge_top: torch.Tensor    # (E,)
    max_edge_top: torch.Tensor
    min_edge_bot: torch.Tensor
    max_edge_bot: torch.Tensor
    min_vertex_top: torch.Tensor  # (V,)
    max_vertex_top: torch.Tensor
    min_vertex_bot: torch.Tensor
    max_vertex_bot: torch.Tensor

    def cell_mask(self, nvert: int, dtype=torch.float64) -> torch.Tensor:
        """(C, K) 1.0 where the layer is active."""
        k = torch.arange(nvert, device=self.min_cell.device)
        return ((k[None, :] >= self.min_cell[:, None])
                & (k[None, :] <= self.max_cell[:, None])).to(dtype)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx)
                           else idx, device=device).long()


def layer_bounds(mesh, min_cell, max_cell, nvert: int) -> LayerBounds:
    """Derive edge/vertex bounds from cell bounds (minMaxLayerEdge /
    minMaxLayerVertex, VertCoord.cpp:486-560).

    Top variants span layers where ANY/ALL adjacent columns are active:
    EdgeTop = [min over cells of min, min over cells of max] (both active),
    EdgeBot = [max of min, max of max] (any active). Inactive columns
    (max == -1) are excluded from Top mins and treated as empty.
    """
    min_cell = torch.as_tensor(min_cell)
    max_cell = torch.as_tensor(max_cell, device=min_cell.device)
    dev = min_cell.device
    nvp1 = nvert + 1
    coe = _index(mesh.cells_on_edge, dev)
    cov = _index(mesh.cells_on_vertex, dev)

    def pick(bound, idx, inactive_val):
        v = bound[idx]
        dead = max_cell[idx] == -1
        return torch.where(dead, torch.full_like(v, inactive_val), v)

    max_e = max_cell[coe]
    min_edge_top = pick(min_cell, coe, nvp1).min(dim=1).values
    min_edge_bot = pick(min_cell, coe, 0).max(dim=1).values
    max_edge_top = max_e.min(dim=1).values
    max_edge_bot = max_e.max(dim=1).values

    min_vertex_top = pick(min_cell, cov, nvp1).min(dim=1).values
    min_vertex_bot = pick(min_cell, cov, 0).max(dim=1).values
    max_vertex_top = max_cell[cov].min(dim=1).values
    max_vertex_bot = max_cell[cov].max(dim=1).values

    return LayerBounds(min_cell, max_cell, min_edge_top, max_edge_top,
                       min_edge_bot, max_edge_bot, min_vertex_top,
                       max_vertex_top, min_vertex_bot, max_vertex_bot)


def full_depth_bounds(mesh, nvert: int) -> LayerBounds:
    """All layers active everywhere (the all-ocean default), on the device
    of the mesh's connectivity."""
    device = torch.as_tensor(mesh.cells_on_edge).device
    zmin = torch.zeros(mesh.ncells, dtype=torch.int32, device=device)
    zmax = torch.full((mesh.ncells,), nvert - 1, dtype=torch.int32,
                      device=device)
    return layer_bounds(mesh, zmin, zmax, nvert)


# ----------------------------------------------------------------------
def compute_pressure(h, surface_pressure, rho0: float,
                     active_mask=None):
    """Interface + mid pressures by a top-down mass sum
    (VertCoord::computePressure, VertCoord.cpp:654-692).

    h: (C, K) pseudo thickness; surface_pressure: (C,).
    Returns (p_interface (C, K+1), p_mid (C, K)).
    """
    dp = GRAVITY * rho0 * h
    if active_mask is not None:
        dp = dp * active_mask
    cum = torch.cumsum(dp, dim=-1)
    p_int = surface_pressure[:, None] + torch.cat(
        [torch.zeros_like(cum[:, :1]), cum], dim=-1)
    p_mid = surface_pressure[:, None] + cum - 0.5 * dp
    return p_int, p_mid


def compute_z_height(h, spec_vol, bottom_depth, rho0: float,
                     active_mask=None):
    """Interface + mid z by a bottom-up sum of rho0 * specvol * h
    (VertCoord::computeZHeight, VertCoord.cpp:700-735).

    Returns (z_interface (C, K+1), z_mid (C, K)); z = -bottom_depth at the
    sea floor.
    """
    dz = rho0 * spec_vol * h
    if active_mask is not None:
        dz = dz * active_mask
    # bottom-up cumulative: reverse, cumsum, reverse
    cum_up = torch.flip(torch.cumsum(torch.flip(dz, dims=(-1,)), dim=-1),
                        dims=(-1,))                        # sum k..K-1
    z_int = -bottom_depth[:, None] + torch.cat(
        [cum_up, torch.zeros_like(cum_up[:, :1])], dim=-1)
    z_mid = -bottom_depth[:, None] + cum_up - 0.5 * dz
    return z_int, z_mid


def compute_geopotential(z_mid, tidal_potential=None,
                         self_attraction=None):
    """Geopotential at layer midpoints (VertCoord::computeGeopotential,
    VertCoord.cpp:743-782). Tidal potential and SAL are default-off hooks."""
    phi = GRAVITY * z_mid
    if tidal_potential is not None:
        phi = phi + tidal_potential[:, None]
    if self_attraction is not None:
        phi = phi + self_attraction[:, None]
    return phi


def compute_target_thickness(p_int, ref_thickness, movement_weights,
                             active_mask, rho0: float = constants.RHO0_SEAWATER):
    """p-star target layer thickness (VertCoord::computeTargetThickness,
    VertCoord.cpp:790-840): redistribute the column's total pseudo
    thickness over layers proportionally to movement weights.

        target_k = ref_k * (1 + coeff * w_k / sum(w_j ref_j))
        coeff    = (p_bot - p_top)/(g rho0) - sum(ref_j)

    movement_weights: (K,) per-layer weights (uniform by default).
    """
    ref = ref_thickness * active_mask
    w = movement_weights[None, :] * active_mask
    col_mass = (p_int[:, -1] - p_int[:, 0]) / (GRAVITY * rho0)
    sum_ref = torch.sum(ref, dim=-1)
    sum_wh = torch.sum(w * ref_thickness, dim=-1)
    coeff = col_mass - sum_ref
    denom = torch.where(sum_wh > 0, sum_wh, torch.ones_like(sum_wh))
    target = ref_thickness * (1.0 + coeff[:, None] * movement_weights[None, :]
                              / denom[:, None])
    return target * active_mask


def _interp_columns(x, xp, fp):
    """Piecewise-linear interpolation along the last axis, column by column
    (x, xp, fp of one shape (..., N)): the formula of `jnp.interp`, with
    the ends held constant and a zero-width interval taking its left
    value."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, n - 1)
    fl, fr = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    xl, xr = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    dx = xr - xl
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fl,
                    fl + ((x - xl) / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * (fr - fl))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def remap_piecewise_constant(h_old, h_new, q):
    """Conservative donor-cell vertical remap of a layer-mean quantity.

    q (..., K) are layer means on thicknesses h_old; returns layer means
    on h_new (same column totals). The cumulative content function
    F(z) = integral of q dz' is piecewise linear for piecewise-constant
    q, so new-layer contents are exact interval integrals:
    F interpolated at the new interfaces, differenced, divided by h_new.
    This is the vertical-remap building block of the p-star
    redistribution (VertCoord.cpp:785-840 computes the targets; the
    remap itself is roadmap in the reference). h_old and h_new broadcast
    against q's leading axes."""
    h_old = h_old.expand(q.shape)
    h_new = h_new.expand(q.shape)
    zero = torch.zeros_like(h_old[..., :1])
    zo = torch.cat([zero, torch.cumsum(h_old, dim=-1)], dim=-1)
    zn = torch.cat([zero, torch.cumsum(h_new, dim=-1)], dim=-1)
    F = torch.cat([zero, torch.cumsum(q * h_old, dim=-1)], dim=-1)
    Fn = _interp_columns(zn, zo, F)
    dF = Fn[..., 1:] - Fn[..., :-1]
    pos = h_new > 0
    return torch.where(pos, dF / torch.where(pos, h_new,
                                             torch.ones_like(h_new)), q)


def make_pstar_phase(mesh, ref_thickness, weights, active_mask=None,
                     rho0: float = constants.RHO0_SEAWATER):
    """Per-step p-star redistribution phase (config VertCoord.PStarEnable).

    Returns state -> state: recompute interface pressure from the
    current thickness, redistribute the column mass onto the target
    layers (computeTargetThickness, VertCoord.cpp:785-840), and
    conservatively remap tracers (cell columns) and normal velocity
    (edge columns, with 2-cell-mean edge thickness) onto the new
    layers. Volume and tracer content per column are conserved exactly
    (the remap is an exact interval integral). The tensors live on the
    device and in the type of `ref_thickness`."""
    from omega_tpu_torch.ops import trisk

    ref = torch.as_tensor(ref_thickness)
    w = torch.as_tensor(weights, dtype=ref.dtype, device=ref.device)
    mask = (torch.ones_like(ref) if active_mask is None
            else torch.as_tensor(active_mask, dtype=ref.dtype,
                                 device=ref.device))

    def phase(state):
        h = state.h
        p_int, _ = compute_pressure(
            h, torch.zeros(h.shape[0], dtype=h.dtype, device=h.device),
            rho0, mask)
        target = compute_target_thickness(p_int, ref, w, mask, rho0)
        tr_new = remap_piecewise_constant(h, target, state.tracers)
        # 2-cell edge mean through the operator path (on a structured
        # mesh the stencil kernel; the steppers' _mix uses the same
        # helper for the same quantity)
        he_old = trisk.cell_mean_on_edge(mesh, h)
        he_new = trisk.cell_mean_on_edge(mesh, target)
        u_new = remap_piecewise_constant(he_old, he_new, state.u)
        return type(state)(h=target, u=u_new, tracers=tr_new)

    return phase


def movement_weights(cfg: VertCoordConfig) -> np.ndarray:
    """VertCoordMovementWeights from config (initMovementWeights,
    VertCoord.cpp:620-646): 'uniform' weights every layer equally; 'fixed'
    puts all movement in the top layer."""
    K = cfg.nvertlayers
    if cfg.movement_weight_type == "uniform":
        return np.ones(K)
    if cfg.movement_weight_type == "fixed":
        w = np.zeros(K)
        w[0] = 1.0
        return w
    raise ValueError(f"unknown MovementWeightType "
                     f"{cfg.movement_weight_type!r}")
