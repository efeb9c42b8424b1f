"""Split-explicit barotropic/baroclinic time stepping.

Counterpart of omega_tpu/stepping/split.py, after established MPAS-Ocean
practice (Ringler et al. 2013, Ocean Modelling 69): the fast external
gravity wave, speed sqrt(g H), sets the explicit CFL limit of the unsplit
steppers, so it is integrated with many cheap barotropic (depth-averaged)
subcycles per baroclinic step, while the full 3-D tendencies advance once
with the long step.

Per step of length dt with M subcycles:
  1. split u = ubar + u' (thickness-weighted depth average on edges)
  2. full velocity tendency G at the current state; its depth average
     minus the fast part is the slow barotropic forcing, held fixed
     through the subcycles
  3. M forward-backward barotropic subcycles of (ubar, ssh) with
     d(ubar)/dt = -g grad(ssh) + f tang(ubar) - r ubar + Gbar_slow,
     d(ssh)/dt  = -div(H_edge ubar),
     accumulating the time-averaged <ubar>
  4. baroclinic update u' += dt (G - depth_avg(G))
  5. recombine u = u' + ubar_final; thickness and tracers advect with the
     transport velocity u' + <ubar>, so the layer sum of the thickness
     fluxes is consistent with the subcycled free surface

For a state on a CUDA device and the configuration the fused kernels take
(`megastep.split_supported`) a step is three kernel calls: splitpre (mode
split, column-ssh velocity tendency, slow forcing), the barotropic
subcycles (ops/barotropic_kernel.py, one cooperative launch) and splitpost
(ops/megastep.py). On the icosahedral sphere
(`patch_megastep.split_patch_supported`) a step of a CUDA state runs the
framed path of ops/patch_megastep.py: the splitpre and splitpost patch
kernels around the flat 2-D phase, whose subcycles are the gather-form
kernel of ops/bt_gather.py (one cooperative launch). The composed stepper
runs its subcycles on the card through one of the two kernels as well
(`subcycle_route`).
"""

from __future__ import annotations

import torch

from omega_tpu_torch.core import aux as auxmod
from omega_tpu_torch.core import tendencies as tend_mod
from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import barotropic_kernel as btk
from omega_tpu_torch.ops import bt_gather, megastep, patch_megastep, trisk
from omega_tpu_torch.stepping.steppers import Halo, _identity, _mix


def _depth_avg_edge(h_edge, x):
    """Thickness-weighted depth average of an edge field: (E, K) -> (E, 1)."""
    ht = torch.sum(h_edge, dim=-1, keepdim=True)
    return torch.sum(h_edge * x, dim=-1, keepdim=True) / ht


def subcycle_route(mesh, ubar, halo, dt) -> str:
    """Where the composed split stepper runs its subcycles, each way one
    call for all M: "planar" (the planar kernel, ops/barotropic_kernel.py,
    on a CUDA array and a mesh it takes), "gather" (the gather-form kernel,
    ops/bt_gather.py, on a CUDA array and any other mesh: the gather
    layout, carved meshes, the sphere's configurations the framed path
    declines) or "plain" (the plain loop: a CPU array, a sharded halo's
    per-subcycle exchanges, a traced dt)."""
    if halo is not _identity or not isinstance(dt, (int, float)):
        return "plain"
    if btk.enabled(ubar) and btk.supported(mesh):
        return "planar"
    return "gather" if bt_gather.enabled(ubar) else "plain"


def split_forward_backward_step(mesh: HorzMesh, cfg: ModelConfig,
                                state: ModelState, t, dt,
                                halo: Halo = _identity, wind_stress=None,
                                n_subcycles: int = 10,
                                bt_drag: float = 0.0) -> ModelState:
    """One split-explicit step (barotropic FB subcycling inside).

    The fast system re-evaluates the SSH gradient AND the barotropic
    Coriolis term (+f u_perp via the tangential reconstruction) every
    subcycle. `bt_drag` adds an optional linear drag -r*ubar to the fast
    system; it is subtracted from the slow forcing too, so the scheme stays
    an exact rearrangement at t0."""
    if cfg.ssh_formulation != "column":
        raise ValueError(
            "the split-explicit stepper integrates the true free surface; "
            "set ModelConfig.ssh_formulation='column' (SshFormulation: "
            "Column) — the default 'stacked' per-layer ssh has no shared "
            "barotropic mode")
    if (halo is _identity and wind_stress is None
            and isinstance(dt, (int, float)) and megastep.enabled(state)
            and megastep.split_supported(mesh, cfg)):
        # fused path: splitpre kernels -> barotropic subcycle kernel ->
        # splitpost kernel (megastep.split_megastep_stacked)
        return megastep.split_megastep(mesh, cfg, state, t, dt, n_subcycles,
                                       bt_drag)
    if (halo is _identity and wind_stress is None
            and isinstance(dt, (int, float))
            and patch_megastep.enabled(state.h)
            and patch_megastep.split_patch_supported(mesh, cfg)):
        # the sphere's framed path for one step: splitpre, the flat 2-D
        # phase with the gather-form subcycle kernel, splitpost
        carry = patch_megastep.stack_frames(mesh, cfg, state)
        carry = patch_megastep.split_patch_megastep_framed(
            mesh, cfg, carry, t, dt, n_subcycles, bt_drag)
        return patch_megastep.unstack_frames(mesh, cfg, carry, type(state))
    h, u, tr = state
    g = cfg.gravity

    # --- mode split (thickness-weighted)
    thick_aux = auxmod.thickness_aux_edge(mesh, cfg, h, u)
    h_edge = thick_aux.mean_h_edge                         # (E, K)
    h_edge_tot = torch.sum(h_edge, dim=-1, keepdim=True)   # (E, 1)
    ubar = _depth_avg_edge(h_edge, u)                      # (E, 1)
    uprime = u - ubar

    # --- full 3-D tendency at the current state
    du_full, _ = tend_mod.compute_velocity_tendency(mesh, cfg, h, u, t,
                                                    wind_stress)
    du_bar = _depth_avg_edge(h_edge, du_full)              # (E, 1)

    # fast operator, re-evaluated every subcycle: SSH gradient +
    # barotropic Coriolis + optional linear drag (bt_gather.fast)
    ssh = (torch.sum(h, dim=-1, keepdim=True)
           - trisk.col(mesh, "bottom_depth"))
    du_fast0 = bt_gather.fast(mesh, ubar, ssh, g, bt_drag)   # (E, 1)
    g_slow = du_bar - du_fast0                             # held fixed

    # --- barotropic FB subcycles
    dt_bt = dt / n_subcycles

    # a sharded halo refreshes the 2-D fields every subcycle through its
    # per-array exchanges (identity on a single device)
    edge_ex = getattr(halo, "edge", None) or (lambda x: x)
    cell_ex = getattr(halo, "cell", None) or (lambda x: x)

    route = subcycle_route(mesh, ubar, halo, dt)
    if route == "planar":
        ub_final, _, ubar_avg = btk.bt_subcycles(
            mesh, ubar, ssh, g_slow, h_edge_tot, gravity=g, dt_bt=dt_bt,
            n_subcycles=n_subcycles, bt_drag=bt_drag)
    elif route == "gather":
        ub_final, _, ubar_avg = bt_gather.bt_subcycles(
            mesh, ubar, ssh, g_slow, h_edge_tot, gravity=g, dt_bt=dt_bt,
            n_subcycles=n_subcycles, bt_drag=bt_drag)
    else:
        ub_final, _, ubar_avg = bt_gather.subcycles_plain(
            mesh, ubar, ssh, g_slow, h_edge_tot, gravity=g, dt_bt=dt_bt,
            n_subcycles=n_subcycles, bt_drag=bt_drag, edge_ex=edge_ex,
            cell_ex=cell_ex)

    # --- baroclinic velocity update (slow modes only)
    uprime_new = uprime + dt * (du_full - du_bar)
    u_new = uprime_new + ub_final

    # --- thickness + tracers with the averaged transport velocity
    u_trans = uprime + ubar_avg
    dh = -trisk.div_cell(mesh, thick_aux.flux_h_edge * u_trans)
    h_new = h + dt * dh

    dtr, _ = tend_mod.compute_tracer_tendency(
        mesh, cfg, h, u_trans, tr, h_edge, t, h_new=h_new, dt=dt,
        flux_h_edge=thick_aux.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]

    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


# run_steps' stacked fast path reads these defaults when the bare function
# is passed as the stepper (the signature's defaults)
split_forward_backward_step.split_explicit_params = (10, 0.0)


def make_split_stepper(n_subcycles: int = 10, bt_drag: float = 0.0):
    """Stepper factory with a fixed subcycle count and optional linear
    barotropic drag (config `TimeIntegration: BarotropicSubcycles` /
    `BarotropicLinearDrag`)."""
    def step(mesh, cfg, state, t, dt, halo=_identity, wind_stress=None):
        return split_forward_backward_step(mesh, cfg, state, t, dt, halo,
                                           wind_stress, n_subcycles,
                                           bt_drag)
    # run_steps reads this to carry the stacked layout across a segment
    # when the fused split path applies
    step.split_explicit_params = (n_subcycles, bt_drag)
    return step
