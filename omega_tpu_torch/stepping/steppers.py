"""Time steppers — state -> state maps.

Counterpart of src/timeStepping/ForwardBackwardStepper.cpp:27-82. The
reference mutates circular time-level buffers and triggers MPI halo
exchanges inside updateTimeLevels; here each stepper returns a new state
and the halo exchange is an injectable `halo` callback (identity on a
single device; the distributed exchanges arrive with parallel/).

Tracer updates are thickness-weighted exactly as TimeStepper.h:205-237:
    tr^{n+1} = (tr^n h^n + sum_s b_s dt R_s) / h^{n+1}

RK2, RK4 and the split-explicit stepper arrive with later slices.
"""

from __future__ import annotations

from typing import Callable

import torch

from omega_tpu_torch.core import tendencies as tend_mod
from omega_tpu_torch.core import vmix
from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import megastep, trisk

Halo = Callable[[ModelState], ModelState]
_identity: Halo = lambda s: s


def _mix(mesh, cfg, state, dt):
    """Operator-split backward-Euler vertical mixing applied after the
    horizontal update (the implicit stage the reference's tridiagonal
    solvers exist for, base/TriDiagSolvers.h:28-35). Unconditionally
    stable; conserves h-weighted tracer columns exactly."""
    vm = cfg.vert_mix
    if not vm.enabled or cfg.nvertlayers < 2:
        return state
    h, u, tr = state
    h_edge = trisk.cell_mean_on_edge(mesh, h)
    if vm.scheme == "pp81":
        kt, km = vmix.pp81_coefficients(mesh, vm, cfg.gravity, h, u, tr)
    else:
        kt = vm.kappa_tracer * torch.ones_like(h[..., :-1])
        km = vm.kappa_momentum * torch.ones_like(h_edge[..., :-1])
    tr_new = vmix.implicit_vmix(h[None], kt[None], dt, tr, method=vm.method)
    u_new = vmix.implicit_vmix(h_edge, km, dt, u, method=vm.method)
    return ModelState(h=h, u=u_new, tracers=tr_new)


def forward_backward_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
                          t, dt, halo: Halo = _identity,
                          wind_stress=None) -> ModelState:
    """Forward h/tracer update, backward u update (uses new h)."""
    tend_mod.check_ported(cfg)
    if (isinstance(dt, (int, float)) and megastep.enabled(state)
            and megastep.supported(mesh, cfg)):
        # the fused path (ops/megastep.py): one kernel reads the state once
        # and writes it once, wind and drag included; vertical mixing
        # follows in the column kernels on the same array
        return halo(megastep.fb_megastep(mesh, cfg, state, t, dt,
                                         wind_stress))
    h, u, tr = state
    dh, thick_aux = tend_mod.compute_thickness_tendency(mesh, cfg, h, u, t)
    h_new = h + dt * dh

    dtr, _ = tend_mod.compute_tracer_tendency(
        mesh, cfg, h, u, tr, thick_aux.mean_h_edge, t, h_new=h_new, dt=dt,
        flux_h_edge=thick_aux.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]

    du, _ = tend_mod.compute_velocity_tendency(
        mesh, cfg, h_new, u, t + dt, wind_stress)
    u_new = u + dt * du

    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


_STEPPERS = {
    "forward-backward": forward_backward_step,
}


def make_stepper(name: str):
    key = name.lower().replace(" ", "").replace("_", "").replace("-", "")
    for k, fn in _STEPPERS.items():
        if k.replace("-", "") == key:
            return fn
    raise ValueError(f"unknown time stepper: {name!r} "
                     f"(expected one of {sorted(_STEPPERS)})")


def run_steps(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
              t0, dt, nsteps: int, stepper=forward_backward_step,
              halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Advance `nsteps` (the ocnRun loop, ocn/OceanRun.cpp:16-70, minus
    host-side IO, which the model's run loop does between segments)."""
    tend_mod.check_ported(cfg)
    if (stepper is forward_backward_step and halo is _identity
            and isinstance(dt, (int, float)) and megastep.enabled(state)
            and megastep.supported(mesh, cfg)):
        # stacked fast path: the fused kernel's single (4+L, K, ny, nx)
        # array is carried across the segment in two buffers that swap
        # roles, so each step is the fused path's kernel launches (one, or
        # up to three with vertical mixing) and no other device work; the
        # wind plane is packed once per segment
        h, _, tr = state
        cur = megastep.stack_state(mesh, state)
        nxt = cur.new_empty(cur.shape)
        wind = megastep.stack_wind(mesh, cfg, wind_stress, h.dtype)
        for _ in range(nsteps):
            megastep.fb_megastep_stacked(mesh, cfg, cur, dt, out=nxt,
                                         wind=wind)
            cur, nxt = nxt, cur
        return megastep.unstack_state(mesh, cur, h.shape[-1], tr.shape[0],
                                      type(state))

    t = t0
    for _ in range(nsteps):
        state = stepper(mesh, cfg, state, t, dt, halo, wind_stress)
        t = t + dt
    return state
