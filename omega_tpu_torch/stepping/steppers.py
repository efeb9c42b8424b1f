"""Time steppers — state -> state maps.

Counterpart of src/timeStepping/: ForwardBackwardStepper.cpp:27-82,
RungeKutta2Stepper.cpp:25-75, RungeKutta4Stepper.cpp:68-137. The reference
mutates circular time-level buffers and triggers MPI halo exchanges inside
updateTimeLevels; here each stepper returns a new state and the halo
exchange is an injectable `halo` callback (identity on a single device; a
shard's exchange over the shard list under parallel/sharded.py). RK4 applies `halo` to the
provisional state at stage 2, matching the reference's width-3-halo
amortization (RungeKutta4Stepper.cpp:107-114).

Tracer updates are thickness-weighted exactly as TimeStepper.h:205-237:
    tr^{n+1} = (tr^n h^n + sum_s b_s dt R_s) / h^{n+1}

For a state on a CUDA device and a configuration the fused kernels take
(`megastep.supported`), each stepper runs them: one launch per FB step, two
per RK2 step, four per RK4 step (ops/megastep.py), plus the column kernels
of vertical mixing. The split-explicit stepper is stepping/split.py
(`make_stepper("SplitExplicit")`); for a CUDA state of the configuration
its kernels take (`megastep.split_supported`) a step is splitpre, the
barotropic subcycles and splitpost.

On a patch-renumbered icosahedral mesh (mesh/icos_patches.py) the FB step
of the configurations `patch_megastep.supported` names (center or upwind
fluxes, wind, bottom drag, PCR vertical mixing with constant or PP81
coefficients) is fused (ops/patch_megastep.py): one call of the patch
kernel (six launches) per step, then with vertical mixing the PP81
coefficient kernel and the column-solve kernel (one launch each), the pole
rows from the composed step on a small submesh. `run_steps` keeps the halo
frames as its carry on any device (the kernels' plain versions on the CPU)
and lays the wind into the frames once per segment; `forward_backward_step`
takes the per-step API for a CUDA state. In `run_steps` alone, FCT tracer
fluxes without vertical mixing are fused too: per step FCT's stage A (the
patch kernel's FCT variant, six launches), the refresh of its fields,
stage B (the limiter, four launches), the FCT fix submesh's composed step
and the final refresh. So are the RK steppers, in the same configurations
as the FB step but FCT: per stage one call of the RK stage kernel (five
launches; RK2 two stages, RK4 four), the pole submesh's tendencies at that
stage and the in-frame refresh, then with vertical mixing the column
kernels. So is the split-explicit stepper with the column free surface,
center fluxes and no wind, drag or mixing (`split_patch_supported`): per
step splitpre (five launches), the flat 2-D phase with the barotropic
subcycles (ops/bt_gather.py, one cooperative launch for all M), splitpost (four
launches), the pole submesh's composed part and the refresh;
`split_forward_backward_step` takes it step by step for a CUDA state. The
Thomas method, column ssh with the unsplit steppers, FCT in the per-step
API, with mixing or under RK, custom tendencies, the split stepper's other
configurations and `rk2_step` / `rk4_step` called step by step run composed
through the patch operators (ops/patch_stencil.py).
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from omega_tpu_torch.core import tendencies as tend_mod
from omega_tpu_torch.core import vmix
from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.ops import megastep, patch_megastep, trisk

Halo = Callable[[ModelState], ModelState]
_identity: Halo = lambda s: s


def _halo_overlap_enabled() -> bool:
    """OMEGA_HALO_OVERLAP=0 restores the trailing full-state exchange
    (A/B knob; the overlap is bit-identical and the default)."""
    return os.environ.get("OMEGA_HALO_OVERLAP", "1") != "0"


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
    if _fused(mesh, cfg, state, dt, "fb"):
        # the fused path (ops/megastep.py): one kernel reads the state once
        # and writes it once, wind and drag included; vertical mixing
        # follows in the column kernels on the same array
        return halo(megastep.fb_megastep(mesh, cfg, state, t, dt,
                                         wind_stress))
    if (isinstance(dt, (int, float)) and patch_megastep.enabled(state.h)
            and patch_megastep.supported(mesh, cfg)):
        # the sphere's fused step (ops/patch_megastep.py), per-step API
        return halo(patch_megastep.fb_patch_megastep(mesh, cfg, state, t,
                                                     dt, wind_stress))
    h, u, tr = state
    dh, thick_aux = tend_mod.compute_thickness_tendency(mesh, cfg, h, u, t)
    h_new = h + dt * dh

    dtr, _ = tend_mod.compute_tracer_tendency(
        mesh, cfg, h, u, tr, thick_aux.mean_h_edge, t, h_new=h_new, dt=dt,
        flux_h_edge=thick_aux.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]

    # Compute/comm overlap (the reference's MPI_Test poll-and-unpack loop,
    # base/Halo.h:849-881): once h and the tracers are updated their owned
    # boundary rows are final, so the cell-space exchange is STARTED here
    # (on CUDA on a side stream, parallel/sharded.shard_halos) and its
    # result read only after the velocity stage, which runs on the shard's
    # own stream meanwhile. The velocity tendency reads the LOCAL
    # pre-exchange h_new (identical values on the rings it touches:
    # width-3 halos keep rings 1-2 of h_new exact after a radius-1
    # update), so results are bit-identical to the trailing exchange.
    # Implicit vertical mixing modifies u/tracers after this point, so
    # with vmix enabled the step keeps the single trailing exchange.
    cell_ex = getattr(halo, "cell", None)
    overlap = (cell_ex is not None and _halo_overlap_enabled()
               and not (cfg.vert_mix.enabled and cfg.nvertlayers >= 2))
    if overlap:
        bundle = torch.cat([h_new[None], tr_new], 0)
        start = getattr(halo, "cell_async", None)
        if start is not None:
            fetch = start(bundle)
        else:
            done = cell_ex(bundle)
            fetch = lambda: done

    du, _ = tend_mod.compute_velocity_tendency(
        mesh, cfg, h_new, u, t + dt, wind_stress)
    u_new = u + dt * du

    if overlap:
        bundle = fetch()
        return ModelState(h=bundle[0], u=halo.edge(u_new),
                          tracers=bundle[1:])
    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


def rk2_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
             t, dt, halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Midpoint method (RungeKutta2Stepper.cpp:25-75)."""
    if _fused(mesh, cfg, state, dt, "rk2"):
        # two launches of the RK stage kernel (ops/megastep.py), then the
        # column kernels of vertical mixing
        return halo(megastep.rk2_megastep(mesh, cfg, state, t, dt,
                                          wind_stress))
    h, u, tr = state

    k1 = tend_mod.compute_all_tendencies(mesh, cfg, h, u, tr, t, wind_stress)
    h_mid = h + 0.5 * dt * k1.dh
    u_mid = u + 0.5 * dt * k1.du
    tr_mid = (tr * h[None] + 0.5 * dt * k1.dtr) / h_mid[None]

    k2 = tend_mod.compute_all_tendencies(mesh, cfg, h_mid, u_mid, tr_mid,
                                         t + 0.5 * dt, wind_stress)
    h_new = h + dt * k2.dh
    u_new = u + dt * k2.du
    tr_new = (tr * h[None] + dt * k2.dtr) / h_new[None]

    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


# the fused path's tables: stage weights a (also the stage times) and b
_RKA, _RKB = megastep.RK4_A, megastep.RK4_B


def rk4_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
             t, dt, halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Classic RK4 with thickness-weighted tracer accumulation
    (RungeKutta4Stepper.cpp:68-137), including the stage-2 halo refresh of
    the provisional state."""
    if halo is _identity and _fused(mesh, cfg, state, dt, "rk4"):
        # four launches of the RK stage kernel (ops/megastep.py); they make
        # no stage-2 exchange, so a real `halo` takes the composed path
        return halo(megastep.rk4_megastep(mesh, cfg, state, t, dt,
                                          wind_stress))
    h, u, tr = state

    k = tend_mod.compute_all_tendencies(mesh, cfg, h, u, tr, t, wind_stress)
    h_acc = h + _RKB[0] * dt * k.dh
    u_acc = u + _RKB[0] * dt * k.du
    tr_acc = tr * h[None] + _RKB[0] * dt * k.dtr

    for stage in range(1, 4):
        h_prov = h + _RKA[stage] * dt * k.dh
        u_prov = u + _RKA[stage] * dt * k.du
        tr_prov = (tr * h[None] + _RKA[stage] * dt * k.dtr) / h_prov[None]
        if stage == 2:
            # width-3 halo supports 2 stages between exchanges
            prov = halo(ModelState(h=h_prov, u=u_prov, tracers=tr_prov))
            h_prov, u_prov, tr_prov = prov
        k = tend_mod.compute_all_tendencies(
            mesh, cfg, h_prov, u_prov, tr_prov, t + _RKA[stage] * dt,
            wind_stress)
        h_acc = h_acc + _RKB[stage] * dt * k.dh
        u_acc = u_acc + _RKB[stage] * dt * k.du
        tr_acc = tr_acc + _RKB[stage] * dt * k.dtr

    tr_new = tr_acc / h_acc[None]
    out = _mix(mesh, cfg, ModelState(h=h_acc, u=u_acc, tracers=tr_new), dt)
    return halo(out)


def _fused(mesh, cfg, state, dt, kind) -> bool:
    """Whether a step of `kind` ("fb", "rk2", "rk4") takes the fused
    kernels: a state on a CUDA device, a Python-number dt and a
    configuration they implement."""
    return (isinstance(dt, (int, float)) and megastep.enabled(state)
            and megastep.supported(mesh, cfg, kind))


_STEPPERS = {
    "forward-backward": forward_backward_step,
    "rungekutta2": rk2_step,
    "rungekutta4": rk4_step,
}
_KIND = {forward_backward_step: "fb", rk2_step: "rk2", rk4_step: "rk4"}


def _split_stepper(*args, **kw):
    from omega_tpu_torch.stepping.split import split_forward_backward_step
    return split_forward_backward_step(*args, **kw)


_split_stepper.split_explicit_params = (10, 0.0)
_STEPPERS["splitexplicit"] = _split_stepper


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
    kind = _KIND.get(stepper)
    if (kind is not None and halo is _identity
            and _fused(mesh, cfg, state, dt, kind)):
        # stacked fast path: the fused kernels' single (4+L, K, ny, nx)
        # array is carried across the segment, so a step is the fused
        # path's kernel launches (FB: one; RK2: two; RK4: four; plus the
        # column kernels with vertical mixing) and no other device work.
        # FB and RK2 write the next state into a second buffer and the two
        # swap roles; RK4's last stage writes the state in place. The
        # stages' work arrays and the wind plane are made once per segment.
        h, _, tr = state
        cur = megastep.stack_state(mesh, state)
        wind = megastep.stack_wind(mesh, cfg, wind_stress, h.dtype)
        if kind == "rk4":
            work = megastep.rk_work(cur, 3)
            for _ in range(nsteps):
                megastep.rk4_megastep_stacked(mesh, cfg, cur, dt, out=cur,
                                              wind=wind, work=work)
        else:
            nxt = cur.new_empty(cur.shape)
            step = megastep.fb_megastep_stacked
            kw = {}
            if kind == "rk2":
                step = megastep.rk2_megastep_stacked
                kw = dict(work=megastep.rk_work(cur, 1))
            for _ in range(nsteps):
                step(mesh, cfg, cur, dt, out=nxt, wind=wind, **kw)
                cur, nxt = nxt, cur
        return megastep.unstack_state(mesh, cur, h.shape[-1], tr.shape[0],
                                      type(state))

    if (kind is not None and halo is _identity
            and isinstance(dt, (int, float))
            and patch_megastep.supported(mesh, cfg, framed=True, kind=kind)):
        # the sphere's framed path: the (frames, pole rows) carry of
        # ops/patch_megastep.py lives across the segment, so a step is the
        # patch kernels (their plain versions on the CPU), the pole
        # submesh's composed part and the in-frame refresh (FCT: its two
        # stages, the refresh between them, the FCT submesh's step; RK2 /
        # RK4: the RK stage kernel, the submesh's tendencies and the
        # refresh per stage); the next frames go into a second buffer and
        # the two swap roles, and the wind frames and the kernels' scratch
        # (RK: the provisional frames and the accumulator too) are made once
        carry = patch_megastep.stack_frames(mesh, cfg, state)
        nxt = torch.empty_like(carry[0])
        wind = patch_megastep.make_wind(mesh, cfg, wind_stress,
                                        state.h.dtype)
        pstep, kw = patch_megastep.framed_stepper(cfg, kind, carry[0])
        t = t0
        for _ in range(nsteps):
            cur = carry[0]
            carry = pstep(mesh, cfg, carry, t, dt, out=nxt, wind=wind, **kw)
            nxt = cur
            t = t + dt
        return patch_megastep.unstack_frames(mesh, cfg, carry, type(state))

    split_params = getattr(stepper, "split_explicit_params", None)
    if (split_params is not None and halo is _identity
            and wind_stress is None and isinstance(dt, (int, float))
            and patch_megastep.split_patch_supported(mesh, cfg)):
        # the sphere's framed split-explicit path: per step splitpre, the
        # flat 2-D phase with the barotropic subcycles, splitpost, the pole
        # submesh's composed part and the refresh (their plain versions on
        # the CPU); the next frames go into a second buffer and the two swap
        # roles, and du_out and the kernels' work fields are made once
        n_sub, r_drag = split_params
        carry = patch_megastep.stack_frames(mesh, cfg, state)
        nxt = torch.empty_like(carry[0])
        scratch = patch_megastep.new_split_scratch(carry[0])
        t = t0
        for _ in range(nsteps):
            cur = carry[0]
            carry = patch_megastep.split_patch_megastep_framed(
                mesh, cfg, carry, t, dt, n_sub, r_drag, out=nxt,
                work=scratch)
            nxt = cur
            t = t + dt
        return patch_megastep.unstack_frames(mesh, cfg, carry, type(state))

    if (split_params is not None and halo is _identity
            and wind_stress is None and isinstance(dt, (int, float))
            and megastep.enabled(state)
            and megastep.split_supported(mesh, cfg)):
        # split-explicit stacked fast path: splitpre, the barotropic
        # subcycles and splitpost per step on the stacked layout; the next
        # state goes into a second buffer and the two swap roles, and the
        # work arrays (du_full and the 2-D planes) are made once per segment
        n_sub, r_drag = split_params
        h, _, tr = state
        cur = megastep.stack_state(mesh, state)
        nxt = cur.new_empty(cur.shape)
        work = megastep.split_work(cur)
        for _ in range(nsteps):
            megastep.split_megastep_stacked(mesh, cfg, cur, dt, n_sub, r_drag,
                                            out=nxt, work=work)
            cur, nxt = nxt, cur
        return megastep.unstack_state(mesh, cur, h.shape[-1], tr.shape[0],
                                      type(state))

    t = t0
    for _ in range(nsteps):
        state = stepper(mesh, cfg, state, t, dt, halo, wind_stress)
        t = t + dt
    return state
