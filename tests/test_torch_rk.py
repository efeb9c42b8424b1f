"""The Runge-Kutta steppers of the port against the JAX package in float64:
composed `rk2_step` / `rk4_step` over 3 / 2 steps at the JAX suite's 1e-10
(tests/test_structured.py:198, 233, 405) on the flagship, upwind, wind +
drag + constant mixing and wind + drag + PP81 configurations; the RK stage
kernel's plain versions (whole grid and tiled as the kernel cuts its slabs)
against the composed steppers and one against the JAX fused RK2 kernel in
interpret mode; `run_steps`' stacked RK path; `make_stepper`;
`megastep.supported` per stepper against the JAX package's; the tendency
chain's ring; the manufactured-solution forcing at 1e-12 and the steppers'
temporal order on it."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_call, jax_mesh, jax_state,
                                jax_wind, port_cfg, port_mesh, port_state,
                                port_wind, random_fields, science_cfg,
                                stratified_fields, wind_fields)

import jax.numpy as jnp

from omega_tpu.core import ManufacturedConfig as JManufacturedConfig
from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.core import manufactured as jman
from omega_tpu.core import tendencies as jtend
from omega_tpu.ops import megastep as jmegastep
from omega_tpu.stepping import rk2_step as jrk2
from omega_tpu.stepping import rk4_step as jrk4

from omega_tpu_torch.core import ModelState, manufactured, tendencies
from omega_tpu_torch.ops import megastep, vmix_kernel
from omega_tpu_torch.stepping import (forward_backward_step, make_stepper,
                                      rk2_step, rk4_step, run_steps)

K, L, DT = 3, 2, 30.0
# configuration -> (flagship_cfg / science_cfg name, fields)
CONFIGS = {"flagship": None, "upwind": "upwind",
           "vmix_wind_drag": "vmix_wind_drag",
           "pp81_wind_drag": "pp81_wind_drag"}
STEPPERS = {"rk2": (rk2_step, jrk2, 3), "rk4": (rk4_step, jrk4, 2)}


def _setup(name, seed=3):
    jm = jax_mesh(32, 16)
    jcfg = flagship_cfg(K, L, tendencies=dict(eddy_diff4=1e6)) \
        if CONFIGS[name] is None else science_cfg(CONFIGS[name], K)
    fields = stratified_fields(jm, K, seed) if "pp81" in name \
        else random_fields(jm, K, L, seed)
    return jm, port_mesh(jm), jcfg, port_cfg(jcfg), fields, wind_fields(jm)


def _close(out, ref, tol=1e-10):
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(out, n).numpy(),
                                   np.asarray(getattr(ref, n)),
                                   rtol=tol, atol=tol, err_msg=n)


def _jitted_tendencies(monkeypatch, name, jm, jcfg):
    """The JAX steppers as they are, with their tendency evaluation
    (compute_all_tendencies, unchanged) compiled once per configuration
    and shared by RK2 and RK4; the steppers' own updates run eagerly."""
    full = jtend.compute_all_tendencies

    def tend(mesh, cfg, h, u, tr, t, wind_stress=None):
        return jax_call(("tendencies", name), lambda h, u, tr, t, w0, w1:
                        full(jm, jcfg, h, u, tr, t, (w0, w1)),
                        h, u, tr, jnp.asarray(t, jnp.float64), *wind_stress)
    monkeypatch.setattr(jtend, "compute_all_tendencies", tend)


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("name", CONFIGS)
def test_composed_rk_matches_jax(monkeypatch, name, stepper):
    jm, pm, jcfg, cfg, fields, wind = _setup(name)
    step, jstep, n = STEPPERS[stepper]
    assert megastep.supported(pm, cfg, stepper)   # the card would fuse it
    _jitted_tendencies(monkeypatch, name, jm, jcfg)
    js, ps = jax_state(*fields), port_state(*fields)
    for _ in range(n):
        js = jstep(jm, jcfg, js, 0.0, DT, wind_stress=jax_wind(wind))
        ps = step(pm, cfg, ps, 0.0, DT, wind_stress=port_wind(wind))
    _close(ps, js)


def _fused_plain(pm, cfg, s, stepper, wind, tile):
    fn = megastep.rk2_megastep_plain if stepper == "rk2" \
        else megastep.rk4_megastep_plain
    s = fn(pm, cfg, s, DT, tile=tile, wind=wind)
    if vmix_kernel.vmix_on(cfg):
        s = vmix_kernel.vmix_plain(pm, cfg, s, DT)
    return s


@pytest.mark.parametrize("tile", [None, (7, 5)], ids=["whole", "ragged7x5"])
@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("name", ["flagship", "pp81_wind_drag"])
def test_stage_plain_matches_composed(name, stepper, tile):
    """The kernel path's plain version (stage launches, then the column
    kernels' plain versions) against the port's composed stepper."""
    _, pm, _, cfg, fields, wind = _setup(name)
    step, _, n = STEPPERS[stepper]
    ref = port_state(*fields)
    pw = port_wind(wind)
    s = megastep.stack_state(pm, ref)
    plane = megastep.stack_wind(pm, cfg, pw, s.dtype)
    for _ in range(n):
        ref = step(pm, cfg, ref, 0.0, DT, wind_stress=pw)
        s = _fused_plain(pm, cfg, s, stepper, plane, tile)
    _close(megastep.unstack_state(pm, s, K, L, ModelState), ref)


def test_stage_plain_matches_jax_pallas_rk2_kernel():
    """Against the JAX fused RK2 kernel (kind "rk2", both chains in one
    launch) in interpret mode, one step, 1e-10."""
    jm, pm, jcfg, cfg, fields, _ = _setup("upwind")
    assert jmegastep.supported(jm, jcfg, kind="rk2")
    jout = jmegastep.rk2_megastep(jm, jcfg, jax_state(*fields), 0.0, DT,
                                  interpret=True)
    _close(megastep.rk2_megastep(pm, cfg, port_state(*fields), 0.0, DT),
           jout)


def test_stage_epilogues_are_the_steppers_updates():
    """Each stage mode's outputs from given tendencies, against the
    composed steppers' expressions written out."""
    _, pm, _, cfg, fields, _ = _setup("flagship")
    s = megastep.stack_state(pm, port_state(*fields))
    k = megastep.tend_plain(pm, cfg, s)
    acc, out = megastep._stage_epilogue(k, megastep.RK_FIRST, 15.0, 5.0, s,
                                        None)
    assert torch.equal(acc[0], s[0] + 5.0 * k[0])
    assert torch.equal(acc[4:], s[4:] * s[0] + 5.0 * k[4:])
    assert torch.equal(out[0], s[0] + 15.0 * k[0])
    assert torch.equal(out[4:], (s[4:] * s[0] + 15.0 * k[4:]) / out[0])
    assert megastep._stage_epilogue(k, megastep.RK_PROV, 15.0, 5.0, s,
                                    None)[0] is None
    acc2, _ = megastep._stage_epilogue(k, megastep.RK_MID, 15.0, 5.0, s, acc)
    assert torch.equal(acc2, acc + 5.0 * k)
    none, last = megastep._stage_epilogue(k, megastep.RK_LAST, 0.0, 5.0,
                                          None, acc)
    assert none is None and torch.equal(last[4:],
                                        (acc[4:] + 5.0 * k[4:]) / last[0])


@pytest.mark.parametrize("stepper", STEPPERS)
def test_run_steps_stacked_rk_path_matches_composed_loop(monkeypatch,
                                                         stepper):
    """The stacked RK fast path of run_steps (taken for a CUDA state; here
    forced on the CPU, where the stage wrappers run the plain versions),
    and the single-step fused dispatch, against the composed loop."""
    _, pm, _, cfg, fields, wind = _setup("pp81_wind_drag")
    step, _, n = STEPPERS[stepper]
    st, pw = port_state(*fields), port_wind(wind)
    ref = run_steps(pm, cfg, st, 0.0, DT, n, stepper=step, wind_stress=pw)
    monkeypatch.setattr(megastep, "enabled", lambda state: True)
    calls = []
    plain = megastep.rk2_megastep_plain if stepper == "rk2" \
        else megastep.rk4_megastep_plain
    name = plain.__name__
    monkeypatch.setattr(megastep, name,
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    fused = run_steps(pm, cfg, st, 0.0, DT, n, stepper=step, wind_stress=pw)
    assert len(calls) == n
    one = step(pm, cfg, st, 0.0, DT, wind_stress=pw)
    assert len(calls) == n + 1
    for a, b in zip(fused, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    again = run_steps(pm, cfg, st, 0.0, DT, 1, stepper=step, wind_stress=pw)
    for a, b in zip(one, again):
        assert torch.equal(a, b)


def test_rk4_step_with_a_halo_takes_the_composed_path(monkeypatch):
    """The fused RK4 step makes no stage-2 exchange: with a real `halo`
    rk4_step runs the composed stages, which call it at stage 2 and at the
    end, even where the fused path would be taken."""
    _, pm, _, cfg, fields, _ = _setup("flagship")
    st = port_state(*fields)
    ref = rk4_step(pm, cfg, st, 0.0, DT)
    monkeypatch.setattr(megastep, "enabled", lambda state: True)
    fused = []
    monkeypatch.setattr(megastep, "rk4_megastep",
                        lambda *a, **k: fused.append(1) or st)
    halos = []
    out = rk4_step(pm, cfg, st, 0.0, DT,
                   halo=lambda s: halos.append(1) or s)
    assert fused == [] and len(halos) == 2
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    rk4_step(pm, cfg, st, 0.0, DT)
    assert fused == [1]


def test_stage_wrapper_takes_no_cpu_array_and_counts_nothing():
    _, pm, _, cfg, fields, _ = _setup("flagship")
    s = megastep.stack_state(pm, port_state(*fields))
    before = megastep.rk_launches
    with pytest.raises(ValueError):
        megastep.rk_stage(pm, cfg, megastep.RK_PROV, 15.0, 0.0, s,
                          torch.empty_like(s), base=s)
    out = torch.empty_like(s)
    res = megastep.rk4_megastep_stacked(pm, cfg, s, DT, out=out)
    assert res is out and megastep.rk_launches == before
    assert torch.equal(out, megastep.rk4_megastep_plain(pm, cfg, s, DT))


@pytest.mark.parametrize("name,expected", [
    ("Forward-Backward", forward_backward_step),
    ("RungeKutta2", rk2_step),
    ("RungeKutta4", rk4_step),
    ("runge_kutta_4", rk4_step),
])
def test_make_stepper(name, expected):
    assert make_stepper(name) is expected


# option -> flagship_cfg keywords, on the 32 x 16 mesh (the JAX kernel's
# TPU tiles refuse some smaller meshes for RK2's wider ring; the port's
# ragged tiles take any)
SUPPORT = {
    "flagship": {},
    "upwind": dict(flux_thickness_type="upwind", flux_tracer_type="upwind"),
    "fct": dict(flux_tracer_type="fct"),
    "fct_upwind": dict(flux_thickness_type="upwind", flux_tracer_type="fct"),
    "wind_drag": dict(tendencies=dict(wind_forcing=True, bottom_drag=True,
                                      bottom_drag_coeff=3e-3)),
    "pp81": dict(vert_mix=JVertMixConfig(enabled=True, scheme="pp81")),
    "thomas": dict(vert_mix=JVertMixConfig(enabled=True, method="thomas")),
    "column_ssh": dict(ssh_formulation="column"),
    "custom": dict(tendencies=dict(use_custom_tendency=True,
                                   manufactured_tendency=True)),
    "no_hyperdiff": dict(tendencies=dict(tracer_hyperdiff=False)),
}


@pytest.mark.parametrize("what", SUPPORT)
def test_supported_per_stepper_agrees_with_jax(what):
    jm = jax_mesh(32, 16)
    pm = port_mesh(jm)
    kw = dict(SUPPORT[what])
    jcfg = flagship_cfg(K, L, tendencies=kw.pop("tendencies", {}), **kw)
    cfg = port_cfg(jcfg)
    got = {kind: megastep.supported(pm, cfg, kind)
           for kind in ("fb", "rk2", "rk4")}
    assert got == {kind: jmegastep.supported(jm, jcfg, kind=kind)
                   for kind in ("fb", "rk2", "rk4")}
    if what.startswith("fct"):
        assert got == {"fb": True, "rk2": False, "rk4": False}


TEND_VARIANTS = {"center": "flagship", "upwind_tails": "upwind"}


@pytest.mark.parametrize("variant", TEND_VARIANTS)
def test_tendency_chain_radius_is_tight(variant):
    """The RK stage's chain (every aux at one level) has its own ring: it
    keeps tiles exact, and one row or one column fewer does not."""
    jm, pm, _, cfg, _, wind = _setup(TEND_VARIANTS[variant])
    tails = variant.endswith("tails")
    cfg = dataclasses.replace(cfg, tendencies=dataclasses.replace(
        cfg.tendencies, wind_forcing=tails, bottom_drag=tails,
        bottom_drag_coeff=3e-3, eddy_diff4=1e6))
    s = megastep.stack_state(pm, port_state(*random_fields(jm, K, L, 0)))
    plane = megastep.stack_wind(pm, cfg, port_wind(wind), s.dtype)
    tabs, consts = megastep._mega_args(pm, cfg, DT)
    ry, rx = megastep._ring(tabs, consts, plane, "rk")
    assert (ry, rx) == megastep.chain_radius(tabs, consts["uph"],
                                             consts["upt"], tails,
                                             kind="rk")
    assert 1 <= ry <= 3 and 1 <= rx <= 3
    whole = megastep.tend_plain(pm, cfg, s, wind=plane)
    assert torch.equal(megastep.tend_plain(pm, cfg, s, tile=(4, 8),
                                           wind=plane), whole)
    for ring in ((ry - 1, rx), (ry, rx - 1)):
        short = megastep.tend_plain(pm, cfg, s, tile=(4, 8), ring=ring,
                                    wind=plane)
        assert not torch.equal(short, whole), ring


# ---- the manufactured solution ------------------------------------------

def _manufactured(nx, jax_side=True):
    """The JAX suite's manufactured setup (tests/test_model.py:79-101):
    one layer, no tracers, del2 on with zero viscosity, RK4-grade forcing."""
    jm = jax_mesh(nx, nx, dc=5.0e6 / nx, f0=1e-4, bottom_depth=1000.0)
    jcfg = JModelConfig(
        nvertlayers=1, ntracers=0,
        manufactured=JManufacturedConfig(wavelength_x=jm.x_period,
                                         wavelength_y=jm.y_period,
                                         amplitude=2.0),
        tendencies=JTendencyConfig(
            velocity_diffusion=True, visc_del2=0.0,
            velocity_hyperdiff=False, visc_del4=0.0,
            tracer_horz_adv=False, tracer_diffusion=False,
            tracer_hyperdiff=False,
            use_custom_tendency=True, manufactured_tendency=True))
    pm = port_mesh(jm)
    cfg = port_cfg(jcfg)
    p = manufactured.make_params(cfg, 1000.0)
    h = 1000.0 + manufactured.exact_ssh(p, pm.x_cell, pm.y_cell, 0.0)[:, None]
    u = manufactured.exact_normal_velocity(p, pm, 0.0)[:, None]
    st = ModelState(h=h, u=u, tracers=torch.zeros((0, pm.ncells, 1),
                                                  dtype=torch.float64))
    return jm, pm, jcfg, cfg, p, st


def test_manufactured_forcing_matches_jax():
    jm, pm, jcfg, cfg, p, st = _manufactured(16)
    jp = jman.make_params(jcfg, 1000.0)
    assert dataclasses.asdict(jp) == dataclasses.asdict(p)
    t = 123.0
    pairs = [
        (manufactured.exact_ssh(p, pm.x_cell, pm.y_cell, t),
         jman.exact_ssh(jp, jm.x_cell, jm.y_cell, t)),
        (manufactured.exact_normal_velocity(p, pm, t),
         jman.exact_normal_velocity(jp, jm, t)),
        (manufactured.thickness_tendency(p, pm, t),
         jman.thickness_tendency(jp, jm, t)),
        (manufactured.velocity_tendency(p, pm, cfg, t),
         jman.velocity_tendency(jp, jm, jcfg, t))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    # the hooks add them to the tendencies (no NotImplementedError now)
    js = jax_state(st.h.numpy(), st.u.numpy(), st.tracers.numpy())
    jt = jax_call(("manufactured tendencies",), lambda h, u, tr:
                  jtend.compute_all_tendencies(jm, jcfg, h, u, tr, t),
                  js.h, js.u, js.tracers)
    pt = tendencies.compute_all_tendencies(pm, cfg, st.h, st.u, st.tracers, t)
    for got, want in ((pt.dh, jt.dh), (pt.du, jt.du)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    assert not megastep.supported(pm, cfg, "rk4")    # runs composed


def test_stepper_temporal_order_on_the_manufactured_solution():
    """Halving dt cuts the time error as each stepper's order says
    (test_model.py:141-166's bounds), against one fine RK4 run over the
    same horizon: FB > 0.85, RK2 > 1.6, RK4 > 3.2."""
    _, pm, _, cfg, _, st = _manufactured(16)
    horizon = 1600.0
    ref = run_steps(pm, cfg, st, 0.0, horizon / 128, 128, stepper=rk4_step)

    def err(stepper, n):
        out = run_steps(pm, cfg, st, 0.0, horizon / n, n, stepper=stepper)
        return float(torch.sqrt(torch.mean((out.h - ref.h) ** 2)))

    orders = {name: np.log2(err(s, n1) / err(s, n2))
              for name, s, n1, n2 in (("fb", forward_backward_step, 16, 32),
                                      ("rk2", rk2_step, 4, 8),
                                      ("rk4", rk4_step, 4, 8))}
    assert orders["fb"] > 0.85 and orders["rk2"] > 1.6 \
        and orders["rk4"] > 3.2, orders
