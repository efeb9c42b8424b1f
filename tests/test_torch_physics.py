"""The science options of the forward-backward configuration, port against
JAX package in float64: the wind-stress aux group, the wind and bottom-drag
blocks of the velocity tendency, and the composed forward-backward step
with upwind fluxes, wind, drag and implicit vertical mixing (constant and
PP81 coefficients, PCR and Thomas), the configurations of the JAX suite's
own tests (tests/test_structured.py).

Operators and tendencies at rtol 1e-12 (same expressions, same order); two
composed steps at rtol = atol = 1e-10, the JAX suite's figure for a step."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (MESHES, SCIENCE_CONFIGS, flagship_cfg,
                                jax_call, jax_mesh, jax_state, jax_wind,
                                port_cfg,
                                port_mesh, port_state, port_wind,
                                random_fields, science_cfg,
                                stratified_fields, wind_fields)

from omega_tpu.core import aux as jaux
from omega_tpu.core import tendencies as jtend
from omega_tpu.stepping import forward_backward_step as jfb

from omega_tpu_torch import convert
from omega_tpu_torch.core import aux, tendencies
from omega_tpu_torch.stepping import forward_backward_step

K, L = 4, 2


def _close(out, ref, what, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("interp", ["isotropic", "anisotropic"])
def test_wind_normal_stress_matches_jax(mesh, interp):
    jm = jax_mesh(*MESHES[mesh])
    pm = port_mesh(jm)
    jcfg = flagship_cfg(K, L, wind_interp_type=interp)
    rng = np.random.default_rng(7)
    wind = (wind_fields(jm)[0] + 0.01 * rng.standard_normal(jm.ncells),
            0.05 * rng.standard_normal(jm.ncells))
    ref = jax_call(("stress", mesh, interp),
                   lambda z, m: jaux.wind_normal_stress(jm, jcfg, z, m),
                   *jax_wind(wind))
    out = aux.wind_normal_stress(pm, port_cfg(jcfg), *port_wind(wind))
    assert tuple(out.shape) == (jm.nedges,)
    # atol: a stress of 0.1 rotated by cos(pi/2) leaves 1e-17
    _close(out, ref, "normal stress", atol=1e-16)


def test_wind_from_numpy_keeps_values_and_takes_dtype():
    z, m = np.linspace(0, 1, 8), np.ones(8)
    wz, wm = convert.wind_from_numpy(z, m, device="cpu")
    assert wz.dtype == torch.float64 and np.array_equal(wz.numpy(), z)
    w32 = convert.wind_from_numpy(z, m, device="cpu", dtype=torch.float32)
    assert w32[1].dtype == torch.float32 and len(w32) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            convert.wind_from_numpy(z, m)


PHYSICS = {"wind": dict(wind_forcing=True),
           "drag": dict(bottom_drag=True, bottom_drag_coeff=3e-3),
           "wind_drag": dict(wind_forcing=True, bottom_drag=True,
                             bottom_drag_coeff=3e-3),
           "drag_coeff_0": dict(bottom_drag=True)}


# center fluxes on every mesh, upwind thickness flux (mean_h is then the
# pair mean, not cmean) on one
TENDENCY_CASES = [(w, "center", m) for w in PHYSICS for m in MESHES] \
    + [(w, "upwind", "24x12") for w in PHYSICS]


@pytest.mark.parametrize("what,flux,mesh", TENDENCY_CASES,
                         ids=["-".join(c) for c in TENDENCY_CASES])
def test_velocity_tendency_with_wind_and_drag_matches_jax(what, flux, mesh):
    jm = jax_mesh(*MESHES[mesh])
    pm = port_mesh(jm)
    jcfg = flagship_cfg(K, L, flux_thickness_type=flux,
                        tendencies=PHYSICS[what])
    cfg = port_cfg(jcfg)
    f = random_fields(jm, K, L, seed=11)
    js, ps = jax_state(*f), port_state(*f)
    wind = wind_fields(jm)
    jdu, jmom = jax_call(
        ("du", what, flux, mesh),
        lambda h, u, w: jtend.compute_velocity_tendency(jm, jcfg, h, u, 0.0,
                                                        w),
        js.h, js.u, jax_wind(wind))
    pdu, pmom = tendencies.compute_velocity_tendency(pm, cfg, ps.h, ps.u, 0.0,
                                                     port_wind(wind))
    _close(pdu, jdu, "du", atol=1e-18)
    if jcfg.tendencies.wind_forcing:
        _close(pmom.normal_stress_edge, jmom.normal_stress_edge, "stress",
               atol=1e-16)
    else:
        assert pmom.normal_stress_edge is None
    # against the same configuration without the physics: only the top
    # layer (wind) and the bottom layer (drag) differ
    base = port_cfg(flagship_cfg(K, L, flux_thickness_type=flux))
    d = (pdu - tendencies.compute_velocity_tendency(pm, base, ps.h, ps.u,
                                                    0.0)[0]).abs()
    assert float(d[:, 1:-1].max()) == 0
    assert (float(d[:, 0].max()) > 0) == jcfg.tendencies.wind_forcing
    assert (float(d[:, -1].max()) > 0) == \
        (jcfg.tendencies.bottom_drag_coeff > 0)


def test_wind_forcing_without_a_stress_adds_nothing():
    jm = jax_mesh(16, 8)
    pm = port_mesh(jm)
    ps = port_state(*random_fields(jm, K, L, seed=2))
    cfg = port_cfg(flagship_cfg(K, L, tendencies=dict(wind_forcing=True)))
    base = port_cfg(flagship_cfg(K, L))
    a, mom = tendencies.compute_velocity_tendency(pm, cfg, ps.h, ps.u, 0.0)
    b, _ = tendencies.compute_velocity_tendency(pm, base, ps.h, ps.u, 0.0)
    assert mom.normal_stress_edge is None and torch.equal(a, b)


def test_all_tendencies_take_the_wind():
    jm = jax_mesh(24, 12)
    pm = port_mesh(jm)
    jcfg = science_cfg("wind_drag", K)
    f = random_fields(jm, K, L, seed=4)
    js, ps = jax_state(*f), port_state(*f)
    wind = wind_fields(jm)
    jt = jax_call("all tendencies", lambda s, w: jtend.compute_all_tendencies(
        jm, jcfg, s.h, s.u, s.tracers, 0.0, w), js, jax_wind(wind))
    pt = tendencies.compute_all_tendencies(pm, port_cfg(jcfg), ps.h, ps.u,
                                           ps.tracers, 0.0, port_wind(wind))
    _close(pt.du, jt.du, "du", atol=1e-18)
    _close(pt.dh, jt.dh, "dh")


# ---- the composed forward-backward step, two steps ----------------------

STEP_CONFIGS = dict(SCIENCE_CONFIGS)
STEP_CONFIGS["vmix_thomas_wind_drag"] = dict(
    SCIENCE_CONFIGS["vmix_wind_drag"],
    vert_mix=dataclasses.replace(SCIENCE_CONFIGS["vmix_wind_drag"]["vert_mix"],
                                 method="thomas"))
STEP_CONFIGS["pp81_thomas"] = dict(
    vert_mix=dataclasses.replace(SCIENCE_CONFIGS["pp81_wind_drag"]["vert_mix"],
                                 method="thomas"))


# every configuration at 32x16x5; the solvers' edge cases (one layer, two,
# a count that is no power of two) for those that mix vertically
STEP_CASES = [(n, "32x16", 5) for n in STEP_CONFIGS] + [
    (n, mesh, Kk)
    for n in ("vmix_wind_drag", "vmix_thomas_wind_drag", "pp81_wind_drag",
              "all")
    for mesh, Kk in (("24x12", 7), ("16x8", 2), ("16x8", 1))]


@pytest.mark.parametrize("name,mesh,Kk", STEP_CASES,
                         ids=[f"{n}-{m}x{k}" for n, m, k in STEP_CASES])
def test_composed_step_matches_jax_over_2_steps(name, mesh, Kk):
    jm = jax_mesh(*MESHES[mesh])
    pm = port_mesh(jm)
    kw = dict(STEP_CONFIGS[name])
    jcfg = flagship_cfg(Kk, L, tendencies=dict(kw.pop("tendencies", {})),
                        **kw)
    cfg = port_cfg(jcfg)
    fields = stratified_fields(jm, Kk, seed=31)
    wind = wind_fields(jm)
    ref, out = jax_state(*fields), port_state(*fields)
    for _ in range(2):
        ref = jax_call(("step", name, mesh, Kk), lambda s, w: jfb(
            jm, jcfg, s, 0.0, 30.0, wind_stress=w), ref, jax_wind(wind))
        out = forward_backward_step(pm, cfg, out, 0.0, 30.0,
                                    wind_stress=port_wind(wind))
    for n in ("h", "u", "tracers"):
        _close(getattr(out, n), getattr(ref, n), n, rtol=1e-10, atol=1e-10)
    if cfg.tendencies.wind_forcing:      # the wind reached the top layer
        base = dataclasses.replace(cfg, tendencies=dataclasses.replace(
            cfg.tendencies, wind_forcing=False))
        calm = forward_backward_step(pm, base, port_state(*fields), 0.0, 30.0)
        once = forward_backward_step(pm, cfg, port_state(*fields), 0.0, 30.0,
                                     wind_stress=port_wind(wind))
        assert float((once.u[:, 0] - calm.u[:, 0]).abs().max()) > 0
