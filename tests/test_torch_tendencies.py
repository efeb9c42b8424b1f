"""The aux groups and the three tendency groups of the port against the
JAX package, each TendencyConfig flag switched off in turn, center and
upwind fluxes; rtol 1e-12 (same expressions in float64, the shift path
sums in the same order). The option not ported yet must raise; those
ported since (wind, drag, FCT, vertical mixing) must not."""

import numpy as np
import pytest

from torch_port_helpers import (flagship_cfg, jax_mesh, jax_state, port_cfg,
                                port_mesh, port_state, random_fields)

from omega_tpu.core import aux as jaux
from omega_tpu.core import tendencies as jtend

from omega_tpu_torch.core import ModelConfig, TendencyConfig, VertMixConfig
from omega_tpu_torch.core import aux, tendencies
from omega_tpu_torch.stepping import forward_backward_step, run_steps

K, L = 4, 2
FLAGS = ("thickness_flux_div", "pv_advection", "ke_gradient", "ssh_gradient",
         "velocity_diffusion", "velocity_hyperdiff", "tracer_horz_adv",
         "tracer_diffusion", "tracer_hyperdiff")


@pytest.fixture(scope="module")
def setup():
    jm = jax_mesh(24, 12)
    pm = port_mesh(jm)
    f = random_fields(jm, K, L, seed=3)
    return jm, pm, jax_state(*f), port_state(*f)


def _close(out, ref, what, atol=0.0):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=atol, err_msg=what)


def _leaves(nt):
    for v in nt:
        if isinstance(v, tuple):
            yield from _leaves(v)
        elif v is not None:
            yield v


@pytest.mark.parametrize("flux", ["center", "upwind"])
def test_aux_groups_match_jax(setup, flux):
    jm, pm, js, ps = setup
    jcfg = flagship_cfg(K, L, flux_thickness_type=flux, flux_tracer_type=flux)
    cfg = port_cfg(jcfg)
    jmom = jaux.compute_momentum_aux(jm, jcfg, js.h, js.u)
    pmom = aux.compute_momentum_aux(pm, cfg, ps.h, ps.u)
    # atol: differences of O(1e-3) curls cancel to O(1e-9) values
    for a, b in zip(_leaves(pmom), _leaves(jmom)):
        _close(a, b, "momentum aux", atol=1e-22)
    jtr = jaux.tracer_aux(jm, jcfg, js.h, js.u, js.tracers,
                          jmom.thickness.mean_h_edge)
    ptr = aux.tracer_aux(pm, cfg, ps.h, ps.u, ps.tracers,
                         pmom.thickness.mean_h_edge)
    for a, b in zip(ptr, jtr):
        _close(a, b, "tracer aux", atol=1e-22)


@pytest.mark.parametrize("flux", ["center", "upwind"])
@pytest.mark.parametrize("off", ("none",) + FLAGS)
def test_tendency_groups_match_jax(setup, off, flux):
    jm, pm, js, ps = setup
    tend = {} if off == "none" else {off: False}
    jcfg = flagship_cfg(K, L, flux_thickness_type=flux, flux_tracer_type=flux,
                        tendencies=dict(eddy_diff4=1e6, **tend))
    cfg = port_cfg(jcfg)
    jdh, jth = jtend.compute_thickness_tendency(jm, jcfg, js.h, js.u, 0.0)
    pdh, pth = tendencies.compute_thickness_tendency(pm, cfg, ps.h, ps.u, 0.0)
    _close(pdh, jdh, "dh")
    jdu, _ = jtend.compute_velocity_tendency(jm, jcfg, js.h, js.u, 0.0)
    pdu, _ = tendencies.compute_velocity_tendency(pm, cfg, ps.h, ps.u, 0.0)
    _close(pdu, jdu, "du", atol=1e-18)
    jdtr, _ = jtend.compute_tracer_tendency(jm, jcfg, js.h, js.u, js.tracers,
                                            jth.mean_h_edge, 0.0)
    pdtr, _ = tendencies.compute_tracer_tendency(pm, cfg, ps.h, ps.u,
                                                 ps.tracers, pth.mean_h_edge,
                                                 0.0)
    _close(pdtr, jdtr, "dtr", atol=1e-18)


def test_compute_all_tendencies_matches_jax(setup):
    jm, pm, js, ps = setup
    jcfg = flagship_cfg(K, L)
    jt = jtend.compute_all_tendencies(jm, jcfg, js.h, js.u, js.tracers, 0.0)
    pt = tendencies.compute_all_tendencies(pm, port_cfg(jcfg), ps.h, ps.u,
                                           ps.tracers, 0.0)
    _close(pt.dh, jt.dh, "dh")
    _close(pt.du, jt.du, "du", atol=1e-18)
    _close(pt.dtr, jt.dtr, "dtr", atol=1e-18)


# option -> (config, whether it still raises NotImplementedError): every
# option is ported now (custom tendencies since the RK slice)
UNPORTED = {
    "custom": (dict(tendencies=TendencyConfig(use_custom_tendency=True,
                                              manufactured_tendency=True)),
               False),
    "wind": (dict(tendencies=TendencyConfig(wind_forcing=True)), False),
    "drag": (dict(tendencies=TendencyConfig(bottom_drag=True,
                                            bottom_drag_coeff=1e-3)), False),
    "fct": (dict(flux_tracer_type="fct"), False),
    "vmix": (dict(vert_mix=VertMixConfig(enabled=True)), False),
}


@pytest.mark.parametrize("what", UNPORTED)
def test_unported_options_raise(setup, what):
    """...and the ported ones run: every entry point returns finite fields
    (none raises NotImplementedError any more)."""
    _, pm, _, ps = setup
    kw, raises = UNPORTED[what]
    cfg = ModelConfig(nvertlayers=K, ntracers=L, **kw)
    calls = (
        lambda: tendencies.compute_velocity_tendency(pm, cfg, ps.h, ps.u,
                                                     0.0)[0],
        lambda: forward_backward_step(pm, cfg, ps, 0.0, 30.0).u,
        lambda: run_steps(pm, cfg, ps, 0.0, 30.0, 1).tracers)
    for call in calls:
        if raises:
            with pytest.raises(NotImplementedError):
                call()
        else:
            assert bool(np.isfinite(call().numpy()).all())


def test_bad_flux_type_is_a_value_error(setup):
    _, pm, _, ps = setup
    cfg = ModelConfig(nvertlayers=K, ntracers=L, flux_thickness_type="weno")
    with pytest.raises(ValueError):
        aux.thickness_aux_edge(pm, cfg, ps.h, ps.u)
