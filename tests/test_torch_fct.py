"""Flux-corrected (Zalesak) tracer transport of the port against the JAX
package in float64: the composed edge fluxes, provisional field and limited
tendency (core/fct.py) at rtol 1e-12; the monotone bounds; the
forward-backward step with flux_tracer_type="fct" over two steps at 1e-10
(the JAX suite's figure, tests/test_structured.py:577), composed and through
the fused kernel's plain version (whole grid and tiled), and the latter
against the JAX fused kernel in interpret mode."""

import functools

import numpy as np
import pytest

from torch_port_helpers import (MESHES, flagship_cfg, jax_call, jax_mesh,
                                jax_state, port_cfg, port_mesh, port_state)

import jax.numpy as jnp

from omega_tpu.core import aux as jaux
from omega_tpu.core import fct as jfct
from omega_tpu.core import tendencies as jtend
from omega_tpu.ops import megastep as jmegastep
from omega_tpu.stepping import forward_backward_step as jfb

from omega_tpu_torch.core import ModelState, aux, fct, tendencies
from omega_tpu_torch.ops import megastep
from omega_tpu_torch.stepping import forward_backward_step, run_steps

K, L, DT = 3, 2, 30.0


def _close(out, ref, what, rtol=1e-12, atol=1e-16):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _fields(jm, seed=11, u_amp=0.5):
    """A 0/1 step tracer and a noisy one, strong random flow."""
    rng = np.random.default_rng(seed)
    kx = 2 * np.pi / jm.x_period
    ssh = np.sin(kx * np.asarray(jm.x_cell))
    h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
    step = (np.asarray(jm.x_cell) > jm.x_period / 2).astype(float)
    tr = np.stack([np.broadcast_to(step[:, None], (jm.ncells, K)),
                   10.0 + rng.standard_normal((jm.ncells, K))])
    u = u_amp * rng.standard_normal((jm.nedges, K))
    u[::7] = 0.0                       # edges at rest take the mean branch
    return h, u, tr


def _cfg(flux_h="center"):
    return flagship_cfg(K, L, flux_tracer_type="fct",
                        flux_thickness_type=flux_h,
                        tendencies=dict(eddy_diff2=0.0, eddy_diff4=0.0))


@functools.lru_cache(maxsize=None)
def _setup(mesh, flux_h="center"):
    jm = jax_mesh(*MESHES[mesh])
    pm = port_mesh(jm)
    jcfg = _cfg(flux_h)
    f = _fields(jm)
    js, ps = jax_state(*f), port_state(*f)
    jdh, jth = jax_call(
        ("dh", mesh, flux_h),
        lambda h, u: jtend.compute_thickness_tendency(jm, jcfg, h, u, 0.0),
        js.h, js.u)
    pdh, pth = tendencies.compute_thickness_tendency(pm, port_cfg(jcfg), ps.h,
                                                     ps.u, 0.0)
    return (jm, pm, jcfg, port_cfg(jcfg), js, ps, js.h + DT * jdh,
            ps.h + DT * pdh, jth.flux_h_edge, pth.flux_h_edge)


@pytest.mark.parametrize("mesh", MESHES)
def test_edge_fluxes_and_provisional_field_match_jax(mesh):
    jm, pm, _, _, js, ps, jhn, phn, jflux, pflux = _setup(mesh)
    jlo, jhi = jax_call(("edge fluxes", mesh), lambda F, u, tr:
                        jfct._edge_fluxes(jm, F, u, tr), jflux * js.u, js.u,
                        js.tracers)
    plo, phi = fct._edge_fluxes(pm, pflux * ps.u, ps.u, ps.tracers)
    _close(plo, jlo, "f_lo")
    _close(phi, jhi, "f_hi")
    _close(fct.fct_provisional(pm, ps.h, phn, ps.u, ps.tracers, DT, pflux),
           jax_call(("provisional", mesh), lambda *a: jfct.fct_provisional(
               jm, *a[:4], DT, a[4]), js.h, jhn, js.u, js.tracers, jflux),
           "tr_td")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("flux_h", ["center", "upwind"])
def test_fct_tracer_tendency_matches_jax_and_is_monotone(mesh, flux_h):
    jm, pm, _, _, js, ps, jhn, phn, jflux, pflux = _setup(mesh, flux_h)
    ref = jax_call(("fct tendency", mesh), lambda *a: jfct.fct_tracer_tendency(
        jm, *a[:4], DT, a[4]), js.h, jhn, js.u, js.tracers, jflux)
    out = fct.fct_tracer_tendency(pm, ps.h, phn, ps.u, ps.tracers, DT, pflux)
    assert tuple(out.shape) == (L, jm.ncells, K)
    _close(out, ref, "fct tendency", atol=1e-14)
    # the limited path through a precomputed provisional field is the same
    td = fct.fct_provisional(pm, ps.h, phn, ps.u, ps.tracers, DT, pflux)
    again = fct.fct_limited_tendency(pm, phn, ps.u, ps.tracers, td, DT, pflux)
    _close(again, ref, "limited tendency", atol=1e-14)
    # monotone: the update stays within the old neighbourhood's extrema
    new = ((ps.tracers * ps.h[None] + DT * out) / phn[None]).numpy()
    from omega_tpu_torch.ops import trisk
    hi, lo = trisk.cell_neighbor_extrema(pm, ps.tracers)
    assert (new <= hi.numpy() + 1e-12).all() and \
        (new >= lo.numpy() - 1e-12).all()
    assert new[0].min() >= -1e-12 and new[0].max() <= 1.0 + 1e-12


def test_fct_tendency_wrapper_and_its_errors():
    jm, pm, jcfg, cfg, js, ps, jhn, phn, jflux, pflux = _setup("24x12")
    jmean = jaux.thickness_aux_edge(jm, jcfg, js.h, js.u).mean_h_edge
    pmean = aux.thickness_aux_edge(pm, cfg, ps.h, ps.u).mean_h_edge
    jd, _ = jtend.compute_tracer_tendency(jm, jcfg, js.h, js.u, js.tracers,
                                          jmean, 0.0, h_new=jhn, dt=DT)
    # flux_h_edge left out: the wrapper recomputes it
    pd, paux = tendencies.compute_tracer_tendency(pm, cfg, ps.h, ps.u,
                                                  ps.tracers, pmean, 0.0,
                                                  h_new=phn, dt=DT)
    _close(pd, jd, "dtr", atol=1e-14)
    jaux_tr = jaux.tracer_aux(jm, jcfg, js.h, js.u, js.tracers, jmean)
    _close(paux.h_tracers_edge, jaux_tr.h_tracers_edge, "h_tracers_edge")
    with pytest.raises(ValueError):      # needs the thickness-first order
        tendencies.compute_tracer_tendency(pm, cfg, ps.h, ps.u, ps.tracers,
                                           pmean, 0.0)


def _jax_fct_steps(mesh, n=2):
    jm, _, jcfg, _, js = _setup(mesh)[:5]
    ref = js
    for _ in range(n):
        ref = jax_call(("fct step", mesh),
                       lambda st: jfb(jm, jcfg, st, 0.0, DT), ref)
    return ref


@pytest.mark.parametrize("mesh", MESHES)
def test_fct_step_matches_jax_over_2_steps_and_stays_in_bounds(mesh):
    """The composed step (a CPU state; on the card the fused kernel takes
    this configuration)."""
    jm, pm, jcfg, cfg, js, ps = _setup(mesh)[:6]
    assert megastep.supported(pm, cfg)
    ref, out = _jax_fct_steps(mesh), ps
    for _ in range(2):
        out = forward_backward_step(pm, cfg, out, 0.0, DT)
    for n in ("h", "u", "tracers"):
        _close(getattr(out, n), getattr(ref, n), n, rtol=1e-10, atol=1e-10)
    t0 = out.tracers[0].numpy()
    assert t0.min() >= -1e-12 and t0.max() <= 1.0 + 1e-12
    again = run_steps(pm, cfg, ps, 0.0, DT, 2)
    for a, b in zip(again, out):
        assert np.array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("tile", [None, (8, 8), (7, 5)],
                         ids=["whole", "tile8x8", "ragged7x5"])
@pytest.mark.parametrize("mesh", ["32x16", "24x12"])
def test_fused_fct_plain_matches_jax_and_is_monotone(mesh, tile):
    """The fused kernel's plain version (the FB chain with the limiter in
    place of the advective term) against the JAX package's composed FCT
    step over two steps, 1e-10; the 0/1 tracer stays in [0, 1]."""
    _, pm, _, cfg, _, ps = _setup(mesh)[:6]
    s = megastep.stack_state(pm, ps)
    for _ in range(2):
        s = megastep.fb_megastep_plain(pm, cfg, s, DT, tile=tile)
    out = megastep.unstack_state(pm, s, K, L, ModelState)
    ref = _jax_fct_steps(mesh)
    for n in ("h", "u", "tracers"):
        _close(getattr(out, n), getattr(ref, n), n, rtol=1e-10, atol=1e-10)
    t0 = out.tracers[0].numpy()
    assert t0.min() >= -1e-12 and t0.max() <= 1.0 + 1e-12
    assert t0.min() < 0.5 < t0.max()


def test_fused_fct_plain_matches_jax_pallas_kernel():
    """Against the JAX fused FB kernel with its FCT tail (`_fct_adv`) in
    interpret mode, one step, 1e-10."""
    jm, pm, jcfg, cfg, js, ps = _setup("32x16")[:6]
    assert jmegastep.supported(jm, jcfg)
    jout = jmegastep.fb_megastep(jm, jcfg, js, 0.0, DT, interpret=True)
    out = megastep.fb_megastep(pm, cfg, ps, 0.0, DT)
    for n in ("h", "u", "tracers"):
        _close(getattr(out, n), getattr(jout, n), n, rtol=1e-10, atol=1e-10)
