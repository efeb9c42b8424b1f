"""Zalesak FCT on the icosahedral sphere's framed path of the port
(ops/patch_megastep.fct_patch_megastep_framed) against the JAX package,
float64, icosahedral subdivision 8, 3 layers, 2 tracers:

- the FCT tables (icos_mega.ensure_fct) bit for bit against the JAX build;
- the stages' validity masks, keeps, fix sets and fix submesh bit for bit;
- the plain stage-A and stage-B chains against the port's composed FCT
  pieces at every position the FCT masks call exact (1e-13 of each field's
  max);
- `run_steps` on the patch mesh (the framed two-stage path), 3 steps at dt
  = 60 s, against the JAX package's composed `run_steps` (1e-11 of each
  field's max, as tests/test_patches.py:599 holds its FCT kernel), for
  center and upwind thickness fluxes and with wind and drag; volume to
  1e-13 and the tracers in [-1e-9, 1 + 1e-9] (tests/test_patches.py:606);
- one call of each stage's plain version per framed step;
- the configurations the fused path declines (the per-step API, FCT with
  vertical mixing, RK4) run composed and agree with the JAX package's
  composed steps (1e-12), or are refused by both;
- the FB chain refuses an FCT configuration and FCT's stages refuse an FB
  configuration or prep.

The JAX side runs composed through one jitted program per configuration."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_call, jax_state, port_cfg,
                                port_state)

import jax.numpy as jnp

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.mesh import icos_mega as jmega
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import patch_megastep as jpm
from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import rk4_step as jrk4
from omega_tpu.stepping import run_steps as jrun_steps

from omega_tpu_torch.core import fct as fctmod
from omega_tpu_torch.core import tendencies as tend
from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS
from omega_tpu_torch.ops import patch_megastep
from omega_tpu_torch.stepping import forward_backward_step, rk4_step
from omega_tpu_torch.stepping import run_steps

N = 8
K, L, DT, NSTEPS = 3, 2, 60.0, 3
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True,
                 bottom_drag_coeff=3.0e-3)
# configuration name -> flagship_cfg keywords (FCT tracer fluxes added)
CONFIGS = {"center": {},
           "upwind_thickness": dict(flux_thickness_type="upwind"),
           "wind_drag": dict(tendencies=WIND_DRAG)}


def fct_cfg(name):
    kw = dict(CONFIGS[name])
    return flagship_cfg(K, L, flux_tracer_type="fct",
                        tendencies=dict(kw.pop("tendencies", {})), **kw)


@pytest.fixture(scope="module")
def setup():
    """JAX and port patch meshes and seeded fields: h from 4000 m + 100 m
    sin(2 lat) cos(lon), u = 0.1 noise x edge_mask, tracer 0 a 0/1
    spherical cap, tracer 1 uniform in [0, 1]; the wind stress (0.1 cos
    lat, 0.05 sin lat)."""
    jp = jpatch(jsphere(N), N)
    pp = patch_icos_mesh(spherical_icos_mesh(N), N)
    rng = np.random.default_rng(11)
    lat, lon = np.asarray(jp.lat_cell), np.asarray(jp.lon_cell)
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.1 * rng.standard_normal((jp.nedges, K)) \
        * np.asarray(jp.edge_mask)[:, None]
    cap = (np.cos(lat) * np.cos(lon) > 0.7).astype(np.float64)
    tr = np.stack([cap[:, None] * np.ones((1, K)),
                   rng.uniform(0.0, 1.0, (jp.ncells, K))])
    wind = (0.1 * np.cos(lat), 0.05 * np.sin(lat))
    return jp, pp, (h, u, tr), wind


@pytest.fixture(scope="module")
def builds(setup):
    jp, pp, _, _ = setup
    return jmega.ensure_mega(jp), jmega.ensure_fct(jp), \
        icos_mega.ensure_fct(pp)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _wind(cfg, wind, torch_side):
    if not cfg.tendencies.wind_forcing:
        return None
    if torch_side:
        return tuple(torch.as_tensor(w) for w in wind)
    return tuple(jnp.asarray(w) for w in wind)


def test_fct_tables_bit_equal(builds):
    jg, _, pf = builds
    assert tuple(pf["tables"]) == icos_mega.FCT_TABLES
    for name, pt in pf["tables"].items():
        jt = jg.tables[name]
        assert (jt.dst_class, jt.src_class) == (pt.dst_class, pt.src_class)
        assert [e[:4] for e in jt.entries] == [e[:4] for e in pt.entries]
        for ej, ep in zip(jt.entries, pt.entries):
            _same(ej[4], ep[4], name)
        _same(jg.resolved[name], pf["resolved"][name], name)


def test_fct_masks_and_fix_closure_equal(setup, builds):
    _, pp, _, _ = setup
    _, jf, pf = builds
    for key in ("masks_a", "masks_b"):
        assert set(jf[key]) == set(pf[key]), key
        for name in jf[key]:
            _same(jf[key][name], pf[key][name], (key, name))
    for key in ("cell_keep", "edge_keep", "sub_cells", "sub_edges",
                "fix_cells_local", "fix_cells_global", "fix_edges_local",
                "fix_edges_global"):
        _same(jf[key], pf[key], key)
    for name in jf["outputs"]:
        for a, b in zip(jf["outputs"][name], pf["outputs"][name]):
            _same(a, b, name)
    for name in ARRAY_FIELDS:
        _same(getattr(jf["sub_mesh"], name), getattr(pf["sub_mesh"], name),
              name)
    # one build per argument set, kept on the mesh
    assert icos_mega.ensure_fct(pp) is pf


def _frames(p, flat, cls):
    """Flat rows as exact frames: (N, K) of a class -> (K, T, 10, S, S);
    tracers (L, C, K) -> (K, L, 10, S, S)."""
    if flat.dim() == 3:
        return torch.cat([_frames(p, f, cls) for f in flat], 1)
    T = 3 if cls == "edge" else 1
    out = flat.new_zeros((flat.shape[-1], T, p.P))
    patch_megastep._frames_of(p, cls, flat, T, out)
    return out.reshape(flat.shape[-1], T, 10, p.S, p.S)


def _at(got, ref, mask, what):
    m = torch.as_tensor(mask).expand(ref.shape[1:])
    err = (got - ref).abs()[:, m].max() / ref.abs().max()
    assert err <= 1e-13, (what, err.item())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_stages_against_composed_pieces(setup, builds, name):
    """Stage A's plain chain on the frames of the state, and stage B's on
    exact mid fields, against the port's composed FCT pieces on the patch
    mesh (core/fct.py, core/tendencies.py), at every position the stage's
    masks call exact."""
    _, pp, fields, wind = setup
    _, _, pf = builds
    cfg = port_cfg(fct_cfg(name))
    pm = pp.to("cpu", torch.float64)
    st = port_state(*fields)
    p = patch_megastep.prep(pm, torch.float64, "cpu", fct=True)
    h, u, tr = st
    w = _wind(cfg, wind, True)
    dh, thick = tend.compute_thickness_tendency(pm, cfg, h, u, 0.0)
    h_new = h + DT * dh
    trtd = fctmod.fct_provisional(pm, h, h_new, u, tr, DT, thick.flux_h_edge)
    facc = tr * h[None] + DT * patch_megastep._fct_diffusion_tendency(
        pm, cfg, h, u, tr, thick.mean_h_edge)
    du, _ = tend.compute_velocity_tendency(pm, cfg, h_new, u, DT, w)
    adv = fctmod.fct_limited_tendency(pm, h_new, u, tr, trtd, DT,
                                      thick.flux_h_edge)
    trn = (facc + DT * adv) / h_new[None]

    frames, _ = patch_megastep.stack_frames(pm, cfg, st)
    pw = patch_megastep.make_wind(pm, cfg, w, torch.float64) if w else None
    mid = patch_megastep.fct_a_plain(p, cfg, frames, DT, wind=pw)
    got = mid.reshape(K, 4 + 2 * L, 10, p.S, p.S)
    ma = pf["masks_a"]
    _at(got[:, 0:1], _frames(p, h_new, "cell"), ma["h_new"], "h_new")
    _at(got[:, 1:4], _frames(p, u + DT * du, "edge"), ma["u_new"], "u_new")
    _at(got[:, 4::2], _frames(p, trtd, "cell"), ma["trtd0"], "trtd")
    _at(got[:, 5::2], _frames(p, facc, "cell"), ma["facc0"], "facc")

    exact = torch.cat([_frames(p, h_new, "cell"),
                       torch.zeros_like(got[:, 1:4])]
                      + [_frames(p, x[l], "cell") for l in range(L)
                         for x in (trtd, facc)], 1)
    got_b = patch_megastep.fct_b_plain(
        p, cfg, exact.reshape(K, 4 + 2 * L, p.P), frames, DT)
    _at(got_b.reshape(K, L, 10, p.S, p.S), _frames(p, trn, "cell"),
        pf["masks_b"]["trn0"], "trn")


_RUNS = {}


def _framed(setup, name):
    """NSTEPS of the port's run_steps on the patch mesh (the framed FCT
    path), once per configuration."""
    if name not in _RUNS:
        _, pp, fields, wind = setup
        cfg = port_cfg(fct_cfg(name))
        pm = pp.to("cpu", torch.float64)
        assert patch_megastep.supported(pm, cfg, framed=True)
        _RUNS[name] = run_steps(pm, cfg, port_state(*fields), 0.0, DT,
                                NSTEPS, wind_stress=_wind(cfg, wind, True))
    return _RUNS[name]


def _close(out, ref, tol):
    for f in ("h", "u", "tracers"):
        r = np.asarray(getattr(ref, f))
        err = np.abs(getattr(out, f).numpy() - r).max() / np.abs(r).max()
        assert err < tol, (f, err)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_framed_run_steps_against_jax_composed(setup, name):
    jp, _, fields, wind = setup
    jcfg = fct_cfg(name)
    jw = _wind(jcfg, wind, False)

    def jax_steps(h, u, tr):
        return jrun_steps(jp, jcfg, JModelState(h, u, tr), 0.0, DT, NSTEPS,
                          wind_stress=jw)
    ref = jax_call(("sphere-fct-run", name), jax_steps, *jax_state(*fields))
    _close(_framed(setup, name), ref, 1e-11)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_framed_conservation_and_range(setup, name):
    _, pp, fields, _ = setup
    out = _framed(setup, name)
    a = torch.as_tensor(np.asarray(pp.area_cell))[:, None]
    h0 = torch.as_tensor(fields[0])
    vol0, vol1 = (a * h0).sum(), (a * out.h).sum()
    assert abs(vol1 - vol0) / vol0 < 1e-13
    assert out.tracers.min() >= -1e-9 and out.tracers.max() <= 1.0 + 1e-9
    assert bool(torch.isfinite(out.u).all()) and out.u.abs().max() > 0


def test_framed_path_calls_each_stage_once_per_step(setup, monkeypatch):
    """On the CPU the stage wrappers run their plain versions: one call of
    each per framed step, the composed stepper not at all."""
    _, pp, fields, _ = setup
    cfg = port_cfg(fct_cfg("center"))
    pm = pp.to("cpu", torch.float64)
    calls = {"a": 0, "b": 0}
    for key, name in (("a", "fct_a_plain"), ("b", "fct_b_plain")):
        plain = getattr(patch_megastep, name)

        def counted(*a, _plain=plain, _key=key, **kw):
            calls[_key] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(patch_megastep, name, counted)
    out = run_steps(pm, cfg, port_state(*fields), 0.0, DT, 2)
    assert calls == {"a": 2, "b": 2}
    assert bool(torch.isfinite(out.tracers).all())


DECLINED = {
    "per_step_api": (dict(), "fb"),
    "vmix": (dict(vert_mix=JVertMixConfig(enabled=True, kappa_tracer=1e-3,
                                          kappa_momentum=1e-2)), "run"),
}


@pytest.mark.parametrize("name", list(DECLINED))
def test_declined_configurations_run_composed(setup, name):
    """The per-step FB API and FCT with vertical mixing are not fused
    (JAX's supported agrees); both run composed through the patch
    operators and agree with the JAX package's composed steps."""
    jp, pp, fields, _ = setup
    kw, how = DECLINED[name]
    jcfg = flagship_cfg(K, L, flux_tracer_type="fct", **kw)
    cfg = port_cfg(jcfg)
    pm = pp.to("cpu", torch.float64)
    framed = how == "run"
    assert not patch_megastep.supported(pm, cfg, framed=framed)
    assert not jpm.supported(jp, jcfg, framed=framed)
    assert patch_megastep.supported(pm, port_cfg(fct_cfg("center")),
                                    framed=True)

    def jax_steps(h, u, tr):
        s = JModelState(h, u, tr)
        if framed:
            return jrun_steps(jp, jcfg, s, 0.0, DT, 2)
        for i in range(2):
            s = jfb(jp, jcfg, s, i * DT, DT)
        return s
    ref = jax_call(("sphere-fct-declined", name), jax_steps,
                   *jax_state(*fields))
    s = port_state(*fields)
    if framed:
        s = run_steps(pm, cfg, s, 0.0, DT, 2)
    else:
        for i in range(2):
            s = forward_backward_step(pm, cfg, s, i * DT, DT)
    _close(s, ref, 1e-12)


def test_rk4_with_fct_refused_as_the_reference_refuses(setup):
    """FCT needs the thickness-first order of the FB stepper: neither the
    JAX package nor the port runs it under RK4 (no fused path takes it)."""
    jp, pp, fields, _ = setup
    jcfg = fct_cfg("center")
    cfg = port_cfg(jcfg)
    assert not jpm.supported(jp, jcfg, kind="rk4", framed=True)
    with pytest.raises(ValueError, match="thickness-first"):
        jax_call(("sphere-fct-rk4",), lambda h, u, tr: jrk4(
            jp, jcfg, JModelState(h, u, tr), 0.0, DT), *jax_state(*fields))
    with pytest.raises(ValueError, match="thickness-first"):
        run_steps(pp.to("cpu", torch.float64), cfg, port_state(*fields),
                  0.0, DT, 1, stepper=rk4_step)


@pytest.mark.parametrize("kind", ["chain_fct_cfg", "fct_a_fb_cfg",
                                  "fct_a_fb_prep", "fct_b_fb_cfg"])
def test_stage_entry_points_refuse_the_other_configuration(setup, kind):
    """The FB chain refuses an FCT configuration (its output has no room for
    stage A's 4 + 2L channels), and FCT's stages refuse an FB configuration
    or an FB prep (whose table lacks the FCT rows)."""
    _, pp, fields, _ = setup
    pm = pp.to("cpu", torch.float64)
    fcfg = port_cfg(fct_cfg("center"))
    bcfg = port_cfg(flagship_cfg(K, L))
    fp = patch_megastep.prep(pm, torch.float64, "cpu", fct=True)
    bp = patch_megastep.prep(pm, torch.float64, "cpu")
    frames, _ = patch_megastep.stack_frames(pm, fcfg, port_state(*fields))
    mid = patch_megastep.new_mid(frames)
    calls = {"chain_fct_cfg": lambda: patch_megastep.chain(
                 bp, fcfg, frames, DT),
             "fct_a_fb_cfg": lambda: patch_megastep.fct_a(
                 fp, bcfg, frames, DT),
             "fct_a_fb_prep": lambda: patch_megastep.fct_a(
                 bp, fcfg, frames, DT),
             "fct_b_fb_cfg": lambda: patch_megastep.fct_b(
                 fp, bcfg, mid, frames, DT, frames.clone())}
    with pytest.raises(ValueError):
        calls[kind]()
