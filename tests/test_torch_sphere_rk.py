"""RK2 and RK4 on the icosahedral sphere's framed path of the port
(ops/patch_megastep.rk2_patch_megastep_framed / rk4_patch_megastep_framed:
the RK stage kernel's plain version per stage, the pole submesh's
tendencies, the in-frame refresh) against the JAX package, float64,
icosahedral subdivision 8, 3 layers, 2 tracers (T, S):

- the stage chains (icos_mega.rk2_stage_chain / rk4_stage_chain) op for op
  and the value classes name for name, for every option;
- the FB validity masks the prep's refresh uses lie inside each stage
  chain's own exactness masks (the original state and the accumulator as
  further inputs);
- each plain stage, at every position the masks call exact, against the
  port's composed tendencies and stage update on the flat mesh (1e-13 of
  each field's max);
- `run_steps` with rk2_step and rk4_step on the patch mesh against the JAX
  package's composed `run_steps`, 2 RK2 and 1 RK4 steps at dt = 60 s:
  flagship, upwind
  fluxes, wind + drag + constant mixing to 1e-12 of each field's max, PP81
  to 1e-11 (tests/test_patches.py:193, tests/test_torch_sphere_science.py);
  one framed RK2 step with upwind fluxes against the JAX package's
  rk2_patch_megastep_framed with its kernel in interpret mode (1e-12);
  volume to 1e-13, u = 0 on dead edges; RK4 bit for bit the same without
  the accumulator's refresh;
- the stages a step runs: modes PROV, PROV per RK2 step and FIRST, MID,
  MID, LAST per RK4 step, one submesh tendency per stage, one coefficient
  and one solve call per step with PP81 mixing;
- Thomas mixing and column ssh under RK run composed and agree with the
  JAX package (1e-12); the stage wrapper refuses FCT.

The JAX side runs composed through one jitted program per configuration,
except the one interpreted framed step."""

import numpy as np
import pytest
import torch

from torch_port_helpers import flagship_cfg, jax_call, jax_state, port_cfg

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.mesh import icos_mega as jmega
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import patch_megastep as jpm
from omega_tpu.stepping import rk2_step as jrk2
from omega_tpu.stepping import rk4_step as jrk4
from omega_tpu.stepping import run_steps as jrun_steps

from omega_tpu_torch.core import ModelState
from omega_tpu_torch.core import tendencies as tend
from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.ops import patch_megastep as pm
from omega_tpu_torch.stepping import rk2_step, rk4_step, run_steps

N = 8
K, L, DT = 3, 2, 60.0
# framed steps per run: RK2 two (the carry's buffers swap), RK4 one (its
# four stages already pass three refreshes and two buffer swaps)
NSTEPS = {"rk2": 2, "rk4": 1}
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)
CONST = JVertMixConfig(enabled=True, kappa_tracer=1e-3, kappa_momentum=1e-2)
PP81 = JVertMixConfig(enabled=True, scheme="pp81", nu0=1e-2, alpha=5.0,
                      n_exp=2, temp_index=0, salt_index=1)
UPWIND = dict(flux_thickness_type="upwind", flux_tracer_type="upwind")
# name -> (flagship_cfg keywords, tolerance against the JAX package)
CONFIGS = {
    "flagship": ({}, 1e-12),
    "upwind": (UPWIND, 1e-12),
    "wind_drag_const": (dict(vert_mix=CONST, tendencies=WIND_DRAG), 1e-12),
    "pp81": (dict(vert_mix=PP81, tendencies=WIND_DRAG, **UPWIND), 1e-11),
}
STEPPERS = {"rk2": (rk2_step, jrk2), "rk4": (rk4_step, jrk4)}
# stage kind -> (mode, ca / dt, cb / dt, the level is the base)
STAGES = {"rk2a": (pm.RK_PROV, 0.5, 0.0, True),
          "rk2b": (pm.RK_PROV, 1.0, 0.0, False),
          "rk4s1": (pm.RK_FIRST, 0.5, 1.0 / 6.0, True),
          "rk4s2": (pm.RK_MID, 0.5, 1.0 / 3.0, False),
          "rk4s3": (pm.RK_MID, 1.0, 1.0 / 3.0, False),
          "rk4s4": (pm.RK_LAST, 0.0, 1.0 / 6.0, False)}


def _jcfg(name, **extra):
    kw = dict(CONFIGS[name][0])
    kw.update(extra)
    return flagship_cfg(K, L, tendencies=dict(kw.pop("tendencies", {})),
                        **kw)


@pytest.fixture(scope="module")
def setup():
    """JAX and port patch meshes and seeded fields: h from 4000 m + 100 m
    sin(2 lat) cos(lon), u = 0.1 noise x edge_mask, a stratified T and S
    near 35 (tests/test_torch_sphere_science.py's state), the wind stress
    (0.1 cos lat, 0.05 sin lat)."""
    jp = jpatch(jsphere(N), N)
    pp = patch_icos_mesh(spherical_icos_mesh(N), N).to("cpu", torch.float64)
    rng = np.random.default_rng(23)
    lat, lon = np.asarray(jp.lat_cell), np.asarray(jp.lon_cell)
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.1 * rng.standard_normal((jp.nedges, K)) \
        * np.asarray(jp.edge_mask)[:, None]
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((jp.ncells, K))
    S = 35.0 + 0.1 * rng.standard_normal((jp.ncells, K))
    wind = (0.1 * np.cos(lat), 0.05 * np.sin(lat))
    return jp, pp, (h, u, np.stack([T, S])), wind


def _state(fields):
    return ModelState(*(torch.as_tensor(a) for a in fields))


def _wind(cfg, wind):
    if not cfg.tendencies.wind_forcing:
        return None
    return tuple(torch.as_tensor(w) for w in wind)


def _close(out, ref, tol):
    for f in ("h", "u", "tracers"):
        r = np.asarray(getattr(ref, f))
        err = np.abs(np.asarray(getattr(out, f)) - r).max() / np.abs(r).max()
        assert err < tol, (f, err)


# ------------------------------------------------------------ the chains

_OPTIONS = [dict(wind=w, drag=d, vmix=v, uw_h=uh, uw_tr=ut, pp=pp)
            for w in (False, True) for d in (False, True)
            for (v, pp) in ((False, None), (True, None), (True, (0, 1)))
            for uh in (False, True) for ut in (False, True)]


def _chain(mod, kind, nl=L, **kw):
    if kind == "rk2a":
        return mod.rk2_stage_chain(nl, "", 0.5, **kw)
    if kind == "rk2b":
        return mod.rk2_stage_chain(nl, "0", 1.0, **kw)
    return mod.rk4_stage_chain(nl, int(kind[4:]), **kw)


@pytest.mark.parametrize("kind", list(STAGES))
def test_stage_chains_equal_the_reference(kind):
    """The port's stage chain equals the JAX package's op for op under
    every option; rk_ops splits it without losing an op; every value's
    class agrees."""
    for opts in _OPTIONS:
        ops = _chain(icos_mega, kind, **opts)
        assert ops == _chain(jmega, kind, **opts), (kind, opts)
        for op in ops:
            for nm in (op[0],) + tuple(a for a in op[3:]
                                       if isinstance(a, str)
                                       and not a.startswith("$")
                                       and op[1] == "ew"):
                assert icos_mega.chain_class(nm) == jmega.chain_class(nm)
    cfg = port_cfg(_jcfg("pp81"))
    h_ops, coeffs, solve = pm.rk_ops(cfg, L, kind, True)
    full = _chain(icos_mega, kind, wind=True, drag=True, vmix=True,
                  uw_h=True, uw_tr=True, pp=(0, 1))
    tail = full[len(h_ops):]
    assert h_ops == full[:len(h_ops)] and h_ops[-1][0] in ("u_new", "u_acc")
    assert len(coeffs) + len(solve) == len(tail)
    for part in (coeffs, solve):
        assert [op for op in tail if op in part] == part
    assert bool(coeffs) == bool(solve) == (kind in ("rk2b", "rk4s4"))


@pytest.fixture(scope="module")
def mega(setup):
    return icos_mega.ensure_mega(setup[1])


_EXTRA = ("h0", "u0", "tr00", "h_a", "u_a", "tra0")


@pytest.mark.parametrize("kind", list(STAGES))
def test_fb_masks_inside_the_stage_chains(mega, kind):
    """Every position the prep's refresh keeps (the FB chain's worst-case
    tiled masks) is exact for the stage chain, evaluated on whole frames,
    for the stage's outputs and, RK4's stages 1-3, the accumulator's."""
    mg = mega
    extra = [(nm, icos_mega.chain_class(nm)) for nm in _EXTRA]
    for uw in (False, True):
        ops = _chain(icos_mega, kind, 1, wind=True, drag=True, vmix=True,
                     uw_h=uw, uw_tr=uw, pp=(0, 0))
        m = icos_mega.chain_validity(mg.tables, mg.content, mg.resolved, 1,
                                     ops, extra_inputs=extra)
        outs = [("h_new", "h_new"), ("u_new", "u_new"), ("trn0", "trn0")]
        if kind in ("rk4s1", "rk4s2", "rk4s3"):
            outs += [("h_new", "h_acc"), ("u_new", "u_acc"),
                     ("trn0", "tracc0")]
        for fb_key, rk_key in outs:
            assert not (mg.masks[fb_key] & ~m[rk_key]).any(), (kind, rk_key)


def _frames(p, flat, cls):
    """Flat rows as exact frames: (N, K) of a class -> (K, T, 10, S, S);
    tracers (L, C, K) -> (K, L, 10, S, S)."""
    if flat.dim() == 3:
        return torch.cat([_frames(p, f, cls) for f in flat], 1)
    T = 3 if cls == "edge" else 1
    out = flat.new_zeros((flat.shape[-1], T, p.P))
    pm._frames_of(p, cls, flat, T, out)
    return out.reshape(flat.shape[-1], T, 10, p.S, p.S)


def _at(got, ref, mask, what):
    m = torch.as_tensor(mask).expand(ref.shape[1:])
    err = (got - ref).abs()[:, m].max() / ref.abs().max()
    assert err <= 1e-13, (what, err.item())


@pytest.mark.parametrize("kind", list(STAGES))
def test_plain_stage_against_composed(setup, mega, kind):
    """One stage's plain version on the frames of a level, the step's
    initial state and an accumulator, against compute_all_tendencies on
    the flat patch mesh and the stage's update (rk4_step's expressions),
    at every position the prep's masks call exact. Upwind fluxes, wind and
    drag; the level differs from the base except where it is the base."""
    _, pp, fields, wind = setup
    mode, a, b, same = STAGES[kind]
    cfg = port_cfg(_jcfg("pp81"))
    p = pm.prep(pp, torch.float64, "cpu")
    w = _wind(cfg, wind)
    base = _state(fields)
    rng = np.random.default_rng(7)
    ev = base if same else ModelState(
        h=base.h * (1 + 1e-3 * torch.as_tensor(rng.standard_normal(
            base.h.shape))),
        u=base.u + 0.01 * torch.as_tensor(rng.standard_normal(
            base.u.shape)) * pp.edge_mask[:, None],
        tracers=base.tracers + 0.1)
    acc = ModelState(h=0.9 * base.h, u=0.5 * base.u,
                     tracers=base.tracers * base.h[None] * 1.1)
    ca, cb = a * DT, b * DT
    k = tend.compute_all_tendencies(pp, cfg, *ev, 0.0, w)
    if mode == pm.RK_LAST:
        h = acc.h + cb * k.dh
        ref = (h, acc.u + cb * k.du, (acc.tracers + cb * k.dtr) / h[None])
    else:
        h = base.h + ca * k.dh
        trh = base.tracers * base.h[None]
        ref = (h, base.u + ca * k.du, (trh + ca * k.dtr) / h[None])
    ref_acc = None
    if mode == pm.RK_FIRST:
        ref_acc = (base.h + cb * k.dh, base.u + cb * k.du,
                   trh + cb * k.dtr)
    elif mode == pm.RK_MID:
        ref_acc = (acc.h + cb * k.dh, acc.u + cb * k.du,
                   acc.tracers + cb * k.dtr)

    def fr(st):
        return pm.stack_frames(pp, cfg, st)[0]
    got_acc, got = pm.rk_stage_plain(
        p, cfg, mode, ca, cb, fr(ev), fr(base), fr(acc),
        pm.make_wind(pp, cfg, w, torch.float64))
    ma = mega.masks
    for res, want, what in ((got, ref, "out"), (got_acc, ref_acc, "acc")):
        if want is None:
            assert res is None
            continue
        r = res.reshape(K, 4 + L, 10, p.S, p.S)
        _at(r[:, 0:1], _frames(p, want[0], "cell"), ma["h_new"], what + " h")
        _at(r[:, 1:4], _frames(p, want[1], "edge"), ma["u_new"], what + " u")
        _at(r[:, 4:], _frames(p, want[2], "cell"), ma["trn0"], what + " tr")


# ----------------------------------------------------------- whole steps

_RUNS = {}


def _framed(setup, name, stepper):
    """NSTEPS[stepper] of the port's run_steps on the patch mesh (the
    framed RK path), once per configuration and stepper."""
    key = (name, stepper)
    if key not in _RUNS:
        _, pp, fields, wind = setup
        cfg = port_cfg(_jcfg(name))
        assert pm.supported(pp, cfg, framed=True, kind=stepper)
        _RUNS[key] = run_steps(pp, cfg, _state(fields), 0.0, DT,
                               NSTEPS[stepper], stepper=STEPPERS[stepper][0],
                               wind_stress=_wind(cfg, wind))
    return _RUNS[key]


@pytest.mark.parametrize("stepper", list(STEPPERS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_framed_run_steps_against_jax_composed(setup, name, stepper):
    jp, _, fields, wind = setup
    jcfg = _jcfg(name)
    jstep = STEPPERS[stepper][1]

    def jax_steps(h, u, tr, zonal, merid):
        return jrun_steps(jp, jcfg, JModelState(h, u, tr), 0.0, DT,
                          NSTEPS[stepper], stepper=jstep, wind_stress=(
                              (zonal, merid) if jcfg.tendencies.wind_forcing
                              else None))
    ref = jax_call(("sphere-rk", name, stepper), jax_steps,
                   *jax_state(*fields), *wind)
    _close(_framed(setup, name, stepper), ref, CONFIGS[name][1])


@pytest.mark.parametrize("stepper", list(STEPPERS))
def test_framed_conservation_and_dead_edges(setup, stepper):
    """Volume to 1e-13 and each tracer's content to 1e-12 (PP81 mixing,
    upwind fluxes, wind and drag), u exactly 0 on dead edges, a moving
    flow."""
    _, pp, fields, _ = setup
    out = _framed(setup, "pp81", stepper)
    a = pp.area_cell[:, None]
    h0, tr0 = torch.as_tensor(fields[0]), torch.as_tensor(fields[2])
    vol0, vol1 = (a * h0).sum(), (a * out.h).sum()
    assert abs(vol1 - vol0) / vol0 < 1e-13
    for l in range(L):
        c0, c1 = (a * h0 * tr0[l]).sum(), (a * out.h * out.tracers[l]).sum()
        assert abs(c1 - c0) / c0 < 1e-12
    dead = pp.edge_mask == 0
    assert bool(dead.any()) and bool((out.u[dead] == 0).all())
    assert bool(torch.isfinite(out.u).all()) and out.u.abs().max() > 0


def test_rk4_accumulator_refresh_changes_nothing(setup, monkeypatch):
    """RK4's refresh of the accumulator frames (the reference's) leaves the
    step bit for bit as it is: a stage reads the accumulator only at the
    position it writes, and the submesh takes its rows from exact positions
    and its fix rows from the carried ones."""
    _, pp, fields, _ = setup
    cfg = port_cfg(_jcfg("flagship"))
    carry = pm.stack_frames(pp, cfg, _state(fields))
    sc = pm.new_rk_scratch(carry[0], cfg, "rk4")
    refresh = pm._refresh_frames
    skipped = []

    def no_acc_refresh(p, nf, nfix, persist):
        if nf is sc["acc"]:
            skipped.append(1)
            return nf
        return refresh(p, nf, nfix, persist)
    monkeypatch.setattr(pm, "_refresh_frames", no_acc_refresh)
    carry = pm.rk4_patch_megastep_framed(pp, cfg, carry, 0.0, DT,
                                         scratch=sc)
    out = pm.unstack_frames(pp, cfg, carry)
    assert len(skipped) == 3
    ref = _framed(setup, "flagship", "rk4")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_one_rk2_step_against_jax_kernel(setup, monkeypatch):
    """One framed RK2 step with upwind fluxes (the hp0 / hp1 picks that
    once shadowed the original state's h0, tests/test_patches.py:194-203):
    the port's plain stages, submesh and refreshes against the JAX
    package's framed step with its kernel in interpret mode (one chain
    instance per block, OMEGA_PATCH_K=1), frame by frame at every
    position, the fix rows, and after unstacking. One tracer: the
    interpreted kernels compile for about a minute each, more with every
    tracer."""
    jp, pp, fields, _ = setup
    Lk = 1
    jcfg = flagship_cfg(K, Lk, **UPWIND)
    cfg = port_cfg(jcfg)
    fields = fields[:2] + (fields[2][:Lk],)
    monkeypatch.setenv("OMEGA_PATCH_MEGA", "1")
    monkeypatch.setenv("OMEGA_PATCH_K", "1")
    jcarry = jpm.stack_frames(jp, jcfg, jax_state(*fields))
    jcarry = jpm.rk2_patch_megastep_framed(jp, jcfg, jcarry, 0.0, DT, K=K,
                                           L=Lk, interpret=True)
    jout = jpm.unstack_frames(jp, jcarry, K, Lk, JModelState)

    carry = pm.stack_frames(pp, cfg, _state(fields))
    carry = pm.rk2_patch_megastep_framed(pp, cfg, carry, 0.0, DT)
    p = pm.prep(pp, torch.float64, "cpu")
    S, fr = p.S, jpm.FR
    jf = np.asarray(jcarry[0])[:, :, fr:fr + S, fr:fr + S, :K]
    pf = carry[0].numpy().reshape(K, 4 + Lk, 10, S, S).transpose(
        1, 2, 3, 4, 0)
    for c in range(4 + Lk):
        err = np.abs(pf[c] - jf[c]).max() / np.abs(jf[c]).max()
        assert err < 1e-12, (c, err)
    for key in ("h", "u", "tr"):
        r = np.asarray(jcarry[1][key])
        assert np.abs(carry[1][key].numpy() - r).max() <= 1e-12 \
            * np.abs(r).max(), key
    _close(pm.unstack_frames(pp, cfg, carry), jout, 1e-12)


@pytest.mark.parametrize("stepper", list(STEPPERS))
def test_stages_per_step(setup, monkeypatch, stepper):
    """On the CPU the wrappers run their plain versions: per RK2 step the
    modes PROV, PROV, per RK4 step FIRST, MID, MID, LAST, one submesh
    tendency per stage, and with PP81 mixing one coefficient and one solve
    call per step."""
    _, pp, fields, wind = setup
    cfg = port_cfg(_jcfg("pp81"))
    calls = {"modes": [], "coeffs": 0, "solve": 0, "sub": 0}

    def wrap(name, record):
        plain = getattr(pm, name)

        def counted(*a, **kw):
            record(a)
            return plain(*a, **kw)
        monkeypatch.setattr(pm, name, counted)
    wrap("rk_stage_plain", lambda a: calls["modes"].append(a[2]))
    wrap("vmix_coeffs_plain",
         lambda a: calls.__setitem__("coeffs", calls["coeffs"] + 1))
    wrap("vmix_solve_plain",
         lambda a: calls.__setitem__("solve", calls["solve"] + 1))
    plain_tend = tend.compute_all_tendencies
    sub_mesh = pm.prep(pp, torch.float64, "cpu").sub_mesh

    def sub_tend(mesh, *a, **kw):
        calls["sub"] += mesh is sub_mesh
        return plain_tend(mesh, *a, **kw)
    monkeypatch.setattr(tend, "compute_all_tendencies", sub_tend)
    out = run_steps(pp, cfg, _state(fields), 0.0, DT, 2,
                    stepper=STEPPERS[stepper][0],
                    wind_stress=_wind(cfg, wind))
    per_step = ([pm.RK_PROV] * 2 if stepper == "rk2" else
                [pm.RK_FIRST, pm.RK_MID, pm.RK_MID, pm.RK_LAST])
    assert calls == {"modes": per_step * 2, "coeffs": 2, "solve": 2,
                     "sub": 2 * len(per_step)}
    assert bool(torch.isfinite(out.tracers).all())


# ------------------------------------------------- declined configurations

DECLINED = {
    "thomas": (dict(vert_mix=JVertMixConfig(enabled=True, method="thomas",
                                            kappa_tracer=1e-3,
                                            kappa_momentum=1e-2)), "rk2"),
    "column_ssh": (dict(ssh_formulation="column"), "rk4"),
}


@pytest.mark.parametrize("name", list(DECLINED))
def test_declined_configurations_run_composed(setup, name):
    """Thomas mixing and the column free surface are not fused under RK
    (nor by the JAX package); run_steps runs the composed stepper through
    the patch operators and agrees with the JAX package's composed steps."""
    jp, pp, fields, _ = setup
    kw, stepper = DECLINED[name]
    jcfg = flagship_cfg(K, L, **kw)
    cfg = port_cfg(jcfg)
    assert not pm.supported(pp, cfg, framed=True, kind=stepper)
    assert not jpm.supported(jp, jcfg, kind=stepper)
    assert pm.supported(pp, port_cfg(flagship_cfg(K, L)), framed=True,
                        kind=stepper)
    jstep = STEPPERS[stepper][1]
    ref = jax_call(("sphere-rk-declined", name), lambda h, u, tr: jrun_steps(
        jp, jcfg, JModelState(h, u, tr), 0.0, DT, 1, stepper=jstep),
        *jax_state(*fields))
    out = run_steps(pp, cfg, _state(fields), 0.0, DT, 1,
                    stepper=STEPPERS[stepper][0])
    _close(out, ref, 1e-12)


@pytest.mark.parametrize("what", ["fct_cfg", "fct_prep"])
def test_stage_refuses_fct(setup, what):
    """The stage wrapper refuses an FCT configuration (FCT needs the
    forward-backward step's thickness-first order) and an FCT prep; the
    framed RK path is not offered FCT."""
    _, pp, fields, _ = setup
    fcfg = port_cfg(flagship_cfg(K, L, flux_tracer_type="fct"))
    bcfg = port_cfg(flagship_cfg(K, L))
    assert not pm.supported(pp, fcfg, framed=True, kind="rk4")
    fr, _ = pm.stack_frames(pp, bcfg, _state(fields))
    p = pm.prep(pp, torch.float64, "cpu", fct=what == "fct_prep")
    cfg = fcfg if what == "fct_cfg" else bcfg
    with pytest.raises(ValueError, match="thickness-first"):
        pm.rk_stage(p, cfg, pm.RK_PROV, DT, 0.0, fr, torch.empty_like(fr),
                    base=fr)
