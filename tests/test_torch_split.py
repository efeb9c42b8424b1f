"""The split-explicit stepper of the port against the JAX package in float64:
the composed `split_forward_backward_step` over 3 steps at the JAX suite's
1e-10 (tests/test_split.py:237-240) with and without the linear barotropic
drag and on a science configuration the fused path declines; the barotropic
kernel's plain version against the JAX kernel in interpret mode and against
the composed subcycle loop (1e-12, tests/test_split.py:199-202); the plain
splitpre -> barotropic -> splitpost chain on the stacked layout, whole grid
and tiled as the kernels cut their slabs; `run_steps` with the split
steppers; conservation over 20 steps (tests/test_split.py:42-56);
`split_supported` against the JAX package's; the probed rings."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_call, jax_mesh, jax_state,
                                jax_wind, port_cfg, port_mesh, port_state,
                                port_wind, random_fields, science_cfg,
                                stratified_fields, wind_fields)

import jax.numpy as jnp

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.ops import barotropic_kernel as jbtk
from omega_tpu.ops import megastep as jmegastep
from omega_tpu.stepping import make_stepper as jmake_stepper
from omega_tpu.stepping import run_steps as jrun_steps
from omega_tpu.stepping.split import make_split_stepper as jmake_split
from omega_tpu.stepping.split import split_forward_backward_step as jsplit

from omega_tpu_torch.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import barotropic_kernel as btk
from omega_tpu_torch.ops import megastep
from omega_tpu_torch.stepping import (make_split_stepper, make_stepper,
                                      run_steps, split_forward_backward_step)

K, L, DT, NSTEPS = 3, 2, 120.0, 3
# (n_subcycles, bt_drag)
CASES = {"m7": (7, 0.0), "m8_drag": (8, 1e-4)}


def _setup(name="flagship", seed=3):
    jm = jax_mesh(32, 16)
    if name == "flagship":
        # (tracer hyperdiffusion on, so that every level of splitpost acts)
        jcfg = flagship_cfg(K, L, ssh_formulation="column",
                            tendencies=dict(eddy_diff4=1e6))
        fields = random_fields(jm, K, L, seed)
    else:
        jcfg = dataclasses.replace(science_cfg(name, K),
                                   ssh_formulation="column")
        fields = stratified_fields(jm, K, seed)
    return jm, port_mesh(jm), jcfg, port_cfg(jcfg), fields


def _close(out, ref, tol=1e-10):
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(out, n).numpy(),
                                   np.asarray(getattr(ref, n)),
                                   rtol=tol, atol=tol, err_msg=n)


def _jax_steps(key, jm, jcfg, fields, M, r, wind=None):
    """NSTEPS composed JAX split steps, the step jitted once per key."""
    w = () if wind is None else jax_wind(wind)

    def step(h, u, tr, t, *w):
        return jsplit(jm, jcfg, JModelState(h, u, tr), t, DT,
                      wind_stress=w or None, n_subcycles=M, bt_drag=r)
    s = jax_state(*fields)
    for i in range(NSTEPS):
        s = jax_call(("split", key), step, *s, jnp.asarray(i * DT), *w)
    return s


@pytest.mark.parametrize("case", CASES)
def test_composed_split_matches_jax(case):
    jm, pm, jcfg, cfg, fields = _setup()
    M, r = CASES[case]
    assert megastep.split_supported(pm, cfg)   # the card would fuse it
    ps = port_state(*fields)
    for i in range(NSTEPS):
        ps = split_forward_backward_step(pm, cfg, ps, i * DT, DT,
                                         n_subcycles=M, bt_drag=r)
    _close(ps, _jax_steps(case, jm, jcfg, fields, M, r))


def test_composed_split_science_matches_jax():
    """Wind, bottom drag and PP81 mixing with the column free surface: the
    fused path declines it, the composed stepper runs wind, drag and _mix."""
    jm, pm, jcfg, cfg, fields = _setup("pp81_wind_drag")
    assert not megastep.split_supported(pm, cfg)
    wind = wind_fields(jm)
    ps = port_state(*fields)
    for i in range(NSTEPS):
        ps = split_forward_backward_step(pm, cfg, ps, i * DT, DT,
                                         wind_stress=port_wind(wind),
                                         n_subcycles=8, bt_drag=1e-4)
    _close(ps, _jax_steps("science", jm, jcfg, fields, 8, 1e-4, wind))


def test_split_refuses_stacked_ssh():
    _, pm, _, _, fields = _setup()
    cfg = port_cfg(flagship_cfg(K, L))
    with pytest.raises(ValueError, match="column"):
        split_forward_backward_step(pm, cfg, port_state(*fields), 0.0, DT)


def _bt_inputs(jm, seed=5):
    rng = np.random.default_rng(seed)
    E, C = jm.nedges, jm.ncells
    ubar = 0.02 * rng.standard_normal((E, 1))
    ssh = 0.5 * rng.standard_normal((C, 1))
    g_slow = 1e-6 * rng.standard_normal((E, 1))
    het = 1000.0 + rng.standard_normal((E, 1))
    return ubar, ssh, g_slow, het


def test_bt_plain_matches_jax_kernel():
    """The port's plain barotropic subcycles against the JAX kernel run in
    interpret mode (M = 7, bt_drag = 1e-4), 1e-12."""
    jm, pm, jcfg, _, _ = _setup()
    ins = _bt_inputs(jm)
    kw = dict(gravity=jcfg.gravity, dt_bt=DT / 7, n_subcycles=7,
              bt_drag=1e-4)
    ref = jbtk.bt_subcycles(jm, *[jnp.asarray(a) for a in ins],
                            interpret=True, **kw)
    got = btk.bt_subcycles(pm, *[torch.as_tensor(a) for a in ins], **kw)
    for a, b, n in zip(got, ref, ("ub_final", "ssh_final", "ubar_avg")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14, err_msg=n)


def test_bt_plain_matches_the_subcycle_loop(monkeypatch):
    """The composed split step with its subcycles in the barotropic kernel's
    plain version against the same step with the composed loop (the JAX
    suite's test_bt_kernel_matches_scan), M = 7, bt_drag = 1e-4."""
    _, pm, _, cfg, fields = _setup()
    ps = port_state(*fields)
    slow = split_forward_backward_step(pm, cfg, ps, 0.0, DT, n_subcycles=7,
                                       bt_drag=1e-4)
    calls = []
    monkeypatch.setattr(btk, "enabled", lambda x: calls.append(1) or True)
    fast = split_forward_backward_step(pm, cfg, ps, 0.0, DT, n_subcycles=7,
                                       bt_drag=1e-4)
    assert calls
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(fast, n).numpy(),
                                   getattr(slow, n).numpy(), rtol=1e-12,
                                   atol=1e-14, err_msg=n)


@pytest.mark.parametrize("tile", [None, (7, 5)], ids=["whole", "ragged7x5"])
def test_plain_split_chain_matches_jax(tile):
    """splitpre -> barotropic subcycles -> splitpost with the plain versions
    on the stacked layout, whole grid and tile by tile with each pass's
    probed ring, against JAX's composed split step."""
    jm, pm, jcfg, cfg, fields = _setup()
    M, r = CASES["m8_drag"]
    s = megastep.stack_state(pm, port_state(*fields))
    for _ in range(NSTEPS):
        s = megastep.split_megastep_plain(pm, cfg, s, DT, M, r, tile=tile)
    _close(megastep.unstack_state(pm, s, K, L, ModelState),
           _jax_steps("m8_drag", jm, jcfg, fields, M, r))


@pytest.mark.parametrize("which", ["SplitExplicit", "m8_drag"])
def test_run_steps_split_matches_jax(monkeypatch, which):
    """run_steps with make_stepper("SplitExplicit") (M = 10, no drag) and
    make_split_stepper(8, 1e-4) against JAX run_steps, composed and on the
    stacked fast path (taken for a CUDA state; here forced on the CPU, where
    the kernels' wrappers run their plain versions)."""
    jm, pm, jcfg, cfg, fields = _setup()
    if which == "SplitExplicit":
        step, jstep = make_stepper(which), jmake_stepper(which)
        assert step.split_explicit_params == (10, 0.0)
    else:
        step, jstep = make_split_stepper(8, 1e-4), jmake_split(8, 1e-4)
    ref = jax_call(("run_steps", which), lambda h, u, tr: jrun_steps(
        jm, jcfg, JModelState(h, u, tr), 0.0, DT, NSTEPS, stepper=jstep),
        *jax_state(*fields))
    ps = port_state(*fields)
    _close(run_steps(pm, cfg, ps, 0.0, DT, NSTEPS, stepper=step), ref)
    monkeypatch.setattr(megastep, "enabled", lambda state: True)
    fused = []
    stacked = megastep.split_megastep_stacked
    monkeypatch.setattr(megastep, "split_megastep_stacked",
                        lambda *a, **k: fused.append(a[4:6]) or stacked(*a,
                                                                        **k))
    _close(run_steps(pm, cfg, ps, 0.0, DT, NSTEPS, stepper=step), ref)
    assert fused == [step.split_explicit_params] * NSTEPS


def _conservation_setup():
    """The JAX suite's split setup (tests/test_split.py:20-37): 16 x 16,
    dc = 10 km, 3 layers, no diffusion, an ssh bump at rest."""
    mesh = planar_hex_mesh(16, 16, dc=10000.0, f0=1e-4,
                           bottom_depth=1000.0).to("cpu", torch.float64)
    cfg = ModelConfig(
        nvertlayers=3, ntracers=2, ssh_formulation="column",
        tendencies=TendencyConfig(visc_del2=0.0, velocity_diffusion=False,
                                  velocity_hyperdiff=False,
                                  tracer_diffusion=False,
                                  tracer_hyperdiff=False))
    x, y = mesh.x_cell.numpy(), mesh.y_cell.numpy()
    kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
    h = (1000.0 + np.sin(kx * x) * np.sin(ky * y))[:, None] / 3 \
        * np.ones((1, 3))
    tr = np.stack([(10.0 + np.cos(kx * x))[:, None] * np.ones((1, 3)),
                   20.0 * np.ones((mesh.ncells, 3))])
    st = port_state(h, np.zeros((mesh.nedges, 3)), tr)
    return mesh, cfg, st


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "stacked"])
def test_split_conservation(monkeypatch, fused):
    """Volume to 1e-13 and tracer content to rtol 1e-12 over 20 steps of
    120 s, composed and on the stacked path's plain versions."""
    mesh, cfg, st = _conservation_setup()
    if fused:
        monkeypatch.setattr(megastep, "enabled", lambda state: True)
    area = mesh.area_cell[:, None]
    vol0 = torch.sum(area * st.h).item()
    trc0 = torch.sum(area * st.h * st.tracers, dim=(1, 2)).numpy()
    out = run_steps(mesh, cfg, st, 0.0, DT, 20,
                    stepper=split_forward_backward_step)
    vol1 = torch.sum(area * out.h).item()
    trc1 = torch.sum(area * out.h * out.tracers, dim=(1, 2)).numpy()
    assert abs(vol1 - vol0) / vol0 < 1e-13
    np.testing.assert_allclose(trc1, trc0, rtol=1e-12)
    assert bool(torch.isfinite(out.u).all()) and out.u.abs().max() > 0


# option -> flagship_cfg keywords of a column-ssh configuration
SUPPORT = {
    "fused": {},
    "upwind": dict(flux_thickness_type="upwind"),
    "upwind_tracer": dict(flux_tracer_type="upwind"),
    "wind": dict(tendencies=dict(wind_forcing=True)),
    "drag": dict(tendencies=dict(bottom_drag=True, bottom_drag_coeff=3e-3)),
    "vmix": dict(vert_mix=JVertMixConfig(enabled=True)),
}


@pytest.mark.parametrize("what", list(SUPPORT) + ["stacked_ssh"])
def test_split_supported_agrees_with_jax(what):
    jm = jax_mesh(32, 16)
    pm = port_mesh(jm)
    kw = dict(SUPPORT.get(what, {}))
    ssh = "stacked" if what == "stacked_ssh" else "column"
    jcfg = flagship_cfg(K, L, tendencies=kw.pop("tendencies", {}),
                        ssh_formulation=ssh, **kw)
    got = megastep.split_supported(pm, port_cfg(jcfg))
    assert got == jmegastep.split_supported(jm, jcfg)
    assert got == (what == "fused")
    assert btk.supported(pm)


def test_rings_are_probed_and_tight():
    """Each split pass and the barotropic subcycle with its probed ring
    reproduces the whole-grid result tile by tile, point for point; with one
    row or one column less of ring some owned value differs (7-row tiles, so
    that slabs start on rows of both parities, as the probe assumes)."""
    _, pm, _, cfg, fields = _setup()
    tabs, c = megastep._split_args(pm, cfg, DT, 1e-4)
    s = megastep.stack_state(pm, port_state(*fields))
    du, pre = megastep.split_pre_plain(pm, cfg, s, 1e-4)
    planes = s.new_zeros((megastep.NPLANES,) + tuple(s.shape[2:]))
    planes[:pre.shape[0]] = pre
    planes[megastep.P_UBF:megastep.P_UAVG + 3] = 0.01
    runs = {kind: (megastep._SPLIT_CHAINS[kind][0],
                   [s] if kind in ("splitcol", "splitpre") else [s, du],
                   None if kind == "splitcol" else planes,
                   megastep.split_ring(tabs, kind), c)
            for kind in megastep._SPLIT_CHAINS}
    cb = btk._consts(pm, cfg.gravity, DT / 8, 1e-4)
    runs["bt"] = (btk._subcycle, [], pre[:10], btk.ring(tabs), cb)
    assert runs["splitpre"][3] == (2, 3) and runs["bt"][3] == (2, 2)
    for kind, (fn, vols, pl, (ry, rx), consts) in runs.items():
        whole = megastep._run_tiled(pm, fn, vols, pl, tabs, consts, None,
                                    None)
        tiled = megastep._run_tiled(pm, fn, vols, pl, tabs, consts, (7, 5),
                                    (ry, rx))
        assert torch.equal(tiled, whole), kind   # same arithmetic
        for short in ((ry - 1, rx), (ry, rx - 1)):
            worse = megastep._run_tiled(pm, fn, vols, pl, tabs, consts,
                                        (7, 5), short)
            assert not torch.equal(worse, whole), (kind, short)


def test_split_wrappers_take_cpu_arrays_and_count_nothing():
    """On CPU arrays the kernels' wrappers run their plain versions into the
    work arrays and launch nothing."""
    _, pm, _, cfg, fields = _setup()
    s = megastep.stack_state(pm, port_state(*fields))
    before = (megastep.split_pre_launches, megastep.split_post_launches,
              btk.launches)
    du, planes = megastep.split_work(s)
    megastep.split_pre(pm, cfg, s, du, planes, 1e-4)
    du_p, pre_p = megastep.split_pre_plain(pm, cfg, s, 1e-4)
    assert torch.equal(du, du_p)
    assert torch.equal(planes[:pre_p.shape[0]], pre_p)
    out = megastep.split_megastep_stacked(pm, cfg, s, DT, 8, 1e-4)
    assert torch.equal(out, megastep.split_megastep_plain(pm, cfg, s, DT, 8,
                                                          1e-4))
    with pytest.raises(ValueError):
        megastep.split_megastep_stacked(pm, cfg, s, DT, out=s)
    assert before == (megastep.split_pre_launches,
                      megastep.split_post_launches, btk.launches)


def test_subcycle_route(monkeypatch):
    """Where the composed split stepper runs its subcycles: on a CUDA array
    (here the kernels' `enabled` made to say so) the planar kernel on a
    mesh it takes and the gather-form kernel on any other (the sphere, a
    carved sphere, a planar mesh off the compiled pattern); the plain loop
    on a CPU array, with a sharded halo or a traced dt. A composed step on
    the gather route makes one call of bt_gather.bt_subcycles."""
    from omega_tpu_torch.mesh import carve_mesh, spherical_icos_mesh
    from omega_tpu_torch.ops import bt_gather
    from omega_tpu_torch.stepping import split as split_mod
    from omega_tpu_torch.stepping.steppers import _identity
    _, pm, _, cfg, fields = _setup()
    sph = spherical_icos_mesh(4)
    lat = np.asarray(sph.lat_cell)
    carved = carve_mesh(sph, np.abs(lat) > 0.3)
    ub = torch.zeros(1, 1, dtype=torch.float64)
    route = split_mod.subcycle_route
    assert route(pm, ub, _identity, DT) == "plain"
    assert route(sph, ub, _identity, DT) == "plain"
    monkeypatch.setattr(btk, "enabled", lambda x: True)
    monkeypatch.setattr(bt_gather, "enabled", lambda x: True)
    assert route(pm, ub, _identity, DT) == "planar"
    assert route(sph, ub, _identity, DT) == "gather"
    assert route(carved, ub, _identity, DT) == "gather"
    assert route(pm, ub, lambda s: s, DT) == "plain"
    assert route(pm, ub, _identity, torch.tensor(DT)) == "plain"
    monkeypatch.setattr(megastep, "hex_pattern_fits", lambda m: False)
    assert not btk.supported(pm)
    assert route(pm, ub, _identity, DT) == "gather"
    calls = []

    def recorder(mesh, *args, **kw):
        calls.append(kw["n_subcycles"])
        return bt_gather.subcycles_plain(mesh, *args, **kw)
    monkeypatch.setattr(bt_gather, "bt_subcycles", recorder)
    got = split_forward_backward_step(pm, cfg, port_state(*fields), 0.0, DT,
                                      n_subcycles=7)
    assert calls == [7]
    monkeypatch.undo()
    ref = split_forward_backward_step(pm, cfg, port_state(*fields), 0.0, DT,
                                      n_subcycles=7)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
