"""The split-explicit stepper on the icosahedral sphere's framed path of the
port (ops/patch_megastep.split_patch_megastep_framed: the splitpre and
splitpost kernels' plain versions, the flat 2-D phase with the barotropic
subcycles of ops/bt_gather.py, the pole submesh's composed part, the
in-frame refresh) against the JAX package, float64, at the JAX suite's own
sizes (tests/test_split.py:253-304): icosahedral subdivision 8, 4 layers, 1
tracer, dt = 120 s, 6 subcycles, bt_drag 1e-4.

- the split chains (icos_mega.split_pre_chain / split_post_chain) and the
  momentum section with the column free surface op for op, the depth const
  plane bit for bit, the prep's uniform depth as the reference's;
- the read-out: splitpre's du_out is exact wherever the FB refresh maps
  read (its mask covers the FB u_new mask), and the plain splitpre read out
  through `edge_src` with the pole rows from the submesh equals the JAX
  package's composed velocity tendency (1e-12 of its max), every row;
- the subcycles' plain version against the reference's flat `lax.scan`
  (1e-12), with bt_drag 0 and 1e-4;
- two framed steps against the JAX package's composed
  split_forward_backward_step (1e-11 of each field's max), volume to 1e-13,
  u = 0 on dead edges; one framed step against the JAX package's
  split_patch_megastep_framed with its kernels in interpret mode (1e-12,
  frame by frame);
- run_steps with split_forward_backward_step and make_split_stepper(6,
  1e-4) takes the framed branch and matches the JAX package's run_steps;
- split_patch_supported agrees with the JAX gate; CPU tensors take the
  plain versions; the wrappers refuse what the kernels do not take."""

import numpy as np
import pytest
import torch

from torch_port_helpers import flagship_cfg, jax_call, jax_state, port_cfg

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.core import tendencies as jtend
from omega_tpu.mesh import icos_mega as jmega
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import patch_megastep as jpm
from omega_tpu.ops import trisk as jtrisk
from omega_tpu.stepping import run_steps as jrun_steps
from omega_tpu.stepping.split import make_split_stepper as jmake_split
from omega_tpu.stepping.split import split_forward_backward_step as jsplit

from omega_tpu_torch.core import ModelState
from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.ops import bt_gather
from omega_tpu_torch.ops import patch_megastep as pm
from omega_tpu_torch.stepping import run_steps
from omega_tpu_torch.stepping.split import (make_split_stepper,
                                            split_forward_backward_step)

N = 8
K, L, DT = 4, 1, 120.0
M, R = 6, 1e-4


def _jcfg(**kw):
    return flagship_cfg(K, L, ssh_formulation="column", **kw)


@pytest.fixture(scope="module")
def setup():
    """JAX and port patch meshes and seeded fields (tests/test_split.py's
    state): h from depth + 100 m sin(2 lat) cos(lon), u = 0.05 noise x
    edge_mask, tracers 10 + noise."""
    jp = jpatch(jsphere(N), N)
    pp = patch_icos_mesh(spherical_icos_mesh(N), N).to("cpu", torch.float64)
    rng = np.random.default_rng(19)
    lat, lon = np.asarray(jp.lat_cell), np.asarray(jp.lon_cell)
    d0 = float(np.asarray(jp.bottom_depth)[0])
    h = (d0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.05 * rng.standard_normal((jp.nedges, K)) \
        * np.asarray(jp.edge_mask)[:, None]
    tr = 10.0 + rng.standard_normal((L, jp.ncells, K))
    return jp, pp, (h, u, tr)


def _state(fields):
    return ModelState(*(torch.as_tensor(a) for a in fields))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _close(out, ref, tol):
    for f in ("h", "u", "tracers"):
        err = _rel(getattr(out, f), getattr(ref, f))
        assert err < tol, (f, err)


# ------------------------------------------------------------ the chains

def test_split_chains_equal_the_reference():
    """The split chains and the momentum section with the column free
    surface equal the JAX package's op for op, every value's class agrees,
    and split_ops hands out the two chains (center fluxes only)."""
    for nl in (1, 2):
        for name in ("split_pre_chain", "split_post_chain"):
            ops = getattr(icos_mega, name)(nl)
            assert ops == getattr(jmega, name)(nl), (name, nl)
            for op in ops:
                assert icos_mega.chain_class(op[0]) == \
                    jmega.chain_class(op[0])
    for hv in ("h", "h_new"):
        for ssh in ("stacked", "column"):
            for uw in (False, True):
                assert icos_mega._vel_tend_ops(hv, ssh=ssh, uw_h=uw) == \
                    jmega._vel_tend_ops(hv, ssh=ssh, uw_h=uw)
    assert icos_mega._vel_tend_ops("h", ssh="column") == \
        jmega._vel_tend_ops("h", ssh="column")
    cfg = port_cfg(_jcfg())
    assert pm.split_ops(cfg, L) == (jmega.split_pre_chain(L),
                                    jmega.split_post_chain(L))
    with pytest.raises(ValueError, match="center"):
        pm.split_ops(port_cfg(_jcfg(flux_tracer_type="upwind")), L)


@pytest.fixture(scope="module")
def mega(setup):
    return icos_mega.ensure_mega(setup[1])


def test_depth_plane_and_prep(setup, mega):
    """The cell depth plane equals the JAX package's bit for bit; the prep
    makes it the scalar the reference's prep makes it (uniform depth), and
    the kernel's depth row is then absent."""
    jp, pp, _ = setup
    jd = jmega.ensure_mega(jp).const_planes["depth"]
    pd = mega.const_planes["depth"]
    assert jd.dtype == pd.dtype and np.array_equal(jd, pd)
    p = pm.prep(pp, torch.float64, "cpu")
    jprep = jpm._prep(jp, jnp.float64)
    assert p.consts["depth"] == jprep.const_idx["depth"] == \
        float(np.asarray(jp.bottom_depth)[0])
    assert p.depth_row is None


def test_du_out_mask_covers_the_read_out(setup, mega):
    """splitpre's du_out is exact, on whole frames, wherever the FB chain's
    tiled u_new mask says so (the refresh maps' `edge_src` picks only such
    positions), and splitpost's h_new and trn0 wherever the FB ones are:
    the kernels' outputs and the frames share one layout, so the frames'
    read-out maps serve for du_out as they are."""
    _, pp, _ = setup
    mg = mega
    m = icos_mega.chain_validity(mg.tables, mg.content, mg.resolved, 1,
                                 icos_mega.split_pre_chain(1))
    assert not (mg.masks["u_new"] & ~m["du_out"]).any()
    m = icos_mega.chain_validity(mg.tables, mg.content, mg.resolved, 1,
                                 icos_mega.split_post_chain(1))
    for key in ("h_new", "trn0"):
        assert not (mg.masks[key] & ~m[key]).any(), key
    p = pm.prep(pp, torch.float64, "cpu")
    keep = (mg.content["edge"] >= 0) & mg.masks["u_new"]
    picked = p.edge_src[p.edge_src_ok].numpy()
    assert keep.reshape(-1)[picked].all()


def test_split_pre_plain_against_composed_du(setup):
    """The plain splitpre on the frames, read out flat with the pole rows
    from the submesh (`split_du`, the driver's read-out), against the JAX
    package's composed velocity tendency with the column free surface on
    the flat patch mesh, every row (pole rows and dead seam slots
    included)."""
    jp, pp, fields = setup
    jcfg = _jcfg()
    cfg = port_cfg(jcfg)
    ref = jax_call(("sphere-split-du",), lambda h, u: jtend.
                   compute_velocity_tendency(jp, jcfg, h, u, 0.0)[0],
                   jnp.asarray(fields[0]), jnp.asarray(fields[1]))
    st = _state(fields)
    p = pm.prep(pp, torch.float64, "cpu")
    fr, _ = pm.stack_frames(pp, cfg, st)
    du = pm.split_du(pp, cfg, p, pm.split_pre_plain(p, cfg, fr), st.h, st.u,
                     0.0)
    assert _rel(du, ref) < 1e-12
    fix = p.fix_edges_global
    assert np.abs(du[fix].numpy() - np.asarray(ref)[fix.numpy()]).max() \
        < 1e-12 * np.abs(np.asarray(ref)).max()
    assert bool((du[pp.edge_mask == 0] == 0).all())


@pytest.mark.parametrize("bt_drag", [0.0, R])
def test_subcycles_plain_against_jax_scan(setup, bt_drag):
    """The subcycles' plain version (the composed loop through the patch
    stencils) against the reference's flat lax.scan
    (omega_tpu/ops/patch_megastep.py:2205-2226) on the same inputs."""
    jp, pp, _ = setup
    rng = np.random.default_rng(5)
    E, C = jp.nedges, jp.ncells
    em = np.asarray(jp.edge_mask)[:, None]
    ubar = 0.05 * rng.standard_normal((E, 1)) * em
    ssh = rng.standard_normal((C, 1))
    g_slow = 1e-6 * rng.standard_normal((E, 1)) * em
    het = 4000.0 + rng.standard_normal((E, 1))
    g, dt_bt = 9.80616, DT / M

    def scan(ub0, s0, gs, he):
        f_e = jtrisk.col(jp, "f_edge")
        mask = jtrisk.col(jp, "edge_mask")

        def fast(ub, s):
            out = (-g * jtrisk.grad_edge(jp, s)
                   + f_e * jtrisk.tangential_edge(jp, ub))
            if bt_drag:
                out = out - bt_drag * ub
            return mask * out

        def body(c, _):
            ub, s, acc = c
            ub = ub + dt_bt * (fast(ub, s) + gs)
            s = s - dt_bt * jtrisk.div_cell(jp, he * ub)
            return (ub, s, acc + ub), None
        (ub, s, acc), _ = jax.lax.scan(body, (ub0, s0, jnp.zeros_like(ub0)),
                                       None, length=M)
        return ub, s, acc / M
    ref = jax_call(("sphere-split-scan", bt_drag), scan, *map(
        jnp.asarray, (ubar, ssh, g_slow, het)))
    got = bt_gather.subcycles_plain(
        pp, *map(torch.as_tensor, (ubar, ssh, g_slow, het)), gravity=g,
        dt_bt=dt_bt, n_subcycles=M, bt_drag=bt_drag)
    for a, b in zip(got, ref):
        assert _rel(a, b) < 1e-12


# ----------------------------------------------------------- whole steps

def _jax_composed(setup, nsteps):
    jp, _, fields = setup
    jcfg = _jcfg()

    def steps(h, u, tr):
        st = JModelState(h, u, tr)
        for i in range(nsteps):
            st = jsplit(jp, jcfg, st, i * DT, DT, n_subcycles=M, bt_drag=R)
        return st
    return jax_call(("sphere-split-composed", nsteps), steps,
                    *jax_state(*fields))


def test_two_framed_steps_against_jax_composed(setup):
    """Two framed steps (the driver called directly, the carry's buffers
    swapped as run_steps swaps them) against the JAX package's composed
    split stepper: every field to 1e-11 of its max, pole rows included;
    volume to 1e-13; u exactly 0 on dead seam edges."""
    _, pp, fields = setup
    cfg = port_cfg(_jcfg())
    assert pm.split_patch_supported(pp, cfg)
    carry = pm.stack_frames(pp, cfg, _state(fields))
    nxt = torch.empty_like(carry[0])
    for i in range(2):
        cur = carry[0]
        carry = pm.split_patch_megastep_framed(pp, cfg, carry, i * DT, DT,
                                               M, R, out=nxt)
        nxt = cur
    out = pm.unstack_frames(pp, cfg, carry)
    _close(out, _jax_composed(setup, 2), 1e-11)
    a = pp.area_cell[:, None]
    h0 = torch.as_tensor(fields[0])
    assert abs((a * out.h).sum() - (a * h0).sum()) / (a * h0).sum() < 1e-13
    dead = pp.edge_mask == 0
    assert bool(dead.any()) and bool((out.u[dead] == 0).all())
    assert out.u.abs().max() > 0


def test_one_framed_step_against_jax_kernel(setup, monkeypatch):
    """One framed step against the JAX package's split_patch_megastep_framed
    with its kernels in interpret mode (one chain instance per block,
    OMEGA_PATCH_K=1; about a minute on one core): frame by frame at every
    position, the fix rows, and after unstacking."""
    jp, pp, fields = setup
    jcfg = _jcfg()
    cfg = port_cfg(jcfg)
    monkeypatch.setenv("OMEGA_PATCH_MEGA", "1")
    monkeypatch.setenv("OMEGA_PATCH_K", "1")
    jcarry = jpm.stack_frames(jp, jcfg, jax_state(*fields))
    jcarry = jpm.split_patch_megastep_framed(jp, jcfg, jcarry, 0.0, DT, K=K,
                                             L=L, n_subcycles=M, bt_drag=R,
                                             interpret=True)
    jout = jpm.unstack_frames(jp, jcarry, K, L, JModelState)
    carry = pm.stack_frames(pp, cfg, _state(fields))
    carry = pm.split_patch_megastep_framed(pp, cfg, carry, 0.0, DT, M, R)
    p = pm.prep(pp, torch.float64, "cpu")
    S, fr = p.S, jpm.FR
    jf = np.asarray(jcarry[0])[:, :, fr:fr + S, fr:fr + S, :K]
    pf = carry[0].numpy().reshape(K, 4 + L, 10, S, S).transpose(
        1, 2, 3, 4, 0)
    for c in range(4 + L):
        assert _rel(pf[c], jf[c]) < 1e-12, c
    for key in ("h", "u", "tr"):
        r = np.asarray(jcarry[1][key])
        assert np.abs(carry[1][key].numpy() - r).max() <= 1e-12 \
            * np.abs(r).max(), key
    _close(pm.unstack_frames(pp, cfg, carry), jout, 1e-12)


STEPPERS = {"bare": (split_forward_backward_step, jsplit),
            "factory": (make_split_stepper(M, R), jmake_split(M, R))}


@pytest.mark.parametrize("name", list(STEPPERS))
def test_run_steps_takes_the_framed_branch(setup, monkeypatch, name):
    """run_steps with the bare split stepper (10 subcycles, no drag) and
    with make_split_stepper(6, 1e-4) runs the framed step (one call per
    step, with the stepper's subcycles and drag) and agrees with the JAX
    package's run_steps (1e-11)."""
    jp, pp, fields = setup
    jcfg = _jcfg()
    cfg = port_cfg(jcfg)
    step, jstep = STEPPERS[name]
    calls = []
    framed = pm.split_patch_megastep_framed

    def spy(*a, **kw):
        calls.append(a[5:7])
        return framed(*a, **kw)
    monkeypatch.setattr(pm, "split_patch_megastep_framed", spy)
    out = run_steps(pp, cfg, _state(fields), 0.0, DT, 2, stepper=step)
    assert calls == [step.split_explicit_params] * 2
    ref = jax_call(("sphere-split-run", name), lambda h, u, tr: jrun_steps(
        jp, jcfg, JModelState(h, u, tr), 0.0, DT, 2, stepper=jstep),
        *jax_state(*fields))
    _close(out, ref, 1e-11)


# ------------------------------------------------------ gate and wrappers

GATE = {
    "flagship_column": dict(ssh_formulation="column"),
    "stacked": {},
    "upwind_thickness": dict(ssh_formulation="column",
                             flux_thickness_type="upwind"),
    "upwind_tracer": dict(ssh_formulation="column",
                          flux_tracer_type="upwind"),
    "fct": dict(ssh_formulation="column", flux_tracer_type="fct"),
    "vmix": dict(ssh_formulation="column",
                 vert_mix=JVertMixConfig(enabled=True, kappa_tracer=1e-3,
                                         kappa_momentum=1e-2)),
    "wind": dict(ssh_formulation="column",
                 tendencies=dict(wind_forcing=True)),
    "drag": dict(ssh_formulation="column",
                 tendencies=dict(bottom_drag=True, bottom_drag_coeff=3e-3)),
    "no_hyperdiff": dict(ssh_formulation="column",
                         tendencies=dict(velocity_hyperdiff=False)),
    "two_tracers_column": dict(ssh_formulation="column"),
}


def test_gate_agrees_with_the_reference(setup):
    """split_patch_supported against the JAX package's gate on ten
    configurations (the flagship with the column free surface the only
    ones taken) and on a mesh without patches."""
    jp, pp, _ = setup
    taken = []
    for name, kw in GATE.items():
        kw = dict(kw)
        nl = 2 if name == "two_tracers_column" else L
        jcfg = flagship_cfg(K, nl, tendencies=kw.pop("tendencies", {}), **kw)
        got = pm.split_patch_supported(pp, port_cfg(jcfg))
        assert got == jpm.split_patch_supported(jp, jcfg), name
        if got:
            taken.append(name)
    assert taken == ["flagship_column", "two_tracers_column"]
    assert not pm.split_patch_supported(spherical_icos_mesh(4),
                                        port_cfg(_jcfg()))


def test_cpu_takes_the_plain_versions(setup):
    """On CPU tensors the wrappers run the plain versions and count no
    launch: splitpre returns the plain du_out, splitpost writes h_new and
    the tracers and leaves the u channels, the subcycles are the plain
    loop, bit for bit."""
    _, pp, fields = setup
    cfg = port_cfg(_jcfg())
    p = pm.prep(pp, torch.float64, "cpu")
    fr, _ = pm.stack_frames(pp, cfg, _state(fields))
    before = (pm.split_pre_launches, pm.split_post_launches,
              bt_gather.launches)
    du = torch.empty((K, 3, p.P), dtype=torch.float64)
    assert pm.split_pre(p, cfg, fr, out=du) is du
    assert torch.equal(du, pm.split_pre_plain(p, cfg, fr))
    out = torch.full_like(fr, 7.0)
    pm.split_post(p, cfg, fr, DT, out)
    ref = pm.split_post_plain(p, cfg, fr, DT)
    assert torch.equal(out[:, :1], ref[:, :1])
    assert torch.equal(out[:, 4:], ref[:, 1:])
    assert bool((out[:, 1:4] == 7.0).all())
    E, C = pp.nedges, pp.ncells
    args = (torch.zeros(E, 1, dtype=torch.float64) + 0.01,
            torch.ones(C, 1, dtype=torch.float64),
            torch.zeros(E, 1, dtype=torch.float64),
            torch.full((E, 1), 4000.0, dtype=torch.float64))
    kw = dict(gravity=9.80616, dt_bt=DT / M, n_subcycles=M, bt_drag=R)
    for a, b in zip(bt_gather.bt_subcycles(pp, *args, **kw),
                    bt_gather.subcycles_plain(pp, *args, **kw)):
        assert torch.equal(a, b)
    assert (pm.split_pre_launches, pm.split_post_launches,
            bt_gather.launches) == before


def test_unsupported_configurations(setup, monkeypatch):
    """The split wrappers refuse upwind fluxes and an FCT prep, splitpost
    its own input as output; run_steps runs a configuration the gate
    declines (wind forcing) through the composed split stepper, not the
    framed one."""
    _, pp, fields = setup
    cfg = port_cfg(_jcfg())
    p = pm.prep(pp, torch.float64, "cpu")
    fr, _ = pm.stack_frames(pp, cfg, _state(fields))
    upw = port_cfg(_jcfg(flux_thickness_type="upwind"))
    with pytest.raises(ValueError, match="center"):
        pm.split_pre(p, upw, fr)
    with pytest.raises(ValueError, match="center"):
        pm.split_post(p, upw, fr, DT, torch.empty_like(fr))
    with pytest.raises(ValueError, match="FB prep"):
        pm.split_pre(pm.prep(pp, torch.float64, "cpu", fct=True), cfg, fr)
    with pytest.raises(ValueError, match="out of place"):
        pm.split_post(p, cfg, fr, DT, fr)
    windy = port_cfg(_jcfg(tendencies=dict(wind_forcing=True)))
    assert not pm.split_patch_supported(pp, windy)

    def refuse(*a, **kw):
        raise AssertionError("the framed split path ran")
    monkeypatch.setattr(pm, "split_patch_megastep_framed", refuse)
    out = run_steps(pp, windy, _state(fields), 0.0, DT, 1,
                    stepper=make_split_stepper(M, R))
    assert bool(torch.isfinite(out.u).all())
