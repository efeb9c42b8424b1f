"""Land on the port's patch layout (mesh/icos_patches.apply_land_mask)
against the JAX package's, float64 on the CPU, on tests/test_boundary.py's
land-masked icos8 (land above 55 deg, BottomDepth 1000): the masked mesh's
arrays and per-patch stencil tables bit for bit the JAX package's; the land
mesh on its own PatchInfo with the parent mesh, its tables and its results
unchanged (the reference's apply_land_mask rewrites the parent's tables,
ROADMAP.md queue 3, so the JAX parent's run is made before JAX's call);
the framed FB path (the patch kernel's plain chain) against the composed
step at 1e-10 with u = 0 on masked edges; FB run_steps against the JAX
package's composed run_steps at 1e-12; the same ocean as carve_mesh at
1e-9; and the other fused kinds (FCT, RK2 / RK4, split) taking the land
mesh where the reference's gates do, each against its composed stepper."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_call, port_cfg

import jax.numpy as jnp

from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.mesh.icos_patches import _REGISTRY
from omega_tpu.mesh.icos_patches import apply_land_mask as japply
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import run_steps as jrun

from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh import carve_mesh, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS
from omega_tpu_torch.mesh.icos_patches import apply_land_mask
from omega_tpu_torch.ops import patch_megastep
from omega_tpu_torch.stepping import (forward_backward_step, rk2_step,
                                      rk4_step, run_steps)
from omega_tpu_torch.stepping.split import split_forward_backward_step

N, LAT, K, L, DT = 8, 55.0, 3, 2, 300.0


def _cfg(**kw):
    return JModelConfig(nvertlayers=K, ntracers=L,
                        tendencies=JTendencyConfig(visc_del2=1e3,
                                                   visc_del4=1e7), **kw)


def _state_np(mesh):
    """tests/test_boundary.py's _sphere_state: a smooth ssh, u = 0."""
    lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
    ssh = 2.0 * np.sin(2 * lat) * np.cos(lon)
    h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
    tr = 10.0 + np.cos(lat)[None, :, None] * np.ones((L, 1, K))
    return h, np.zeros((mesh.nedges, K)), tr


def _port(h, u, tr):
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return ModelState(t(h), t(u), t(tr))


@pytest.fixture(scope="module")
def land():
    """JAX parent and land mesh (the parent's reference run made first),
    the port's parent (host) and land mesh (host and on the CPU)."""
    jparent = jpatch(jsphere(N, bottom_depth=1000.0), N)
    land_mask = np.asarray(jparent.lat_cell) > np.deg2rad(LAT)
    assert land_mask.sum() > 10
    pparent = patch_icos_mesh(spherical_icos_mesh(N, bottom_depth=1000.0), N)
    # the JAX parent's tables before JAX's apply_land_mask rewrites them
    jparent_kite = [np.array(e[4]) for e in
                    _REGISTRY[jparent.patch_key].tables["kite"].entries]
    jland = japply(jparent, land_mask)
    pland = apply_land_mask(pparent, land_mask)
    return dict(jparent=jparent, jland=jland, mask=land_mask,
                jparent_kite=jparent_kite, pparent=pparent, pland=pland,
                pland_dev=pland.to("cpu", torch.float64))


def test_land_mesh_bit_equal(land):
    jm, pm = land["jland"], land["pland"]
    for name in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, name)), np.asarray(getattr(pm, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    em = np.asarray(pm.edge_mask)
    assert 0 < (em == 0).sum() < em.size
    jt = _REGISTRY[jm.patch_key].tables
    pt = pm.patch_info.tables
    assert set(jt) == set(pt)
    for name in jt:
        ja, pa = jt[name], pt[name]
        assert len(ja.entries) == len(pa.entries), name
        for x, y in zip(ja.entries, pa.entries):
            assert x[:4] == y[:4] and np.array_equal(x[4], y[4]), name
        for f in ("fix_ids", "fix_idx", "fix_w"):
            assert np.array_equal(getattr(ja, f), getattr(pa, f)), (name, f)


def test_land_mesh_has_its_own_patch_info(land):
    """The land mesh's PatchInfo is its own (masked host mesh, fresh cache
    and tables); the parent's arrays, tables and cache are left as they
    were, unlike the reference's, whose parent kite table changed."""
    pparent, pland = land["pparent"], land["pland"]
    assert pland.patch_info is not pparent.patch_info
    assert pland.patch_info.host_mesh is not pparent.patch_info.host_mesh
    assert np.array_equal(pland.patch_info.host_mesh.edge_mask,
                          pland.edge_mask)
    fresh = patch_icos_mesh(spherical_icos_mesh(N, bottom_depth=1000.0), N)
    for name in ARRAY_FIELDS:
        assert np.array_equal(np.asarray(getattr(pparent, name)),
                              np.asarray(getattr(fresh, name))), name
    for name, tab in fresh.patch_info.tables.items():
        got = pparent.patch_info.tables[name]
        for x, y in zip(tab.entries, got.entries):
            assert np.array_equal(x[4], y[4]), name
    # the reference's side effect, recorded: its parent's kite weights
    # are the land mesh's after the call
    jnow = [e[4] for e in
            _REGISTRY[land["jparent"].patch_key].tables["kite"].entries]
    assert any(not np.array_equal(a, b)
               for a, b in zip(land["jparent_kite"], jnow))
    # the port's parent still runs as before the call (its own tables)
    cfg = port_cfg(_cfg())
    st = _port(*_state_np(pparent))
    a = run_steps(pparent.to("cpu", torch.float64), cfg, st, 0.0, DT, 1)
    b = run_steps(fresh.to("cpu", torch.float64), cfg, st, 0.0, DT, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_land_tables_take_the_parent_slots(land):
    """The mega build resolves the tables a land mask changes (the tracer
    laplacians' masked geometry, the land cells' kite weights) on the
    parent mesh's slots: every slot of the land mesh's table is the
    parent's, used at no position the parent's leaves empty, so each table
    group fits the patch kernels' compiled slots (a table resolved on its
    own land weights took a seventh divergence slot at 8 positions of a
    land-masked icos48)."""
    from omega_tpu_torch.mesh import icos_mega
    parent = icos_mega.ensure_mega(land["pparent"])
    masked = icos_mega.ensure_mega(land["pland"])
    for name in ("sdiv_geo", "sdiv_geo2", "sdiv_geo4", "kite"):
        slots = {e[:4]: e[4] != 0 for e in parent.tables[name].entries}
        for e in masked.tables[name].entries:
            assert e[:4] in slots, (name, e[:4])
            assert not ((e[4] != 0) & ~slots[e[:4]]).any(), (name, e[:4])
    # every group within its compiled slots (compact_table raises past them)
    offs, _ = patch_megastep.compact_table(masked)
    assert offs.shape[0] == patch_megastep.compact_table(parent)[0].shape[0]


def test_fused_chain_matches_composed(land):
    """The framed FB path on the land mesh (the patch kernel's plain chain
    with the mask gates) against the composed step, 3 steps at 1e-10; u
    stays 0 on masked edges and land cells keep their state."""
    mesh = land["pland_dev"]
    cfg = port_cfg(_cfg())
    assert patch_megastep.supported(mesh, cfg, framed=True)
    p = patch_megastep.prep(mesh, torch.float64, "cpu")
    assert not isinstance(p.consts["edge_mask"], float), \
        "the land mask must be a per-position plane"
    st = _port(*_state_np(mesh))
    fused = run_steps(mesh, cfg, st, 0.0, DT, 3)
    comp = st
    for _ in range(3):
        comp = forward_backward_step(mesh, cfg, comp, 0.0, DT)
    for a, b in zip(fused, comp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)
    em = mesh.edge_mask.numpy()
    assert np.array_equal(fused.u.numpy()[em == 0], np.zeros(((em == 0).sum(),
                                                              K)))
    lm = land["mask"]
    assert torch.equal(fused.h[lm], st.h[lm])
    assert float(fused.u.abs().max()) > 1e-6


def test_run_steps_against_jax_composed(land):
    """FB run_steps on the port's land mesh against the JAX package's
    composed run_steps on its land mesh, 3 steps at 1e-12."""
    jm = land["jland"]
    jcfg = _cfg()
    h, u, tr = _state_np(jm)
    ref = jax_call(("land", N, "fb3"), lambda s: jrun(
        jm, jcfg, s, 0.0, DT, 3, stepper=jfb),
        JModelState(jnp.asarray(h), jnp.asarray(u), jnp.asarray(tr)))
    got = run_steps(land["pland_dev"], port_cfg(jcfg), _port(h, u, tr), 0.0,
                    DT, 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_matches_carved(land):
    """The masked mesh is the same ocean as carve_mesh(base, ~land):
    10 framed steps against 10 steps on the carved mesh, every ocean cell
    matched by position, at tests/test_boundary.py's 1e-9."""
    mesh = land["pland_dev"]
    base = spherical_icos_mesh(N, bottom_depth=1000.0)
    land_b = np.asarray(base.lat_cell) > np.deg2rad(LAT)
    carved = carve_mesh(base, ~land_b).to("cpu", torch.float64)
    cfg = port_cfg(dataclasses.replace(_cfg(), ntracers=1))
    one = lambda m: [a[:1] if i == 2 else a
                     for i, a in enumerate(_state_np(m))]
    out_m = run_steps(mesh, cfg, _port(*one(mesh)), 0.0, DT, 10)
    out_c = run_steps(carved, cfg, _port(*one(carved)), 0.0, DT, 10)
    key = lambda m: {(round(float(a), 9), round(float(b), 9)): i
                     for i, (a, b) in enumerate(zip(m.lat_cell.numpy(),
                                                    m.lon_cell.numpy()))}
    km, kc = key(mesh), key(carved)
    rows_c = list(kc.values())
    rows_m = [km[k] for k in kc]
    assert len(rows_c) == carved.ncells
    np.testing.assert_allclose(out_m.h.numpy()[rows_m],
                               out_c.h.numpy()[rows_c], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out_m.tracers.numpy()[:, rows_m],
                               out_c.tracers.numpy()[:, rows_c], rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("kind", ["fct", "rk2", "rk4", "split"])
def test_other_fused_kinds_take_the_land_mesh(land, kind):
    """The land mesh runs on every fused kind the parent does (the gates
    read no land), each framed step against its composed stepper at
    1e-10, u = 0 on masked edges."""
    mesh = land["pland_dev"]
    h, u, tr = _state_np(mesh)
    if kind == "fct":
        jcfg = _cfg(flux_tracer_type="fct")
        assert patch_megastep.supported(mesh, port_cfg(jcfg), framed=True)
        stepper = forward_backward_step
    elif kind == "split":
        jcfg = _cfg(ssh_formulation="column")
        assert patch_megastep.split_patch_supported(mesh, port_cfg(jcfg))
        stepper = split_forward_backward_step
    else:
        jcfg = _cfg()
        assert patch_megastep.supported(mesh, port_cfg(jcfg), framed=True,
                                        kind=kind)
        stepper = rk2_step if kind == "rk2" else rk4_step
    cfg = port_cfg(jcfg)
    dt = 120.0 if kind == "split" else DT
    st = _port(h, u, tr)
    run_stepper = stepper
    if kind == "split":
        from omega_tpu_torch.stepping import make_stepper
        run_stepper = make_stepper("SplitExplicit")
    fused = run_steps(mesh, cfg, st, 0.0, dt, 1, stepper=run_stepper)
    comp = stepper(mesh, cfg, st, 0.0, dt)
    for a, b in zip(fused, comp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)
    em = mesh.edge_mask.numpy()
    assert not fused.u.numpy()[em == 0].any()
