"""The icosahedral sphere of the port against the JAX package, float64:
`spherical_icos_mesh(8)` and `patch_icos_mesh` bit for bit (arrays,
connectivity, content maps, fills, per-patch tables), the mega-step build
(wide content, padded-domain tables, validity masks, paste-back maps, fix
sets, the pole submesh) equal to the JAX package's, every composed patch
operator against the JAX operator on the patch mesh, and composed steps of
configurations the fused sphere path declines."""

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_call, jax_state, port_cfg,
                                port_state)

import jax.numpy as jnp

from omega_tpu.core import ModelState as JModelState
from omega_tpu.mesh import icos_mega as jmega
from omega_tpu.mesh.horz_mesh import \
    unclamped_connectivity as junclamped
from omega_tpu.mesh.icos_patches import _REGISTRY
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import trisk as jtrisk
from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import rk4_step as jrk4

from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.mesh.horz_mesh import (ARRAY_FIELDS, META_FIELDS,
                                            unclamped_connectivity)
from omega_tpu_torch.ops import patch_megastep
from omega_tpu_torch.ops import trisk
from omega_tpu_torch.stepping import forward_backward_step, rk4_step

N = 8
K, L, DT = 3, 2, 60.0


@pytest.fixture(scope="module")
def meshes():
    """(JAX sphere, JAX patch mesh, port sphere, port patch mesh), host."""
    js = jsphere(N)
    ps = spherical_icos_mesh(N)
    return js, jpatch(js, N), ps, patch_icos_mesh(ps, N)


@pytest.fixture(scope="module")
def megas(meshes):
    _, jp, _, pp = meshes
    return jmega.ensure_mega(jp), icos_mega.ensure_mega(pp)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("which", ["sphere", "patch"])
def test_mesh_arrays_bit_equal(meshes, which):
    js, jp, ps, pp = meshes
    jm, pm = (js, ps) if which == "sphere" else (jp, pp)
    for name in ARRAY_FIELDS:
        _same(getattr(jm, name), getattr(pm, name), name)
    for name in META_FIELDS:
        assert getattr(jm, name) == getattr(pm, name), name
    assert pm.ncells == 10 * N * N + 2 and pm.on_sphere


@pytest.mark.parametrize("which", ["sphere", "patch"])
def test_unclamped_connectivity(meshes, which):
    js, jp, ps, pp = meshes
    jm, pm = (js, ps) if which == "sphere" else (jp, pp)
    ju, pu = junclamped(jm), unclamped_connectivity(pm)
    assert set(ju) == set(pu)
    for name in ju:
        _same(ju[name], pu[name], name)


def test_patch_layout_equal(meshes):
    _, jp, _, pp = meshes
    ji, pi = _REGISTRY[jp.patch_key], pp.patch_info
    assert (ji.n, ji.ncells, ji.nedges, ji.nvertices) == \
        (pi.n, pi.ncells, pi.nedges, pi.nvertices)
    for cls in ji.content:
        _same(ji.content[cls], pi.content[cls], cls)
        for a, b in zip(ji.fills[cls], pi.fills[cls]):
            _same(a, b, cls)
    assert set(ji.tables) == set(pi.tables)
    for name, jt in ji.tables.items():
        pt = pi.tables[name]
        assert (jt.dst_class, jt.src_class, jt.n_dst) == \
            (pt.dst_class, pt.src_class, pt.n_dst)
        assert [e[:4] for e in jt.entries] == [e[:4] for e in pt.entries]
        for ej, ep in zip(jt.entries, pt.entries):
            _same(ej[4], ep[4], name)
        for f in ("fix_ids", "fix_idx", "fix_w"):
            _same(getattr(jt, f), getattr(pt, f), f"{name}.{f}")


def test_mega_build_equal(megas):
    jg, pg = megas
    assert (jg.n, jg.by, jg.S) == (pg.n, pg.by, pg.S)
    for cls in jg.content:
        _same(jg.content[cls], pg.content[cls], cls)
    for cls in pg.fills:
        for a, b in zip(jg.fills[cls], pg.fills[cls]):
            _same(a, b, cls)
    for name, pt in pg.tables.items():
        jt = jg.tables[name]
        assert [e[:4] for e in jt.entries] == [e[:4] for e in pt.entries]
        for ej, ep in zip(jt.entries, pt.entries):
            _same(ej[4], ep[4], name)
        _same(jg.resolved[name], pg.resolved[name], name)
    assert set(jg.masks) == set(pg.masks)
    for name in jg.masks:
        _same(jg.masks[name], pg.masks[name], name)
    for name in jg.outputs:
        for a, b in zip(jg.outputs[name], pg.outputs[name]):
            _same(a, b, name)
    for name in pg.const_planes:
        _same(jg.const_planes[name], pg.const_planes[name], name)
    for f in ("sub_cells", "sub_edges", "fix_cells_local",
              "fix_cells_global", "fix_edges_local", "fix_edges_global"):
        _same(getattr(jg, f), getattr(pg, f), f)
    for name in ARRAY_FIELDS:
        _same(getattr(jg.sub_mesh, name), getattr(pg.sub_mesh, name), name)


def test_mega_build_cached_and_tight_masks(meshes, megas):
    """One build per argument set, kept on the mesh; the tight masks of
    the flagship chain trust at least every position the worst-case
    masks trust."""
    pp = meshes[3]
    _, pg = megas
    assert icos_mega.ensure_mega(pp) is pg
    assert icos_mega.ensure_mega(pp.to("cpu", torch.float64)) is pg
    tight = icos_mega.ensure_mega(pp, phys_masks=False)
    assert tight is not pg
    for name in ("h_new", "u_new", "trn0"):
        assert (tight.masks[name] | ~pg.masks[name]).all(), name
    assert len(tight.fix_cells_global) <= len(pg.fix_cells_global)


OPERATORS = {
    "div_cell": "edge", "curl_vertex": "edge", "tangential_edge": "edge",
    "grad_edge": "cell", "ke_cell": "edge", "cell_to_vertex_kite": "cell",
    "cell_mean_on_edge": "cell", "cell_diff_on_edge": "cell",
    "vertex_mean_on_edge": "vertex", "vertex_diff_on_edge": "vertex",
    "edge_to_cell_signed": "edge", "div_cell_pos": "edge",
    "div_cell_neg": "edge", "interp_cell_to_edge_iso": "cell",
    "cell_pair_on_edge": "cell", "vertex_pair_on_edge": "vertex",
    "cell_neighbor_extrema": "cell"}


@pytest.mark.parametrize("name", OPERATORS)
def test_patch_operator(meshes, name):
    _, jp, _, pp = meshes
    pm = pp.to("cpu", torch.float64)
    n = {"cell": jp.ncells, "edge": jp.nedges, "vertex": jp.nvertices}[
        OPERATORS[name]]
    f = np.random.default_rng(7).standard_normal((2, n, 4))
    ref = getattr(jtrisk, name)(jp, jnp.asarray(f))
    out = getattr(trisk, name)(pm, torch.as_tensor(f))
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(refs, outs):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err < 1e-13, (name, err)


def _sphere_fields(jm, seed):
    rng = np.random.default_rng(seed)
    lat, lon = np.asarray(jm.lat_cell), np.asarray(jm.lon_cell)
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.1 * rng.standard_normal((jm.nedges, K)) \
        * np.asarray(jm.edge_mask)[:, None]
    tr = 10.0 + rng.standard_normal((L, jm.ncells, K))
    return h, u, tr


@pytest.mark.parametrize("name", ["upwind", "rk4"])
def test_composed_steps_decline_fused(meshes, name):
    """Steps the fused sphere path declines (the per-step FB API on a CPU
    state, here with upwind fluxes; the RK4 stepper) run composed through
    the patch operators and agree with the JAX package's composed steps
    (1e-12 of each field's max)."""
    _, jp, _, pp = meshes
    pm = pp.to("cpu", torch.float64)
    kw = (dict(flux_thickness_type="upwind", flux_tracer_type="upwind")
          if name == "upwind" else {})
    jcfg = flagship_cfg(K, L, **kw)
    cfg = port_cfg(jcfg)
    jstep, step = (jfb, forward_backward_step) if name == "upwind" \
        else (jrk4, rk4_step)
    # (both configurations are fused for the FB stepper's framed path and
    # the per-step API on a CUDA state; neither for RK4 or a CPU state)
    assert patch_megastep.supported(pm, cfg)
    assert not patch_megastep.enabled(pm.area_cell)
    fields = _sphere_fields(jp, 5)

    def jax_steps(h, u, tr):
        s = JModelState(h, u, tr)
        for i in range(2):
            s = jstep(jp, jcfg, s, i * DT, DT)
        return s
    ref = jax_call(("sphere-composed", name), jax_steps, *jax_state(*fields))
    s = port_state(*fields)
    for i in range(2):
        s = step(pm, cfg, s, i * DT, DT)
    for f in ("h", "u", "tracers"):
        r = np.asarray(getattr(ref, f))
        err = np.abs(getattr(s, f).numpy() - r).max() / np.abs(r).max()
        assert err < 1e-12, (f, err)
