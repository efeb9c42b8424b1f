"""The port's gather path against the JAX package: mesh/reorder.py,
mesh/carve.py, the gather tables of ops/trisk.py (`warm_gather`) and the
plain version of the gather kernel (ops/gather_kernel.apply_plain), on the
CPU in float64.

- Reordered meshes: permutations and every mesh array bit-equal to the JAX
  package's (`rcm` and `sfc`, icos8, icos16 and planar 16 x 16), and the
  window statistics equal.
- Tables: each of the 16 tables' idx / w equal to the JAX GatherTable's
  (reconstructed from bases and relative indices where the weight is not 0).
- `apply_plain` against the JAX Pallas gather in interpret mode (1e-12
  absolute, tests/test_gather.py's limit) and against `trisk._gather_sum`.
- Steps at icos8 x 3 layers x 2 tracers, the port on the table path
  against the JAX steppers with OMEGA_PALLAS_GATHER=1 (1e-11 absolute):
  3 FB steps, one FCT step, one RK4 step, one FB step of the science
  configuration (upwind fluxes, wind, bottom drag 3e-3, PP81 mixing) and
  one split-explicit step (column ssh, 10 subcycles).
- Carved meshes: `carve_mesh` bit-equal to JAX's; the port's reordered
  carved mesh keeps the coast and its steps equal, after permuting back,
  JAX's on the un-reordered carved mesh; JAX's own `reorder_mesh` loses the
  coast's edge mask (a statement about the reference).
- The direct kernel's launch plan: its threads cover every output value
  once at each vector width, on the 16 tables of the reordered icos8 and of
  the reordered carved icos8; a torch emulation of the kernel, block by
  block, equals `apply_plain` bit for bit in float64 and float32.
- Dispatch: a CPU field takes the plain version; an unsupported dtype,
  shape or device raises.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_call, jax_state, port_cfg,
                                port_state)

import jax.numpy as jnp

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.mesh import planar_hex_mesh as jplanar
from omega_tpu.mesh.carve import carve_mesh as jcarve
from omega_tpu.mesh.reorder import gather_window_stats as jstats
from omega_tpu.mesh.reorder import reorder_mesh as jreorder
from omega_tpu.mesh.reorder import sfc_permutations as jperms
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import pallas_gather as jpg
from omega_tpu.ops import trisk as jtrisk
from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import rk4_step as jrk4
from omega_tpu.stepping import run_steps as jrun_steps
from omega_tpu.stepping.split import split_forward_backward_step as jsplit

from omega_tpu_torch.mesh import (carve_mesh, planar_hex_mesh,
                                  reorder_mesh, spherical_icos_mesh)
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS
from omega_tpu_torch.mesh.reorder import (gather_window_stats,
                                          sfc_permutations)
from omega_tpu_torch.ops import gather_kernel, trisk
from omega_tpu_torch.stepping import (forward_backward_step, rk4_step,
                                      run_steps)
from omega_tpu_torch.stepping.split import split_forward_backward_step

NAMES = ("div", "div_pos", "div_neg", "ke", "signed_div", "curl", "kite",
         "tang", "cdiff", "cmean", "vdiff", "vmean", "c0", "c1", "v0", "v1")
# stencil -> the class of its source rows (cell, edge, vertex)
SOURCE = {"div": "e", "div_pos": "e", "div_neg": "e", "ke": "e",
          "signed_div": "e", "curl": "e", "kite": "c", "tang": "e",
          "cdiff": "c", "cmean": "c", "vdiff": "v", "vmean": "v",
          "c0": "c", "c1": "c", "v0": "v", "v1": "v"}
K, L, DT = 3, 2, 30.0


def _gen(kind):
    """(JAX mesh, port mesh) of the same generator, host numpy."""
    if kind == "planar16":
        return (jplanar(16, 16, dc=5000.0, f0=1e-4, bottom_depth=1000.0),
                planar_hex_mesh(16, 16, dc=5000.0, f0=1e-4,
                                bottom_depth=1000.0))
    n = int(kind[4:])
    return jsphere(n), spherical_icos_mesh(n)


_BASE, _REORD = {}, {}


def base(kind):
    if kind not in _BASE:
        _BASE[kind] = _gen(kind)
    return _BASE[kind]


def reordered(kind, method="rcm"):
    if (kind, method) not in _REORD:
        jm, pm = base(kind)
        _REORD[kind, method] = (jreorder(jm, method), reorder_mesh(pm, method))
    return _REORD[kind, method]


def continent(mesh):
    """Land where |lat| < 60 deg and 0 <= lon < 40 deg."""
    lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
    lon = np.mod(lon, 2 * np.pi)
    return (np.abs(lat) < np.deg2rad(60.0)) & (lon < np.deg2rad(40.0))


def island(mesh):
    """tests/test_boundary.py's 6 x 6 island of a 24 x 24 plane."""
    i = np.arange(mesh.ncells) % 24
    j = np.arange(mesh.ncells) // 24
    return (i >= 9) & (i < 15) & (j >= 9) & (j < 15)


def _arrays_equal(jm, pm):
    return [n for n in ARRAY_FIELDS
            if not np.array_equal(np.asarray(getattr(jm, n)),
                                  np.asarray(getattr(pm, n)))]


@pytest.mark.parametrize("method", ["rcm", "sfc"])
@pytest.mark.parametrize("kind", ["icos8", "icos16", "planar16"])
def test_reorder_bit_equal(kind, method):
    jm, pm = base(kind)
    for a, b in zip(jperms(jm, method), sfc_permutations(pm, method)):
        np.testing.assert_array_equal(a, b)
    jr, pr = reordered(kind, method)
    assert _arrays_equal(jr, pr) == []
    assert (pr.gather_info is not None) == (method == "rcm")
    for reduce in ("max", "median"):
        assert gather_window_stats(pr, reduce=reduce) == jstats(jr,
                                                                reduce=reduce)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["icos8", "icos16"])
def test_tables_equal_jax(kind, name):
    jr, pr = reordered(kind)
    jt, t = jpg.get(jr, name), pr.gather_info[name]
    assert jt is not None
    jw = np.asarray(jt.w)
    jidx = np.asarray(jt.bases).repeat(jpg.BLOCK)[:, None] \
        + np.asarray(jt.rel)
    np.testing.assert_array_equal(t.w, jw)
    np.testing.assert_array_equal(t.idx, np.where(jw != 0.0, jidx, 0))
    assert (t.n, t.nblocks) == (jt.n, jt.nblocks)
    assert t.idx.dtype == np.int32 and t.w.dtype == np.float64
    assert t.window <= jt.window


def _field(mesh, cls, lead=(), kk=5, seed=0):
    n = {"c": mesh.ncells, "e": mesh.nedges, "v": mesh.nvertices}[cls]
    return np.random.default_rng(seed).standard_normal(lead + (n, kk))


@pytest.mark.parametrize("name", ["tang", "div", "kite", "cmean"])
def test_apply_plain_against_pallas_interpret(name):
    """Two leading indices, K = 4 (the Pallas call pads it to 128 lanes)."""
    jr, pr = reordered("icos8")
    f = _field(pr, SOURCE[name], (2,), 4, seed=1)
    ref = jpg.apply(jpg.get(jr, name), jnp.asarray(f), interpret=True)
    got = gather_kernel.apply_plain(pr.gather_info[name], torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def _jax_weights(jm, name):
    """(weights, idx) of the JAX package's _gather_sum for a table."""
    a = lambda n: np.asarray(getattr(jm, n))
    E = jm.nedges
    two = {"cdiff": [-1.0, 1.0], "cmean": [0.5, 0.5],
           "vdiff": [-1.0, 1.0], "vmean": [0.5, 0.5]}
    if name in two:
        idx = a("cells_on_edge" if name[0] == "c" else "vertices_on_edge")
        return np.tile(two[name], (E, 1)), idx
    if name in ("c0", "c1", "v0", "v1"):
        idx = a("cells_on_edge" if name[0] == "c" else "vertices_on_edge")
        return np.ones((E, 1)), idx[:, int(name[1]):int(name[1]) + 1]
    w_div = a("w_div_cell")
    return {"div": (w_div, a("edges_on_cell")),
            "div_pos": (np.maximum(w_div, 0.0), a("edges_on_cell")),
            "div_neg": (np.maximum(-w_div, 0.0), a("edges_on_cell")),
            "ke": (a("w_ke_cell"), a("edges_on_cell")),
            "signed_div": (-a("edge_sign_on_cell") / a("area_cell")[:, None],
                           a("edges_on_cell")),
            "curl": (a("w_curl_vertex"), a("edges_on_vertex")),
            "kite": (a("w_kite_frac"), a("cells_on_vertex")),
            "tang": (a("weights_on_edge"), a("edges_on_edge"))}[name]


@pytest.mark.parametrize("name", NAMES)
def test_apply_plain_against_gather_sum(name):
    jr, pr = reordered("icos16")
    f = _field(pr, SOURCE[name], (), 6, seed=2)
    w, idx = _jax_weights(jr, name)
    ref = jtrisk._gather_sum(w, idx, jnp.asarray(f))
    got = gather_kernel.apply_plain(pr.gather_info[name], torch.as_tensor(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def _sphere_fields(mesh, kk, ll, seed=0):
    """bench.py's sphere state (h = (depth + sin 2 lat cos lon) / K) with
    u = 0.01 x noise x edge_mask and tracers 10 + noise, numpy float64."""
    rng = np.random.default_rng(seed)
    lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
    depth = np.asarray(mesh.bottom_depth)
    h = (depth + np.sin(2 * lat) * np.cos(lon))[:, None] / kk \
        * np.ones((1, kk))
    u = 0.01 * rng.standard_normal((mesh.nedges, kk)) \
        * np.asarray(mesh.edge_mask)[:, None]
    tr = 10.0 + rng.standard_normal((ll, mesh.ncells, kk))
    return h, u, tr


def _assert_state(got, ref, perm=None):
    for i, n in enumerate(("h", "u", "tracers")):
        r = np.asarray(ref[i])
        if perm is not None:
            r = r[..., perm[n], :]
        np.testing.assert_allclose(getattr(got, n).numpy(), r, rtol=0,
                                   atol=1e-11, err_msg=n)


PP81 = JVertMixConfig(enabled=True, scheme="pp81", nu0=1e-2, alpha=5.0,
                      n_exp=2, temp_index=0, salt_index=1)
# kind -> (flagship_cfg keywords, steps, JAX stepper, port stepper, wind,
# the index_select launches of the steps: only FCT's extrema have no table)
STEPS = {
    "fb3": ({}, 3, jfb, forward_backward_step, False, 0),
    "fct1": (dict(flux_tracer_type="fct"), 1, jfb, forward_backward_step,
             False, 2),
    "rk4": ({}, 1, jrk4, rk4_step, False, 0),
    "science": (dict(flux_thickness_type="upwind", flux_tracer_type="upwind",
                     vert_mix=PP81, tendencies=dict(
                         wind_forcing=True, bottom_drag=True,
                         bottom_drag_coeff=3e-3)),
                1, jfb, forward_backward_step, True, 0),
    "split": (dict(ssh_formulation="column"), 1, jsplit,
              split_forward_backward_step, False, 0),
}


@pytest.mark.parametrize("kind", list(STEPS))
def test_steps_against_jax_gather_kernel(kind, monkeypatch):
    """The port's table path (apply_plain on the CPU) against the JAX
    steppers with the Pallas gather on (interpret mode): 3 FB steps, one FB
    step with FCT tracer fluxes (div_pos / div_neg), one RK4 step, one FB
    step of the science configuration (wind stress 0.1 cos lat, 0.05 sin
    lat) and one split-explicit step."""
    jr, pr = reordered("icos8")
    kw, nsteps, jstep, step, wind, takes = STEPS[kind]
    jcfg = flagship_cfg(K, L, **kw)
    fields = _sphere_fields(pr, K, L)
    lat = np.asarray(pr.lat_cell)
    stress = (0.1 * np.cos(lat), 0.05 * np.sin(lat)) if wind else None
    monkeypatch.setenv("OMEGA_PALLAS_GATHER", "1")

    def jax_steps(h, u, tr, *ws):
        s = JModelState(h, u, tr)
        for i in range(nsteps):
            s = jstep(jr, jcfg, s, i * DT, DT,
                      wind_stress=tuple(ws) if ws else None)
        return s
    ref = jax_call(("gather-steps", kind), jax_steps, *jax_state(*fields),
                   *(jnp.asarray(w) for w in stress or ()))
    mesh = pr.to("cpu", torch.float64)
    trisk.take_launches = 0
    s = port_state(*fields)
    ws = None if stress is None else tuple(torch.as_tensor(w)
                                           for w in stress)
    for i in range(nsteps):
        s = step(mesh, port_cfg(jcfg), s, i * DT, DT, wind_stress=ws)
    assert trisk.take_launches == takes
    _assert_state(s, ref)


_CARVED = {}


def carved(kind):
    """(JAX carved mesh, port carved mesh, port reordered carved mesh)."""
    if kind not in _CARVED:
        if kind == "island":
            jm = jplanar(24, 24, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
            pm = planar_hex_mesh(24, 24, dc=5000.0, f0=1e-4,
                                 bottom_depth=1000.0)
            keep = ~island(jm)
        else:
            jm, pm = base(kind)
            keep = ~continent(jm)
        pc = carve_mesh(pm, keep)
        _CARVED[kind] = (jcarve(jm, keep), pc, reorder_mesh(pc))
    return _CARVED[kind]


@pytest.mark.parametrize("kind", ["island", "icos8"])
def test_carve_bit_equal(kind):
    jc, pc, _ = carved(kind)
    assert (jc.ncells, jc.nedges, jc.nvertices) == (pc.ncells, pc.nedges,
                                                    pc.nvertices)
    assert _arrays_equal(jc, pc) == []
    assert (np.asarray(pc.edge_mask) == 0).sum() > 0


@pytest.mark.parametrize("kind", ["island", "icos8"])
def test_reorder_keeps_the_coast(kind):
    """The port's reordered carved mesh has the carved mesh's coast: the
    same count of masked edges, the same mask after the permutation."""
    _, pc, pr = carved(kind)
    _, ep, _ = sfc_permutations(pc)
    em = np.asarray(pc.edge_mask)
    np.testing.assert_array_equal(np.asarray(pr.edge_mask), em[ep])
    assert (np.asarray(pr.edge_mask) == 0).sum() == (em == 0).sum() > 0
    assert len(pr.gather_info) == len(NAMES)


def test_reference_reorder_loses_the_coast():
    """The JAX package's reorder_mesh remaps the clamped connectivity: on
    the island mesh its coast edges (46) all read as interior after the
    renumbering. If the reference ever keeps its coast, this fails."""
    jc, _, _ = carved("island")
    assert (np.asarray(jc.edge_mask) == 0).sum() == 46
    assert (np.asarray(jreorder(jc).edge_mask) == 0).sum() == 0


def test_coastal_steps_against_jax_unreordered():
    """3 FB steps on the port's reordered carved icos8 (the table path, the
    coast's slots at weight 0) equal, permuted back, the JAX package's
    jitted run_steps on the un-reordered carved mesh (index gathers)."""
    jc, pc, pr = carved("icos8")
    cp, ep, _ = sfc_permutations(pc)
    jcfg = flagship_cfg(K, L)
    fields = _sphere_fields(pc, K, L, seed=3)
    ref = jax_call(("gather-coast",), lambda h, u, tr: jrun_steps(
        jc, jcfg, JModelState(h, u, tr), 0.0, DT, 3,
        stepper=jfb), *jax_state(*fields))
    h, u, tr = fields
    out = run_steps(pr.to("cpu", torch.float64), port_cfg(jcfg),
                    port_state(h[cp], u[ep], tr[:, cp]), 0.0, DT, 3,
                    stepper=forward_backward_step)
    _assert_state(out, ref, {"h": cp, "u": ep, "tracers": cp})
    coast = np.asarray(pr.edge_mask) == 0
    assert coast.any() and (out.u.numpy()[coast] == 0.0).all()


def _plan_meshes():
    return {"icos8": reordered("icos8")[1], "coastal": carved("icos8")[2]}


def _direct_grid(n, K, itemsize):
    """csrc/gather.cu's direct launch for n rows of K values of `itemsize`
    bytes, 16-byte aligned: (vector width, blocks of 256 threads, each
    thread's row, vector and whether it is live)."""
    wide = 16 // itemsize
    vw = wide if K % wide == 0 else 2 if K % 2 == 0 else 1
    nv = K // vw
    blocks = -(-n * nv // 256)
    g = np.arange(blocks * 256)
    return vw, blocks, g // nv, g % nv, g < n * nv


@pytest.mark.parametrize("kind", ["icos8", "coastal"])
def test_direct_grid_covers_every_output(kind):
    """The direct launch's threads cover every (row, value of K) of every
    table's output once, at every vector width, with no empty block."""
    mesh = _plan_meshes()[kind]
    assert len(mesh.gather_info) == len(NAMES)
    for name, t in mesh.gather_info.items():
        for K, itemsize in ((12, 4), (6, 4), (5, 4), (12, 8), (3, 8),
                            (1, 8)):
            vw, blocks, n, v, live = _direct_grid(t.n, K, itemsize)
            assert vw * itemsize <= 16 and K % vw == 0
            assert blocks * 256 - live.sum() < 256, name
            hits = np.zeros((t.n, K), np.int64)
            cols = v[live, None] * vw + np.arange(vw)
            np.add.at(hits, (n[live, None], cols), 1)
            assert (hits == 1).all(), (name, K, itemsize)


def _emulate_direct(table, field):
    """csrc/gather.cu's direct form in torch, block by block: each live
    thread's row slots loaded once, then for every leading index its
    vector of K summed in slot order, every product rounded on its own."""
    lead, K = field.shape[:-2], field.shape[-1]
    f = field.reshape((-1,) + field.shape[-2:])
    out = torch.full((f.shape[0], table.n, K), float("nan"),
                     dtype=field.dtype)
    vw, blocks, n, v, live = _direct_grid(table.n, K, field.element_size())
    idx = torch.as_tensor(table.idx, dtype=torch.long)
    w = torch.as_tensor(table.w, dtype=field.dtype)
    for b in range(blocks):
        sl = slice(b * 256, (b + 1) * 256)
        nb = torch.as_tensor(n[sl][live[sl]])
        cols = torch.as_tensor(v[sl][live[sl], None] * vw + np.arange(vw))
        ix, wr = idx[nb], w[nb]
        for l in range(f.shape[0]):
            s = wr[:, :1] * f[l][ix[:, :1], cols]
            for j in range(1, table.m):
                s = s + wr[:, j:j + 1] * f[l][ix[:, j:j + 1], cols]
            out[l][nb[:, None], cols] = s
    return out.reshape(lead + (table.n, K))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["icos8", "coastal"])
def test_direct_emulator_equals_plain(kind, dtype):
    mesh = _plan_meshes()[kind]
    rng = np.random.default_rng(7)
    for name, t in mesh.gather_info.items():
        for K in (12, 6, 3):
            f = torch.as_tensor(rng.standard_normal((2, t.nsrc, K)),
                                dtype=dtype)
            assert torch.equal(_emulate_direct(t, f),
                               gather_kernel.apply_plain(t, f)), (name, K)


def test_apply_dispatch():
    """A CPU field takes the plain version; an unsupported dtype, shape or
    device raises."""
    _, pr = reordered("icos8")
    t = pr.gather_info["tang"]
    f = torch.as_tensor(_field(pr, "e", (2,), 1, seed=4))
    assert torch.equal(gather_kernel.apply(t, f),
                       gather_kernel.apply_plain(t, f))
    assert gather_kernel.apply(t, f).shape == (2, pr.nedges, 1)
    with pytest.raises(TypeError):
        gather_kernel.apply(t, f.to(torch.float16))
    with pytest.raises(TypeError):
        gather_kernel.apply(t, f.to(torch.int32))
    with pytest.raises(ValueError):
        gather_kernel.apply(t, f[:, :-1])
    with pytest.raises(ValueError):
        gather_kernel.apply(t, f[0, :, 0])
    with pytest.raises(ValueError):
        gather_kernel.apply(t, f.to("meta"))


def test_mesh_copies_share_tables():
    """The tables ride along through .to(); the device copy of a table is
    made once per (device, dtype)."""
    _, pr = reordered("icos8")
    m32, m64 = pr.to("cpu", torch.float32), pr.to("cpu", torch.float64)
    assert m32.gather_info is pr.gather_info is m64.gather_info
    t = pr.gather_info["div"]
    a = t.on("cpu", torch.float32)
    assert t.on("cpu", torch.float32)[1] is a[1]
    assert a[1].dtype == torch.float32 and a[0].dtype == torch.int32


def test_fb_step_gather_calls_match_port_bounds(monkeypatch):
    """One FB step on a mesh with tables makes exactly the gather passes
    port_bounds.FB_STEP_GATHERS counts (by table and leading count), the
    profile behind the per-step sums of chip_smoke.py's kernel_gather."""
    import port_bounds

    _, pr = reordered("icos8")
    names = {id(t): n for n, t in pr.gather_info.items()}
    calls = {}
    plain = gather_kernel.apply

    def counting(table, field):
        key = (names[id(table)], int(np.prod(field.shape[:-2])))
        calls[key] = calls.get(key, 0) + 1
        return plain(table, field)
    monkeypatch.setattr(gather_kernel, "apply", counting)
    jcfg = flagship_cfg(K, L)
    forward_backward_step(pr.to("cpu", torch.float64), port_cfg(jcfg),
                          port_state(*_sphere_fields(pr, K, L)), 0.0, DT)
    assert calls == port_bounds.FB_STEP_GATHERS
