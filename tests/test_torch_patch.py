"""The fused sphere step of the port (ops/patch_megastep.py) against the JAX
package, float64, icosahedral subdivision 8: the plain version of the
patch kernel on frames, after the in-frame refresh, against the JAX kernel
in interpret mode (1e-12 of each field's max, as tests/test_patches.py:186
holds its kernel); `run_steps` on the patch mesh (the framed path) against
the JAX package's composed `run_steps` (1e-12); the framed carry against
the per-step API (1e-13, tests/test_patches.py:395); volume and tracer
conservation (1e-13); exact zeros on dead edges; and the compact table the
CUDA kernel reads, applied as the kernel applies it, against the
reference's padded-domain tables."""

import numpy as np
import pytest
import torch

from torch_port_helpers import flagship_cfg, jax_call, jax_state, port_cfg

from omega_tpu.core import ModelState as JModelState
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.ops import patch_megastep as jpm
from omega_tpu.stepping import run_steps as jrun_steps

from omega_tpu_torch.core import ModelState
from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import planar_hex_mesh, spherical_icos_mesh
from omega_tpu_torch.mesh.icos_patches import NPER
from omega_tpu_torch.ops import patch_megastep
from omega_tpu_torch.stepping import forward_backward_step, run_steps

N = 8
K, L, DT, NSTEPS = 3, 2, 60.0, 3


@pytest.fixture(scope="module")
def setup():
    """JAX and port patch meshes, the flagship configuration, and seeded
    fields: h from 4000 m + 100 m sin(2 lat) cos(lon), u noise times the
    edge mask, tracers near 10."""
    jp = jpatch(jsphere(N), N)
    pp = patch_icos_mesh(spherical_icos_mesh(N), N).to("cpu", torch.float64)
    jcfg = flagship_cfg(K, L)
    rng = np.random.default_rng(11)
    lat, lon = np.asarray(jp.lat_cell), np.asarray(jp.lon_cell)
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.1 * rng.standard_normal((jp.nedges, K)) \
        * np.asarray(jp.edge_mask)[:, None]
    tr = 10.0 + rng.standard_normal((L, jp.ncells, K))
    return jp, pp, jcfg, port_cfg(jcfg), (h, u, tr)


def _state(fields):
    return ModelState(*(torch.as_tensor(a) for a in fields))


def _close(out, ref, tol):
    for f in ("h", "u", "tracers"):
        r = np.asarray(getattr(ref, f))
        err = np.abs(getattr(out, f).numpy() - r).max() / np.abs(r).max()
        assert err < tol, (f, err)


def test_supported(setup):
    """The flagship and its science options (upwind fluxes, wind, drag;
    tests/test_torch_sphere_science.py holds them) are fused; column ssh
    and a missing standard term are not."""
    _, pp, _, cfg, _ = setup
    assert patch_megastep.supported(pp, cfg)
    for kw in (dict(flux_thickness_type="upwind"),
               dict(flux_tracer_type="upwind"),
               dict(tendencies=dict(wind_forcing=True)),
               dict(tendencies=dict(bottom_drag=True))):
        assert patch_megastep.supported(pp, port_cfg(
            flagship_cfg(K, L, **kw))), kw
    for kw in (dict(ssh_formulation="column"),
               dict(tendencies=dict(tracer_hyperdiff=False))):
        assert not patch_megastep.supported(pp, port_cfg(
            flagship_cfg(K, L, **kw))), kw
    assert not patch_megastep.supported(
        planar_hex_mesh(16, 8, dc=5000.0), cfg)


def test_plain_chain_against_jax_kernel(setup, monkeypatch):
    """One framed step: the port's plain chain, submesh step and refresh
    against the JAX kernel in interpret mode (one chain instance per block,
    OMEGA_PATCH_K=1: the block classes only skip entries that are zero in
    the block), frame by frame at every position, and after unstacking.
    One tracer: the interpreted kernel compiles for about a minute, more
    with every tracer."""
    jp, pp, _, _, fields = setup
    Lk = 1
    jcfg = flagship_cfg(K, Lk)
    cfg = port_cfg(jcfg)
    fields = fields[:2] + (fields[2][:Lk],)
    monkeypatch.setenv("OMEGA_PATCH_MEGA", "1")
    monkeypatch.setenv("OMEGA_PATCH_K", "1")
    js = jax_state(*fields)
    jcarry = jpm.stack_frames(jp, jcfg, js)
    jcarry = jpm.fb_patch_megastep_framed(jp, jcfg, jcarry, 0.0, DT, K=K,
                                          L=Lk, interpret=True)
    jout = jpm.unstack_frames(jp, jcarry, K, Lk, JModelState)

    carry = patch_megastep.stack_frames(pp, cfg, _state(fields))
    carry = patch_megastep.fb_patch_megastep_framed(pp, cfg, carry, 0.0, DT)
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    S, fr = p.S, jpm.FR
    jf = np.asarray(jcarry[0])[:, :, fr:fr + S, fr:fr + S, :K]
    pf = carry[0].numpy().reshape(K, 4 + Lk, 10, S, S).transpose(1, 2, 3, 4,
                                                                 0)
    for c in range(4 + Lk):
        err = np.abs(pf[c] - jf[c]).max() / np.abs(jf[c]).max()
        assert err < 1e-12, (c, err)
    for key in ("h", "u", "tr"):
        r = np.asarray(jcarry[1][key])
        assert np.abs(carry[1][key].numpy() - r).max() <= 1e-12 \
            * np.abs(r).max(), key
    _close(patch_megastep.unstack_frames(pp, cfg, carry), jout, 1e-12)


@pytest.fixture(scope="module")
def framed(setup):
    """NSTEPS of the port's run_steps on the patch mesh (the framed path)."""
    _, pp, _, cfg, fields = setup
    return run_steps(pp, cfg, _state(fields), 0.0, DT, NSTEPS)


def test_run_steps_against_jax_composed(setup, framed):
    jp, _, jcfg, _, fields = setup

    def jax_steps(h, u, tr):
        return jrun_steps(jp, jcfg, JModelState(h, u, tr), 0.0, DT, NSTEPS)
    ref = jax_call(("sphere-run", N, K, L), jax_steps, *jax_state(*fields))
    _close(framed, ref, 1e-12)


def test_framed_carry_against_per_step_api(setup, framed):
    _, pp, _, cfg, fields = setup
    st = _state(fields)
    for i in range(NSTEPS):
        st = patch_megastep.fb_patch_megastep(pp, cfg, st, i * DT, DT)
    _close(framed, st, 1e-13)


def test_framed_against_composed_steps(setup, framed):
    """The port's own composed stepper through the patch operators (the
    CPU's forward_backward_step) agrees with the framed path."""
    _, pp, _, cfg, fields = setup
    st = _state(fields)
    for i in range(NSTEPS):
        st = forward_backward_step(pp, cfg, st, i * DT, DT)
    _close(framed, st, 1e-12)


def test_conservation(setup, framed):
    """Volume and tracer content over NSTEPS to 1e-13."""
    _, pp, _, _, fields = setup
    a = pp.area_cell[:, None]
    h0, _, tr0 = _state(fields)
    vol0, vol1 = (a * h0).sum(), (a * framed.h).sum()
    assert abs(vol1 - vol0) / vol0 < 1e-13
    for l in range(L):
        c0 = (a * h0 * tr0[l]).sum()
        c1 = (a * framed.h * framed.tracers[l]).sum()
        assert abs(c1 - c0) / c0 < 1e-13, l


def test_dead_edges_stay_zero(setup, framed):
    _, pp, _, _, _ = setup
    dead = pp.edge_mask == 0
    assert dead.any()
    assert (framed.u[dead] == 0).all()
    assert torch.isfinite(framed.u).all() and framed.u.abs().max() > 0


def _apply_compact(p, name, src):
    """A table of the compact layout applied as the CUDA kernel applies
    it: out[td, p] = sum over the slots of (td, p) of w * src[p + offset],
    src flat (Ts * P,) of one layer."""
    P = p.P
    row_off = row_w = 0
    for gname, names, ns in patch_megastep.GROUPS:
        td_n = NPER[p.mg.tables[names[0]].dst_class]
        rows = td_n * ns
        if name in names:
            i = names.index(name)
            off = p.offs[row_off:row_off + rows].numpy().astype(np.int64)
            w = p.wts[row_w + i * rows:row_w + (i + 1) * rows].numpy()
            pos = np.arange(P)
            terms = w * src[pos[None, :] + off]
            return terms.reshape(td_n, ns, P).sum(1)
        row_off += rows
        row_w += rows * len(names)
    raise KeyError(name)


def test_compact_table_matches_reference_tables(setup):
    """Every table of the chain through the compact layout equals the sum
    of the reference's entry planes, at every frame position, on random
    sources (the layout the CUDA kernel reads, tested on the host)."""
    _, pp, _, _, _ = setup
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    mg, S, P = p.mg, p.S, p.P
    assert p.offs.shape == (60, P) and p.wts.shape == (120, P)
    assert p.cpl.shape == (17, P)
    rng = np.random.default_rng(3)
    for name, tab in mg.tables.items():
        ts_n = NPER[tab.src_class]
        src = rng.standard_normal((ts_n, 10, S, S))
        ref = np.zeros((NPER[tab.dst_class], 10, S, S))
        for (td, ts, da, db, wpl) in tab.entries:
            ref[td] += wpl * np.roll(src[ts], (-db, -da), axis=(-2, -1))
        got = _apply_compact(p, name, src.reshape(-1))
        np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0,
                                   atol=1e-13 * np.abs(ref).max(),
                                   err_msg=name)


def test_compact_reads_stay_in_the_frame(setup):
    """Every used slot reads a position of its destination's own rhombus
    frame in a channel of its source field, and an unused slot (weight 0
    in every table of its group) reads its own position."""
    _, pp, _, _, _ = setup
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    S, P = p.S, p.P
    off = p.offs.numpy().astype(np.int64)
    pos = np.arange(P)[None, :]
    row_off = row_w = 0
    for gname, names, ns in patch_megastep.GROUPS:
        td_n = NPER[p.mg.tables[names[0]].dst_class]
        ts_n = NPER[p.mg.tables[names[0]].src_class]
        rows = td_n * ns
        o = off[row_off:row_off + rows]
        w = p.wts[row_w:row_w + rows * len(names)].numpy().reshape(
            len(names), rows, P)
        used = np.broadcast_to((w != 0).any(0), o.shape)
        src = pos + o
        assert ((src >= 0) & (src < ts_n * P))[used].all(), gname
        assert ((src % P) // (S * S) == pos // (S * S))[used].all(), gname
        assert (o[~used] == 0).all(), gname
        row_off += rows
        row_w += rows * len(names)


def test_mega_arguments_reach_the_prep(setup):
    """The run-time prep uses the reference's defaults: margin 8, tile 16,
    worst-case masks."""
    _, pp, _, _, _ = setup
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    assert p.mg is icos_mega.ensure_mega(pp)
    assert (p.mh, p.S) == (icos_mega.MH, N + 2 * icos_mega.MH)
