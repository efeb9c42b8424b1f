"""The port's sharded patch path (parallel/patch_shard.py) on the CPU,
float64, every shard on the CPU: the exchange plan's index lists the JAX
package's build_patch_shard entry for entry (host numpy on both sides; no
Pallas interpret; positions mapped into the JAX package's wider frames);
the sharded run against the port's single-device framed path (run_steps) at tests/test_patch_shard.py's 1e-13 for 2, 5 and 10
shards (it is bit for bit: the shard's kernel computes on its slice of the
compact table, which no stencil leaves, and the refresh moves the same
values), on a land-masked mesh, and with the science tails (wind, drag,
PCR vertical mixing with PP81 coefficients); the shard preps; bad counts
and configurations refused."""

import numpy as np
import pytest
import torch

from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.parallel import patch_shard as jps

from omega_tpu_torch.core import (ModelConfig, ModelState, TendencyConfig,
                                  VertMixConfig)
from omega_tpu_torch.mesh import patch_icos_mesh, spherical_icos_mesh
from omega_tpu_torch.mesh.icos_mega import ensure_mega
from omega_tpu_torch.mesh.icos_patches import apply_land_mask
from omega_tpu_torch.ops import patch_megastep as pm
from omega_tpu_torch.parallel import patch_shard as ps
from omega_tpu_torch.stepping import run_steps

N_SUB, K, L, DT = 8, 3, 2, 300.0
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def host():
    return patch_icos_mesh(spherical_icos_mesh(N_SUB, bottom_depth=1000.0),
                           N_SUB)


@pytest.fixture(scope="module")
def mesh(host):
    return host.to("cpu", torch.float64)


def _state(mesh, L=L):
    lat, lon = mesh.lat_cell.numpy(), mesh.lon_cell.numpy()
    ssh = 2.0 * np.sin(2 * lat) * np.cos(lon)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    rng = np.random.default_rng(5)
    return ModelState(
        t((1000.0 + ssh[:, None]) / K * np.ones((1, K))),
        t(0.01 * rng.standard_normal((mesh.nedges, K))),
        t(10.0 + np.cos(lat)[None, :, None] * np.ones((L, 1, K))))


def _cfg(**kw):
    tend = dict(visc_del2=1e3, visc_del4=1e7)
    tend.update(kw.pop("tendencies", {}))
    return ModelConfig(nvertlayers=K, ntracers=kw.pop("ntracers", L),
                       tendencies=TendencyConfig(**tend), **kw)


def _jax_pos(lp, T, Pp, S, SS, FR):
    """A port frame position (t, r, y, x on S x S patch frames) as the JAX
    package's (its frames are SS = S + 2 FR wide, the S x S window at
    offset FR)."""
    q, rem = np.divmod(np.asarray(lp, np.int64), S * S)
    y, x = np.divmod(rem, S)
    return (q * SS + y + FR) * SS + x + FR


def test_plan_bit_equal_to_jax(host):
    """Per group: the local refills, the rings by shard distance (sender
    and receiver lists), the fix scatter and the hole positions; the
    submesh's per-shard sources and owners — the JAX plan's arrays. The
    JAX frames are SS = S + 2 FR wide (a lane-aligned margin the port does
    not keep), so each port position is mapped into them: every real entry
    and every padding slot equal; the holes the same but for the JAX
    frames' extra margin."""
    from omega_tpu.ops import patch_megastep as jpm
    jmesh = jpatch(jsphere(N_SUB, bottom_depth=1000.0), N_SUB)
    for N in ps.NSHARDS:
        jp = jps.build_patch_shard(jmesh, N, np.float64)
        pp = ps.build_patch_shard(host, N, torch.float64)
        S, SS, FR = jp.p.S, jp.p.SS, jpm.FR
        assert (jp.N, jp.P, S) == (pp.N, pp.P, pp.p.S)
        for grp, T in (("cell", 1), ("edge", 3)):
            jg, pg = jp.groups[grp], pp.groups[grp]
            joob, poob = jg["size_l"], pg["size_l"]
            assert (joob, poob) == (T * jp.P * SS * SS, T * pp.P * S * S)
            J = lambda a: np.asarray(a).astype(np.int64)

            def same_pos(jpos, ppos, what):
                ok = ppos != poob
                assert np.array_equal(J(jpos) == joob, ~ok), what
                assert np.array_equal(
                    J(jpos)[ok], _jax_pos(ppos[ok], T, jp.P, S, SS, FR)), \
                    what
                return ok
            ok = same_pos(jg["refill_pos"], pg["refill_pos"], (N, grp))
            assert np.array_equal(J(jg["refill_src"])[ok], _jax_pos(
                pg["refill_src"][ok], T, jp.P, S, SS, FR))
            okf = same_pos(jg["fix_pos"], pg["fix_pos"], (N, grp, "fix"))
            assert np.array_equal(J(jg["fix_row"])[okf], pg["fix_row"][okf])
            assert [r[0] for r in jg["rings"]] == [r[0] for r in pg["rings"]]
            for (dd, s1, r1), (_, s2, r2) in zip(jg["rings"], pg["rings"]):
                okr = same_pos(r1, r2, (N, grp, dd))
                for d in range(N):          # d sends to d + dd
                    n = okr[(d + dd) % N].sum()
                    assert np.array_equal(J(s1)[d, :n], _jax_pos(
                        s2[d, :n], T, jp.P, S, SS, FR))
            for d in range(N):
                z = pg["zero_pos"][d]
                jz = J(jg["zero_pos"])[d]
                jz = jz[jz != joob]
                q, rem = np.divmod(jz, SS * SS)
                y, x = np.divmod(rem, SS)
                inside = ((y >= FR) & (y < FR + S) & (x >= FR)
                          & (x < FR + S))
                assert np.array_equal(
                    jz[inside], _jax_pos(z[z != poob], T, jp.P, S, SS, FR))
        for nm in ("sub_cell", "sub_edge"):
            T = 1 if nm == "sub_cell" else 3
            own = getattr(pp, f"{nm}_own")
            assert np.array_equal(np.asarray(getattr(jp, f"{nm}_own")), own)
            # 0: a fix row's source (clamped; the carried fix row is read)
            js, src = (np.asarray(getattr(jp, f"{nm}_src_l")).astype(np.int64),
                       getattr(pp, f"{nm}_src_l"))
            real = own & (src != 0)
            assert np.array_equal(js[real],
                                  _jax_pos(src[real], T, jp.P, S, SS, FR))
            assert not js[own & (src == 0)].any()


def test_shard_prep_is_the_global_slice(mesh):
    """A shard's compact table is the global one's columns with offsets
    re-based to its P_l, and no offset of a used slot leaves its patch's
    frame (what makes a shard's kernel the single-device kernel's cut)."""
    p = pm.prep(mesh, torch.float64, "cpu")
    mg = ensure_mega(mesh)
    S = mg.S
    offs = p.offs.numpy().astype(np.int64)
    pos = np.arange(p.P)
    y, x = np.divmod(pos % (S * S), S)
    ts = np.floor((offs + p.P // 2) / p.P).astype(np.int64)
    d = offs - ts * p.P
    db = np.round(d / S).astype(np.int64)
    da = d - db * S
    assert ((y + db >= 0) & (y + db < S) & (x + da >= 0)
            & (x + da < S)).all()
    for N in (2, 5):
        Pl = (10 // N) * S * S
        for s in range(N):
            q = ps.shard_prep(p, N, s, "cpu")
            assert q.P == Pl and q.npatch == 10 // N
            o = q.offs.numpy().astype(np.int64)
            cols = slice(s * Pl, (s + 1) * Pl)
            assert np.array_equal(o - ts[:, cols] * Pl, d[:, cols])
            assert torch.equal(q.wts, p.wts[:, cols])
            assert torch.equal(q.cpl, p.cpl[:, cols])
            assert ps.shard_prep(p, N, s, "cpu") is q


@pytest.fixture(scope="module")
def flagship(mesh):
    """(cfg, state, 2 framed steps on one device), made once."""
    cfg = _cfg()
    st = _state(mesh)
    return cfg, st, run_steps(mesh, cfg, st, 0.0, DT, 2)


@pytest.mark.parametrize("nshards", [2, 5, 10])
def test_sharded_matches_framed(mesh, flagship, nshards):
    cfg, st, ref = flagship
    run = ps.make_patch_sharded_run(mesh, cfg, nshards, [CPU] * nshards)
    out = run(st, 0.0, DT, 2)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-13)
        assert torch.equal(a, b)


def test_sharded_land_masked(host):
    """A land-masked mesh (its own PatchInfo) runs sharded as it runs on
    one device; u stays 0 on masked edges (tests/test_patch_shard.py:63)."""
    land = np.asarray(host.lat_cell) > np.deg2rad(55.0)
    mesh = apply_land_mask(host, land).to("cpu", torch.float64)
    cfg = _cfg()
    st = _state(mesh)
    st = st._replace(u=st.u * mesh.edge_mask[:, None])
    ref = run_steps(mesh, cfg, st, 0.0, DT, 2)
    out = ps.make_patch_sharded_run(mesh, cfg, 5, [CPU] * 5)(st, 0.0, DT, 2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert not out.u[mesh.edge_mask == 0].any()


@pytest.mark.parametrize("nshards", [2, 10])
def test_sharded_science_tails(mesh, nshards):
    """Wind (the const planes' wind rows cut per shard, the submesh's
    stress replicated), bottom drag and PCR vertical mixing with PP81
    coefficients (the coefficient and solve kernels' plain versions per
    shard) against the single-device framed path at 1e-12."""
    cfg = _cfg(vert_mix=VertMixConfig(enabled=True, scheme="pp81",
                                      temp_index=0, salt_index=1),
               tendencies=dict(wind_forcing=True, bottom_drag=True,
                               bottom_drag_coeff=3.0e-3))
    assert ps.supported(mesh, cfg, nshards)
    st = _state(mesh)
    lat = mesh.lat_cell
    wind = (0.1 * torch.cos(lat), 0.05 * torch.ones_like(lat))
    ref = run_steps(mesh, cfg, st, 0.0, DT, 2, wind_stress=wind)
    out = ps.make_patch_sharded_run(mesh, cfg, nshards, [CPU] * nshards)(
        st, 0.0, DT, 2, wind_stress=wind)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12)


def test_bad_counts_and_configurations(host, mesh):
    with pytest.raises(ValueError, match="nshards in"):
        ps.build_patch_shard(host, 4, torch.float64)
    with pytest.raises(ValueError, match="nshards in"):
        ps.make_patch_sharded_run(mesh, _cfg(), 3, [CPU] * 3)
    with pytest.raises(ValueError, match="fused configurations"):
        ps.make_patch_sharded_run(mesh, _cfg(flux_tracer_type="fct"), 2,
                                  [CPU] * 2)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        ps.make_patch_sharded_run(mesh, _cfg(), 2, [CPU] * 3)
