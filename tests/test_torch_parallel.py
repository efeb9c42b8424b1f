"""The port's distributed layer (omega_tpu_torch/parallel/) against the JAX
package's, float64 on the CPU, every shard on the CPU (the JAX side on the
8 virtual devices of tests/conftest.py):

- partition_cells, decompose and build_permute_lists bit for bit the JAX
  package's, on the native route (the port's own copy of the partitioner,
  built by g++) and on the numpy route (the JAX side with its library
  turned away); hilbert keys, halo rings and the boundary refinement;
- the halo exchange's global-ID oracle (tests/test_parallel.py:35), both
  forms, at halo widths 1-4, and on a rank-4 array;
- decomposition invariance of the sharded FB / RK2 / RK4 / split steps
  against the unsharded run (FB bit for bit; RK4 at the JAX suite's
  1e-13; RK2 and split at 1e-12, see the test);
- the FB step's compute/comm overlap bit-identical to the trailing
  exchange, and taken;
- the cross-shard reductions bit for bit across shard counts and the JAX
  package's sum, and the sharded energetics equal the gathered ones;
- the host-major device ordering and the link volumes of
  tests/test_parallel.py:165."""


import numpy as np
import pytest
import torch

from torch_port_helpers import port_cfg

import jax.numpy as jnp

from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.mesh import planar_hex_mesh as jplanar
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.parallel import decomp as jdecomp
from omega_tpu.parallel import native as jnative
from omega_tpu.parallel import reductions as jred
from omega_tpu.parallel import sharded as jsharded

from omega_tpu_torch import analysis
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh import planar_hex_mesh, spherical_icos_mesh
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS
from omega_tpu_torch.parallel import decomp, native, reductions, sharded
from omega_tpu_torch.stepping import (forward_backward_step, make_stepper,
                                      rk2_step, rk4_step, run_steps)
from omega_tpu_torch.stepping import steppers as steppers_mod

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def plane():
    """(JAX mesh, port host mesh) 16 x 16, dc 1000."""
    return jplanar(16, 16, dc=1000.0), planar_hex_mesh(16, 16, dc=1000.0)


@pytest.fixture(scope="module")
def sphere():
    return jsphere(8), spherical_icos_mesh(8)


_LISTS = ("owned_cell_mask", "owned_edge_mask", "owned_vertex_mask",
          "cell_send_idx", "cell_recv_src_shard", "cell_recv_src_slot",
          "cell_recv_dst", "edge_send_idx", "edge_recv_src_shard",
          "edge_recv_src_slot", "edge_recv_dst", "vertex_send_idx",
          "vertex_recv_src_shard", "vertex_recv_src_slot",
          "vertex_recv_dst", "cell_local_to_global",
          "edge_local_to_global", "vertex_local_to_global")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("case", ["plane2", "plane3", "plane8", "sphere4"])
def test_decompose_bit_equal(plane, sphere, route, case, monkeypatch):
    jm, pm = plane if case.startswith("plane") else sphere
    S = int(case[-1])
    if route == "numpy":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.available() and jnative.available()
    _same(jdecomp.partition_cells(jm, S),
          decomp.partition_cells(pm, S), "owner")
    assert native.ROUTE["partition_geom"] == route
    a = jdecomp.decompose(jm, S)
    b = decomp.decompose(pm, S)
    assert native.ROUTE["halo_layers"] == route
    for f in _LISTS:
        _same(getattr(a, f), getattr(b, f), f)
    for f in ARRAY_FIELDS:
        _same(getattr(a.mesh, f),
              np.stack([np.asarray(getattr(m, f)) for m in b.meshes]), f)
    for kind in ("cell", "edge", "vertex"):
        ja, pb = (jsharded.build_permute_lists(a, kind),
                  sharded.build_permute_lists(b, kind))
        assert [x[0] for x in ja] == [x[0] for x in pb]
        for (_, s1, r1), (_, s2, r2) in zip(ja, pb):
            _same(s1, s2, kind)
            _same(r1, r2, kind)
    host_of = np.arange(S) // max(1, S // 2)
    assert jsharded.comm_volume_by_link(a, host_of) == \
        sharded.comm_volume_by_link(b, host_of)


def test_other_partitions_and_native_twins(plane, sphere, monkeypatch):
    jm, pm = plane
    for method in ("sfc", "stripe"):
        _same(jdecomp.partition_cells(jm, 4, method),
              decomp.partition_cells(pm, 4, method), method)
    with pytest.raises(ValueError, match="unknown partition"):
        decomp.partition_cells(pm, 4, "metis")
    js, ps = sphere
    x, y = decomp._norm_coords(ps)
    for bits in (8, 16):
        k = native.hilbert_keys(x, y, bits)
        _same(jnative.hilbert_keys(x, y, bits), k, "keys")
        _same(native._hilbert_py(x, y, bits), k, "numpy")
    from omega_tpu_torch.mesh.horz_mesh import unclamped_connectivity
    coc = unclamped_connectivity(ps)["cells_on_cell"]
    ne = np.asarray(ps.n_edges_on_cell)
    seed = native.partition_geom(x, y, 8)
    nat = native.halo_layers(coc, ne.astype(np.int32), seed, 8, 3)
    py = native._halo_py(coc, ne.astype(np.int32), seed, 8, 3)
    for (o1, r1), (o2, r2) in zip(nat, py):
        _same(o1, o2, "owned")
        rings = decomp._halo_layers(o1, coc, ne, 3)
        for a, b, c in zip(r1, r2, rings):
            _same(np.sort(a), np.sort(b), "ring")
            _same(np.sort(a), c, "bfs ring")
    refined, cut = native.refine_partition(coc, ne, seed, 8)
    jref, jcut = jnative.refine_partition(coc, ne, seed, 8)
    _same(jref, refined, "refined")
    assert cut == jcut

    def cut_of(o):
        tot = 0
        for j in range(coc.shape[1]):
            v = coc[:, j] >= 0
            tot += int((o[coc[:, j][v]] != o[np.where(v)[0]]).sum())
        return tot // 2
    assert cut == cut_of(refined) <= cut_of(seed)
    monkeypatch.setattr(native, "_load", lambda: None)
    _same(seed, native.partition_geom(x, y, 8), "numpy seed")
    assert native.refine_partition(coc, ne, seed, 8)[1] is None


def _id_state(mesh, nlayers=2, ntracers=2):
    """The HaloTest oracle: values derived from global ids."""
    k = np.arange(nlayers)[None, :]
    h = np.arange(mesh.ncells)[:, None] * 10.0 + k + 1.0
    u = np.arange(mesh.nedges)[:, None] * 7.0 + k + 1.0
    tr = np.stack([np.arange(mesh.ncells)[:, None] * (3.0 + l) + k + 1.0
                   for l in range(ntracers)])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return ModelState(t(h), t(u), t(tr))


def _corrupt(x, owned):
    m = torch.as_tensor(owned > 0)
    return torch.where(m[..., None], x, torch.full_like(x, -9999.0))


@pytest.mark.parametrize("impl", ["permute", "allgather"])
@pytest.mark.parametrize("nshards,width", [(2, 3), (8, 3), (4, 1), (4, 2),
                                           (4, 4)])
def test_halo_exchange_id_oracle(plane, nshards, width, impl):
    """Zero the halos, exchange, require exact equality with the ID oracle
    on every real local row (tests/test_parallel.py:35, :259)."""
    _, pm = plane
    sm = decomp.decompose(pm, nshards, halo_width=width).to(cpus(nshards))
    assert sm.halo_width == width
    state = _id_state(pm)
    sts = sharded.shard_state(sm, state)
    bad = [ModelState(_corrupt(st.h, sm.owned_cell_mask[s]),
                      _corrupt(st.u, sm.owned_edge_mask[s]),
                      _corrupt(st.tracers, sm.owned_cell_mask[s]))
           for s, st in enumerate(sts)]
    lists = sharded.ShardLists(sm, cpus(nshards), permute=impl == "permute")
    fixed = sharded.make_halo_fn(lists, impl == "permute")(bad)
    for s, st in enumerate(fixed):
        cm = sm.cell_local_to_global[s] >= 0
        em = sm.edge_local_to_global[s] >= 0
        c, e = sm.cell_local_to_global[s][cm], sm.edge_local_to_global[s][em]
        assert torch.equal(st.h[cm], state.h[c])
        assert torch.equal(st.u[em], state.u[e])
        assert torch.equal(st.tracers[:, cm], state.tracers[:, c])


@pytest.mark.parametrize("impl", ["permute", "allgather"])
def test_halo_rank4_and_vertex_space(plane, impl):
    """exchangeFullArrayHalo takes 1-5-D arrays (base/Halo.h:45): a rank-4
    (time level, tracer, cell, K) array refreshes exactly, and so does a
    vertex-space array."""
    _, pm = plane
    sm = decomp.decompose(pm, 4).to(cpus(4))
    lists = sharded.ShardLists(sm, cpus(4), permute=impl == "permute")
    T, L, K = 2, 3, 2
    for space, n, own, l2g in (
            ("cell", pm.ncells, sm.owned_cell_mask, sm.cell_local_to_global),
            ("vertex", pm.nvertices, sm.owned_vertex_mask,
             sm.vertex_local_to_global)):
        ref = torch.as_tensor(np.arange(n)[None, None, :, None] * 10.0
                              + np.arange(T)[:, None, None, None] * 1000.0
                              + np.arange(L)[None, :, None, None] * 100.0
                              + np.arange(K)[None, None, None, :])
        xs = [torch.where(torch.as_tensor(own[s] > 0)[:, None],
                          ref[:, :, np.maximum(l2g[s], 0)], -1.0)
              for s in range(4)]
        got = sharded.exchange_any(lists, xs, space, impl == "permute")
        for s in range(4):
            m = l2g[s] >= 0
            assert torch.equal(got[s][:, :, m], ref[:, :, l2g[s][m]])


def _inertia_gravity(nx=16, column=False):
    """tests/test_model.py's _inertia_gravity_setup, in numpy."""
    mesh = planar_hex_mesh(nx, nx, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    jcfg = JModelConfig(
        nvertlayers=3, ntracers=2,
        ssh_formulation="column" if column else "stacked",
        tendencies=JTendencyConfig(
            visc_del2=0.0, velocity_diffusion=False,
            velocity_hyperdiff=False, tracer_diffusion=True,
            eddy_diff2=10.0, tracer_hyperdiff=False))
    kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
    x, y = np.asarray(mesh.x_cell), np.asarray(mesh.y_cell)
    ssh = np.sin(kx * x) * np.sin(ky * y)
    h = (1000.0 / 3 + ssh[:, None] / 3) * np.ones((1, 3))
    tr_base = 10.0 + np.cos(kx * x)
    tr = np.stack([tr_base[:, None] * np.ones((1, 3)),
                   20.0 * np.ones((mesh.ncells, 3))])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    st = ModelState(t(h), t(np.zeros((mesh.nedges, 3))), t(tr))
    return mesh, port_cfg(jcfg), st


def _run_sharded(mesh, cfg, state, stepper, S, nsteps, dt, **kw):
    sm = decomp.decompose(mesh, S).to(cpus(S))
    step = sharded.make_sharded_step(sm, cfg, stepper, cpus(S), **kw)
    sts = sharded.shard_state(sm, state)
    t = 0.0
    for _ in range(nsteps):
        sts = step(sts, t, dt)
        t += dt
    return sharded.gather_state(sm, sts, mesh.ncells, mesh.nedges)


@pytest.mark.parametrize("name,nsteps,tol", [
    ("fb", 6, 0.0), ("rk2", 4, 1e-12), ("rk4", 4, 1e-13),
    ("split", 3, 1e-12)])
def test_decomposition_invariance(name, nsteps, tol):
    """8 shards against one device on owned values. FB is bit for bit (its
    one exchange is the step's last act). RK4 holds the JAX suite's 1e-13;
    RK2 evaluates two tendencies between exchanges and the split stepper
    exchanges its 2-D fields every subcycle, so the rows at the width-3
    edge round differently: 1e-12 (in units of h ~ 333 m, relative
    3e-15)."""
    column = name == "split"
    mesh, cfg, st = _inertia_gravity(column=column)
    stepper = {"fb": forward_backward_step, "rk2": rk2_step,
               "rk4": rk4_step}.get(name) or make_stepper("SplitExplicit")
    dt = 60.0
    ref = st
    for i in range(nsteps):
        ref = stepper(mesh.to("cpu", torch.float64), cfg, ref, i * dt, dt)
    out = _run_sharded(mesh, cfg, st, stepper, 8, nsteps, dt)
    for a, b, what in zip(out, ref, ("h", "u", "tracers")):
        err = (a - b).abs().max().item()
        assert err <= tol, (what, err)


@pytest.mark.parametrize("stepper", [rk2_step, rk4_step])
def test_rk_del4_leak_is_bounded(stepper):
    """Sharded RK2 / RK4 with del4 evaluate two tendencies between
    exchanges, beyond the width-3 halo: the owned values leak (the
    reference's own TODO). The leak stays under
    1e-10 of max|h| over 5 steps on 4 shards (del2 1e3, del4 1e9, a noisy
    16 x 8 x 3 state), where FB is bit for bit."""
    mesh = planar_hex_mesh(16, 8, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    cfg = port_cfg(JModelConfig(nvertlayers=3, ntracers=2,
                                tendencies=JTendencyConfig(visc_del2=1e3,
                                                           visc_del4=1e9)))
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    st = ModelState(t(1000 / 3 + rng.normal(0, 1, (mesh.ncells, 3))),
                    t(rng.normal(0, 0.1, (mesh.nedges, 3))),
                    t(rng.normal(10, 1, (2, mesh.ncells, 3))))
    dev = mesh.to("cpu", torch.float64)
    for stp, tol in ((forward_backward_step, 0.0), (stepper, 1e-10)):
        ref = run_steps(dev, cfg, st, 0.0, 30.0, 5, stepper=stp)
        out = _run_sharded(mesh, cfg, st, stp, 4, 5, 30.0)
        leak = ((out.h - ref.h).abs().max() / ref.h.abs().max()).item()
        assert leak <= tol, (stp.__name__, leak)


def test_halo_overlap_bit_identical(monkeypatch):
    """The FB step's compute/comm overlap (the cell exchange started before
    the velocity stage, read after it) against the trailing exchange
    (OMEGA_HALO_OVERLAP=0) and the unsharded run: bit for bit, and the
    overlap branch was taken."""
    mesh, cfg, st = _inertia_gravity()
    calls = {"n": 0}
    real = sharded.shard_halos

    def counting(group, lhalo):
        halos = real(group, lhalo)
        for h in halos:
            inner = h.cell_async

            def wrapped(x, inner=inner):
                calls["n"] += 1
                return inner(x)
            h.cell_async = wrapped
        return halos
    monkeypatch.setattr(sharded, "shard_halos", counting)
    monkeypatch.setenv("OMEGA_HALO_OVERLAP", "1")
    on = _run_sharded(mesh, cfg, st, forward_backward_step, 8, 4, 30.0)
    assert calls["n"] == 8 * 4
    monkeypatch.setenv("OMEGA_HALO_OVERLAP", "0")
    off = _run_sharded(mesh, cfg, st, forward_backward_step, 8, 4, 30.0)
    assert calls["n"] == 8 * 4
    assert not steppers_mod._halo_overlap_enabled()
    ref = run_steps(mesh.to("cpu", torch.float64), cfg, st, 0.0, 30.0, 4)
    for a, b, c in zip(on, off, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reductions_across_shard_counts(dtype):
    """global_sum over a list of shards is bit for bit the one-array sum
    and the JAX package's, whatever the shard count and split; min / max
    with masks; the (hi, lo) pairs of other dtypes combine in shard
    order."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(5000) * 10.0 ** rng.integers(-8, 8, 5000)
    x = x.astype(np.float64 if dtype == torch.float64 else np.float32)
    whole = torch.as_tensor(x)
    ref = reductions.global_sum(whole)
    assert ref.item() == float(jred.global_sum(jnp.asarray(x)))
    for S in (2, 3, 5, 8):
        cuts = np.sort(rng.choice(np.arange(1, x.size), S - 1,
                                  replace=False))
        parts = [torch.as_tensor(p) for p in np.split(x, cuts)]
        assert torch.equal(reductions.global_sum(parts), ref), S
        perm = [torch.as_tensor(p) for p in np.split(x[::-1].copy(), cuts)]
        assert torch.equal(reductions.global_sum(perm), ref), S
        mult = [2.0 * torch.ones_like(p) for p in parts]
        masks = [p > 0 for p in parts]
        assert torch.equal(
            reductions.global_sum(parts, multiplier=mult, mask=masks),
            reductions.global_sum(whole, multiplier=2.0 * torch.ones_like(
                whole), mask=whole > 0)), S
        assert reductions.global_min(parts, mask=masks) == \
            whole[whole > 0].min()
        assert reductions.global_max(parts) == whole.max()
    ints = [torch.arange(4), torch.arange(4, 10)]
    assert int(reductions.global_sum(ints)) == 45
    with pytest.raises(ValueError, match="one entry a shard"):
        reductions.global_sum([whole], mask=[whole > 0, whole > 0])


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_energetics_equal_gathered(S):
    """The owned-masked energetics over the shards equal the gathered
    state's: the sums bit for bit (the reductions are order-free), the
    derived enstrophy and min / max exact."""
    mesh, cfg, st = _inertia_gravity()
    dev = mesh.to("cpu", torch.float64)
    st = run_steps(dev, cfg, st, 0.0, 60.0, 2)
    sm = decomp.decompose(mesh, S).to(cpus(S))
    sample = sharded.make_sharded_energetics(sm, cfg, cpus(S))
    row, ssh_ref = sample(sharded.shard_state(sm, st))
    assert ssh_ref == analysis.mean_ssh(dev, cfg, st)
    want = analysis.energetics(dev, cfg, st, ssh_ref)
    assert row == want


def test_dcn_ordering_and_link_volumes(plane):
    """The host-major device order sorts (process, slice, id) and leaves
    the numerics alone (placement cannot change them); the link volumes
    count every exchanged row once, the cross-host rows only at the two
    host seams of the rank ring (tests/test_parallel.py:165)."""
    class Dev:
        def __init__(self, i):
            self.id, self.process_index = i, i // 4
    shuffled = [Dev(i) for i in (3, 7, 1, 5, 0, 4, 2, 6)]
    assert [d.id for d in sharded.dcn_device_mesh(8, shuffled)] == \
        list(range(8))
    with pytest.raises(ValueError, match="need 9 devices"):
        sharded.dcn_device_mesh(9, shuffled)
    mesh, cfg, st = _inertia_gravity()
    sm = decomp.decompose(mesh, 8)
    vol = sharded.comm_volume_by_link(sm, np.arange(8) // 4)
    assert 0 < vol["dcn"] < vol["ici"]
    assert set(vol["per_dcn_pair"]) == {(0, 1)}
    expect = sum(int((recv != getattr(sm, f"{k}_local_to_global")
                      .shape[1] - 1).sum())
                 for k in ("cell", "edge")
                 for _, _, recv in sharded.build_permute_lists(sm, k))
    assert vol["ici"] + vol["dcn"] == expect


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.default_devices(4)
    mesh, cfg, st = _inertia_gravity()
    sm = decomp.decompose(mesh, 2)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        sm.to(cpus(3))
    with pytest.raises(ValueError, match="halo_impl"):
        sharded.make_sharded_step(sm, cfg, forward_backward_step, cpus(2),
                                  halo_impl="mpi")


def test_failing_shard_stops_every_shard():
    """A shard that raises stops the others at their next exchange (no
    shard waits forever) and its error reaches the caller."""
    group = sharded.Lockstep(cpus(4))

    def fn(s):
        if s == 2:
            raise ArithmeticError("shard 2")
        return group.meet(s, s, lambda v: [x * 10 for x in v])
    with pytest.raises(ArithmeticError, match="shard 2"):
        group.run(fn)
    assert group.run(lambda s: group.meet(s, s, lambda v: v[::-1])) == \
        [3, 2, 1, 0]
