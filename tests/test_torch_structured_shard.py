"""The port's structure-preserving decomposition of planar hex meshes
(parallel/structured_shard.py) against the JAX package's, float64 on the
CPU, every shard on the CPU: the layout, the element maps, the per-shard
windows of states and of beta-plane / variable-depth overrides bit for bit;
the sharded FB step against the unsharded run (bit for bit on owned rows;
tests/test_structured_shard.py holds 1e-12) for row bands and 2-D blocks,
f- and beta-plane; RK2 (tests/test_structured_shard.py:86's 1e-8);
exchange_every = 2; the refused layouts. The local mesh of 256 x 256 on 4
shards is 256 x 72 rows, not a multiple of the FB kernel's 16-row tile:
the kernel (csrc/fb_step.cuh, built by g++ against the block-level shim of
tests/test_torch_rk_shim.py) is held against its plain version on a local
mesh with a ragged last row of tiles, as the sharded step launches it."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_call

import jax.numpy as jnp

from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.mesh import planar_hex_mesh as jplanar
from omega_tpu.parallel import structured_shard as jss
from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import run_steps as jrun

from omega_tpu_torch import convert
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.ops import megastep, structured
from omega_tpu_torch.parallel import structured_shard as sshard
from omega_tpu_torch.stepping import forward_backward_step, rk2_step, \
    run_steps

from test_torch_fb_shim import _call, lib  # noqa: F401  (g++ kernel)

K, L, DT = 3, 2, 60.0
CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def _cfg(d2=1e2, d4=1e8):
    return JModelConfig(nvertlayers=K, ntracers=L,
                        tendencies=JTendencyConfig(visc_del2=d2,
                                                   visc_del4=d4))


def _pcfg(d2=1e2, d4=1e8):
    return convert.config_from_dict(dataclasses.asdict(_cfg(d2, d4)))


def _state_np(mesh, both=True):
    kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
    x, y = np.asarray(mesh.x_cell), np.asarray(mesh.y_cell)
    ssh = np.sin(kx * x) * (np.sin(ky * y) if both else 1.0)
    h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
    rng = np.random.default_rng(2)
    return (h, 0.01 * rng.standard_normal((mesh.nedges, K)),
            10.0 + rng.standard_normal((L, mesh.ncells, K)))


def _port(h, u, tr):
    return convert.state_from_numpy(h, u, tr, device="cpu",
                                    dtype=torch.float64)


def _run(ss, cfg, st, stepper, nsteps, dt=DT, **kw):
    step = sshard.make_sharded_step(ss, cfg, stepper, cpus(ss.nshards), **kw)
    sts = sshard.shard_state(ss, st, step.devices)
    t = 0.0
    every = kw.get("exchange_every", 1)
    for _ in range(nsteps // every):
        sts = step(sts, t, dt)
        t += every * dt
    return sshard.gather_state(ss, sts)


@pytest.mark.parametrize("nx,ny,S,layout,beta", [
    (16, 32, 2, None, 0.0), (16, 32, 4, None, 0.0), (16, 32, 8, None, 0.0),
    (32, 16, 8, (2, 4), 0.0), (32, 16, 8, (4, 2), 1e-11),
    (32, 16, 8, None, 1e-11)])
def test_layout_maps_and_windows_bit_equal(nx, ny, S, layout, beta):
    jm = jplanar(nx, ny, dc=5000.0, f0=1e-4, beta=beta, bottom_depth=1000.0)
    pm = planar_hex_mesh(nx, ny, dc=5000.0, f0=1e-4, beta=beta,
                         bottom_depth=1000.0)
    a = jss.decompose_structured(jm, S, layout=layout)
    b = sshard.decompose_structured(pm, S, layout=layout)
    for f in ("nshards", "sy", "sx", "nx", "ny", "band", "band_x", "hw",
              "hwx", "nyl", "nxl"):
        assert getattr(a, f) == getattr(b, f), f
    assert structured.enabled(b.local_mesh)
    assert b.local_mesh.structured_ny == b.nyl
    assert b.local_mesh.structured_scalars == a.local_mesh.structured_scalars
    assert [n for n, _ in a.mesh_overrides] == \
        [n for n, _ in b.mesh_overrides]
    for (_, x), (_, y) in zip(a.mesh_overrides, b.mesh_overrides):
        assert np.array_equal(np.asarray(x), y)
    for cls in ("cell", "edge", "vertex"):
        for x, y in zip(jss.element_maps(a, cls), sshard.element_maps(b, cls)):
            assert np.array_equal(x, y), cls
    h, u, tr = _state_np(jm)
    js = jss.shard_state(a, JModelState(jnp.asarray(h), jnp.asarray(u),
                                        jnp.asarray(tr)))
    st = _port(h, u, tr)
    sts = sshard.shard_state(b, st, cpus(S))
    for s in range(S):
        for x, y in zip(js, sts[s]):
            assert np.array_equal(np.asarray(x)[s], y.numpy())
    back = sshard.gather_state(b, sts)
    assert all(torch.equal(x, y) for x, y in zip(back, st))
    # the JAX sharded state carried into the port gathers to the same
    carried = convert.sharded_state_from_numpy(
        *(np.array(x) for x in js), cpus(S), torch.float64)
    assert all(torch.equal(x, y) for x, y in
               zip(sshard.gather_state(b, carried), st))


@pytest.fixture(scope="module")
def band_case():
    """tests/test_structured_shard.py's setup (16 x 32, del2 1e2, del4
    1e8), its unsharded 4 steps in the port and in the JAX package."""
    jm = jplanar(16, 32, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    pm = planar_hex_mesh(16, 32, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    jcfg = _cfg()
    cfg = _pcfg()
    h, u, tr = _state_np(jm)
    st = _port(h, u, tr)
    ref = run_steps(pm.to("cpu", torch.float64), cfg, st, 0.0, DT, 4)
    jref = jax_call(("sshard", 16, 32, "fb4"), lambda s: jrun(
        jm, jcfg, s, 0.0, DT, 4, stepper=jfb),
        JModelState(jnp.asarray(h), jnp.asarray(u), jnp.asarray(tr)))
    return pm, cfg, st, ref, jref


@pytest.mark.parametrize("nshards", [2, 4, 8])
def test_fb_invariance(band_case, nshards):
    pm, cfg, st, ref, jref = band_case
    ss = sshard.decompose_structured(pm, nshards)
    out = _run(ss, cfg, st, forward_backward_step, 4)
    for a, b, c in zip(out, ref, jref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("layout,beta", [((2, 4), 0.0), ((4, 2), 1e-11),
                                         (None, 1e-11)])
def test_2d_blocks_and_beta_plane(layout, beta):
    """2-D blocks (corner fill through the two-stage exchange) and the
    beta plane's per-shard f windows (tests/test_parallel.py:116): owned
    rows equal the single-device run's."""
    pm = planar_hex_mesh(32, 16, dc=5000.0, f0=1e-4, beta=beta,
                         bottom_depth=1000.0)
    cfg = _pcfg(1e3, 1e9)
    st = _port(*_state_np(pm))
    ref = run_steps(pm.to("cpu", torch.float64), cfg, st, 0.0, DT, 3)
    ss = sshard.decompose_structured(pm, 8, layout=layout)
    if beta:
        assert {"f_cell", "f_edge", "f_vertex"} <= \
            {a for a, _ in ss.mesh_overrides}
    out = _run(ss, cfg, st, forward_backward_step, 3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_rk2_close(band_case):
    """RK2 evaluates two tendencies between exchanges: within the JAX
    suite's 1e-8 (tests/test_structured_shard.py:86)."""
    pm, cfg, st, _, _ = band_case
    ref = run_steps(pm.to("cpu", torch.float64), cfg, st, 0.0, DT, 3,
                    stepper=rk2_step)
    out = _run(sshard.decompose_structured(pm, 4), cfg, st, rk2_step, 3)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)


def test_exchange_every_amortized_halos():
    """exchange_every = 2 with hw = 8: two steps a call, one exchange, the
    owned rows still the single-device run's at 1e-12
    (tests/test_structured_shard.py:121)."""
    pm = planar_hex_mesh(16, 64, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    cfg = _pcfg(1e3, 1e9)
    h, u, tr = _state_np(pm, both=False)
    st = _port(h, np.zeros_like(u), tr)
    ref = run_steps(pm.to("cpu", torch.float64), cfg, st, 0.0, DT, 4)
    out = _run(sshard.decompose_structured(pm, 4, hw=8), cfg, st,
               forward_backward_step, 4, exchange_every=2)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12)


def test_errors():
    pm = planar_hex_mesh(16, 16, dc=5000.0)
    with pytest.raises(ValueError, match="no valid"):
        sshard.decompose_structured(pm, 5)
    with pytest.raises(ValueError, match="layout"):
        sshard.decompose_structured(pm, 4, layout=(2, 3))
    with pytest.raises(ValueError, match="rows"):
        sshard.decompose_structured(pm, 4, layout=(4, 1), hw=6)
    from omega_tpu_torch.mesh import spherical_icos_mesh
    with pytest.raises(ValueError, match="not structured"):
        sshard.decompose_structured(spherical_icos_mesh(4), 2)
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        sshard.make_sharded_step(sshard.decompose_structured(pm, 2),
                                 _pcfg(),
                                 forward_backward_step, cpus(3))


def test_ragged_local_mesh_runs_the_fused_kernel(lib):  # noqa: F811
    """A shard's local mesh whose row count is not a multiple of the FB
    kernel's 16-row tile (32 x 32 on 2 row bands: 16 owned + 8 halo rows =
    24, a full tile and half of one) is one the fused path takes, and one
    launch of the kernel equals its plain version on it at 1e-12 a
    channel."""
    pm = planar_hex_mesh(32, 32, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    ss = sshard.decompose_structured(pm, 2)
    local = ss.local_mesh
    assert local.structured_ny == 24 and 24 % megastep.HEX_TILE[0] != 0
    mesh = local.to("cpu", torch.float64)
    cfg = _pcfg(1e3, 1e9)
    assert megastep.supported(mesh, cfg)
    st = sshard.shard_state(ss, _port(*_state_np(pm)), cpus(2))[1]
    s = megastep.stack_state(mesh, st)
    ref = megastep.fb_megastep_plain(mesh, cfg, s, 30.0)
    out = torch.full_like(s, float("nan"))
    import test_torch_fb_shim as fbs
    old = fbs.DT
    fbs.DT = 30.0
    try:
        assert _call(lib, mesh, cfg, s, out, None) == 0
    finally:
        fbs.DT = old
    assert bool(torch.isfinite(out).all())
    for c in range(ref.shape[0]):
        err = (out[c] - ref[c]).abs().max() / ref[c].abs().max()
        assert err <= 1e-12, (c, err)
