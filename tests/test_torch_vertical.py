"""The port's equation of state (omega_tpu_torch.core.eos) and vertical
coordinate (omega_tpu_torch.core.vert_coord) against the JAX package's, in
float64 at 1e-12, on the same numpy inputs; with the oracles of
tests/test_vertical.py (the TEOS-10 check value, the per-column scans,
conservation of the p-star phase)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import jax.numpy as jnp

from omega_tpu.core import eos as j_eos
from omega_tpu.core import vert_coord as j_vc
from omega_tpu.core.state import ModelState as JState
from omega_tpu.infra.config import Config as JConfig
from omega_tpu_torch.core import eos as p_eos
from omega_tpu_torch.core import vert_coord as p_vc
from omega_tpu_torch.core.state import ModelState as PState
from omega_tpu_torch.infra.config import Config as PConfig

import torch_port_helpers as H

RTOL = 1e-12


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _ts(shape, seed):
    rng = np.random.default_rng(seed)
    ct = 10 + 5 * rng.standard_normal(shape)
    sa = 35 + 0.5 * rng.standard_normal(shape)
    p = np.cumsum(np.full(shape, 2e5), axis=-1) * rng.uniform(0.5, 1.5,
                                                              shape)
    return ct, sa, p


# ---------------------------------------------------------------- EOS

def test_teos10_check_value():
    """Roquet et al. (2015): specvol(SA=30, CT=10, p=1000 dbar) =
    9.732819628e-04 m3/kg (the polynomial's pressure unit is 1e4 dbar)."""
    v = p_eos.teos10_specvol(t(10.0), t(30.0), t(1000.0e4)).item()
    assert abs(v - 9.732819628e-04) < 1e-12
    vj = float(j_eos.teos10_specvol(jnp.array(10.0), jnp.array(30.0),
                                    jnp.array(1000.0e4)))
    assert v == pytest.approx(vj, rel=RTOL)
    v0 = p_eos.teos10_specvol(t(0.0), t(35.16504), t(0.0)).item()
    assert abs(1.0 / v0 - 1028.10720) < 1e-3


@pytest.mark.parametrize("kind", ["linear", "teos10"])
def test_spec_vol_against_jax(kind):
    ct, sa, p = _ts((40, 12), 0)
    jc = j_eos.EosConfig(eos_type=kind, drho_dt=-0.25, drho_ds=0.75,
                         rho_t0_s0=1001.0)
    pc = p_eos.EosConfig(eos_type=kind, drho_dt=-0.25, drho_ds=0.75,
                         rho_t0_s0=1001.0)
    close(p_eos.compute_spec_vol(pc, t(ct), t(sa), t(p)),
          j_eos.compute_spec_vol(jc, jnp.asarray(ct), jnp.asarray(sa),
                                 jnp.asarray(p)))
    for disp in (-2, 1, 3):
        close(p_eos.compute_spec_vol_displaced(pc, t(ct), t(sa), t(p),
                                               disp),
              j_eos.compute_spec_vol_displaced(jc, jnp.asarray(ct),
                                               jnp.asarray(sa),
                                               jnp.asarray(p), disp))
    close(p_eos.teos10_specvol_anomaly(t(ct), t(sa), t(p)),
          j_eos.teos10_specvol_anomaly(jnp.asarray(ct), jnp.asarray(sa),
                                       jnp.asarray(p)))
    close(p_eos.teos10_ref_profile(t(p)),
          j_eos.teos10_ref_profile(jnp.asarray(p)))
    with pytest.raises(ValueError):
        p_eos.compute_spec_vol(p_eos.EosConfig(eos_type="junk"), t(ct),
                               t(sa), t(p))


def test_linear_eos_value_and_config():
    c = p_eos.EosConfig(eos_type="linear")
    v = p_eos.compute_spec_vol(c, t(10.0), t(35.0), 0.0).item()
    assert abs(1.0 / v - (1000.0 - 2.0 + 28.0)) < 1e-12
    doc = {"Eos": {"EosType": "TEOS10", "Linear": {"DRhoDT": -0.3}}}
    for d in ({}, doc, {"Eos": {"EosType": "linear"}}):
        got = p_eos.EosConfig.from_yaml(PConfig("Omega", dict(d)))
        want = j_eos.EosConfig.from_yaml(JConfig("Omega", dict(d)))
        assert (got.eos_type, got.drho_dt, got.drho_ds, got.rho_t0_s0) == \
            (want.eos_type, want.drho_dt, want.drho_ds, want.rho_t0_s0)


# ---------------------------------------------------------- VertCoord

def test_pressure_zheight_geopotential_against_jax():
    C, K = 30, 8
    rng = np.random.default_rng(1)
    h = 50.0 + 10.0 * rng.random((C, K))
    psfc = 1e4 * rng.random(C)
    sv = (1.0 / 1026.0) * (1 + 0.01 * rng.standard_normal((C, K)))
    bot = 400.0 + 100.0 * rng.random(C)
    mask = (rng.random((C, K)) < 0.8).astype(np.float64)
    for m in (None, mask):
        mj = None if m is None else jnp.asarray(m)
        mp = None if m is None else t(m)
        for a, b in zip(p_vc.compute_pressure(t(h), t(psfc), 1026.0, mp),
                        j_vc.compute_pressure(jnp.asarray(h),
                                              jnp.asarray(psfc), 1026.0,
                                              mj)):
            close(a, b)
        zp = p_vc.compute_z_height(t(h), t(sv), t(bot), 1026.0, mp)
        zj = j_vc.compute_z_height(jnp.asarray(h), jnp.asarray(sv),
                                   jnp.asarray(bot), 1026.0, mj)
        for a, b in zip(zp, zj):
            close(a, b)
    # the per-column oracle of tests/test_vertical.py
    p_int, p_mid = p_vc.compute_pressure(t(h), t(psfc), 1026.0)
    g = p_vc.GRAVITY
    acc = psfc[3]
    for k in range(K):
        inc = g * 1026.0 * h[3, k]
        assert abs(p_mid[3, k].item() - (acc + 0.5 * inc)) < 1e-6
        acc += inc
        assert abs(p_int[3, k + 1].item() - acc) < 1e-6
    z_mid = zp[1]
    tide, sal = rng.random(C), rng.random(C)
    close(p_vc.compute_geopotential(z_mid, t(tide), t(sal)),
          j_vc.compute_geopotential(jnp.asarray(z_mid.numpy()),
                                    jnp.asarray(tide), jnp.asarray(sal)))
    close(p_vc.compute_geopotential(z_mid), g * z_mid.numpy())


@pytest.fixture(scope="module")
def meshes():
    jm = H.jax_mesh(16, 8, dc=1000.0, f0=0.0, bottom_depth=100.0)
    return jm, H.port_mesh(jm)


def test_layer_bounds_against_jax(meshes):
    jm, pm = meshes
    K = 5
    rng = np.random.default_rng(2)
    min_c = rng.integers(0, 2, jm.ncells).astype(np.int32)
    max_c = rng.integers(1, K, jm.ncells).astype(np.int32)
    max_c[[3, 9]] = -1                                   # dead columns
    bj = j_vc.layer_bounds(jm, jnp.asarray(min_c), jnp.asarray(max_c), K)
    bp = p_vc.layer_bounds(pm, torch.as_tensor(min_c),
                           torch.as_tensor(max_c), K)
    for name, a, b in zip(bp._fields, bp, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    np.testing.assert_array_equal(bp.cell_mask(K).numpy(),
                                  np.asarray(bj.cell_mask(K)))
    fj = j_vc.full_depth_bounds(jm, K)
    fp = p_vc.full_depth_bounds(pm, K)
    for a, b in zip(fp, fj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("weights", ["uniform", "fixed"])
def test_target_thickness_against_jax(weights):
    C, K = 20, 6
    rng = np.random.default_rng(3)
    ref = 100.0 * (1 + 0.1 * rng.random((C, K)))
    h = ref * (1 + 0.05 * rng.standard_normal((C, K)))
    mask = np.ones((C, K))
    mask[2, 4:] = 0.0
    w = p_vc.movement_weights(p_vc.VertCoordConfig(K, weights))
    np.testing.assert_array_equal(
        w, j_vc.movement_weights(j_vc.VertCoordConfig(K, weights)))
    pj, _ = j_vc.compute_pressure(jnp.asarray(h), jnp.zeros(C), 1026.0)
    pp, _ = p_vc.compute_pressure(t(h), torch.zeros(C, dtype=torch.float64),
                                  1026.0)
    got = p_vc.compute_target_thickness(pp, t(ref), t(w), t(mask), 1026.0)
    want = j_vc.compute_target_thickness(pj, jnp.asarray(ref),
                                         jnp.asarray(w), jnp.asarray(mask),
                                         1026.0)
    close(got, want)
    with pytest.raises(ValueError):
        p_vc.movement_weights(p_vc.VertCoordConfig(K, "junk"))


def test_vert_coord_config_from_yaml():
    for d in ({}, {"VertCoord": {"MovementWeightType": "Fixed"}}):
        got = p_vc.VertCoordConfig.from_yaml(PConfig("Omega", dict(d)), 7)
        want = j_vc.VertCoordConfig.from_yaml(JConfig("Omega", dict(d)), 7)
        assert (got.nvertlayers, got.movement_weight_type, got.rho0) == \
            (want.nvertlayers, want.movement_weight_type, want.rho0)


def test_remap_analytic_and_against_jax():
    out = p_vc.remap_piecewise_constant(t([[2.0, 1.0, 1.0]]),
                                        t([[1.0, 1.0, 2.0]]),
                                        t([[1.0, 2.0, 3.0]]))
    np.testing.assert_allclose(out.numpy(), [[1.0, 1.0, 2.5]], atol=1e-14)
    rng = np.random.default_rng(7)
    C, K = 40, 8
    h_old = rng.uniform(0.5, 2.0, (C, K))
    h_old[5, 2] = 0.0                  # a vanished layer: a zero-width step
    q = rng.standard_normal((3, C, K))
    w = rng.uniform(0.5, 2.0, (C, K))
    w[7, 1] = 0.0                      # a vanishing target layer
    h_new = w / w.sum(1, keepdims=True) * h_old.sum(1, keepdims=True)
    got = p_vc.remap_piecewise_constant(t(h_old), t(h_new), t(q))
    for l in range(3):
        want = j_vc.remap_piecewise_constant(jnp.asarray(h_old),
                                             jnp.asarray(h_new),
                                             jnp.asarray(q[l]))
        close(got[l], want, atol=1e-13)
    np.testing.assert_allclose((got * t(h_new)).sum(-1).numpy(),
                               (q * h_old).sum(-1), rtol=1e-12)
    close(p_vc.remap_piecewise_constant(t(h_old), t(h_old), t(q[0])), q[0],
          atol=1e-13)


def test_pstar_phase_against_jax(meshes):
    jm, pm = meshes
    K, C, E = 5, jm.ncells, jm.nedges
    rng = np.random.default_rng(3)
    ref = np.full((C, K), 100.0 / K) * (1 + 0.05 * rng.random((C, K)))
    amask = np.ones((C, K))
    amask[4, 3:] = 0.0
    tr = rng.standard_normal((2, C, K)) + 10.0
    u = 0.1 * rng.standard_normal((E, K))
    h = ref * (1.0 + rng.standard_normal(C)[:, None] / 100.0)
    for weights in ("uniform", "fixed"):
        w = p_vc.movement_weights(p_vc.VertCoordConfig(K, weights))
        for m in (None, amask):
            jph = j_vc.make_pstar_phase(
                jm, ref, w, None if m is None else jnp.asarray(m))
            pph = p_vc.make_pstar_phase(pm, t(ref), w,
                                        None if m is None else t(m))
            want = jph(JState(h=jnp.asarray(h), u=jnp.asarray(u),
                              tracers=jnp.asarray(tr)))
            got = pph(PState(h=t(h), u=t(u), tracers=t(tr)))
            for a, b in zip(got, want):
                close(a, b, atol=1e-12)
            if m is None:
                np.testing.assert_allclose(got.h.sum(1).numpy(), h.sum(1),
                                           rtol=1e-13)
                np.testing.assert_allclose(
                    (got.tracers * got.h[None]).sum(-1).numpy(),
                    (tr * h[None]).sum(-1), rtol=1e-12)
    # the reference profile is a fixed point
    pph = p_vc.make_pstar_phase(pm, t(ref), np.ones(K))
    out = pph(PState(h=t(ref), u=t(u), tracers=t(tr)))
    close(out.h, ref, atol=1e-10)
    close(out.tracers, tr, atol=1e-10)
