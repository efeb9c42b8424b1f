"""The module of the fused forward-backward kernel: its plain version
(whole grid and tiled as the kernel cuts its slabs) against the port's
composed step and against the JAX package's Pallas kernel in interpret
mode; `supported()`; the tile/ring planner.

rtol and atol 1e-10: the JAX suite's own figure for fused against composed
(tests/test_structured.py) — the chain divides by h_v where the composed
step multiplies by its reciprocal, and folds constants differently."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_mesh, jax_state, port_cfg,
                                port_mesh, port_state, random_fields)

from omega_tpu.ops import megastep as jmegastep

from omega_tpu_torch.core import (ModelConfig, ModelState, TendencyConfig,
                                  VertMixConfig)
from omega_tpu_torch.ops import megastep
from omega_tpu_torch.stepping import forward_backward_step

SIZES = {"32x16x3": (32, 16, 3), "24x12x4": (24, 12, 4), "16x8x5": (16, 8, 5)}
L = 2


def _setup(size, seed=0):
    nx, ny, K = SIZES[size]
    jm = jax_mesh(nx, ny)
    pm = port_mesh(jm)
    jcfg = flagship_cfg(K, L, tendencies=dict(eddy_diff4=1e6))
    fields = random_fields(jm, K, L, seed)
    return jm, pm, jcfg, port_cfg(jcfg), fields, K


def _assert_state_close(out, ref, tol=1e-10):
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(out, n).numpy(),
                                   getattr(ref, n).numpy(),
                                   rtol=tol, atol=tol, err_msg=n)


@pytest.mark.parametrize("tile", [None, (8, 8), (7, 5), (32, 32)],
                         ids=["whole", "tile8x8", "ragged7x5", "tile>domain"])
@pytest.mark.parametrize("size", SIZES)
def test_plain_matches_composed_over_3_steps(size, tile):
    _, pm, _, cfg, fields, K = _setup(size)
    assert megastep.supported(pm, cfg)
    ref = port_state(*fields)
    s = megastep.stack_state(pm, ref)
    for _ in range(3):
        ref = forward_backward_step(pm, cfg, ref, 0.0, 30.0)
        s = megastep.fb_megastep_plain(pm, cfg, s, 30.0, tile=tile)
    _assert_state_close(megastep.unstack_state(pm, s, K, L, ModelState), ref)


def test_plain_matches_jax_pallas_kernel_one_step():
    jm, pm, jcfg, cfg, fields, K = _setup("32x16x3")
    assert jmegastep.supported(jm, jcfg)
    jout = jmegastep.fb_megastep(jm, jcfg, jax_state(*fields), 0.0, 30.0,
                                 interpret=True)
    st = port_state(*fields)
    out = megastep.unstack_state(
        pm, megastep.fb_megastep_plain(pm, cfg, megastep.stack_state(pm, st),
                                       30.0, tile=(8, 16)),
        K, L, ModelState)
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(out, n).numpy(),
                                   np.asarray(getattr(jout, n)),
                                   rtol=1e-10, atol=1e-10, err_msg=n)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    _, pm, _, cfg, fields, K = _setup("16x8x5")
    st = port_state(*fields)
    s = megastep.stack_state(pm, st)
    before = megastep.launches
    out = torch.empty_like(s)
    res = megastep.fb_megastep_stacked(pm, cfg, s, 30.0, out=out)
    assert res is out and megastep.launches == before
    torch.testing.assert_close(out, megastep.fb_megastep_plain(pm, cfg, s, 30.0),
                               rtol=0, atol=0)
    _assert_state_close(megastep.fb_megastep(pm, cfg, st, 0.0, 30.0),
                        forward_backward_step(pm, cfg, st, 0.0, 30.0))


def test_stack_unstack_round_trip():
    _, pm, _, _, fields, K = _setup("24x12x4")
    st = port_state(*fields)
    s = megastep.stack_state(pm, st)
    assert tuple(s.shape) == (4 + L, K, 12, 24) and s.is_contiguous()
    back = megastep.unstack_state(pm, s, K, L, ModelState)
    for a, b in zip(back, st):
        assert torch.equal(a, b)


UNSUPPORTED = {
    "upwind_thickness": dict(flux_thickness_type="upwind"),
    "upwind_tracer": dict(flux_tracer_type="upwind"),
    "fct": dict(flux_tracer_type="fct"),
    "column_ssh": dict(ssh_formulation="column"),
    "vmix": dict(vert_mix=VertMixConfig(enabled=True)),
    "wind": dict(tendencies=TendencyConfig(wind_forcing=True)),
    "drag": dict(tendencies=TendencyConfig(bottom_drag=True)),
    "no_pv": dict(tendencies=TendencyConfig(pv_advection=False)),
    "custom": dict(tendencies=TendencyConfig(use_custom_tendency=True)),
}


@pytest.mark.parametrize("what", UNSUPPORTED)
def test_supported_is_false_off_the_flagship(what):
    pm = port_mesh(jax_mesh(16, 8))
    assert megastep.supported(pm, ModelConfig(nvertlayers=3, ntracers=2))
    assert not megastep.supported(
        pm, ModelConfig(nvertlayers=3, ntracers=2, **UNSUPPORTED[what]))


def test_supported_needs_structured_f_plane():
    cfg = ModelConfig(nvertlayers=3, ntracers=2)
    pm = port_mesh(jax_mesh(16, 8))
    assert not megastep.supported(dataclasses.replace(pm, structured_nx=0), cfg)
    assert not megastep.supported(port_mesh(jax_mesh(16, 8, beta=2e-11)), cfg)


# ---- the tile / ring planner ------------------------------------------

def _tabs():
    pm = port_mesh(jax_mesh(16, 8))
    return megastep._mega_args(pm, ModelConfig(nvertlayers=3, ntracers=2),
                               30.0)[0]


def test_chain_radius_is_tight():
    """The derived ring keeps tiles exact; one row or column less does
    not. It never exceeds the 5 rows x 6 columns of summed table radii."""
    _, pm, _, cfg, fields, K = _setup("32x16x3")
    tabs = megastep._mega_args(pm, cfg, 30.0)[0]
    ry, rx = megastep.chain_radius(tabs)
    assert 1 <= ry <= 5 and 1 <= rx <= 6
    s = megastep.stack_state(pm, port_state(*fields))
    whole = megastep.fb_megastep_plain(pm, cfg, s, 30.0)
    exact = megastep.fb_megastep_plain(pm, cfg, s, 30.0, tile=(4, 8))
    assert torch.equal(exact, whole)     # same arithmetic, point for point
    for ring in ((ry - 1, rx), (ry, rx - 1)):
        short = megastep.fb_megastep_plain(pm, cfg, s, 30.0, tile=(4, 8),
                                           ring=ring)
        assert not torch.equal(short, whole), ring


@pytest.mark.parametrize("ny,nx", [(256, 256), (16, 32), (8, 16), (20, 48)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_tile_invariants(ny, nx, itemsize):
    ring = megastep.chain_radius(_tabs())
    plan = megastep.plan_tile(ny, nx, itemsize, ring)
    by, bx = plan["by"], plan["bx"]
    assert 1 <= by <= ny and 1 <= bx <= nx
    assert (plan["ry"], plan["rx"]) == ring
    slab = (by + 2 * ring[0]) * (bx + 2 * ring[1])
    assert plan["guard"] >= 2 * (bx + 2 * ring[1]) + 2
    assert plan["smem"] == (megastep.SLOTS * slab + 2 * plan["guard"]) \
        * itemsize
    assert plan["smem"] <= megastep.SMEM_LIMIT
    assert 32 <= plan["threads"] <= 512 and plan["threads"] % 32 == 0
    # the grid of tiles covers the domain
    assert -(-ny // by) * by >= ny and -(-nx // bx) * bx >= nx


def test_plan_tile_override_and_limits():
    ring = megastep.chain_radius(_tabs())
    assert megastep.plan_tile(256, 256, 4, ring, tile=(16, 64))["bx"] == 64
    assert megastep.plan_tile(256, 256, 4, ring,
                              tile=(16, 64, 384))["threads"] == 384
    with pytest.raises(ValueError):
        megastep.plan_tile(256, 256, 4, ring, tile=(16, 64, 1000))
    with pytest.raises(ValueError):
        megastep.plan_tile(256, 256, 8, ring, tile=(64, 64))
    with pytest.raises(ValueError):
        megastep.plan_tile(256, 256, 4, ring, tile=(0, 8))


@pytest.mark.parametrize("ft", [np.float32, np.float64])
def test_param_record_mirrors_the_kernel_struct(ft):
    pm = port_mesh(jax_mesh(16, 8))
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1e3, visc_del4=1e9))
    tabs, consts = megastep._mega_args(pm, cfg, 30.0)
    plan = megastep.plan_tile(8, 16, np.dtype(ft).itemsize,
                              megastep.chain_radius(tabs))
    rec = megastep.pack_params(tabs, consts, ft, plan)
    size = np.dtype(ft).itemsize
    # int[2][96], T[96], short[10][4], 13 T, 9 int, padded to T's alignment:
    # the C++ struct's layout
    raw = 2 * 96 * 4 + 96 * size + 80 + 13 * size + 36
    assert rec.dtype.itemsize == -(-raw // size) * size
    # the compile-time layout: tables in order, classes in order, fixed counts
    XX = plan["bx"] + 2 * plan["rx"]
    S = (plan["by"] + 2 * plan["ry"]) * XX
    n = 0
    for b, name in enumerate(megastep.TABLE_NAMES):
        for t in range(megastep._PD[name]):
            assert rec["start"][b, t] == n
            want = [e for e in tabs[name] if e[0] == t]
            assert len(want) == megastep._ENTRY_COUNTS[name]
            for i, (_, ts, dj, di_e, di_o, w) in enumerate(want):
                assert rec["off"][0, n + i] == ts * S + dj * XX + di_e
                assert rec["off"][1, n + i] == ts * S + dj * XX + di_o
                assert rec["w"][n + i] == ft(w)
            n += len(want)
        assert rec["start"][b, 3] == n
    assert n == 78 <= megastep.MAX_ENTRIES
    # constants folded in float64, rounded once
    assert rec["nu4s"] == ft(1e9 * 1.0) and rec["dt"] == ft(30.0)
    assert rec["geo4"] == ft(consts["geo"] * 1.0)
    assert rec["guard"] == plan["guard"] >= 2 * XX + 2
