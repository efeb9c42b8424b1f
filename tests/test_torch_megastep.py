"""The module of the fused forward-backward kernel: its plain version
(whole grid and tiled as the kernel cuts its slabs) against the port's
composed step and against the JAX package's Pallas kernel in interpret
mode, for the flagship chain and for every variant (upwind fluxes, wind,
drag, vertical mixing by the column kernels' plain versions);
`supported()`; the tile/ring planner.

rtol and atol 1e-10: the JAX suite's own figure for fused against composed
(tests/test_structured.py) — the chain divides by h_v where the composed
step multiplies by its reciprocal, and folds constants differently."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (SCIENCE_CONFIGS, flagship_cfg, jax_mesh,
                                jax_state, jax_wind, port_cfg, port_mesh,
                                port_state, port_wind, random_fields,
                                science_cfg, stratified_fields, wind_fields)

from omega_tpu.ops import megastep as jmegastep

from omega_tpu_torch.core import (ModelConfig, ModelState, TendencyConfig,
                                  VertMixConfig, aux)
from omega_tpu_torch.ops import megastep, vmix_kernel
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


# option -> (config, whether the fused path takes it, as the JAX package's
# megastep.supported does for kind "fb")
OFF_FLAGSHIP = {
    "upwind_thickness": (dict(flux_thickness_type="upwind"), True),
    "upwind_tracer": (dict(flux_tracer_type="upwind"), True),
    "fct": (dict(flux_tracer_type="fct"), True),
    "column_ssh": (dict(ssh_formulation="column"), False),
    "vmix": (dict(vert_mix=VertMixConfig(enabled=True)), True),
    "vmix_pp81": (dict(vert_mix=VertMixConfig(enabled=True, scheme="pp81")),
                  True),
    "vmix_thomas": (dict(vert_mix=VertMixConfig(enabled=True,
                                                method="thomas")), False),
    "vmix_other_scheme": (dict(vert_mix=VertMixConfig(enabled=True,
                                                      scheme="kpp")), False),
    "wind": (dict(tendencies=TendencyConfig(wind_forcing=True)), True),
    "drag": (dict(tendencies=TendencyConfig(bottom_drag=True)), True),
    "no_pv": (dict(tendencies=TendencyConfig(pv_advection=False)), False),
    "custom": (dict(tendencies=TendencyConfig(use_custom_tendency=True)),
               False),
}


@pytest.mark.parametrize("what", OFF_FLAGSHIP)
def test_supported_is_false_off_the_flagship(what):
    """...and off the variants the fused path has: upwind and FCT fluxes,
    wind, drag and PCR vertical mixing are taken, the rest runs composed."""
    pm = port_mesh(jax_mesh(16, 8))
    kw, taken = OFF_FLAGSHIP[what]
    assert megastep.supported(pm, ModelConfig(nvertlayers=3, ntracers=2))
    assert megastep.supported(
        pm, ModelConfig(nvertlayers=3, ntracers=2, **kw)) is taken


def test_supported_with_one_layer_leaves_vmix_to_the_composed_step():
    pm = port_mesh(jax_mesh(16, 8))
    cfg = ModelConfig(nvertlayers=1, ntracers=2,
                      vert_mix=VertMixConfig(enabled=True))
    assert not megastep.supported(pm, cfg)


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
    # int[2][96], T[96], short[20][4], 15 T, 9 int, padded to T's alignment:
    # the C++ struct's layout
    raw = 2 * 96 * 4 + 96 * size + 20 * 4 * 2 + 15 * size + 36
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
    assert n == 96 == megastep.MAX_ENTRIES
    # constants folded in float64, rounded once
    assert rec["nu4s"] == ft(1e9 * 1.0) and rec["dt"] == ft(30.0)
    assert rec["geo4"] == ft(consts["geo"] * 1.0)
    assert rec["guard"] == plan["guard"] >= 2 * XX + 2
    assert rec["rho0"] == ft(cfg.tendencies.density0) and rec["cd"] == 0
    drag = dataclasses.replace(cfg, tendencies=dataclasses.replace(
        cfg.tendencies, bottom_drag=True, bottom_drag_coeff=3e-3))
    consts = megastep._mega_args(pm, drag, 30.0)[1]
    assert megastep.pack_params(tabs, consts, ft, plan)["cd"] == ft(3e-3)


# ---- the variants: upwind fluxes, wind, drag, vertical mixing -----------

def _science(name, size="32x16x5", seed=31):
    nx, ny, K = SIZES[size] if size in SIZES else (32, 16, 5)
    jm = jax_mesh(nx, ny)
    jcfg = science_cfg(name, K)
    return (jm, port_mesh(jm), jcfg, port_cfg(jcfg),
            stratified_fields(jm, K, seed), wind_fields(jm), K)


def _fused_plain(pm, cfg, s, dt, wind, tile=None):
    """The fused path's plain version: the horizontal chain, then the
    column kernels' plain versions."""
    s = megastep.fb_megastep_plain(pm, cfg, s, dt, tile=tile, wind=wind)
    if vmix_kernel.vmix_on(cfg):
        s = vmix_kernel.vmix_plain(pm, cfg, s, dt)
    return s


@pytest.mark.parametrize("tile", [None, (8, 8), (7, 5)],
                         ids=["whole", "tile8x8", "ragged7x5"])
@pytest.mark.parametrize("name", SCIENCE_CONFIGS)
def test_variant_plain_matches_composed_over_2_steps(name, tile):
    _, pm, _, cfg, fields, wind, K = _science(name)
    assert megastep.supported(pm, cfg)
    ref = port_state(*fields)
    pw = port_wind(wind)
    s = megastep.stack_state(pm, ref)
    plane = megastep.stack_wind(pm, cfg, pw, ref.h.dtype)
    assert (plane is None) == (not cfg.tendencies.wind_forcing)
    for _ in range(2):
        ref = forward_backward_step(pm, cfg, ref, 0.0, 30.0, wind_stress=pw)
        s = _fused_plain(pm, cfg, s, 30.0, plane, tile)
    _assert_state_close(megastep.unstack_state(pm, s, K, L, ModelState), ref)


@pytest.mark.parametrize("name", ["upwind", "vmix_wind_drag", "all"])
def test_variant_plain_matches_jax_pallas_kernel(name):
    """Against the JAX fused kernel in interpret mode, two steps, 1e-10."""
    jm, pm, jcfg, cfg, fields, wind, K = _science(name)
    assert jmegastep.supported(jm, jcfg)
    jout = jax_state(*fields)
    st = port_state(*fields)
    pw = port_wind(wind)
    for _ in range(2):
        jout = jmegastep.fb_megastep(jm, jcfg, jout, 0.0, 30.0,
                                     interpret=True,
                                     wind_stress=jax_wind(wind))
        st = megastep.fb_megastep(pm, cfg, st, 0.0, 30.0, wind_stress=pw)
    for n in ("h", "u", "tracers"):
        np.testing.assert_allclose(getattr(st, n).numpy(),
                                   np.asarray(getattr(jout, n)),
                                   rtol=1e-10, atol=1e-10, err_msg=n)


def test_wind_and_drag_act_on_one_layer_each():
    _, pm, _, cfg, fields, wind, K = _science("wind_drag")
    base = port_cfg(flagship_cfg(K, L))
    s = megastep.stack_state(pm, port_state(*fields))
    plane = megastep.stack_wind(pm, cfg, port_wind(wind), s.dtype)
    assert tuple(plane.shape) == (3, 16, 32) and plane.is_contiguous()
    d = (megastep.fb_megastep_plain(pm, cfg, s, 30.0, wind=plane)
         - megastep.fb_megastep_plain(pm, base, s, 30.0))
    assert float(d[0].abs().max()) == 0 and float(d[4:].abs().max()) == 0
    assert float(d[1:4, 1:K - 1].abs().max()) == 0
    assert float(d[1:4, 0].abs().max()) > 0        # wind: top layer
    assert float(d[1:4, K - 1].abs().max()) > 0    # drag: bottom layer
    # without a stress the wind variant adds nothing to the top layer
    d0 = (megastep.fb_megastep_plain(pm, cfg, s, 30.0)
          - megastep.fb_megastep_plain(pm, base, s, 30.0))
    assert float(d0[1:4, 0].abs().max()) == 0


VARIANTS = {"center": (False, False, False), "upwind_h": (True, False, False),
            "upwind_tr": (False, True, False), "upwind": (True, True, False),
            "tails": (False, False, True), "upwind_tails": (True, True, True),
            "fct": (False, "fct", False), "fct_upwind_tails": (True, "fct", True)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_chain_radius_per_variant_is_tight(variant):
    """Each variant's ring is derived by its own probe run; it keeps tiles
    exact, and one row or one column fewer does not."""
    uph, upt, tails = VARIANTS[variant]
    fct = upt == "fct"
    upt = upt is True
    name = {(False, False): "wind_drag", (True, False): "upwind_thickness",
            (False, True): "upwind_tracer", (True, True): "upwind"}[uph, upt]
    jm, pm, jcfg, cfg, _, wind, K = _science(name, "32x16x3")
    fields = random_fields(jm, K, L, 0)    # noise in every field and row
    # (a non-zero eddy_diff4 keeps the tracer del4's reach in the result)
    tc = dataclasses.replace(cfg.tendencies, wind_forcing=tails,
                             bottom_drag=tails, bottom_drag_coeff=3e-3,
                             eddy_diff4=1e6)
    cfg = dataclasses.replace(cfg, tendencies=tc)
    if fct:
        cfg = dataclasses.replace(cfg, flux_tracer_type="fct")
    tabs, consts = megastep._mega_args(pm, cfg, 30.0)
    assert (consts["uph"], consts["upt"], consts["cd"] != 0,
            consts["fct"]) == (uph, upt, tails, fct)
    ry, rx = megastep.chain_radius(tabs, uph, upt, tails, fct)
    assert 1 <= ry <= 5 and 1 <= rx <= 6
    s = megastep.stack_state(pm, port_state(*fields))
    plane = megastep.stack_wind(pm, cfg, port_wind(wind), s.dtype)
    assert (plane is not None) == tails
    whole = megastep.fb_megastep_plain(pm, cfg, s, 30.0, wind=plane)
    exact = megastep.fb_megastep_plain(pm, cfg, s, 30.0, tile=(4, 8),
                                       wind=plane)
    assert torch.equal(exact, whole)
    for ring in ((ry - 1, rx), (ry, rx - 1)):
        short = megastep.fb_megastep_plain(pm, cfg, s, 30.0, tile=(4, 8),
                                           ring=ring, wind=plane)
        assert not torch.equal(short, whole), ring


def test_radius_probe_sees_through_the_upwind_pick():
    """With the data-dependent picks left in, a slab of ones (u > 0 picks
    one side only, a >= 0 one limiter pair) would hide the other side's
    reach; every pick of the probe depends on all its operands."""
    pm = port_mesh(jax_mesh(16, 8))
    tabs = megastep._mega_args(pm, ModelConfig(nvertlayers=3, ntracers=2),
                               30.0)[0]
    nan = torch.tensor(float("nan"), dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    assert torch.isfinite(aux._upwind(one, one, nan))
    for name in megastep.Picks._fields:
        real = getattr(megastep.PICKS, name)
        probe = getattr(megastep.PROBE_PICKS, name)
        assert torch.isfinite(real(one, one, nan)), name
        assert torch.isnan(probe(one, one, nan)), name
        assert torch.isnan(probe(one, nan, one)), name
    assert megastep.chain_radius(tabs, True, True, True) >= \
        megastep.chain_radius(tabs)
    assert megastep.chain_radius(tabs, True, False, True, fct=True) >= \
        megastep.chain_radius(tabs)


def test_cpu_wrapper_with_vmix_takes_plain_versions_and_counts_nothing():
    _, pm, _, cfg, fields, wind, K = _science("all")
    st = port_state(*fields)
    s = megastep.stack_state(pm, st)
    plane = megastep.stack_wind(pm, cfg, port_wind(wind), s.dtype)
    before = (megastep.launches, vmix_kernel.coeff_launches,
              vmix_kernel.solve_launches)
    out = megastep.fb_megastep_stacked(pm, cfg, s, 30.0, wind=plane)
    assert before == (megastep.launches, vmix_kernel.coeff_launches,
                      vmix_kernel.solve_launches)
    torch.testing.assert_close(out, _fused_plain(pm, cfg, s, 30.0, plane),
                               rtol=0, atol=0)


def test_wind_plane_is_kept_while_the_stress_is_unchanged(monkeypatch):
    """The plane is kept for a segment and no longer: `run_steps` packs it
    once per call on its stacked path, and `stack_wind` holds nothing from
    one call to the next, so it reads the stress as it stands."""
    from omega_tpu_torch.stepping import run_steps
    _, pm, _, cfg, fields, wind, K = _science("wind_drag")
    pw = port_wind(wind)
    a = megastep.stack_wind(pm, cfg, pw, torch.float64)
    b = megastep.stack_wind(pm, cfg, pw, torch.float64)
    assert b is not a and torch.equal(b, a)
    assert megastep.stack_wind(pm, cfg, pw, torch.float32).dtype == \
        torch.float32
    # a write that bumps no version counter is seen all the same
    pw[0].data.mul_(2.0)
    d = megastep.stack_wind(pm, cfg, pw, torch.float64)
    assert not torch.equal(d, a)
    want = megastep.auxmod.wind_normal_stress(pm, cfg, *pw).reshape(3, 16, 32)
    assert torch.equal(d, want)
    assert megastep.stack_wind(pm, cfg, None, torch.float64) is None
    # the stacked segment loop, on the CPU through the plain versions
    packs = []
    pack = megastep.stack_wind
    monkeypatch.setattr(megastep, "enabled", lambda state: True)
    monkeypatch.setattr(megastep, "stack_wind",
                        lambda *args: packs.append(1) or pack(*args))
    st = port_state(*fields)
    seg = run_steps(pm, cfg, st, 0.0, 30.0, 3, wind_stress=pw)
    assert len(packs) == 1
    monkeypatch.undo()
    ref = run_steps(pm, cfg, st, 0.0, 30.0, 3, wind_stress=pw)   # composed
    for x, y in zip(seg, ref):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)
