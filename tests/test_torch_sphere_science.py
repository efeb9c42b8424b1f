"""The Omega-1 science configuration on the sphere's fused path of the port
(ops/patch_megastep.py: upwind fluxes, wind, bottom drag, PCR vertical
mixing with constant or PP81 coefficients) against the JAX package,
float64, icosahedral subdivision 8, K = 4 layers, L = 2 tracers (T, S).

The port's framed `run_steps` (the kernels' plain versions, the pole
submesh's composed step, the in-frame refresh) is held against the JAX
package's composed `run_steps` on the same patch mesh: wind + drag +
constant mixing and upwind fluxes to 1e-12 of each field's max
(tests/test_patches.py:313, :434), PP81 to 1e-11 (:485). The whole chain on
the frames is held against the port's composed step at every position the
validity masks call exact; the compact table's upwind pair slots against
the reference tables; volume and tracer content to 1e-13; u stays 0 on dead
edges. The JAX side runs composed (no Pallas kernel in interpret mode), one
jitted program per configuration."""

import numpy as np
import pytest
import torch

from torch_port_helpers import flagship_cfg, jax_call, jax_state, port_cfg

from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.mesh.icos_patches import patch_icos_mesh as jpatch
from omega_tpu.mesh.spherical import spherical_icos_mesh as jsphere
from omega_tpu.stepping import run_steps as jrun_steps

from omega_tpu_torch.core import ModelState
from omega_tpu_torch.mesh import icos_mega, patch_icos_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.mesh.icos_patches import NPER
from omega_tpu_torch.ops import patch_megastep
from omega_tpu_torch.stepping import forward_backward_step, run_steps

N = 8
K, L, DT, NSTEPS = 4, 2, 60.0, 2
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3e-3)
CONST = JVertMixConfig(enabled=True, kappa_tracer=1e-3, kappa_momentum=1e-2)
PP81 = JVertMixConfig(enabled=True, scheme="pp81", nu0=1e-2, alpha=5.0,
                      n_exp=2, temp_index=0, salt_index=1)
UPWIND = dict(flux_thickness_type="upwind", flux_tracer_type="upwind")
# name -> (flagship_cfg keywords, tolerance against the JAX package)
CONFIGS = {
    "wind_drag_const": (dict(vert_mix=CONST, tendencies=WIND_DRAG), 1e-12),
    "pp81": (dict(vert_mix=PP81), 1e-11),
    "upwind": (UPWIND, 1e-12),
    "all": (dict(vert_mix=PP81, tendencies=WIND_DRAG, **UPWIND), 1e-11),
}


def _jcfg(name):
    kw = dict(CONFIGS[name][0])
    return flagship_cfg(K, L, tendencies=dict(kw.pop("tendencies", {})),
                        **kw)


@pytest.fixture(scope="module")
def setup():
    """JAX and port patch meshes and seeded fields: h from 4000 m + 100 m
    sin(2 lat) cos(lon), u noise times the edge mask, a stratified T and S
    near 35 (tests/test_patches.py:485's state), the wind stress of
    tests/test_patches.py:295-296."""
    jp = jpatch(jsphere(N), N)
    pp = patch_icos_mesh(spherical_icos_mesh(N), N).to("cpu", torch.float64)
    rng = np.random.default_rng(61)
    lat, lon = np.asarray(jp.lat_cell), np.asarray(jp.lon_cell)
    h = (4000.0 + 100.0 * np.sin(2 * lat) * np.cos(lon))[:, None] / K \
        * np.ones((1, K))
    u = 0.1 * rng.standard_normal((jp.nedges, K)) \
        * np.asarray(jp.edge_mask)[:, None]
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((jp.ncells, K))
    S = 35.0 + 0.1 * rng.standard_normal((jp.ncells, K))
    wind = (0.1 * np.cos(lat), 0.05 * np.sin(lat))
    return jp, pp, (h, u, np.stack([T, S])), wind


def _state(fields):
    return ModelState(*(torch.as_tensor(a) for a in fields))


def _wind(wind):
    return tuple(torch.as_tensor(w) for w in wind)


def _close(out, ref, tol):
    for f in ("h", "u", "tracers"):
        r = np.asarray(getattr(ref, f))
        err = np.abs(getattr(out, f).numpy() - r).max() / np.abs(r).max()
        assert err < tol, (f, err)


_FRAMED = {}


def _framed(setup, name):
    """NSTEPS of the port's run_steps on the patch mesh (the framed path),
    once per configuration."""
    if name not in _FRAMED:
        _, pp, fields, wind = setup
        cfg = port_cfg(_jcfg(name))
        assert patch_megastep.supported(pp, cfg)
        _FRAMED[name] = run_steps(pp, cfg, _state(fields), 0.0, DT, NSTEPS,
                                  wind_stress=_wind(wind))
    return _FRAMED[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_run_steps_against_jax_composed(setup, name):
    jp, _, fields, wind = setup
    jcfg = _jcfg(name)

    def jax_steps(h, u, tr, zonal, merid):
        return jrun_steps(jp, jcfg, JModelState(h, u, tr), 0.0, DT, NSTEPS,
                          wind_stress=(zonal, merid))
    ref = jax_call(("sphere-science", N, name), jax_steps,
                   *jax_state(*fields), *wind)
    _close(_framed(setup, name), ref, CONFIGS[name][1])


@pytest.mark.parametrize("name", ["wind_drag_const", "all"])
def test_per_step_api_against_framed(setup, name):
    """The per-step API (frames assembled and pasted back every step, wind
    laid in every step) against the framed carry (1e-13,
    tests/test_patches.py:395)."""
    _, pp, fields, wind = setup
    cfg = port_cfg(_jcfg(name))
    st = _state(fields)
    for i in range(NSTEPS):
        st = patch_megastep.fb_patch_megastep(pp, cfg, st, i * DT, DT,
                                              _wind(wind))
    _close(st, _framed(setup, name), 1e-13)


def test_options_move_the_state(setup):
    """Each option changes the result: the framed steps differ from those
    of the same configuration without it by far more than roundoff."""
    _, pp, fields, wind = setup
    full = _framed(setup, "all")
    for drop in (dict(vert_mix=JVertMixConfig()),
                 dict(flux_thickness_type="center"),
                 dict(flux_tracer_type="center"),
                 dict(tendencies=dict(bottom_drag=False))):
        kw = dict(CONFIGS["all"][0])
        tend = dict(kw.pop("tendencies"))
        tend.update(drop.pop("tendencies", {}))
        kw.update(drop)
        cfg = port_cfg(flagship_cfg(K, L, tendencies=tend, **kw))
        out = run_steps(pp, cfg, _state(fields), 0.0, DT, NSTEPS,
                        wind_stress=_wind(wind))
        moved = max((getattr(full, f) - getattr(out, f)).abs().max()
                    / getattr(full, f).abs().max()
                    for f in ("h", "u", "tracers"))
        assert moved > 1e-9, (drop, moved)
    calm = run_steps(pp, port_cfg(_jcfg("all")), _state(fields), 0.0, DT,
                     NSTEPS)
    assert (full.u[:, 0] - calm.u[:, 0]).abs().max() > 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_chain_exact_where_the_masks_say(setup, name):
    """The whole chain on the frames (step_plain, before the refresh)
    equals the port's composed step, mapped onto the frames by element id,
    at every position the validity masks call exact."""
    _, pp, fields, wind = setup
    cfg = port_cfg(_jcfg(name))
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    st = _state(fields)
    frames, _ = patch_megastep.stack_frames(pp, cfg, st)
    pw = patch_megastep.make_wind(pp, cfg, _wind(wind), torch.float64)
    got = patch_megastep.step_plain(p, cfg, frames, DT, pw).numpy()
    ref = forward_backward_step(pp, cfg, st, 0.0, DT,
                                wind_stress=_wind(wind))
    mg, P = p.mg, p.P
    for ch0, T, cls, mask, flat in (
            [(0, 1, "cell", "h_new", ref.h), (1, 3, "edge", "u_new", ref.u)]
            + [(4 + l, 1, "cell", "trn0", ref.tracers[l])
               for l in range(L)]):
        ids = mg.content[cls].reshape(T, P)
        exact = (ids >= 0) & mg.masks[mask].reshape(T, P)
        assert exact.sum() >= 10 * N * N * T     # as many as grid elements
        want = flat.numpy()[np.maximum(ids, 0)]          # (T, P, K)
        have = got[:, ch0:ch0 + T].transpose(1, 2, 0)    # (T, P, K)
        err = np.abs(have - want)[exact].max() / np.abs(want[exact]).max()
        assert err < 1e-12, (name, ch0, err)


@pytest.mark.parametrize("name", ["pp81", "all"])
def test_kernel_split_equals_one_chain(setup, name):
    """The three kernels' plain versions in a row (the patch step, the
    coefficients, the solve: the CPU side of `step`) are the one chain of
    `step_plain`, bit for bit; the coefficients are finite wherever the
    solve uses them."""
    _, pp, fields, wind = setup
    cfg = port_cfg(_jcfg(name))
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    frames, _ = patch_megastep.stack_frames(pp, cfg, _state(fields))
    pw = patch_megastep.make_wind(pp, cfg, _wind(wind), torch.float64)
    one = patch_megastep.step_plain(p, cfg, frames, DT, pw)
    nf = patch_megastep.chain_plain(p, cfg, frames, DT, wind=pw)
    coef = patch_megastep.vmix_coeffs_plain(p, cfg, nf)
    assert coef.shape == (K, 4, p.P)
    assert torch.equal(patch_megastep.step(p, cfg, frames, DT, wind=pw),
                       one)
    assert torch.equal(patch_megastep.vmix_solve_plain(p, cfg, nf, DT, coef),
                       one)
    live = nf[:, 0].gt(0).all(0)
    assert torch.isfinite(coef[:-1, 0][:, live]).all()
    assert torch.isfinite(one).all()


def test_solve_leaves_holes(setup):
    """A column whose thickness is not positive at every layer (a lattice
    hole, all zeros) keeps its values; the others move."""
    _, pp, fields, _ = setup
    cfg = port_cfg(_jcfg("wind_drag_const"))
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    frames, _ = patch_megastep.stack_frames(pp, cfg, _state(fields))
    hole = torch.as_tensor(p.mg.content["cell"].reshape(-1) < 0)
    assert hole.any()
    frames[:, 4:, hole] = 7.0
    out = patch_megastep.vmix_solve_plain(p, cfg, frames, DT)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, 4:, hole], frames[:, 4:, hole])
    assert (out[:, 4:, ~hole] != frames[:, 4:, ~hole]).any()


def test_conservation(setup):
    """Volume and tracer content over NSTEPS of every option at once, to
    1e-13 (vertical mixing conserves h-weighted columns exactly)."""
    _, pp, fields, _ = setup
    out = _framed(setup, "all")
    a = pp.area_cell[:, None]
    h0, _, tr0 = _state(fields)
    vol0, vol1 = (a * h0).sum(), (a * out.h).sum()
    assert abs(vol1 - vol0) / vol0 < 1e-13
    for l in range(L):
        c0 = (a * h0 * tr0[l]).sum()
        c1 = (a * out.h * out.tracers[l]).sum()
        assert abs(c1 - c0) / c0 < 1e-13, l


@pytest.mark.parametrize("name", CONFIGS)
def test_dead_edges_stay_zero(setup, name):
    _, pp, _, _ = setup
    out = _framed(setup, name)
    dead = pp.edge_mask == 0
    assert dead.any()
    assert (out.u[dead] == 0).all()
    assert torch.isfinite(out.u).all() and out.u.abs().max() > 0


def test_upwind_pair_slots_match_reference_tables(setup):
    """The c0 / c1 tables through the compact layout (the cmean group's
    offsets, their own weight rows) equal the reference's entry planes at
    every frame position, and read exactly the cmean slots' sources."""
    _, pp, _, _ = setup
    p = patch_megastep.prep(pp, torch.float64, "cpu")
    mg, S, P = p.mg, p.S, p.P
    row_off = row_w = 0
    for gname, group, ns in patch_megastep.GROUPS:
        rows = NPER[mg.tables[group[0]].dst_class] * ns
        if gname == "cmean":
            break
        row_off += rows
        row_w += rows * len(group)
    off = p.offs[row_off:row_off + rows].numpy().astype(np.int64)
    pos = np.arange(P)
    src = np.random.default_rng(3).standard_normal((10, S, S))
    for name in ("c0", "c1"):
        i = group.index(name)
        w = p.wts[row_w + i * rows:row_w + (i + 1) * rows].numpy()
        got = (w * src.reshape(-1)[pos[None, :] + off]).reshape(3, ns, P)
        ref = np.zeros((3, 10, S, S))
        for (td, ts, da, db, wpl) in mg.tables[name].entries:
            ref[td] += wpl * np.roll(src, (-db, -da), axis=(-2, -1))
        np.testing.assert_array_equal(got.sum(1).reshape(ref.shape), ref)
        # one unit weight per live edge position, in one of the slots
        assert set(np.unique(w)) <= {0.0, 1.0}
        live = mg.content["edge"].reshape(3, P) >= 0
        used = (w.reshape(3, ns, P) != 0).sum(1)
        assert (used <= 1).all() and (used[live] == 1).mean() > 0.9


@pytest.mark.parametrize("case", ["thomas", "column_ssh", "fct", "margin_6",
                                  "tight_masks", "one_layer"])
def test_supported_declines(setup, case):
    """Thomas, column ssh, FCT, and vertical mixing without the margin or
    the worst-case masks its radius-7 chain needs stay composed; so does
    mixing on a single layer (which mixes nothing)."""
    _, pp, _, _ = setup
    kw, args, nk = dict(vert_mix=PP81), {}, K
    if case == "thomas":
        kw = dict(vert_mix=JVertMixConfig(enabled=True, method="thomas"))
    elif case == "column_ssh":
        kw = dict(ssh_formulation="column")
    elif case == "fct":
        kw = dict(flux_tracer_type="fct")
    elif case == "margin_6":
        args = dict(mh=6)
    elif case == "tight_masks":
        args = dict(phys_masks=False)
    else:
        nk = 1
    cfg = port_cfg(flagship_cfg(nk, L, **kw))
    assert not patch_megastep.supported(pp, cfg, **args)
    if case in ("margin_6", "tight_masks"):
        # the same margin and masks serve the configurations without mixing
        assert patch_megastep.supported(
            pp, port_cfg(flagship_cfg(K, L, **UPWIND)), **args)


@pytest.mark.parametrize("name", CONFIGS)
def test_supported_takes_the_science_configurations(setup, name):
    _, pp, _, _ = setup
    assert patch_megastep.supported(pp, port_cfg(_jcfg(name)))
    assert patch_megastep.supported(pp, port_cfg(_jcfg(name)),
                                    mh=icos_mega.MH, phys_masks=True)
