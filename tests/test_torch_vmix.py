"""Implicit vertical mixing of the port against the JAX package: the
tridiagonal solvers (ops/tridiag), core/vmix, and the column kernels'
module (ops/vmix_kernel: plain versions, planner, parameter record).

Same inputs from a numpy seed through both packages in float64. rtol 1e-12
(atol 1e-14 for values near zero): the same expressions in the same order,
so only the libraries' own rounding of a division or a power can differ."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (MESHES, jax_call, jax_mesh, port_cfg,
                                port_mesh, port_state, science_cfg,
                                stratified_fields, tt)

import jax.numpy as jnp

from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.core import vmix as jvmix
from omega_tpu.ops import tridiag as jtridiag

from omega_tpu_torch.core import ModelConfig, ModelState, VertMixConfig, vmix
from omega_tpu_torch.ops import megastep, tridiag, vmix_kernel
from omega_tpu_torch.ops.stencil_kernel import entry_dtype

KS = [1, 2, 5, 7]


def _close(out, ref, what="", rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _system(K, seed, batch=(3, 4)):
    """A diagonally dominant tridiagonal system, numpy float64."""
    rng = np.random.default_rng(seed)
    dl = rng.standard_normal(batch + (K,))
    du = rng.standard_normal(batch + (K,))
    d = 3.0 + np.abs(dl) + np.abs(du) + rng.random(batch + (K,))
    b = rng.standard_normal(batch + (K,))
    return dl, d, du, b


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_solver_matches_jax_and_solves_the_system(solver, K):
    dl, d, du, b = _system(K, seed=K)
    x = getattr(tridiag, solver)(tt(dl), tt(d), tt(du), tt(b))
    ref = jax_call(solver, getattr(jtridiag, solver),
                   *(jnp.asarray(a) for a in (dl, d, du, b)))
    _close(x, ref, solver)
    # residual of the tridiagonal product
    xn = x.numpy()
    r = d * xn
    r[..., 1:] += dl[..., 1:] * xn[..., :-1]
    r[..., :-1] += du[..., :-1] * xn[..., 1:]
    np.testing.assert_allclose(r, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("K", KS)
def test_pcr_and_thomas_agree(K):
    dl, d, du, b = (tt(a) for a in _system(K, seed=10 + K))
    torch.testing.assert_close(tridiag.pcr(dl, d, du, b),
                               tridiag.thomas(dl, d, du, b),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("offset", [-9, -2, 0, 1, 3, 8])
def test_shift_fills_out_of_range_rows(offset):
    x = np.arange(1.0, 8.0)[None].repeat(2, 0)
    out = tridiag._shift(tt(x), offset, 1.0).numpy()
    for k in range(7):
        want = x[0, k + offset] if 0 <= k + offset < 7 else 1.0
        assert (out[:, k] == want).all()


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("method", ["pcr", "thomas"])
def test_diffusion_solve_matches_jax(method, K):
    rng = np.random.default_rng(20 + K)
    g = rng.random((6, K))
    g[:, -1] = 0.0
    h = 1.0 + rng.random((6, K))
    b = rng.standard_normal((2, 6, K))
    x = tridiag.diffusion_solve(tt(g), tt(h), tt(b), method)
    ref = jax_call(("diffusion", method), lambda *a: jtridiag.diffusion_solve(
        *a, method), jnp.asarray(g), jnp.asarray(h), jnp.asarray(b))
    _close(x, ref, method)
    for a, r in zip(tridiag.implicit_diffusion_matrix(tt(g), tt(h)),
                    jtridiag.implicit_diffusion_matrix(jnp.asarray(g),
                                                       jnp.asarray(h))):
        _close(a, r, "matrix", rtol=0, atol=0)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("method", ["pcr", "thomas"])
def test_implicit_vmix_matches_jax_and_conserves_columns(method, K):
    rng = np.random.default_rng(30 + K)
    h = 5.0 + rng.random((40, K))
    kappa = 1e-2 * rng.random((40, max(K - 1, 0)))
    f = 10.0 + rng.standard_normal((2, 40, K))
    out = vmix.implicit_vmix(tt(h)[None], tt(kappa)[None], 30.0, tt(f),
                             method=method)
    ref = jax_call(("implicit_vmix", method), lambda h, kap, f:
                   jvmix.implicit_vmix(h, kap, 30.0, f, method=method),
                   jnp.asarray(h)[None], jnp.asarray(kappa)[None],
                   jnp.asarray(f))
    _close(out, ref, method)
    _close(vmix.interface_coupling(tt(h), tt(kappa), 30.0),
           jvmix.interface_coupling(jnp.asarray(h), jnp.asarray(kappa), 30.0),
           "coupling")
    # thickness-weighted column content is what the solve conserves
    np.testing.assert_allclose((h * out.numpy()).sum(-1), (h * f).sum(-1),
                               rtol=1e-13)
    u = vmix.implicit_vmix_velocity(tt(h), tt(kappa), 30.0, tt(f[0]), method)
    _close(u, ref[0], "velocity form")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("ts", ["with_ts", "without_ts"])
@pytest.mark.parametrize("K", [2, 5, 7])
def test_pp81_coefficients_match_jax(mesh, ts, K):
    jm = jax_mesh(*MESHES[mesh])
    pm = port_mesh(jm)
    idx = (0, 1) if ts == "with_ts" else (-1, 1)
    jvm = JVertMixConfig(enabled=True, scheme="pp81", n_exp=2,
                         temp_index=idx[0], salt_index=idx[1])
    vm = VertMixConfig(**dataclasses.asdict(jvm))
    h, u, tr = stratified_fields(jm, K, seed=K)
    jk, jn = jax_call(("pp81", mesh, ts), lambda *a: jvmix.pp81_coefficients(
        jm, jvm, 9.80665, *a), jnp.asarray(h), jnp.asarray(u),
        jnp.asarray(tr))
    pk, pn = vmix.pp81_coefficients(pm, vm, 9.80665, tt(h), tt(u), tt(tr))
    assert tuple(pk.shape) == (jm.ncells, K - 1)
    assert tuple(pn.shape) == (jm.nedges, K - 1)
    _close(pk, jk, "kappa_cell")
    _close(pn, jn, "nu_edge")
    if ts == "without_ts":     # unstratified: Ri = 0, mixing at its peak
        assert np.allclose(pn.numpy(), jvm.nu0 + jvm.kappa_momentum)
    else:
        assert pn.numpy().min() < 0.5 * pn.numpy().max()


# ---- the column kernels' module: plain versions, planner, record --------

def _stacked(name, K, size=(24, 12), seed=3):
    jm = jax_mesh(*size)
    pm = port_mesh(jm)
    cfg = port_cfg(science_cfg(name, K))
    st = port_state(*stratified_fields(jm, K, seed))
    return pm, cfg, st, megastep.stack_state(pm, st)


@pytest.mark.parametrize("K", [2, 5, 7])
@pytest.mark.parametrize("name", ["pp81_wind_drag", "pp81_unstratified"])
def test_coeffs_plain_on_stacked_layout_matches_core(name, K):
    pm, cfg, st, s = _stacked(name, K)
    kappa, nu = vmix_kernel.pp81_coeffs_plain(pm, cfg, s)
    assert tuple(kappa.shape) == (K - 1, 12, 24)
    assert tuple(nu.shape) == (3, K - 1, 12, 24)
    rk, rn = vmix.pp81_coefficients(pm, cfg.vert_mix, cfg.gravity, *st)
    # repeated multiplication against torch.pow: one rounding apart
    torch.testing.assert_close(kappa.permute(1, 2, 0).reshape(-1, K - 1), rk,
                               rtol=1e-13, atol=0)
    torch.testing.assert_close(nu.permute(0, 2, 3, 1).reshape(-1, K - 1), rn,
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("K", [2, 5, 7])
@pytest.mark.parametrize("name", ["vmix_wind_drag", "pp81_wind_drag"])
def test_vmix_plain_matches_the_composed_mix(name, K):
    from omega_tpu_torch.stepping.steppers import _mix
    pm, cfg, st, s = _stacked(name, K)
    out = megastep.unstack_state(pm, vmix_kernel.vmix_plain(pm, cfg, s, 30.0),
                                 K, 2, ModelState)
    ref = _mix(pm, cfg, st, 30.0)
    for n in ("h", "u", "tracers"):
        torch.testing.assert_close(getattr(out, n), getattr(ref, n),
                                   rtol=1e-12, atol=1e-14, msg=n)
    assert torch.equal(out.h, st.h)
    # column content sum_k h * tr is what the solve conserves
    torch.testing.assert_close((out.h * out.tracers).sum(-1),
                               (st.h * st.tracers).sum(-1), rtol=1e-13,
                               atol=0)


def test_cpu_wrappers_take_the_plain_versions_in_place():
    pm, cfg, st, s = _stacked("pp81_wind_drag", 5)
    want = vmix_kernel.vmix_plain(pm, cfg, s, 30.0)
    before = (vmix_kernel.coeff_launches, vmix_kernel.solve_launches)
    work = s.clone()
    res = vmix_kernel.vmix_stacked(pm, cfg, work, 30.0)
    assert res is work and torch.equal(work, want)
    assert before == (vmix_kernel.coeff_launches, vmix_kernel.solve_launches)
    assert not torch.equal(work, s)


VMIX_ON = {
    "constant": (dict(enabled=True), 3, True),
    "pp81": (dict(enabled=True, scheme="pp81"), 3, True),
    "off": (dict(enabled=False), 3, False),
    "thomas": (dict(enabled=True, method="thomas"), 3, False),
    "one_layer": (dict(enabled=True), 1, False),
    "other_scheme": (dict(enabled=True, scheme="kpp"), 3, False),
    "negative_exponent": (dict(enabled=True, scheme="pp81", n_exp=-1), 3,
                          False),
}


@pytest.mark.parametrize("what", VMIX_ON)
def test_vmix_on(what):
    kw, K, want = VMIX_ON[what]
    cfg = ModelConfig(nvertlayers=K, ntracers=2, vert_mix=VertMixConfig(**kw))
    assert vmix_kernel.vmix_on(cfg) is want


@pytest.mark.parametrize("K,L,itemsize", [(100, 2, 4), (100, 2, 8), (2, 0, 4),
                                          (7, 5, 8), (64, 1, 4),
                                          (400, 8, 4), (100, 10, 4),
                                          (800, 8, 8)])
def test_plan_solve_invariants(K, L, itemsize):
    """The sphere's solve plan (plan_frames): plan_chunks' block for lc
    tracers per pass, all L where the staging fits (at most FRAME_RHS),
    run by the kernel compiled for SOLVE_RHS or FRAME_RHS values."""
    plan = vmix_kernel.plan_frames(K, L, itemsize)
    lc = plan["lc"]
    assert 1 <= lc <= min(max(L, 1), vmix_kernel.FRAME_RHS)
    assert plan["rhs"] == (vmix_kernel.SOLVE_RHS
                           if lc <= vmix_kernel.SOLVE_RHS
                           else vmix_kernel.FRAME_RHS)
    want = vmix_kernel.plan_chunks(K, itemsize, lc)
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] == ((2 + max(lc, 2)) * K + (2 + lc) * 2
                            * plan["lanes"]) * plan["cw"] * itemsize
    assert plan["smem"] <= vmix_kernel.SMEM_LIMIT
    assert 1 <= plan["cw"] * plan["lanes"] <= 256 and plan["cw"] <= 32
    if K == 100 and L == 2 and itemsize == 4:     # the main path's shape
        assert (plan["cw"], plan["lanes"], plan["chunk"], lc,
                plan["smem"]) == (32, 4, 25, 2, 55296)
    if L > vmix_kernel.FRAME_RHS:         # passes of FRAME_RHS tracers
        assert lc == vmix_kernel.FRAME_RHS
    elif (K, itemsize) != (800, 8):
        assert lc == max(L, 1)
    else:           # eight float64 tracers of 800 layers do not fit a pass
        assert lc < L


@pytest.mark.parametrize("K", [2, 3, 7, 25, 26, 33, 100, 200, 201, 400,
                               800])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_chunks_invariants(K, itemsize):
    """The planar solve's plan: the fewest k-lanes whose chunks of at most
    SOLVE_CHUNK rows take the column, every chunk at least two rows, at
    most 256 threads, a warp of columns up to 8 lanes, the staged columns
    within a block's shared memory."""
    plan = vmix_kernel.plan_chunks(K, itemsize)
    lanes, cw = plan["lanes"], plan["cw"]
    assert lanes == -(-K // vmix_kernel.SOLVE_CHUNK)
    sizes = [(j + 1) * K // lanes - j * K // lanes for j in range(lanes)]
    assert sum(sizes) == K and plan["chunk"] == max(sizes)
    assert 2 <= min(sizes) and max(sizes) <= vmix_kernel.SOLVE_CHUNK
    assert cw * lanes <= 256 and (cw == 32) == (lanes <= 8)
    assert plan["smem"] == (4 * K + (2 + vmix_kernel.SOLVE_RHS) * 2
                            * lanes) * cw * itemsize
    assert plan["smem"] <= vmix_kernel.SMEM_LIMIT
    if K == 100:          # the main path's shape: four chunks of 25 rows
        assert (lanes, cw, plan["chunk"]) == (4, 32, 25)


def test_plan_chunks_refuses_what_cannot_fit():
    for K in (1, vmix_kernel.SOLVE_CHUNK * vmix_kernel.MAX_LANES + 1):
        with pytest.raises(ValueError):
            vmix_kernel.plan_chunks(K, 4)


def test_plan_solve_refuses_what_cannot_fit():
    """The sphere's plan refuses a column no k-lanes take (one layer, more
    than SOLVE_CHUNK x MAX_LANES layers), as plan_chunks does."""
    for K in (1, vmix_kernel.SOLVE_CHUNK * vmix_kernel.MAX_LANES + 1,
              10000):
        with pytest.raises(ValueError):
            vmix_kernel.plan_frames(K, 2, 8)


@pytest.mark.parametrize("ft", [np.float32, np.float64])
def test_param_record_mirrors_the_kernel_struct(ft):
    pm, cfg, _, _ = _stacked("pp81_wind_drag", 5)
    rec = vmix_kernel.pack_params(pm, cfg, 30.0, ft, 2, 5)
    size = np.dtype(ft).itemsize
    # Entry<T>[16], int nke, int[4], 8 T, 14 int, padded to T's alignment
    raw = 16 * entry_dtype(ft).itemsize + 20
    raw = -(-raw // size) * size + 8 * size + 14 * 4
    assert rec.dtype.itemsize == -(-raw // size) * size
    ke, cmean = vmix_kernel._tables(pm)
    assert rec["nke"] == len(ke) == 6
    assert list(rec["cm_start"]) == [6, 8, 10, 12]
    for i, (_, ts, dj, di_e, di_o, w) in enumerate(ke):
        e = rec["e"][i]
        assert (e["ts"], e["dj"], e["di_e"], e["di_o"]) == (ts, dj, di_e,
                                                             di_o)
        assert e["w"] == ft(w)
    assert (rec["ry"], rec["rx"]) == (1, 1)
    # the coefficient kernel's compiled tile and its groups of interfaces
    assert (rec["by"], rec["bx"]) == vmix_kernel.COEF_TILE
    assert rec["groups"] == vmix_kernel.plan_coeffs(
        pm.structured_ny, pm.structured_nx, 5)["groups"]
    assert rec["dt"] == ft(30.0) and rec["n_exp"] == 2
    assert (rec["ti"], rec["si"], rec["L"], rec["K"]) == (0, 1, 2, 5)
    # the solve's plan: one k-lane holds the 5 rows, a warp of columns
    assert (rec["cw"], rec["lanes"]) == (32, 1)
    assert rec["kt0"] == ft(cfg.vert_mix.kappa_tracer)
    with pytest.raises(ValueError):
        vmix_kernel.pack_params(pm, cfg, 30.0, ft, 1, 5)   # S row missing
