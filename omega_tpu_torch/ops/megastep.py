"""The whole time step as few kernels as it takes (mega-step): the FB step
as ONE kernel, an RK stage as one kernel, the split-explicit step as
splitpre, the barotropic subcycles (ops/barotropic_kernel.py) and
splitpost.

The composed step makes ~27 stencil passes, each reading and writing whole
fields in device memory. The fused kernels read h, u and the tracers once
per tile (with a halo ring), compute every auxiliary variable and tendency
term in shared memory, and write their outputs once — the minimal-traffic
formulation of a step. They are the counterparts of the JAX package's
`megastep._kernel` with `_fb_compute` (csrc/fb_step.cuh) and with
`_tend_compute` in the stage kinds `rk2` and `rk4s1`-`rk4s4`
(csrc/rk_stage.cuh), and with `_split_pre` / `_split_post` in the kinds
`splitpre` and `splitpost` (csrc/split.cu).

Mechanics:
  * state lives in ONE stacked (4+L, K, ny, nx) array, x fastest (channel
    0 = h, 1..3 = the edge classes of u, 4.. = tracers); `run_steps` keeps
    that layout across a whole segment, so an FB step is exactly one kernel
    launch, an RK2 step two and an RK4 step four
  * the chains couple no two layers (stacked ssh), so a block of a kernel
    is one layer x one (by, bx) tile with a (ry, rx) ring; the periodic
    wrap is index arithmetic
  * inside the slab every structured-table stencil is a shifted read; a
    read that leaves the slab returns a wrong value, so wrong values creep
    in from the slab edge by one stencil radius per level, and the owned
    centre stays exact because the ring is at least the chain radius
    (`chain_radius`, derived from each chain itself)
  * supported configuration = a structured f-plane mesh with uniform
    geometry whose tables pack into the hex pattern the FB step and RK
    stage kernels are compiled for (`hex_pattern_fits`), stacked ssh and
    every tendency term on, with center or upwind
    thickness and tracer fluxes, wind forcing, quadratic bottom drag and
    implicit vertical mixing (constant or PP81 coefficients, PCR); the FB
    step also takes the flux-corrected (FCT) tracer flux, which needs the
    thickness-first order of that step. Anything else (column ssh, the
    Thomas method, custom tendencies, FCT with an RK stepper) runs the
    composed stepper (steppers.py); the split-explicit step needs the
    column ssh and center fluxes, without wind, drag or mixing
    (`split_supported`)
  * the flux types and the wind / drag tails are compile-time variants of
    the kernels, so the flagship chain stays as it was; vertical mixing
    couples the layers, which a one-layer block cannot see, so it runs as
    column kernels AFTER the horizontal ones on the same stacked array
    (ops/vmix_kernel.py)
  * an RK stage kernel evaluates the tendency chain on one level and
    writes, at the owned centre, what the stage makes of it (`RK_PROV`,
    `RK_FIRST`, `RK_MID`, `RK_LAST`): the provisional state, the
    thickness-weighted accumulator, the new state. RK2 is two launches of
    it, RK4 four; the (acc, prov) channels pass through device memory.
  * no block sees a column, so splitpre is two launches: the column sums
    (layers walked in order inside a thread), then the momentum chain with
    the ssh gradient of the column free surface on the RK stage's compiled
    slab, which also carries the depth average of du from layer to layer
    of a tile in layer order and forms the slow forcing at the last layer;
    splitpost is the FB step's kernel with the momentum compiled out, on
    its own compiled ring (2, 2): its thickness and tracer levels with the
    transport velocity formed as the slab loads. The 2-D fields between
    them live in one (NPLANES, ny, nx) array.

Beside the kernels stand their plain PyTorch versions,
`fb_megastep_plain`, `tend_plain` with `rk_stage_plain`,
`rk2_megastep_plain` / `rk4_megastep_plain`, and `split_pre_plain` /
`split_post_plain` / `split_megastep_plain`: the same chains from the same
tables and constants with `torch.roll` on the whole periodic grid, or tile
by tile (`tile=(by, bx)`) exactly as the kernels cut and evaluate their
slabs. The CPU tests use them; a state on the card never does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from omega_tpu_torch.core import aux as auxmod
from omega_tpu_torch.ops import _build, structured, vmix_kernel
from omega_tpu_torch.ops.stencil_kernel import pack_entries
from omega_tpu_torch.ops.structured import apply_grid

# launches of the CUDA kernels since the last reset (plain integers):
# the fused FB step, the RK stage kernel, splitpre's passes
# (SPLIT_PRE_PASSES per split step) and splitpost
launches = 0
rk_launches = 0
split_pre_launches = 0
split_post_launches = 0

# table order of `enum FbTable` in csrc/slab_chain.cuh
TABLE_NAMES = ("div", "ke", "curl", "kite", "tang", "cdiff", "cmean",
               "vdiff", "vmean", "signed_div", "c0", "c1", "div_pos",
               "div_neg") + tuple(f"coc{j}" for j in range(6))
_PD = {"div": 1, "ke": 1, "curl": 2, "kite": 2, "tang": 3, "cdiff": 3,
       "cmean": 3, "vdiff": 3, "vmean": 3, "signed_div": 1, "c0": 3, "c1": 3,
       "div_pos": 1, "div_neg": 1, **{f"coc{j}": 1 for j in range(6)}}
# entries per destination class the kernels are compiled for (tab_count
# there); div_pos / div_neg keep the three edges of a cell whose divergence
# weight has that sign
_ENTRY_COUNTS = {"div": 6, "ke": 6, "curl": 3, "kite": 3, "tang": 8,
                 "cdiff": 2, "cmean": 2, "vdiff": 2, "vmean": 2,
                 "signed_div": 6, "c0": 1, "c1": 1, "div_pos": 3,
                 "div_neg": 3, **{f"coc{j}": 1 for j in range(6)}}
# scalar constants of `omega::FbParams<T>`, in the struct's order
CONST_FIELDS = ("dt", "grav", "nu2s", "nu4s", "div_factor", "ed2s", "ed4",
                "inv_dc", "inv_dv", "inv_dv_floor", "geo", "geo4", "f0v",
                "rho0", "cd")
MAX_ENTRIES = 96      # kFbMaxEntries
# slab arrays in shared memory, per chain: the FB step (fb_slots in
# csrc/fb_step.cuh: FCT keeps its fluxes, bounds and ratios on the slab), the
# RK stage (kRkSlots); `plan_tile`'s default
SLOTS = 16
FCT_SLOTS = 22
RK_SLOTS = 18
# the tile and block the FB step and the RK stage kernels are compiled for
# (HexSlab's BY, BX, THREADS in csrc/fb_step.cuh and csrc/rk_stage.cuh, with
# their chains' rings), whatever the domain
HEX_TILE = (16, 32, 256)
# the planar hex mesh's table entries in pack_params' order, (source class,
# dj, di on even rows, di on odd rows): hex_ent of csrc/hex_slab.cuh, which
# both kernels' offsets are compiled from
HEX_PATTERN = (
    (0, 0, 0, 0), (1, 0, 0, 0), (2, 0, 0, 0), (0, 0, -1, -1), (1, -1, -1, 0),
    (2, -1, 0, 1),
    (0, 0, 0, 0), (1, 0, 0, 0), (2, 0, 0, 0), (0, 0, -1, -1), (1, -1, -1, 0),
    (2, -1, 0, 1),
    (0, 0, 0, 0), (1, 0, 0, 0), (2, 0, 1, 1), (1, 0, 0, 0), (2, 0, 0, 0),
    (0, 1, -1, 0),
    (0, 0, 0, 0), (0, 0, 1, 1), (0, 1, 0, 1), (0, 0, 0, 0), (0, 1, 0, 1),
    (0, 1, -1, 0),
    (1, 0, 0, 0), (2, 0, 0, 0), (1, -1, -1, 0), (2, -1, 0, 1), (1, -1, 0, 1),
    (2, -1, 1, 2), (1, 0, 1, 1), (2, 0, 1, 1), (2, 0, 0, 0), (0, 0, -1, -1),
    (2, -1, 0, 1), (0, 0, 0, 0), (2, 0, 1, 1), (0, 1, 0, 1), (2, 1, 0, 1),
    (0, 1, -1, 0), (0, 0, -1, -1), (1, -1, -1, 0), (0, 0, 0, 0),
    (1, 0, 0, 0), (0, 1, -1, 0), (1, 1, -1, 0), (0, 1, -2, -1),
    (1, 0, -1, -1),
    (0, 0, 0, 0), (0, 0, 1, 1), (0, 0, 0, 0), (0, 1, 0, 1), (0, 0, 0, 0),
    (0, 1, -1, 0),
    (0, 0, 0, 0), (0, 0, 1, 1), (0, 0, 0, 0), (0, 1, 0, 1), (0, 0, 0, 0),
    (0, 1, -1, 0),
    (1, -1, 0, 1), (0, 0, 0, 0), (0, 0, 0, 0), (1, 0, 0, 0), (1, 0, 0, 0),
    (0, 0, -1, -1),
    (1, -1, 0, 1), (0, 0, 0, 0), (0, 0, 0, 0), (1, 0, 0, 0), (1, 0, 0, 0),
    (0, 0, -1, -1),
    (0, 0, 0, 0), (1, 0, 0, 0), (2, 0, 0, 0), (0, 0, -1, -1), (1, -1, -1, 0),
    (2, -1, 0, 1),
    (0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0),
    (0, 0, 1, 1), (0, 1, 0, 1), (0, 1, -1, 0),
    (0, 0, 0, 0), (1, 0, 0, 0), (2, 0, 0, 0),
    (0, 0, -1, -1), (1, -1, -1, 0), (2, -1, 0, 1),
    (0, 0, 1, 1), (0, 1, 0, 1), (0, 1, -1, 0), (0, 0, -1, -1), (0, -1, -1, 0),
    (0, -1, 0, 1))
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on sm_90
_FLOAT = {torch.float32: (np.float32, "f32"), torch.float64: (np.float64, "f64")}

# what an RK stage launch writes at the owned centre (enum RkMode in
# csrc/rk_stage.cuh), with k = the tendencies of the evaluated level:
#   RK_PROV   out = base + ca k                  (RK2's two launches)
#   RK_FIRST  acc = (h, u, tr h)(base) + cb k ;  out = base + ca k
#   RK_MID    acc = acc + cb k ;                 out = base + ca k
#   RK_LAST   out = acc + cb k                    (tracers / the new h)
# where a state's tracers are tr, the accumulator's tr h, and
# out's tracers are (tr h of base + ca dtr) / out's h
RK_PROV, RK_FIRST, RK_MID, RK_LAST = 0, 1, 2, 3
RK4_A = (0.0, 0.5, 0.5, 1.0)
RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def enabled(state) -> bool:
    """The fused kernels serve states that live on a CUDA device."""
    return state.h.is_cuda


def supported(mesh, cfg, kind="fb") -> bool:
    """The configurations the fused path of a stepper implements (`kind`
    "fb", "rk2" or "rk4"): stacked ssh, every tendency term on, center or
    upwind fluxes (and FCT tracer fluxes for "fb"), wind, drag, and
    vertical mixing as far as the column kernels take it
    (vmix_kernel.vmix_on)."""
    tc = cfg.tendencies
    if not structured.enabled(mesh):
        return False
    if cfg.vert_mix.enabled and not vmix_kernel.vmix_on(cfg):
        return False
    need = ("dc_edge", "dv_edge", "area_cell", "area_triangle", "f_vertex",
            "bottom_depth", "edge_mask", "mesh_scaling_del2",
            "mesh_scaling_del4")
    if any(structured.uniform_scalar(mesh, a) is None for a in need):
        return False
    if structured.uniform_scalar(mesh, "edge_mask") != 1.0:
        return False
    if not tables_fit(mesh) or not hex_pattern_fits(mesh):
        return False
    # FCT (Zalesak) tracer fluxes need the thickness-first update order of
    # the FB step (core/tendencies.compute_tracer_tendency), as in the JAX
    # package's kernel
    tracer_types = ("center", "upwind") + (("fct",) if kind == "fb" else ())
    return (cfg.flux_thickness_type in ("center", "upwind")
            and cfg.flux_tracer_type in tracer_types
            and cfg.ssh_formulation == "stacked"
            and tc.thickness_flux_div and tc.pv_advection and tc.ke_gradient
            and tc.ssh_gradient and tc.velocity_diffusion
            and tc.velocity_hyperdiff and tc.tracer_horz_adv
            and tc.tracer_diffusion and tc.tracer_hyperdiff
            and not tc.use_custom_tendency)


def tables_fit(mesh) -> bool:
    """Every table of TABLE_NAMES is cached for this mesh with the entry
    counts the kernels' stencil loops are unrolled for (the hex mesh's)."""
    for n in TABLE_NAMES:
        tab = structured.cached_table(mesh, n)
        if tab is None:
            return False
        if any(sum(1 for e in tab if e[0] == t) != _ENTRY_COUNTS[n]
               for t in range(_PD[n])):
            return False
    return True


_PATTERN_CACHE: dict = {}


def hex_pattern_fits(mesh) -> bool:
    """The tables' entries, packed as pack_params packs them, are the
    planar hex pattern the FB step and RK stage kernels are compiled for
    (HEX_PATTERN), on an even number of rows (once per set of tables)."""
    tabs = tuple(structured.cached_table(mesh, n) for n in TABLE_NAMES)
    key = (tabs, mesh.structured_ny % 2)
    if key not in _PATTERN_CACHE:
        got = []
        for n, tab in zip(TABLE_NAMES, tabs):
            if tab is None:
                break
            ent, _ = pack_entries(tab, _PD[n], np.float64)
            got += [(int(e["ts"]), int(e["dj"]), int(e["di_e"]),
                     int(e["di_o"])) for e in ent]
        _PATTERN_CACHE[key] = (tuple(got) == HEX_PATTERN
                               and mesh.structured_ny % 2 == 0)
    return _PATTERN_CACHE[key]


def _mega_args(mesh, cfg, dt):
    """(tabs, consts): the shift tables and the constants of the chain.
    Products of constants are folded in float64 here and rounded to the
    working type once, as a float32 array times python floats does.
    `uph` / `upt` / `fct` (upwind thickness flux, upwind or FCT tracer
    flux) pick the variant; `cd` is the drag coefficient, 0 without
    bottom drag."""
    tc = cfg.tendencies
    us = lambda a: structured.uniform_scalar(mesh, a)
    dc, dv = us("dc_edge"), us("dv_edge")
    scal2, scal4 = us("mesh_scaling_del2"), us("mesh_scaling_del4")
    geo = dv / dc                                  # edge_mask == 1
    consts = dict(
        dt=float(dt), grav=cfg.gravity,
        nu2s=tc.visc_del2 * scal2, nu4s=tc.visc_del4 * scal4,
        div_factor=tc.div_factor,
        ed2s=tc.eddy_diff2 * scal2, ed4=tc.eddy_diff4,
        inv_dc=1.0 / dc, inv_dv=1.0 / dv,
        inv_dv_floor=1.0 / max(dv, 0.25 * dc),
        geo=geo, geo4=geo * scal4, f0v=us("f_vertex"),
        rho0=tc.density0,
        cd=tc.bottom_drag_coeff if tc.bottom_drag else 0.0,
        uph=cfg.flux_thickness_type == "upwind",
        upt=cfg.flux_tracer_type == "upwind",
        fct=cfg.flux_tracer_type == "fct")
    tabs = {n: structured.cached_table(mesh, n) for n in TABLE_NAMES}
    return tabs, consts


# ----------------------------------------------------------------------
# the plain chains

class Picks(NamedTuple):
    """The data-dependent picks of the chains: the upwind selection of a
    flux (aux._upwind), FCT's low-order pick of an edge tracer (upwind, the
    mean at rest) and its limiter's pick by the sign of the antidiffusive
    flux."""
    upwind: object
    low: object
    sign: object


PICKS = Picks(
    upwind=auxmod._upwind,
    low=lambda u, a, b: torch.where(u > 0, a, torch.where(u < 0, b,
                                                          0.5 * (a + b))),
    sign=lambda a, x, y: torch.where(a >= 0, x, y))
# for the radius probe: a pick depends on all its operands, whichever the
# data would choose (a NaN operand stays visible)
PROBE_PICKS = Picks(upwind=lambda u, a, b: u + a + b,
                    low=lambda u, a, b: u + a + b,
                    sign=lambda a, x, y: a + x + y)


def _h_fluxes(h, u, c, ap, pk):
    """(mean_h, flux_h) per edge class: center (flux == mean) or upwind."""
    if c["uph"]:
        h0, h1 = ap("c0", [h], 3), ap("c1", [h], 3)
        return ([0.5 * (h0[i] + h1[i]) for i in range(3)],
                [pk.upwind(u[i], h0[i], h1[i]) for i in range(3)])
    mean_h = ap("cmean", [h], 3)
    return mean_h, mean_h


def _fct_adv(h, h_new, trl, u, mass_flux, c, ap, pk):
    """The Zalesak-limited advective tendency of one tracer, the JAX
    kernel's `_fct_adv` (core/fct.fct_tracer_tendency on the slab;
    edge_mask is 1). mass_flux = flux_h * u per edge class, the thickness
    equation's own flux."""
    dt = c["dt"]
    tr0, tr1 = ap("c0", [trl], 3), ap("c1", [trl], 3)
    f_hi = [0.5 * (tr0[i] + tr1[i]) * mass_flux[i] for i in range(3)]
    f_lo = [pk.low(u[i], tr0[i], tr1[i]) * mass_flux[i] for i in range(3)]
    div_lo = ap("div", f_lo, 1)[0]
    tr_td = (trl * h - dt * div_lo) / h_new

    # admissible bounds: extrema of the old and transported fields over
    # the cell and its 6 neighbours (Zalesak eq. 17-18)
    tr_max = tr_min = trl
    td_max = td_min = tr_td
    for j in range(6):
        nb_o = ap(f"coc{j}", [trl], 1)[0]
        nb_t = ap(f"coc{j}", [tr_td], 1)[0]
        tr_max, tr_min = torch.maximum(tr_max, nb_o), torch.minimum(tr_min, nb_o)
        td_max, td_min = torch.maximum(td_max, nb_t), torch.minimum(td_min, nb_t)
    tr_max = torch.maximum(tr_max, td_max)
    tr_min = torch.minimum(tr_min, td_min)

    # antidiffusive fluxes, split so the budgets use the nonnegative
    # div_pos / div_neg stencils (Zalesak eq. 7-10)
    a = [f_hi[i] - f_lo[i] for i in range(3)]
    b_pos = [torch.clamp(a[i], min=0.0) for i in range(3)]
    b_neg = [torch.clamp(-a[i], min=0.0) for i in range(3)]
    p_in = dt * (ap("div_neg", b_pos, 1)[0] + ap("div_pos", b_neg, 1)[0])
    p_out = dt * (ap("div_pos", b_pos, 1)[0] + ap("div_neg", b_neg, 1)[0])
    q_in = (tr_max - tr_td) * h_new
    q_out = (tr_td - tr_min) * h_new
    r_in = torch.clamp(q_in / torch.clamp(p_in, min=1e-30), 0.0, 1.0)
    r_out = torch.clamp(q_out / torch.clamp(p_out, min=1e-30), 0.0, 1.0)

    r_in0, r_in1 = ap("c0", [r_in], 3), ap("c1", [r_in], 3)
    r_out0, r_out1 = ap("c0", [r_out], 3), ap("c1", [r_out], 3)
    f_corr = [f_lo[i] + pk.sign(a[i], torch.minimum(r_in1[i], r_out0[i]),
                                torch.minimum(r_in0[i], r_out1[i])) * a[i]
              for i in range(3)]
    return -ap("div", f_corr, 1)[0]


def _tracer_tend(h, u, trl, mean_h, c, ap, pk, fct=None):
    """d(h tr)/dt of one tracer on level h: center or upwind advection (or
    FCT, with fct = (h_new, mass_flux)), del2 and del4 diffusion."""
    if fct is not None:
        adv = _fct_adv(h, fct[0], trl, u, fct[1], c, ap, pk)
    else:
        if c["upt"]:
            h0, h1 = ap("c0", [h], 3), ap("c1", [h], 3)
            t0, t1 = ap("c0", [trl], 3), ap("c1", [trl], 3)
            htr = [pk.upwind(u[i], h0[i] * t0[i], h1[i] * t1[i])
                   for i in range(3)]
        else:
            htr = ap("cmean", [h * trl], 3)
        adv = -ap("div", [htr[i] * u[i] for i in range(3)], 1)[0]
    ctr = ap("cdiff", [trl], 3)
    d2tr = ap("signed_div",
              [c["geo"] * mean_h[i] * ctr[i] for i in range(3)], 1)[0]
    cd2 = ap("cdiff", [d2tr], 3)
    hyp = ap("signed_div", [c["geo4"] * cd2[i] for i in range(3)], 1)[0]
    return adv + c["ed2s"] * d2tr - c["ed4"] * hyp


def _momentum_tend(hl, u, c, ap, pk, wind, ssh=None):
    """du (three edge classes) with the momentum aux on thickness level
    hl: h_new in the FB step, the evaluated level in an RK stage. The ssh
    gradient reads `ssh` where given (the column free surface of the
    split step, (1, Y, X)), else hl (stacked ssh, uniform depth)."""
    inv_dc, inv_dv = c["inv_dc"], c["inv_dv"]
    ke = ap("ke", [ui * ui for ui in u], 1)[0]
    div_u = ap("div", u, 1)[0]
    rvort = ap("curl", u, 2)
    h_v = ap("kite", [hl], 2)
    nrv = [rvort[i] / h_v[i] for i in range(2)]
    npv = [c["f0v"] / h_v[i] for i in range(2)]
    nrv_e = ap("vmean", nrv, 3)
    npv_e = ap("vmean", npv, 3)
    q_e = [nrv_e[i] + npv_e[i] for i in range(3)]

    cdd = ap("cdiff", [div_u], 3)
    vdr = ap("vdiff", rvort, 3)
    del2_e = [cdd[i] * inv_dc - vdr[i] * c["inv_dv_floor"] for i in range(3)]
    del2_div = ap("div", del2_e, 1)[0]
    del2_rv = ap("curl", del2_e, 2)

    mean_hl, flux_hl = _h_fluxes(hl, u, c, ap, pk)
    F = [flux_hl[i] * u[i] for i in range(3)]
    tf = ap("tang", F, 3)
    tfq = ap("tang", [F[i] * q_e[i] for i in range(3)], 3)
    pv = [0.5 * (q_e[i] * tf[i] + tfq[i]) for i in range(3)]

    gke = ap("cdiff", [ke], 3)
    gssh = ap("cdiff", [hl if ssh is None else ssh], 3)
    cd4 = ap("cdiff", [del2_div], 3)
    vd4 = ap("vdiff", del2_rv, 3)

    # wind on the top layer, drag on the bottom one, both with mean_h of
    # level hl; 2*cmean(ke) == ke0 + ke1 of the composed step bit for bit
    kee = ap("cmean", [ke], 3) if c["cd"] else None

    # the du diff terms use plain 1/dv (TendencyTerms), while
    # del2_e above used the dv >= 0.25 dc floor (Del2AuxVars)
    dus = []
    for i in range(3):
        du = (pv[i]
              - gke[i] * inv_dc
              - c["grav"] * gssh[i] * inv_dc
              + c["nu2s"] * (cdd[i] * inv_dc - vdr[i] * inv_dv)
              - c["nu4s"] * (c["div_factor"] * cd4[i] * inv_dc
                             - vd4[i] * inv_dv))
        if wind is not None:
            du[0] += wind[i] / (c["rho0"] * mean_hl[i][0])
        if c["cd"]:
            speed = torch.sqrt(torch.clamp(2.0 * kee[i][-1], min=0.0))
            du[-1] += -(c["cd"] * speed * u[i][-1] / mean_hl[i][-1])
        dus.append(du)
    return dus


def _fb_chain(h, u, tr, even, tabs, c, wind=None, pk=PICKS):
    """The FB step chain on grids (K, Y, X). h: tensor; u, tr: lists;
    wind: None or the (3, Y, X) edge-normal stress. Returns (h_new, un,
    trn). Mirrors the kernel level for level."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    dt = c["dt"]

    # --- thickness (center or upwind flux)
    mean_h, flux_h = _h_fluxes(h, u, c, ap, pk)
    flux = [flux_h[i] * u[i] for i in range(3)]
    h_new = h + dt * (-ap("div", flux, 1)[0])

    # --- tracers (fluxes on the OLD h; FCT on the thickness flux)
    fct = (h_new, flux) if c["fct"] else None
    trn = [(trl * h + dt * _tracer_tend(h, u, trl, mean_h, c, ap, pk, fct))
           / h_new for trl in tr]

    # --- velocity (momentum aux on h_new, FB order)
    du = _momentum_tend(h_new, u, c, ap, pk, wind)
    return h_new, [u[i] + dt * du[i] for i in range(3)], trn


def _tend_chain(h, u, tr, even, tabs, c, wind=None, pk=PICKS):
    """compute_all_tendencies on grids (K, Y, X): every aux variable at
    the SAME level (h, u, tr), the JAX kernel's `_tend_compute`. Returns
    (dh, du, dtr) with du and dtr lists."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    mean_h, flux_h = _h_fluxes(h, u, c, ap, pk)
    dh = -ap("div", [flux_h[i] * u[i] for i in range(3)], 1)[0]
    dtr = [_tracer_tend(h, u, trl, mean_h, c, ap, pk) for trl in tr]
    return dh, _momentum_tend(h, u, c, ap, pk, wind), dtr


def _chain_on(s, even, tabs, consts, wind=None, pk=PICKS, kind="fb"):
    """Run a chain on a stacked (4+L, K, Y, X) array; returns the same
    layout: the new state ("fb") or the tendencies (dh, du, dtr) ("rk")."""
    fn = _fb_chain if kind == "fb" else _tend_chain
    h, u, tr = fn(s[0], [s[1], s[2], s[3]],
                  [s[c] for c in range(4, s.shape[0])],
                  even, tabs, consts, wind, pk)
    return torch.stack([h] + list(u) + list(tr))


# ----------------------------------------------------------------------
# tile and ring planning (host python, exercised by the CPU tests)

_RADIUS_CACHE: dict = {}


def probe_ring(fn, tabs, consts, vols=(5,), nplanes=0, frame_planes=True):
    """(rows, columns) of ring the chain `fn` needs: the least margin that
    keeps a slab's centre exact when a shifted read that leaves the slab
    returns a wrong value.

    Derived from the chain itself: fn(vols, planes, even, tabs, consts,
    PROBE_PICKS) runs once on a small slab of ones framed by NaNs (one
    (c, 1, Y, X) array per entry of `vols`, and `nplanes` (Y, X) planes,
    framed too unless `frame_planes` is False), so every value that such a
    read could reach turns NaN level by level, exactly as wrong values
    creep into a kernel's slab. (A pick would let a NaN operand pass on
    some data, so the probe replaces every pick by the sum of its operands,
    and the chains clamp with NaN-keeping functions.) The distance from the
    frame to the finite region of the outputs, over both row parities of
    the slab origin, is the ring."""
    pad = max(max(abs(v) for v in e[2:5]) for n in TABLE_NAMES
              for e in tabs[n])
    n = 32
    size = n + 2 * pad

    def framed(shape, frame=True):
        a = torch.full(shape, float("nan") if frame else 1.0,
                       dtype=torch.float64)
        a[..., pad:pad + n, pad:pad + n] = 1.0
        return a

    ry = rx = 0
    oks = []
    for parity in (0, 1):
        vs = [framed((c, 1, size, size)) for c in vols]
        planes = framed((nplanes, size, size), frame_planes) \
            if nplanes else None
        even = ((torch.arange(size) + parity) % 2 == 0)[:, None]
        res = fn(vs, planes, even, tabs, consts, PROBE_PICKS)
        ok = torch.isfinite(res).reshape(-1, size, size).all(0)
        oks.append(ok)
        # the stagger makes the finite region's edge jagged: take each
        # side's deepest reach along the slab's middle band
        mid = slice(pad + n // 3, pad + 2 * n // 3)
        bad_rows = (~ok[:, mid]).any(1)[pad:pad + n]   # rows with a NaN
        bad_cols = (~ok[mid, :]).any(0)[pad:pad + n]
        for bad in (bad_rows, bad_cols):
            if bool(bad[n // 3:2 * n // 3].any()):
                raise ValueError("the chain's radius exceeds the probe")
        top = int(torch.nonzero(~bad_rows)[0])
        bottom = n - 1 - int(torch.nonzero(~bad_rows)[-1])
        left = int(torch.nonzero(~bad_cols)[0])
        right = n - 1 - int(torch.nonzero(~bad_cols)[-1])
        ry, rx = max(ry, top, bottom), max(rx, left, right)
    for parity_ok in oks:
        if not bool(parity_ok[pad + ry:pad + n - ry,
                              pad + rx:pad + n - rx].all()):
            raise ValueError("the chain's finite region is not the slab "
                             "minus a ring")
    return ry, rx


def _state_chain(kind):
    """A chain of the stacked state ("fb" or "rk") in probe_ring's and
    _run_tiled's form: the one volume is the state, the planes the wind."""
    def fn(vols, planes, even, tabs, c, pk):
        return _chain_on(vols[0], even, tabs, c, planes, pk, kind)
    return fn


def chain_radius(tabs, uph=False, upt=False, tails=False, fct=False,
                 kind="fb"):
    """The ring (probe_ring) of the FB step's chain (`kind` "fb") or an RK
    stage's tendency chain ("rk"), per variant: upwind thickness flux,
    upwind or FCT tracer flux, wind and drag tails (the wind plane is read
    at the owned centre only, so it is not framed)."""
    key = (tuple((n, tuple(tabs[n])) for n in TABLE_NAMES), uph, upt, tails,
           fct, kind)
    if key not in _RADIUS_CACHE:
        consts = dict.fromkeys(CONST_FIELDS, 1.0)
        consts.update(uph=uph, upt=upt, fct=fct, cd=1.0 if tails else 0.0)
        _RADIUS_CACHE[key] = probe_ring(_state_chain(kind), tabs, consts,
                                        (5,), 3 if tails else 0,
                                        frame_planes=False)
    return _RADIUS_CACHE[key]


def _ring(tabs, consts, wind, kind="fb"):
    """chain_radius of the chain and variant these constants and this wind
    select."""
    return chain_radius(tabs, consts["uph"], consts["upt"],
                        wind is not None or consts["cd"] != 0.0,
                        consts["fct"], kind)


def slots(consts, kind="fb") -> int:
    """Slab arrays of the chain and variant these constants select."""
    if kind == "rk":
        return RK_SLOTS
    return FCT_SLOTS if consts["fct"] else SLOTS


def guard_elems(slab_width):
    """Slack (in elements) kept before the first and after the last slab
    array, so that a read shifted by up to 2 rows and 2 columns (the most
    `structured._decompose` accepts) stays inside shared memory."""
    return 2 * slab_width + 2


def plan_tile(ny, nx, itemsize, ring, tile=None, nslots=SLOTS):
    """Pick a kernel's tile: dict(by, bx, ry, rx, threads, guard, smem)
    (every chain kernel is compiled for HEX_TILE, `hex_plan`; this plans
    any other tile, which the launchers refuse).

    The slab (by+2ry) x (bx+2rx) times `nslots` arrays must fit one block's
    shared memory; the tile need not divide the domain (ragged tiles are
    masked) and is never larger than it. The default is 16 rows x 32
    columns (the fastest of the tiles timed for the FB step on an H100 at
    256 x 256 x 100, see PERF.md), halved until it fits. `tile=(by, bx)` or
    `(by, bx, threads)` overrides it."""
    ry, rx = ring

    def smem(by, bx):
        # slab arrays + a guard either side
        slab = (by + 2 * ry) * (bx + 2 * rx)
        return (nslots * slab + 2 * guard_elems(bx + 2 * rx)) * itemsize

    threads = None
    if tile is not None:
        by, bx = tile[:2]
        threads = tile[2] if len(tile) > 2 else None
        if by < 1 or bx < 1:
            raise ValueError(f"bad tile {tile}")
        if smem(min(by, ny), min(bx, nx)) > SMEM_LIMIT:
            raise ValueError(f"tile {tile} needs {smem(by, bx)} bytes of "
                             f"shared memory (limit {SMEM_LIMIT})")
    else:
        by, bx = 16, 32
        while smem(min(by, ny), min(bx, nx)) > SMEM_LIMIT:
            if max(by, bx) == 1:
                raise ValueError("no tile fits the shared memory")
            by, bx = max(by // 2, 1), max(bx // 2, 1)
    by, bx = min(by, ny), min(bx, nx)
    if threads is None:
        own = by * bx
        threads = 512 if own >= 1024 else 256 if own >= 256 else 128
    if threads % 32 or not 32 <= threads <= 512:
        raise ValueError(f"bad thread count {threads}")
    return dict(by=by, bx=bx, ry=ry, rx=rx, threads=threads,
                guard=guard_elems(bx + 2 * rx), smem=smem(by, bx))


def hex_plan(itemsize, ring, nslots):
    """The plan (plan_tile's keys) of a chain kernel compiled for the hex
    mesh (the FB step, the RK stage, the split step's chain and
    splitpost): the tile and block they are compiled for (HEX_TILE) with
    the chain's ring and `nslots` slab arrays, whatever the domain (a tile
    larger than the domain is ragged: wrapped reads, masked writes)."""
    by, bx, threads = HEX_TILE
    ry, rx = ring
    guard = guard_elems(bx + 2 * rx)
    smem = (nslots * (by + 2 * ry) * (bx + 2 * rx) + 2 * guard) * itemsize
    return dict(by=by, bx=bx, ry=ry, rx=rx, threads=threads, guard=guard,
                smem=smem)


# ----------------------------------------------------------------------
# layout

def stack_state(mesh, state):
    """ModelState -> the kernel's stacked (1+3+L, K, ny, nx) layout."""
    nx, ny = mesh.structured_nx, mesh.structured_ny
    h, u, tr = state
    K, L = h.shape[-1], tr.shape[0]
    out = torch.empty((4 + L, K, ny, nx), dtype=h.dtype, device=h.device)
    out[0] = h.reshape(ny, nx, K).permute(2, 0, 1)
    out[1:4] = u.reshape(3, ny, nx, K).permute(0, 3, 1, 2)
    out[4:] = tr.reshape(L, ny, nx, K).permute(0, 3, 1, 2)
    return out


def unstack_state(mesh, stacked, K, L, state_type):
    nx, ny = mesh.structured_nx, mesh.structured_ny
    s = stacked.permute(0, 2, 3, 1)                  # (CH, ny, nx, K)
    return state_type(
        h=s[0].reshape(ny * nx, K),
        u=s[1:4].reshape(3 * ny * nx, K),
        tracers=s[4:].reshape(L, ny * nx, K))


def stack_wind(mesh, cfg, wind_stress, dtype):
    """The wind plane the fused kernels read: (zonal, merid) cell stresses
    rotated onto the edge normals (aux.wind_normal_stress) and laid out
    like u's classes, (3, ny, nx). None without wind forcing or without a
    stress. `run_steps` packs it once per segment; a caller that steps one
    step at a time on the stacked layout packs it once and passes it on."""
    if wind_stress is None or not cfg.tendencies.wind_forcing:
        return None
    stress = auxmod.wind_normal_stress(mesh, cfg, wind_stress[0],
                                       wind_stress[1])
    return stress.to(dtype).reshape(
        3, mesh.structured_ny, mesh.structured_nx).contiguous()


def rk_work(stacked, n):
    """n work arrays shaped like a stacked state, for the RK steps' stage
    outputs (RK2 takes 1: the midpoint state; RK4 takes 3: the accumulator
    and two provisional states that swap roles)."""
    return tuple(torch.empty_like(stacked) for _ in range(n))


# ----------------------------------------------------------------------
# the plain versions

def _run_tiled(mesh, fn, vols, planes, tabs, consts, tile, ring):
    """fn(vols, planes, even, tabs, consts, PICKS) over the periodic grid:
    on the whole grid with periodic rolls (tile=None), or as a kernel does
    it: for every tile the slab with its (ry, rx) ring is cut from every
    volume (C, K, ny, nx) and from the planes (P, ny, nx) with wrapped
    indices, the chain runs on the slab with shifts that wrap inside it,
    and the owned centre of its output (..., Y, X) is pasted."""
    nx, ny = mesh.structured_nx, mesh.structured_ny
    dev = (vols[0] if vols else planes).device
    if tile is None:
        even = (torch.arange(ny, device=dev) % 2 == 0)[:, None]
        return fn(vols, planes, even, tabs, consts, PICKS)
    by, bx = tile
    ry, rx = ring
    out = None
    for y0 in range(0, ny, by):
        for x0 in range(0, nx, bx):
            rows = torch.arange(y0 - ry, y0 + by + ry, device=dev) % ny
            cols = torch.arange(x0 - rx, x0 + bx + rx, device=dev) % nx
            cut = lambda a: a.index_select(-2, rows).index_select(-1, cols)
            res = fn([cut(v) for v in vols],
                     None if planes is None else cut(planes),
                     (rows % 2 == 0)[:, None], tabs, consts, PICKS)
            if out is None:
                out = res.new_empty(res.shape[:-2] + (ny, nx))
            oy, ox = min(by, ny - y0), min(bx, nx - x0)   # ragged edge
            out[..., y0:y0 + oy, x0:x0 + ox] = \
                res[..., ry:ry + oy, rx:rx + ox]
    return out


def _tiled(mesh, stacked, tabs, consts, wind, kind, tile, ring):
    """The FB or RK chain over the stacked state, whole grid or tiled
    (_run_tiled); `ring` defaults to `chain_radius`."""
    if tile is not None and ring is None:
        ring = _ring(tabs, consts, wind, kind)
    return _run_tiled(mesh, _state_chain(kind), [stacked], wind, tabs,
                      consts, tile, ring)


def fb_megastep_plain(mesh, cfg, stacked, dt, tile=None, ring=None,
                      wind=None):
    """The plain PyTorch version of the fused FB kernel: the horizontal
    chain of one FB step on the stacked (4+L, K, ny, nx) layout (vertical
    mixing is vmix_kernel.vmix_plain). `wind` is None or the (3, ny, nx)
    stress plane of `stack_wind`; `tile` and `ring` as in `_tiled`."""
    tabs, consts = _mega_args(mesh, cfg, dt)
    return _tiled(mesh, stacked, tabs, consts, wind, "fb", tile, ring)


def tend_plain(mesh, cfg, stacked, tile=None, ring=None, wind=None):
    """The tendencies (dh, du x3, dtr x L) of a stacked level as a stacked
    array: the chain of the RK stage kernel, whole grid or tiled."""
    tabs, consts = _mega_args(mesh, cfg, 0.0)
    return _tiled(mesh, stacked, tabs, consts, wind, "rk", tile, ring)


def _stage_epilogue(k, mode, ca, cb, base, acc):
    """(acc_out or None, out) of an RK stage from its tendencies k (see
    RK_PROV ... RK_LAST): the JAX kernel's `_stage_out` and `_rk4_s4`, the
    composed rk2_step / rk4_step expression for expression. ca, cb are the
    stage's a*dt and b*dt, folded in python floats."""
    if mode == RK_LAST:
        h = acc[0] + cb * k[0]
        return None, torch.cat([h[None], acc[1:4] + cb * k[1:4],
                                (acc[4:] + cb * k[4:]) / h])
    tr_h = base[4:] * base[0]
    acc_out = None
    if mode == RK_FIRST:
        acc_out = torch.cat([base[:4] + cb * k[:4], tr_h + cb * k[4:]])
    elif mode == RK_MID:
        acc_out = acc + cb * k
    h = base[0] + ca * k[0]
    return acc_out, torch.cat([h[None], base[1:4] + ca * k[1:4],
                               (tr_h + ca * k[4:]) / h])


def rk_stage_plain(mesh, cfg, mode, ca, cb, ev, base=None, acc=None,
                   tile=None, ring=None, wind=None):
    """The plain PyTorch version of one RK stage launch: the tendency chain
    on the stacked level `ev` (whole grid or tiled), then the stage's
    epilogue against `base` (the step's initial state) and `acc`. Returns
    (acc_out or None, out)."""
    k = tend_plain(mesh, cfg, ev, tile, ring, wind)
    return _stage_epilogue(k, mode, ca, cb, base, acc)


def rk2_megastep_plain(mesh, cfg, stacked, dt, tile=None, wind=None):
    """The horizontal part of one midpoint-RK2 step on the stacked layout,
    as the kernel path does it: two stage launches (vertical mixing
    follows in vmix_kernel.vmix_plain)."""
    _, mid = rk_stage_plain(mesh, cfg, RK_PROV, 0.5 * dt, 0.0, stacked,
                            stacked, tile=tile, wind=wind)
    return rk_stage_plain(mesh, cfg, RK_PROV, dt, 0.0, mid, stacked,
                          tile=tile, wind=wind)[1]


def rk4_megastep_plain(mesh, cfg, stacked, dt, tile=None, wind=None):
    """The horizontal part of one classic-RK4 step on the stacked layout,
    as the kernel path does it: four stage launches."""
    acc, prov = rk_stage_plain(mesh, cfg, RK_FIRST, RK4_A[1] * dt,
                               RK4_B[0] * dt, stacked, stacked, tile=tile,
                               wind=wind)
    for s in (1, 2):
        acc, prov = rk_stage_plain(mesh, cfg, RK_MID, RK4_A[s + 1] * dt,
                                   RK4_B[s] * dt, prov, stacked, acc,
                                   tile=tile, wind=wind)
    return rk_stage_plain(mesh, cfg, RK_LAST, 0.0, RK4_B[3] * dt, prov,
                          acc=acc, tile=tile, wind=wind)[1]


# ----------------------------------------------------------------------
# the split-explicit step: splitpre, the barotropic subcycles, splitpost
#
# The 2-D fields of a step live in one (NPLANES, ny, nx) array, edge fields
# as three class planes, at these indices: the barotropic kernel's inputs
# in the JAX kernel's order (ubar, sshc, g_slow, het = sum_k mean_h), the
# depth average of du_full, the barotropic kernel's outputs (ub_final,
# ssh_final, <ubar>) and its ping-pong buffer.
P_UBAR, P_SSH, P_GSLOW, P_HET, P_DUBAR = 0, 3, 4, 7, 10
P_UBF, P_SSHF, P_UAVG, P_WORK, NPLANES = 13, 16, 17, 20, 24
# slab arrays of the split kernels (kSplit*Slots in csrc/split.cu): the
# chain is the RK stage's momentum levels on its compiled tile (HEX_TILE,
# ring (2, 3)); splitpost the FB step's kernel with the momentum compiled
# out (csrc/fb_step.cuh, switch SPLIT; HEX_TILE, ring (2, 2)), its
# center-flux slots
SPLIT_SLOTS = {"splitpre": 18, "splitpost": 16}
_SPLIT_PASS = {"splitpre": 1, "splitpost": 3}
# splitpre's launches per call (the column pass, the chain) and their names
SPLIT_PRE_PASSES = 2
SPLIT_PRE_PASS_NAMES = ("columns", "chain")


def split_supported(mesh, cfg) -> bool:
    """The fused split-explicit path: the flagship tendency configuration
    with the COLUMN free surface, center fluxes, no wind, drag or vertical
    mixing (those run the composed split stepper, as in the JAX package),
    and a uniform f_edge for the barotropic Coriolis term (`supported`
    covers what the barotropic kernel needs besides)."""
    tc = cfg.tendencies
    return (cfg.ssh_formulation == "column"
            and supported(mesh, dataclasses.replace(
                cfg, ssh_formulation="stacked"))
            and cfg.flux_thickness_type == "center"
            and cfg.flux_tracer_type == "center"
            and not cfg.vert_mix.enabled
            and not tc.wind_forcing and not tc.bottom_drag
            and structured.uniform_scalar(mesh, "f_edge") is not None)


def _split_args(mesh, cfg, dt, bt_drag=0.0):
    """(tabs, consts) of the split chains: the FB chain's, plus the uniform
    depth, ggrad = -g / dc (folded in float64, as the JAX kernels fold
    -g * inv_dc), f_edge and the linear drag r."""
    tabs, c = _mega_args(mesh, cfg, dt)
    c.update(depth=structured.uniform_scalar(mesh, "bottom_depth"),
             ggrad=-cfg.gravity * c["inv_dc"],
             f_e=structured.uniform_scalar(mesh, "f_edge"),
             r=float(bt_drag))
    return tabs, c


def _ksum(x):
    """Sum over the leading (layer) axis in layer order, one add at a time,
    as a thread of the column kernels sums its column."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _split_columns(vols, planes, even, tabs, c, pk):
    """splitpre's first pass (the JAX kernel's _split_pre up to uprime):
    per column ubar = sum_k mean_h u / het, sshc = sum_k h - depth and
    het = sum_k mean_h. Returns (7, Y, X): ubar x3, sshc, het x3."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    s = vols[0]
    h, u = s[0], s[1:4]
    mean_h = ap("cmean", [h], 3)
    het = [_ksum(m) for m in mean_h]
    ubar = [_ksum(mean_h[i] * u[i]) / het[i] for i in range(3)]
    return torch.stack(ubar + [_ksum(h) - c["depth"]] + het)


def _split_chain(vols, planes, even, tabs, c, pk):
    """splitpre's second pass, the JAX kernel's _vel_tend_column: the
    velocity tendency du_full (3, K, Y, X) at (h, u) with the ssh gradient
    of the column free surface sshc."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    s = vols[0]
    return torch.stack(_momentum_tend(s[0], [s[1], s[2], s[3]], c, ap, pk,
                                      None, ssh=planes[P_SSH][None]))


def _split_slow(vols, planes, even, tabs, c, pk):
    """splitpre's third pass: du_bar = sum_k mean_h du_full / het and the
    slow forcing g_slow = du_bar - (ggrad cdiff(sshc) + f_e tang(ubar)
    - r ubar). Returns (6, Y, X): g_slow x3, du_bar x3."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    s, du = vols
    mean_h = ap("cmean", [s[0]], 3)
    ubar = [planes[P_UBAR + i] for i in range(3)]
    du_bar = [_ksum(mean_h[i] * du[i]) / planes[P_HET + i]
              for i in range(3)]
    gssh = ap("cdiff", [planes[P_SSH]], 3)
    tg = ap("tang", ubar, 3)
    fast0 = [c["ggrad"] * gssh[i] + c["f_e"] * tg[i] - c["r"] * ubar[i]
             for i in range(3)]
    return torch.stack([du_bar[i] - fast0[i] for i in range(3)] + du_bar)


def _split_post(vols, planes, even, tabs, c, pk):
    """splitpost, the JAX kernel's _split_post: u_new = u' + dt (du_full -
    du_bar) + ub_final with u' = u - ubar; h and the tracers advance with
    the transport velocity u' + <ubar> (center fluxes, tracer diffusion at
    the old h). Returns the new stacked state (4+L, K, Y, X)."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    s, du = vols
    h, u, tr = s[0], s[1:4], s[4:]
    dt = c["dt"]
    uprime = [u[i] - planes[P_UBAR + i] for i in range(3)]
    ut = [uprime[i] + planes[P_UAVG + i] for i in range(3)]
    un = [uprime[i] + dt * (du[i] - planes[P_DUBAR + i]) + planes[P_UBF + i]
          for i in range(3)]
    mean_h = ap("cmean", [h], 3)
    h_new = h + dt * (-ap("div", [mean_h[i] * ut[i] for i in range(3)],
                          1)[0])
    trn = [(trl * h + dt * _tracer_tend(h, ut, trl, mean_h, c, ap, pk))
           / h_new for trl in tr]
    return torch.stack([h_new] + un + trn)


# each split pass: its chain and what it reads through its slab (the
# channels of each volume, the number of planes) for probe_ring
_SPLIT_CHAINS = {"splitcol": (_split_columns, (5,), 0),
                 "splitpre": (_split_chain, (5,), NPLANES),
                 "splitslow": (_split_slow, (5, 3), NPLANES),
                 "splitpost": (_split_post, (5, 3), NPLANES)}


def split_ring(tabs, kind):
    """probe_ring of a split pass (`kind` as in SPLIT_SLOTS)."""
    key = (tuple((n, tuple(tabs[n])) for n in TABLE_NAMES), kind)
    if key not in _RADIUS_CACHE:
        fn, vols, nplanes = _SPLIT_CHAINS[kind]
        consts = dict.fromkeys(CONST_FIELDS + ("depth", "ggrad", "f_e", "r"),
                               1.0)
        consts.update(uph=False, upt=False, fct=False)
        _RADIUS_CACHE[key] = probe_ring(fn, tabs, consts, vols, nplanes)
    return _RADIUS_CACHE[key]


def _split_pass(mesh, kind, vols, planes, tabs, c, tile):
    fn = _SPLIT_CHAINS[kind][0]
    ring = None if tile is None else split_ring(tabs, kind)
    return _run_tiled(mesh, fn, vols, planes, tabs, c, tile, ring)


def split_work(stacked):
    """The work arrays of a split step on a stacked state: du_full
    (3, K, ny, nx) and the 2-D planes (NPLANES, ny, nx). `run_steps` makes
    them once per segment."""
    return (stacked.new_empty((3,) + tuple(stacked.shape[1:])),
            stacked.new_zeros((NPLANES,) + tuple(stacked.shape[2:])))


def split_pre_plain(mesh, cfg, stacked, bt_drag=0.0, tile=None):
    """The plain PyTorch version of splitpre, as three chains (the column
    sums, the momentum chain, the depth average and slow forcing) on the
    stacked state: (du_full (3, K, ny, nx), planes (P_DUBAR + 3, ny, nx)
    holding ubar, sshc, g_slow, het and du_bar at their P_* indices); whole
    grid or tiled with each pass's probed ring."""
    tabs, c = _split_args(mesh, cfg, 0.0, bt_drag)
    cols = _split_pass(mesh, "splitcol", [stacked], None, tabs, c, tile)
    planes = stacked.new_zeros((P_DUBAR + 3,) + tuple(stacked.shape[2:]))
    planes[P_UBAR:P_UBAR + 3] = cols[0:3]
    planes[P_SSH] = cols[3]
    planes[P_HET:P_HET + 3] = cols[4:7]
    du = _split_pass(mesh, "splitpre", [stacked], planes, tabs, c, tile)
    slow = _split_pass(mesh, "splitslow", [stacked, du], planes, tabs, c,
                       tile)
    planes[P_GSLOW:P_GSLOW + 3] = slow[0:3]
    planes[P_DUBAR:P_DUBAR + 3] = slow[3:6]
    return du, planes


def split_post_plain(mesh, cfg, stacked, du, planes, dt, tile=None):
    """The plain PyTorch version of splitpost: the new stacked state from
    the state, du_full and the planes up to P_UAVG + 3."""
    tabs, c = _split_args(mesh, cfg, dt)
    return _split_pass(mesh, "splitpost", [stacked, du], planes, tabs, c,
                       tile)


def split_megastep_plain(mesh, cfg, stacked, dt, n_subcycles=10,
                         bt_drag=0.0, tile=None):
    """One split-explicit step on the stacked layout as the kernel path
    does it, with the plain versions: splitpre, the barotropic subcycles
    (barotropic_kernel.bt_plain), splitpost."""
    from omega_tpu_torch.ops import barotropic_kernel as btk
    du, pre = split_pre_plain(mesh, cfg, stacked, bt_drag, tile)
    bt = btk.bt_plain(mesh, pre[:P_DUBAR], gravity=cfg.gravity,
                      dt_bt=float(dt) / n_subcycles,
                      n_subcycles=n_subcycles, bt_drag=bt_drag, tile=tile)
    return split_post_plain(mesh, cfg, stacked, du, torch.cat([pre, bt]),
                            dt, tile)


# ----------------------------------------------------------------------
# the kernels' wrappers

def _params_dtype(ft) -> np.dtype:
    """numpy mirror of `omega::FbParams<T>` (csrc/slab_chain.cuh)."""
    ints = ["L", "K", "ny", "nx", "by", "bx", "ry", "rx", "guard"]
    return np.dtype([("off", "i4", (2, MAX_ENTRIES)),
                     ("w", ft, (MAX_ENTRIES,)),
                     ("start", "i2", (len(TABLE_NAMES), 4))]
                    + [(n, ft) for n in CONST_FIELDS]
                    + [(n, "i4") for n in ints], align=True)


def pack_params(tabs, consts, ft, plan):
    """The tables, constants and tile plan as one FbParams record.

    Entries are laid out table by table (TABLE_NAMES order), class by
    class, in table order within a class — the layout the kernels have at
    compile time. Each entry becomes a flat offset into the slab arrays
    per row parity, class * S + dj * XX + di, for the plan's slab."""
    rec = np.zeros((), _params_dtype(ft))
    YY, XX = plan["by"] + 2 * plan["ry"], plan["bx"] + 2 * plan["rx"]
    S = YY * XX
    n = 0
    for b, name in enumerate(TABLE_NAMES):
        pd = _PD[name]
        ent, start = pack_entries(tabs[name], pd, ft)
        if n + len(ent) > MAX_ENTRIES:
            raise ValueError("the chains' tables exceed the kernels' "
                             f"{MAX_ENTRIES} entries")
        sl = slice(n, n + len(ent))
        base = ent["ts"].astype(np.int64) * S + ent["dj"].astype(np.int64) * XX
        rec["off"][0, sl] = base + ent["di_e"]
        rec["off"][1, sl] = base + ent["di_o"]
        rec["w"][sl] = ent["w"]
        rec["start"][b, :pd + 1] = n + start
        rec["start"][b, pd + 1:] = n + start[-1]
        n += len(ent)
    if np.abs(rec["off"]).max() > plan["guard"] + 2 * S:
        raise ValueError("a table shift exceeds the slab guard")
    for k in CONST_FIELDS:
        rec[k] = consts[k]
    for k in ("by", "bx", "ry", "rx", "guard"):
        rec[k] = plan[k]
    return rec


_PARAM_CACHE: dict = {}


def _check_stacked(mesh, stacked, what):
    if stacked.dtype not in _FLOAT:
        raise TypeError(f"{what} takes float32/float64, got {stacked.dtype}")
    nx, ny = mesh.structured_nx, mesh.structured_ny
    if stacked.ndim != 4 or stacked.shape[0] < 4 \
            or tuple(stacked.shape[2:]) != (ny, nx):
        raise ValueError(f"stacked state must be (4+L, K, {ny}, {nx}), "
                         f"got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("stacked state must be contiguous")


def _check_like(a, stacked, name):
    if (a.shape != stacked.shape or a.dtype != stacked.dtype
            or a.device != stacked.device or not a.is_contiguous()):
        raise ValueError(f"`{name}` must match the stacked state and be "
                         "contiguous")


def _check_wind(wind, stacked, ny, nx):
    if wind is not None and (
            tuple(wind.shape) != (3, ny, nx) or wind.dtype != stacked.dtype
            or wind.device != stacked.device or not wind.is_contiguous()):
        raise ValueError(f"the wind plane must be a contiguous (3, {ny}, "
                         f"{nx}) array of the state's type and device")


def launch_record(mesh, cfg, dt, stacked, wind, kind):
    """(rec, threads, C function name, slab arrays, variant) of a chain
    kernel's launch on this stacked state: the FbParams record packed once
    per configuration and shape (`kind` "fb" or "rk"; the plan is
    hex_plan's)."""
    ft, suffix = _FLOAT[stacked.dtype]
    nx, ny = mesh.structured_nx, mesh.structured_ny
    L, K = stacked.shape[0] - 4, stacked.shape[1]
    key = (kind, nx, ny, mesh.structured_dc, mesh.structured_scalars, cfg,
           float(dt), suffix, L, K, wind is not None)
    hit = _PARAM_CACHE.get(key)
    if hit is None:
        tabs, consts = _mega_args(mesh, cfg, dt)
        nslots = slots(consts, kind)
        ring = _ring(tabs, consts, wind, kind)
        plan = hex_plan(np.dtype(ft).itemsize, ring, nslots)
        rec = pack_params(tabs, consts, ft, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, ny, nx
        # the compiled variant: flux types, and the tails only when wanted
        name = "omega_{}_{}{}_{}_{}".format(
            "fb_step" if kind == "fb" else "rk_stage",
            "u" if consts["uph"] else "c",
            "f" if consts["fct"] else "u" if consts["upt"] else "c",
            "tails" if wind is not None or consts["cd"] != 0.0 else "plain",
            suffix)
        variant = (int(kind == "rk"), int(consts["fct"]))
        hit = _PARAM_CACHE[key] = (rec, plan["threads"], name, nslots,
                                   variant)
    return hit


def _launch_args(mesh, cfg, dt, stacked, wind, kind):
    """(lib, rec, threads, C function name) of a kernel launch on a CUDA
    stacked state (launch_record), with the library's layout checked."""
    ft, suffix = _FLOAT[stacked.dtype]
    rec, threads, name, nslots, variant = launch_record(
        mesh, cfg, dt, stacked, wind, kind)
    lib = _build.load()
    size = getattr(lib, f"omega_fb_params_size_{suffix}")()
    if size != rec.dtype.itemsize or lib.omega_chain_slots(*variant) != nslots:
        raise RuntimeError(f"FbParams layout mismatch: kernel {size} bytes "
                           f"and {lib.omega_chain_slots(*variant)} slab "
                           f"arrays, host {rec.dtype.itemsize} and {nslots}")
    return lib, rec, threads, name


def _finish(mesh, cfg, res, dt, out):
    """A CPU step's result with vertical mixing (plain), into `out`."""
    if vmix_kernel.vmix_on(cfg):
        res = vmix_kernel.vmix_plain(mesh, cfg, res, dt)
    if out is None:
        return res
    out.copy_(res)
    return out


def fb_megastep_stacked(mesh, cfg, stacked, dt, out=None, wind=None):
    """One FB step on the stacked layout (stacked -> stacked), out of
    place: on PyTorch's current stream for a CUDA array, one launch of the
    horizontal kernel, then, with vertical mixing, the column kernels in
    place on the result (vmix_kernel.vmix_stacked); the plain versions
    for a CPU array. `out`, when given, is a distinct array of the same
    shape that receives the result; `wind` is None or the (3, ny, nx)
    plane of `stack_wind`."""
    global launches
    if not stacked.is_cuda:
        return _finish(mesh, cfg,
                       fb_megastep_plain(mesh, cfg, stacked, dt, wind=wind),
                       dt, out)
    _check_stacked(mesh, stacked, "fused FB kernel")
    if out is None:
        out = torch.empty_like(stacked)
    _check_like(out, stacked, "out")
    if out.data_ptr() == stacked.data_ptr():
        raise ValueError("the fused FB step is out of place: `out` must "
                         "not alias the input")
    _check_wind(wind, stacked, mesh.structured_ny, mesh.structured_nx)
    lib, rec, threads, name = _launch_args(mesh, cfg, dt, stacked, wind,
                                           "fb")
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            stacked.data_ptr(), out.data_ptr(),
            None if wind is None else wind.data_ptr(), rec.ctypes.data,
            threads, stream)
    _build.check(code, "fused FB step launch")
    launches += 1
    if vmix_kernel.vmix_on(cfg):
        vmix_kernel.vmix_stacked(mesh, cfg, out, dt)
    return out


def rk_stage(mesh, cfg, mode, ca, cb, ev, out, base=None, acc=None,
             acc_out=None, wind=None):
    """One launch of the RK stage kernel on CUDA stacked arrays, on
    PyTorch's current stream: the tendency chain on the level `ev`, then
    the epilogue of `mode` (RK_PROV ... RK_LAST) with ca = a*dt and
    cb = b*dt. `out` must not alias `ev` (neighbours read it through the
    ring); `acc_out` may be `acc` (a point reads and writes only itself),
    and `out` may be `base` in RK_LAST, which reads no base."""
    global rk_launches
    for a in (ev, out, base, acc, acc_out):
        if a is not None and not a.is_cuda:
            raise ValueError("the RK stage kernel takes CUDA arrays; the "
                             "plain version is rk_stage_plain")
    _check_stacked(mesh, ev, "RK stage kernel")
    need = {RK_PROV: ("base",), RK_FIRST: ("base", "acc_out"),
            RK_MID: ("base", "acc", "acc_out"), RK_LAST: ("acc",)}[mode]
    arrays = dict(out=out, base=base, acc=acc, acc_out=acc_out)
    for name in ("out",) + need:
        if arrays[name] is None:
            raise ValueError(f"RK stage mode {mode} needs `{name}`")
        _check_like(arrays[name], ev, name)
    if out.data_ptr() == ev.data_ptr():
        raise ValueError("an RK stage is out of place: `out` must not alias "
                         "the evaluated level")
    _check_wind(wind, ev, mesh.structured_ny, mesh.structured_nx)
    # (the stage reads no dt of its own: ca and cb carry it)
    lib, rec, threads, name = _launch_args(mesh, cfg, 0.0, ev, wind, "rk")
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(ev.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            ev.data_ptr(), ptr(base), ptr(acc), ptr(acc_out), out.data_ptr(),
            ptr(wind), rec.ctypes.data, float(ca), float(cb), mode, threads,
            stream)
    _build.check(code, "RK stage launch")
    rk_launches += 1
    return out


def _attrs(kind, cfg, dtype, tails):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the FB step (`kind` "fb_step") or RK stage
    ("rk_stage") kernel for the flux types of `cfg`, with or without the
    tails, in `dtype`, and the blocks an SM holds at its dynamic shared
    memory."""
    lib = _build.load()
    fn = getattr(lib, "omega_{}_attrs_{}{}_{}_{}".format(
        kind, "u" if cfg.flux_thickness_type == "upwind" else "c",
        {"upwind": "u", "fct": "f"}.get(cfg.flux_tracer_type, "c"),
        "tails" if tails else "plain", _FLOAT[dtype][1]))
    got = np.zeros(4, np.int32)
    _build.check(fn(got.ctypes.data), "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def fb_step_attrs(cfg, dtype, tails):
    """_attrs of the FB step kernel."""
    return _attrs("fb_step", cfg, dtype, tails)


def rk_stage_attrs(cfg, dtype, tails):
    """_attrs of the RK stage kernel."""
    return _attrs("rk_stage", cfg, dtype, tails)


def rk2_megastep_stacked(mesh, cfg, stacked, dt, out=None, wind=None,
                         work=None):
    """One midpoint-RK2 step on the stacked layout, out of place: for a
    CUDA array two launches of the RK stage kernel (midpoint into
    work[0], the new state into `out`), then the column kernels of
    vertical mixing in place on `out`; the plain versions for a CPU array.
    `work` is a tuple of one array like `stacked` (`rk_work`)."""
    if not stacked.is_cuda:
        return _finish(mesh, cfg,
                       rk2_megastep_plain(mesh, cfg, stacked, dt, wind=wind),
                       dt, out)
    mid = (work or rk_work(stacked, 1))[0]
    out = torch.empty_like(stacked) if out is None else out
    if out.data_ptr() == stacked.data_ptr():
        raise ValueError("the fused RK2 step is out of place: `out` must "
                         "not alias the input")
    rk_stage(mesh, cfg, RK_PROV, 0.5 * dt, 0.0, stacked, mid, base=stacked,
             wind=wind)
    rk_stage(mesh, cfg, RK_PROV, dt, 0.0, mid, out, base=stacked, wind=wind)
    if vmix_kernel.vmix_on(cfg):
        vmix_kernel.vmix_stacked(mesh, cfg, out, dt)
    return out


def rk4_megastep_stacked(mesh, cfg, stacked, dt, out=None, wind=None,
                         work=None):
    """One classic-RK4 step on the stacked layout: for a CUDA array four
    launches of the RK stage kernel threading the accumulator (updated in
    place) and two provisional states through `work` (three arrays like
    `stacked`, `rk_work`), then the column kernels of vertical mixing in
    place on `out`; the plain versions for a CPU array. `out` may be
    `stacked` itself: the last stage reads only the accumulator and the
    provisional state."""
    if not stacked.is_cuda:
        return _finish(mesh, cfg,
                       rk4_megastep_plain(mesh, cfg, stacked, dt, wind=wind),
                       dt, out)
    acc, p0, p1 = work or rk_work(stacked, 3)
    out = torch.empty_like(stacked) if out is None else out
    kw = dict(wind=wind)
    rk_stage(mesh, cfg, RK_FIRST, RK4_A[1] * dt, RK4_B[0] * dt, stacked, p0,
             base=stacked, acc_out=acc, **kw)
    rk_stage(mesh, cfg, RK_MID, RK4_A[2] * dt, RK4_B[1] * dt, p0, p1,
             base=stacked, acc=acc, acc_out=acc, **kw)
    rk_stage(mesh, cfg, RK_MID, RK4_A[3] * dt, RK4_B[2] * dt, p1, p0,
             base=stacked, acc=acc, acc_out=acc, **kw)
    rk_stage(mesh, cfg, RK_LAST, 0.0, RK4_B[3] * dt, p0, out, acc=acc, **kw)
    if vmix_kernel.vmix_on(cfg):
        vmix_kernel.vmix_stacked(mesh, cfg, out, dt)
    return out


def _state_step(step, mesh, cfg, state, dt, wind_stress):
    h, _, tr = state
    out = step(mesh, cfg, stack_state(mesh, state), dt,
               wind=stack_wind(mesh, cfg, wind_stress, h.dtype))
    return unstack_state(mesh, out, h.shape[-1], tr.shape[0], type(state))


def fb_megastep(mesh, cfg, state, t, dt, wind_stress=None):
    """One forward-backward step (== stepping.forward_backward_step) for
    a supported configuration."""
    return _state_step(fb_megastep_stacked, mesh, cfg, state, dt,
                       wind_stress)


def rk2_megastep(mesh, cfg, state, t, dt, wind_stress=None):
    """One midpoint-RK2 step (== stepping.rk2_step) for a supported
    configuration."""
    return _state_step(rk2_megastep_stacked, mesh, cfg, state, dt,
                       wind_stress)


def rk4_megastep(mesh, cfg, state, t, dt, wind_stress=None):
    """One classic-RK4 step (== stepping.rk4_step) for a supported
    configuration."""
    return _state_step(rk4_megastep_stacked, mesh, cfg, state, dt,
                       wind_stress)


# ----------------------------------------------------------------------
# the split-explicit kernels' wrappers

def _split_rec(mesh, cfg, dt, stacked, kind):
    """(rec, threads, (depth, ggrad, f_e)) of a split pass on a CUDA
    stacked state, packed once per configuration and shape for the
    compiled tile (hex_plan) with the pass's probed ring: splitpre's chain
    (2, 3), splitpost (2, 2) (the launchers refuse any other)."""
    ft, suffix = _FLOAT[stacked.dtype]
    nx, ny = mesh.structured_nx, mesh.structured_ny
    L, K = stacked.shape[0] - 4, stacked.shape[1]
    key = (kind, nx, ny, mesh.structured_dc, mesh.structured_scalars, cfg,
           float(dt), suffix, L, K)
    hit = _PARAM_CACHE.get(key)
    if hit is None:
        tabs, c = _split_args(mesh, cfg, dt)
        ring, itemsize = split_ring(tabs, kind), np.dtype(ft).itemsize
        plan = hex_plan(itemsize, ring, SPLIT_SLOTS[kind])
        rec = pack_params(tabs, c, ft, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = L, K, ny, nx
        hit = _PARAM_CACHE[key] = (rec, plan["threads"],
                                   (c["depth"], c["ggrad"], c["f_e"]))
    lib = _build.load()
    size = getattr(lib, f"omega_fb_params_size_{suffix}")()
    nslots = lib.omega_split_slots(_SPLIT_PASS[kind])
    if size != hit[0].dtype.itemsize or nslots != SPLIT_SLOTS[kind]:
        raise RuntimeError(f"{kind}: kernel takes {size}-byte FbParams and "
                           f"{nslots} slab arrays, host packs "
                           f"{hit[0].dtype.itemsize} and {SPLIT_SLOTS[kind]}")
    return hit


def _check_split_work(mesh, stacked, du, planes):
    shape = (3,) + tuple(stacked.shape[1:])
    pshape = (NPLANES, mesh.structured_ny, mesh.structured_nx)
    for a, want, name in ((du, shape, "du"), (planes, pshape, "planes")):
        if (tuple(a.shape) != want or a.dtype != stacked.dtype
                or a.device != stacked.device or not a.is_contiguous()):
            raise ValueError(f"`{name}` must be a contiguous {want} array of "
                             "the state's type and device (split_work)")


def split_pre(mesh, cfg, stacked, du, planes, bt_drag=0.0):
    """splitpre on the stacked state into the work arrays of `split_work`:
    du_full into `du`, ubar, sshc, g_slow, het and du_bar into `planes`.
    For a CUDA array one C call launches the SPLIT_PRE_PASSES passes (the
    column sums; the column-ssh momentum chain with the depth average and
    the slow forcing, which keeps its counters and partial sums in the work
    planes P_WORK..) on PyTorch's current stream; for a CPU array the plain
    version runs."""
    global split_pre_launches
    if not stacked.is_cuda:
        d, p = split_pre_plain(mesh, cfg, stacked, bt_drag)
        du.copy_(d)
        planes[:p.shape[0]].copy_(p)
        return du, planes
    _check_stacked(mesh, stacked, "splitpre")
    _check_split_work(mesh, stacked, du, planes)
    rec, threads, (depth, ggrad, f_e) = _split_rec(mesh, cfg, 0.0, stacked,
                                                   "splitpre")
    suffix = _FLOAT[stacked.dtype][1]
    lib = _build.load()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_split_pre_{suffix}")(
            stacked.data_ptr(), du.data_ptr(), planes.data_ptr(),
            rec.ctypes.data, depth, ggrad, f_e, float(bt_drag), threads,
            stream)
    _build.check(code, "splitpre launch")
    split_pre_launches += SPLIT_PRE_PASSES
    return du, planes


def split_pre_attrs(dtype):
    """{pass name: cudaFuncGetAttributes' numRegs, localSizeBytes (the
    spill) and sharedSizeBytes, and the blocks an SM holds at the launch's
    block and shared memory} of splitpre's kernels in `dtype`."""
    lib = _build.load()
    fn = getattr(lib, f"omega_split_pre_attrs_{_FLOAT[dtype][1]}")
    out = {}
    for i, name in enumerate(SPLIT_PRE_PASS_NAMES):
        got = np.zeros(4, np.int32)
        _build.check(fn(i, got.ctypes.data), "cudaFuncGetAttributes")
        out[name] = dict(zip(("num_regs", "local_bytes", "shared_bytes",
                              "blocks_per_sm"), map(int, got)))
    return out


def split_post_attrs(dtype):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of splitpost's kernel in `dtype`, and the blocks an SM
    holds at its block and shared memory."""
    lib = _build.load()
    got = np.zeros(4, np.int32)
    _build.check(getattr(lib, f"omega_split_post_attrs_"
                              f"{_FLOAT[dtype][1]}")(got.ctypes.data),
                 "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def split_post(mesh, cfg, stacked, du, planes, dt, out):
    """splitpost into `out` (a distinct array like `stacked`): for a CUDA
    array one launch of the FB step's kernel with the momentum compiled
    out (csrc/fb_step.cuh, instantiated by csrc/split.cu) on PyTorch's
    current stream, for a CPU array the plain version."""
    global split_post_launches
    if not stacked.is_cuda:
        out.copy_(split_post_plain(mesh, cfg, stacked, du, planes, dt))
        return out
    _check_stacked(mesh, stacked, "splitpost")
    _check_split_work(mesh, stacked, du, planes)
    _check_like(out, stacked, "out")
    if out.data_ptr() == stacked.data_ptr():
        raise ValueError("splitpost is out of place: `out` must not alias "
                         "the input")
    rec, threads, _ = _split_rec(mesh, cfg, dt, stacked, "splitpost")
    lib = _build.load()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_split_post_{_FLOAT[stacked.dtype][1]}")(
            stacked.data_ptr(), du.data_ptr(), planes.data_ptr(),
            out.data_ptr(), rec.ctypes.data, threads, stream)
    _build.check(code, "splitpost launch")
    split_post_launches += 1
    return out


def split_megastep_stacked(mesh, cfg, stacked, dt, n_subcycles=10,
                           bt_drag=0.0, out=None, work=None):
    """One split-explicit step on the stacked layout, out of place:
    splitpre, the barotropic subcycles (barotropic_kernel.bt_planes: one
    cooperative launch for all M) and splitpost, on the card for a CUDA
    array (SPLIT_PRE_PASSES + 1 + 1 launches), with the plain versions for
    a CPU array.
    `work` is `split_work(stacked)` (made here when None). dt_bt = dt / M
    is folded in float64 and rounded once, as the JAX code does."""
    from omega_tpu_torch.ops import barotropic_kernel as btk
    out = torch.empty_like(stacked) if out is None else out
    if out.data_ptr() == stacked.data_ptr():
        raise ValueError("the split step is out of place: `out` must not "
                         "alias the input")
    du, planes = work or split_work(stacked)
    split_pre(mesh, cfg, stacked, du, planes, bt_drag)
    btk.bt_planes(mesh, planes[:P_DUBAR], gravity=cfg.gravity,
                  dt_bt=float(dt) / n_subcycles, n_subcycles=n_subcycles,
                  bt_drag=bt_drag, out=planes[P_UBF:P_UAVG + 3],
                  work=planes[P_WORK:])
    return split_post(mesh, cfg, stacked, du, planes, dt, out)


def split_megastep(mesh, cfg, state, t, dt, n_subcycles=10, bt_drag=0.0):
    """One split-explicit step (== stepping.split.split_forward_backward_
    step) for the configuration of `split_supported`."""
    h, _, tr = state
    out = split_megastep_stacked(mesh, cfg, stack_state(mesh, state), dt,
                                 n_subcycles, bt_drag)
    return unstack_state(mesh, out, h.shape[-1], tr.shape[0], type(state))
