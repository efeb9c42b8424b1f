"""The forward-backward and Runge-Kutta steps on the icosahedral sphere,
fused.

Counterpart of omega_tpu/ops/patch_megastep.py for kinds `fb`, `fcta`,
`fctb`, `rk2a` / `rk2b`, `rk4s1`-`rk4s4` and `splitpre` / `splitpost`.
Icosahedral meshes renumbered by mesh/icos_patches.py run the whole FB chain
(mesh/icos_mega.fb_chain: center or upwind fluxes, wind, bottom drag,
implicit vertical mixing with constant or PP81 coefficients) on halo-MH
frames of the 10 rhombi, with the padded-domain tables of
mesh/icos_mega.py: per-position weights instead of the planar path's
uniform scalars, plain 2-D offsets instead of parity shifts (the rhombus
lattice is unstaggered), and no mid-chain fix-ups: rotated seam stencils
are extra entries, and the only rows the lattice cannot serve (the pole
wedges: a constant count at any resolution) are recomputed on an
extracted submesh by the composed stepper and scattered over the result.

Execution model per step, frames as the loop carry:
  1. the chain evaluates every frame position of the (K, 4+L, 10, S, S)
     frames (channel 0 = h, 1..3 = the edge classes of u, 4.. = tracers;
     S = n + 2 MH). On the card: the horizontal part in the six passes
     of the patch kernel (csrc/patch_step.cuh, one source per pair of
     flux types), then with vertical mixing the PP81 coefficient kernel
     and the column-solve kernel (csrc/patch_vmix.cu); on the CPU their
     plain versions, `chain_plain`, `vmix_coeffs_plain`,
     `vmix_solve_plain` (the chain's ops with torch.roll)
  2. the composed forward-backward step advances the pole submesh
  3. the in-frame refresh: positions the validity masks of
     mesh/icos_mega.py do not call exact are refilled from an exact copy
     of the same element, the pole rows come from the submesh step, and
     lattice holes are set to zero again

The RK steppers (`rk2_patch_megastep_framed`, `rk4_patch_megastep_framed`,
run_steps only) run one kernel launch group per stage: every tendency at
the in-kernel level (icos_mega.rk2_stage_chain / rk4_stage_chain: one level
shallower than the FB chain, whose masks therefore serve), then the
stage's update against the step's initial frames and, for RK4, the
accumulator (csrc/patch_rk.cuh, five passes; plain version
`rk_stage_plain`), each stage followed by the pole submesh's tendencies at
that stage and the in-frame refresh; vertical mixing after the last stage
(the column kernels above).

The split-explicit stepper (`split_patch_megastep_framed`, run_steps and
split_forward_backward_step) runs per step the splitpre kernel (the full 3-D
velocity tendency with the column free surface, icos_mega.split_pre_chain;
csrc/patch_split.cu, five passes; plain version `split_pre_plain`), the
flat 2-D phase on the (E, K) / (C, K) arrays with the barotropic subcycles
(ops/bt_gather.py: a gather-form kernel, one cooperative launch for all M
subcycles), then
the splitpost kernel (the thickness and tracer advance with the transport
velocity, icos_mega.split_post_chain; four passes; `split_post_plain`), the
pole submesh's composed advance and the in-frame refresh.

With Zalesak FCT tracer fluxes (`fct_patch_megastep_framed`, run_steps
only, no vertical mixing) the step has two stages, as the reference's
(the limiter's chain is deeper than the MH margin): stage A is the patch
kernel's FCT variant (h_new, u_new, the provisional tracers and the
diffusion numerators), then the refresh of its fields, stage B the
limiter (csrc/patch_fct.cu; plain versions `fct_a_plain`, `fct_b_plain`),
with the FCT closure's own fix submesh and maps (mesh/icos_mega.ensure_fct,
an FCT prep).

The TPU kernel tiles each frame into (16, 16) blocks with an 8-wide ring
and reads its weights from a lane-major plane stack (10, SS, SS, npl),
164 MB at icos48 in float32 and mostly zeros. Here the weights are a
compact per-position table: for each group of tables that share a support
(div / ke / sdiv_geo*; cmean / cdiff / cgrad / c0 / c1; vmean / vgrad /
vgrad_floor; curl; kite; tang) and each destination channel, a fixed
number of slots of (offset, one weight per table), zero weights in unused
slots; offsets are flat within a layer of the source field. Every layer
uses the same weights. The kernel evaluates whole frames (so the
reference's tiled validity masks are sufficient: an untiled evaluation is
exact wherever the tiled one is) in six launches, one per group of chain
levels (the deepest split by section: cells, edges), with the intermediate
fields in device memory. The reference runs
PP81 and upwind fluxes as two staged kernels (its kinds fb2a / fb2b) to
fit its on-chip memory; that staging is not semantics, and the port
evaluates the one chain.

Divisions guard against lattice-hole zeros (safe_div) because 0/0 NaN at a
hole would otherwise poison valid sums through 0 * NaN entries; the column
solve leaves a column whose thickness is not positive at every layer (a
hole, or a frame position no exact value depends on) as it found it.

Semantics == stepping.forward_backward_step, rk2_step, rk4_step and
split_forward_backward_step on the sphere configurations `supported` and
`split_patch_supported` name; reference chain per
core/tendencies.py / core/aux.py /
core/vmix.py (TendencyTerms.h:70-340, AuxiliaryState.cpp:60-143,
TriDiagSolvers.h PCRDiffusionSolver).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from omega_tpu_torch.core import aux as auxmod
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh import icos_mega as imx
from omega_tpu_torch.mesh.icos_patches import NPER
from omega_tpu_torch.ops import _build, megastep, tridiag, trisk, \
    vmix_kernel

# launches since the last reset: the patch step (PASSES per call), the
# PP81 coefficient kernel and the column-solve kernel (one per call each),
# FCT's stage A (the patch step's FCT variant, PASSES per call) and stage B
# (FCT_B_PASSES per call), the RK stage (RK_PASSES per call), the split
# stepper's splitpre (SPLIT_PRE_PASSES per call) and splitpost
# (SPLIT_POST_PASSES per call)
launches = 0
coeff_launches = 0
solve_launches = 0
fct_a_launches = 0
fct_b_launches = 0
rk_launches = 0
split_pre_launches = 0
split_post_launches = 0
PASSES = 6
FCT_B_PASSES = 4
RK_PASSES = 5
SPLIT_PRE_PASSES = 5
# the passes of an RK stage (csrc/patch_rk.cuh: A, B, C, D1 the cells, D2
# the edges) and of splitpre (csrc/patch_split.cu: the column free surface,
# then the stage's momentum passes), in launch order
RK_PASS_NAMES = ("A", "B", "C", "D1", "D2")
# the passes of the FB step and FCT's stage A (csrc/patch_step.cuh: A, B, C,
# D1 the cells, D2 the edges, E), in launch order
FB_PASS_NAMES = ("A", "B", "C", "D1", "D2", "E")
SPLIT_PRE_PASS_NAMES = ("ssh", "A", "B", "C", "D2")
SPLIT_POST_PASSES = 4
# the passes of FCT's stage B (csrc/patch_fct.cu: pass_flux, pass_ratios,
# pass_limit, pass_tracers), in launch order
FCT_B_PASS_NAMES = ("flux", "ratios", "limit", "tracers")
# what an RK stage makes of its tendencies k (megastep's modes, the same
# run-time enum RkMode of the kernels), with ca = a dt and cb = b dt:
#   RK_PROV   out = base + ca k                  (RK2's two stages)
#   RK_FIRST  acc = (h, u, tr h)(base) + cb k ;  out = base + ca k
#   RK_MID    acc = acc + cb k ;                 out = base + ca k
#   RK_LAST   out = acc + cb k
RK_PROV, RK_FIRST, RK_MID, RK_LAST = (megastep.RK_PROV, megastep.RK_FIRST,
                                      megastep.RK_MID, megastep.RK_LAST)
_MODE_NAME = {RK_PROV: "prov", RK_FIRST: "first", RK_MID: "mid",
              RK_LAST: "last"}
# layers one thread of FCT's stage B walks with the weights of its position
# in registers (the FB, RK and split passes and the PP81 coefficient kernel
# walk their own groups, compiled in: csrc/patch_step.cuh's kFbPassLayers,
# patch_rk.cuh's kRkPassLayers, patch_vmix.cu's kCoefLayers; they do not
# read this entry of the call's ints)
LAYERS_PER_THREAD = 8
THREADS = 128

# the compact table: groups of tables that share their offsets, with the
# slots per destination channel (the widest row of the group's stencils)
GROUPS = (("div", ("div", "ke", "sdiv_geo", "sdiv_geo2", "sdiv_geo4"), 6),
          ("curl", ("curl",), 3),
          ("kite", ("kite",), 3),
          ("tang", ("tang",), 10),
          ("cmean", ("cmean", "cdiff", "cgrad", "c0", "c1"), 2),
          ("vmean", ("vmean", "vgrad", "vgrad_floor"), 2))
# the rows an FCT prep appends: the relu'd divergence halves (the div
# support) and one single-slot group per neighbour pick
FCT_GROUPS = (("fdiv", ("div_pos", "div_neg"), 6),) + tuple(
    (f"coc{j}", (f"coc{j}",), 1) for j in range(6))
# const planes in the order of the kernel's plane rows; the three rows of
# the wind stress on the edge classes follow them (zero without wind)
CONSTS = (("f_vertex", "vertex"), ("gdepth", "edge"), ("scal2", "edge"),
          ("scal4", "edge"), ("edge_mask", "edge"))
WIND_ROW = sum(NPER[cls] for _, cls in CONSTS)
# the const the split-explicit chain reads besides (the column free
# surface's bottom depth); the splitpre kernel takes it as its own row
SPLIT_CONSTS = (("depth", "cell"),)


def fct_b_work_fields(L: int) -> int:
    """Stage B's scratch in (K, 1, P) fields: the antidiffusive flux (3L),
    the low-order then corrected flux (3L), r_in (L), r_out (L)."""
    return 8 * L


def work_fields(L: int) -> int:
    """The kernel's scratch in units of one (K, 1, P) field: flux / F (3),
    ke, div_u / dd2, rvort (2), hflux (3L), mc / cd2 (3L), trp (L), d2aux
    (L), dup (3), del2e / Fq (3), qv (2), dr2 (2); csrc/patch_step.cuh
    carves it in this order."""
    return 3 + 1 + 1 + 2 + 3 * L + 3 * L + L + L + 3 + 3 + 2 + 2


def rk_work_fields(L: int) -> int:
    """The RK stage's scratch in (K, 1, P) fields: flux (3), hflux (3L), mc
    / cd2 (3L), ke, div_u / dd2, rvort / dr2 (2), qv (2), dh, trp (L), d2aux
    (L), dup (3), del2e (3), Fq (3); csrc/patch_rk.cuh carves it in this
    order."""
    return 3 + 3 * L + 3 * L + 1 + 1 + 2 + 2 + 1 + L + L + 3 + 3 + 3


def split_work_fields(L: int) -> int:
    """The split kernels' scratch in (K, 1, P) fields, shared by the two
    (one runs after the other): splitpre's flux (3), ke, div_u / dd2, rvort
    / dr2 (2), qv (2), dup (3), del2e (3), Fq (3) and the column free surface
    sshc (one field); splitpost's flux (3), hflux (3L), mc / cd2 (3L), trp
    (L), d2aux (L). csrc/patch_split.cu carves them in these orders."""
    return max(3 + 1 + 1 + 2 + 2 + 3 + 3 + 3 + 1, 3 + 8 * L)


def enabled(x) -> bool:
    """The kernel serves tensors that live on a CUDA device."""
    return x.is_cuda


vmix_on = vmix_kernel.vmix_on


def supported(mesh, cfg, mh: int = imx.MH, phys_masks: bool = True,
              framed: bool = False, kind: str = "fb") -> bool:
    """The sphere configurations of the fused steps on a patch mesh (the
    reference's `supported(kind=..., framed=...)`; `kind` "fb", "rk2" or
    "rk4"): center or upwind thickness and tracer fluxes, stacked ssh,
    every standard term, wind and bottom drag, implicit vertical mixing by
    PCR (constant or PP81 coefficients, at least two layers), no custom
    tendency. The radius-7 vmix chain needs a margin `mh` of at least 7
    and the worst-case validity masks (`phys_masks`), with which `prep`
    builds; the Thomas method stays composed. FCT tracer fluxes are fused
    only in the FB step on the framed path (`framed`: run_steps' carry,
    the two-stage step `fct_patch_megastep_framed`) and only without
    vertical mixing; the RK steps run on the framed path alone
    (`rk2_patch_megastep_framed`, `rk4_patch_megastep_framed`). The
    reference declines PP81 under RK for its chip's on-chip memory alone
    (OMEGA_PATCH_PP81); the port fuses it."""
    if kind not in ("fb", "rk2", "rk4"):
        raise ValueError(f"unknown kind {kind!r}")
    if getattr(mesh, "patch_info", None) is None:
        return False
    if cfg.vert_mix.enabled and not vmix_on(cfg):
        return False
    if vmix_on(cfg) and (mh < 7 or not phys_masks):
        return False
    tc = cfg.tendencies
    tracer_types = ("center", "upwind")
    if kind == "fb" and framed and not cfg.vert_mix.enabled:
        tracer_types += ("fct",)
    return (cfg.flux_thickness_type in ("center", "upwind")
            and cfg.flux_tracer_type in tracer_types
            and cfg.ssh_formulation == "stacked"
            and tc.thickness_flux_div and tc.pv_advection and tc.ke_gradient
            and tc.ssh_gradient and tc.velocity_diffusion
            and tc.velocity_hyperdiff and tc.tracer_horz_adv
            and tc.tracer_diffusion and tc.tracer_hyperdiff
            and not tc.use_custom_tendency)


def split_patch_supported(mesh, cfg) -> bool:
    """The split-explicit configurations of the sphere's framed path
    (`split_patch_megastep_framed`; the reference's gate): the column free
    surface, a configuration `supported` takes with the stacked one, center
    thickness and tracer fluxes, and no vertical mixing, wind or bottom drag
    (those keep the composed split stepper, as on the plane)."""
    tc = cfg.tendencies
    return (cfg.ssh_formulation == "column"
            and supported(mesh, dataclasses.replace(
                cfg, ssh_formulation="stacked"))
            and cfg.flux_thickness_type == "center"
            and cfg.flux_tracer_type == "center"
            and not cfg.vert_mix.enabled
            and not tc.wind_forcing and not tc.bottom_drag)


def _drag_on(cfg) -> bool:
    tc = cfg.tendencies
    return bool(tc.bottom_drag and tc.bottom_drag_coeff != 0.0)


def fct_ops(cfg, L: int, wind: bool):
    """The two FCT stages of `cfg` (icos_mega.fct_stage_a_chain /
    fct_stage_b_chain): (stage A, stage B)."""
    uw_h = cfg.flux_thickness_type == "upwind"
    return (imx.fct_stage_a_chain(L, wind=wind, drag=_drag_on(cfg),
                                  uw_h=uw_h),
            imx.fct_stage_b_chain(L, uw_h=uw_h))


def chain_ops(cfg, L: int, wind: bool):
    """The chain of `cfg` (icos_mega.fb_chain with its options), split
    into (horizontal, coefficients, solve): the patch kernel's ops
    through u_new, the PP81 coefficient fields (empty for constant
    coefficients or without mixing), and the column solves."""
    vm = cfg.vert_mix
    mix = vmix_on(cfg)
    pp = (vm.temp_index, vm.salt_index) if mix and vm.scheme == "pp81" \
        else None
    ops = imx.fb_chain(L, wind=wind, drag=_drag_on(cfg), vmix=mix,
                       uw_h=cfg.flux_thickness_type == "upwind",
                       uw_tr=cfg.flux_tracer_type == "upwind", pp=pp)
    cut = next(i for i, op in enumerate(ops) if op[0] == "u_new") + 1
    tail = ops[cut:]
    solve = [op for op in tail
             if op[0] == "he_new" or op[2].startswith("vmix_")]
    coeffs = [op for op in tail if op not in solve]
    return ops[:cut], coeffs, solve


def split_ops(cfg, L: int):
    """The two chains of the split-explicit step (icos_mega.split_pre_chain,
    split_post_chain): (splitpre, splitpost). Center fluxes only
    (`split_patch_supported`)."""
    if cfg.flux_thickness_type != "center" or \
            cfg.flux_tracer_type != "center":
        raise ValueError("the split chains take center fluxes")
    return imx.split_pre_chain(L), imx.split_post_chain(L)


RK_KINDS = ("rk2a", "rk2b", "rk4s1", "rk4s2", "rk4s3", "rk4s4")


def rk_ops(cfg, L: int, kind: str, wind: bool):
    """The chain of RK stage `kind` (icos_mega.rk2_stage_chain /
    rk4_stage_chain with the options of `cfg`), split into (horizontal,
    coefficients, solve) as `chain_ops` splits the FB chain: the RK stage
    kernel's ops (the tendencies and the stage update, the accumulator's
    included), the PP81 coefficient fields and the column solves (those
    two only at the last stage, rk2b / rk4s4, with vertical mixing)."""
    if kind not in RK_KINDS:
        raise ValueError(f"unknown RK stage kind {kind!r}")
    vm = cfg.vert_mix
    mix = vmix_on(cfg)
    pp = (vm.temp_index, vm.salt_index) if mix and vm.scheme == "pp81" \
        else None
    kw = dict(wind=wind, drag=_drag_on(cfg), vmix=mix,
              uw_h=cfg.flux_thickness_type == "upwind",
              uw_tr=cfg.flux_tracer_type == "upwind", pp=pp)
    if kind.startswith("rk2"):
        ops = (imx.rk2_stage_chain(L, "", 0.5, **kw) if kind == "rk2a"
               else imx.rk2_stage_chain(L, "0", 1.0, **kw))
    else:
        ops = imx.rk4_stage_chain(L, int(kind[4:]), **kw)
    cut = next((i for i, op in enumerate(ops) if op[0] == "he_new"),
               len(ops))
    tail = ops[cut:]
    solve = [op for op in tail
             if op[0] == "he_new" or op[2].startswith("vmix_")]
    coeffs = [op for op in tail if op not in solve]
    return ops[:cut], coeffs, solve


# ----------------------------------------------------------------------
# prep (host side, kept on the mesh's PatchInfo per type and device)

class Prep:
    """What one (mesh, type, device) needs at run time: the mega build,
    the compact table, the const planes, the refresh maps, the pole
    submesh and its row maps. An FCT prep (`prep(..., fct=True)`) holds the
    FCT closure's refresh maps, submesh, row maps and read-out maps in the
    same fields, and its compact table carries the FCT rows."""


def _persist_map(mg, grp, keep, fixg, nel):
    """In-frame refresh map for one element class given a validity keep
    mask (T, 10, S, S) and a fix set: (persist dict, src_of). Positions are
    flat in the class's (T, 10, S, S) frame block of one layer."""
    n, S, mh = mg.n, mg.S, mg.mh
    NG = 10 * n * n
    cont = mg.content[grp]
    T = cont.shape[0]
    ids = cont.reshape(-1)
    keep_f = keep.reshape(-1)
    natural_id = np.full(cont.shape, -1, np.int64)
    natural_id[:, :, mh:mh + n, mh:mh + n] = \
        np.arange(T * NG, dtype=np.int64).reshape(T, 10, n, n)
    is_nat = ((cont == natural_id) & (natural_id >= 0)).reshape(-1)
    src_of = np.full(nel, -1, np.int64)
    sel = np.flatnonzero(keep_f)
    src_of[ids[sel]] = sel               # any valid position...
    sel2 = np.flatnonzero(keep_f & is_nat)
    src_of[ids[sel2]] = sel2             # ...natural one preferred
    isfix = np.zeros(nel, bool)
    isfix[fixg] = True
    refp = np.flatnonzero((ids >= 0) & ~keep_f)
    gref = ids[refp]
    from_fix = isfix[gref]
    # every non-fix refreshed element must be exact SOMEWHERE in the
    # frame — otherwise it belongs in the fix set by construction
    if (src_of[gref[~from_fix]] < 0).any():
        raise RuntimeError(f"{grp}: a refreshed element is exact nowhere")
    persist = dict(
        refill_pos=refp[~from_fix], refill_src=src_of[gref[~from_fix]],
        fix_pos=refp[from_fix],
        fix_row=np.searchsorted(fixg, gref[from_fix]),
        zero_pos=np.flatnonzero(ids < 0))
    return persist, src_of


def compact_table(mg, groups=GROUPS, tables=None):
    """The per-position compact table of a mega build (`tables`: the
    build's own, or those of `groups`): (offs (R_off, P) int32, wts (R_w,
    P) float64). Rows: per group, per destination channel
    td, `slots` rows of offsets, and per table of the group the same rows
    of weights; an offset is ts * P + db * S + da within one layer of the
    source field; unused slots hold offset 0 and weight 0. Slots of a
    position follow the sorted (ts, da, db) order of the reference's
    entries, so a kernel sum runs in the reference's order."""
    S = mg.S
    P = 10 * S * S
    tables = mg.tables if tables is None else tables
    offs, wts = [], []
    for gname, names, ns in groups:
        tabs = [tables[nm] for nm in names]
        Td = NPER[tabs[0].dst_class]
        off = np.zeros((Td * ns, P), np.int32)
        w = np.zeros((len(tabs), Td * ns, P), np.float64)
        for td in range(Td):
            planes = {}
            for i, tab in enumerate(tabs):
                for (t_d, ts, da, db, wpl) in tab.entries:
                    if t_d == td:
                        planes.setdefault((ts, da, db), {})[i] = \
                            wpl.reshape(-1)
            count = np.zeros(P, np.int64)
            for (ts, da, db) in sorted(planes):
                per = planes[(ts, da, db)]
                used = np.zeros(P, bool)
                for pl in per.values():
                    used |= pl != 0.0
                pos = np.flatnonzero(used)
                slot = count[pos]
                if pos.size and slot.max() >= ns:
                    raise RuntimeError(
                        f"table group {gname}: a position needs more than "
                        f"{ns} slots for channel {td}")
                row = td * ns + slot
                off[row, pos] = ts * P + db * S + da
                for i, pl in per.items():
                    w[i, row, pos] = pl[pos]
                count[pos] += 1
        offs.append(off)
        wts.extend(w)
    return np.concatenate(offs), np.concatenate(wts)


def _const_values(mg, consts=CONSTS):
    """name -> python float where the const plane is uniform over live
    content (0.0 where it is identically zero), else the (T, 10, S, S)
    float64 plane — the reference's decision (_prep_build)."""
    out = {}
    for cname, cls in consts:
        cpl = mg.const_planes[cname]
        T = cpl.shape[0]
        live = (mg.content[cls] >= 0).reshape(T, -1)
        vals = cpl.reshape(T, -1)[live]
        if not live.any() or not vals.any():
            out[cname] = 0.0
        elif np.allclose(vals, vals[0]):
            out[cname] = float(vals[0])
        else:
            out[cname] = cpl
    return out


def prep(mesh, dtype, device, fct: bool = False) -> Prep:
    """The run-time data of the patch step for `mesh` in `dtype` on
    `device` (built once, kept on mesh.patch_info); with `fct` the FCT
    prep (`_fct_prep`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = ("prep", dtype, device, bool(fct))
    info = mesh.patch_info
    if key in info.cache:
        return info.cache[key]
    if fct:
        info.cache[key] = _fct_prep(mesh, prep(mesh, dtype, device))
        return info.cache[key]
    mg = imx.ensure_mega(mesh)
    p = Prep()
    p.mg = mg
    p.fct = False
    p.tables = mg.tables
    p.n, p.S, p.mh = mg.n, mg.S, mg.mh
    p.npatch = 10          # the patches the frames hold (parallel/patch_shard)
    p.P = 10 * p.S * p.S
    p.dtype, p.device = dtype, device
    put = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a)).to(
        device=p.device, dtype=dt)
    idx = lambda a: put(a, torch.long)

    # the chain's tables as per-entry weight planes (the plain version)
    p.entries = {name: [(td, ts, da, db, put(wpl))
                        for (td, ts, da, db, wpl) in tab.entries]
                 for name, tab in mg.tables.items()}
    p.consts = {k: (v if isinstance(v, float) else put(v))
                for k, v in _const_values(mg, CONSTS + SPLIT_CONSTS).items()}
    # the splitpre kernel's depth: a (P,) row, or None where it is uniform
    dv = p.consts["depth"]
    p.depth_row = None if isinstance(dv, float) else \
        dv.reshape(p.P).contiguous()

    # the kernel's compact table and const plane rows (the wind rows zero:
    # make_wind fills a copy)
    offs, wts = compact_table(mg)
    p.offs, p.wts = put(offs, torch.int32), put(wts)
    rows, flags, scalars = [], [], []
    for cname, cls in CONSTS:
        v = p.consts[cname]
        flags.append(0 if isinstance(v, float) else 1)
        scalars.append(v if isinstance(v, float) else 0.0)
        rows.append(v.reshape(NPER[cls], p.P) if flags[-1]
                    else torch.zeros((NPER[cls], p.P), dtype=dtype,
                                     device=p.device))
    rows.append(torch.zeros((3, p.P), dtype=dtype, device=p.device))
    p.cpl = torch.cat(rows).contiguous()
    p.const_flags, p.const_scalars = flags, scalars

    # fills of the frames from flat state (frame positions of one layer)
    p.fills = {cls: (idx(mg.fills[cls][0]), idx(mg.fills[cls][1]))
               for cls in ("cell", "edge")}

    # paste-back of the per-step API: rim positions in full-frame coords
    no = p.n + 2 * imx.OH
    p.outputs = {}
    for oname, (rim, rpos, dead, fix) in mg.outputs.items():
        t, rem = np.divmod(rpos.astype(np.int64), 10 * no * no)
        r, rem = np.divmod(rem, no * no)
        yo, xo = np.divmod(rem, no)
        full = ((t * 10 + r) * p.S + yo + p.mh - imx.OH) * p.S \
            + xo + p.mh - imx.OH
        p.outputs[oname] = (idx(rim), idx(full), idx(dead), idx(fix))

    # the pole submesh (an ordinary mesh: the composed stepper's gather
    # path) and its row maps
    p.sub_mesh = mg.sub_mesh.to(p.device, dtype)
    p.sub_cells, p.sub_edges = idx(mg.sub_cells), idx(mg.sub_edges)
    p.fix_cells_local = idx(mg.fix_cells_local)
    p.fix_cells_global = idx(mg.fix_cells_global)
    p.fix_edges_local = idx(mg.fix_edges_local)
    p.fix_edges_global = idx(mg.fix_edges_global)

    # refresh maps (frames as the carry): after the chain, mg.masks say
    # which positions are exact; the rest refill from a valid position of
    # the same element, pole rows come from the submesh, holes re-zero
    p.persist, src_of = {}, {}
    for grp, mask_keys, fixg, nel in (
            ("cell", ("h_new", "trn0"), mg.fix_cells_global, mesh.ncells),
            ("edge", ("u_new",), mg.fix_edges_global, mesh.nedges)):
        keep = mg.content[grp] >= 0
        for k_ in mask_keys:
            keep = keep & mg.masks[k_]
        persist, src_of[grp] = _persist_map(mg, grp, keep, fixg, nel)
        p.persist[grp] = {k: idx(v) for k, v in persist.items()}
    # sub-state gathers (fix rows overwritten from the carried fix rows)
    p.sub_cell_src = idx(np.maximum(src_of["cell"][mg.sub_cells], 0))
    p.sub_edge_src = idx(np.maximum(src_of["edge"][mg.sub_edges], 0))
    # final read-out maps (refreshed frames hold every element somewhere)
    p.cell_src = idx(np.maximum(src_of["cell"], 0))
    p.cell_src_ok = put(src_of["cell"] >= 0, torch.bool)
    p.edge_src = idx(np.maximum(src_of["edge"], 0))
    p.edge_src_ok = put(src_of["edge"] >= 0, torch.bool)
    info.cache[key] = p
    return p


def _prep_for(mesh, cfg, dtype, device) -> Prep:
    """The prep whose fix sets a carry of `cfg` lives on: the FCT prep for
    an FCT configuration, else the FB one."""
    return prep(mesh, dtype, device, fct=cfg.flux_tracer_type == "fct")


def _fct_prep(mesh, base: Prep) -> Prep:
    """The FCT prep: `base` (the FB prep of the same mesh, type and device)
    with the FCT tables (plain entries, and the compact rows of FCT_GROUPS
    appended to the table), and the refresh maps, submesh, row maps and
    read-out maps of the FCT closure (icos_mega.ensure_fct) in place of the
    FB chain's (the reference's _prep_build FCT extension)."""
    fi = imx.ensure_fct(mesh)
    mg = base.mg
    p = copy.copy(base)
    p.fct = True
    put = lambda a, dt=base.dtype: torch.as_tensor(
        np.ascontiguousarray(a)).to(device=base.device, dtype=dt)
    idx = lambda a: put(a, torch.long)
    p.tables = {**mg.tables, **fi["tables"]}
    p.entries = {**base.entries, **{
        name: [(td, ts, da, db, put(wpl))
               for (td, ts, da, db, wpl) in tab.entries]
        for name, tab in fi["tables"].items()}}
    offs, wts = compact_table(mg, FCT_GROUPS, fi["tables"])
    p.offs = torch.cat([base.offs, put(offs, torch.int32)])
    p.wts = torch.cat([base.wts, put(wts)])
    # the per-step API's paste-back is the FB chain's: FCT runs framed only
    p.outputs = None
    p.sub_mesh = fi["sub_mesh"].to(base.device, base.dtype)
    p.sub_cells, p.sub_edges = idx(fi["sub_cells"]), idx(fi["sub_edges"])
    for f in ("fix_cells_local", "fix_cells_global", "fix_edges_local",
              "fix_edges_global"):
        setattr(p, f, idx(fi[f]))
    p.persist, src_of = {}, {}
    for grp, keep, fixg, nel in (
            ("cell", fi["cell_keep"], fi["fix_cells_global"], mesh.ncells),
            ("edge", fi["edge_keep"], fi["fix_edges_global"], mesh.nedges)):
        persist, src_of[grp] = _persist_map(
            mg, grp, (mg.content[grp] >= 0) & keep, fixg, nel)
        p.persist[grp] = {k: idx(v) for k, v in persist.items()}
    p.sub_cell_src = idx(np.maximum(src_of["cell"][fi["sub_cells"]], 0))
    p.sub_edge_src = idx(np.maximum(src_of["edge"][fi["sub_edges"]], 0))
    p.cell_src = idx(np.maximum(src_of["cell"], 0))
    p.cell_src_ok = put(src_of["cell"] >= 0, torch.bool)
    p.edge_src = idx(np.maximum(src_of["edge"], 0))
    p.edge_src_ok = put(src_of["edge"] >= 0, torch.bool)
    return p


# ----------------------------------------------------------------------
# wind

def make_wind(mesh, cfg, wind_stress, dtype):
    """The per-segment wind of the fused step: (cpl, (zonal_sub,
    merid_sub)), or None without wind forcing or without a stress. The
    cell stress is rotated onto the edge normals once
    (aux.wind_normal_stress, WindForcingAuxVars.h:13-40) and laid into the
    edge frames (grid ids and fills) as the three wind rows of a copy of
    the prep's const planes `cpl`; the pole submesh's composed step (FCT:
    the FCT fix submesh's) gets the stress of its own cells, whose
    rotation reproduces the global one on its fix rows."""
    if wind_stress is None or not cfg.tendencies.wind_forcing:
        return None
    zonal, merid = wind_stress
    p = _prep_for(mesh, cfg, dtype, zonal.device)
    stress = auxmod.wind_normal_stress(mesh, cfg, zonal, merid).to(dtype)
    cpl = p.cpl.clone()
    _frames_of(p, "edge", stress[:, None], 3,
               cpl[WIND_ROW:WIND_ROW + 3].view(1, 3, p.P))
    return cpl, (zonal[p.sub_cells], merid[p.sub_cells])


# ----------------------------------------------------------------------
# the chain on frames, plain PyTorch (the counterpart of _eval_chain)

def _safe_div(a, b):
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def _next_layer(x, fill):
    """x at layer k + 1 (layers on dim 0), `fill` past the last layer (the
    reference's lane shift, ops/tridiag._shift)."""
    return torch.cat([x[1:], torch.full_like(x[:1], fill)])


def _upwind(u, a, b):
    """The reference's upwind selection (LayerThicknessAuxVars.h /
    TracerAuxVars.h): a where u > 0, b where u < 0, max(a, b) at rest."""
    return torch.where(u > 0, a, torch.where(u < 0, b, torch.maximum(a, b)))


def _pp81(vm, ri):
    """(nu0 / f^n_exp, f), f = 1 + alpha max(ri, 0); the power by repeated
    multiplication, as the kernel takes it."""
    f = 1.0 + vm.alpha * torch.clamp(ri, min=0.0)
    return vm.nu0 / vmix_kernel._ipow(f, vm.n_exp), f


def _column_mix(h, phi, kappa, dt):
    """Backward-Euler vertical diffusion of phi against the thickness h
    (layers on dim 0) by PCR (ops/tridiag.pcr, the reference's
    _pcr_diffusion level for level): G = dt kappa / dz above the bottom
    interface, 0 at it. A column whose thickness is not positive at every
    layer keeps phi."""
    dz = 0.5 * (h + _next_layer(h, 1.0))
    K = h.shape[0]
    last = (torch.arange(K, device=h.device) == K - 1).view(
        (K,) + (1,) * (h.dim() - 1))
    g = torch.where(last, torch.zeros_like(h), dt * kappa / dz)
    mixed = tridiag.diffusion_solve(g.movedim(0, -1), h.movedim(0, -1),
                                    (h * phi).movedim(0, -1),
                                    "pcr").movedim(-1, 0)
    return torch.where((h > 0).all(0, keepdim=True), mixed, phi)


def _eval(p, cfg, ops, vals, dt, wind_planes=None):
    """Run the chain ops on `vals` (name -> (K, T, npatch, S, S); npatch = 10
    except on a shard of parallel/patch_shard.py), each stencil
    a sum of roll-shifted sources times weight planes in the reference's
    entry order; returns `vals`."""
    tc, vm = cfg.tendencies, cfg.vert_mix
    dt, grav = float(dt), float(cfg.gravity)
    nu2, nu4, dfac = tc.visc_del2, tc.visc_del4, tc.div_factor
    ed2, ed4 = tc.eddy_diff2, tc.eddy_diff4
    S = p.S

    def ap(tname, src):
        Td = NPER[p.tables[tname].dst_class]
        outs = [None] * Td
        for (td, ts, da, db, w) in p.entries[tname]:
            term = w * torch.roll(src[:, ts], shifts=(-db, -da),
                                  dims=(-2, -1))
            outs[td] = term if outs[td] is None else outs[td] + term
        zero = src.new_zeros(src.shape[:1] + (p.npatch, S, S))
        return torch.stack([o if o is not None else zero for o in outs], 1)

    def c(name):
        if name == "wind_stress":
            return wind_planes[None]
        v = p.consts[name]
        return v if isinstance(v, float) else v[None]

    def mask_or_one(name):
        v = p.consts[name]
        return None if isinstance(v, float) and v == 1.0 else c(name)

    for op in ops:
        name, kind = op[0], op[1]
        if kind == "st":
            vals[name] = ap(op[2], vals[op[3]])
            continue
        fn, a = op[2], op[3:]
        v = lambda i: vals[a[i]]
        if fn == "mul":
            r = v(0) * v(1)
        elif fn == "sub":
            r = v(0) - v(1)
        elif fn == "copy":
            r = v(0)
        elif fn == "mean2":                  # 0.5 * (a + b)
            r = 0.5 * (v(0) + v(1))
        elif fn == "upwind":                 # sel(u, a, b)
            r = _upwind(v(0), v(1), v(2))
        elif fn == "upwind_prod":            # sel(u, a*b, c*d)
            r = _upwind(v(0), v(1) * v(2), v(3) * v(4))
        elif fn == "mulc":                   # x * const; alias when 1.0
            m = mask_or_one(a[1][1:])
            r = v(0) if m is None else v(0) * m
        elif fn == "sub_mc":                 # mask*x - y
            m = mask_or_one(a[2][1:])
            r = v(0) - v(1) if m is None else m * v(0) - v(1)
        elif fn == "axpy":                   # x + dt * coef * y
            r = v(0) + dt * a[1] * v(2)
        elif fn == "axpy_m":                 # x + dt*coef*(mask*y)
            m = mask_or_one(a[3][1:])
            y = v(2) if m is None else m * v(2)
            r = v(0) + dt * a[1] * y
        elif fn == "tracer_rhs":             # -adv + ed2*diff2 - ed4*hyp
            r = -v(0) + ed2 * v(1) - ed4 * v(2)
        elif fn == "tracer_update":          # (tr*h + dt*dtr) / h_new
            r = _safe_div(v(0) * v(1) + dt * v(2), v(3))
        elif fn == "tracer_updc":            # (tr*h + coef*dt*dtr) / h_new
            r = _safe_div(v(0) * v(1) + a[4] * dt * v(2), v(3))
        elif fn == "tracer_acc0":            # tr*h + coef*dt*dtr
            r = v(0) * v(1) + a[3] * dt * v(2)
        elif fn == "tracer_fin":             # (acc + coef*dt*dtr) / h_new
            r = _safe_div(v(0) + a[3] * dt * v(1), v(2))
        elif fn == "upwind_mean":            # core/fct's upwind pick, the
            r = torch.where(v(0) > 0, v(1),  # mean at rest
                            torch.where(v(0) < 0, v(2), 0.5 * (v(1) + v(2))))
        elif fn == "max2":
            r = torch.maximum(v(0), v(1))
        elif fn == "min2":
            r = torch.minimum(v(0), v(1))
        elif fn == "relu":                   # the positive part B+
            r = torch.clamp(v(0), min=0.0)
        elif fn == "relu_neg":               # the negative part B-
            r = torch.clamp(-v(0), min=0.0)
        elif fn == "diff_rhs":               # ed2*diff2 - ed4*hyp
            r = ed2 * v(0) - ed4 * v(1)
        elif fn == "fct_p":                  # dt * (x + y): flux budgets
            r = dt * (v(0) + v(1))
        elif fn == "fct_q":                  # (x - y) * h_new: room to bounds
            r = (v(0) - v(1)) * v(2)
        elif fn == "fct_r":                  # clip(q / max(p, eps), 0, 1)
            r = torch.clamp(v(0) / torch.clamp(v(1), min=1e-30), 0.0, 1.0)
        elif fn == "fct_corr":               # f_lo + C_e * a: limited flux
            r = v(1) + torch.where(v(0) >= 0, torch.minimum(v(3), v(4)),
                                   torch.minimum(v(2), v(5))) * v(0)
        elif fn == "q_vertex":               # (rvort + f) / h_v
            r = _safe_div(v(0) + c(a[1][1:]), v(2))
        elif fn == "pv":                     # 0.5 * (q_e*tf + tfq)
            r = 0.5 * (v(0) * v(1) + v(2))
        elif fn == "gssh":                   # du - g*(gh - gdepth)
            r = v(0) - grav * (v(1) - c(a[2][1:]))
        elif fn == "ssh_col":    # sum_k h - depth, one value per column,
            h, acc = v(0), v(0)[0]           # summed layer by layer as the
            for k in range(1, h.shape[0]):   # kernel sums it
                acc = acc + h[k]
            r = acc[None] - c(a[1][1:])
        elif fn == "gssh_col":               # du - g*gh (column ssh)
            r = v(0) - grav * v(1)
        elif fn == "visc2":                  # du + nu2*s2*(cdd - vdr)
            r = v(0) + nu2 * c(a[3][1:]) * (v(1) - v(2))
        elif fn == "visc4":                  # du - nu4*s4*(df*cd4 - vd4)
            r = v(0) - nu4 * c(a[3][1:]) * (dfac * v(1) - v(2))
        elif fn == "wind":                   # du[0] += stress/(rho0 mean_hn)
            r = v(0).clone()
            r[0] += _safe_div(c(a[2][1:])[0], tc.density0 * v(1)[0])
        elif fn == "drag":       # du[K-1] -= cd sqrt(2 kee) u / mean_hn
            r = v(0).clone()
            kee, mh, u = v(1)[-1], v(2)[-1], v(3)[-1]
            r[-1] += -_safe_div(tc.bottom_drag_coeff * torch.sqrt(
                torch.clamp(2.0 * kee, min=0.0)) * u, mh)
        elif fn == "lanediff":               # u_k - u_{k+1}
            r = v(0) - _next_layer(v(0), 0.0)
        elif fn == "dzhalf":                 # 0.5 * (h_k + h_{k+1})
            r = 0.5 * (v(0) + _next_layer(v(0), 1.0))
        elif fn == "zero_like":
            r = torch.zeros_like(v(0))
        elif fn == "pp_n2":      # max(g (aT dT - bS dS) / dz, 0), hole-safe
            T, S_, dz = v(0), v(1), v(2)
            db = grav * (vm.eos_alpha_t * (T - _next_layer(T, 0.0))
                         - vm.eos_beta_s * (S_ - _next_layer(S_, 0.0)))
            r = torch.clamp(_safe_div(db, dz), min=0.0)
        elif fn == "pp_kc":      # kappa at cells from (n2, ke(du^2), dz)
            shear2 = 2.0 * v(1) / (v(2) * v(2))
            nu, f = _pp81(vm, v(0) / torch.clamp(shear2, min=vmix_kernel.EPS))
            r = nu / f + vm.kappa_tracer
        elif fn == "pp_ne":      # nu at edges from (n2_e, du, dz_e)
            shear2 = (v(1) / v(2)) ** 2
            nu, _ = _pp81(vm, v(0) / torch.clamp(shear2, min=vmix_kernel.EPS))
            r = nu + vm.kappa_momentum
        elif fn in ("vmix_u", "vmix_c", "vmix_u_arr", "vmix_c_arr"):
            kappa = v(2) if fn.endswith("_arr") else (
                vm.kappa_momentum if fn == "vmix_u" else vm.kappa_tracer)
            r = _column_mix(v(1), v(0), kappa, dt)
        else:
            raise ValueError(fn)
        vals[name] = r
    return vals


_TRACER_NAME = {"": "tr", "_new": "trn", "0": "tr0", "_a": "tra"}


def _vals(p, frames, prefix=""):
    """The frames' channels as chain values: h, u (the three edge classes)
    and tr{l}, with `prefix` "" (h, u, tr{l}), "_new" (h_new, u_new,
    trn{l}), "0" (the RK stages' original state h0, u0, tr0{l}) or "_a"
    (their accumulator h_a, u_a, tra{l})."""
    K, CH, P = frames.shape
    fr = frames.reshape(K, CH, p.npatch, p.S, p.S)
    t = _TRACER_NAME[prefix]
    vals = {"h" + prefix: fr[:, 0:1], "u" + prefix: fr[:, 1:4]}
    for l in range(CH - 4):
        vals[f"{t}{l}"] = fr[:, 4 + l:5 + l]
    return vals


def _frames_out(vals, K, CH, P, out, names=("h_new", "u_new", "trn")):
    h, u, t = names
    res = torch.cat([vals[h], vals[u]]
                    + [vals[f"{t}{l}"] for l in range(CH - 4)], 1)
    res = res.reshape(K, CH, P)
    if out is None:
        return res
    out.copy_(res)
    return out


def _wind_planes(p, wind):
    return None if wind is None else \
        wind[0][WIND_ROW:WIND_ROW + 3].view(3, p.npatch, p.S, p.S)


def chain_plain(p, cfg, frames, dt, out=None, wind=None):
    """The plain PyTorch version of the patch kernel: the horizontal part
    of the chain (through u_new; `chain_ops`) at every position of the
    (K, 4+L, P) frames. `wind` is a `make_wind` bundle or None. Returns
    (K, 4+L, P): h_new, u_new x3, trn x L."""
    K, CH, P = frames.shape
    ops = chain_ops(cfg, CH - 4, wind is not None)[0]
    vals = _eval(p, cfg, ops, _vals(p, frames), dt, _wind_planes(p, wind))
    return _frames_out(vals, K, CH, P, out)


def vmix_coeffs_plain(p, cfg, frames):
    """The plain version of the PP81 coefficient kernel on the frames the
    horizontal chain made (h_new, u_new, trn): (K, 4, P), channel 0 kappa
    at the cells, 1..3 nu at the edge classes; layer K-1 is not used."""
    K, CH, P = frames.shape
    vals = _eval(p, cfg, chain_ops(cfg, CH - 4, False)[1],
                 _vals(p, frames, "_new"), dt=0.0)
    return torch.cat([vals["kapc"], vals["nue"]], 1).reshape(K, 4, P)


def vmix_solve_plain(p, cfg, frames, dt, coef=None, out=None):
    """The plain version of the column-solve kernel, out of place: the
    tracers against h_new and the edge classes of u against cmean(h_new),
    with the constant coefficients of cfg.vert_mix, or with `coef` from
    `vmix_coeffs_plain` / `vmix_coeffs` for PP81."""
    K, CH, P = frames.shape
    vals = _vals(p, frames, "_new")
    if coef is not None:
        cf = coef.reshape(K, 4, p.npatch, p.S, p.S)
        vals.update(kapc=cf[:, 0:1], nue=cf[:, 1:4])
    vals = _eval(p, cfg, chain_ops(cfg, CH - 4, False)[2], vals, dt)
    return _frames_out(vals, K, CH, P, out)


def step_plain(p, cfg, frames, dt, wind=None):
    """The whole chain of `cfg` on the frames in one evaluation (the
    three kernels' plain versions in a row)."""
    K, CH, P = frames.shape
    ops = sum(chain_ops(cfg, CH - 4, wind is not None), [])
    vals = _eval(p, cfg, ops, _vals(p, frames), dt, _wind_planes(p, wind))
    return _frames_out(vals, K, CH, P, None)


def fct_a_plain(p, cfg, frames, dt, out=None, wind=None):
    """The plain PyTorch version of FCT's stage A kernel on the (K, 4+L, P)
    frames of an FCT prep `p`: returns (K, 4+2L, P) in the reference's
    layout, h_new, u_new x3, then trtd{l} at 4+2l and facc{l} at 5+2l."""
    K, CH, P = frames.shape
    L = CH - 4
    vals = _eval(p, cfg, fct_ops(cfg, L, wind is not None)[0],
                 _vals(p, frames), dt, _wind_planes(p, wind))
    res = torch.cat([vals["h_new"], vals["u_new"]]
                    + [vals[f"{nm}{l}"] for l in range(L)
                       for nm in ("trtd", "facc")], 1).reshape(K, 4 + 2 * L, P)
    if out is None:
        return res
    out.copy_(res)
    return out


def _mid_vals(p, mid, frames):
    """The chain values of stage B: the original frames' h, u, tr{l} and
    the refreshed stage-A fields h_new, trtd{l}, facc{l} of `mid`."""
    K, CH, P = frames.shape
    vals = _vals(p, frames)
    m = mid.reshape(K, mid.shape[1], p.npatch, p.S, p.S)
    vals["h_new"] = m[:, 0:1]
    for l in range(CH - 4):
        vals[f"trtd{l}"] = m[:, 4 + 2 * l:5 + 2 * l]
        vals[f"facc{l}"] = m[:, 5 + 2 * l:6 + 2 * l]
    return vals


def fct_b_plain(p, cfg, mid, frames, dt):
    """The plain version of FCT's stage B kernel (the Zalesak limiter) from
    the refreshed stage-A output `mid` (K, 4+2L, P) and the original
    frames (K, 4+L, P): the new tracers trn{l}, (K, L, P)."""
    K, CH, P = frames.shape
    L = CH - 4
    vals = _eval(p, cfg, fct_ops(cfg, L, False)[1],
                 _mid_vals(p, mid, frames), dt)
    return torch.cat([vals[f"trn{l}"] for l in range(L)], 1).reshape(K, L, P)


def rk_stage_plain(p, cfg, mode, ca, cb, ev, base=None, acc=None,
                   wind=None):
    """The plain PyTorch version of one RK stage on the (K, 4+L, P) frames:
    every tendency at the level `ev`, then the update of `mode` (RK_PROV
    ... RK_LAST) against `base` (the step's initial frames) and `acc` (the
    accumulator, thickness-weighted tracers), with ca = a dt and cb = b dt
    (icos_mega.rk_stage_ops; the coefficients are the chain's literals, so
    it runs at dt = 1). `wind` is a `make_wind` bundle or None. Returns
    (acc_out or None, out)."""
    K, CH, P = ev.shape
    ops = imx.rk_stage_ops(CH - 4, _MODE_NAME[mode], "0", ca, cb,
                           wind is not None, _drag_on(cfg),
                           cfg.flux_thickness_type == "upwind",
                           cfg.flux_tracer_type == "upwind")
    vals = _vals(p, ev)
    if mode != RK_LAST:
        vals.update(_vals(p, base, "0"))
    if mode in (RK_MID, RK_LAST):
        vals.update(_vals(p, acc, "_a"))
    vals = _eval(p, cfg, ops, vals, 1.0, _wind_planes(p, wind))
    acc_out = None
    if mode in (RK_FIRST, RK_MID):
        acc_out = _frames_out(vals, K, CH, P, None,
                              ("h_acc", "u_acc", "tracc"))
    return acc_out, _frames_out(vals, K, CH, P, None)


def split_pre_plain(p, cfg, frames):
    """The plain PyTorch version of the splitpre kernel: the full velocity
    tendency with the column free surface (icos_mega.split_pre_chain) at
    every position of the (K, 4+L, P) frames, ungated, as the reference's
    kernel emits it. Returns du_out, (K, 3, P)."""
    K, CH, P = frames.shape
    vals = _eval(p, cfg, split_ops(cfg, CH - 4)[0], _vals(p, frames), 0.0)
    return vals["du_out"].reshape(K, 3, P)


def split_post_plain(p, cfg, frames, dt):
    """The plain PyTorch version of the splitpost kernel: the thickness and
    tracer advance (icos_mega.split_post_chain) of the (K, 4+L, P) frames
    whose u channels hold the transport velocity. Returns (K, 1+L, P):
    h_new, then trn{l}."""
    K, CH, P = frames.shape
    L = CH - 4
    vals = _eval(p, cfg, split_ops(cfg, L)[1], _vals(p, frames), dt)
    return torch.cat([vals["h_new"]] + [vals[f"trn{l}"] for l in range(L)],
                     1).reshape(K, 1 + L, P)


# ----------------------------------------------------------------------
# the kernels

_FLUX = {"center": "c", "upwind": "u"}


def _suffix(frames):
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(frames.dtype)
    if suffix is None:
        raise TypeError(f"patch kernels take float32/float64, not "
                        f"{frames.dtype}")
    return suffix


def _check(p, frames, out, work, out_ch=None, work_n=None):
    K, CH, P = frames.shape
    if frames.dtype != p.dtype or frames.device != p.device:
        raise TypeError("frames must match the prep's type and device")
    out_ch = CH if out_ch is None else out_ch
    work_n = work_fields(CH - 4) if work_n is None else work_n
    for a, shape, name in ((frames, (K, CH, p.P), "frames"),
                           (out, (K, out_ch, p.P), "out"),
                           (work, (work_n * K * p.P,), "work")):
        if (tuple(a.shape) != shape or a.dtype != frames.dtype
                or a.device != frames.device or not a.is_contiguous()):
            raise ValueError(f"`{name}` must be a contiguous {shape} array "
                             "of the frames' type and device")
    if out.data_ptr() == frames.data_ptr():
        raise ValueError("the patch step cannot write its input frames")


def _rows_ok(lib, p):
    rows = lib.omega_patch_fct_rows if p.fct else lib.omega_patch_rows
    if rows(0) != p.offs.shape[0] or rows(1) != p.wts.shape[0] \
            or lib.omega_patch_rows(2) != p.cpl.shape[0]:
        raise RuntimeError("patch kernels: table layout differs between "
                           "kernel and host")


def _fb_args(p, cfg, frames, dt, wind, tracer):
    """(entry point, const planes, consts, ints) of the patch step's call
    for the thickness flux and tails of `cfg` and the tracer-flux variant
    `tracer` ("c", "u", or "f" for FCT's stage A); the RK stage's call
    takes the same with its ca in place of dt."""
    K, CH, P = frames.shape
    cpl = p.cpl if wind is None else wind[0]
    if cpl.shape != p.cpl.shape or cpl.dtype != p.dtype \
            or cpl.device != p.device:
        raise ValueError("the wind's const planes must match the prep's")
    tc = cfg.tendencies
    drag = _drag_on(cfg)
    consts = np.array([float(dt), cfg.gravity, tc.visc_del2, tc.visc_del4,
                       tc.div_factor, tc.eddy_diff2, tc.eddy_diff4]
                      + list(p.const_scalars)
                      + [tc.density0, tc.bottom_drag_coeff if drag else 0.0],
                      np.float64)
    ints = np.array([P, p.S, K, CH - 4, LAYERS_PER_THREAD, THREADS]
                    + list(p.const_flags) + [int(wind is not None),
                                             int(drag)], np.int32)
    name = (f"omega_patch_fb_{_FLUX[cfg.flux_thickness_type]}"
            f"{tracer}_"
            f"{'tails' if wind is not None or drag else 'plain'}_"
            f"{_suffix(frames)}")
    return name, cpl, consts, ints


def chain(p, cfg, frames, dt, out=None, work=None, wind=None):
    """The horizontal part of the chain on the (K, 4+L, P) frames into
    `out`. For a CUDA array one C call launches the PASSES kernels of the
    patch step's variant for the flux types and tails of `cfg` on
    PyTorch's current stream (`work`: scratch of work_fields(L) fields,
    made here when not given; `wind`: a `make_wind` bundle); for a CPU
    array the plain version runs."""
    global launches
    if cfg.flux_tracer_type not in _FLUX:
        raise ValueError(f"the patch step's chain takes center or upwind "
                         f"tracer fluxes, not {cfg.flux_tracer_type!r} "
                         "(FCT: fct_a / fct_b)")
    if not frames.is_cuda:
        return chain_plain(p, cfg, frames, dt, out, wind)
    K, CH, P = frames.shape
    out = torch.empty_like(frames) if out is None else out
    if work is None:
        work = frames.new_empty(work_fields(CH - 4) * K * P)
    _check(p, frames, out, work)
    lib = _build.load()
    _rows_ok(lib, p)
    name, cpl, consts, ints = _fb_args(p, cfg, frames, dt, wind,
                                       _FLUX[cfg.flux_tracer_type])
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            frames.data_ptr(), out.data_ptr(), p.offs.data_ptr(),
            p.wts.data_ptr(), cpl.data_ptr(), work.data_ptr(),
            consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "patch step launch")
    launches += PASSES
    return out


def _check_fct(p, cfg):
    if cfg.flux_tracer_type != "fct" or not p.fct:
        raise ValueError("FCT's stages take an FCT configuration and an FCT "
                         "prep (`prep(..., fct=True)`)")


def fct_a(p, cfg, frames, dt, out=None, work=None, wind=None):
    """FCT's stage A on the (K, 4+L, P) frames of an FCT prep `p` into
    `out` (K, 4+2L, P), laid out as `fct_a_plain`'s. For a CUDA array one C
    call launches the PASSES kernels of the patch step's FCT variant
    (csrc/patch_step_cf.cu / _uf.cu by the thickness flux, with the tails
    when `wind` is given or drag is on) on PyTorch's current stream (`work`
    as for `chain`); for a CPU array the plain version runs."""
    global fct_a_launches
    _check_fct(p, cfg)
    if not frames.is_cuda:
        return fct_a_plain(p, cfg, frames, dt, out, wind)
    K, CH, P = frames.shape
    if out is None:
        out = frames.new_empty((K, 2 * CH - 4, P))
    if work is None:
        work = frames.new_empty(work_fields(CH - 4) * K * P)
    _check(p, frames, out, work, out_ch=2 * CH - 4)
    lib = _build.load()
    _rows_ok(lib, p)
    name, cpl, consts, ints = _fb_args(p, cfg, frames, dt, wind, "f")
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            frames.data_ptr(), out.data_ptr(), p.offs.data_ptr(),
            p.wts.data_ptr(), cpl.data_ptr(), work.data_ptr(),
            consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "FCT stage A launch")
    fct_a_launches += PASSES
    return out


def _fct_b_args(p, cfg, mid, frames, dt, out, work):
    """(entry point, consts, ints, work) of stage B's call, after the
    checks: shapes, types and devices, and `out` not aliasing `mid`."""
    _check_fct(p, cfg)
    K, CH, P = frames.shape
    L = CH - 4
    if work is None or work.numel() < fct_b_work_fields(L) * K * P:
        work = frames.new_empty(fct_b_work_fields(L) * K * P)
    work = work[:fct_b_work_fields(L) * K * P]
    _check(p, frames, out, work, work_n=fct_b_work_fields(L))
    _check(p, frames, mid, work, out_ch=2 * CH - 4,
           work_n=fct_b_work_fields(L))
    if out.data_ptr() == mid.data_ptr():
        raise ValueError("stage B cannot write its input")
    em = p.consts["edge_mask"]
    consts = np.array([float(dt), em if isinstance(em, float) else 0.0],
                      np.float64)
    ints = np.array([P, p.S, K, L, LAYERS_PER_THREAD, THREADS,
                     0 if isinstance(em, float) else 1], np.int32)
    name = (f"omega_patch_fct_b_{_FLUX[cfg.flux_thickness_type]}_"
            f"{_suffix(frames)}")
    return name, consts, ints, work


def fct_b(p, cfg, mid, frames, dt, out, work=None):
    """FCT's stage B: the new tracers from the refreshed stage-A output
    `mid` (K, 4+2L, P) and the original frames (K, 4+L, P), written into
    channels 4.. of `out` (K, 4+L, P; the other channels are left as they
    are). For a CUDA array one C call launches the FCT_B_PASSES kernels of
    csrc/patch_fct.cu on PyTorch's current stream (`work`: scratch of
    fct_b_work_fields(L) fields, made here when not given); for a CPU
    array the plain version runs."""
    global fct_b_launches
    _check_fct(p, cfg)
    if not frames.is_cuda:
        out[:, 4:] = fct_b_plain(p, cfg, mid, frames, dt)
        return out
    name, consts, ints, work = _fct_b_args(p, cfg, mid, frames, dt, out,
                                           work)
    lib = _build.load()
    _rows_ok(lib, p)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            mid.data_ptr(), frames.data_ptr(), out.data_ptr(),
            p.offs.data_ptr(), p.wts.data_ptr(), p.cpl.data_ptr(),
            work.data_ptr(), consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "FCT stage B launch")
    fct_b_launches += FCT_B_PASSES
    return out


_RK_NEEDS = {RK_PROV: ("base",), RK_FIRST: ("base", "acc_out"),
             RK_MID: ("base", "acc", "acc_out"), RK_LAST: ("acc",)}


def rk_stage(p, cfg, mode, ca, cb, ev, out, base=None, acc=None,
             acc_out=None, work=None, wind=None):
    """One RK stage on the (K, 4+L, P) frames `ev` into `out`: every
    tendency at `ev`, then the update of `mode` (RK_PROV ... RK_LAST, see
    `rk_stage_plain`) with ca = a dt and cb = b dt, writing RK_FIRST's and
    RK_MID's accumulator into `acc_out`. For a CUDA array one C call
    launches the RK_PASSES kernels of csrc/patch_rk.cuh (the variant for
    the flux types of `cfg`, with the tails when `wind` is given or drag is
    on) on PyTorch's current stream (`work`: scratch of rk_work_fields(L)
    fields, made here when not given); for a CPU array the plain version
    runs. `out` must alias none of `ev` (read at neighbours), `base`,
    `acc` and `acc_out`; `acc_out` may be `acc` (a position reads and
    writes only its own value). Returns `out`."""
    global rk_launches
    if cfg.flux_tracer_type not in _FLUX or p.fct:
        raise ValueError("the RK stages take center or upwind tracer fluxes "
                         "and an FB prep: FCT needs the thickness-first "
                         "order of the forward-backward step")
    arrays = dict(base=base, acc=acc, acc_out=acc_out)
    for name in _RK_NEEDS[mode]:
        if arrays[name] is None:
            raise ValueError(f"RK stage mode {mode} needs `{name}`")
    if any(a is not None and a.data_ptr() == out.data_ptr()
           for a in (ev, base, acc, acc_out)):
        raise ValueError("an RK stage writes `out` out of place")
    if not ev.is_cuda:
        acc_new, res = rk_stage_plain(p, cfg, mode, ca, cb, ev, base, acc,
                                      wind)
        if acc_new is not None:
            acc_out.copy_(acc_new)
        out.copy_(res)
        return out
    K, CH, P = ev.shape
    if work is None:
        work = ev.new_empty(rk_work_fields(CH - 4) * K * P)
    _check(p, ev, out, work, work_n=rk_work_fields(CH - 4))
    ptrs = {}
    for name in ("base", "acc", "acc_out"):
        a = arrays[name] if name in _RK_NEEDS[mode] else None
        if a is not None and (a.shape != ev.shape or a.dtype != ev.dtype
                              or a.device != ev.device
                              or not a.is_contiguous()):
            raise ValueError(f"`{name}` must be a contiguous array like "
                             "the frames")
        ptrs[name] = None if a is None else a.data_ptr()
    lib = _build.load()
    _rows_ok(lib, p)
    name, cpl, consts, ints = _fb_args(p, cfg, ev, ca, wind,
                                       _FLUX[cfg.flux_tracer_type])
    name = name.replace("omega_patch_fb_", "omega_patch_rk_")
    consts = np.append(consts, float(cb))
    ints = np.append(ints, int(mode)).astype(np.int32)
    with torch.cuda.device(ev.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            ev.data_ptr(), ptrs["base"], ptrs["acc"], ptrs["acc_out"],
            out.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
            cpl.data_ptr(), work.data_ptr(), consts.ctypes.data,
            ints.ctypes.data, stream)
    _build.check(code, "RK stage launch")
    rk_launches += RK_PASSES
    return out


def _attrs(fn, *args):
    got = np.zeros(3, np.int32)
    _build.check(fn(*args, got.ctypes.data), "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes"),
                    map(int, got)))


def _pass_attrs(fn, names):
    out = {}
    for i, name in enumerate(names):
        got = np.zeros(4, np.int32)
        _build.check(fn(i, THREADS, got.ctypes.data), "cudaFuncGetAttributes")
        out[name] = dict(zip(("num_regs", "local_bytes", "shared_bytes",
                              "blocks_per_sm"), map(int, got)))
    return out


def fb_pass_attrs(cfg, dtype, tails):
    """{pass name: cudaFuncGetAttributes' numRegs, localSizeBytes (the
    spill), sharedSizeBytes, and the blocks of THREADS threads an SM holds}
    of the FB step's kernels (FCT's stage A for an FCT `cfg`) for the flux
    types of `cfg`, with or without the tails, in `dtype`."""
    lib = _build.load()
    tr = "f" if cfg.flux_tracer_type == "fct" \
        else _FLUX[cfg.flux_tracer_type]
    fn = getattr(lib, f"omega_patch_fb_attrs_"
                      f"{_FLUX[cfg.flux_thickness_type]}{tr}_"
                      f"{'tails' if tails else 'plain'}_"
                      f"{_suffix(torch.empty(0, dtype=dtype))}")
    return _pass_attrs(fn, FB_PASS_NAMES)


def split_post_attrs(dtype):
    """fb_pass_attrs of splitpost's kernels (the FB step's passes A, B, C
    and D1 with the momentum compiled out) in `dtype`."""
    lib = _build.load()
    fn = getattr(lib, f"omega_patch_split_post_attrs_"
                      f"{_suffix(torch.empty(0, dtype=dtype))}")
    return _pass_attrs(fn, FB_PASS_NAMES[:SPLIT_POST_PASSES])


def fct_b_attrs(cfg, dtype):
    """fb_pass_attrs of stage B's kernels (FCT_B_PASS_NAMES) for the
    thickness flux of `cfg` in `dtype`."""
    lib = _build.load()
    fn = getattr(lib, f"omega_patch_fct_b_attrs_"
                      f"{_FLUX[cfg.flux_thickness_type]}_"
                      f"{_suffix(torch.empty(0, dtype=dtype))}")
    return _pass_attrs(fn, FCT_B_PASS_NAMES)


def rk_pass_attrs(cfg, dtype, tails):
    """{pass name: cudaFuncGetAttributes' numRegs, localSizeBytes (the
    spill) and sharedSizeBytes} of the RK stage's kernels for the flux
    types of `cfg`, with or without the tails, in `dtype`."""
    lib = _build.load()
    fn = getattr(lib, f"omega_patch_rk_attrs_"
                      f"{_FLUX[cfg.flux_thickness_type]}"
                      f"{_FLUX[cfg.flux_tracer_type]}_"
                      f"{'tails' if tails else 'plain'}_"
                      f"{_suffix(torch.empty(0, dtype=dtype))}")
    return {name: _attrs(fn, i) for i, name in enumerate(RK_PASS_NAMES)}


def split_pre_attrs(dtype):
    """{pass name: numRegs, localSizeBytes, sharedSizeBytes} of splitpre's
    kernels in `dtype`."""
    lib = _build.load()
    fn = getattr(lib, f"omega_patch_split_pre_attrs_"
                      f"{_suffix(torch.empty(0, dtype=dtype))}")
    # the C call numbers the column pass 0 and the RK stage's pass i 1 + i
    return {name: _attrs(fn, 0 if name == "ssh" else
                         1 + RK_PASS_NAMES.index(name))
            for name in SPLIT_PRE_PASS_NAMES}


def _split_call(name, p, cfg, frames, out, work, dt, extra):
    """One C call of csrc/patch_split.cu: entry `name` with the patch step's
    consts and ints (`_fb_args`) and `extra` (pointers after cpl)."""
    _check(p, frames, out, work, out_ch=out.shape[1],
           work_n=split_work_fields(frames.shape[1] - 4))
    lib = _build.load()
    _rows_ok(lib, p)
    _, cpl, consts, ints = _fb_args(p, cfg, frames, dt, None, "c")
    dv = p.consts["depth"]
    consts = np.append(consts, dv if isinstance(dv, float) else 0.0)
    ints = np.append(ints, int(p.depth_row is not None)).astype(np.int32)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"{name}_{_suffix(frames)}")(
            frames.data_ptr(), out.data_ptr(), p.offs.data_ptr(),
            p.wts.data_ptr(), cpl.data_ptr(), *extra, work.data_ptr(),
            consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, f"{name} launch")


def _check_split(p, cfg):
    if p.fct or cfg.flux_thickness_type != "center" \
            or cfg.flux_tracer_type != "center":
        raise ValueError("the split kernels take center fluxes and an FB "
                         "prep")


def split_pre(p, cfg, frames, out=None, work=None):
    """splitpre on the (K, 4+L, P) frames: du_out (K, 3, P), ungated (see
    `split_pre_plain`). For a CUDA array one C call launches the
    SPLIT_PRE_PASSES kernels of csrc/patch_split.cu (the column free
    surface, then the momentum passes of csrc/patch_rk.cuh) on PyTorch's
    current stream (`work`: scratch of split_work_fields(L) fields, made
    here when not given); for a CPU array the plain version runs."""
    global split_pre_launches
    _check_split(p, cfg)
    if not frames.is_cuda:
        res = split_pre_plain(p, cfg, frames)
        if out is None:
            return res
        out.copy_(res)
        return out
    K, CH, P = frames.shape
    out = frames.new_empty((K, 3, P)) if out is None else out
    if work is None:
        work = frames.new_empty(split_work_fields(CH - 4) * K * P)
    _split_call("omega_patch_split_pre", p, cfg, frames, out, work, 0.0,
                (None if p.depth_row is None else p.depth_row.data_ptr(),))
    split_pre_launches += SPLIT_PRE_PASSES
    return out


def split_post(p, cfg, frames, dt, out, work=None):
    """splitpost on the (K, 4+L, P) frames whose u channels hold the
    transport velocity: h_new and trn{l} into channels 0 and 4.. of `out`
    (K, 4+L, P; its u channels are left as they are). For a CUDA array one C
    call launches the SPLIT_POST_PASSES kernels of csrc/patch_split.cu (the
    thickness and tracer passes of csrc/patch_step.cuh) on PyTorch's current
    stream (`work` as for `split_pre`); for a CPU array the plain version
    runs. `out` must not be `frames` (read at neighbours)."""
    global split_post_launches
    _check_split(p, cfg)
    if out.data_ptr() == frames.data_ptr():
        raise ValueError("splitpost writes `out` out of place")
    if not frames.is_cuda:
        res = split_post_plain(p, cfg, frames, dt)
        out[:, :1] = res[:, :1]
        out[:, 4:] = res[:, 1:]
        return out
    K, CH, P = frames.shape
    if work is None:
        work = frames.new_empty(split_work_fields(CH - 4) * K * P)
    _split_call("omega_patch_split_post", p, cfg, frames, out, work, dt, ())
    split_post_launches += SPLIT_POST_PASSES
    return out


def _vmix_args(p, cfg, frames, dt):
    vm = cfg.vert_mix
    K, CH, P = frames.shape
    L = CH - 4
    if vm.temp_index >= L or vm.salt_index >= L:
        raise ValueError("temp_index / salt_index exceed the tracer count")
    plan = vmix_kernel.plan_frames(K, L, frames.element_size())
    consts = np.array([float(dt), cfg.gravity, vm.nu0, vm.alpha,
                       vm.eos_alpha_t, vm.eos_beta_s, vm.kappa_tracer,
                       vm.kappa_momentum], np.float64)
    ints = np.array([P, K, L, vm.temp_index, vm.salt_index, vm.n_exp,
                     LAYERS_PER_THREAD, THREADS, plan["cw"], plan["lanes"],
                     plan["lc"], plan["rhs"]], np.int32)
    return consts, ints


def vmix_coeffs(p, cfg, frames, coef=None):
    """The PP81 coefficients of the frames the horizontal chain made, into
    `coef` (K, 4, P) (made here when None): one launch on PyTorch's
    current stream for a CUDA array, the plain version for a CPU one."""
    global coeff_launches
    if not frames.is_cuda:
        return vmix_coeffs_plain(p, cfg, frames)
    K, CH, P = frames.shape
    coef = frames.new_empty((K, 4, P)) if coef is None else coef
    _check_coef(p, frames, coef)
    lib = _build.load()
    _rows_ok(lib, p)
    consts, ints = _vmix_args(p, cfg, frames, 0.0)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_patch_pp81_{_suffix(frames)}")(
            frames.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
            coef.data_ptr(), consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "patch PP81 coefficient launch")
    coeff_launches += 1
    return coef


def _check_coef(p, frames, coef):
    K, CH, P = frames.shape
    if frames.dtype != p.dtype or frames.device != p.device \
            or not frames.is_contiguous() or P != p.P:
        raise ValueError("frames must be contiguous and match the prep")
    if coef is not None and (
            tuple(coef.shape) != (K, 4, P) or coef.dtype != frames.dtype
            or coef.device != frames.device or not coef.is_contiguous()):
        raise ValueError(f"`coef` must be a contiguous {(K, 4, P)} array "
                         "of the frames' type and device")


def vmix_solve(p, cfg, frames, dt, coef=None):
    """The column solves IN PLACE on the u and tracer channels of the
    frames the horizontal chain made (h_new is read only); returns
    `frames`. One launch on PyTorch's current stream for a CUDA array, the
    plain version for a CPU array. `coef` as in `vmix_solve_plain`."""
    global solve_launches
    if not frames.is_cuda:
        frames.copy_(vmix_solve_plain(p, cfg, frames, dt, coef))
        return frames
    _check_coef(p, frames, coef)
    lib = _build.load()
    _rows_ok(lib, p)
    consts, ints = _vmix_args(p, cfg, frames, dt)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_patch_vmix_solve_{_suffix(frames)}")(
            frames.data_ptr(), p.offs.data_ptr(), p.wts.data_ptr(),
            None if coef is None else coef.data_ptr(),
            consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "patch column-solve launch")
    solve_launches += 1
    return frames


def coeff_attrs(cfg, frames):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the PP81 coefficient kernel these frames launch, and
    the blocks of THREADS threads an SM holds."""
    lib = _build.load()
    consts, ints = _vmix_args(None, cfg, frames, 0.0)
    got = np.zeros(4, np.int32)
    _build.check(getattr(lib, f"omega_patch_pp81_attrs_{_suffix(frames)}")(
        consts.ctypes.data, ints.ctypes.data, got.ctypes.data),
        "cudaFuncGetAttributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def solve_attrs(cfg, frames):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the column-solve kernel these frames launch, the
    blocks an SM holds for their plan, and the plan
    (vmix_kernel.plan_frames)."""
    lib = _build.load()
    consts, ints = _vmix_args(None, cfg, frames, 0.0)
    got = np.zeros(4, np.int32)
    _build.check(getattr(lib, f"omega_patch_vmix_solve_attrs_"
                              f"{_suffix(frames)}")(
        consts.ctypes.data, ints.ctypes.data, got.ctypes.data),
        "cudaFuncGetAttributes")
    K, CH, _ = frames.shape
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)),
                plan=vmix_kernel.plan_frames(K, CH - 4,
                                             frames.element_size()))


def new_work(frames):
    """Scratch of the patch step for frames like `frames` (None on the
    CPU)."""
    if not frames.is_cuda:
        return None
    K, CH, P = frames.shape
    return frames.new_empty(work_fields(CH - 4) * K * P)


def new_coef(frames, cfg):
    """The PP81 coefficient array for frames like `frames` (None on the
    CPU or without PP81)."""
    if not frames.is_cuda or not vmix_on(cfg) \
            or cfg.vert_mix.scheme != "pp81":
        return None
    K, CH, P = frames.shape
    return frames.new_empty((K, 4, P))


def _mix_frames(p, cfg, nf, dt, coef=None):
    """The vertical mixing of `cfg` on the frames a chain made, in place:
    the coefficient kernel (PP81) and the column solve."""
    if vmix_on(cfg):
        if cfg.vert_mix.scheme == "pp81":
            coef = vmix_coeffs(p, cfg, nf, coef)
        vmix_solve(p, cfg, nf, dt, coef if cfg.vert_mix.scheme == "pp81"
                   else None)
    return nf


def step(p, cfg, frames, dt, out=None, work=None, wind=None, coef=None):
    """The whole chain of `cfg` on the frames into `out`: the patch step,
    then with vertical mixing the coefficient kernel (PP81) and the column
    solve on `out`."""
    nf = chain(p, cfg, frames, dt, out=out, work=work, wind=wind)
    return _mix_frames(p, cfg, nf, dt, coef)


# ----------------------------------------------------------------------
# frames

def _frames_of(p, cls, flat, T, out):
    """Flat (N, K) rows -> out (K, T, P): the grid ids pasted, the halo
    and seam positions filled from their elements, holes zero."""
    n, S, mh = p.n, p.S, p.mh
    K = flat.shape[-1]
    NG = 10 * n * n
    out.zero_()
    fr = out.view(K, T, 10, S, S)
    fr[..., mh:mh + n, mh:mh + n] = \
        flat[:T * NG].reshape(T, 10, n, n, K).permute(4, 0, 1, 2, 3)
    pos, src = p.fills[cls]
    out.view(K, T * p.P)[:, pos] = flat[src].T


def _assemble(p, state):
    h, u, tr = state
    K, L = h.shape[-1], tr.shape[0]
    frames = h.new_empty((K, 4 + L, p.P))
    buf = h.new_empty((K, 3, p.P))
    _frames_of(p, "cell", h, 1, buf[:, :1])
    frames[:, 0:1] = buf[:, :1]
    _frames_of(p, "edge", u, 3, buf)
    frames[:, 1:4] = buf
    for l in range(L):
        _frames_of(p, "cell", tr[l], 1, buf[:, :1])
        frames[:, 4 + l:5 + l] = buf[:, :1]
    return frames


def stack_frames(mesh, cfg, state):
    """Flat state -> the (frames, fix rows) carry; an FCT configuration
    carries the fix rows of the FCT fix sets."""
    h, u, tr = state
    p = _prep_for(mesh, cfg, h.dtype, h.device)
    frames = _assemble(p, state)
    fc, fe = p.fix_cells_global, p.fix_edges_global
    return frames, dict(h=h[fc], u=u[fe], tr=tr[:, fc])


def _cls_view(frames, c0, T):
    """Channels [c0, c0+T) of the (K, CH, P) frames as a (K, T*P) view."""
    K, _, P = frames.shape
    return frames[:, c0:c0 + T].reshape(K, T * P)


def _refresh(flat, m, fix_rows):
    """Refresh one class's (K, T*P) view with the persist map `m`, in
    place: refill invalid positions from exact ones, scatter the fix rows,
    re-zero the lattice holes."""
    flat[:, m["refill_pos"]] = flat[:, m["refill_src"]]
    if m["fix_pos"].numel():
        flat[:, m["fix_pos"]] = fix_rows[m["fix_row"]].T
    if m["zero_pos"].numel():
        flat[:, m["zero_pos"]] = 0.0


def _refresh_frames(p, nf, nfix, persist):
    """In-frame halo refresh of the next frames `nf`, in place, with the
    persist maps `persist` (the prep's `persist`: the FB chain's, or an FCT
    prep's) and the fix rows `nfix`."""
    L = nf.shape[1] - 4
    _refresh(_cls_view(nf, 0, 1), persist["cell"], nfix["h"])
    _refresh(_cls_view(nf, 1, 3), persist["edge"], nfix["u"])
    for l in range(L):
        _refresh(_cls_view(nf, 4 + l, 1), persist["cell"], nfix["tr"][l])
    return nf


def _sub_state(p, frames, fix):
    """The pole submesh's state: its rows read from exact frame positions,
    the fix rows from the carry."""
    L = frames.shape[1] - 4
    h = _cls_view(frames, 0, 1)[:, p.sub_cell_src].T.contiguous()
    h[p.fix_cells_local] = fix["h"]
    u = _cls_view(frames, 1, 3)[:, p.sub_edge_src].T.contiguous()
    u[p.fix_edges_local] = fix["u"]
    tr = torch.stack([_cls_view(frames, 4 + l, 1)[:, p.sub_cell_src].T
                      for l in range(L)])
    tr[:, p.fix_cells_local] = fix["tr"]
    return ModelState(h=h, u=u, tracers=tr)


def _fix_rows(p, h, u, tr):
    """The carried fix rows of a submesh state (h, u, tracers)."""
    return dict(h=h[p.fix_cells_local], u=u[p.fix_edges_local],
                tr=tr[:, p.fix_cells_local])


def fb_patch_megastep_framed(mesh, cfg, carry, t, dt, out=None, work=None,
                             wind=None, coef=None):
    """One FB step on the (frames, fix rows) carry: the chain (the kernels
    on the card), the submesh step, the in-frame refresh. `out` receives
    the next frames (a new array when None; never the carry's own);
    `wind` is a `make_wind` bundle (None without wind); `work` and `coef`
    are the kernels' scratch (`new_work`, `new_coef`)."""
    from omega_tpu_torch.stepping.steppers import forward_backward_step
    frames, fix = carry
    p = prep(mesh, frames.dtype, frames.device)
    nf = step(p, cfg, frames, dt, out=out, work=work, wind=wind, coef=coef)
    sub = forward_backward_step(p.sub_mesh, cfg, _sub_state(p, frames, fix),
                                t, dt, wind_stress=_sub_wind(wind))
    nfix = _fix_rows(p, *sub)
    return _refresh_frames(p, nf, nfix, p.persist), nfix


def _sub_wind(wind):
    return None if wind is None else wind[1]


def _fct_diffusion_tendency(sub, cfg, h, u, tr, mean_h_edge):
    """The del2 / del4 tracer terms of tendencies.compute_tracer_tendency
    alone: what FCT's stage A accumulates before the limiter."""
    tc = cfg.tendencies
    tr_aux = auxmod.tracer_aux(sub, cfg, h, u, tr, mean_h_edge)
    tend = tc.eddy_diff2 * auxmod._weighted_cell_laplacian(
        sub, trisk.col(sub, "mesh_scaling_del2") * mean_h_edge, tr)
    return tend - tc.eddy_diff4 * auxmod._weighted_cell_laplacian(
        sub, trisk.col(sub, "mesh_scaling_del4"), tr_aux.del2_tracers_cell)


def new_mid(frames):
    """Stage A's output for frames like `frames`: (K, 4+2L, P)."""
    K, CH, P = frames.shape
    return frames.new_empty((K, 2 * CH - 4, P))


def fct_sub_a(p, cfg, frames, fix, t, dt, wind=None):
    """The composed stage A on the FCT fix submesh of an FCT prep `p`: the
    fix rows of h_new, trtd and facc (`mid_fix`), and what stage B's
    composed part reads (the submesh's u, tracers and mass flux, and the
    fix rows of u_new)."""
    from omega_tpu_torch.core import fct as fctmod
    from omega_tpu_torch.core import tendencies as tend_mod
    sub, fc = p.sub_mesh, p.fix_cells_local
    h0, u0, tr0 = _sub_state(p, frames, fix)
    dh, thick = tend_mod.compute_thickness_tendency(sub, cfg, h0, u0, t)
    h_new = h0 + dt * dh
    trtd = fctmod.fct_provisional(sub, h0, h_new, u0, tr0, dt,
                                  thick.flux_h_edge)
    facc = tr0 * h0[None] + dt * _fct_diffusion_tendency(
        sub, cfg, h0, u0, tr0, thick.mean_h_edge)
    du, _ = tend_mod.compute_velocity_tendency(sub, cfg, h_new, u0, t + dt,
                                               _sub_wind(wind))
    mid_fix = dict(h=h_new[fc], trtd=trtd[:, fc], facc=facc[:, fc])
    return mid_fix, (u0, tr0, thick.flux_h_edge,
                     (u0 + dt * du)[p.fix_edges_local])


def fct_refresh_mid(p, mid, mid_fix):
    """The refresh of stage A's [h_new, trtd x L, facc x L] in `mid`, in
    place, on the FCT prep's cell maps with the submesh's fix rows."""
    pc = p.persist["cell"]
    _refresh(_cls_view(mid, 0, 1), pc, mid_fix["h"])
    for l in range(mid_fix["trtd"].shape[0]):
        _refresh(_cls_view(mid, 4 + 2 * l, 1), pc, mid_fix["trtd"][l])
        _refresh(_cls_view(mid, 5 + 2 * l, 1), pc, mid_fix["facc"][l])
    return mid


def fct_sub_b(p, mid, mid_fix, sub_a, dt):
    """The composed stage B on the FCT fix submesh (core/fct.
    fct_limited_tendency) from the refreshed `mid`: the next fix rows."""
    from omega_tpu_torch.core import fct as fctmod
    u0, tr0, flux_h_edge, u_new_fix = sub_a
    fc = p.fix_cells_local

    def rows(c):
        return _cls_view(mid, c, 1)[:, p.sub_cell_src].T

    L = tr0.shape[0]
    h_new = rows(0).contiguous()
    h_new[fc] = mid_fix["h"]
    trtd = torch.stack([rows(4 + 2 * l) for l in range(L)])
    trtd[:, fc] = mid_fix["trtd"]
    facc = torch.stack([rows(5 + 2 * l) for l in range(L)])
    facc[:, fc] = mid_fix["facc"]
    adv = fctmod.fct_limited_tendency(p.sub_mesh, h_new, u0, tr0, trtd, dt,
                                      flux_h_edge)
    trn = (facc + dt * adv) / h_new[None]
    return dict(h=mid_fix["h"], u=u_new_fix, tr=trn[:, fc])


def fct_patch_megastep_framed(mesh, cfg, carry, t, dt, out=None, work=None,
                              wind=None, mid=None):
    """One FB step with Zalesak FCT tracer fluxes on the (frames, fix rows)
    carry of an FCT configuration (the reference's two-stage driver; the
    limiter's radius-10 chain exceeds the MH = 8 margin, so the step splits
    where the provisional field is formed):

      stage A (icos_mega.fct_stage_a_chain, `fct_a`): h_new, u_new, the
        provisional trtd{l} and the numerator facc{l}, into `mid`;
      the composed stage A on the FCT fix submesh (`fct_sub_a`);
      the refresh of [h_new, trtd, facc] in `mid` (`fct_refresh_mid`);
      stage B (fct_stage_b_chain, `fct_b`): the limiter from the refreshed
        mid fields and the original frames, trn{l} into `out`;
      the composed stage B on the submesh (`fct_sub_b`) and the final
        refresh on the FCT maps.

    `out` receives the next frames (a new array when None; never the
    carry's own); `mid` is stage A's output (`new_mid`), `work` the
    kernels' scratch (`new_work`), `wind` a `make_wind` bundle."""
    frames, fix = carry
    p = _prep_for(mesh, cfg, frames.dtype, frames.device)
    mid = fct_a(p, cfg, frames, dt, out=mid, work=work, wind=wind)
    mid_fix, sub_a = fct_sub_a(p, cfg, frames, fix, t, dt, wind)
    fct_refresh_mid(p, mid, mid_fix)
    out = torch.empty_like(frames) if out is None else out
    out[:, :4] = mid[:, :4]            # h_new and u_new from stage A
    fct_b(p, cfg, mid, frames, dt, out, work)
    nfix = fct_sub_b(p, mid, mid_fix, sub_a, dt)
    return _refresh_frames(p, out, nfix, p.persist), nfix


def new_rk_scratch(frames, cfg, kind):
    """The buffers of the RK steps of `kind` ("rk2", "rk4") for frames
    like `frames`, made once per segment: the provisional frames (RK2 one,
    RK4 two that swap), RK4's accumulator, the stage kernel's work fields
    (None on the CPU) and the PP81 coefficients (`new_coef`)."""
    K, CH, P = frames.shape
    return dict(
        prov=[torch.empty_like(frames) for _ in range(1 if kind == "rk2"
                                                      else 2)],
        acc=torch.empty_like(frames) if kind == "rk4" else None,
        work=(frames.new_empty(rk_work_fields(CH - 4) * K * P)
              if frames.is_cuda else None),
        coef=new_coef(frames, cfg))


def rk2_patch_megastep_framed(mesh, cfg, carry, t, dt, out=None, wind=None,
                              scratch=None):
    """One midpoint-RK2 step on the (frames, fix rows) carry (the
    reference's two-stage step: the MH = 8 margins hold one chain
    radius, so the stages are two kernel calls with an in-frame refresh
    between them):

      stage A (RK_PROV, a = 1/2): the midpoint into scratch["prov"][0];
        the pole submesh's tendencies at the original state give the
        midpoint's fix rows; the refresh of the midpoint frames
      stage B (RK_PROV, a = 1, from the original frames): the full step
        into `out`; the submesh's tendencies at the midpoint (its rows
        gathered from the refreshed midpoint frames), the composed
        vertical mixing on the submesh (steppers._mix) and on the frames
        the column kernels; the refresh.

    `out` receives the next frames (a new array when None; never the
    carry's own); `wind` is a `make_wind` bundle; `scratch` the buffers of
    `new_rk_scratch` (made here when None)."""
    from omega_tpu_torch.core import tendencies as tend_mod
    from omega_tpu_torch.stepping.steppers import _mix
    frames, fix = carry
    p = prep(mesh, frames.dtype, frames.device)
    sc = new_rk_scratch(frames, cfg, "rk2") if scratch is None else scratch
    out = torch.empty_like(frames) if out is None else out
    sub, wsub = p.sub_mesh, _sub_wind(wind)
    h0, u0, tr0 = _sub_state(p, frames, fix)
    trh0 = tr0 * h0[None]

    mid = rk_stage(p, cfg, RK_PROV, 0.5 * dt, 0.0, frames, sc["prov"][0],
                   base=frames, work=sc["work"], wind=wind)
    k = tend_mod.compute_all_tendencies(sub, cfg, h0, u0, tr0, t, wsub)
    hm = h0 + 0.5 * dt * k.dh
    mid_fix = _fix_rows(p, hm, u0 + 0.5 * dt * k.du,
                        (trh0 + 0.5 * dt * k.dtr) / hm[None])
    _refresh_frames(p, mid, mid_fix, p.persist)

    rk_stage(p, cfg, RK_PROV, dt, 0.0, mid, out, base=frames,
             work=sc["work"], wind=wind)
    hm, um, trm = _sub_state(p, mid, mid_fix)
    k = tend_mod.compute_all_tendencies(sub, cfg, hm, um, trm, t + 0.5 * dt,
                                        wsub)
    hn = h0 + dt * k.dh
    st = _mix(sub, cfg, ModelState(h=hn, u=u0 + dt * k.du,
                                   tracers=(trh0 + dt * k.dtr) / hn[None]),
              dt)
    nfix = _fix_rows(p, *st)
    _mix_frames(p, cfg, out, dt, sc["coef"])
    return _refresh_frames(p, out, nfix, p.persist), nfix


def rk4_patch_megastep_framed(mesh, cfg, carry, t, dt, out=None, wind=None,
                              scratch=None):
    """One classic-RK4 step on the (frames, fix rows) carry (the
    reference's four-stage step): stage s evaluates every tendency at
    its level (the original frames, then the refreshed provisional ones)
    and writes the next provisional frames and the accumulator (RK_FIRST,
    RK_MID, RK_MID), the last stage the next frames from the accumulator
    (RK_LAST). After each stage the pole submesh's tendencies at that
    stage's level and time give the fix rows of both (the accumulator's
    thickness-weighted), and both are refreshed in-frame; after the last,
    the vertical mixing (steppers._mix on the submesh, the column kernels
    on the frames) and the refresh. The provisional frames alternate
    between the two buffers of scratch["prov"], the accumulator is updated
    in place (a stage reads it only at the position it writes), and the
    original frames stay untouched until the step ends. Arguments as
    `rk2_patch_megastep_framed`."""
    from omega_tpu_torch.core import tendencies as tend_mod
    from omega_tpu_torch.stepping.steppers import _mix
    frames, fix = carry
    p = prep(mesh, frames.dtype, frames.device)
    sc = new_rk_scratch(frames, cfg, "rk4") if scratch is None else scratch
    out = torch.empty_like(frames) if out is None else out
    A, B = megastep.RK4_A, megastep.RK4_B
    prov, acc = sc["prov"], sc["acc"]
    sub, wsub = p.sub_mesh, _sub_wind(wind)
    h0, u0, tr0 = _sub_state(p, frames, fix)
    trh0 = tr0 * h0[None]
    ev, ev_fix, acc_fix = frames, fix, None
    for s in range(4):
        # the submesh's rows of this stage's level and of the accumulator,
        # gathered before the stage updates the accumulator in place
        hp, up, trp = (h0, u0, tr0) if s == 0 else _sub_state(p, ev, ev_fix)
        if s:
            ha, ua, tra = _sub_state(p, acc, acc_fix)
        mode = (RK_FIRST, RK_MID, RK_MID, RK_LAST)[s]
        nxt = out if s == 3 else prov[s % 2]
        rk_stage(p, cfg, mode, A[s + 1] * dt if s < 3 else 0.0, B[s] * dt,
                 ev, nxt, base=frames if s < 3 else None,
                 acc=acc if s else None, acc_out=acc if s < 3 else None,
                 work=sc["work"], wind=wind)
        k = tend_mod.compute_all_tendencies(sub, cfg, hp, up, trp,
                                            t + A[s] * dt, wsub)
        if s == 0:
            ha = h0 + B[0] * dt * k.dh
            ua = u0 + B[0] * dt * k.du
            tra = trh0 + B[0] * dt * k.dtr
        else:
            ha = ha + B[s] * dt * k.dh
            ua = ua + B[s] * dt * k.du
            tra = tra + B[s] * dt * k.dtr
        if s < 3:
            hp = h0 + A[s + 1] * dt * k.dh
            ev_fix = _fix_rows(p, hp, u0 + A[s + 1] * dt * k.du,
                               (trh0 + A[s + 1] * dt * k.dtr) / hp[None])
            acc_fix = _fix_rows(p, ha, ua, tra)
            ev = _refresh_frames(p, nxt, ev_fix, p.persist)
            _refresh_frames(p, acc, acc_fix, p.persist)
    st = _mix(sub, cfg, ModelState(h=ha, u=ua, tracers=tra / ha[None]), dt)
    nfix = _fix_rows(p, *st)
    _mix_frames(p, cfg, out, dt, sc["coef"])
    return _refresh_frames(p, out, nfix, p.persist), nfix


def new_split_scratch(frames):
    """The buffers of the split steps for frames like `frames`, made once
    per segment: splitpre's du_out (K, 3, P), the split kernels' work
    fields (both None on the CPU) and the subcycle kernel's outputs and
    second buffers (`bt`, bt_gather.new_buffers, made at the first step)."""
    if not frames.is_cuda:
        return dict(du=None, work=None, bt=None)
    K, CH, P = frames.shape
    return dict(du=frames.new_empty((K, 3, P)),
                work=frames.new_empty(split_work_fields(CH - 4) * K * P),
                bt=None)


def split_du(mesh, cfg, p, du_fr, h, u, t):
    """splitpre's du_out (K, 3, P) read out flat, (E, K): every edge from a
    position the prep's refresh maps call exact (`edge_src`: the kernel's
    output has the frames' layout), gated by the edge mask (the composed
    tendency masks every term; dead seam slots read 0), the pole rows from
    the composed tendency on the submesh at the flat state (h, u)."""
    from omega_tpu_torch.core import tendencies as tend_mod
    K = du_fr.shape[0]
    du = du_fr.reshape(K, 3 * p.P)[:, p.edge_src].T
    mask = trisk.col(mesh, "edge_mask")
    if not isinstance(mask, (int, float)):
        du = torch.where(mask != 0, du, torch.zeros_like(du))
    du = torch.where(p.edge_src_ok[:, None], du, torch.zeros_like(du))
    du_s, _ = tend_mod.compute_velocity_tendency(
        p.sub_mesh, cfg, h[p.sub_cells], u[p.sub_edges], t)
    du[p.fix_edges_global] = du_s[p.fix_edges_local]
    return du


def split_patch_megastep_framed(mesh, cfg, carry, t, dt, n_subcycles=10,
                                bt_drag=0.0, out=None, work=None):
    """One split-explicit step on the (frames, fix rows) carry
    (stepping/split.py's semantics on the sphere; the reference's driver):

      1. splitpre (`split_pre`): the full 3-D velocity tendency with the
         column free surface at every frame position, read out flat through
         the refresh maps (`edge_src`: the kernel's output shares the frames'
         layout), gated by the edge mask; the pole rows from the composed
         tendency on the submesh
      2. the flat 2-D phase on the (E, K) / (C, K) arrays: the
         thickness-weighted mode split, the frozen slow forcing and the
         barotropic subcycles (ops/bt_gather.bt_subcycles: the gather-form
         kernel on the card, one launch for all M, into the scratch's
         buffers); the subcycles are global, so the pole rows
         need nothing of their own
      3. the transport velocity u' + <ubar> laid into the carry's u
         channels, splitpost (`split_post`): h_new and the tracers into
         `out`; the submesh's composed advance with the global transport
         velocity for the fix rows; the new velocity u' + dt (G - Gbar) +
         ubar_final, pointwise flat, laid into `out`'s u channels; the
         refresh.

    The carry's frames are consumed: their u channels take the transport
    velocity. `out` receives the next frames (a new array when None; never
    the carry's own); `work` the buffers of `new_split_scratch`."""
    from omega_tpu_torch.core import tendencies as tend_mod
    from omega_tpu_torch.ops import bt_gather
    from omega_tpu_torch.stepping.split import _depth_avg_edge
    frames, fix = carry
    p = prep(mesh, frames.dtype, frames.device)
    sc = new_split_scratch(frames) if work is None else work
    out = torch.empty_like(frames) if out is None else out
    h, u, tr = unstack_frames(mesh, cfg, carry)

    # 1. the full velocity tendency, read out flat
    du = split_du(mesh, cfg, p, split_pre(p, cfg, frames, out=sc["du"],
                                          work=sc["work"]), h, u, t)
    h_sub, tr_sub = h[p.sub_cells], tr[:, p.sub_cells]

    # 2. the flat 2-D phase (stepping/split.py's order of operations)
    h_edge = trisk.cell_mean_on_edge(mesh, h)
    h_edge_tot = torch.sum(h_edge, dim=-1, keepdim=True)
    ubar = _depth_avg_edge(h_edge, u)
    uprime = u - ubar
    du_bar = _depth_avg_edge(h_edge, du)
    ssh = (torch.sum(h, dim=-1, keepdim=True)
           - trisk.col(mesh, "bottom_depth"))
    g_slow = du_bar - bt_gather.fast(mesh, ubar, ssh, cfg.gravity,
                                     bt_drag)
    if frames.is_cuda and sc.get("bt") is None:
        sc["bt"] = bt_gather.new_buffers(ubar, ssh)
    out_bt, work_bt = sc.get("bt") or (None, None)
    ub_final, _, ubar_avg = bt_gather.bt_subcycles(
        mesh, ubar, ssh, g_slow, h_edge_tot, gravity=cfg.gravity,
        dt_bt=dt / n_subcycles, n_subcycles=n_subcycles, bt_drag=bt_drag,
        out=out_bt, work=work_bt)
    u_new = (uprime + dt * (du - du_bar)) + ub_final
    u_trans = uprime + ubar_avg

    # 3. the thickness and tracer advance with the transport velocity
    _frames_of(p, "edge", u_trans, 3, frames[:, 1:4])
    split_post(p, cfg, frames, dt, out, work=sc["work"])
    ut_sub = u_trans[p.sub_edges]
    he_sub = trisk.cell_mean_on_edge(p.sub_mesh, h_sub)
    h_sub_new = h_sub + dt * -trisk.div_cell(p.sub_mesh, he_sub * ut_sub)
    dtr_sub, _ = tend_mod.compute_tracer_tendency(
        p.sub_mesh, cfg, h_sub, ut_sub, tr_sub, he_sub, t, h_new=h_sub_new,
        dt=dt, flux_h_edge=he_sub)
    tr_sub_new = (tr_sub * h_sub[None] + dt * dtr_sub) / h_sub_new[None]
    nfix = dict(h=h_sub_new[p.fix_cells_local], u=u_new[p.fix_edges_global],
                tr=tr_sub_new[:, p.fix_cells_local])
    _frames_of(p, "edge", u_new, 3, out[:, 1:4])
    return _refresh_frames(p, out, nfix, p.persist), nfix


def framed_stepper(cfg, kind, frames):
    """The function of one framed step of `kind` ("fb", "rk2", "rk4") for
    `cfg` and the scratch it reuses across a segment, for frames like
    `frames`: (step function, its keyword arguments)."""
    if kind == "fb" and cfg.flux_tracer_type == "fct":
        return fct_patch_megastep_framed, dict(work=new_work(frames),
                                               mid=new_mid(frames))
    if kind == "fb":
        return fb_patch_megastep_framed, dict(work=new_work(frames),
                                              coef=new_coef(frames, cfg))
    fn = rk2_patch_megastep_framed if kind == "rk2" \
        else rk4_patch_megastep_framed
    return fn, dict(scratch=new_rk_scratch(frames, cfg, kind))


def unstack_frames(mesh, cfg, carry, state_cls=ModelState):
    """(frames, fix rows) carry of `cfg` -> flat state (an FCT
    configuration's fix rows live on the FCT fix sets)."""
    frames, fix = carry
    p = _prep_for(mesh, cfg, frames.dtype, frames.device)
    L = frames.shape[1] - 4

    def read(flat, src, ok, fixg, fix_rows):
        v = flat[:, src].T
        v = torch.where(ok[:, None], v, torch.zeros_like(v))
        v[fixg] = fix_rows
        return v

    h = read(_cls_view(frames, 0, 1), p.cell_src, p.cell_src_ok,
             p.fix_cells_global, fix["h"])
    u = read(_cls_view(frames, 1, 3), p.edge_src, p.edge_src_ok,
             p.fix_edges_global, fix["u"])
    tr = torch.stack([
        read(_cls_view(frames, 4 + l, 1), p.cell_src, p.cell_src_ok,
             p.fix_cells_global, fix["tr"][l]) for l in range(L)])
    return state_cls(h=h, u=u, tracers=tr)


def fb_patch_megastep(mesh, cfg, state, t, dt, wind_stress=None):
    """One forward-backward step of a flat state (the per-step API): frames
    assembled from the state, the chain, the submesh step on the state's
    own rows, and the paste-back of the outputs (grid rows by reshape, seam
    and tail rows from exact rim positions, dead rows zero, fix rows from
    the submesh)."""
    from omega_tpu_torch.stepping.steppers import forward_backward_step
    h, u, tr = state
    K, L = h.shape[-1], tr.shape[0]
    p = prep(mesh, h.dtype, h.device)
    n, S, mh = p.n, p.S, p.mh
    NG = 10 * n * n
    wind = make_wind(mesh, cfg, wind_stress, h.dtype)
    out = step(p, cfg, _assemble(p, state), dt, wind=wind)
    sub = forward_backward_step(
        p.sub_mesh, cfg, ModelState(h=h[p.sub_cells], u=u[p.sub_edges],
                                    tracers=tr[:, p.sub_cells]), t, dt,
        wind_stress=_sub_wind(wind))

    def paste(oname, ch0, T, N, fix_src, fix_local, fix_global):
        grid = out[:, ch0:ch0 + T].reshape(K, T, 10, S, S)[
            ..., mh:mh + n, mh:mh + n]
        flat = h.new_zeros((N, K))
        flat[:T * NG] = grid.reshape(K, T * NG).T
        rim, rpos, dead, fix = p.outputs[oname]
        if dead.numel():
            flat[dead] = 0.0
        if rim.numel():
            flat[rim] = _cls_view(out, ch0, T)[:, rpos].T
        if fix.numel():
            flat[fix] = fix_src[fix_local[torch.searchsorted(fix_global,
                                                             fix)]]
        return flat

    cells = (p.fix_cells_local, p.fix_cells_global)
    h_new = paste("h", 0, 1, mesh.ncells, sub.h, *cells)
    u_new = paste("u", 1, 3, mesh.nedges, sub.u, p.fix_edges_local,
                  p.fix_edges_global)
    trn = torch.stack([paste("tr", 4 + l, 1, mesh.ncells, sub.tracers[l],
                             *cells) for l in range(L)])
    return ModelState(h=h_new, u=u_new, tracers=trn)
