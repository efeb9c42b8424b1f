"""Mega-step build artifacts for patch-structured icosahedral meshes.

The composed patch path (ops/patch_stencil.py) rebuilds a halo-2 frame
per stencil pass and patches seams with gather fix-ups BETWEEN passes.
A whole-step kernel cannot fix up mid-chain, so this module builds the
static data that lets the FULL forward-backward chain run on halo-MH
frames with NO mid-chain fix-ups:

  * wide content maps — element ids at every frame position out to a
    MH+2 ring, grown from the patch builder's halo-2 maps by pure
    connectivity walking (no orientation bookkeeping; stops at the 12
    pentagon defects and the 2 poles)
  * GEOMETRIC stencil tables on the padded domain: for every position p
    holding element X, X's stencil is re-expressed as offsets into THIS
    patch frame with per-position weight planes (10, S, S).  Rotated
    seam offsets become extra low-support entries instead of fix-ups,
    so chained applications stay valid under the usual creep rule.
    Geometry factors are folded in (1/dc, 1/dv, the del2 dv-floor,
    dv/dc and the del2/del4 mesh scalings on the tracer laplacians).
  * positions that cannot resolve (the pole wedges) and the closure of
    outputs their garbage can reach; elements with no clean frame
    position anywhere form the FIX SET, recomputed each step on a tiny
    extracted submesh (a few hundred cells around the poles) by the
    ordinary composed stepper and scattered over the kernel result
  * paste/scatter maps: one reshape paste covers the grid ids; rim
    positions recover seam orphans and tail elements; dead rows zero

Host numpy, the counterpart of omega_tpu/mesh/icos_mega.py for the
forward-backward chain (center or upwind fluxes, stacked ssh, wind, bottom
drag, implicit vertical mixing with constant or PP81 coefficients) and its
Zalesak FCT form in two stages (`ensure_fct`: the FCT tables, the stages'
validity masks and their own fix submesh, built only for FCT). The
frame margin MH, the tile whose slab creep the validity masks model, and
the choice of worst-case (every physics option on) or tight masks are
arguments with the reference's defaults; a build is kept on the mesh's
PatchInfo, keyed by them.

Reference: operators unchanged (ocn/HorzOperators.h:9-187); this is
layout work the reference does not need (its gathers are cheap on CPU,
base/Decomp.cpp:968 buys locality from METIS instead).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from omega_tpu_torch.mesh import icos_patches as ip
from omega_tpu_torch.mesh.horz_mesh import HorzMesh, finalize_mesh, \
    unclamped_connectivity
from omega_tpu_torch.mesh.icos_patches import EDGE_DIRS, HALO, VERTEX_TRIS

# frame halo (>= the FB chain radius 6) and kernel tile of the reference
MH = 8
TILE = 16
OH = 2        # output rim written around each owned patch region
SUB_GROW = 10  # BFS closure width of the fix submesh (chain + halo)

# tables only the FCT chains read, built by ensure_fct alone, so the
# flagship and science builds (and their compact tables) stay as they are
FCT_TABLES = ("div_pos", "div_neg") + tuple(f"coc{j}" for j in range(6))


@dataclasses.dataclass
class MegaTable:
    """One stencil as padded-domain entries with weight planes."""
    name: str
    dst_class: str
    src_class: str
    # [(t_dst, t_src, da, db, wplane (10, S, S) float64)], S = n + 2*MH
    entries: List[Tuple[int, int, int, int, np.ndarray]]


@dataclasses.dataclass
class MegaInfo:
    n: int
    mh: int                              # frame halo
    by: tuple                # the reference kernel's tile (rows, cols), | S
    content: Dict[str, np.ndarray]       # (T, 10, S, S) element ids, S wide
    fills: Dict[str, Tuple[np.ndarray, np.ndarray]]  # frame pos <- flat id
    tables: Dict[str, MegaTable]
    const_planes: Dict[str, np.ndarray]  # name -> (T, 10, S, S) float64
    # paste-back per output field ("h"/"u"/"tr"): (rim_rows, rim_pos,
    # dead_rows, fix_rows) from _pasteback_one
    outputs: Dict[str, tuple]
    # exactness mask of every chain value (diagnostic + tests)
    masks: Dict[str, np.ndarray]
    # pole/defect fix: extracted submesh + row maps
    sub_mesh: HorzMesh
    sub_cells: np.ndarray      # global cell ids of submesh rows
    sub_edges: np.ndarray      # global edge ids of submesh rows
    fix_cells_local: np.ndarray   # submesh-local rows to harvest
    fix_cells_global: np.ndarray
    fix_edges_local: np.ndarray
    fix_edges_global: np.ndarray
    # per-table resolution masks
    resolved: Dict[str, np.ndarray] = None

    @property
    def S(self) -> int:
        return self.n + 2 * self.mh


def ensure_mega(mesh, mh: int = MH, tile=TILE,
                phys_masks: bool = True) -> MegaInfo:
    """Build (once per argument set) and return the mega artifacts of a
    patch mesh. `tile` (an int or (rows, cols)) is the kernel tile whose
    slab creep the validity masks model; `phys_masks` selects the
    worst-case masks (every physics option on, the reference's default)
    over the tight masks of the flagship chain."""
    info = getattr(mesh, "patch_info", None)
    if info is None:
        raise ValueError("mesh is not patch-structured")
    key = ("mega", int(mh), tile if isinstance(tile, int) else tuple(tile),
           bool(phys_masks))
    if key not in info.cache:
        # built from the host float64 arrays the mesh was made with
        info.cache[key] = _build(info.host_mesh, info, int(mh), tile,
                                 bool(phys_masks))
    return info.cache[key]


def ensure_fct(mesh, mh: int = MH, tile=TILE, phys_masks: bool = True):
    """Build (once per argument set, kept on the mesh's PatchInfo) and
    return the FCT extension of a mega build: the FCT tables and their
    resolution masks, the tiled validity masks of the two stages, the
    cell / edge keeps of the refreshes between and after them, and the FCT
    fix closure with its own submesh (the limiter's creep differs from the
    FB chain's, so its fix set comes from its own masks). Arguments as
    `ensure_mega`."""
    mg = ensure_mega(mesh, mh, tile, phys_masks)
    info = mesh.patch_info
    key = ("fct", int(mh), tile if isinstance(tile, int) else tuple(tile),
           bool(phys_masks))
    if key not in info.cache:
        info.cache[key] = _build_fct(info.host_mesh, mg)
    return info.cache[key]


def _build_fct(mesh, mg: MegaInfo) -> dict:
    n, mh = mg.n, mg.mh
    pos_of = _positions_of(mg.content)
    tables, resolved = dict(mg.tables), dict(mg.resolved)
    for name, idx, dst, src, w in _fct_table_specs(mesh):
        tables[name], resolved[name] = _build_mega_table(
            n, mg.content, pos_of, name, idx, w, dst, src, 2, mh)
    masks_a = kernel_validity(
        tables, mg.content, resolved, n, mg.by, mh,
        fct_stage_a_chain(1, wind=True, drag=True), mh,
        out_keys=("h_new", "u_new", "trtd0", "facc0"))
    masks_b = kernel_validity(
        tables, mg.content, resolved, n, mg.by, mh, fct_stage_b_chain(1), mh,
        out_keys=("trn0",),
        extra_inputs=(("h_new", "cell"), ("trtd0", "cell"),
                      ("facc0", "cell")))
    cell_keep = (masks_a["h_new"] & masks_a["trtd0"] & masks_a["facc0"]
                 & masks_b["trn0"])
    edge_keep = masks_a["u_new"]
    outputs, fix = _fix_closure(mesh, mg.content, n, (
        ("c", cell_keep, "cell", mesh.ncells),
        ("u", edge_keep, "edge", mesh.nedges)), mh)
    return dict(tables={k: tables[k] for k in FCT_TABLES},
                resolved={k: resolved[k] for k in FCT_TABLES},
                masks_a=masks_a, masks_b=masks_b, cell_keep=cell_keep,
                edge_keep=edge_keep, outputs=outputs, **fix)


# ----------------------------------------------------------------------
# wide content maps

def _widen_cells(mesh, info: ip.PatchInfo, mh: int) -> np.ndarray:
    """Grow the cell content map from HALO to MH+2 rings by connectivity
    walking on the renumbered mesh (same rule as icos_patches'
    _resolve_slot, id-agnostic)."""
    n = info.n
    reach = mh + 2
    S = n + 2 * reach
    Sold = n + 2 * HALO
    grow = reach - HALO
    fr_all = np.full((10, S, S), -1, np.int64)
    fr_all[:, grow:grow + Sold, grow:grow + Sold] = info.content["cell"][0]
    adj = ip._adjacency_sets(mesh)
    for r in range(10):
        fr = fr_all[r]
        for _ in range(grow + 2):
            progress = False
            for bi in range(S):
                for ai in range(S):
                    if fr[bi, ai] >= 0:
                        continue
                    placed = ip._resolve_slot(fr, adj, bi, ai, S)
                    if placed >= 0:
                        fr[bi, ai] = placed
                        progress = True
            if not progress:
                break
    return fr_all


def _wide_content(mesh, info: ip.PatchInfo, mh: int):
    """(cell, edge, vertex) content maps out to the MH+2 ring."""
    n = info.n
    reach = mh + 2
    S = n + 2 * reach
    cells = _widen_cells(mesh, info, mh)
    epair, vtri = ip._elem_dicts(mesh)
    cont_e = np.full((3, 10, S, S), -1, np.int64)
    cont_v = np.full((2, 10, S, S), -1, np.int64)
    for r in range(10):
        fr = cells[r]
        for b in range(S):
            for a in range(S):
                c0 = int(fr[b, a])
                if c0 < 0:
                    continue
                for t, (da, db) in enumerate(EDGE_DIRS):
                    bb, aa = b + db, a + da
                    if 0 <= bb < S and 0 <= aa < S:
                        e = ip._edge_at(epair, c0, int(fr[bb, aa]))
                        if e >= 0:
                            cont_e[t, r, b, a] = e
                for t, tri in enumerate(VERTEX_TRIS):
                    cs = []
                    ok = True
                    for (da, db) in tri:
                        bb, aa = b + db, a + da
                        if not (0 <= bb < S and 0 <= aa < S) or fr[bb, aa] < 0:
                            ok = False
                            break
                        cs.append(int(fr[bb, aa]))
                    if ok:
                        v = vtri.get(frozenset(cs), -1)
                        if v >= 0:
                            cont_v[t, r, b, a] = v
    # clip the MH+2 build ring to the MH frame the kernel uses
    sl = slice(2, 2 + n + 2 * mh)
    return {"cell": cells[None, :, sl, sl],
            "edge": cont_e[:, :, sl, sl],
            "vertex": cont_v[:, :, sl, sl]}


def _fills_from_content(content: Dict[str, np.ndarray], n: int, mh: int):
    out = {}
    for cls, cont in content.items():
        T = cont.shape[0]
        S = n + 2 * mh
        NG = 10 * n * n
        natural = np.full((T, 10, S, S), -1, np.int64)
        grid_ids = np.arange(T * NG, dtype=np.int64).reshape(T, 10, n, n)
        natural[:, :, mh:mh + n, mh:mh + n] = grid_ids
        need = (cont >= 0) & (cont != natural)
        pos = np.flatnonzero(need)
        src = cont.reshape(-1)[pos]
        out[cls] = (pos.astype(np.int32), src.astype(np.int32))
    return out


# ----------------------------------------------------------------------
# geometric padded-domain tables

def _positions_of(content: Dict[str, np.ndarray]):
    """Per class, per patch: element id -> [(t, y, x)] frame positions
    (padded coords)."""
    out = {}
    for cls, cont in content.items():
        T, _, S, _ = cont.shape
        per_r: List[Dict[int, list]] = [dict() for _ in range(10)]
        for t in range(T):
            for r in range(10):
                ids = cont[t, r].reshape(-1)
                for flat in np.flatnonzero(ids >= 0):
                    y, x = divmod(int(flat), S)
                    per_r[r].setdefault(int(ids[flat]), []).append((t, y, x))
        out[cls] = per_r
    return out


def _build_mega_table(n, content, pos_of, name, idx, weights, dst_class,
                      src_class, max_off, mh, res_weights=None):
    """Geometric padded-domain factorization of one stencil.

    For every padded-frame position p with live destination element D,
    express D's row (idx[D], weights[D]) as offsets p -> source position
    within the SAME patch frame; accumulate per-position planes.  Also
    returns the bool mask of positions that fully resolved with offsets
    <= max_off (offsets contribute to the chain creep radius, so each
    table caps them: tang 4, everything else 2). `res_weights` (default:
    `weights`) decide which terms a position resolves and so which slots
    gain support: a land mask's zero weights then take the slots the
    parent mesh's table takes (`_resolution_weights`)."""
    S = n + 2 * mh
    idx = np.asarray(idx, np.int64)
    if idx.ndim == 1:
        idx = idx[:, None]
    w = None if weights is None else np.asarray(weights, np.float64)
    wr = w if res_weights is None else np.asarray(res_weights, np.float64)
    dst_cont = content[dst_class]
    pos_src = pos_of[src_class]
    Td = dst_cont.shape[0]
    planes: Dict[tuple, np.ndarray] = {}
    support: Dict[tuple, int] = {}
    resolved = np.zeros((Td, 10, S, S), bool)
    # destinations ordered by ring (owned first): interior positions
    # establish the dominant entry slots, and seam/halo positions then
    # consolidate onto already-used slots instead of minting near-
    # duplicate offsets — this cuts tang from ~240 entries to ~60
    order = []
    for td in range(Td):
        for r in range(10):
            sl = dst_cont[td, r]
            for flat in np.flatnonzero(sl.reshape(-1) >= 0):
                yd, xd = divmod(int(flat), S)
                ring = max(mh - yd, yd - (mh + n - 1), mh - xd,
                           xd - (mh + n - 1), 0)
                order.append((ring, td, r, yd, xd))
    order.sort()
    for (_, td, r, yd, xd) in order:
        D = int(dst_cont[td, r, yd, xd])
        terms = []
        ok = True
        for s in range(idx.shape[1]):
            ws = 1.0 if w is None else float(w[D, s])
            if wr is not None and float(wr[D, s]) == 0.0:
                continue
            X = int(idx[D, s])
            best = None
            for (ts, ys, xs) in pos_src[r].get(X, ()):
                da, db = xs - xd, ys - yd
                dist = max(abs(da), abs(db))
                if dist > max_off:
                    continue
                slot = (td, ts, da, db)
                key = (-support.get(slot, 0), dist)
                if best is None or key < best[0]:
                    best = (key, slot)
            if best is None:
                ok = False
                break
            terms.append((best[1], ws))
        if not ok:
            continue
        resolved[td, r, yd, xd] = True
        for (slot, ws) in terms:
            if slot not in planes:
                planes[slot] = np.zeros((10, S, S), np.float64)
            planes[slot][r, yd, xd] += ws
            support[slot] = support.get(slot, 0) + 1
    entries = [(td, ts, da, db, pl)
               for (td, ts, da, db), pl in sorted(planes.items())]
    return MegaTable(name=name, dst_class=dst_class, src_class=src_class,
                     entries=entries), resolved


def _table_specs(mesh):
    """The 16 stencils of the sphere FB chain, with geometry factors folded
    in (cites per core/tendencies.py + core/aux.py)."""
    a = lambda nm: np.asarray(getattr(mesh, nm))
    E = mesh.nedges
    coe, voe = a("cells_on_edge"), a("vertices_on_edge")
    dc, dv = a("dc_edge"), a("dv_edge")
    mask = a("edge_mask")
    w_signed = -a("edge_sign_on_cell") / a("area_cell")[:, None]
    geo = mask * dv / dc                          # aux._weighted_cell_laplacian
    s2, s4 = a("mesh_scaling_del2"), a("mesh_scaling_del4")
    eoc = a("edges_on_cell")

    def src_fold(idx, w, fac):
        """w[D, s] *= fac[idx[D, s]] (source-side geometry factor)."""
        return w * fac[np.maximum(np.asarray(idx, np.int64), 0)]

    diff = np.tile([-1.0, 1.0], (E, 1))
    inv_dvf = 1.0 / np.maximum(dv, 0.25 * dc)     # del2 dv-floor (aux.del2_aux)
    return [
        ("div", eoc, "cell", "edge", a("w_div_cell")),
        ("ke", eoc, "cell", "edge", a("w_ke_cell")),
        # tracer laplacians: geo / geo*scal2 / geo*scal4 on the source edge
        ("sdiv_geo", eoc, "cell", "edge", src_fold(eoc, w_signed, geo)),
        ("sdiv_geo2", eoc, "cell", "edge",
         src_fold(eoc, w_signed, geo * s2)),
        ("sdiv_geo4", eoc, "cell", "edge",
         src_fold(eoc, w_signed, geo * s4)),
        ("curl", a("edges_on_vertex"), "vertex", "edge", a("w_curl_vertex")),
        ("kite", a("cells_on_vertex"), "vertex", "cell", a("w_kite_frac")),
        ("tang", a("edges_on_edge"), "edge", "edge", a("weights_on_edge")),
        ("cmean", coe, "edge", "cell", np.full((E, 2), 0.5)),
        # upwind pair slots (same source availability as cmean, so the
        # center chain's validity masks cover the upwind variants exactly)
        ("c0", coe[:, :1], "edge", "cell", np.ones((E, 1))),
        ("c1", coe[:, 1:2], "edge", "cell", np.ones((E, 1))),
        ("cdiff", coe, "edge", "cell", diff),
        ("cgrad", coe, "edge", "cell", diff / dc[:, None]),
        ("vgrad", voe, "edge", "vertex", diff / dv[:, None]),
        ("vgrad_floor", voe, "edge", "vertex", diff * inv_dvf[:, None]),
        ("vmean", voe, "edge", "vertex", np.full((E, 2), 0.5)),
    ]


def _resolution_weights(mesh):
    """{table: weights} resolving the tables a land mask changes
    (icos_patches.apply_land_mask: edge_mask in the tracer laplacians'
    geometry, the land cells' kite weights) as on the mesh without land:
    the mask's zeros stay in the weights, but the slot each term takes is
    the unmasked mesh's, so a group of tables keeps the slots its compact
    table holds (patch_megastep.GROUPS). On a mesh without land these are
    the weights themselves."""
    a = lambda nm: np.asarray(getattr(mesh, nm))
    eoc = np.maximum(a("edges_on_cell").astype(np.int64), 0)
    w_signed = -a("edge_sign_on_cell") / a("area_cell")[:, None]
    geo = a("dv_edge") / a("dc_edge")
    kites = a("kite_areas_on_vertex")
    out = {"sdiv_geo": w_signed * geo[eoc],
           "sdiv_geo2": w_signed * (geo * a("mesh_scaling_del2"))[eoc],
           "sdiv_geo4": w_signed * (geo * a("mesh_scaling_del4"))[eoc],
           "kite": np.where(kites != 0.0,
                            kites / a("area_triangle")[:, None], 0.0)}
    return out


def _fct_table_specs(mesh):
    """The FCT (Zalesak) tables: the relu'd halves of the divergence
    (trisk.div_cell_pos / _neg) and the cell-neighbour picks behind
    trisk.cell_neighbor_extrema. A pentagon's padded slot points at the
    cell itself: a self-pick is the neutral element of the max / min folds
    the chain builds from the picks."""
    eoc = np.asarray(mesh.edges_on_cell)
    w_div = np.asarray(mesh.w_div_cell, np.float64)
    coc = np.asarray(unclamped_connectivity(mesh)["cells_on_cell"], np.int64)
    coc_s = np.where(coc >= 0, coc,
                     np.arange(coc.shape[0], dtype=np.int64)[:, None])
    specs = [("div_pos", eoc, "cell", "edge", np.maximum(w_div, 0.0)),
             ("div_neg", eoc, "cell", "edge", np.maximum(-w_div, 0.0))]
    for j in range(coc_s.shape[1]):
        specs.append((f"coc{j}", coc_s[:, j:j + 1], "cell", "cell",
                      np.ones((coc_s.shape[0], 1))))
    return specs


def _const_planes(mesh, content):
    """Per-position geometry fields the chain multiplies by directly."""
    S = content["cell"].shape[-1]
    f_v = np.asarray(mesh.f_vertex, np.float64)
    cv = content["vertex"]
    fv_pl = np.where(cv >= 0, f_v[np.maximum(cv, 0)], 0.0)
    # grad of bottom depth on edges ((ssh = h - depth).grad, stacked form)
    depth = np.asarray(mesh.bottom_depth, np.float64)
    dc = np.asarray(mesh.dc_edge, np.float64)
    coe = np.asarray(unclamped_connectivity(mesh)["cells_on_edge"], np.int64)
    gd = np.where((coe[:, 0] >= 0) & (coe[:, 1] >= 0),
                  (depth[np.maximum(coe[:, 1], 0)]
                   - depth[np.maximum(coe[:, 0], 0)]) / dc, 0.0)
    ce = content["edge"]
    gd_pl = np.where(ce >= 0, gd[np.maximum(ce, 0)], 0.0)
    # del2/del4 mesh scalings multiply the velocity diffusion terms
    # directly (TendencyTerms.h velocityDiffusion/HyperDiff); the tracer
    # variants are folded into the sdiv_geo2/4 tables instead
    pls = {"f_vertex": fv_pl, "gdepth": gd_pl}
    for nm in ("mesh_scaling_del2", "mesh_scaling_del4"):
        arr = np.asarray(getattr(mesh, nm), np.float64)
        pls["scal2" if nm.endswith("del2") else "scal4"] = np.where(
            ce >= 0, arr[np.maximum(ce, 0)], 0.0)
    em = np.asarray(mesh.edge_mask, np.float64)
    pls["edge_mask"] = np.where(ce >= 0, em[np.maximum(ce, 0)], 0.0)
    # cell bottom depth: the column free surface of the split-explicit chain
    # reads ssh = sum_k h - depth (a uniform depth becomes a scalar in the
    # prep)
    cc = content["cell"]
    pls["depth"] = np.where(cc >= 0, depth[np.maximum(cc, 0)], 0.0)
    return pls


# ----------------------------------------------------------------------
# the FB chain, declaratively — shared by the build-time validity pass
# (numpy bool masks) and the plain evaluation of the chain on frames
# (ops/patch_megastep.py).
#
# ("name", "st", table, src)            stencil application
# ("name", "ew", fn, args...)           elementwise combine (same class)
# args starting with "$" are const planes; numeric literals allowed.
# Mirrors stepping.forward_backward_step -> core/tendencies.py exactly
# (stacked ssh, all standard terms; the flux types, wind, drag and vmix as
# fb_chain's arguments select).

def _pre_ops(uw_h=False, uw_tr=False):
    if uw_h or uw_tr:
        # named hp0/hp1, as the reference names them: "h0" names the
        # original-state input of its RK stage chains
        ops = [("hp0", "st", "c0", "h"), ("hp1", "st", "c1", "h"),
               ("mean_h", "ew", "mean2", "hp0", "hp1")]
    else:
        ops = [("mean_h", "st", "cmean", "h")]
    if uw_h:
        ops += [("flux_h", "ew", "upwind", "u", "hp0", "hp1")]
    else:
        ops += [("flux_h", "ew", "copy", "mean_h")]
    return ops + [
        ("flux", "ew", "mul", "flux_h", "u"),
        ("dh", "st", "div", "flux"),
        # masked velocity for the tracer advective flux (tendencies.py
        # `h_tracers_edge * (mask * u)`); on land-free meshes the mask
        # collapses to the scalar 1.0 and this op is a free alias
        ("u_m", "ew", "mulc", "u", "$edge_mask"),
    ]


def _tracer_tend_ops(l: int, uw_tr=False):
    t = f"tr{l}"
    if uw_tr:
        adv_ops = [
            (f"t0{l}", "st", "c0", t),
            (f"t1{l}", "st", "c1", t),
            (f"htre{l}", "ew", "upwind_prod", "u", "hp0", f"t0{l}",
             "hp1", f"t1{l}"),
        ]
    else:
        adv_ops = [
            (f"htr{l}", "ew", "mul", "h", t),
            (f"htre{l}", "st", "cmean", f"htr{l}"),
        ]
    return adv_ops + [
        (f"hflux{l}", "ew", "mul", f"htre{l}", "u_m"),
        (f"adv{l}", "st", "div", f"hflux{l}"),
        (f"ctr{l}", "st", "cdiff", t),
        (f"mc{l}", "ew", "mul", "mean_h", f"ctr{l}"),
        (f"d2aux{l}", "st", "sdiv_geo", f"mc{l}"),
        (f"diff2{l}", "st", "sdiv_geo2", f"mc{l}"),
        (f"cd2{l}", "st", "cdiff", f"d2aux{l}"),
        (f"hyp{l}", "st", "sdiv_geo4", f"cd2{l}"),
        (f"dtr{l}", "ew", "tracer_rhs", f"adv{l}", f"diff2{l}",
         f"hyp{l}"),
    ]


def _vel_tend_ops(hv: str, ssh: str = "stacked", uw_h=False):
    # du accumulates term by term; `hv` is the thickness feeding the
    # momentum terms: "h_new" for the forward-backward stepper, "h" for the
    # RK stage chains and the split-explicit chain (every tendency at one
    # level), where mean_hn and flux_hn are aliases of _pre_ops' mean_h and
    # flux_h. `ssh` "column" is the true shared free surface of
    # cfg.ssh_formulation="column": the pressure gradient reads ssh = sum_k
    # h - depth, one value per column, with the depth a cell const plane
    if hv == "h":
        pre_hn = [("mean_hn", "ew", "copy", "mean_h"),
                  ("flux_hn", "ew", "copy", "flux_h")]
    elif uw_h:
        pre_hn = [("hn0", "st", "c0", hv), ("hn1", "st", "c1", hv),
                  ("mean_hn", "ew", "mean2", "hn0", "hn1"),
                  ("flux_hn", "ew", "upwind", "u", "hn0", "hn1")]
    else:
        pre_hn = [("mean_hn", "st", "cmean", hv),
                  ("flux_hn", "ew", "copy", "mean_hn")]
    if ssh == "column":
        gssh = [("sshc", "ew", "ssh_col", hv, "$depth"),
                ("gh", "st", "cgrad", "sshc"),
                ("du", "ew", "gssh_col", "du", "gh")]
    else:
        gssh = [("gh", "st", "cgrad", hv),
                ("du", "ew", "gssh", "du", "gh", "$gdepth")]
    return [
        ("h_v", "st", "kite", hv),
        ("rvort", "st", "curl", "u"),
        ("qv", "ew", "q_vertex", "rvort", "$f_vertex", "h_v"),
        ("q_e", "st", "vmean", "qv"),
        *pre_hn,
        ("F", "ew", "mul", "flux_hn", "u"),
        ("Fq", "ew", "mul", "F", "q_e"),
        ("tf", "st", "tang", "F"),
        ("tfq", "st", "tang", "Fq"),
        ("du", "ew", "pv", "q_e", "tf", "tfq"),       # 0.5*(q_e*tf + tfq)
        ("u2", "ew", "mul", "u", "u"),
        ("ke", "st", "ke", "u2"),
        ("gke", "st", "cgrad", "ke"),
        ("du", "ew", "sub", "du", "gke"),
        *gssh,                                        # du - g*grad(ssh)
        ("div_u", "st", "div", "u"),
        ("cdd", "st", "cgrad", "div_u"),
        ("vdr", "st", "vgrad", "rvort"),
        ("du", "ew", "visc2", "du", "cdd", "vdr", "$scal2"),
        ("vdr_f", "st", "vgrad_floor", "rvort"),
        # EdgeMask applies to the grad-div part of Del2Edge only
        # (VelocityDel2AuxVars.h:40-45, aux.del2_aux)
        ("del2_e", "ew", "sub_mc", "cdd", "vdr_f", "$edge_mask"),
        ("dd2", "st", "div", "del2_e"),
        ("dr2", "st", "curl", "del2_e"),
        ("cd4", "st", "cgrad", "dd2"),
        ("vd4", "st", "vgrad", "dr2"),
        ("du", "ew", "visc4", "du", "cd4", "vd4", "$scal4"),
    ]


def _phys_ops(wind: bool, drag: bool):
    """Wind forcing (top layer) and quadratic bottom drag (bottom layer)
    appended to the du accumulation (TendencyTerms.h:281-340); their
    structure shapes the worst-case validity masks."""
    ops = []
    if wind:
        ops.append(("du", "ew", "wind", "du", "mean_hn", "$wind_stress"))
    if drag:
        ops += [("kee", "st", "cmean", "ke"),
                ("du", "ew", "drag", "du", "kee", "mean_hn", "u")]
    return ops


def _vmix_ops(L: int, pp81=None):
    """Operator-split implicit vertical mixing on the updated state
    (steppers._mix), constant or PP81 coefficients (pp81 = (ti, si)); their
    structure shapes the worst-case validity masks: he_new = cmean(h_new)
    adds one chain radius at the end, the PP81 coefficient sweeps two
    cmean and one ke."""
    ops = [("he_new", "st", "cmean", "h_new")]
    if pp81 is not None:
        ti, si = pp81
        ops += [
            ("duv", "ew", "lanediff", "u_new"),
            ("dze", "ew", "dzhalf", "h_new"),
        ]
        if ti >= 0 and si >= 0:
            ops += [("n2c", "ew", "pp_n2", f"trn{ti}", f"trn{si}",
                     "dze")]
        else:
            ops += [("n2c", "ew", "zero_like", "dze")]
        ops += [
            ("dzee", "st", "cmean", "dze"),
            ("du2", "ew", "mul", "duv", "duv"),
            ("keduv", "st", "ke", "du2"),
            ("kapc", "ew", "pp_kc", "n2c", "keduv", "dze"),
            ("n2e", "st", "cmean", "n2c"),
            ("nue", "ew", "pp_ne", "n2e", "duv", "dzee"),
            ("u_new", "ew", "vmix_u_arr", "u_new", "he_new", "nue"),
        ]
        for l in range(L):
            ops += [(f"trn{l}", "ew", "vmix_c_arr", f"trn{l}", "h_new",
                     "kapc")]
        return ops
    ops += [("u_new", "ew", "vmix_u", "u_new", "he_new")]
    for l in range(L):
        ops += [(f"trn{l}", "ew", "vmix_c", f"trn{l}", "h_new")]
    return ops


def _thick_tracer_ops(L: int, uw_h=False, uw_tr=False):
    """The FB chain's thickness and tracer section: h_new, then per tracer
    its tendency and trn{l}."""
    pre = _pre_ops(uw_h, uw_tr)
    nsplit = len(pre) - 1                 # ops through "dh" (u_m after)
    ops = pre[:nsplit] + [
        ("h_new", "ew", "axpy", "h", -1.0, "dh"),     # h - dt*dh (dt folded)
    ] + pre[nsplit:]
    for l in range(L):
        ops += _tracer_tend_ops(l, uw_tr) + [
            (f"trn{l}", "ew", "tracer_update", f"tr{l}", "h", f"dtr{l}",
             "h_new"),
        ]
    return ops


def fb_chain(L: int, wind=False, drag=False, vmix=False, uw_h=False,
             uw_tr=False, pp=None):
    """The forward-backward step as a chain: h_new, trn{l}, u_new. `uw_h`
    / `uw_tr` select upwind thickness / tracer fluxes, `wind` / `drag`
    the top-layer stress and the bottom drag, `vmix` the implicit
    vertical mixing (PP81 coefficients with `pp` = (T, S) tracer rows,
    else constant ones)."""
    ops = _thick_tracer_ops(L, uw_h, uw_tr)
    ops += _vel_tend_ops("h_new", uw_h=uw_h) + _phys_ops(wind, drag) + [
        # every momentum term carries the edge mask in the composed
        # chain (tendencies.py velocity_tendency); with mask in {0, 1}
        # gating the accumulated du once is bit-identical (and covers
        # the wind and drag terms' per-term masks)
        ("u_new", "ew", "axpy_m", "u", 1.0, "du", "$edge_mask"),
    ]
    if vmix:
        ops += _vmix_ops(L, pp)
    return ops


def split_pre_chain(L: int):
    """Split-explicit phase 1 (stepping/split.py): the full 3-D velocity
    tendency at the current state with the column free surface, emitted
    whole and ungated (du_out). The depth averages, the mode split, the
    frozen slow forcing and the barotropic subcycles run on the flat 2-D
    arrays outside the kernel (ops/patch_megastep.split_patch_megastep_
    framed)."""
    return ([("mean_h", "st", "cmean", "h"),
             # the center-flux alias (split is fused with center fluxes
             # only); the velocity section with hv = "h" reads flux_h for F
             ("flux_h", "ew", "copy", "mean_h")]
            + _vel_tend_ops("h", ssh="column")
            + [("du_out", "ew", "copy", "du")])


def split_post_chain(L: int):
    """Split-explicit phase 3: the thickness and tracer advance with the
    transport velocity, which the caller lays into the frames' u channels
    (u' + <ubar>): the FB chain's thickness and tracer section with center
    fluxes."""
    return _thick_tracer_ops(L)


def fct_stage_a_chain(L: int, wind=False, drag=False, uw_h=False):
    """FCT stage A (of two; ops/patch_megastep.fct_patch_megastep_framed):
    the FB thickness and velocity sections, and per tracer the low-order
    (upwind) provisional field trtd{l} (core/fct.fct_provisional, radius 4)
    and the diffusion-only numerator facc{l} = tr h + dt (ed2 diff2 - ed4
    hyp) (radius 8). The limiter, radius 10 from the original state, runs
    in stage B from these fields after a refresh."""
    pre = _pre_ops(uw_h, False)
    nsplit = len(pre) - 1                 # ops through "dh" (u_m unused)
    ops = pre[:nsplit] + [
        ("h_new", "ew", "axpy", "h", -1.0, "dh"),
        # the thickness equation's own edge flux, masked (core/fct.py)
        ("mflux", "ew", "mulc", "flux", "$edge_mask"),
    ]
    for l in range(L):
        t = f"tr{l}"
        ops += [
            (f"t0{l}", "st", "c0", t),
            (f"t1{l}", "st", "c1", t),
            (f"flo{l}", "ew", "upwind_mean", "u", f"t0{l}", f"t1{l}"),
            (f"flo{l}", "ew", "mul", f"flo{l}", "mflux"),
            (f"dlo{l}", "st", "div", f"flo{l}"),
            (f"trtd{l}", "ew", "tracer_updc", t, "h", f"dlo{l}", "h_new",
             -1.0),
            # the diffusion terms as _tracer_tend_ops
            (f"ctr{l}", "st", "cdiff", t),
            (f"mc{l}", "ew", "mul", "mean_h", f"ctr{l}"),
            (f"d2aux{l}", "st", "sdiv_geo", f"mc{l}"),
            (f"diff2{l}", "st", "sdiv_geo2", f"mc{l}"),
            (f"cd2{l}", "st", "cdiff", f"d2aux{l}"),
            (f"hyp{l}", "st", "sdiv_geo4", f"cd2{l}"),
            (f"dtrd{l}", "ew", "diff_rhs", f"diff2{l}", f"hyp{l}"),
            (f"facc{l}", "ew", "tracer_acc0", t, "h", f"dtrd{l}", 1.0),
        ]
    return ops + _vel_tend_ops("h_new", uw_h=uw_h) \
        + _phys_ops(wind, drag) + [
        ("u_new", "ew", "axpy_m", "u", 1.0, "du", "$edge_mask"),
    ]


def fct_stage_b_chain(L: int, uw_h=False):
    """FCT stage B: the Zalesak limiter (core/fct.py steps 4-5) from the
    refreshed stage-A fields h_new, trtd{l}, facc{l} and the original
    state. Deepest path: flux picks (2), budget divergences (4), limiter
    factors (4), their edge picks (6), the corrected flux's divergence (8):
    the MH = 8 margin exactly."""
    if uw_h:
        ops = [("hp0", "st", "c0", "h"), ("hp1", "st", "c1", "h"),
               ("flux_h", "ew", "upwind", "u", "hp0", "hp1")]
    else:
        ops = [("mean_h", "st", "cmean", "h"),
               ("flux_h", "ew", "copy", "mean_h")]
    ops += [("flux", "ew", "mul", "flux_h", "u"),
            ("mflux", "ew", "mulc", "flux", "$edge_mask")]
    for l in range(L):
        t = f"tr{l}"
        ops += [
            (f"t0{l}", "st", "c0", t),
            (f"t1{l}", "st", "c1", t),
            (f"fhi{l}", "ew", "mean2", f"t0{l}", f"t1{l}"),
            (f"fhi{l}", "ew", "mul", f"fhi{l}", "mflux"),
            (f"flo{l}", "ew", "upwind_mean", "u", f"t0{l}", f"t1{l}"),
            (f"flo{l}", "ew", "mul", f"flo{l}", "mflux"),
            (f"fa{l}", "ew", "sub", f"fhi{l}", f"flo{l}"),
            (f"fbp{l}", "ew", "relu", f"fa{l}"),
            (f"fbn{l}", "ew", "relu_neg", f"fa{l}"),
            (f"pi1{l}", "st", "div_neg", f"fbp{l}"),
            (f"pi2{l}", "st", "div_pos", f"fbn{l}"),
            (f"pin{l}", "ew", "fct_p", f"pi1{l}", f"pi2{l}"),
            (f"po1{l}", "st", "div_pos", f"fbp{l}"),
            (f"po2{l}", "st", "div_neg", f"fbn{l}"),
            (f"pout{l}", "ew", "fct_p", f"po1{l}", f"po2{l}"),
            # bounds: extrema over the cell and its 6 picks of the old and
            # the transported field (max / min fold in any order exactly)
            (f"tmax{l}", "ew", "max2", t, f"trtd{l}"),
            (f"tmin{l}", "ew", "min2", t, f"trtd{l}"),
        ]
        for j in range(6):
            ops += [
                (f"nb{l}", "st", f"coc{j}", t),
                (f"tmax{l}", "ew", "max2", f"tmax{l}", f"nb{l}"),
                (f"tmin{l}", "ew", "min2", f"tmin{l}", f"nb{l}"),
                (f"nb{l}", "st", f"coc{j}", f"trtd{l}"),
                (f"tmax{l}", "ew", "max2", f"tmax{l}", f"nb{l}"),
                (f"tmin{l}", "ew", "min2", f"tmin{l}", f"nb{l}"),
            ]
        ops += [
            (f"qin{l}", "ew", "fct_q", f"tmax{l}", f"trtd{l}", "h_new"),
            (f"rin{l}", "ew", "fct_r", f"qin{l}", f"pin{l}"),
            (f"qout{l}", "ew", "fct_q", f"trtd{l}", f"tmin{l}", "h_new"),
            (f"rout{l}", "ew", "fct_r", f"qout{l}", f"pout{l}"),
            (f"ri0{l}", "st", "c0", f"rin{l}"),
            (f"ri1{l}", "st", "c1", f"rin{l}"),
            (f"ro0{l}", "st", "c0", f"rout{l}"),
            (f"ro1{l}", "st", "c1", f"rout{l}"),
            (f"fc{l}", "ew", "fct_corr", f"fa{l}", f"flo{l}", f"ri0{l}",
             f"ri1{l}", f"ro0{l}", f"ro1{l}"),
            (f"adv{l}", "st", "div", f"fc{l}"),
            (f"trn{l}", "ew", "tracer_fin", f"facc{l}", f"adv{l}", "h_new",
             -1.0),
        ]
    return ops


def _rk_tend_ops(L: int, wind=False, drag=False, uw_h=False, uw_tr=False):
    """ALL tendencies at the in-kernel state (h, u, tr{l}): unlike the
    forward-backward chain the momentum terms read the SAME h (mean_hn is
    mean_h, F is flux)."""
    ops = list(_pre_ops(uw_h, uw_tr))
    for l in range(L):
        ops += _tracer_tend_ops(l, uw_tr)
    return ops + _vel_tend_ops("h", uw_h=uw_h) + _phys_ops(wind, drag)


def _rk_update_ops(L: int, mode: str, b: str, ca: float, cb: float):
    """The stage update of an RK stage chain from its tendencies (dh, du,
    dtr{l}), coefficients times dt (`ca`, `cb`) as the ops' literals:

      "prov"   out = base + ca k                  (both RK2 stages)
      "first"  out = base + ca k ; acc = (h, u, tr h)(base) + cb k
      "mid"    out = base + ca k ; acc = acc + cb k
      "last"   out = acc + cb k

    with `b` the suffix of the base's names ("" for the in-kernel state,
    "0" for the original state h0 / u0 / tr0{l}), the accumulator in
    h_a / u_a / tra{l} (thickness-weighted tracers) and out's tracers
    (tr h of base + ca dtr) / out's h (TimeStepper.h:205-237). Outputs are
    h_new / u_new / trn{l} and h_acc / u_acc / tracc{l}."""
    if mode == "last":
        return ([("h_new", "ew", "axpy", "h_a", -cb, "dh")]
                + [(f"trn{l}", "ew", "tracer_fin", f"tra{l}", f"dtr{l}",
                    "h_new", cb) for l in range(L)]
                + [("u_new", "ew", "axpy_m", "u_a", cb, "du", "$edge_mask")])
    trb = [f"tr{b}{l}" if b else f"tr{l}" for l in range(L)]
    ops = [("h_new", "ew", "axpy", f"h{b}", -ca, "dh")]
    ops += [(f"trn{l}", "ew", "tracer_updc", trb[l], f"h{b}", f"dtr{l}",
             "h_new", ca) for l in range(L)]
    ops += [("u_new", "ew", "axpy_m", f"u{b}", ca, "du", "$edge_mask")]
    if mode == "first":
        ops += [("h_acc", "ew", "axpy", f"h{b}", -cb, "dh")]
        ops += [(f"tracc{l}", "ew", "tracer_acc0", trb[l], f"h{b}",
                 f"dtr{l}", cb) for l in range(L)]
        ops += [("u_acc", "ew", "axpy_m", f"u{b}", cb, "du", "$edge_mask")]
    elif mode == "mid":
        ops += [("h_acc", "ew", "axpy", "h_a", -cb, "dh")]
        ops += [(f"tracc{l}", "ew", "axpy", f"tra{l}", cb, f"dtr{l}")
                for l in range(L)]
        ops += [("u_acc", "ew", "axpy_m", "u_a", cb, "du", "$edge_mask")]
    return ops


def rk_stage_ops(L: int, mode: str, b: str, ca: float, cb: float,
                 wind=False, drag=False, uw_h=False, uw_tr=False):
    """One RK stage's horizontal chain: the tendencies at the in-kernel
    state, then `_rk_update_ops(L, mode, b, ca, cb)`."""
    return (_rk_tend_ops(L, wind, drag, uw_h, uw_tr)
            + _rk_update_ops(L, mode, b, ca, cb))


def rk2_stage_chain(L: int, base: str, coef: float, wind=False,
                    drag=False, vmix=False, uw_h=False, uw_tr=False,
                    pp=None):
    """One RK2 stage (stepping.steppers.rk2_step): all tendencies at the
    in-kernel state, then the state update from the `base` state with
    `coef` dt:

      stage A: base "" (the in-kernel state itself), coef 0.5 -> midpoint
      stage B: base "0" (the original state h0 / u0 / tr0{l}), coef 1.0
               -> the full step, then with `vmix` the vertical mixing

    Outputs keep the h_new / u_new / trn{l} names, so the FB chain's
    exactness masks and refresh maps apply unchanged (both stages are
    shallower than the FB chain: the masks are conservative)."""
    ops = rk_stage_ops(L, "prov", base, coef, 0.0, wind, drag, uw_h, uw_tr)
    if vmix and base:          # the final stage updates the full step
        ops += _vmix_ops(L, pp)
    return ops


# classic RK4: stage weights a (also the stage times) and b
_RKA = (0.0, 0.5, 0.5, 1.0)
_RKB = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rk4_stage_chain(L: int, stage: int, wind=False, drag=False,
                    vmix=False, uw_h=False, uw_tr=False, pp=None):
    """One classic-RK4 stage (stepping.steppers.rk4_step): k_s = all
    tendencies at the in-kernel state (stage 1's is the original; stages
    2-4 read the refreshed provisional state, with the original in h0 /
    u0 / tr0{l} and the accumulator in h_a / u_a / tra{l}). Stages 1-3
    emit the next provisional state (h_new / u_new / trn{l}) and the
    updated accumulator (h_acc / u_acc / tracc{l}, thickness-weighted
    tracers); stage 4 emits the final state, then with `vmix` the vertical
    mixing."""
    mode = {1: "first", 4: "last"}.get(stage, "mid")
    ops = rk_stage_ops(L, mode, "" if stage == 1 else "0",
                       _RKA[stage] if stage < 4 else 0.0, _RKB[stage - 1],
                       wind, drag, uw_h, uw_tr)
    if vmix and stage == 4:
        ops += _vmix_ops(L, pp)
    return ops


# the element class of every chain value
CLASS_OF = {"h": "cell", "u": "edge", "u_m": "edge",
            "h0": "cell", "u0": "edge",
            "h_a": "cell", "u_a": "edge",
            "h_acc": "cell", "u_acc": "edge",
            "mean_h": "edge", "flux": "edge",
            "dh": "cell", "h_new": "cell", "u2": "edge", "ke": "cell",
            "div_u": "cell", "rvort": "vertex", "h_v": "vertex",
            "qv": "vertex", "q_e": "edge", "cdd": "edge", "vdr_f": "edge",
            "vdr": "edge", "del2_e": "edge", "dd2": "cell", "dr2": "vertex",
            "mean_hn": "edge", "F": "edge", "Fq": "edge", "tf": "edge",
            "tfq": "edge", "gke": "edge", "gh": "edge", "cd4": "edge",
            "vd4": "edge", "du": "edge", "u_new": "edge",
            "kee": "edge", "he_new": "edge",
            "sshc": "cell", "du_out": "edge",
            "hp0": "edge", "hp1": "edge", "hn0": "edge", "hn1": "edge",
            "flux_h": "edge", "flux_hn": "edge",
            "duv": "edge", "dze": "cell", "n2c": "cell", "dzee": "edge",
            "du2": "edge", "keduv": "cell", "kapc": "cell",
            "n2e": "edge", "nue": "edge", "mflux": "edge"}

# per-tracer value prefixes; order matters where one prefix starts another
# ("tracc" and "tra" before "tr", "facc" before "fa")
_PREFIXES = (("tracc", "cell"), ("tra", "cell"), ("tr", "cell"),
             ("t0", "edge"), ("t1", "edge"), ("htre", "edge"),
             ("hflux", "edge"), ("htr", "cell"), ("adv", "cell"),
             ("ctr", "edge"), ("mc", "edge"), ("d2aux", "cell"),
             ("diff2", "cell"), ("cd2", "edge"), ("hyp", "cell"),
             ("dtr", "cell"), ("trn", "cell"),
             ("trtd", "cell"), ("facc", "cell"), ("dtrd", "cell"),
             ("flo", "edge"), ("fhi", "edge"), ("fbp", "edge"),
             ("fbn", "edge"), ("fa", "edge"), ("fc", "edge"),
             ("dlo", "cell"), ("pi1", "cell"), ("pi2", "cell"),
             ("po1", "cell"), ("po2", "cell"), ("pin", "cell"),
             ("pout", "cell"), ("tmax", "cell"), ("tmin", "cell"),
             ("nb", "cell"), ("qin", "cell"), ("qout", "cell"),
             ("rin", "cell"), ("rout", "cell"), ("ri0", "edge"),
             ("ri1", "edge"), ("ro0", "edge"), ("ro1", "edge"))


def chain_class(name: str) -> str:
    """The element class ("cell", "edge", "vertex") of a chain value; a
    per-tracer name is a prefix and the tracer's index (tr00 is tracer 0
    of the original state)."""
    if name in CLASS_OF:
        return CLASS_OF[name]
    for pre, cls in _PREFIXES:
        if name.startswith(pre) and name[len(pre):].isdigit():
            return cls
    raise KeyError(name)


def validity_chain(mh: int, phys_masks: bool):
    """The chain the validity masks are built for: the worst case (wind,
    drag and PP81 mixing on: the vmix edge-thickness cmean erodes u_new by
    one extra ring and the PP81 sweeps erode the tracers likewise), so the
    masks are conservative-correct for every chain variant — a physics-off
    chain is exact at strictly more positions than the masks claim, and
    refreshing an exact position from another exact copy of the same
    element is the identity. A margin below 7 cannot hold the radius-7
    vmix chain, and `phys_masks=False` asks for the tight radius-6 masks
    of the flagship chain; both leave the physics out."""
    vm_ok = mh >= 7 and phys_masks
    return fb_chain(1, wind=True, drag=True, vmix=vm_ok,
                    pp=(0, 0) if vm_ok else None)


def chain_validity(tables: Dict[str, MegaTable], content, resolved,
                   L: int, ops, state_masks=None,
                   extra_inputs=()) -> Dict[str, np.ndarray]:
    """Propagate exactness masks through a chain.

    `resolved[name]` is the per-dst-position bool mask of positions whose
    stencil fully resolved.  State values are exact wherever content
    exists (override with `state_masks` (cell, edge) to emulate a tile
    slab boundary).  `extra_inputs` lists (name, class) pairs of further
    chain inputs (FCT stage B's refreshed fields), exact where the state
    of their class is.  Returns the mask of every chain value."""
    if state_masks is None:
        state_masks = {"cell": content["cell"] >= 0,
                       "edge": content["edge"] >= 0}
    masks: Dict[str, np.ndarray] = {
        "h": state_masks["cell"],
        "u": state_masks["edge"],
    }
    for l in range(L):
        masks[f"tr{l}"] = masks["h"]
    for nm, cls in extra_inputs:
        masks[nm] = state_masks[cls]
    plane_mask = {"$f_vertex": content["vertex"] >= 0,
                  "$gdepth": content["edge"] >= 0,
                  "$scal2": content["edge"] >= 0,
                  "$scal4": content["edge"] >= 0,
                  "$edge_mask": content["edge"] >= 0,
                  "$wind_stress": content["edge"] >= 0,
                  "$depth": content["cell"] >= 0}
    for op in ops:
        name, kind = op[0], op[1]
        if kind == "st":
            tab = tables[op[2]]
            src = masks[op[3]]
            # exact: a destination is valid iff its stencil resolved and
            # every source position an entry actually reads (nonzero
            # weight at this destination) holds a valid value — zero
            # weights make lattice holes harmless, so they don't poison
            out = resolved[op[2]].copy()
            S = src.shape[-1]
            for (td, ts, da, db, wpl) in tab.entries:
                used = wpl != 0.0                    # (10, S, S)
                sh = np.zeros((10, S, S), bool)      # src valid at p+off
                ys = slice(max(0, db), min(S, S + db))
                yd = slice(max(0, -db), min(S, S - db))
                xs = slice(max(0, da), min(S, S + da))
                xd = slice(max(0, -da), min(S, S - da))
                sh[:, yd, xd] = src[ts][:, ys, xs]
                out[td] &= ~used | sh
            masks[name] = out
        else:
            m = None
            for a in op[3:]:
                if isinstance(a, str):
                    am = plane_mask[a] if a.startswith("$") else masks[a]
                    m = am if m is None else (m & am)
            masks[name] = m
    return masks


def kernel_validity(tables, content, resolved, n, by, R, ops, mh,
                    out_keys=("h_new", "u_new", "trn0"), extra_inputs=()):
    """Exactness of the TILED kernel's outputs (`out_keys`) at every frame
    position; `extra_inputs` as in chain_validity.

    The reference kernel partitions the S x S frame into (byy, byx) tiles,
    each computed on a radius-R slab; values creep garbage inward from the
    slab edge exactly as a frame boundary would.  Emulated by running
    the chain-validity pass with state masks clipped to each tile's
    slab box; a frame position's kernel validity is its validity in the
    ONE tile that writes it.  (Identical slab boxes across the 10
    patches let each (ty, tx) run cover all patches at once.)  A kernel
    that evaluates whole frames is exact wherever the tiled one is."""
    S = n + 2 * mh
    byy, byx = (by, by) if isinstance(by, int) else by
    if S % byy or S % byx:
        raise ValueError(f"tile {by} does not divide the frame ({S})")
    base = {"cell": content["cell"] >= 0, "edge": content["edge"] >= 0}
    outs = {}
    for ty in range(S // byy):
        for tx in range(S // byx):
            box = np.zeros((1, 1, S, S), bool)
            box[:, :, max(0, ty * byy - R):ty * byy + byy + R,
                max(0, tx * byx - R):tx * byx + byx + R] = True
            sm = {k: v & box for k, v in base.items()}
            m = chain_validity(tables, content, resolved, 1, ops,
                               state_masks=sm, extra_inputs=extra_inputs)
            ys = slice(ty * byy, ty * byy + byy)
            xs = slice(tx * byx, tx * byx + byx)
            for k in out_keys:
                if k not in outs:
                    outs[k] = np.zeros(m[k].shape, bool)
                outs[k][:, :, ys, xs] = m[k][:, :, ys, xs]
    return outs


def _pasteback_one(cont, clean, n, N, mh):
    """Paste-back maps for ONE output field of one element class.

    Natural grid slots with clean content==natural are covered by the
    pure reshape paste of the kernel's rim output; all other live rows
    (tail elements, dead-slot occupants pushed elsewhere, seam orphans)
    are recovered from ANY clean rim position.  Rows with no clean
    position anywhere form the fix set.  `N` is the TRUE flat row count.

    Returns (rim_rows, rim_pos, dead_rows, fix_rows)."""
    S = cont.shape[-1]
    no = n + 2 * OH
    NG = 10 * n * n
    T = cont.shape[0]
    nat = np.full((T, 10, S, S), -1, np.int64)
    nat[:, :, mh:mh + n, mh:mh + n] = np.arange(
        T * NG, dtype=np.int64).reshape(T, 10, n, n)
    ok_nat = (cont == nat) & clean & (nat >= 0)
    covered = np.zeros(N, bool)
    covered_ids = np.unique(cont[ok_nat]) if ok_nat.any() else \
        np.zeros(0, np.int64)
    covered[covered_ids] = True
    # candidates: clean rim positions [MH-OH, MH+n+OH)
    rim = np.zeros((T, 10, S, S), bool)
    rim[:, :, mh - OH:mh + n + OH, mh - OH:mh + n + OH] = True
    cand = rim & clean & (cont >= 0)
    rows, poss = [], []
    seen = set()
    ids = cont.reshape(-1)
    for flat in np.flatnonzero(cand):
        D = int(ids[flat])
        if covered[D] or D in seen:
            continue
        seen.add(D)
        # frame flat pos -> rim-output flat pos
        t, rem = divmod(int(flat), 10 * S * S)
        r, rem = divmod(rem, S * S)
        y, x = divmod(rem, S)
        yo, xo = y - (mh - OH), x - (mh - OH)
        rows.append(D)
        poss.append(((t * 10 + r) * no + yo) * no + xo)
    rows_a = np.asarray(rows, np.int64)
    alive = np.zeros(N, bool)
    alive[covered_ids] = True
    alive[rows_a] = True
    # rows that are not real elements at all (dead grid slots):
    # ids < T*NG never appearing as content anywhere
    is_elem = np.zeros(N, bool)
    is_elem[np.unique(cont[cont >= 0])] = True
    dead_grid = np.zeros(N, bool)
    dead_grid[:T * NG] = ~is_elem[:T * NG]
    # tail ids (>= T*NG) are real elements by construction
    is_elem[T * NG:] = True
    fix = np.flatnonzero(is_elem & ~alive & ~dead_grid)
    return (rows_a.astype(np.int32), np.asarray(poss, np.int32),
            np.flatnonzero(dead_grid).astype(np.int32),
            fix.astype(np.int32))


# ----------------------------------------------------------------------
# fix submesh (poles + anything else unresolved)

def _extract_submesh(mesh, cell_ids: np.ndarray):
    """Standalone HorzMesh over `cell_ids` (+nothing else): local ids in
    the given order; edges/vertices = those fully inside, others padded
    out.  Used only for the tiny pole-fix patch, where every fix row is
    far from the cut."""
    g = unclamped_connectivity(mesh)
    a = lambda nm: np.asarray(getattr(mesh, nm))
    C = mesh.ncells
    c_o2n = np.full(C, -1, np.int64)
    c_o2n[cell_ids] = np.arange(len(cell_ids))
    # local edges/vertices: incident to any local cell
    eoc = g["edges_on_cell"][cell_ids]
    voc = g["vertices_on_cell"][cell_ids]
    loc_e = np.unique(eoc[eoc >= 0])
    loc_v = np.unique(voc[voc >= 0])
    e_o2n = np.full(mesh.nedges, -1, np.int64)
    e_o2n[loc_e] = np.arange(len(loc_e))
    v_o2n = np.full(mesh.nvertices, -1, np.int64)
    v_o2n[loc_v] = np.arange(len(loc_v))

    def remap(idx, o2n):
        idx = np.asarray(idx, np.int64)
        out = o2n[np.maximum(idx, 0)]
        return np.where(idx >= 0, out, -1)

    raw = dict(
        x_cell=a("x_cell")[cell_ids], y_cell=a("y_cell")[cell_ids],
        lon_cell=a("lon_cell")[cell_ids], lat_cell=a("lat_cell")[cell_ids],
        area_cell=a("area_cell")[cell_ids], f_cell=a("f_cell")[cell_ids],
        bottom_depth=a("bottom_depth")[cell_ids],
        n_edges_on_cell=a("n_edges_on_cell")[cell_ids],
        edges_on_cell=remap(g["edges_on_cell"][cell_ids], e_o2n),
        cells_on_cell=remap(g["cells_on_cell"][cell_ids], c_o2n),
        vertices_on_cell=remap(g["vertices_on_cell"][cell_ids], v_o2n),
        x_edge=a("x_edge")[loc_e], y_edge=a("y_edge")[loc_e],
        lon_edge=a("lon_edge")[loc_e], lat_edge=a("lat_edge")[loc_e],
        dc_edge=a("dc_edge")[loc_e], dv_edge=a("dv_edge")[loc_e],
        angle_edge=a("angle_edge")[loc_e], f_edge=a("f_edge")[loc_e],
        cells_on_edge=remap(g["cells_on_edge"][loc_e], c_o2n),
        vertices_on_edge=remap(g["vertices_on_edge"][loc_e], v_o2n),
        n_edges_on_edge=a("n_edges_on_edge")[loc_e],
        edges_on_edge=remap(g["edges_on_edge"][loc_e], e_o2n),
        weights_on_edge=a("weights_on_edge")[loc_e],
        mesh_scaling_del2=a("mesh_scaling_del2")[loc_e],
        mesh_scaling_del4=a("mesh_scaling_del4")[loc_e],
        x_vertex=a("x_vertex")[loc_v], y_vertex=a("y_vertex")[loc_v],
        lon_vertex=a("lon_vertex")[loc_v], lat_vertex=a("lat_vertex")[loc_v],
        area_triangle=a("area_triangle")[loc_v],
        f_vertex=a("f_vertex")[loc_v],
        cells_on_vertex=remap(g["cells_on_vertex"][loc_v], c_o2n),
        edges_on_vertex=remap(g["edges_on_vertex"][loc_v], e_o2n),
        kite_areas_on_vertex=a("kite_areas_on_vertex")[loc_v],
    )
    sub = finalize_mesh(raw, ncells=len(cell_ids), nedges=len(loc_e),
                        nvertices=len(loc_v), max_edges=mesh.max_edges,
                        vertex_degree=mesh.vertex_degree,
                        on_sphere=mesh.on_sphere,
                        sphere_radius=mesh.sphere_radius)
    # finalize re-derives edge_mask / kite weights from geometry alone,
    # which loses any LAND masking applied to the parent (mesh/
    # icos_patches.apply_land_mask).  Fold the parent's zeros back in
    # multiplicatively so finalize's own zeros (submesh-boundary edges,
    # out-of-submesh kite slots) survive.
    p_em = a("edge_mask")[loc_e]
    p_kite = a("w_kite_frac")[loc_v]
    sub = dataclasses.replace(
        sub,
        edge_mask=np.asarray(sub.edge_mask) * (p_em != 0.0),
        w_kite_frac=np.asarray(sub.w_kite_frac) * (p_kite != 0.0))
    return sub, loc_e, loc_v


def _grow(mesh, cells: set, width: int) -> np.ndarray:
    coc = np.asarray(unclamped_connectivity(mesh)["cells_on_cell"], np.int64)
    cur = set(cells)
    frontier = set(cells)
    for _ in range(width):
        nxt = set()
        for c in frontier:
            for nb in coc[c]:
                if nb >= 0 and nb not in cur:
                    nxt.add(int(nb))
        cur |= nxt
        frontier = nxt
    return np.array(sorted(cur), np.int64)


# ----------------------------------------------------------------------

def _build(mesh, info: ip.PatchInfo, mh: int, tile, phys_masks: bool):
    n = info.n
    content = _wide_content(mesh, info, mh)
    fills = _fills_from_content(content, n, mh)
    pos_of = _positions_of(content)

    tables, resolved = {}, {}
    res = _resolution_weights(mesh)
    for name, idx, dst, src, w in _table_specs(mesh):
        max_off = 4 if name == "tang" else 2
        tables[name], resolved[name] = _build_mega_table(
            n, content, pos_of, name, idx, w, dst, src, max_off, mh,
            res.get(name))

    # exactness of every chain value at every frame position, INCLUDING
    # the tiled reference kernel's slab-creep (validity erodes from lattice
    # holes, unresolved stencils, and tile-slab edges by the real chain
    # structure, not a conservative ball)
    S = n + 2 * mh
    ty_, tx_ = (tile, tile) if isinstance(tile, int) else tile

    # the reference's tile choice: the largest divisor of S up to the
    # requested size that is a multiple of 8, else the largest divisor
    def pick(t):
        cand = [b for b in range(1, max(t, 1) + 1) if S % b == 0]
        oct_ = [b for b in cand if b % 8 == 0]
        return max(oct_) if oct_ else max(cand)
    by = (pick(ty_), pick(tx_))
    masks = kernel_validity(tables, content, resolved, n, by, mh,
                            validity_chain(mh, phys_masks), mh)

    outputs, fix = _fix_closure(mesh, content, n, (
        ("h", masks["h_new"], "cell", mesh.ncells),
        ("u", masks["u_new"], "edge", mesh.nedges),
        ("tr", masks["trn0"], "cell", mesh.ncells)), mh)

    return MegaInfo(
        n=n, mh=mh, by=by, content=content, fills=fills, tables=tables,
        const_planes=_const_planes(mesh, content),
        outputs=outputs, masks=masks, resolved=resolved, **fix)


def _fix_closure(mesh, content, n, outspec, mh):
    """Paste maps + fix sets + fix submesh for a set of kernel outputs.

    outspec: (out_name, validity_mask, class, flat_count) per output.
    Returns (outputs dict, dict of MegaInfo fix/submesh fields)."""
    outputs = {}
    for out_name, mask, cls, N in outspec:
        outputs[out_name] = _pasteback_one(content[cls], mask, n, N, mh)

    # fix set -> cells to recompute on the submesh: fix cells (cell-
    # class output rows) + both cells of every fix edge
    coe = np.asarray(unclamped_connectivity(mesh)["cells_on_edge"], np.int64)
    fix_c = set()
    fix_e = set()
    for out_name, mask, cls, N in outspec:
        rows = outputs[out_name][3]
        if cls == "cell":
            fix_c.update(int(c) for c in rows)
        else:
            fix_e.update(int(e) for e in rows)
    fix_edges_global = np.asarray(sorted(fix_e), np.int64)
    for e in fix_edges_global:
        for c in coe[int(e)]:
            if c >= 0:
                fix_c.add(int(c))
    fix_cells_global = np.asarray(sorted(fix_c), np.int64)
    sub_cells = _grow(mesh, fix_c, SUB_GROW)
    sub, loc_e, loc_v = _extract_submesh(mesh, sub_cells)
    c_o2n = np.full(mesh.ncells, -1, np.int64)
    c_o2n[sub_cells] = np.arange(len(sub_cells))
    fix_cells_local = c_o2n[fix_cells_global]
    e_o2n = np.full(mesh.nedges, -1, np.int64)
    e_o2n[loc_e] = np.arange(len(loc_e))
    fix_edges_local = e_o2n[fix_edges_global]
    if (fix_cells_local < 0).any() or (fix_edges_local < 0).any():
        raise RuntimeError("a fix row lies outside its submesh")
    return outputs, dict(
        sub_mesh=sub, sub_cells=sub_cells, sub_edges=loc_e,
        fix_cells_local=fix_cells_local.astype(np.int32),
        fix_cells_global=fix_cells_global.astype(np.int32),
        fix_edges_local=fix_edges_local.astype(np.int32),
        fix_edges_global=fix_edges_global.astype(np.int32))
