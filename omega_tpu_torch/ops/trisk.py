"""TRiSK horizontal stencil operators.

The reference implements these as per-element Kokkos functors with inner
neighbor loops (ocn/HorzOperators.h:9-187). Here every operator is a
whole-array weighted gather: neighbor indices are static (C, M) int32
arrays (padded entries point at element 0 with weight 0) and the vertical
dimension K is the trailing axis of every field.

Four execution paths, numerically equivalent:
  * gather path — general unstructured MPAS meshes; also the oracle the
    tests hold the structured path against
  * table path  — unstructured meshes with gather tables (`warm_gather`,
    built by mesh/reorder.reorder_mesh): one pass of the gather kernel
    (ops/gather_kernel.py) per operator on a CUDA field, its plain version
    on a CPU field
  * shift path  — uniform planar hex meshes (ops/structured.py): every
    neighbor access becomes a lattice shift (the stencil kernel on a CUDA
    field, rolls on a CPU field)
  * patch path  — patch-renumbered icosahedral meshes
    (ops/patch_stencil.py): per-patch slices with per-position weights and
    an exact gather fix-up

Besides the five classic operators, this module exposes the gather
PRIMITIVES the aux-var/tendency layers build on (cell/vertex pairs on
edges, kite-weighted cell->vertex, signed edge->cell sums), so the whole
hot path inherits the fast path on structured meshes.

Field shape conventions: cell fields (..., C, K), edge fields (..., E, K),
vertex fields (..., V, K). Operators are linear maps between classes.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.mesh.horz_mesh import HorzMesh, unclamped_connectivity
from omega_tpu_torch.ops import gather_kernel, patch_stencil, structured

# index_select launches of the gather path since the last reset (a plain
# integer: the smoke run shows that operators with a table make none)
take_launches = 0


def _take(field, idx):
    """field[..., idx, :] for an index array of any shape."""
    global take_launches
    take_launches += 1
    flat = field.index_select(-2, idx.reshape(-1))
    return flat.reshape(field.shape[:-2] + tuple(idx.shape)
                        + field.shape[-1:])


def _gather_sum(weights, idx, field):
    """sum_j weights[n, j] * field[..., idx[n, j], k] -> (..., n, K)."""
    g = _take(field, idx)                        # (..., N, M, K)
    return torch.einsum("nj,...njk->...nk", weights.to(field.dtype), g)


def _struct(mesh, name, idx, dst, src, weights=None):
    """Fast-path stencil table — uniform planar shifts (name-tagged) or
    icosahedral patch slices ("patch", table) — or None."""
    if structured.enabled(mesh):
        tab, dstc, srcc = structured.stencil_table(mesh, name, idx, dst,
                                                   src, weights)
        return (tab, dstc, srcc, name) if tab is not None else None
    if patch_stencil.enabled(mesh):
        t = patch_stencil.table(mesh, name)
        if t is not None:
            return ("patch", t)
    return None


def _apply(mesh, t, f):
    """Apply a table from `_struct` to a field."""
    if t[0] == "patch":
        return patch_stencil.apply_patch_stencil(mesh, t[1], f)
    return structured.apply_stencil(mesh, t, f)


def col(mesh: HorzMesh, attr: str):
    """Per-element column of a mesh array for broadcasting against
    (..., N, K) fields: a plain python scalar when the array is uniform on
    a structured mesh, else the (N, 1) column."""
    sc = structured.uniform_scalar(mesh, attr)
    if sc is not None:
        return sc
    return getattr(mesh, attr)[:, None]


def warm_structured(mesh: HorzMesh) -> bool:
    """Eagerly build every stencil table for a structured mesh while its
    arrays are host numpy (called by the planar generator). Returns True
    when the shift path is fully available."""
    if not structured.enabled(mesh):
        return False
    w_signed = -np.asarray(mesh.edge_sign_on_cell) / np.asarray(
        mesh.area_cell)[:, None]
    w_div = np.asarray(mesh.w_div_cell)
    specs = [
        ("div_pos", mesh.edges_on_cell, "cell", "edge",
         np.maximum(w_div, 0.0)),
        ("div_neg", mesh.edges_on_cell, "cell", "edge",
         np.maximum(-w_div, 0.0)),
        ("div", mesh.edges_on_cell, "cell", "edge", mesh.w_div_cell),
        ("ke", mesh.edges_on_cell, "cell", "edge", mesh.w_ke_cell),
        ("signed_div", mesh.edges_on_cell, "cell", "edge", w_signed),
        ("curl", mesh.edges_on_vertex, "vertex", "edge", mesh.w_curl_vertex),
        ("kite", mesh.cells_on_vertex, "vertex", "cell", mesh.w_kite_frac),
        ("tang", mesh.edges_on_edge, "edge", "edge", mesh.weights_on_edge),
        ("c0", mesh.cells_on_edge[:, 0], "edge", "cell", None),
        ("c1", mesh.cells_on_edge[:, 1], "edge", "cell", None),
        ("v0", mesh.vertices_on_edge[:, 0], "edge", "vertex", None),
        ("v1", mesh.vertices_on_edge[:, 1], "edge", "vertex", None),
        ("cdiff", mesh.cells_on_edge, "edge", "cell",
         np.tile([-1.0, 1.0], (mesh.nedges, 1))),
        ("cmean", mesh.cells_on_edge, "edge", "cell",
         np.full((mesh.nedges, 2), 0.5)),
        ("vdiff", mesh.vertices_on_edge, "edge", "vertex",
         np.tile([-1.0, 1.0], (mesh.nedges, 1))),
        ("vmean", mesh.vertices_on_edge, "edge", "vertex",
         np.full((mesh.nedges, 2), 0.5)),
    ] + [(f"coc{j}", np.asarray(mesh.cells_on_cell)[:, j], "cell", "cell",
          None) for j in range(mesh.cells_on_cell.shape[1])]
    ok = True
    for name, idx, dst, src, w in specs:
        tab, _, _ = structured.stencil_table(mesh, name, idx, dst, src, w)
        ok = ok and tab is not None
    return ok


def warm_gather(mesh: HorzMesh) -> HorzMesh:
    """Build the gather tables of an UNSTRUCTURED mesh (host side, numpy
    arrays) and return the mesh with them in `gather_info`; the TRiSK
    operators that have a table then take the table path. Meant for a mesh
    with bounded index bandwidth (mesh/reorder.reorder_mesh, RCM), where
    each block of rows reads a narrow window of sources; every table is
    built whatever its window (a direct gather has no window to fit)."""
    import dataclasses

    C, E, V = mesh.ncells, mesh.nedges, mesh.nvertices
    w_signed = -np.asarray(mesh.edge_sign_on_cell) / np.asarray(
        mesh.area_cell)[:, None]
    w_div = np.asarray(mesh.w_div_cell)
    # boundary meshes: the 2-slot entries of a missing neighbour get weight
    # 0 from the unclamped form (the index_select path reads the clamped
    # element-0 value there instead; both are masked downstream)
    unc = unclamped_connectivity(mesh)
    coe_u = unc["cells_on_edge"]
    voe_u = unc["vertices_on_edge"]
    vw = lambda raw, w01: np.where(raw >= 0, np.asarray(w01), 0.0)
    cl = lambda raw: np.maximum(raw, 0)
    specs = [
        ("div", mesh.edges_on_cell, w_div, E),
        ("div_pos", mesh.edges_on_cell, np.maximum(w_div, 0.0), E),
        ("div_neg", mesh.edges_on_cell, np.maximum(-w_div, 0.0), E),
        ("ke", mesh.edges_on_cell, mesh.w_ke_cell, E),
        ("signed_div", mesh.edges_on_cell, w_signed, E),
        ("curl", mesh.edges_on_vertex, mesh.w_curl_vertex, E),
        ("kite", mesh.cells_on_vertex, mesh.w_kite_frac, C),
        ("tang", mesh.edges_on_edge, mesh.weights_on_edge, E),
        ("cdiff", cl(coe_u), vw(coe_u, [-1.0, 1.0]), C),
        ("cmean", cl(coe_u), vw(coe_u, [0.5, 0.5]), C),
        ("vdiff", cl(voe_u), vw(voe_u, [-1.0, 1.0]), V),
        ("vmean", cl(voe_u), vw(voe_u, [0.5, 0.5]), V),
        ("c0", cl(coe_u[:, :1]), vw(coe_u[:, :1], [1.0]), C),
        ("c1", cl(coe_u[:, 1:]), vw(coe_u[:, 1:], [1.0]), C),
        ("v0", cl(voe_u[:, :1]), vw(voe_u[:, :1], [1.0]), V),
        ("v1", cl(voe_u[:, 1:]), vw(voe_u[:, 1:], [1.0]), V),
    ]
    tables = {name: gather_kernel.GatherTable(np.asarray(idx),
                                              np.asarray(w), nsrc)
              for name, idx, w, nsrc in specs}
    return dataclasses.replace(mesh, gather_info=tables)


def _gtab(mesh, name):
    """The mesh's gather table `name`, or None."""
    info = getattr(mesh, "gather_info", None)
    return None if info is None else info.get(name)


# ----------------------------------------------------------------------
# primitives

def _pair(mesh, f, name0, name1, idx0, idx1, dst, src):
    t0 = _struct(mesh, name0, idx0, dst, src)
    if t0 is None:
        g0, g1 = _gtab(mesh, name0), _gtab(mesh, name1)
        if g0 is not None and g1 is not None:
            return gather_kernel.apply(g0, f), gather_kernel.apply(g1, f)
        return _take(f, idx0), _take(f, idx1)
    t1 = _struct(mesh, name1, idx1, dst, src)
    return _apply(mesh, t0, f), _apply(mesh, t1, f)


def cell_pair_on_edge(mesh: HorzMesh, f):
    """(f[cellsOnEdge[:,0]], f[cellsOnEdge[:,1]]) for a cell field."""
    return _pair(mesh, f, "c0", "c1", mesh.cells_on_edge[:, 0],
                 mesh.cells_on_edge[:, 1], "edge", "cell")


def vertex_pair_on_edge(mesh: HorzMesh, f):
    """(f[verticesOnEdge[:,0]], f[verticesOnEdge[:,1]]) for a vertex field."""
    return _pair(mesh, f, "v0", "v1", mesh.vertices_on_edge[:, 0],
                 mesh.vertices_on_edge[:, 1], "edge", "vertex")


def _two_slot(mesh, f, name, idx2, w01, combine, dst, src):
    """Fused 2-slot stencil w0*f[idx2[:,0]] + w1*f[idx2[:,1]] in ONE
    pass — the separate pair gathers cost a full sweep each, and most
    consumers only need the difference or mean."""
    w_np = None
    if isinstance(idx2, np.ndarray):
        w_np = np.tile(np.asarray(w01, np.float64), (idx2.shape[0], 1))
    t = _struct(mesh, name, idx2, dst, src, w_np)
    if t is not None:
        return _apply(mesh, t, f)
    g = _gtab(mesh, name)
    if g is not None:
        return gather_kernel.apply(g, f)
    return combine(_take(f, idx2[:, 0]), _take(f, idx2[:, 1]))


def cell_diff_on_edge(mesh: HorzMesh, f):
    """f[coe1] - f[coe0] (the gradient numerator) in one pass."""
    return _two_slot(mesh, f, "cdiff", mesh.cells_on_edge, (-1.0, 1.0),
                     lambda a, b: b - a, "edge", "cell")


def cell_mean_on_edge(mesh: HorzMesh, f):
    """0.5*(f[coe0] + f[coe1]) in one pass."""
    return _two_slot(mesh, f, "cmean", mesh.cells_on_edge, (0.5, 0.5),
                     lambda a, b: 0.5 * (a + b), "edge", "cell")


def vertex_diff_on_edge(mesh: HorzMesh, f):
    """f[voe1] - f[voe0] in one pass."""
    return _two_slot(mesh, f, "vdiff", mesh.vertices_on_edge, (-1.0, 1.0),
                     lambda a, b: b - a, "edge", "vertex")


def vertex_mean_on_edge(mesh: HorzMesh, f):
    """0.5*(f[voe0] + f[voe1]) in one pass."""
    return _two_slot(mesh, f, "vmean", mesh.vertices_on_edge, (0.5, 0.5),
                     lambda a, b: 0.5 * (a + b), "edge", "vertex")


def cell_to_vertex_kite(mesh: HorzMesh, f):
    """Kite-area-fraction interpolation of a cell field to vertices
    (h_vertex of VorticityAuxVars.h:36-48)."""
    t = _struct(mesh, "kite", mesh.cells_on_vertex, "vertex", "cell",
                mesh.w_kite_frac)
    if t is not None:
        return _apply(mesh, t, f)
    gt = _gtab(mesh, "kite")
    if gt is not None:
        return gather_kernel.apply(gt, f)
    return _gather_sum(mesh.w_kite_frac, mesh.cells_on_vertex, f)


def edge_to_cell_signed(mesh: HorzMesh, g):
    """sum_e -sign(c,e)/A_c * g[e]: the shared edge->cell accumulation of
    the tracer laplacian/diffusion terms (TracerAuxVars.h:70-105)."""
    w_np = None
    if isinstance(mesh.edge_sign_on_cell, np.ndarray):
        w_np = -np.asarray(mesh.edge_sign_on_cell) / np.asarray(
            mesh.area_cell)[:, None]
    t = _struct(mesh, "signed_div", mesh.edges_on_cell, "cell", "edge",
                w_np)
    if t is not None:
        return _apply(mesh, t, g)
    gt = _gtab(mesh, "signed_div")
    if gt is not None:
        return gather_kernel.apply(gt, g)
    w = -mesh.edge_sign_on_cell / mesh.area_cell[:, None]
    return _gather_sum(w, mesh.edges_on_cell, g)


def ke_cell(mesh: HorzMesh, u):
    """Kinetic energy at cells: sum_e w_ke * u_e^2 (KineticAuxVars.h:12-60)."""
    u2 = torch.square(u)
    t = _struct(mesh, "ke", mesh.edges_on_cell, "cell", "edge",
                mesh.w_ke_cell)
    if t is not None:
        return _apply(mesh, t, u2)
    gt = _gtab(mesh, "ke")
    if gt is not None:
        return gather_kernel.apply(gt, u2)
    return _gather_sum(mesh.w_ke_cell, mesh.edges_on_cell, u2)


def _signed_div_part(mesh: HorzMesh, g, positive: bool):
    name = "div_pos" if positive else "div_neg"
    w_np = None
    if isinstance(mesh.w_div_cell, np.ndarray):
        w_np = np.maximum(np.asarray(mesh.w_div_cell)
                          * (1.0 if positive else -1.0), 0.0)
    t = _struct(mesh, name, mesh.edges_on_cell, "cell", "edge", w_np)
    if t is not None:
        return _apply(mesh, t, g)
    gt = _gtab(mesh, name)
    if gt is not None:
        return gather_kernel.apply(gt, g)
    w = torch.clamp(mesh.w_div_cell * (1.0 if positive else -1.0),
                    min=0.0)
    return _gather_sum(w, mesh.edges_on_cell, g)


def div_cell_pos(mesh: HorzMesh, g):
    """sum_j max(w_div, 0) * g[eoc] — the outgoing-flux part of the
    divergence, used by the FCT limiter budgets."""
    return _signed_div_part(mesh, g, True)


def div_cell_neg(mesh: HorzMesh, g):
    """sum_j max(-w_div, 0) * g[eoc] — the incoming-flux part."""
    return _signed_div_part(mesh, g, False)


def cell_neighbor_extrema(mesh: HorzMesh, f):
    """(max, min) of a cell field over each cell and its edge neighbors —
    the local bounds used by the Zalesak FCT limiter."""
    if structured.enabled(mesh):
        coc = mesh.cells_on_cell
        tabs = [structured.stencil_table(
            mesh, f"coc{j}",
            coc[:, j] if isinstance(coc, np.ndarray) else coc,
            "cell", "cell", None) for j in range(coc.shape[1])]
        if all(t[0] is not None for t in tabs):
            fmax = fmin = f
            for t in tabs:
                g = structured.apply_stencil(mesh, t, f)
                fmax = torch.maximum(fmax, g)
                fmin = torch.minimum(fmin, g)
            return fmax, fmin
    coc = mesh.cells_on_cell
    nbr = _take(f, coc)                              # (..., C, M, K)
    valid = (torch.arange(coc.shape[1], device=f.device)[None, :]
             < mesh.n_edges_on_cell[:, None])[..., None]
    big = torch.finfo(f.dtype).max
    fmax = torch.maximum(
        f, torch.amax(torch.where(valid, nbr, -big), dim=-2))
    fmin = torch.minimum(
        f, torch.amin(torch.where(valid, nbr, big), dim=-2))
    return fmax, fmin


# ----------------------------------------------------------------------
# classic TRiSK operators

def div_cell(mesh: HorzMesh, vec_edge):
    """Divergence of an edge-normal vector field at cell centers.

    div(c) = -(1/A_c) sum_e sign(c,e) dv_e u_e   (HorzOperators.h:9-42)
    """
    t = _struct(mesh, "div", mesh.edges_on_cell, "cell", "edge",
                mesh.w_div_cell)
    if t is not None:
        return _apply(mesh, t, vec_edge)
    gt = _gtab(mesh, "div")
    if gt is not None:
        return gather_kernel.apply(gt, vec_edge)
    return _gather_sum(mesh.w_div_cell, mesh.edges_on_cell, vec_edge)


def grad_edge(mesh: HorzMesh, scalar_cell):
    """Normal gradient of a cell scalar on edges (HorzOperators.h:44-66)."""
    return cell_diff_on_edge(mesh, scalar_cell) / col(mesh, "dc_edge")


def curl_vertex(mesh: HorzMesh, vec_edge):
    """Relative vorticity (curl) of an edge-normal field at vertices.

    curl(v) = (1/A_v) sum_e sign(v,e) dc_e u_e   (HorzOperators.h:68-102)
    """
    t = _struct(mesh, "curl", mesh.edges_on_vertex, "vertex", "edge",
                mesh.w_curl_vertex)
    if t is not None:
        return _apply(mesh, t, vec_edge)
    gt = _gtab(mesh, "curl")
    if gt is not None:
        return gather_kernel.apply(gt, vec_edge)
    return _gather_sum(mesh.w_curl_vertex, mesh.edges_on_vertex, vec_edge)


def tangential_edge(mesh: HorzMesh, vec_edge):
    """Tangential velocity reconstruction on edges via TRiSK weights.

    t(e) = sum_{e'} w(e,e') u(e')   (HorzOperators.h:104-133)
    """
    t = _struct(mesh, "tang", mesh.edges_on_edge, "edge", "edge",
                mesh.weights_on_edge)
    if t is not None:
        return _apply(mesh, t, vec_edge)
    gt = _gtab(mesh, "tang")
    if gt is not None:
        return gather_kernel.apply(gt, vec_edge)
    return _gather_sum(mesh.weights_on_edge, mesh.edges_on_edge, vec_edge)


def interp_cell_to_edge_aniso(mesh: HorzMesh, scalar_cell):
    """Two-cell average onto edges (HorzOperators.h:158-164)."""
    was_1d = scalar_cell.ndim == 1
    f = scalar_cell[:, None] if was_1d else scalar_cell
    out = cell_mean_on_edge(mesh, f)
    return out[:, 0] if was_1d else out


def interp_cell_to_edge_iso(mesh: HorzMesh, scalar_cell):
    """Kite-area-weighted interpolation onto edges (HorzOperators.h:166-183).

    Averages over the cells of both end vertices with kite-area weights.
    """
    was_1d = scalar_cell.ndim == 1
    f = scalar_cell[:, None] if was_1d else scalar_cell
    # per-vertex kite-weighted numerator: w_kite_frac = kites/areaTri, so
    # num_v = interp_v * areaTri; denominator is the vertex kite sum
    # (== areaTri on interior vertices)
    ksum = torch.sum(mesh.kite_areas_on_vertex, dim=1, keepdim=True)  # (V,1)
    num_v = cell_to_vertex_kite(mesh, f) * mesh.area_triangle[:, None]
    num0, num1 = vertex_pair_on_edge(mesh, num_v)
    den0, den1 = vertex_pair_on_edge(mesh, ksum)
    out = (num0 + num1) / (den0 + den1)
    return out[:, 0] if was_1d else out
