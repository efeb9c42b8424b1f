"""Patch-structured layout for icosahedral spherical meshes.

The icos-family mesh (mesh/spherical.py) is 10 structured rhombus patches
of n x n cells plus the 2 pole pentagons: subdividing the icosahedron n
times gives 10n^2+2 generator points that tile into 10 parallelograms
(each a pair of icosahedral faces), with every interior point having its
6 neighbors at FIXED lattice displacements {(+-1,0),(0,+-1),(+1,-1),
(-1,+1)}.  On TPU that structure is worth ~10x: row gathers of (N, K)
fields run 10-15x slower than streaming sweeps (CLAUDE.md perf facts),
and the general sphere path is all gathers.

This module renumbers an icos mesh patch-major (cell id = r*n^2 + b*n + a
for rhombus r, row b, column a; the 2 poles appended) with edges and
vertices class-major per owning cell exactly like the planar generator
(mesh/planar.py:133-170), and derives PER-POSITION stencil tables:

    out[t_dst, r, b, a] = sum_entries  w[t_dst,t_src,da,db](r, b, a)
                          * src[t_src, r, b + db, a + da]

Unlike the uniform planar tables (ops/structured.py), weights are
(10, n, n) planes (spherical geometry is non-uniform) and NO lattice
uniformity is assumed: every destination's sources are resolved
individually against the real connectivity at build time.  Destinations
that do not resolve (the 12 pentagons, patch-seam orphans, pole cells)
go on an exact gather FIX-UP list evaluated with the same weighted-gather
formula as the general path and scattered over the patch result —
correctness never depends on the lattice assumption.

Reference: the layout replaces what the reference gets from METIS
locality + Kokkos CPU blocking (base/Decomp.cpp:968); the operators
themselves are unchanged (ocn/HorzOperators.h:9-187).

Host numpy, the counterpart of omega_tpu/mesh/icos_patches.py: the
renumbered arrays, content maps, fills and tables equal the JAX package's.
The layout metadata (PatchInfo) rides on the mesh itself
(`HorzMesh.patch_info`), not in a module registry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from omega_tpu_torch.mesh.horz_mesh import HorzMesh, finalize_mesh, \
    unclamped_connectivity
from omega_tpu_torch.mesh.spherical import _icosahedron, _subdivide

# lattice displacement of the 6 hex neighbors (da, db); the diagonal is
# always (+1,-1)/(-1,+1) in rhombus coords regardless of face orientation
# (the 6 neighbor offsets are the permutations of barycentric (-1,+1,0),
# which project to exactly this set for any vertex-order permutation)
NEIGHBOR_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-1, 1))

# edge ownership: cell (a, b) owns its bonds toward these directions,
# slot t = index in this tuple (class-major edge id = t*NG + cell)
EDGE_DIRS = ((1, 0), (0, 1), (1, -1))

# vertex ownership: cell (a, b) anchors the two lattice triangles
#   t=0 (up):   {(a,b), (a+1,b), (a,b+1)}
#   t=1 (down): {(a,b), (a+1,b-1), (a+1,b)}
VERTEX_TRIS = (((0, 0), (1, 0), (0, 1)), ((0, 0), (1, -1), (1, 0)))

NPER = {"cell": 1, "edge": 3, "vertex": 2}

HALO = 2            # frame padding; covers all stencil offsets (<= 2)


def _rhombi():
    """The 10 rhombi as vertex-id quadruples (P, A, B, C): P a pole,
    A/B adjacent corners, C opposite.  (P, A, B) is CCW from outside so
    every rhombus has consistent chirality."""
    verts, faces = _icosahedron()
    npole, spole = 0, 3         # antipodal vertex pair of _icosahedron()
    out = []
    for pole in (npole, spole):
        pfaces = [tuple(f) for f in faces if pole in f]
        assert len(pfaces) == 5
        for f in pfaces:
            # order (P, A, B) CCW from outside
            i = f.index(pole)
            A, B = f[(i + 1) % 3], f[(i + 2) % 3]
            det = np.linalg.det(np.stack([verts[pole], verts[A], verts[B]]))
            if det < 0:
                A, B = B, A
            # C: the other face sharing edge (A, B)
            other = [tuple(g) for g in faces
                     if A in g and B in g and pole not in g]
            assert len(other) == 1, (pole, f, other)
            C = [v for v in other[0] if v not in (A, B)][0]
            out.append((pole, A, B, C))
    assert len(out) == 10
    return out


def _rhombus_points(n: int):
    """point_of[r][(a, b)] = generator point id for rhombus lattice
    coordinates a, b in [0..n]; corners: P=(0,0), A=(n,0), B=(0,n),
    C=(n,n).  Recovered from the deterministic per-face subdivision
    grids (spherical._subdivide)."""
    verts, faces = _icosahedron()
    _, _, fgrids = _subdivide(n, return_grids=True)
    face_index = {tuple(sorted(f)): k for k, f in enumerate(faces)}

    def face_grid(corner_ids):
        k = face_index[tuple(sorted(corner_ids))]
        return k, tuple(faces[k]), fgrids[k]

    out = []
    for (P, A, B, C) in _rhombi():
        pmap: Dict[Tuple[int, int], int] = {}
        # lower triangle (P, A, B): a + b <= n
        k1, f1, g1 = face_grid((P, A, B))
        # barycentric weight of each f1 vertex for grid point (i, j):
        # (n-i-j, i, j); rhombus coords: a = weight(A), b = weight(B)
        wof = {f1[0]: "w0", f1[1]: "wi", f1[2]: "wj"}
        for (i, j), pid in g1.items():
            w = {"w0": n - i - j, "wi": i, "wj": j}
            a, b = w[wof[A]], w[wof[B]]
            pmap[(a, b)] = pid
        # upper triangle (A, B, C): a + b >= n; barycentric on (A, B, C)
        # is ((n-b), (n-a), (a+b-n)) -> a = n - weight(B), b = n - weight(A)
        k2, f2, g2 = face_grid((A, B, C))
        wof2 = {f2[0]: "w0", f2[1]: "wi", f2[2]: "wj"}
        for (i, j), pid in g2.items():
            w = {"w0": n - i - j, "wi": i, "wj": j}
            a, b = n - w[wof2[B]], n - w[wof2[A]]
            if (a, b) in pmap:
                assert pmap[(a, b)] == pid, ((a, b), pmap[(a, b)], pid)
            pmap[(a, b)] = pid
        out.append(pmap)
    return out


def _cell_ownership(n: int, ncells: int):
    """Assign every non-pole generator point to exactly one rhombus slot.

    Returns (owner (10, n, n) point ids, poles (2,) point ids).  Owned
    slot (r, b, a) <-> rhombus param point (a+1, b) for the 5 northern
    rhombi and (a, b+1) for the 5 southern: the seam structure is
    north a=0 col == next-north b=0 row (and likewise in the south),
    north a=n col == a south a=n col, north b=n row == a south b=n row,
    so the translated windows tile the sphere minus the two poles
    exactly once (verified; duplicates would trip the asserts)."""
    rp = _rhombus_points(n)
    owner = np.full((10, n, n), -1, np.int64)
    seen = np.zeros(ncells, bool)
    for r in range(10):
        for b in range(n):
            for a in range(n):
                pid = rp[r][(a + 1, b) if r < 5 else (a, b + 1)]
                assert not seen[pid], (r, a, b, pid)
                seen[pid] = True
                owner[r, b, a] = pid
    unassigned = np.flatnonzero(~seen)
    assert unassigned.size == 2, unassigned   # exactly the two poles
    poles = np.array([rp[0][(0, 0)], rp[5][(0, 0)]], np.int64)
    assert set(poles) == set(unassigned), (poles, unassigned)
    return owner, poles, rp


def _adjacency_sets(mesh) -> List[set]:
    """cells_on_cell as python sets of valid neighbor ids."""
    coc = np.asarray(mesh.cells_on_cell, np.int64)
    n_eoc = np.asarray(mesh.n_edges_on_cell, np.int64)
    out = []
    for c in range(mesh.ncells):
        out.append(set(int(x) for x in coc[c, :n_eoc[c]]))
    return out


def _cell_frames(mesh, n: int, reach: int):
    """Per-rhombus cell position maps over the padded lattice frame.

    Returns frames (10, n+2*reach, n+2*reach) int64 of OLD cell ids
    (-1 where the lattice has no cell: beyond pentagonal defects).
    Slot [r, b+reach, a+reach] holds the cell at lattice position (a, b)
    (owned region is (a, b) in [0, n)^2).

    Initialization comes from the rhombus parameterization (which covers
    one extra ring on two sides); the remaining ring slots are resolved
    by pure connectivity walking: an unknown slot adjacent to a known
    lattice-adjacent pair (k1, k2) must be one of the two common graph
    neighbors of their cells, and the other one is the known third point
    of the opposite triangle.  No orientation bookkeeping — the walk
    works across any seam and simply stops at the 12 pentagon defects."""
    owner, poles, rp = _cell_ownership(n, mesh.ncells)
    adj = _adjacency_sets(mesh)
    S = n + 2 * reach
    frames = np.full((10, S, S), -1, np.int64)
    for r in range(10):
        fr = frames[r]
        # param coverage: local (a, b) <-> param (a+1, b) north, (a, b+1)
        # south; param range [0..n]^2 covers local [-1..n-1]x[0..n] north
        # and [0..n]x[-1..n-1] south
        for (pa, pb), pid in rp[r].items():
            a, b = (pa - 1, pb) if r < 5 else (pa, pb - 1)
            if -reach <= a < n + reach and -reach <= b < n + reach:
                fr[b + reach, a + reach] = pid
        # connectivity walk for the remaining ring slots
        for _ in range(4 * reach + 4):
            progress = False
            for bi in range(S):
                for ai in range(S):
                    if fr[bi, ai] >= 0:
                        continue
                    placed = _resolve_slot(fr, adj, bi, ai, S)
                    if placed >= 0:
                        fr[bi, ai] = placed
                        progress = True
            if not progress:
                break
    return frames, owner, poles


def _elem_dicts(mesh):
    """Lookup dicts: edge by sorted cell pair, vertex by cell triple."""
    coe = np.asarray(mesh.cells_on_edge, np.int64)
    cov = np.asarray(mesh.cells_on_vertex, np.int64)
    epair = {}
    for e in range(mesh.nedges):
        a, b = int(coe[e, 0]), int(coe[e, 1])
        epair[(a, b) if a < b else (b, a)] = e
    vtri = {}
    for v in range(mesh.nvertices):
        vtri[frozenset(int(x) for x in cov[v])] = v
    return epair, vtri


def _edge_at(epair, c0: int, c1: int) -> int:
    if c0 < 0 or c1 < 0:
        return -1
    return epair.get((c0, c1) if c0 < c1 else (c1, c0), -1)


def _claim_elements(n: int, frames: np.ndarray, epair: dict, vtri: dict,
                    nedges: int, nvertices: int, reach: int):
    """Class-major ownership of edges and vertices by their anchor cell.

    Slot (t, r, b, a) claims: edges — the bond from cell (a, b) toward
    EDGE_DIRS[t]; vertices — the lattice triangle VERTEX_TRIS[t].
    Cross-seam double claims keep the first claimant (the loser slot
    becomes a dead hole id); never-claimed elements (seam orphans, pole
    edges the rim does not reach) are appended after the grid ids.

    Returns (edge_new_of_slot (3,10,n,n), vertex_new_of_slot (2,10,n,n)
    OLD element ids with -1 holes, edge orphans, vertex orphans)."""
    eslot = np.full((3, 10, n, n), -1, np.int64)
    vslot = np.full((2, 10, n, n), -1, np.int64)
    eclaimed = np.zeros(nedges, bool)
    vclaimed = np.zeros(nvertices, bool)
    for r in range(10):
        fr = frames[r]
        for t, (da, db) in enumerate(EDGE_DIRS):
            for b in range(n):
                for a in range(n):
                    c0 = fr[b + reach, a + reach]
                    c1 = fr[b + db + reach, a + da + reach]
                    e = _edge_at(epair, int(c0), int(c1))
                    if e >= 0 and not eclaimed[e]:
                        eclaimed[e] = True
                        eslot[t, r, b, a] = e
        for t, tri in enumerate(VERTEX_TRIS):
            for b in range(n):
                for a in range(n):
                    cs = [int(fr[b + db + reach, a + da + reach])
                          for (da, db) in tri]
                    if min(cs) < 0:
                        continue
                    v = vtri.get(frozenset(cs), -1)
                    if v >= 0 and not vclaimed[v]:
                        vclaimed[v] = True
                        vslot[t, r, b, a] = v
    e_orphans = np.flatnonzero(~eclaimed)
    v_orphans = np.flatnonzero(~vclaimed)
    return eslot, vslot, e_orphans, v_orphans


@dataclasses.dataclass
class PatchTable:
    """One stencil as per-patch slices + per-position weights + fix-up."""
    name: str
    dst_class: str
    src_class: str
    n_dst: int
    # [(t_dst, t_src, da, db, wplane (10, n, n) float64)]
    entries: List[Tuple[int, int, int, int, np.ndarray]]
    fix_ids: np.ndarray      # (F,)   destination ids recomputed by gather
    fix_idx: np.ndarray      # (F, S) source ids (clamped)
    fix_w: np.ndarray        # (F, S) weights


@dataclasses.dataclass
class PatchInfo:
    """Static patch metadata for one renumbered icos mesh (host side)."""
    n: int
    ncells: int
    nedges: int
    nvertices: int
    # per class: (flat positions into the (T, 10, n+2W, n+2W) frame,
    # source element ids) for every slot whose content differs from the
    # natural interior paste — the single gather+scatter that fills
    # halos, seam holes, and cross-seam duplicates
    fills: Dict[str, Tuple[np.ndarray, np.ndarray]]
    # per class: frame content maps (T, 10, n+2W, n+2W) of element ids
    content: Dict[str, np.ndarray]
    tables: Dict[str, PatchTable] = dataclasses.field(default_factory=dict)
    # the renumbered mesh as built (host numpy, float64, without this
    # info): what the mega-step build reads, whatever device and type the
    # mesh was later moved to
    host_mesh: Optional[HorzMesh] = None
    # what is derived from the layout once and reused: the mega-step
    # builds of mesh/icos_mega.py and the per-device tensors of the
    # stencil tables and fills, keyed by a tuple that starts with a tag
    cache: dict = dataclasses.field(default_factory=dict)

    @property
    def ngrid(self) -> int:
        return 10 * self.n * self.n

    def frame_shape(self, cls: str) -> tuple:
        S = self.n + 2 * HALO
        return (NPER[cls], 10, S, S)


def _expand(old_arr, new2old, fill=0.0):
    """new[i] = old[new2old[i]], `fill` on dead ids (new2old == -1)."""
    old_arr = np.asarray(old_arr)
    out = np.full((len(new2old),) + old_arr.shape[1:], fill,
                  old_arr.dtype)
    valid = new2old >= 0
    out[valid] = old_arr[new2old[valid]]
    return out


def patch_icos_mesh(mesh, n: int) -> HorzMesh:
    """Renumber a generated icos mesh into the patch-major layout and
    warm its per-patch stencil tables.

    `mesh` must come from spherical_icos_mesh(n) (the builder recovers
    rhombus coordinates from the deterministic subdivision id order).
    The returned mesh is numerically the same ocean (permuted ids) with
    a handful of DEAD elements interleaved (seam slots whose element is
    owned by the neighboring patch; their connectivity is empty, their
    weights zero, and every stencil output pins them to the exact
    gather-path value), with `patch_info` set for the patch path."""
    reach = HALO + 1
    frames, owner, poles = _cell_frames(mesh, n, reach)
    epair, vtri = _elem_dicts(mesh)
    eslot, vslot, e_orph, v_orph = _claim_elements(
        n, frames, epair, vtri, mesh.nedges, mesh.nvertices, reach)

    # --- new -> old maps (−1 = dead id) ---
    c_n2o = np.concatenate([owner.reshape(-1), poles])
    e_n2o = np.concatenate([eslot.reshape(-1), e_orph])
    v_n2o = np.concatenate([vslot.reshape(-1), v_orph])
    NC, NE, NV = len(c_n2o), len(e_n2o), len(v_n2o)
    assert (c_n2o >= 0).all()

    def old2new(n2o, nold):
        o2n = np.full(nold, -1, np.int64)
        valid = n2o >= 0
        o2n[n2o[valid]] = np.flatnonzero(valid)
        return o2n

    c_o2n = old2new(c_n2o, mesh.ncells)
    e_o2n = old2new(e_n2o, mesh.nedges)
    v_o2n = old2new(v_n2o, mesh.nvertices)
    assert (c_o2n >= 0).all() and (e_o2n >= 0).all() and (v_o2n >= 0).all()

    def remap(idx, o2n):
        idx = np.asarray(idx, np.int64)
        out = o2n[np.maximum(idx, 0)]
        return np.where(idx >= 0, out, -1)

    unc = unclamped_connectivity(mesh)
    a = lambda name: np.asarray(getattr(mesh, name))
    ex = _expand

    raw = dict(
        x_cell=ex(a("x_cell"), c_n2o), y_cell=ex(a("y_cell"), c_n2o),
        lon_cell=ex(a("lon_cell"), c_n2o), lat_cell=ex(a("lat_cell"), c_n2o),
        area_cell=ex(a("area_cell"), c_n2o, 1.0),
        f_cell=ex(a("f_cell"), c_n2o),
        bottom_depth=ex(a("bottom_depth"), c_n2o),
        n_edges_on_cell=ex(a("n_edges_on_cell"), c_n2o),
        edges_on_cell=ex(remap(unc["edges_on_cell"], e_o2n), c_n2o, -1),
        cells_on_cell=ex(remap(unc["cells_on_cell"], c_o2n), c_n2o, -1),
        vertices_on_cell=ex(remap(unc["vertices_on_cell"], v_o2n),
                            c_n2o, -1),
        x_edge=ex(a("x_edge"), e_n2o), y_edge=ex(a("y_edge"), e_n2o),
        lon_edge=ex(a("lon_edge"), e_n2o), lat_edge=ex(a("lat_edge"), e_n2o),
        # dead-row geometry must be benign, not zero: 1/dc and 1/dv
        # columns are formed BEFORE the edge_mask multiply in the
        # tendencies, and 0 * inf would leak NaN into masked terms
        dc_edge=ex(a("dc_edge"), e_n2o, 1.0),
        dv_edge=ex(a("dv_edge"), e_n2o, 1.0),
        angle_edge=ex(a("angle_edge"), e_n2o),
        f_edge=ex(a("f_edge"), e_n2o),
        cells_on_edge=ex(remap(unc["cells_on_edge"], c_o2n), e_n2o, -1),
        vertices_on_edge=ex(remap(unc["vertices_on_edge"], v_o2n),
                            e_n2o, -1),
        n_edges_on_edge=ex(a("n_edges_on_edge"), e_n2o),
        edges_on_edge=ex(remap(unc["edges_on_edge"], e_o2n), e_n2o, -1),
        weights_on_edge=ex(a("weights_on_edge"), e_n2o),
        mesh_scaling_del2=ex(a("mesh_scaling_del2"), e_n2o, 1.0),
        mesh_scaling_del4=ex(a("mesh_scaling_del4"), e_n2o, 1.0),
        x_vertex=ex(a("x_vertex"), v_n2o), y_vertex=ex(a("y_vertex"), v_n2o),
        lon_vertex=ex(a("lon_vertex"), v_n2o),
        lat_vertex=ex(a("lat_vertex"), v_n2o),
        area_triangle=ex(a("area_triangle"), v_n2o, 1.0),
        f_vertex=ex(a("f_vertex"), v_n2o),
        cells_on_vertex=ex(remap(unc["cells_on_vertex"], c_o2n), v_n2o, -1),
        edges_on_vertex=ex(remap(unc["edges_on_vertex"], e_o2n), v_n2o, -1),
        kite_areas_on_vertex=ex(a("kite_areas_on_vertex"), v_n2o),
    )
    new = finalize_mesh(raw, ncells=NC, nedges=NE, nvertices=NV,
                        max_edges=mesh.max_edges,
                        vertex_degree=mesh.vertex_degree,
                        on_sphere=mesh.on_sphere,
                        sphere_radius=mesh.sphere_radius)

    # --- frame content maps in NEW ids ---
    S = n + 2 * HALO
    cont_c = np.full((1, 10, S, S), -1, np.int64)
    cont_e = np.full((3, 10, S, S), -1, np.int64)
    cont_v = np.full((2, 10, S, S), -1, np.int64)
    for r in range(10):
        fr = frames[r]
        for b in range(-HALO, n + HALO):
            for aa in range(-HALO, n + HALO):
                c0 = int(fr[b + reach, aa + reach])
                if c0 >= 0:
                    cont_c[0, r, b + HALO, aa + HALO] = c_o2n[c0]
                for t, (da, db) in enumerate(EDGE_DIRS):
                    c1 = int(fr[b + db + reach, aa + da + reach])
                    e = _edge_at(epair, c0, c1)
                    if e >= 0:
                        cont_e[t, r, b + HALO, aa + HALO] = e_o2n[e]
                for t, tri in enumerate(VERTEX_TRIS):
                    cs = [int(fr[b + db + reach, aa + da + reach])
                          for (da, db) in tri]
                    if min(cs) >= 0:
                        v = vtri.get(frozenset(cs), -1)
                        if v >= 0:
                            cont_v[t, r, b + HALO, aa + HALO] = v_o2n[v]

    info = PatchInfo(
        n=n, ncells=NC, nedges=NE, nvertices=NV,
        fills={cls: _fill_list(cont, n)
               for cls, cont in (("cell", cont_c), ("edge", cont_e),
                                 ("vertex", cont_v))},
        content={"cell": cont_c, "edge": cont_e, "vertex": cont_v},
        host_mesh=new)
    _warm_tables(new, info)
    return dataclasses.replace(new, patch_info=info)


def _fill_list(content: np.ndarray, n: int):
    """Frame slots whose runtime value must be gathered (content differs
    from the natural interior paste of rows [0, T*NG))."""
    T = content.shape[0]
    S = n + 2 * HALO
    NG = 10 * n * n
    natural = np.full((T, 10, S, S), -1, np.int64)
    grid_ids = np.arange(T * NG, dtype=np.int64).reshape(T, 10, n, n)
    natural[:, :, HALO:HALO + n, HALO:HALO + n] = grid_ids
    need = (content >= 0) & (content != natural)
    pos = np.flatnonzero(need)
    src = content.reshape(-1)[pos]
    return pos.astype(np.int32), src.astype(np.int32)


def _reverse_maps(info: PatchInfo):
    """Per class, per patch: element id -> list of frame slots (t, b, a)
    (frame coords including halo, origin at the owned corner)."""
    out = {}
    S = info.n + 2 * HALO
    for cls, cont in info.content.items():
        T = cont.shape[0]
        per_r: List[Dict[int, list]] = [dict() for _ in range(10)]
        for t in range(T):
            for r in range(10):
                sl = cont[t, r]
                ids = sl.reshape(-1)
                for flat in np.flatnonzero(ids >= 0):
                    b, a2 = divmod(int(flat), S)
                    per_r[r].setdefault(int(ids[flat]), []).append(
                        (t, b - HALO, a2 - HALO))
        out[cls] = per_r
    return out


def _build_table(info: PatchInfo, rev, name: str, idx: np.ndarray,
                 weights: Optional[np.ndarray], dst_class: str,
                 src_class: str) -> PatchTable:
    """Factor one stencil into per-position patch entries + fix-up.

    For every live destination (one with an owned frame slot), each
    nonzero-weight source is located in the destination patch's frame
    via the content reverse map; its weight accumulates into the
    (t_dst, t_src, da, db) entry plane at the destination's position.
    Destinations that don't fully resolve — the 12 pentagons' own
    stencils, seam orphans, pole cells, dead ids — get the exact
    weighted-gather recipe (their verbatim idx/weights rows), so the
    patch result equals the gather path on EVERY row.  Entries with
    tiny support (pentagon-corner wraps) are pruned back to fix-up so
    the streaming pass never pays a full sweep for a handful of cells."""
    n, NG = info.n, info.ngrid
    idx = np.asarray(idx, np.int64)
    if idx.ndim == 1:
        idx = idx[:, None]
    N_dst, S = idx.shape
    Td = NPER[dst_class]
    w = None if weights is None else np.asarray(weights, np.float64)
    dst_cont = info.content[dst_class]
    rev_src = rev[src_class]

    # pass 1: resolve every destination
    contribs: Dict[int, list] = {}
    fixup: set = set()
    for D in range(N_dst):
        if D >= Td * NG:
            fixup.add(D)            # tail: poles / orphans
            continue
        td, g = divmod(D, NG)
        r, gg = divmod(g, n * n)
        bd, ad = divmod(gg, n)
        if dst_cont[td, r, bd + HALO, ad + HALO] != D:
            fixup.add(D)            # dead hole id
            continue
        terms = []
        ok = True
        for s in range(S):
            ws = 1.0 if w is None else float(w[D, s])
            if ws == 0.0:
                continue
            X = int(idx[D, s])
            slot = None
            for (ts, bs, as_) in rev_src[r].get(X, ()):
                da, db = as_ - ad, bs - bd
                if abs(da) <= HALO and abs(db) <= HALO:
                    slot = (td, ts, da, db)
                    break
            if slot is None:
                ok = False
                break
            terms.append((slot, ws))
        if ok:
            contribs[D] = terms
        else:
            fixup.add(D)

    # pass 2: prune tiny-support entries back to fix-up
    thresh = max(16, NG // 256)
    while True:
        support: Dict[tuple, int] = {}
        for terms in contribs.values():
            for (slot, _) in terms:
                support[slot] = support.get(slot, 0) + 1
        small = {slot for slot, cnt in support.items() if cnt < thresh}
        if not small:
            break
        moved = [D for D, terms in contribs.items()
                 if any(slot in small for (slot, _) in terms)]
        for D in moved:
            del contribs[D]
            fixup.add(D)

    # pass 3: accumulate weight planes
    planes: Dict[tuple, np.ndarray] = {}
    for D, terms in contribs.items():
        td, g = divmod(D, NG)
        r, gg = divmod(g, n * n)
        bd, ad = divmod(gg, n)
        for (slot, ws) in terms:
            if slot not in planes:
                planes[slot] = np.zeros((10, n, n), np.float64)
            planes[slot][r, bd, ad] += ws

    entries = [(td, ts, da, db, pl)
               for (td, ts, da, db), pl in sorted(planes.items())]
    fix_ids = np.fromiter(sorted(fixup), np.int32, len(fixup))
    fix_idx = np.maximum(idx[fix_ids], 0).astype(np.int32)
    fix_w = (np.ones((len(fix_ids), S)) if w is None
             else w[fix_ids]).astype(np.float64)
    return PatchTable(name=name, dst_class=dst_class, src_class=src_class,
                      n_dst=N_dst, entries=entries, fix_ids=fix_ids,
                      fix_idx=fix_idx, fix_w=fix_w)


def _warm_tables(mesh: HorzMesh, info: PatchInfo) -> None:
    """Build the full stencil-table set (same list the planar fast path
    warms — trisk.warm_structured) for a patch-renumbered mesh."""
    rev = _reverse_maps(info)
    a = lambda name: np.asarray(getattr(mesh, name))
    w_signed = -a("edge_sign_on_cell") / a("area_cell")[:, None]
    w_div = a("w_div_cell")
    E = mesh.nedges
    coe, voe = a("cells_on_edge"), a("vertices_on_edge")
    specs = [
        ("div", a("edges_on_cell"), "cell", "edge", w_div),
        ("div_pos", a("edges_on_cell"), "cell", "edge",
         np.maximum(w_div, 0.0)),
        ("div_neg", a("edges_on_cell"), "cell", "edge",
         np.maximum(-w_div, 0.0)),
        ("ke", a("edges_on_cell"), "cell", "edge", a("w_ke_cell")),
        ("signed_div", a("edges_on_cell"), "cell", "edge", w_signed),
        ("curl", a("edges_on_vertex"), "vertex", "edge",
         a("w_curl_vertex")),
        ("kite", a("cells_on_vertex"), "vertex", "cell",
         a("w_kite_frac")),
        ("tang", a("edges_on_edge"), "edge", "edge",
         a("weights_on_edge")),
        ("c0", coe[:, 0], "edge", "cell", None),
        ("c1", coe[:, 1], "edge", "cell", None),
        ("v0", voe[:, 0], "edge", "vertex", None),
        ("v1", voe[:, 1], "edge", "vertex", None),
        ("cdiff", coe, "edge", "cell", np.tile([-1.0, 1.0], (E, 1))),
        ("cmean", coe, "edge", "cell", np.full((E, 2), 0.5)),
        ("vdiff", voe, "edge", "vertex", np.tile([-1.0, 1.0], (E, 1))),
        ("vmean", voe, "edge", "vertex", np.full((E, 2), 0.5)),
    ]
    for name, idx, dst, src, wts in specs:
        info.tables[name] = _build_table(info, rev, name, idx, wts,
                                         dst, src)


def _resolve_slot(fr, adj, bi, ai, S) -> int:
    """Resolve one unknown frame slot by the common-neighbor rule, or -1."""
    for k in range(6):
        da1, db1 = NEIGHBOR_DIRS[k]
        for m in range(6):
            if m == k:
                continue
            da2, db2 = NEIGHBOR_DIRS[m]
            # k1, k2 must be lattice-adjacent to each other
            if (da1 - da2, db1 - db2) not in NEIGHBOR_DIRS:
                continue
            b1, a1 = bi + db1, ai + da1
            b2, a2 = bi + db2, ai + da2
            if not (0 <= b1 < S and 0 <= a1 < S
                    and 0 <= b2 < S and 0 <= a2 < S):
                continue
            c1, c2 = fr[b1, a1], fr[b2, a2]
            if c1 < 0 or c2 < 0:
                continue
            cand = adj[c1] & adj[c2]
            # the opposite triangle's third point: the other slot
            # adjacent to both k1 and k2
            b3, a3 = b1 + b2 - bi, a1 + a2 - ai
            if 0 <= b3 < S and 0 <= a3 < S and fr[b3, a3] >= 0:
                cand = cand - {int(fr[b3, a3])}
            if len(cand) == 1:
                return cand.pop()
    return -1


def apply_land_mask(mesh: HorzMesh, land_cells) -> HorzMesh:
    """A land-masked variant of a patch-renumbered icos mesh.

    Land on the patch layout is expressed by MASKING, not by removing
    elements (removal would puncture the 10 n x n lattice the patch
    kernels depend on): the full lattice stays, and

      - `edge_mask` is zeroed on every edge touching a land cell (so all
        masked momentum/tracer-flux terms vanish there, exactly as the
        reference's boundary EdgeMask does, ocn/HorzMesh.cpp:581-604);
      - the kite interpolation weights of land cells are zeroed (what
        carve_mesh gets from finalize zeroing removed-cell kites), so
        vertex thickness h_v never reads land state. A vertex whose every
        cell is land keeps its weights: zeroing them all gives h_v = 0 and
        qv = f/0 = inf, which 0*inf = NaN's through the edge-mask gates;
        its (finite, junk) qv only reaches land edges, where the mask
        zeroes it exactly.

    With zero initial velocity on masked edges, the ocean cells evolve
    identically to the same ocean carved out with mesh/carve.py (land rows
    stay frozen at their initial state). The fused patch kernels
    (ops/patch_megastep.py) carry the mask gates of the composed chain, so
    land meshes stay on the fast path.

    `land_cells`: bool (ncells,) in the PATCH numbering. Returns a new
    HorzMesh, on the device and in the type of `mesh`, with its OWN
    PatchInfo: the masked host mesh, stencil tables rebuilt against the
    masked weights, and an empty cache (the mega builds and preps of
    icos_mega / patch_megastep are made for the land mesh on first use).
    The parent mesh and its PatchInfo are left as they were."""
    info = getattr(mesh, "patch_info", None)
    if info is None:
        raise ValueError("apply_land_mask needs a patch-renumbered mesh "
                         "(mesh.patch_info set by patch_icos_mesh)")
    land = np.asarray(land_cells, bool)
    if land.shape != (mesh.ncells,):
        raise ValueError(f"land_cells must be ({mesh.ncells},), "
                         f"got {land.shape}")
    parent = info.host_mesh

    unc = unclamped_connectivity(parent)
    coe = np.asarray(unc["cells_on_edge"], np.int64)
    touch = np.zeros(parent.nedges, bool)
    for s in range(coe.shape[1]):
        ok = coe[:, s] >= 0
        touch[ok] |= land[coe[ok, s]]
    em = np.array(parent.edge_mask, copy=True)
    em[touch] = 0.0

    cov = np.asarray(unc["cells_on_vertex"], np.int64)
    kite = np.array(parent.w_kite_frac, copy=True)
    valid = cov >= 0
    is_land = valid & land[np.maximum(cov, 0)]
    all_land = valid.any(axis=1) & (is_land == valid).all(axis=1)
    kite[is_land & ~all_land[:, None]] = 0.0

    host = dataclasses.replace(parent, edge_mask=em, w_kite_frac=kite,
                               patch_info=None)
    new_info = PatchInfo(n=info.n, ncells=info.ncells, nedges=info.nedges,
                         nvertices=info.nvertices, fills=info.fills,
                         content=info.content, host_mesh=host)
    _warm_tables(host, new_info)
    if isinstance(mesh.edge_mask, np.ndarray):
        return dataclasses.replace(host, patch_info=new_info)
    dev = mesh.edge_mask.device
    out = dataclasses.replace(
        mesh,
        edge_mask=torch.as_tensor(em).to(device=dev,
                                         dtype=mesh.edge_mask.dtype),
        w_kite_frac=torch.as_tensor(kite).to(device=dev,
                                             dtype=mesh.w_kite_frac.dtype))
    return dataclasses.replace(out, patch_info=new_info)
