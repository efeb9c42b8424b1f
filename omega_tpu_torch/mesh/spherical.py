"""Spherical icosahedral Voronoi mesh generator.

In-repo replacement for the externally downloaded MPAS spherical meshes the
reference tests against (QU240 quasi-uniform, Icos480 cosine-bell;
doc/devGuide/QuickStart.md:148-166). Subdividing the icosahedron n times
and taking the Voronoi dual of the resulting geodesic Delaunay
triangulation yields exactly the Icos-family mesh: 10n^2+2 Voronoi cells
(12 pentagons, the rest hexagons), 20n^2 triangle vertices, 30n^2 edges.

All geometry is geodesic (areas by spherical excess, distances by arc
length), connectivity follows the MPAS spec (CCW orderings; edge normal
cell0 -> cell1; edge tangent = r_hat x normal pointing vertex0 -> vertex1),
and TRiSK tangential weights come from the same Thuburn/Ringler
construction used for planar meshes (mesh/planar.py:_build_edges_on_edge).

Optional Lloyd (CVT) relaxation iterations pull cell generators toward
Voronoi centroids, matching MPAS's SCVT mesh optimization.

Host numpy only, the counterpart of omega_tpu/mesh/spherical.py: every
array equals the JAX package's bit for bit. `.to(device, dtype)` puts the
mesh on a device.
"""

from __future__ import annotations

import numpy as np

from omega_tpu_torch.mesh.horz_mesh import HorzMesh, finalize_mesh
from omega_tpu_torch.mesh.planar import _build_edges_on_edge

EARTH_RADIUS = 6.371e6          # m, MPAS standard sphere
OMEGA_ROT = 7.29212e-5          # s^-1 Earth rotation rate


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return verts, faces


def _subdivide(n: int, return_grids: bool = False):
    """Subdivide each icosahedral face into n^2 triangles; dedupe shared
    points. Returns (points (N,3) unit vectors, triangles (T,3)); with
    return_grids also the per-face {(i, j): point id} lattice dicts —
    the deterministic id assignment mesh/icos_patches.py relies on to
    recover rhombus coordinates for any subdivision level."""
    verts, faces = _icosahedron()
    pts: list = []
    index: dict = {}

    def key(p):
        return tuple(np.round(p, 9))

    def add(p):
        p = p / np.linalg.norm(p)
        k = key(p)
        if k not in index:
            index[k] = len(pts)
            pts.append(p)
        return index[k]

    tris = []
    fgrids = []
    for (a, b, c) in faces:
        A, B, C = verts[a], verts[b], verts[c]
        # grid[i][j] for i+j <= n
        grid = {}
        for i in range(n + 1):
            for j in range(n + 1 - i):
                p = A + (B - A) * (i / n) + (C - A) * (j / n)
                grid[(i, j)] = add(p)
        fgrids.append(grid)
        for i in range(n):
            for j in range(n - i):
                tris.append([grid[(i, j)], grid[(i + 1, j)], grid[(i, j + 1)]])
                if i + j < n - 1:
                    tris.append([grid[(i + 1, j)], grid[(i + 1, j + 1)],
                                 grid[(i, j + 1)]])
    if return_grids:
        return np.array(pts), np.array(tris, np.int64), fgrids
    return np.array(pts), np.array(tris, np.int64)


def _tri_excess(a, b, c):
    """Spherical triangle area on the unit sphere (Oosterom & Strackee)."""
    num = np.abs(np.einsum("...i,...i->...", a, np.cross(b, c)))
    den = (1.0 + np.einsum("...i,...i->...", a, b)
           + np.einsum("...i,...i->...", b, c)
           + np.einsum("...i,...i->...", c, a))
    return 2.0 * np.arctan2(num, den)


def _arc(a, b):
    """Great-circle distance between unit vectors."""
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                      np.einsum("...i,...i->...", a, b))


def _east_north(p):
    """Local east/north unit vectors at unit point(s) p.

    At the poles (z x p = 0) east is ill-defined; fall back to the x axis
    so azimuthal sorts stay well-defined (any fixed frame works there).
    """
    p = np.atleast_2d(p)
    z = np.array([0.0, 0.0, 1.0])
    east = np.cross(np.broadcast_to(z, p.shape), p)
    nrm = np.linalg.norm(east, axis=-1, keepdims=True)
    polar = nrm[..., 0] < 1e-12
    if np.any(polar):
        x = np.array([1.0, 0.0, 0.0])
        east[polar] = np.cross(np.broadcast_to(x, p[polar].shape), p[polar])
        nrm = np.linalg.norm(east, axis=-1, keepdims=True)
    east = east / nrm
    north = np.cross(p, east)
    if east.shape[0] == 1 and p.shape[0] == 1:
        return east[0], north[0]
    return east, north


def _ccw_sort(center, points_idx, coords):
    """Sort element indices CCW (viewed from outside) around `center`."""
    east, north = _east_north(center)
    d = coords[points_idx] - center
    az = np.arctan2(d @ north, d @ east)
    return points_idx[np.argsort(az)]


def _lloyd_relax(pts, tris, iters: int):
    """Pull generators toward spherical Voronoi-cell centroids (SCVT)."""
    for _ in range(iters):
        circ = np.cross(pts[tris[:, 1]] - pts[tris[:, 0]],
                        pts[tris[:, 2]] - pts[tris[:, 0]])
        circ /= np.linalg.norm(circ, axis=1, keepdims=True)
        flip = np.einsum("ij,ij->i", circ, pts[tris[:, 0]]) < 0
        circ[flip] *= -1
        acc = np.zeros_like(pts)
        wts = np.zeros(len(pts))
        # accumulate triangle-area-weighted circumcenters per generator
        area = _tri_excess(pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]])
        for k in range(3):
            np.add.at(acc, tris[:, k], circ * area[:, None])
            np.add.at(wts, tris[:, k], area)
        newp = acc / wts[:, None]
        newp /= np.linalg.norm(newp, axis=1, keepdims=True)
        pts = newp
    return pts


def _mobius_dilate(pts: np.ndarray, a: float) -> np.ndarray:
    """Conformal dilation of the unit sphere toward the north pole.

    Stereographic projection from the south pole, w -> a*w, and back.
    Mobius maps send circles to circles, so the empty-circumcircle
    (Delaunay) property of a triangulation is PRESERVED — warping the
    generators of a valid icos mesh yields a valid VARIABLE-RESOLUTION
    Voronoi mesh.  The conformal factor is a at the north pole and 1/a
    at the south, so cell spacing varies by a^2 pole to pole (a < 1:
    finer north; the EC30to60-style use case, e3sm mesh family;
    reference partitions such meshes via METIS, base/Decomp.cpp:968 —
    here the SFC+refinement path must handle nonuniform cell sizes)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    d = 1.0 + z
    # exact pole (d == 0) maps to itself (w = infinity fixed point)
    pole = d < 1e-12
    d = np.where(pole, 1.0, d)
    wx, wy = a * x / d, a * y / d
    r2 = wx * wx + wy * wy
    out = np.stack([2 * wx, 2 * wy, 1.0 - r2], axis=-1) / (1.0 + r2)[:, None]
    out[pole] = [0.0, 0.0, -1.0]
    return out


def spherical_icos_mesh(n: int, *, radius: float = EARTH_RADIUS,
                        omega: float = OMEGA_ROT,
                        bottom_depth: float = 4000.0,
                        lloyd_iters: int = 0,
                        refine_factor: float = 1.0) -> HorzMesh:
    """Build the Icos-family spherical Voronoi mesh at subdivision n.

    n=8 -> 642 cells (~1000 km), n=16 -> 2562, n=32 -> 10242 (~QU240 size),
    n=64 -> 40962 cells.

    refine_factor a != 1 applies a conformal dilation (a < 1 pulls
    generators toward the north pole): cell spacing scales by a at the
    north pole and 1/a at the south — max/min dc ratio ~1/a^2.
    """
    if n < 2:
        raise ValueError("need n >= 2")
    pts, tris = _subdivide(n)
    if lloyd_iters:
        pts = _lloyd_relax(pts, tris, lloyd_iters)
    if refine_factor != 1.0:
        pts = _mobius_dilate(pts, float(refine_factor))
    C = len(pts)
    T = len(tris)

    # orient triangles CCW seen from outside: det(p0,p1,p2) > 0
    det = np.einsum("ij,ij->i", pts[tris[:, 0]],
                    np.cross(pts[tris[:, 1]], pts[tris[:, 2]]))
    sw = det < 0
    tris[sw] = tris[sw][:, [0, 2, 1]]

    # triangle circumcenters = Voronoi vertices
    circ = np.cross(pts[tris[:, 1]] - pts[tris[:, 0]],
                    pts[tris[:, 2]] - pts[tris[:, 0]])
    circ /= np.linalg.norm(circ, axis=1, keepdims=True)
    flip = np.einsum("ij,ij->i", circ, pts[tris[:, 0]]) < 0
    circ[flip] *= -1

    # ---- edges: unique generator pairs ----
    pair_raw = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                               tris[:, [2, 0]]])
    pair_sorted = np.sort(pair_raw, axis=1)
    pairs, first_idx, inv = np.unique(pair_sorted, axis=0,
                                      return_index=True, return_inverse=True)
    E = len(pairs)
    # triangles adjacent to each edge (each pair appears in exactly 2 tris)
    tri_of_pair = np.tile(np.arange(T), 3)
    verts_on_edge = np.full((E, 2), -1, np.int64)
    for row, e in enumerate(inv):
        t = tri_of_pair[row]
        if verts_on_edge[e, 0] == -1:
            verts_on_edge[e, 0] = t
        elif verts_on_edge[e, 0] != t:
            verts_on_edge[e, 1] = t
    assert (verts_on_edge >= 0).all(), "non-closed triangulation"

    cells_on_edge = pairs.copy()               # provisional orientation
    # edge midpoint on the sphere
    mid = pts[cells_on_edge[:, 0]] + pts[cells_on_edge[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)

    # normal = unit tangent at midpoint along arc cell0 -> cell1
    c1v = pts[cells_on_edge[:, 1]]
    nrm = c1v - np.einsum("ij,ij->i", c1v, mid)[:, None] * mid
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    # order verticesOnEdge so tangent (= r_hat x normal) points v0 -> v1
    tang = np.cross(mid, nrm)
    d = circ[verts_on_edge[:, 1]] - circ[verts_on_edge[:, 0]]
    swapv = np.einsum("ij,ij->i", d, tang) < 0
    verts_on_edge[swapv] = verts_on_edge[swapv][:, ::-1]

    # ---- per-cell CCW edge/vertex/cell lists ----
    M = 6   # pentagons have 5, padded
    n_eoc = np.zeros(C, np.int64)
    edges_on_cell = np.full((C, M), -1, np.int64)
    cells_on_cell = np.full((C, M), -1, np.int64)
    vertices_on_cell = np.full((C, M), -1, np.int64)

    # adjacency: edges of each cell
    cell_edges = [[] for _ in range(C)]
    for e, (ca, cb) in enumerate(pairs):
        cell_edges[ca].append(e)
        cell_edges[cb].append(e)

    # vertex -> cells map for kites later
    cells_on_vertex = tris.copy()               # CCW (det > 0)
    edges_on_vertex = np.full((T, 3), -1, np.int64)

    # build per-cell CCW orderings: sort edges by azimuth of edge midpoint
    east_c, north_c = _east_north(pts)
    for c in range(C):
        es = np.array(cell_edges[c], np.int64)
        dm = mid[es] - pts[c]
        az = np.arctan2(dm @ north_c[c], dm @ east_c[c])
        es = es[np.argsort(az)]
        k = len(es)
        n_eoc[c] = k
        edges_on_cell[c, :k] = es
        other = np.where(pairs[es, 0] == c, pairs[es, 1], pairs[es, 0])
        cells_on_cell[c, :k] = other
        # verticesOnCell[c, j] sits between edgesOnCell[c, j] and [c, j+1]:
        # it is the shared triangle of the two consecutive edges
        for j in range(k):
            e0, e1 = es[j], es[(j + 1) % k]
            s0 = set(verts_on_edge[e0])
            s1 = set(verts_on_edge[e1])
            shared = s0 & s1
            assert len(shared) == 1, (c, j, s0, s1)
            vertices_on_cell[c, j] = shared.pop()

    # edgesOnVertex: the 3 edges bounding each triangle, CCW
    pair_lookup = {}
    for e, (ca, cb) in enumerate(pairs):
        pair_lookup[(ca, cb)] = e
        pair_lookup[(cb, ca)] = e
    for t in range(T):
        a, b, c = tris[t]
        edges_on_vertex[t] = [pair_lookup[(a, b)], pair_lookup[(b, c)],
                              pair_lookup[(c, a)]]

    # ---- geodesic geometry (scaled by radius at the end) ----
    dc_edge = _arc(pts[cells_on_edge[:, 0]], pts[cells_on_edge[:, 1]])
    dv_edge = _arc(circ[verts_on_edge[:, 0]], circ[verts_on_edge[:, 1]])
    area_tri = _tri_excess(pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]])

    # kites: for vertex t and each of its 3 cells c: (c, m_prev, circ, m_next)
    kites = np.zeros((T, 3), np.float64)
    for k in range(3):
        c_k = tris[:, k]
        c_next = tris[:, (k + 1) % 3]
        c_prev = tris[:, (k + 2) % 3]
        e_next = 0.5 * (pts[c_k] + pts[c_next])
        e_next /= np.linalg.norm(e_next, axis=1, keepdims=True)
        e_prev = 0.5 * (pts[c_k] + pts[c_prev])
        e_prev /= np.linalg.norm(e_prev, axis=1, keepdims=True)
        kites[:, k] = (_tri_excess(pts[c_k], e_next, circ)
                       + _tri_excess(pts[c_k], circ, e_prev))

    area_cell = np.zeros(C)
    np.add.at(area_cell, tris.ravel(), kites.ravel())

    # angleEdge: angle of the edge normal from local east at the midpoint
    east_e, north_e = _east_north(mid)
    angle_edge = np.arctan2(np.einsum("ij,ij->i", nrm, north_e),
                            np.einsum("ij,ij->i", nrm, east_e))

    lat_c = np.arcsin(np.clip(pts[:, 2], -1, 1))
    lon_c = np.arctan2(pts[:, 1], pts[:, 0])
    lat_e = np.arcsin(np.clip(mid[:, 2], -1, 1))
    lon_e = np.arctan2(mid[:, 1], mid[:, 0])
    lat_v = np.arcsin(np.clip(circ[:, 2], -1, 1))
    lon_v = np.arctan2(circ[:, 1], circ[:, 0])

    f_cell = 2 * omega * np.sin(lat_c)
    f_edge = 2 * omega * np.sin(lat_e)
    f_vertex = 2 * omega * np.sin(lat_v)

    R = radius
    eoe, woe, n_eoe = _build_edges_on_edge(
        n_eoc, edges_on_cell, vertices_on_cell, cells_on_edge,
        cells_on_vertex, kites * R * R, area_cell * R * R,
        dv_edge * R, dc_edge * R, M)

    # mesh scaling for resolution-dependent viscosity: (dc/dc_ref)^2, ^3/2
    # per-del2 ~ dx and del4 ~ dx^3 per doc/design MeshScaling convention
    dc_mean = float(np.mean(dc_edge))
    scaling2 = (dc_edge / dc_mean) ** 1
    scaling4 = (dc_edge / dc_mean) ** 3

    raw = dict(
        x_cell=R * pts[:, 0], y_cell=R * pts[:, 1],
        lon_cell=lon_c, lat_cell=lat_c,
        area_cell=area_cell * R * R, f_cell=f_cell,
        bottom_depth=np.full(C, bottom_depth),
        n_edges_on_cell=n_eoc,
        edges_on_cell=edges_on_cell, cells_on_cell=cells_on_cell,
        vertices_on_cell=vertices_on_cell,
        x_edge=R * mid[:, 0], y_edge=R * mid[:, 1],
        lon_edge=lon_e, lat_edge=lat_e,
        dc_edge=R * dc_edge, dv_edge=R * dv_edge,
        angle_edge=angle_edge, f_edge=f_edge,
        cells_on_edge=cells_on_edge, vertices_on_edge=verts_on_edge,
        n_edges_on_edge=n_eoe, edges_on_edge=eoe, weights_on_edge=woe,
        mesh_scaling_del2=scaling2, mesh_scaling_del4=scaling4,
        x_vertex=R * circ[:, 0], y_vertex=R * circ[:, 1],
        lon_vertex=lon_v, lat_vertex=lat_v,
        area_triangle=area_tri * R * R, f_vertex=f_vertex,
        cells_on_vertex=cells_on_vertex, edges_on_vertex=edges_on_vertex,
        kite_areas_on_vertex=kites * R * R,
    )
    # (x, y) keep the projected position; lon / lat carry the full one
    return finalize_mesh(raw, ncells=C, nedges=E, nvertices=T, max_edges=M,
                         vertex_degree=3, on_sphere=True, sphere_radius=R)
