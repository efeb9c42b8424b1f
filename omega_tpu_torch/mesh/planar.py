"""Doubly periodic uniform hexagonal mesh generator.

Replaces the reference's reliance on externally downloaded MPAS mesh files
(e.g. the 48x48 periodic planar hex mesh of test/ocn/HorzOperatorsTest.cpp)
with an exact in-repo generator. The generated mesh is a perfect centroidal
Voronoi tessellation (pointy-top hexagons), so primal/dual geometry (areas,
kites, TRiSK weights) is computed exactly.

Layout: cell (i, j) at x = (i + 0.5*(j%2)) dc, y = j * dc*sqrt(3)/2.
`ny` must be even for periodicity. Each cell owns 3 edges (E, NE, NW) and
2 vertices (the circumcenters of triangles (c,E,NE) and (c,NE,NW)).

The TRiSK tangential-reconstruction weights (weightsOnEdge) follow
Thuburn et al. 2009 / Ringler et al. 2010 eq. (33): for each cell i adjacent
to edge e, walking the edges of i CCW from e, the weight of the edge reached
after passing vertices with accumulated kite-area fraction R is
    w(e,e') = s * (0.5 - R) * dv(e')/dc(e)
with s = +-1 fixed by the edge-normal orientations (validated in
tests/test_operators.py: uniform-flow reconstruction is exact to roundoff).
"""

from __future__ import annotations

import numpy as np

from omega_tpu_torch.mesh.horz_mesh import HorzMesh, finalize_mesh

SQRT3 = np.sqrt(3.0)


def _build_edges_on_edge(n_eoc, eoc, voc, coe, cov, kites, area_cell, dv, dc,
                         max_edges):
    """Generic Thuburn/Ringler weightsOnEdge construction.

    Works for any CCW-ordered mesh where verticesOnCell[c, j] is the vertex
    between edgesOnCell[c, j] and edgesOnCell[c, j+1].
    Returns (edges_on_edge, weights_on_edge, n_edges_on_edge), padded with -1.
    """
    nedges = coe.shape[0]
    M2 = 2 * max_edges
    eoe = np.full((nedges, M2), -1, np.int64)
    woe = np.zeros((nedges, M2), np.float64)
    n_eoe = np.zeros(nedges, np.int64)

    edge_ids = np.arange(nedges)

    slot = np.zeros(nedges, np.int64)
    for side in range(2):
        cell = coe[:, side]                      # (E,)
        ne = n_eoc[cell]                         # edges per that cell
        eoc_c = eoc[cell]                        # (E, M)
        voc_c = voc[cell]                        # (E, M)
        # position of e within its cell's CCW edge list
        pos = np.argmax(eoc_c == edge_ids[:, None], axis=1)

        # orientation: does the tangent of e point CCW around this cell?
        # With normal pointing c0 -> c1 and tangent = z x normal, the tangent
        # runs CCW around c1 and CW around c0. The Thuburn sum sign flips
        # accordingly; the net per-side sign is resolved below.
        side_sign = 1.0 if side == 0 else -1.0

        maxm = eoc.shape[1]
        steps = np.arange(1, maxm)               # up to M-1 other edges
        idx = (pos[:, None] + steps[None, :]) % ne[:, None]
        eprime = np.take_along_axis(eoc_c, idx, axis=1)          # (E, M-1)
        # vertex passed when stepping from slot (pos+s-1) to (pos+s):
        vidx = (pos[:, None] + steps[None, :] - 1) % ne[:, None]
        vpass = np.take_along_axis(voc_c, vidx, axis=1)          # (E, M-1)

        # kite fraction of (vpass, cell)
        ki = np.argmax(cov[vpass] == cell[:, None, None], axis=2)
        kfrac = np.take_along_axis(kites[vpass], ki[..., None], axis=2)[..., 0]
        kfrac = kfrac / area_cell[cell][:, None]
        R = np.cumsum(kfrac, axis=1)

        # outward-normal indicator of e' w.r.t. this cell
        nsign = np.where(coe[eprime, 0] == cell[:, None], 1.0, -1.0)

        w = side_sign * nsign * (0.5 - R) * dv[eprime] / dc[:, None]

        valid = steps[None, :] < ne[:, None]
        nvalid = (ne - 1).astype(np.int64)
        for e in range(nedges):
            nv = nvalid[e]
            s0 = slot[e]
            eoe[e, s0:s0 + nv] = eprime[e, :nv]
            woe[e, s0:s0 + nv] = w[e, :nv]
        slot += nvalid
    n_eoe = slot
    return eoe, woe, n_eoe


def planar_hex_mesh(nx: int, ny: int, dc: float = 1.0, *,
                    f0: float = 0.0, beta: float = 0.0,
                    bottom_depth: float = 1000.0) -> HorzMesh:
    """Generate a doubly periodic uniform hex mesh with nx*ny cells."""
    if ny % 2 != 0:
        raise ValueError("ny must be even for periodicity")
    if nx < 4 or ny < 4:
        raise ValueError("mesh too small (need nx, ny >= 4)")

    C = nx * ny
    E = 3 * C
    V = 2 * C
    M = 6
    D = 3
    dy = dc * SQRT3 / 2.0
    Lx, Ly = nx * dc, ny * dy

    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    ii = ii.ravel()
    jj = jj.ravel()
    x_cell = (ii + 0.5 * (jj % 2)) * dc
    y_cell = jj * dy

    def cid(i, j):
        return (j % ny) * nx + (i % nx)

    odd = (jj % 2).astype(np.int64)
    # neighbor ids; relative positions are parity-independent:
    # E=(dc,0) NE=(dc/2,dy) NW=(-dc/2,dy) W=(-dc,0) SW=(-dc/2,-dy) SE=(dc/2,-dy)
    nbr_E = cid(ii + 1, jj)
    nbr_W = cid(ii - 1, jj)
    nbr_NE = cid(ii + odd, jj + 1)
    nbr_NW = cid(ii - 1 + odd, jj + 1)
    nbr_SW = cid(ii - 1 + odd, jj - 1)
    nbr_SE = cid(ii + odd, jj - 1)

    cells = np.arange(C)
    # CCW order starting from E: E, NE, NW, W, SW, SE
    cells_on_cell = np.stack([nbr_E, nbr_NE, nbr_NW, nbr_W, nbr_SW, nbr_SE], 1)

    # --- edges: cell c owns E edge (c), NE edge (C+c), NW edge (2C+c).
    # CLASS-MAJOR numbering (type-contiguous blocks): per-type slices of
    # (E, K) fields are then free reshapes to (3, ny, nx, K), the layout
    # the structured shift path works in (ops/structured.py) ---
    e_E = cells
    e_NE = C + cells
    e_NW = 2 * C + cells
    cells_on_edge = np.zeros((E, 2), np.int64)
    cells_on_edge[e_E] = np.stack([cells, nbr_E], 1)
    cells_on_edge[e_NE] = np.stack([cells, nbr_NE], 1)
    cells_on_edge[e_NW] = np.stack([cells, nbr_NW], 1)

    x_edge = np.zeros(E)
    y_edge = np.zeros(E)
    ang = np.zeros(E)
    x_edge[e_E] = x_cell + dc / 2
    y_edge[e_E] = y_cell
    ang[e_E] = 0.0
    x_edge[e_NE] = x_cell + dc / 4
    y_edge[e_NE] = y_cell + dy / 2
    ang[e_NE] = np.pi / 3
    x_edge[e_NW] = x_cell - dc / 4
    y_edge[e_NW] = y_cell + dy / 2
    ang[e_NW] = 2 * np.pi / 3
    x_edge %= Lx
    y_edge %= Ly

    # edges of cell, CCW from E edge:
    # [E(c), NE(c), NW(c), E-of-W(c), NE-of-SW(c), NW-of-SE(c)]
    edges_on_cell = np.stack(
        [e_E, e_NE, e_NW, nbr_W, C + nbr_SW, 2 * C + nbr_SE], 1)

    # --- vertices (class-major like edges): cell c owns v0 = c
    # (circumcenter of c,E,NE at c+(dc/2, dc/(2*sqrt3))) and v1 = C+c
    # (of c,NE,NW at c+(0, dc/sqrt3)) ---
    v0 = cells
    v1 = C + cells
    x_vertex = np.zeros(V)
    y_vertex = np.zeros(V)
    x_vertex[v0] = x_cell + dc / 2
    y_vertex[v0] = y_cell + dc / (2 * SQRT3)
    x_vertex[v1] = x_cell
    y_vertex[v1] = y_cell + dc / SQRT3
    x_vertex %= Lx
    y_vertex %= Ly

    cells_on_vertex = np.zeros((V, D), np.int64)
    cells_on_vertex[v0] = np.stack([cells, nbr_E, nbr_NE], 1)   # CCW
    cells_on_vertex[v1] = np.stack([cells, nbr_NE, nbr_NW], 1)  # CCW

    # vertices of cell, CCW; verticesOnCell[c, k] sits between
    # edgesOnCell[c, k] and edgesOnCell[c, k+1]:
    #   [v0(c) 30deg, v1(c) 90deg, v0(W) 150deg, v1(SW) 210deg,
    #    v0(SW) 270deg, v1(SE) 330deg]
    vertices_on_cell = np.stack(
        [v0, v1, nbr_W, C + nbr_SW, nbr_SW, C + nbr_SE], 1)

    # verticesOnEdge (tangent = z x normal points vertex0 -> vertex1):
    #   E edge:  v0 = v1-of-SE(c) (below), v1 = v0-of-c (above)   [tangent +y]
    #   NE edge: v0 = v0-of-c,   v1 = v1-of-c
    #   NW edge: v0 = v1-of-c,   v1 = v0-of-W(c)
    vertices_on_edge = np.zeros((E, 2), np.int64)
    vertices_on_edge[e_E] = np.stack([C + nbr_SE, v0], 1)
    vertices_on_edge[e_NE] = np.stack([v0, v1], 1)
    vertices_on_edge[e_NW] = np.stack([v1, nbr_W], 1)

    # edgesOnVertex:
    #   v0(c): E(c), NE(c), NW-of-E(c)
    #   v1(c): NE(c), NW(c), E-of-NW(c)
    edges_on_vertex = np.zeros((V, D), np.int64)
    edges_on_vertex[v0] = np.stack([e_E, e_NE, 2 * C + nbr_E], 1)
    edges_on_vertex[v1] = np.stack([e_NE, e_NW, nbr_NW], 1)

    # --- exact geometry for the uniform CVT hex mesh ---
    a = dc / SQRT3                    # hexagon side = dv
    area_cell = np.full(C, (SQRT3 / 2.0) * dc * dc)
    area_tri = np.full(V, (SQRT3 / 4.0) * dc * dc)
    kites = np.full((V, D), area_tri[0] / 3.0)
    dv_edge = np.full(E, a)
    dc_edge = np.full(E, dc)

    n_edges_on_cell = np.full(C, M, np.int64)

    eoe, woe, n_eoe = _build_edges_on_edge(
        n_edges_on_cell, edges_on_cell, vertices_on_cell, cells_on_edge,
        cells_on_vertex, kites, area_cell, dv_edge, dc_edge, M)

    f_cell = f0 + beta * y_cell
    f_edge = f0 + beta * ((y_cell[cells_on_edge[:, 0]] +
                           np.where(  # unwrap periodic midpoint
                               np.abs(y_cell[cells_on_edge[:, 1]] -
                                      y_cell[cells_on_edge[:, 0]]) < Ly / 2,
                               y_cell[cells_on_edge[:, 1]],
                               y_cell[cells_on_edge[:, 0]])) / 2.0)
    f_vertex = f0 + beta * y_vertex

    raw = dict(
        x_cell=x_cell, y_cell=y_cell, area_cell=area_cell, f_cell=f_cell,
        bottom_depth=np.full(C, bottom_depth),
        n_edges_on_cell=n_edges_on_cell,
        edges_on_cell=edges_on_cell, cells_on_cell=cells_on_cell,
        vertices_on_cell=vertices_on_cell,
        x_edge=x_edge, y_edge=y_edge, dc_edge=dc_edge, dv_edge=dv_edge,
        angle_edge=ang, f_edge=f_edge,
        cells_on_edge=cells_on_edge, vertices_on_edge=vertices_on_edge,
        n_edges_on_edge=n_eoe, edges_on_edge=eoe, weights_on_edge=woe,
        x_vertex=x_vertex, y_vertex=y_vertex, area_triangle=area_tri,
        f_vertex=f_vertex, cells_on_vertex=cells_on_vertex,
        edges_on_vertex=edges_on_vertex, kite_areas_on_vertex=kites,
    )
    mesh = finalize_mesh(raw, ncells=C, nedges=E, nvertices=V, max_edges=M,
                         vertex_degree=D, x_period=Lx, y_period=Ly)
    # mark the regular (ny, nx) structure so operators can take the
    # gather-free shift path (ops/structured.py), and build the shift
    # tables eagerly while the arrays are still host numpy (once the mesh
    # is moved to a device, tables can only be cache hits)
    import dataclasses as _dc
    from omega_tpu_torch.ops import structured as _st
    from omega_tpu_torch.ops import trisk
    mesh = _dc.replace(mesh, structured_nx=nx, structured_ny=ny,
                       structured_dc=float(dc))
    mesh = _dc.replace(mesh, structured_scalars=_st.uniform_scalar_table(mesh))
    trisk.warm_structured(mesh)
    return mesh
