"""Carve land out of a mesh: remove cells, renumber, rebuild with real
boundaries.

The counterpart of the JAX package's `omega_tpu/mesh/carve.py`. The
reference's operating meshes have land: cells are simply absent and boundary
edges have one missing neighbour, which HorzMesh turns into edge masks and
zero-weighted padded connectivity slots (ocn/HorzMesh.cpp:581-604).
Generated meshes here are boundary-free, so this module produces true
boundary meshes from them: drop a set of cells, keep every edge / vertex
still adjacent to an active cell, remap all connectivity (references to
removed elements become -1 padding) and re-derive signs, masks and weights
through finalize_mesh.

No-flux behaviour then follows from the masks: the velocity tendency is
multiplied by edge_mask, so normal velocity on boundary edges never leaves
zero and no volume or tracer crosses the coast.

Host numpy in, host numpy out (run it before `.to()`).
"""

from __future__ import annotations

import numpy as np

from omega_tpu_torch.mesh.horz_mesh import (HorzMesh, finalize_mesh,
                                            unclamped_connectivity)


def carve_mesh(mesh: HorzMesh, keep_cells) -> HorzMesh:
    """A new HorzMesh containing only `keep_cells` (bool mask over cells),
    with real boundary edges / vertices and -1-padded connectivity."""
    keep_cells = np.asarray(keep_cells, bool)
    C = mesh.ncells
    if keep_cells.shape != (C,):
        raise ValueError(f"keep_cells must be ({C},), got {keep_cells.shape}")

    a = lambda n: np.asarray(getattr(mesh, n))
    coe = a("cells_on_edge").astype(np.int64)
    cov = a("cells_on_vertex").astype(np.int64)

    new_cell = np.full(C, -1, np.int64)
    new_cell[keep_cells] = np.arange(int(keep_cells.sum()))

    # keep an edge when at least one adjacent cell is active; the same for
    # vertices (kite weights of removed cells are zeroed by finalize)
    keep_edge = keep_cells[coe[:, 0]] | keep_cells[coe[:, 1]]
    keep_vertex = keep_cells[cov].any(axis=1)
    new_edge = np.full(mesh.nedges, -1, np.int64)
    new_edge[keep_edge] = np.arange(int(keep_edge.sum()))
    new_vertex = np.full(mesh.nvertices, -1, np.int64)
    new_vertex[keep_vertex] = np.arange(int(keep_vertex.sum()))

    def remap(raw_idx, table):
        """Remap -1-padded connectivity; removed targets become -1."""
        raw_idx = np.asarray(raw_idx, np.int64)
        out = table[np.maximum(raw_idx, 0)]
        return np.where(raw_idx >= 0, out, -1)

    # the source mesh's true -1 padding (its clamp-0 recovered centrally)
    unc = unclamped_connectivity(mesh)
    n_eoc = a("n_edges_on_cell").astype(np.int64)
    n_eoe = a("n_edges_on_edge").astype(np.int64)

    kc, ke, kv = keep_cells, keep_edge, keep_vertex
    raw = dict(
        x_cell=a("x_cell")[kc], y_cell=a("y_cell")[kc],
        lon_cell=a("lon_cell")[kc], lat_cell=a("lat_cell")[kc],
        area_cell=a("area_cell")[kc], f_cell=a("f_cell")[kc],
        bottom_depth=a("bottom_depth")[kc],
        n_edges_on_cell=n_eoc[kc],
        edges_on_cell=remap(unc["edges_on_cell"], new_edge)[kc],
        cells_on_cell=remap(unc["cells_on_cell"], new_cell)[kc],
        vertices_on_cell=remap(unc["vertices_on_cell"], new_vertex)[kc],
        x_edge=a("x_edge")[ke], y_edge=a("y_edge")[ke],
        lon_edge=a("lon_edge")[ke], lat_edge=a("lat_edge")[ke],
        dc_edge=a("dc_edge")[ke], dv_edge=a("dv_edge")[ke],
        angle_edge=a("angle_edge")[ke], f_edge=a("f_edge")[ke],
        cells_on_edge=remap(unc["cells_on_edge"], new_cell)[ke],
        vertices_on_edge=remap(unc["vertices_on_edge"], new_vertex)[ke],
        n_edges_on_edge=n_eoe[ke],
        edges_on_edge=remap(unc["edges_on_edge"], new_edge)[ke],
        weights_on_edge=np.where(unc["edges_on_edge"] >= 0,
                                 a("weights_on_edge"), 0.0)[ke],
        mesh_scaling_del2=a("mesh_scaling_del2")[ke],
        mesh_scaling_del4=a("mesh_scaling_del4")[ke],
        x_vertex=a("x_vertex")[kv], y_vertex=a("y_vertex")[kv],
        lon_vertex=a("lon_vertex")[kv], lat_vertex=a("lat_vertex")[kv],
        area_triangle=a("area_triangle")[kv], f_vertex=a("f_vertex")[kv],
        cells_on_vertex=remap(unc["cells_on_vertex"], new_cell)[kv],
        edges_on_vertex=remap(unc["edges_on_vertex"], new_edge)[kv],
        kite_areas_on_vertex=np.where(unc["cells_on_vertex"] >= 0,
                                      a("kite_areas_on_vertex"), 0.0)[kv],
    )
    return finalize_mesh(
        raw, ncells=int(kc.sum()), nedges=int(ke.sum()),
        nvertices=int(kv.sum()), max_edges=mesh.max_edges,
        vertex_degree=mesh.vertex_degree, on_sphere=mesh.on_sphere,
        sphere_radius=mesh.sphere_radius,
        x_period=mesh.x_period, y_period=mesh.y_period)
