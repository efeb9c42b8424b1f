"""Bandwidth-bounding renumbering of unstructured meshes.

The counterpart of the JAX package's `omega_tpu/mesh/reorder.py`: permute
the cells, edges and vertices of a HorzMesh so that the rows every gather
touches lie close together. Cells follow reverse Cuthill-McKee (method
"rcm", the default: bounded bandwidth) or a space-filling curve (method
"sfc": a 2-D Hilbert curve on planar meshes, 3-D Morton keys of the
unit-sphere positions on spheres); edges and vertices follow the new rank
of their first adjacent cell. `reorder_mesh(..., "rcm")` also builds the
gather tables of ops/trisk.py (`warm_gather`), so the TRiSK operators of
the result run through the gather kernel (csrc/gather.cu) on the card.

The result keeps all operator results identical up to the permutation,
also on meshes with land: the connectivity is read through
`unclamped_connectivity`, so a missing neighbour stays -1 through
`finalize_mesh` (the coast keeps its edge mask). On boundary-free meshes,
where every slot is valid, the permutations and every array equal the
reference's bit for bit; on carved meshes the reference's version remaps the
clamped arrays, links every coast edge to the new index of old cell 0 and
loses the coast's edge mask, which this version does not.

Host numpy in, host numpy out (run it before `.to()`).
"""

from __future__ import annotations

import numpy as np

from omega_tpu_torch.mesh.horz_mesh import (HorzMesh, finalize_mesh,
                                            unclamped_connectivity)


def _morton3(x, y, z, bits: int = 20) -> np.ndarray:
    """3-D Morton keys of coordinates normalized to [0, 1)."""
    def q(v):
        return np.minimum((v * (1 << bits)).astype(np.uint64),
                          np.uint64((1 << bits) - 1))
    xi, yi, zi = q(x), q(y), q(z)
    key = np.zeros_like(xi)
    for b in range(bits):
        bb = np.uint64(b)
        key |= ((xi >> bb) & np.uint64(1)) << np.uint64(3 * b)
        key |= ((yi >> bb) & np.uint64(1)) << np.uint64(3 * b + 1)
        key |= ((zi >> bb) & np.uint64(1)) << np.uint64(3 * b + 2)
    return key


def _norm_coords(mesh: HorzMesh):
    """Cell coordinates normalized to [0, 1)^2 (cylindrical on the sphere);
    a copy of the JAX package's `parallel/decomp._norm_coords`."""
    if mesh.on_sphere:
        x = (np.asarray(mesh.lon_cell) % (2 * np.pi)) / (2 * np.pi)
        y = (np.asarray(mesh.lat_cell) + np.pi / 2) / np.pi
    else:
        x = np.asarray(mesh.x_cell) / max(mesh.x_period, 1e-30)
        y = np.asarray(mesh.y_cell) / max(mesh.y_period, 1e-30)
    return x % 1.0, np.clip(y, 0.0, 1.0 - 1e-12)


def _hilbert_keys(x, y, bits: int = 16) -> np.ndarray:
    """Hilbert-curve keys of points normalized to [0, 1); a copy of the JAX
    package's `parallel/native._hilbert_py` (its C++ twin gives the same
    keys)."""
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n = len(x)
    scale = float(1 << bits)
    xq = np.minimum((np.mod(x, 1.0) * scale), scale - 1).astype(np.uint64)
    yq = np.minimum((np.mod(y, 1.0) * scale), scale - 1).astype(np.uint64)
    d = np.zeros(n, np.uint64)
    x_, y_ = xq.copy(), yq.copy()
    s = np.uint64(1 << (bits - 1))
    while s > 0:
        rx = ((x_ & s) > 0).astype(np.uint64)
        ry = ((y_ & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - np.uint64(1) - x_, x_)
        y_f = np.where(flip, s - np.uint64(1) - y_, y_)
        x_, y_ = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= np.uint64(1)
    return d


def _rcm_cell_perm(mesh: HorzMesh, unc: dict) -> np.ndarray:
    """Reverse Cuthill-McKee order of the cell graph (valid neighbours only):
    bounded bandwidth, where Morton / Hilbert curves on a sphere have seam
    blocks whose index window spans the whole mesh."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    coc = np.asarray(unc["cells_on_cell"], np.int64)
    n_eoc = np.asarray(mesh.n_edges_on_cell, np.int64)
    C = mesh.ncells
    slot = np.arange(coc.shape[1])[None, :] < n_eoc[:, None]
    slot &= coc >= 0
    rows = np.broadcast_to(np.arange(C)[:, None], coc.shape)[slot]
    cols = coc[slot]
    A = csr_matrix((np.ones_like(cols), (rows, cols)), shape=(C, C))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      np.int64)


def _first_valid(idx: np.ndarray) -> np.ndarray:
    """Each row's first non-negative entry (rows of -1-padded connectivity
    that hold at least one)."""
    j = np.argmax(idx >= 0, axis=1)
    return idx[np.arange(idx.shape[0]), j]


def _permutations(mesh: HorzMesh, method: str, unc: dict):
    if method == "rcm":
        cell_perm = _rcm_cell_perm(mesh, unc)
    elif method != "sfc":
        raise ValueError(f"unknown method {method!r} (rcm or sfc)")
    elif mesh.on_sphere:
        lat = np.asarray(mesh.lat_cell)
        lon = np.asarray(mesh.lon_cell)
        px = 0.5 * (np.cos(lat) * np.cos(lon) + 1.0)
        py = 0.5 * (np.cos(lat) * np.sin(lon) + 1.0)
        pz = 0.5 * (np.sin(lat) + 1.0)
        cell_perm = np.argsort(_morton3(px, py, pz), kind="stable")
    else:
        x, y = _norm_coords(mesh)
        cell_perm = np.argsort(_hilbert_keys(x, y), kind="stable")
    cell_rank = np.empty_like(cell_perm)
    cell_rank[cell_perm] = np.arange(mesh.ncells)

    # edges / vertices ordered by (rank of first adjacent cell, old id)
    coe = _first_valid(unc["cells_on_edge"])
    cov = _first_valid(unc["cells_on_vertex"])
    edge_perm = np.lexsort((np.arange(mesh.nedges), cell_rank[coe]))
    vertex_perm = np.lexsort((np.arange(mesh.nvertices), cell_rank[cov]))
    return cell_perm, edge_perm, vertex_perm


def sfc_permutations(mesh: HorzMesh, method: str = "rcm"):
    """(cell_perm, edge_perm, vertex_perm): new order -> old index.

    method 'rcm' (default): reverse Cuthill-McKee, bounded index bandwidth.
    method 'sfc': planar meshes a 2-D Hilbert curve, spherical meshes 3-D
    Morton keys of the unit-sphere positions."""
    return _permutations(mesh, method, unclamped_connectivity(mesh))


def reorder_mesh(mesh: HorzMesh, method: str = "rcm") -> HorzMesh:
    """An equivalent HorzMesh with locality-local element numbering ('rcm'
    default: bounded bandwidth, and the gather tables built; 'sfc':
    space-filling curve). Padding and missing neighbours stay -1 through
    `finalize_mesh`, so a coast keeps its masks."""
    unc = unclamped_connectivity(mesh)
    cp, ep, vp = _permutations(mesh, method, unc)
    C, E, V = mesh.ncells, mesh.nedges, mesh.nvertices
    cr = np.empty(C, np.int64)
    cr[cp] = np.arange(C)
    er = np.empty(E, np.int64)
    er[ep] = np.arange(E)
    vr = np.empty(V, np.int64)
    vr[vp] = np.arange(V)

    def remap(idx, rank):
        idx = np.asarray(idx, np.int64)
        out = rank[np.maximum(idx, 0)]
        return np.where(idx >= 0, out, -1)

    a = lambda n: np.asarray(getattr(mesh, n))
    n_eoc = a("n_edges_on_cell")[cp]
    M = mesh.max_edges
    pad_c = np.arange(M)[None, :] >= n_eoc[:, None]

    raw = dict(
        x_cell=a("x_cell")[cp], y_cell=a("y_cell")[cp],
        lon_cell=a("lon_cell")[cp], lat_cell=a("lat_cell")[cp],
        area_cell=a("area_cell")[cp], f_cell=a("f_cell")[cp],
        bottom_depth=a("bottom_depth")[cp],
        n_edges_on_cell=n_eoc,
        edges_on_cell=np.where(pad_c, -1,
                               remap(unc["edges_on_cell"][cp], er)),
        cells_on_cell=np.where(pad_c, -1,
                               remap(unc["cells_on_cell"][cp], cr)),
        vertices_on_cell=np.where(pad_c, -1,
                                  remap(unc["vertices_on_cell"][cp], vr)),
        x_edge=a("x_edge")[ep], y_edge=a("y_edge")[ep],
        lon_edge=a("lon_edge")[ep], lat_edge=a("lat_edge")[ep],
        dc_edge=a("dc_edge")[ep], dv_edge=a("dv_edge")[ep],
        angle_edge=a("angle_edge")[ep], f_edge=a("f_edge")[ep],
        cells_on_edge=remap(unc["cells_on_edge"][ep], cr),
        vertices_on_edge=remap(unc["vertices_on_edge"][ep], vr),
        n_edges_on_edge=a("n_edges_on_edge")[ep],
        # every slot remapped as stored: its weight says whether it counts
        # (a regular hexagon's opposite edge has a Thuburn weight of 0 and
        # is still a neighbour), as in the reference
        edges_on_edge=remap(a("edges_on_edge")[ep], er),
        weights_on_edge=a("weights_on_edge")[ep],
        mesh_scaling_del2=a("mesh_scaling_del2")[ep],
        mesh_scaling_del4=a("mesh_scaling_del4")[ep],
        x_vertex=a("x_vertex")[vp], y_vertex=a("y_vertex")[vp],
        lon_vertex=a("lon_vertex")[vp], lat_vertex=a("lat_vertex")[vp],
        area_triangle=a("area_triangle")[vp], f_vertex=a("f_vertex")[vp],
        cells_on_vertex=remap(unc["cells_on_vertex"][vp], cr),
        edges_on_vertex=remap(unc["edges_on_vertex"][vp], er),
        kite_areas_on_vertex=a("kite_areas_on_vertex")[vp],
    )
    out = finalize_mesh(raw, ncells=C, nedges=E, nvertices=V,
                        max_edges=M, vertex_degree=mesh.vertex_degree,
                        on_sphere=mesh.on_sphere,
                        sphere_radius=mesh.sphere_radius,
                        x_period=mesh.x_period, y_period=mesh.y_period)
    if method == "rcm":
        from omega_tpu_torch.ops import trisk
        out = trisk.warm_gather(out)
    return out


def gather_window_stats(mesh: HorzMesh, block: int = 256,
                        reduce: str = "max") -> dict:
    """Index window each `block` of consecutive destinations touches, per
    connectivity array: 'max' (worst block) or 'median' (typical block, the
    cache-locality indicator)."""
    out = {}
    for name in ("edges_on_cell", "cells_on_edge", "edges_on_vertex",
                 "cells_on_vertex", "edges_on_edge"):
        idx = np.asarray(getattr(mesh, name))
        N = idx.shape[0]
        nb = (N + block - 1) // block
        ws = []
        for b in range(nb):
            sl = idx[b * block:(b + 1) * block]
            valid = sl[sl >= 0]
            if valid.size:
                ws.append(int(valid.max() - valid.min() + 1))
        out[name] = int(np.max(ws) if reduce == "max" else np.median(ws))
    return out
