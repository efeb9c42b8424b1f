"""Domain decomposition — the analogue of base/Decomp + base/Halo.

The reference partitions the cell graph with METIS (base/Decomp.cpp:968),
derives edge/vertex ownership from the first adjacent cell
(base/Decomp.h:108-130), grows HaloWidth=3 layers of ghost elements, and
builds per-neighbor send/recv index lists for MPI halo exchange
(base/Halo.cpp:455-600).

Here the same construction happens once on the host (numpy): cells are
partitioned (a Hilbert curve refined by boundary swaps by default), each
shard gets an owned+halo local mesh with locally renumbered connectivity
padded to a common size, and the exchange lists are baked into index
arrays. At run time one controller holds the shards as a list, each local
mesh on its shard's device (`ShardedMesh.to`), and the halo exchange is a
pack, a copy and an unpack per shard pair (parallel/halo.py) instead of
MPI_Irecv/Isend polling (base/Halo.h:769-915).

Every local mesh gets one trailing dummy row per element class; padded
exchange-list slots target the dummy row so scatters stay in bounds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from omega_tpu_torch.mesh.horz_mesh import (ARRAY_FIELDS, HorzMesh,
                                            finalize_mesh,
                                            unclamped_connectivity)

HALO_WIDTH = 3   # configs/Default.yml Decomp.HaloWidth


def host(x) -> np.ndarray:
    """A mesh or state array as host numpy (a tensor is copied off its
    device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_mesh(mesh: HorzMesh) -> HorzMesh:
    """`mesh` with every array leaf as host numpy (patch and gather layout
    metadata kept)."""
    return dataclasses.replace(mesh, **{
        n: (None if getattr(mesh, n) is None else host(getattr(mesh, n)))
        for n in ARRAY_FIELDS})


def _morton_key(x, y, bits=16):
    """Interleave normalized coordinates into a Morton (Z-order) key."""
    xi = np.clip((x * (1 << bits)).astype(np.uint64), 0, (1 << bits) - 1)
    yi = np.clip((y * (1 << bits)).astype(np.uint64), 0, (1 << bits) - 1)
    key = np.zeros_like(xi)
    for b in range(bits):
        key |= ((xi >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        key |= ((yi >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
    return key


def _norm_coords(mesh: HorzMesh):
    """Cell coordinates normalized to [0, 1)^2 (cylindrical on the sphere)."""
    if mesh.on_sphere:
        x = (host(mesh.lon_cell) % (2 * np.pi)) / (2 * np.pi)
        y = (host(mesh.lat_cell) + np.pi / 2) / np.pi
    else:
        x = host(mesh.x_cell) / max(mesh.x_period, 1e-30)
        y = host(mesh.y_cell) / max(mesh.y_period, 1e-30)
    return x % 1.0, np.clip(y, 0.0, 1.0 - 1e-12)


def partition_cells(mesh: HorzMesh, nshards: int,
                    method: str = "hilbert") -> np.ndarray:
    """Assign an owning shard to every cell.

    "hilbert": Hilbert space-filling-curve chunking by the native C++
    partitioner (parallel/native.py; numpy twin built in), refined by
    greedy boundary swaps where the library is present — the METIS-free
    stand-in for base/Decomp.cpp:968 with good locality.
    "sfc": Morton (Z-order) curve, pure numpy.
    "stripe": contiguous global-id ranges (useful for tests)."""
    mesh = host_mesh(mesh)
    C = mesh.ncells
    if method == "hilbert":
        from omega_tpu_torch.parallel import native
        x, y = _norm_coords(mesh)
        owner = native.partition_geom(x, y, nshards)
        if nshards > 1:
            # graph-aware KL boundary refinement of the geometric seed
            # (the METIS-gap closer for base/Decomp.cpp:968): lowers the
            # edge cut, especially on variable-resolution meshes
            coc = unclamped_connectivity(mesh)["cells_on_cell"]
            owner, _ = native.refine_partition(
                coc, host(mesh.n_edges_on_cell), owner, nshards)
        return owner
    if method == "stripe":
        order = np.arange(C)
    elif method == "sfc":
        x, y = _norm_coords(mesh)
        order = np.argsort(_morton_key(x, y), kind="stable")
    else:
        raise ValueError(f"unknown partition method {method!r}")
    owner = np.empty(C, np.int64)
    bounds = np.linspace(0, C, nshards + 1).astype(np.int64)
    for s in range(nshards):
        owner[order[bounds[s]:bounds[s + 1]]] = s
    return owner


_LISTS = ("send_idx", "recv_src_shard", "recv_src_slot", "recv_dst")


@dataclasses.dataclass(frozen=True)
class ShardedMesh:
    """Per-shard local meshes + halo exchange index lists.

    `meshes` holds one local HorzMesh per shard (host numpy as built; on
    the shards' devices after `to`). The index lists are host (S, N) int32
    arrays padded with entries that target each shard's dummy row; the
    masks and local-to-global maps are host (S, N_local) arrays."""
    nshards: int
    halo_width: int
    meshes: List[HorzMesh]
    owned_cell_mask: np.ndarray          # (S, Cl) 1.0 where this shard owns
    owned_edge_mask: np.ndarray          # (S, El)
    owned_vertex_mask: np.ndarray        # (S, Vl)
    cell_send_idx: np.ndarray            # (S, NSc)
    cell_recv_src_shard: np.ndarray      # (S, NHc)
    cell_recv_src_slot: np.ndarray       # (S, NHc)
    cell_recv_dst: np.ndarray            # (S, NHc)
    edge_send_idx: np.ndarray            # (S, NSe)
    edge_recv_src_shard: np.ndarray      # (S, NHe)
    edge_recv_src_slot: np.ndarray       # (S, NHe)
    edge_recv_dst: np.ndarray            # (S, NHe)
    # vertex-space exchange (the reference's Halo exchanges any array on
    # any of the three index spaces, base/Halo.h:45; diagnostics like
    # vorticity snapshots need it even though the step loop does not)
    vertex_send_idx: np.ndarray          # (S, NSv)
    vertex_recv_src_shard: np.ndarray    # (S, NHv)
    vertex_recv_src_slot: np.ndarray     # (S, NHv)
    vertex_recv_dst: np.ndarray          # (S, NHv)
    cell_local_to_global: np.ndarray     # (S, Cl), -1 on padding
    edge_local_to_global: np.ndarray     # (S, El)
    vertex_local_to_global: np.ndarray   # (S, Vl)
    devices: Optional[tuple] = None      # each shard's device after `to`

    def to(self, devices, dtype=None) -> "ShardedMesh":
        """The local meshes on `devices` (one per shard), floats in
        `dtype`; the index lists stay on the host (parallel/sharded.py
        puts them on the devices it runs on)."""
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != self.nshards:
            raise ValueError(f"{len(devices)} devices for {self.nshards} "
                             "shards")
        return dataclasses.replace(
            self, meshes=[m.to(d, dtype) for m, d in zip(self.meshes,
                                                        devices)],
            devices=devices)

    def lists(self, space: str):
        """The four exchange lists of `space` ('cell' | 'edge' |
        'vertex') as host arrays."""
        if space not in ("cell", "edge", "vertex"):
            raise ValueError(f"unknown index space {space!r}")
        return tuple(getattr(self, f"{space}_{n}") for n in _LISTS)


def _halo_layers(owned, cells_on_cell, n_edges_on_cell, width):
    """BFS halo rings over the cell graph (base/Decomp.cpp halo growth)."""
    seen = set(owned.tolist())
    layers = []
    frontier = owned
    for _ in range(width):
        nbrs = cells_on_cell[frontier]
        valid = (np.arange(cells_on_cell.shape[1])[None, :]
                 < n_edges_on_cell[frontier][:, None]) & (nbrs >= 0)
        cand = np.unique(nbrs[valid])
        new = np.array(sorted(c for c in cand.tolist() if c not in seen),
                       np.int64)
        seen.update(new.tolist())
        layers.append(new)
        frontier = new
    return layers


_GLOBAL = (
    "x_cell", "y_cell", "lon_cell", "lat_cell", "area_cell", "f_cell",
    "bottom_depth", "n_edges_on_cell", "edges_on_cell", "cells_on_cell",
    "vertices_on_cell",
    "x_edge", "y_edge", "lon_edge", "lat_edge", "dc_edge", "dv_edge",
    "angle_edge", "f_edge", "cells_on_edge", "vertices_on_edge",
    "n_edges_on_edge", "edges_on_edge", "weights_on_edge", "edge_mask",
    "mesh_scaling_del2", "mesh_scaling_del4",
    "x_vertex", "y_vertex", "lon_vertex", "lat_vertex", "area_triangle",
    "f_vertex", "cells_on_vertex", "edges_on_vertex",
    "kite_areas_on_vertex", "edge_sign_on_vertex",
)


def decompose(mesh: HorzMesh, nshards: int, *, halo_width: int = HALO_WIDTH,
              method: str = "hilbert") -> ShardedMesh:
    """Build the full sharded mesh from a global HorzMesh (host side; the
    local meshes in float64 numpy)."""
    mesh = host_mesh(mesh)
    C, E, V, M, D = (mesh.ncells, mesh.nedges, mesh.nvertices,
                     mesh.max_edges, mesh.vertex_degree)
    g = {name: np.asarray(getattr(mesh, name)) for name in _GLOBAL}
    # the stored connectivity clamps padding to element 0, which collides
    # with the REAL element 0 on boundary (carved/coastal) meshes — remap
    # from the -1-padded form so local finalize sees true padding
    g.update(unclamped_connectivity(mesh))

    owner_cell = partition_cells(mesh, nshards, method)
    # edge/vertex ownership = first VALID adjacent cell (boundary slots
    # are -1 on carved meshes; base/Decomp.h:108-130)
    coe_g = g["cells_on_edge"]
    owner_edge = owner_cell[np.where(coe_g[:, 0] >= 0, coe_g[:, 0],
                                     coe_g[:, 1])]
    cov_g = g["cells_on_vertex"]
    first_v = cov_g[np.arange(V), np.argmax(cov_g >= 0, axis=1)]
    owner_vertex = owner_cell[np.maximum(first_v, 0)]

    from omega_tpu_torch.parallel import native
    all_halos = native.halo_layers(g["cells_on_cell"],
                                   g["n_edges_on_cell"].astype(np.int32),
                                   owner_cell, nshards, halo_width)

    shards = []
    for s in range(nshards):
        owned_cells, halo = all_halos[s]
        local_cells = np.concatenate([owned_cells] + list(halo))

        # edges/vertices incident to any local cell (skip -1 padding)
        valid = (np.arange(M)[None, :] <
                 g["n_edges_on_cell"][local_cells][:, None])
        eoc_l = g["edges_on_cell"][local_cells]
        voc_l = g["vertices_on_cell"][local_cells]
        loc_e = np.unique(eoc_l[valid & (eoc_l >= 0)])
        loc_v = np.unique(voc_l[valid & (voc_l >= 0)])
        # owned first (sorted by global id), then halo
        loc_e = np.concatenate([loc_e[owner_edge[loc_e] == s],
                                loc_e[owner_edge[loc_e] != s]])
        loc_v = np.concatenate([loc_v[owner_vertex[loc_v] == s],
                                loc_v[owner_vertex[loc_v] != s]])
        shards.append(dict(cells=local_cells, edges=loc_e, verts=loc_v,
                           n_owned_c=len(owned_cells),
                           n_owned_e=int((owner_edge[loc_e] == s).sum()),
                           n_owned_v=int((owner_vertex[loc_v] == s).sum())))

    # common padded sizes (+1 dummy row)
    Cl = max(len(sh["cells"]) for sh in shards) + 1
    El = max(len(sh["edges"]) for sh in shards) + 1
    Vl = max(len(sh["verts"]) for sh in shards) + 1

    # ---- send lists: owned elements needed by any other shard ----
    needed = {k: [set() for _ in range(nshards)]
              for k in ("cells", "edges", "verts")}
    owners = {"cells": owner_cell, "edges": owner_edge,
              "verts": owner_vertex}
    n_owned = {"cells": "n_owned_c", "edges": "n_owned_e",
               "verts": "n_owned_v"}
    for sh in shards:
        for k in needed:
            for gid in sh[k][sh[n_owned[k]]:].tolist():
                needed[k][owners[k][gid]].add(gid)
    send_global = {k: [np.array(sorted(x), np.int64) for x in v]
                   for k, v in needed.items()}
    NS = {k: max(1, max(len(a) for a in v)) for k, v in send_global.items()}
    NH = {k: max(1, max(len(sh[k]) - sh[n_owned[k]] for sh in shards))
          for k in needed}

    # global slot lookup: for each global element, its slot in the owner's
    # buffer
    slot = {}
    for k, n in (("cells", C), ("edges", E), ("verts", V)):
        slot[k] = np.full(n, -1, np.int64)
        for arr in send_global[k]:
            slot[k][arr] = np.arange(len(arr))

    def new(shape, fill, dtype=np.int64):
        return np.full((nshards,) + shape, fill, dtype)

    nloc = {"cells": Cl, "edges": El, "verts": Vl}
    meshes = []
    owned = {k: np.zeros((nshards, nloc[k])) for k in needed}
    l2g = {k: new((nloc[k],), -1) for k in needed}
    send = {k: new((NS[k],), nloc[k] - 1) for k in needed}
    rsrc = {k: new((NH[k],), 0) for k in needed}
    rslot = {k: new((NH[k],), 0) for k in needed}
    rdst = {k: new((NH[k],), nloc[k] - 1) for k in needed}

    for s, sh in enumerate(shards):
        lc, le, lv = sh["cells"], sh["edges"], sh["verts"]
        nc, ne, nv = len(lc), len(le), len(lv)
        for k in needed:
            l2g[k][s, :len(sh[k])] = sh[k]
            owned[k][s, :sh[n_owned[k]]] = 1.0

        # global -> local lookup (absent -> -1)
        cmap = np.full(C, -1, np.int64)
        cmap[lc] = np.arange(nc)
        emap = np.full(E, -1, np.int64)
        emap[le] = np.arange(ne)
        vmap = np.full(V, -1, np.int64)
        vmap[lv] = np.arange(nv)

        def map_idx(global_rows, lookup):
            out = lookup[np.maximum(global_rows, 0)]
            return np.where(global_rows >= 0, out, -1)

        raw = dict(
            x_cell=_pad(g["x_cell"][lc], Cl),
            y_cell=_pad(g["y_cell"][lc], Cl),
            lon_cell=_pad(g["lon_cell"][lc], Cl),
            lat_cell=_pad(g["lat_cell"][lc], Cl),
            area_cell=_pad(g["area_cell"][lc], Cl, 1.0),
            f_cell=_pad(g["f_cell"][lc], Cl),
            bottom_depth=_pad(g["bottom_depth"][lc], Cl, 1.0),
            n_edges_on_cell=_pad(g["n_edges_on_cell"][lc], Cl).astype(np.int64),
            edges_on_cell=_pad2(map_idx(g["edges_on_cell"][lc], emap), Cl),
            cells_on_cell=_pad2(map_idx(g["cells_on_cell"][lc], cmap), Cl),
            vertices_on_cell=_pad2(map_idx(g["vertices_on_cell"][lc], vmap),
                                   Cl),
            x_edge=_pad(g["x_edge"][le], El),
            y_edge=_pad(g["y_edge"][le], El),
            lon_edge=_pad(g["lon_edge"][le], El),
            lat_edge=_pad(g["lat_edge"][le], El),
            dc_edge=_pad(g["dc_edge"][le], El, 1.0),
            dv_edge=_pad(g["dv_edge"][le], El, 1.0),
            angle_edge=_pad(g["angle_edge"][le], El),
            f_edge=_pad(g["f_edge"][le], El),
            cells_on_edge=_pad2(map_idx(g["cells_on_edge"][le], cmap), El),
            vertices_on_edge=_pad2(map_idx(g["vertices_on_edge"][le], vmap),
                                   El),
            n_edges_on_edge=_pad(g["n_edges_on_edge"][le], El).astype(np.int64),
            edges_on_edge=_pad2(map_idx(g["edges_on_edge"][le], emap), El),
            weights_on_edge=_pad2(g["weights_on_edge"][le], El),
            mesh_scaling_del2=_pad(g["mesh_scaling_del2"][le], El, 1.0),
            mesh_scaling_del4=_pad(g["mesh_scaling_del4"][le], El, 1.0),
            x_vertex=_pad(g["x_vertex"][lv], Vl),
            y_vertex=_pad(g["y_vertex"][lv], Vl),
            lon_vertex=_pad(g["lon_vertex"][lv], Vl),
            lat_vertex=_pad(g["lat_vertex"][lv], Vl),
            area_triangle=_pad(g["area_triangle"][lv], Vl, 1.0),
            f_vertex=_pad(g["f_vertex"][lv], Vl),
            cells_on_vertex=_pad2(map_idx(g["cells_on_vertex"][lv], cmap), Vl),
            edges_on_vertex=_pad2(map_idx(g["edges_on_vertex"][lv], emap), Vl),
            kite_areas_on_vertex=_pad2(g["kite_areas_on_vertex"][lv], Vl),
        )
        lmesh = finalize_mesh(raw, ncells=Cl, nedges=El, nvertices=Vl,
                              max_edges=M, vertex_degree=D,
                              on_sphere=mesh.on_sphere,
                              sphere_radius=mesh.sphere_radius,
                              x_period=mesh.x_period, y_period=mesh.y_period)
        # boundary-edge mask must reflect the *global* mesh, not local
        # truncation: take the owner's global mask rows
        lmesh = dataclasses.replace(lmesh,
                                    edge_mask=_pad(g["edge_mask"][le], El))
        # keep 1/h_vertex finite on fringe/dummy vertices with no local cells
        wk = np.asarray(lmesh.w_kite_frac)
        dead = wk.sum(axis=1) <= 0.0
        wk = np.where(dead[:, None],
                      np.concatenate([np.ones((Vl, 1)),
                                      np.zeros((Vl, D - 1))], 1), wk)
        lmesh = dataclasses.replace(lmesh, w_kite_frac=wk)
        meshes.append(lmesh)

        # halo recv lists; send lists in *local* indices
        for k, lookup in (("cells", cmap), ("edges", emap), ("verts", vmap)):
            loc = sh[k]
            halo_k = loc[sh[n_owned[k]]:]
            rsrc[k][s, :len(halo_k)] = owners[k][halo_k]
            rslot[k][s, :len(halo_k)] = slot[k][halo_k]
            rdst[k][s, :len(halo_k)] = np.arange(sh[n_owned[k]], len(loc))
            sg = send_global[k][s]
            send[k][s, :len(sg)] = lookup[sg]

    i32 = lambda a: a.astype(np.int32)
    kw = {}
    for space, k in (("cell", "cells"), ("edge", "edges"),
                     ("vertex", "verts")):
        kw[f"owned_{space}_mask"] = owned[k]
        kw[f"{space}_send_idx"] = i32(send[k])
        kw[f"{space}_recv_src_shard"] = i32(rsrc[k])
        kw[f"{space}_recv_src_slot"] = i32(rslot[k])
        kw[f"{space}_recv_dst"] = i32(rdst[k])
        kw[f"{space}_local_to_global"] = i32(l2g[k])
    return ShardedMesh(nshards=nshards, halo_width=halo_width,
                       meshes=meshes, **kw)


def _pad(arr, n, fill=0.0):
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def _pad2(arr, n):
    out = np.full((n,) + arr.shape[1:], -1, arr.dtype)
    out[:len(arr)] = arr
    return out
