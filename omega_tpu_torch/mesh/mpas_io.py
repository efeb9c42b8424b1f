"""MPAS-format mesh file reading and writing.

The reference reads MPAS NetCDF mesh files (QU240 global, Icos sphere,
48x48 periodic planar) through PIO in Decomp::readMesh (base/Decomp.cpp:
108-390) and HorzMesh's constructor (ocn/HorzMesh.cpp:49-148). Here one
host-side reader loads the whole mesh into a HorzMesh pytree (decomposition
comes with the distributed layer), and a writer emits
MPAS-format files so generated meshes interoperate with the reference
tooling (and serve as test fixtures).

MPAS conventions handled: 1-based connectivity with 0 padding (converted to
0-based with -1 padding), per-file `on_a_sphere`/`sphere_radius`/
`x_period`/`y_period` attributes, optional fields defaulted (Coriolis,
bottomDepth) when absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from omega_tpu_torch.io.netcdf import NCFile, read_netcdf, write_netcdf
from omega_tpu_torch.mesh.horz_mesh import (ARRAY_FIELDS, HorzMesh,
                                            finalize_mesh,
                                            unclamped_connectivity)


def _conn(nc: NCFile, name: str) -> np.ndarray:
    """MPAS 1-based connectivity (0 = missing) -> 0-based (-1 = missing)."""
    return np.asarray(nc.get(name), np.int64) - 1


def _yes(attr) -> bool:
    if isinstance(attr, (bytes, str)):
        s = attr.decode() if isinstance(attr, bytes) else attr
        return s.strip().upper() in ("YES", "TRUE", "1")
    return bool(attr)


def read_mpas_mesh(path: str, *,
                   defaults: Optional[Dict[str, float]] = None) -> HorzMesh:
    """Load an MPAS mesh file into a HorzMesh.

    Mirrors the union of Decomp::readMesh (connectivity) and the HorzMesh
    constructor reads (coordinates, areas, dv/dc, angleEdge, weightsOnEdge,
    kiteAreas, Coriolis, bottomDepth); derived quantities (edge signs,
    masks, fused stencil weights) are recomputed by finalize_mesh exactly
    as HorzMesh.cpp:527-604 recomputes them after reading.
    """
    nc = read_netcdf(path)
    defaults = defaults or {}

    C = int(nc.dims["nCells"])
    E = int(nc.dims["nEdges"])
    V = int(nc.dims["nVertices"])
    M = int(nc.dims["maxEdges"])
    D = int(nc.dims["vertexDegree"])

    on_sphere = _yes(nc.attrs.get("on_a_sphere", "NO"))
    sphere_radius = float(nc.attrs.get("sphere_radius", 0.0) or 0.0)
    x_period = float(nc.attrs.get("x_period", 0.0) or 0.0)
    y_period = float(nc.attrs.get("y_period", 0.0) or 0.0)

    def opt(name, shape, default=0.0):
        if nc.has(name):
            return np.asarray(nc.get(name), np.float64)
        return np.full(shape, defaults.get(name, default), np.float64)

    raw = dict(
        x_cell=np.asarray(nc.get("xCell"), np.float64),
        y_cell=np.asarray(nc.get("yCell"), np.float64),
        lon_cell=opt("lonCell", C),
        lat_cell=opt("latCell", C),
        area_cell=np.asarray(nc.get("areaCell"), np.float64),
        f_cell=opt("fCell", C),
        bottom_depth=opt("bottomDepth", C, 1000.0),
        n_edges_on_cell=np.asarray(nc.get("nEdgesOnCell"), np.int64),
        edges_on_cell=_conn(nc, "edgesOnCell"),
        cells_on_cell=_conn(nc, "cellsOnCell"),
        vertices_on_cell=_conn(nc, "verticesOnCell"),
        x_edge=np.asarray(nc.get("xEdge"), np.float64),
        y_edge=np.asarray(nc.get("yEdge"), np.float64),
        lon_edge=opt("lonEdge", E),
        lat_edge=opt("latEdge", E),
        dc_edge=np.asarray(nc.get("dcEdge"), np.float64),
        dv_edge=np.asarray(nc.get("dvEdge"), np.float64),
        angle_edge=opt("angleEdge", E),
        f_edge=opt("fEdge", E),
        cells_on_edge=_conn(nc, "cellsOnEdge"),
        vertices_on_edge=_conn(nc, "verticesOnEdge"),
        n_edges_on_edge=np.asarray(nc.get("nEdgesOnEdge"), np.int64),
        edges_on_edge=_conn(nc, "edgesOnEdge"),
        weights_on_edge=np.asarray(nc.get("weightsOnEdge"), np.float64),
        x_vertex=np.asarray(nc.get("xVertex"), np.float64),
        y_vertex=np.asarray(nc.get("yVertex"), np.float64),
        lon_vertex=opt("lonVertex", V),
        lat_vertex=opt("latVertex", V),
        area_triangle=np.asarray(nc.get("areaTriangle"), np.float64),
        f_vertex=opt("fVertex", V),
        cells_on_vertex=_conn(nc, "cellsOnVertex"),
        edges_on_vertex=_conn(nc, "edgesOnVertex"),
        kite_areas_on_vertex=np.asarray(nc.get("kiteAreasOnVertex"),
                                        np.float64),
    )
    if nc.has("meshScalingDel2"):
        raw["mesh_scaling_del2"] = np.asarray(nc.get("meshScalingDel2"),
                                              np.float64)
    if nc.has("meshScalingDel4"):
        raw["mesh_scaling_del4"] = np.asarray(nc.get("meshScalingDel4"),
                                              np.float64)

    return finalize_mesh(raw, ncells=C, nedges=E, nvertices=V, max_edges=M,
                         vertex_degree=D, on_sphere=on_sphere,
                         sphere_radius=sphere_radius,
                         x_period=x_period, y_period=y_period)


def write_mpas_mesh(mesh: HorzMesh, path: str, fmt: str = "netcdf3") -> None:
    """Write a HorzMesh as an MPAS-format mesh file (1-based connectivity).
    A mesh on a device is copied to the host first."""
    mesh = dataclasses.replace(mesh, **{
        n: getattr(mesh, n).detach().cpu().numpy() for n in ARRAY_FIELDS
        if isinstance(getattr(mesh, n), torch.Tensor)})
    C, E, V = mesh.ncells, mesh.nedges, mesh.nvertices

    def conn1(raw):
        """-1-padded 0-based connectivity -> MPAS 1-based, 0 padding."""
        raw = np.asarray(raw, np.int64)
        return np.where(raw >= 0, raw + 1, 0)

    a = lambda name: np.asarray(getattr(mesh, name))
    n_eoc = a("n_edges_on_cell").astype(np.int64)
    M = mesh.max_edges
    pad_c = np.arange(M)[None, :] >= n_eoc[:, None]

    # true -1 padding recovered from the derived sign/weight arrays
    # (periodic/sphere meshes have none and this is the stored data)
    unc = unclamped_connectivity(mesh)

    n_eoe = a("n_edges_on_edge").astype(np.int64)
    pad_e = np.arange(mesh.max_edges * 2)[None, :] >= n_eoe[:, None]

    dims = dict(nCells=C, nEdges=E, nVertices=V, maxEdges=M,
                maxEdges2=2 * M, vertexDegree=mesh.vertex_degree, TWO=2)
    variables = {
        "xCell": a("x_cell"), "yCell": a("y_cell"),
        "zCell": np.zeros(C), "lonCell": a("lon_cell"),
        "latCell": a("lat_cell"), "areaCell": a("area_cell"),
        "fCell": a("f_cell"), "bottomDepth": a("bottom_depth"),
        "nEdgesOnCell": n_eoc.astype(np.int32),
        "edgesOnCell": conn1(unc["edges_on_cell"]),
        "cellsOnCell": conn1(unc["cells_on_cell"]),
        "verticesOnCell": conn1(unc["vertices_on_cell"]),
        "xEdge": a("x_edge"), "yEdge": a("y_edge"), "zEdge": np.zeros(E),
        "lonEdge": a("lon_edge"), "latEdge": a("lat_edge"),
        "dcEdge": a("dc_edge"), "dvEdge": a("dv_edge"),
        "angleEdge": a("angle_edge"), "fEdge": a("f_edge"),
        "cellsOnEdge": conn1(unc["cells_on_edge"]),
        "verticesOnEdge": conn1(unc["vertices_on_edge"]),
        "nEdgesOnEdge": n_eoe.astype(np.int32),
        # keep legitimately-zero-weight targets (MPAS convention), zero
        # only the beyond-nEdgesOnEdge padding
        "edgesOnEdge": np.where(pad_e, 0,
                                np.asarray(a("edges_on_edge"),
                                           np.int64) + 1),
        "weightsOnEdge": np.where(pad_e, 0.0, a("weights_on_edge")),
        "meshScalingDel2": a("mesh_scaling_del2"),
        "meshScalingDel4": a("mesh_scaling_del4"),
        "xVertex": a("x_vertex"), "yVertex": a("y_vertex"),
        "zVertex": np.zeros(V), "lonVertex": a("lon_vertex"),
        "latVertex": a("lat_vertex"), "areaTriangle": a("area_triangle"),
        "fVertex": a("f_vertex"),
        "cellsOnVertex": conn1(unc["cells_on_vertex"]),
        "edgesOnVertex": conn1(unc["edges_on_vertex"]),
        "kiteAreasOnVertex": a("kite_areas_on_vertex"),
    }
    var_dims = {
        "xCell": ("nCells",), "yCell": ("nCells",), "zCell": ("nCells",),
        "lonCell": ("nCells",), "latCell": ("nCells",),
        "areaCell": ("nCells",), "fCell": ("nCells",),
        "bottomDepth": ("nCells",), "nEdgesOnCell": ("nCells",),
        "edgesOnCell": ("nCells", "maxEdges"),
        "cellsOnCell": ("nCells", "maxEdges"),
        "verticesOnCell": ("nCells", "maxEdges"),
        "xEdge": ("nEdges",), "yEdge": ("nEdges",), "zEdge": ("nEdges",),
        "lonEdge": ("nEdges",), "latEdge": ("nEdges",),
        "dcEdge": ("nEdges",), "dvEdge": ("nEdges",),
        "angleEdge": ("nEdges",), "fEdge": ("nEdges",),
        "cellsOnEdge": ("nEdges", "TWO"),
        "verticesOnEdge": ("nEdges", "TWO"),
        "nEdgesOnEdge": ("nEdges",),
        "edgesOnEdge": ("nEdges", "maxEdges2"),
        "weightsOnEdge": ("nEdges", "maxEdges2"),
        "meshScalingDel2": ("nEdges",), "meshScalingDel4": ("nEdges",),
        "xVertex": ("nVertices",), "yVertex": ("nVertices",),
        "zVertex": ("nVertices",), "lonVertex": ("nVertices",),
        "latVertex": ("nVertices",), "areaTriangle": ("nVertices",),
        "fVertex": ("nVertices",),
        "cellsOnVertex": ("nVertices", "vertexDegree"),
        "edgesOnVertex": ("nVertices", "vertexDegree"),
        "kiteAreasOnVertex": ("nVertices", "vertexDegree"),
    }
    attrs = {
        "on_a_sphere": "YES" if mesh.on_sphere else "NO",
        "sphere_radius": float(mesh.sphere_radius),
        "x_period": float(mesh.x_period),
        "y_period": float(mesh.y_period),
        "mesh_spec": "1.0",
        "source": "omega_tpu_torch mesh generator",
    }
    write_netcdf(path, dims=dims, variables=variables, var_dims=var_dims,
                 attrs=attrs, fmt=fmt)
