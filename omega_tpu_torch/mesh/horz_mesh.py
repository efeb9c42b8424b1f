"""Horizontal mesh container — the counterpart of ocn/HorzMesh.h:30.

The reference stores the local (owned+halo) MPAS mesh as Kokkos arrays and
derives edge signs / masks / mesh scaling at init (ocn/HorzMesh.cpp:527-640).
Here the mesh is a frozen dataclass of arrays plus static integer
dimensions; every derived quantity (edge signs, masks, fused stencil
weights) is precomputed once on the host so the compute path is pure
gathers (or lattice shifts) and weighted reductions.

After generation every array is host numpy (float64 / int32). `.to(device,
dtype)` turns the arrays into torch tensors on one device, casting the
floating-point leaves only.

Conventions (identical to the reference / MPAS spec):
  * all connectivity is 0-based; padded slots point at element 0 with a zero
    weight so gathers stay in-bounds and contribute nothing
  * edge normal points from cellsOnEdge[e,0] to cellsOnEdge[e,1]
    (edgeSignOnCell = -1 for cell 0, +1 for cell 1; HorzMesh.cpp:539-546)
  * edge tangent points from verticesOnEdge[e,0] to verticesOnEdge[e,1]
    (edgeSignOnVertex = -1 for vertex 0, +1 for vertex 1; HorzMesh.cpp:560-570)
  * angleEdge is the angle between the edge normal and local east
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from omega_tpu_torch import resolve_device

# array leaves, in the JAX package's order
ARRAY_FIELDS = (
    # cell arrays
    "x_cell", "y_cell", "lon_cell", "lat_cell",
    "area_cell", "f_cell", "bottom_depth",
    "n_edges_on_cell", "edges_on_cell", "cells_on_cell",
    "vertices_on_cell", "edge_sign_on_cell", "cell_mask",
    # edge arrays
    "x_edge", "y_edge", "lon_edge", "lat_edge",
    "dc_edge", "dv_edge", "angle_edge", "f_edge",
    "cells_on_edge", "vertices_on_edge",
    "n_edges_on_edge", "edges_on_edge", "weights_on_edge",
    "edge_mask", "mesh_scaling_del2", "mesh_scaling_del4",
    # vertex arrays
    "x_vertex", "y_vertex", "lon_vertex", "lat_vertex",
    "area_triangle", "f_vertex",
    "cells_on_vertex", "edges_on_vertex",
    "kite_areas_on_vertex", "edge_sign_on_vertex", "vertex_mask",
    # fused stencil weights (derived; pure geometry)
    "w_div_cell", "w_ke_cell", "w_curl_vertex", "w_kite_frac",
)

# static metadata
META_FIELDS = ("ncells", "nedges", "nvertices", "max_edges", "vertex_degree",
               "on_sphere", "sphere_radius", "x_period", "y_period",
               "structured_nx", "structured_ny", "structured_dc",
               "structured_scalars")


@dataclasses.dataclass(frozen=True)
class HorzMesh:
    """Immutable horizontal mesh (cells / edges / vertices).

    Shapes: C = ncells, E = nedges, V = nvertices, M = max_edges, D = degree.
    """

    # --- static metadata ---
    ncells: int
    nedges: int
    nvertices: int
    max_edges: int
    vertex_degree: int
    on_sphere: bool = False
    sphere_radius: float = 0.0
    x_period: float = 0.0
    y_period: float = 0.0
    # non-zero when the mesh is the uniform doubly periodic hex grid of
    # planar_hex_mesh: enables the gather-free shift-based operator path
    # (ops/structured.py); 0 for unstructured meshes
    structured_nx: int = 0
    structured_ny: int = 0
    structured_dc: float = 0.0
    # static ((attr, value), ...) pairs for per-element arrays that are
    # spatially uniform on this mesh — trisk.col() returns these python
    # scalars instead of (N, 1) columns. Static metadata (not a global
    # cache) so two same-sized meshes with different f0/depth cannot
    # collide, and a beta-plane mesh simply omits the f entries.
    structured_scalars: tuple = ()

    # --- cell arrays ---
    x_cell: Any = None           # (C,)
    y_cell: Any = None           # (C,)
    lon_cell: Any = None         # (C,)
    lat_cell: Any = None         # (C,)
    area_cell: Any = None        # (C,)
    f_cell: Any = None           # (C,)   Coriolis at cell
    bottom_depth: Any = None     # (C,)
    n_edges_on_cell: Any = None  # (C,)   int32
    edges_on_cell: Any = None    # (C, M) int32, padded -> 0
    cells_on_cell: Any = None    # (C, M) int32, padded -> 0
    vertices_on_cell: Any = None # (C, M) int32, padded -> 0
    edge_sign_on_cell: Any = None  # (C, M) float, 0 on padding
    cell_mask: Any = None        # (C,)   1.0 for active cells

    # --- edge arrays ---
    x_edge: Any = None           # (E,)
    y_edge: Any = None           # (E,)
    lon_edge: Any = None         # (E,)
    lat_edge: Any = None         # (E,)
    dc_edge: Any = None          # (E,)   distance between cell centers
    dv_edge: Any = None          # (E,)   distance between vertices
    angle_edge: Any = None       # (E,)
    f_edge: Any = None           # (E,)
    cells_on_edge: Any = None    # (E, 2) int32
    vertices_on_edge: Any = None # (E, 2) int32
    n_edges_on_edge: Any = None  # (E,)   int32
    edges_on_edge: Any = None    # (E, 2M) int32, padded -> 0
    weights_on_edge: Any = None  # (E, 2M) float, 0 on padding
    edge_mask: Any = None        # (E,)   1.0 interior, 0.0 boundary
    mesh_scaling_del2: Any = None  # (E,)
    mesh_scaling_del4: Any = None  # (E,)

    # --- vertex arrays ---
    x_vertex: Any = None         # (V,)
    y_vertex: Any = None         # (V,)
    lon_vertex: Any = None       # (V,)
    lat_vertex: Any = None       # (V,)
    area_triangle: Any = None    # (V,)
    f_vertex: Any = None         # (V,)
    cells_on_vertex: Any = None  # (V, D) int32
    edges_on_vertex: Any = None  # (V, D) int32
    kite_areas_on_vertex: Any = None  # (V, D)
    edge_sign_on_vertex: Any = None   # (V, D) float
    vertex_mask: Any = None      # (V,)

    # --- fused stencil weights (precomputed so the hot path is gather+FMA) ---
    # divergence:    div(c)  = sum_j w_div_cell[c,j]  * u[edges_on_cell[c,j]]
    w_div_cell: Any = None       # (C, M) = -sign * dv / areaCell
    # kinetic energy: ke(c)  = sum_j w_ke_cell[c,j]   * u[eoc]^2
    w_ke_cell: Any = None        # (C, M) = 0.25 * dv * dc / areaCell
    # curl:          curl(v) = sum_j w_curl_vertex[v,j] * u[edges_on_vertex]
    w_curl_vertex: Any = None    # (V, D) = sign_v * dc / areaTriangle
    # kite fractions: h(v)   = sum_j w_kite_frac[v,j] * h[cells_on_vertex]
    w_kite_frac: Any = None      # (V, D) = kiteArea / areaTriangle

    # host-side layout metadata of a patch-renumbered icosahedral mesh
    # (mesh/icos_patches.PatchInfo: frame content maps, per-patch stencil
    # tables and the cache of the mega-step build); None on other meshes.
    # It rides along unchanged through `.to()`, so every copy of the mesh
    # shares one set of tables.
    patch_info: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    # host-side gather tables of a bandwidth-bounded (RCM-renumbered)
    # unstructured mesh: {stencil name: ops/gather_kernel.GatherTable},
    # built by ops/trisk.warm_gather; None on other meshes. Like patch_info
    # it rides along through `.to()`; each table keeps its device copies per
    # (device, dtype), made at first use.
    gather_info: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    # ------------------------------------------------------------------
    def to(self, device=None, dtype=None) -> "HorzMesh":
        """Every array leaf as a torch tensor on `device` (None: the CUDA
        device, see omega_tpu_torch.default_device). Floating-point leaves
        are cast to `dtype` (None keeps each leaf's own precision); integer
        leaves keep theirs."""
        dev = resolve_device(device)

        def put(x):
            if x is None:
                return None
            t = torch.as_tensor(x)
            if t.is_floating_point() and dtype is not None:
                return t.to(device=dev, dtype=dtype)
            return t.to(device=dev)
        return dataclasses.replace(
            self, **{n: put(getattr(self, n)) for n in ARRAY_FIELDS})

    @property
    def float_dtype(self):
        return self.area_cell.dtype


def unclamped_connectivity(mesh: HorzMesh) -> dict:
    """Recover -1-padded connectivity from a finalized mesh's clamped
    arrays (padding was clamped to element 0, which collides with the
    real element 0 on boundary meshes).

    Validity comes from the derived arrays finalize_mesh zeroes exactly
    on padding (edge signs, kite areas, weights) plus edge<->cell /
    edge<->vertex incidence for the 2-slot edge arrays. On periodic or
    sphere meshes every slot is valid and the output equals the stored
    arrays. Host numpy in, host numpy (int64) out; consumers: the patch
    renumbering (mesh/icos_patches.py) and the mega-step build
    (mesh/icos_mega.py)."""
    a = lambda n: np.asarray(getattr(mesh, n))
    M = mesh.max_edges

    eoc = a("edges_on_cell").astype(np.int64)
    eov = a("edges_on_vertex").astype(np.int64)
    coe = a("cells_on_edge").astype(np.int64)
    voe = a("vertices_on_edge").astype(np.int64)
    cov = a("cells_on_vertex").astype(np.int64)
    n_eoc = a("n_edges_on_cell").astype(np.int64)

    pad_c = np.arange(M)[None, :] >= n_eoc[:, None]
    valid_eoc = (a("edge_sign_on_cell") != 0.0) & ~pad_c
    valid_eov = a("edge_sign_on_vertex") != 0.0
    valid_cov = a("kite_areas_on_vertex") != 0.0

    def _incidence(two_slot, src_ids, src_valid):
        """two_slot[e, i] valid iff (e, target) appears in the transposed
        connectivity with a valid slot."""
        valid = np.zeros(two_slot.shape, bool)
        e_f = src_ids[src_valid]
        t_f = np.broadcast_to(np.arange(src_ids.shape[0])[:, None],
                              src_ids.shape)[src_valid]
        for i in range(two_slot.shape[1]):
            hit = two_slot[e_f, i] == t_f
            valid[e_f[hit], i] = True
        return valid

    valid_coe = _incidence(coe, eoc, valid_eoc)
    valid_voe = _incidence(voe, eov, valid_eov)

    interior = a("edge_mask") > 0.0
    valid_coc = valid_eoc & interior[np.where(valid_eoc, eoc, 0)]

    n_eoe = a("n_edges_on_edge").astype(np.int64)
    eoe = a("edges_on_edge").astype(np.int64)
    pad_e = np.arange(eoe.shape[1])[None, :] >= n_eoe[:, None]
    # zero-weight slots carry nothing: dropping a legitimately-zero
    # Thuburn weight's target is numerically identical and also catches
    # clamped padding (whose weight finalize zeroed)
    valid_eoe = ~pad_e & (a("weights_on_edge") != 0.0)

    unc = lambda idx, valid: np.where(valid, idx, -1)
    return dict(
        edges_on_cell=unc(eoc, valid_eoc),
        cells_on_cell=unc(a("cells_on_cell").astype(np.int64), valid_coc),
        vertices_on_cell=unc(a("vertices_on_cell").astype(np.int64),
                             valid_eoc),
        cells_on_edge=unc(coe, valid_coe),
        vertices_on_edge=unc(voe, valid_voe),
        edges_on_edge=unc(eoe, valid_eoe),
        cells_on_vertex=unc(cov, valid_cov),
        edges_on_vertex=unc(eov, valid_eov),
    )


def finalize_mesh(raw: dict, *, ncells: int, nedges: int, nvertices: int,
                  max_edges: int, vertex_degree: int, on_sphere: bool = False,
                  sphere_radius: float = 0.0, x_period: float = 0.0,
                  y_period: float = 0.0) -> HorzMesh:
    """Build a HorzMesh from primitive numpy arrays, deriving edge signs,
    masks, mesh scaling, and fused stencil weights.

    `raw` must contain (0-based connectivity, padded entries = -1):
      x/y/area/f per element class, bottom_depth, dc/dv/angle,
      edges_on_cell, cells_on_cell, vertices_on_cell, n_edges_on_cell,
      cells_on_edge, vertices_on_edge, edges_on_edge, n_edges_on_edge,
      weights_on_edge, cells_on_vertex, edges_on_vertex, kite_areas_on_vertex.
    Optional: lon/lat per element class, mesh_scaling_del2/del4.
    """
    C, E, V, M, D = ncells, nedges, nvertices, max_edges, vertex_degree

    eoc = np.asarray(raw["edges_on_cell"], np.int64)
    coe = np.asarray(raw["cells_on_edge"], np.int64)
    voe = np.asarray(raw["vertices_on_edge"], np.int64)
    eov = np.asarray(raw["edges_on_vertex"], np.int64)
    cov = np.asarray(raw["cells_on_vertex"], np.int64)

    n_eoc = np.asarray(raw["n_edges_on_cell"], np.int64)
    valid_eoc = np.arange(M)[None, :] < n_eoc[:, None]
    valid_eoc &= eoc >= 0

    # edge sign on cell: -1 if the cell is cellsOnEdge[e,0] (normal points
    # away from it), +1 otherwise  (HorzMesh.cpp:539-546)
    cell_ids = np.arange(C)[:, None]
    eoc_c = np.where(valid_eoc, eoc, 0)
    sign_c = np.where(coe[eoc_c, 0] == cell_ids, -1.0, 1.0)
    sign_c = np.where(valid_eoc, sign_c, 0.0)

    # edge sign on vertex: -1 if vertex is verticesOnEdge[e,0]
    valid_eov = eov >= 0
    vert_ids = np.arange(V)[:, None]
    eov_c = np.where(valid_eov, eov, 0)
    sign_v = np.where(voe[eov_c, 0] == vert_ids, -1.0, 1.0)
    sign_v = np.where(valid_eov, sign_v, 0.0)

    # edge mask: zero when either adjacent cell is missing (HorzMesh.cpp:581-604)
    edge_mask = ((coe[:, 0] >= 0) & (coe[:, 1] >= 0)).astype(np.float64)

    area_cell = np.asarray(raw["area_cell"], np.float64)
    area_tri = np.asarray(raw["area_triangle"], np.float64)
    dv = np.asarray(raw["dv_edge"], np.float64)
    dc = np.asarray(raw["dc_edge"], np.float64)
    kites = np.asarray(raw["kite_areas_on_vertex"], np.float64)

    w_div = np.where(valid_eoc, -sign_c * dv[eoc_c] / area_cell[:, None], 0.0)
    w_ke = np.where(valid_eoc, 0.25 * dv[eoc_c] * dc[eoc_c] / area_cell[:, None], 0.0)
    w_curl = np.where(valid_eov, sign_v * dc[eov_c] / area_tri[:, None], 0.0)
    valid_cov = cov >= 0
    w_kite = np.where(valid_cov, kites / area_tri[:, None], 0.0)

    def clamp(idx):
        return np.maximum(np.asarray(idx, np.int64), 0).astype(np.int32)

    zeros_c = np.zeros(C, np.float64)
    zeros_e = np.zeros(E, np.float64)
    zeros_v = np.zeros(V, np.float64)

    eoe = np.asarray(raw["edges_on_edge"], np.int64)
    woe = np.asarray(raw["weights_on_edge"], np.float64)
    woe = np.where(eoe >= 0, woe, 0.0)

    return HorzMesh(
        ncells=C, nedges=E, nvertices=V, max_edges=M, vertex_degree=D,
        on_sphere=on_sphere, sphere_radius=sphere_radius,
        x_period=x_period, y_period=y_period,
        x_cell=np.asarray(raw["x_cell"], np.float64),
        y_cell=np.asarray(raw["y_cell"], np.float64),
        lon_cell=np.asarray(raw.get("lon_cell", zeros_c), np.float64),
        lat_cell=np.asarray(raw.get("lat_cell", zeros_c), np.float64),
        area_cell=area_cell,
        f_cell=np.asarray(raw["f_cell"], np.float64),
        bottom_depth=np.asarray(raw["bottom_depth"], np.float64),
        n_edges_on_cell=n_eoc.astype(np.int32),
        edges_on_cell=clamp(eoc_c * valid_eoc),
        cells_on_cell=clamp(np.asarray(raw["cells_on_cell"], np.int64)),
        vertices_on_cell=clamp(np.asarray(raw["vertices_on_cell"], np.int64)),
        edge_sign_on_cell=sign_c,
        cell_mask=np.ones(C, np.float64),
        x_edge=np.asarray(raw["x_edge"], np.float64),
        y_edge=np.asarray(raw["y_edge"], np.float64),
        lon_edge=np.asarray(raw.get("lon_edge", zeros_e), np.float64),
        lat_edge=np.asarray(raw.get("lat_edge", zeros_e), np.float64),
        dc_edge=dc, dv_edge=dv,
        angle_edge=np.asarray(raw["angle_edge"], np.float64),
        f_edge=np.asarray(raw["f_edge"], np.float64),
        cells_on_edge=clamp(coe),
        vertices_on_edge=clamp(voe),
        n_edges_on_edge=np.asarray(raw["n_edges_on_edge"], np.int32),
        edges_on_edge=clamp(eoe),
        weights_on_edge=woe,
        edge_mask=edge_mask,
        mesh_scaling_del2=np.asarray(raw.get("mesh_scaling_del2", np.ones(E)), np.float64),
        mesh_scaling_del4=np.asarray(raw.get("mesh_scaling_del4", np.ones(E)), np.float64),
        x_vertex=np.asarray(raw["x_vertex"], np.float64),
        y_vertex=np.asarray(raw["y_vertex"], np.float64),
        lon_vertex=np.asarray(raw.get("lon_vertex", zeros_v), np.float64),
        lat_vertex=np.asarray(raw.get("lat_vertex", zeros_v), np.float64),
        area_triangle=area_tri,
        f_vertex=np.asarray(raw["f_vertex"], np.float64),
        cells_on_vertex=clamp(cov),
        edges_on_vertex=clamp(eov),
        kite_areas_on_vertex=np.where(valid_cov, kites, 0.0),
        edge_sign_on_vertex=sign_v,
        vertex_mask=np.ones(V, np.float64),
        w_div_cell=w_div, w_ke_cell=w_ke,
        w_curl_vertex=w_curl, w_kite_frac=w_kite,
    )
