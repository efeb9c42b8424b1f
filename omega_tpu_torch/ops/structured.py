"""Gather-free stencil execution on uniform doubly periodic hex meshes.

On the uniform planar hex mesh every stencil neighbor is a FIXED lattice
displacement, so each gather of (element, K) rows can be replaced by a
periodic shift of the (ny, nx) grid: streaming reads instead of indexed
ones.

The machinery is derived, not hand-coded: `_decompose` inspects an actual
connectivity array (e.g. edges_on_cell) of the generated mesh and factors
every (destination-type, slot) entry into

    (source type t, row shift dj, column shift for even rows di_e,
     column shift for odd rows di_o)

verifying uniformity across all elements (the odd-row stagger of the
offset hex layout makes di parity-dependent). Weights are likewise
verified uniform per slot and reduced to scalars. Any mesh whose
connectivity does not factor this way simply fails detection and stays on
the gather path, so correctness never depends on the generator details.

Element ids follow the planar generator's CLASS-MAJOR scheme: cell
c = j*nx + i, edges t*C + c for t in {E, NE, NW}, vertices t*C + c
(mesh/planar.py:133-170). Class-major numbering makes the canonical
internal layout (..., T, ny, nx, K) a free reshape of (..., N, K), so
per-type slices and output stacks stay contiguous.

Execution: `apply_stencil` hands a CUDA field to the hand-written stencil
kernel and a CPU field to its plain roll form (both in
ops/stencil_kernel.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NPER = {"cell": 1, "edge": 3, "vertex": 2}


def enabled(mesh) -> bool:
    return (getattr(mesh, "structured_nx", 0) > 0
            and mesh.structured_ny % 2 == 0)


# ----------------------------------------------------------------------
# table derivation (host-side numpy, cached per mesh size + stencil name)

def _wrap(d, n):
    """Displacement folded to the symmetric range (-n/2, n/2]."""
    return (d + n // 2) % n - n // 2


def _decompose(idx: np.ndarray, dst_class: str, src_class: str,
               nx: int, ny: int,
               weights: Optional[np.ndarray]) -> Optional[list]:
    """Factor a (N_dst, S) index map into per-(t_dst, slot) shift tuples.

    Returns [(t_dst, t_src, dj, di_e, di_o, w_scalar), ...] or None if the
    map is not uniform (not a structured mesh stencil)."""
    pd, ps = _NPER[dst_class], _NPER[src_class]
    N, S = idx.shape
    C = nx * ny
    if N != C * pd:
        return None
    d = np.arange(N)
    c_dst = d % C          # class-major: id = t*C + c
    i_dst, j_dst = c_dst % nx, c_dst // nx
    t_dst = d // C
    out = []
    for s in range(S):
        tgt = idx[:, s]
        t_src = tgt // C
        c_src = tgt % C
        i_src, j_src = c_src % nx, c_src // nx
        dj = _wrap(j_src - j_dst, ny)
        di = _wrap(i_src - i_dst, nx)
        for t in range(pd):
            sel = t_dst == t
            if not sel.any():
                return None
            if weights is not None and np.all(weights[sel, s] == 0.0):
                continue    # padded slot (e.g. edgesOnEdge beyond nEdgesOnEdge)
            ts = t_src[sel]
            if (ts != ts[0]).any():
                return None
            djs = dj[sel]
            if (djs != djs[0]).any():
                return None
            even = sel & (j_dst % 2 == 0)
            odd = sel & (j_dst % 2 == 1)
            di_e = di[even]
            di_o = di[odd]
            if (di_e != di_e[0]).any() or (di_o != di_o[0]).any():
                return None
            if abs(int(djs[0])) > 2 or abs(int(di_e[0])) > 2 \
                    or abs(int(di_o[0])) > 2:
                return None
            w = 1.0
            if weights is not None:
                ws = weights[sel, s]
                if not np.allclose(ws, ws[0], rtol=0, atol=0):
                    return None
                w = float(ws[0])
            out.append((t, int(ts[0]), int(djs[0]), int(di_e[0]),
                        int(di_o[0]), w))
    return out


_TABLE_CACHE: dict = {}

# per-element mesh arrays that collapse to scalars on the uniform mesh —
# the hot path asks for these via trisk.col() and multiplies by a python
# scalar instead of broadcasting an (N, 1) column
_UNIFORM_ATTRS = ("dc_edge", "dv_edge", "edge_mask", "mesh_scaling_del2",
                  "mesh_scaling_del4", "f_edge", "f_vertex", "f_cell",
                  "bottom_depth", "area_cell", "area_triangle")


def uniform_scalar_table(mesh) -> tuple:
    """((attr, value), ...) for per-element arrays that are spatially
    uniform (host side, called with numpy arrays at mesh construction;
    stored as static HorzMesh.structured_scalars metadata)."""
    out = []
    for attr in _UNIFORM_ATTRS:
        arr = getattr(mesh, attr)
        if isinstance(arr, np.ndarray) and arr.size and np.ptp(arr) == 0.0:
            out.append((attr, float(arr.flat[0])))
    return tuple(out)


def uniform_scalar(mesh, attr: str):
    """The scalar value of a uniform per-element array, or None."""
    if not enabled(mesh):
        return None
    for a, v in mesh.structured_scalars:
        if a == attr:
            return v
    return None


def stencil_table(mesh, name: str, idx, dst_class: str,
                  src_class: str, weights=None):
    """Cached table for a named stencil of a structured mesh. `idx` and
    `weights` may be attribute names or arrays; cache key is mesh size +
    grid spacing + stencil name (weights are pure functions of dc on the
    uniform mesh, so same-size different-spacing meshes must not collide).

    Tables are built from host numpy arrays — planar_hex_mesh (and
    convert.mesh_from_numpy) warm the cache before the mesh moves to a
    device. With tensor leaves a cache miss falls back to the gather path
    (returns a None table) rather than erroring."""
    key = (mesh.structured_nx, mesh.structured_ny, mesh.structured_dc, name)
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    if isinstance(idx, str):
        idx = getattr(mesh, idx)
    if not isinstance(idx, np.ndarray):
        # device tensors: lookup-only, no build — warm_structured
        # populates the cache at mesh construction
        return (None, dst_class, src_class)
    idx = np.asarray(idx)
    if idx.ndim == 1:
        idx = idx[:, None]
    if isinstance(weights, str):
        weights = getattr(mesh, weights)
    w = None if weights is None else np.asarray(weights)
    tab = _decompose(idx, dst_class, src_class,
                     mesh.structured_nx, mesh.structured_ny, w)
    _TABLE_CACHE[key] = (tab, dst_class, src_class)
    return _TABLE_CACHE[key]


def cached_table(mesh, name: str):
    """The cached shift list of a named stencil as a tuple, or None."""
    key = (mesh.structured_nx, mesh.structured_ny, mesh.structured_dc, name)
    tab = _TABLE_CACHE.get(key, (None,))[0]
    return None if tab is None else tuple(tab)


# ----------------------------------------------------------------------
# execution

def _to_grid(f, nper: int, nx: int, ny: int):
    """(..., N, K) -> (..., T, ny, nx, K) — free for class-major ids."""
    return f.reshape(f.shape[:-2] + (nper, ny, nx) + f.shape[-1:])


def _from_grid(g):
    """(..., T, ny, nx, K) -> (..., N, K)."""
    T, ny, nx, K = g.shape[-4:]
    return g.reshape(g.shape[:-4] + (T * ny * nx, K))


def _shift(F, dj: int, di_e: int, di_o: int):
    """out[..., j, i, :] = F[..., (j+dj) % ny, (i+di(j)) % nx, :]
    with di depending on the parity of the DESTINATION row j.
    F: (..., ny, nx, K); row axis -3, column axis -2."""
    G = torch.roll(F, -dj, dims=-3) if dj else F
    if di_e == di_o:
        return torch.roll(G, -di_e, dims=-2) if di_e else G
    ny = F.shape[-3]
    even_rows = (torch.arange(ny, device=F.device) % 2 == 0)[:, None, None]
    a = torch.roll(G, -di_e, dims=-2) if di_e else G
    b = torch.roll(G, -di_o, dims=-2) if di_o else G
    return torch.where(even_rows, a, b)


def roll_grid(s, d, dim):
    """out[i] = s[i + d] along `dim`, periodic."""
    return torch.roll(s, -d, dims=dim) if d else s


def apply_grid(tab, vals, even, pd):
    """Apply a shift table to per-class grids (..., Y, X), x fastest (the
    layout of the fused kernels' plain versions):
    out[t_dst][y, x] = sum w * val[t_src][y + dj, x + di(parity(y))],
    shifts wrapping within the array; `even` is the (Y, 1) mask of rows
    whose GLOBAL index is even."""
    outs = [None] * pd
    for (t_dst, t_src, dj, di_e, di_o, w) in tab:
        s = roll_grid(vals[t_src], dj, -2)
        a = roll_grid(s, di_e, -1)
        if di_e != di_o:
            a = torch.where(even, a, roll_grid(s, di_o, -1))
        contrib = w * a
        outs[t_dst] = contrib if outs[t_dst] is None else outs[t_dst] + contrib
    return outs


def apply_stencil(mesh, table, field):
    """Compute out[d] = sum_s w_{t,s} * field[idx[d, s]] as lattice shifts.

    field: (..., N_src, K). Returns (..., N_dst, K). A CUDA field goes
    through the stencil kernel, a CPU field through its plain roll form;
    a kernel that fails to build or launch raises."""
    from omega_tpu_torch.ops import stencil_kernel
    tab, dst_class, src_class = table[:3]
    nx, ny = mesh.structured_nx, mesh.structured_ny
    ps, pd = _NPER[src_class], _NPER[dst_class]
    return stencil_kernel.apply(tab, ps, pd, nx, ny, field)
