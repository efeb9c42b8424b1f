"""Structure-preserving decomposition of uniform planar hex meshes.

The general decomposition (decomp.py) renumbers each shard's local mesh,
which drops it off the structured fast path — on the card that forfeits
the fused step kernels precisely where performance matters most. This
module shards the (ny, nx) grid into an (sy, sx) grid of rectangles
instead (sx == 1 gives row bands):

  * shard (iy, ix) owns cell rows [iy*band, (iy+1)*band) x columns
    [ix*band_x, (ix+1)*band_x); its local domain adds `hw` halo rows and
    (when sx > 1) `hw` halo columns, so the local mesh IS a
    planar_hex_mesh(band_x + 2*hw, band + 2*hw) — fully structured, so the
    fused FB step (ops/megastep.py) takes it
  * the local periodic wrap across the cuts produces garbage only in the
    outermost halo ring, exactly the owned+halo redundancy model of the
    reference (compute over NCellsAll, exchange refreshes halos)
  * halo width hw = 4 (>= the width-3 contract; even so the row parity
    phase of the hex stagger is preserved across row cuts — column cuts
    have no parity constraint since the stagger shifts whole rows)
  * the exchange is two stages of row / column block copies over the
    shard list (shard id s = iy*sx + ix): stage 1 moves row blocks
    between y-neighbors, stage 2 moves column blocks (including the
    just-refreshed y-halo rows) between x-neighbors, which also fills the
    corner regions — no index lists at all; all element classes and
    tracers ride one stacked (1 + 3 + L, nyl, nxl, K) bundle
  * beta-plane (and variable-depth) meshes are supported by overriding
    the local mesh's f / bottom_depth arrays with per-shard windows of the
    global arrays (sliced, not recomputed, so the periodic-wrap
    discontinuity of f matches the global mesh exactly); the local mesh's
    static uniform-scalar table drops those attrs so trisk.col falls back
    to the per-element columns, and such a mesh leaves the fused path, as
    in the reference
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import HorzMesh
from omega_tpu_torch.mesh.planar import planar_hex_mesh
from omega_tpu_torch.ops import structured
from omega_tpu_torch.parallel.decomp import host
from omega_tpu_torch.parallel.sharded import (Lockstep, _devices, _preload,
                                              _to_shards, sharded_sampler,
                                              shard_halos)

HW = 4   # halo rows/cols (>= reference HaloWidth 3; even preserves parity)

# per-element mesh fields that may vary spatially on a planar hex mesh
# (everything else — dc, dv, areas, kites, weights — is uniform by
# construction); ordered (attr, element class)
_VARIABLE_ATTRS = (("f_cell", "cell"), ("f_edge", "edge"),
                   ("f_vertex", "vertex"), ("bottom_depth", "cell"))
_NPER = {"cell": 1, "edge": 3, "vertex": 2}


@dataclasses.dataclass(frozen=True)
class StructuredShards:
    nshards: int
    sy: int                      # shard grid rows
    sx: int                      # shard grid cols
    nx: int                      # global grid
    ny: int
    band: int                    # owned rows per shard
    band_x: int                  # owned cols per shard (nx when sx == 1)
    hw: int                      # halo rows
    hwx: int                     # halo cols (0 when sx == 1)
    local_mesh: HorzMesh         # planar hex local mesh (host), shared
    global_mesh: HorzMesh
    # host (S, N_local) per-shard windows of non-uniform mesh fields,
    # ((attr, array), ...); () on fully uniform (f-plane) meshes
    mesh_overrides: tuple = ()

    @property
    def nyl(self):
        return self.band + 2 * self.hw

    @property
    def nxl(self):
        return self.band_x + 2 * self.hwx

    def local_meshes(self, devices, dtype=None) -> list:
        """One local mesh a shard on its device: the shared local mesh (one
        copy a device) with the shard's windows of the overrides."""
        copies = {}
        out = []
        for s, dev in enumerate(devices):
            if dev not in copies:
                copies[dev] = self.local_mesh.to(dev, dtype)
            m = copies[dev]
            if self.mesh_overrides:
                m = dataclasses.replace(m, **{
                    a: torch.as_tensor(v[s]).to(
                        device=dev, dtype=dtype or torch.float64)
                    for a, v in self.mesh_overrides})
            out.append(m)
        return out


def _choose_layout(nx, ny, nshards, hw):
    """(sy, sx) with ny%sy==0, even band>=hw, nx%sx==0, band_x>=hw.
    Prefers row bands (sx=1), then the most-square valid factorization."""
    opts = []
    for sx in range(1, nshards + 1):
        if nshards % sx:
            continue
        sy = nshards // sx
        if ny % sy:
            continue
        band = ny // sy
        if band % 2 or band < hw:
            continue
        if sx > 1:
            if nx % sx:
                continue
            if nx // sx < hw:
                continue
        opts.append((sx != 1, abs(sy - sx), sy, sx))
    if not opts:
        raise ValueError(
            f"no valid (sy, sx) layout for nx={nx}, ny={ny}, "
            f"nshards={nshards} (need ny%sy==0 with even band>=hw={hw}, "
            f"and nx%sx==0 with band_x>=hw)")
    opts.sort()
    _, _, sy, sx = opts[0]
    return sy, sx


def decompose_structured(mesh: HorzMesh, nshards: int, hw: int = HW,
                         layout: Optional[Tuple[int, int]] = None
                         ) -> StructuredShards:
    nx, ny = mesh.structured_nx, mesh.structured_ny
    if nx == 0:
        raise ValueError("mesh is not structured")
    if layout is None:
        sy, sx = _choose_layout(nx, ny, nshards, hw)
    else:
        sy, sx = layout
        if sy * sx != nshards:
            raise ValueError(f"layout {layout} != {nshards} shards")
    band = ny // sy
    band_x = nx // sx
    hwx = hw if sx > 1 else 0
    if ny % sy or band % 2 or band < hw:
        raise ValueError(f"rows: ny={ny} needs sy | ny with even "
                         f"band >= hw, got sy={sy}")
    if sx > 1 and (nx % sx or band_x < hw):
        raise ValueError(f"cols: nx={nx} needs sx | nx with "
                         f"band_x >= hw, got sx={sx}")

    f0 = structured.uniform_scalar(mesh, "f_cell")
    depth = structured.uniform_scalar(mesh, "bottom_depth")
    local = planar_hex_mesh(band_x + 2 * hwx, band + 2 * hw,
                            dc=mesh.structured_dc,
                            f0=f0 if f0 is not None else 0.0,
                            bottom_depth=depth if depth is not None else 1.0)

    ss = StructuredShards(nshards=nshards, sy=sy, sx=sx, nx=nx, ny=ny,
                          band=band, band_x=band_x, hw=hw, hwx=hwx,
                          local_mesh=local, global_mesh=mesh)

    # per-shard windows of any non-uniform field (beta-plane f, variable
    # bathymetry); strip those attrs from the local static scalar table
    overrides = []
    stale = set()
    for attr, cls in _VARIABLE_ATTRS:
        if structured.uniform_scalar(mesh, attr) is None:
            arr = host(getattr(mesh, attr))
            loc = _split_field(ss, arr[:, None], _NPER[cls])[..., 0]
            overrides.append((attr, loc))
            stale.add(attr)
    if stale:
        keep = tuple((a, v) for a, v in local.structured_scalars
                     if a not in stale)
        local = dataclasses.replace(local, structured_scalars=keep)
        ss = dataclasses.replace(ss, local_mesh=local,
                                 mesh_overrides=tuple(overrides))
    return ss


# ----------------------------------------------------------------------
# state scatter/gather (host side)

def _rows(ss: StructuredShards, iy: int) -> np.ndarray:
    """Global row indices (wrapped) of a shard row's local rows."""
    start = iy * ss.band - ss.hw
    return (start + np.arange(ss.band + 2 * ss.hw)) % ss.ny


def _cols(ss: StructuredShards, ix: int) -> np.ndarray:
    start = ix * ss.band_x - ss.hwx
    return (start + np.arange(ss.band_x + 2 * ss.hwx)) % ss.nx


def _split_field(ss: StructuredShards, f, nper: int):
    """(..., nper*ny*nx, K) -> (S, ..., nper*nyl*nxl, K), host numpy."""
    f = host(f)
    K = f.shape[-1]
    lead = f.shape[:-2]
    g = f.reshape(lead + (nper, ss.ny, ss.nx, K))
    outs = []
    for iy in range(ss.sy):
        rows = _rows(ss, iy)
        gr = np.take(g, rows, axis=len(lead) + 1)
        for ix in range(ss.sx):
            loc = np.take(gr, _cols(ss, ix), axis=len(lead) + 2)
            outs.append(loc.reshape(lead + (nper * ss.nyl * ss.nxl, K)))
    return np.stack(outs)


def _local_index(ss: StructuredShards, nper: int):
    """(S, nper*nyl*nxl) global ids of every shard's local elements."""
    return element_maps(ss, {1: "cell", 3: "edge", 2: "vertex"}[nper])[0]


def shard_state(ss: StructuredShards, state: ModelState,
                devices) -> list:
    """A global state -> one local state a shard, on its device (gathered on
    the state's own device, then moved)."""
    dev0 = state.h.device
    ci = torch.as_tensor(_local_index(ss, 1), device=dev0)
    ei = torch.as_tensor(_local_index(ss, 3), device=dev0)
    return [ModelState(h=state.h[ci[s]].to(d), u=state.u[ei[s]].to(d),
                       tracers=state.tracers[:, ci[s]].to(d))
            for s, d in enumerate(devices)]


def gather_state(ss: StructuredShards, states) -> ModelState:
    """Owned windows of every shard -> the global state, on the first
    shard's device."""
    dev = states[0].h.device

    def merge(fs, nper):
        g = torch.stack([f.to(dev) for f in fs])     # (S, ..., n_loc, K)
        K = g.shape[-1]
        lead = tuple(g.shape[1:-2])
        nl = len(lead)
        g = g.reshape((ss.sy, ss.sx) + lead + (nper, ss.nyl, ss.nxl, K))
        own = g[(slice(None), slice(None)) + (slice(None),) * nl +
                (slice(None),
                 slice(ss.hw, ss.hw + ss.band),
                 slice(ss.hwx, ss.hwx + ss.band_x))]
        # (sy, sx, lead..., nper, band, band_x, K) ->
        # (lead..., nper, sy, band, sx, band_x, K) -> global (ny, nx)
        perm = tuple(range(2, 2 + nl)) + (2 + nl, 0, 3 + nl, 1,
                                          4 + nl, 5 + nl)
        own = own.permute(perm)
        out = own.reshape(lead + (nper, ss.sy * ss.band,
                                  ss.sx * ss.band_x, K))
        return out.reshape(lead + (nper * ss.ny * ss.nx, K))

    return ModelState(h=merge([s.h for s in states], 1),
                      u=merge([s.u for s in states], 3),
                      tracers=merge([s.tracers for s in states], 1))


def element_maps(ss: StructuredShards, cls: str):
    """(l2g, owned) for one element class: (S, nper*nyl*nxl) global ids
    of every local element and the owned-window mask — feeds sharded
    region writes (io.stream.ShardedFieldData)."""
    nper = _NPER[cls]
    S = ss.nshards
    n_loc = nper * ss.nyl * ss.nxl
    l2g = np.zeros((S, n_loc), np.int64)
    owned = np.zeros((S, n_loc), bool)
    oy = (np.arange(ss.nyl) >= ss.hw) & \
        (np.arange(ss.nyl) < ss.hw + ss.band)
    ox = (np.arange(ss.nxl) >= ss.hwx) & \
        (np.arange(ss.nxl) < ss.hwx + ss.band_x)
    own_grid = (oy[None, :, None] & ox[None, None, :]) & \
        np.ones((nper, 1, 1), bool)
    for iy in range(ss.sy):
        rows = _rows(ss, iy)
        for ix in range(ss.sx):
            cols = _cols(ss, ix)
            gid = (np.arange(nper)[:, None, None] * (ss.ny * ss.nx)
                   + rows[None, :, None] * ss.nx + cols[None, None, :])
            s = iy * ss.sx + ix
            l2g[s] = gid.reshape(-1)
            owned[s] = own_grid.reshape(-1)
    return l2g, owned


# ----------------------------------------------------------------------
# the halo exchange: two stages of block copies over the shard list

def _src_y(ss, s, d):
    """The shard whose row blocks reach shard s moving d shard-rows
    forward."""
    iy, ix = divmod(s, ss.sx)
    return ((iy - d) % ss.sy) * ss.sx + ix


def _src_x(ss, s, d):
    iy, ix = divmod(s, ss.sx)
    return iy * ss.sx + (ix - d) % ss.sx


def _exchange_bundle(ss: StructuredShards, bundles):
    """Halo refresh of (T, nyl, nxl, K) stacked grid arrays, one a shard."""
    hw, hwx = ss.hw, ss.hwx
    S = len(bundles)
    # stage 1: rows between y-neighbors (full local width): every shard
    # sends its top owned rows up and its bottom owned rows down
    ups = [b[:, ss.band:ss.band + hw] for b in bundles]
    dns = [b[:, hw:2 * hw] for b in bundles]
    out = []
    for s in range(S):
        b = bundles[s]
        up = ups[_src_y(ss, s, 1)].to(b.device, non_blocking=True)
        dn = dns[_src_y(ss, s, -1)].to(b.device, non_blocking=True)
        out.append(torch.cat([up, b[:, hw:ss.band + hw], dn], 1))
    bundles = out
    # stage 2: columns between x-neighbors (full local height including
    # the fresh y-halos, which fills the corners)
    if ss.sx > 1:
        rts = [b[:, :, ss.band_x:ss.band_x + hwx] for b in bundles]
        lts = [b[:, :, hwx:2 * hwx] for b in bundles]
        out = []
        for s in range(S):
            b = bundles[s]
            rt = rts[_src_x(ss, s, 1)].to(b.device, non_blocking=True)
            lt = lts[_src_x(ss, s, -1)].to(b.device, non_blocking=True)
            out.append(torch.cat([rt, b[:, :, hwx:ss.band_x + hwx], lt], 2))
        bundles = out
    return bundles


def _exchange_array(ss: StructuredShards, xs, nper: int):
    """Halo refresh of one element array (..., nper*nyl*nxl, K) a shard."""
    K = xs[0].shape[-1]
    lead = tuple(xs[0].shape[:-2])
    g = _exchange_bundle(ss, [x.reshape((-1, ss.nyl, ss.nxl, K))
                              for x in xs])
    return [b.reshape(lead + (nper * ss.nyl * ss.nxl, K)) for b in g]


def _exchange_rows(ss: StructuredShards, states) -> list:
    nyl, nxl = ss.nyl, ss.nxl
    bundles = []
    for st in states:
        K = st.h.shape[-1]
        L = st.tracers.shape[0]
        bundles.append(torch.cat([st.h.reshape(1, nyl, nxl, K),
                                  st.u.reshape(3, nyl, nxl, K),
                                  st.tracers.reshape(L, nyl, nxl, K)], 0))
    out = []
    for b in _exchange_bundle(ss, bundles):
        K = b.shape[-1]
        out.append(ModelState(h=b[0].reshape(nyl * nxl, K),
                              u=b[1:4].reshape(3 * nyl * nxl, K),
                              tracers=b[4:].reshape(-1, nyl * nxl, K)))
    return out


def make_halo_fn(ss: StructuredShards) -> Callable:
    """The list-level exchange of the structured decomposition: the
    full-state bundle, `.cell` / `.edge` for one array a shard."""
    def halo_fn(states):
        return _exchange_rows(ss, states)
    halo_fn.cell = lambda xs: _exchange_array(ss, xs, 1)
    halo_fn.edge = lambda xs: _exchange_array(ss, xs, 3)
    return halo_fn


def make_sharded_step(ss: StructuredShards, cfg: ModelConfig, stepper,
                      devices=None, wind_stress=None,
                      exchange_every: int = 1, dtype=None) -> Callable:
    """Sharded step over the structured decomposition: (list of per-shard
    ModelState, t, dt, wind) -> list.

    Every shard runs the SAME structured local mesh (on the card the fused
    FB step, one launch a shard a step); the halo callback is the
    two-stage block copy.

    exchange_every=k > 1 amortizes communication (the reference's
    deep-halo pattern, base/Halo.h:849 + RK4's mid-step skip): the
    returned step advances k steps per call with ONE exchange at the end,
    trading halo redundancy for 1/k the exchanges. Requires hw >= k *
    (per-step stencil radius, 3 with del4 enabled) + 1 and a stepper whose
    only halo use is the end-of-step refresh (FB, RK2 — not split-explicit,
    whose subcycles exchange internally)."""
    devices = _devices(devices, ss.nshards)
    meshes = ss.local_meshes(devices, dtype)
    group = Lockstep(devices)
    halos = shard_halos(group, make_halo_fn(ss))
    c_idx = _local_index(ss, 1)
    _preload(devices)

    def scatter_wind(w):
        """(zonal, merid) global (C,) arrays -> per-shard windows (for
        time-varying forcing updates between segments)."""
        out = []
        for s, dev in enumerate(devices):
            c = torch.as_tensor(c_idx[s], device=w[0].device)
            out.append(tuple(x[c].to(dev) for x in w))
        return out

    default_wind = None if wind_stress is None else scatter_wind(wind_stress)

    def step(states, t, dt, wind=None):
        wind = default_wind if wind is None else wind

        def local(s):
            st = states[s]
            w = None if wind is None else wind[s]
            for i in range(exchange_every - 1):
                # halo garbage creeps inward one radius per un-exchanged
                # step; hw budgets for it
                st = stepper(meshes[s], cfg, st, t + i * dt, dt,
                             wind_stress=w)
            return stepper(meshes[s], cfg, st, t + (exchange_every - 1) * dt,
                           dt, halos[s], wind_stress=w)

        return group.run(local)

    step.scatter_wind = scatter_wind
    step.meshes = meshes
    step.devices = devices
    return step


def make_sharded_energetics(ss: StructuredShards, cfg, devices=None,
                            dtype=None):
    """Sharded energetics sampler for the structured decomposition
    (analysis.energetics_local over the shards' owned windows): removes
    the global-state gather at analysis sample boundaries. Returns
    sample(states, ssh_ref=None) -> (row dict, ssh_ref)."""
    devices = _devices(devices, ss.nshards)
    own_c = _to_shards(element_maps(ss, "cell")[1], devices, torch.bool)
    own_v = _to_shards(element_maps(ss, "vertex")[1], devices, torch.bool)
    return sharded_sampler(ss.local_meshes(devices, dtype), cfg, own_c,
                           own_v)
