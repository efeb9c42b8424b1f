"""Sharded execution of the patch-structured sphere fast path.

The 10 rhombus patches of the icosahedral frame layout (mesh/
icos_patches.py) shard over a list of nshards devices with nshards in
{2, 5, 10}: each shard holds whole patches (with their in-frame halo
margins) as its own (K, 4+L, P_l) frames, P_l = (10 / nshards) S S, runs
the fused FB patch kernel (ops/patch_megastep.py: six launches, then the
column kernels with vertical mixing) on them, and the per-step in-frame
refresh decomposes into

  - LOCAL refills (source and target patch on the same shard),
  - copies between shards, one round per shard distance (static exchange
    lists exactly like Halo::generateExchangeLists,
    base/Halo.cpp:455-600 — here derived from the fixed patch adjacency
    instead of a graph partition),
  - the pole-fix substep, REPLICATED on every device that holds a shard:
    each shard's rows of the tiny (~hundreds of rows) submesh state are
    gathered from its own frames, and the composed step runs once a
    device,

so one step is one kernel call a shard + one round of copies + an O(1)
substep. The patch stencils read no position outside their own patch's
frame, so a shard's kernel, given its slice of the compact table (offsets
re-based to P_l), computes bit for bit what the single-device kernel
computes on the same patches; the refresh moves the same values. Results
match the single-device framed path (ops/patch_megastep.
fb_patch_megastep_framed) bit for bit.

The exchange plan (`build_patch_shard`) is the JAX package's: per-device
index lists padded to a common length with out-of-bounds positions
(`oob`); at run time each shard's lists are cut to their real entries.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.ops import patch_megastep as pm
from omega_tpu_torch.parallel.decomp import host
from omega_tpu_torch.parallel.sharded import _devices, _preload

NSHARDS = (2, 5, 10)


class PatchShardPlan:
    """Host-side per-(mesh, nshards, dtype) exchange plan (static)."""


def _split_flat(idx: np.ndarray, cell: int, N: int):
    """Global frame-flat index ((t*10 + r)*SS + y)*SS + x ->
    (device, local flat with P = 10/N patches per device)."""
    P_ = 10 // N
    q, rem = np.divmod(idx, cell)
    t, r = np.divmod(q, 10)
    d, rp = np.divmod(r, P_)
    return d, (t * P_ + rp) * cell + rem


def _stack_pad(lists, pad_val, dtype=np.int32):
    """Per-device variable-length lists -> (N, max) array padded."""
    n = max((len(v) for v in lists), default=0)
    out = np.full((len(lists), max(n, 1)), pad_val, dtype)
    for d, v in enumerate(lists):
        out[d, :len(v)] = v
    return out


def _check_nshards(nshards):
    if nshards not in NSHARDS:
        raise ValueError(f"patch sharding needs nshards in {NSHARDS}, "
                         f"got {nshards}")


def build_patch_shard(mesh, nshards: int, dtype) -> PatchShardPlan:
    """Split the framed-step refresh maps of ops/patch_megastep.prep into
    per-device local + per-distance exchange lists (host numpy, kept on
    the mesh's PatchInfo)."""
    _check_nshards(nshards)
    key = ("patch_shard", nshards, dtype)
    info = mesh.patch_info
    if key in info.cache:
        return info.cache[key]
    p = pm.prep(mesh, dtype, "cpu")
    N = nshards
    pl_ = PatchShardPlan()
    pl_.p = p
    pl_.N = N
    pl_.P = 10 // N
    cell = p.S * p.S

    pl_.groups = {}
    for grp, T in (("cell", 1), ("edge", 3)):
        m = {k: host(v) for k, v in p.persist[grp].items()}
        size_l = T * pl_.P * cell          # local flat size (per device)
        oob = size_l                       # padding sentinel

        pos = m["refill_pos"]
        src = m["refill_src"]
        d_p, lp = _split_flat(pos, cell, N)
        d_s, ls = _split_flat(src, cell, N)

        same = d_p == d_s
        loc_p = [lp[same & (d_p == d)] for d in range(N)]
        loc_s = [ls[same & (d_p == d)] for d in range(N)]

        # cross-device: distance rings, wire order = receiver's order
        rings = []
        for dd in range(1, N):
            sel = ~same & (((d_p - d_s) % N) == dd)
            if not sel.any():
                continue
            send = [[] for _ in range(N)]
            recv = [[] for _ in range(N)]
            for d in range(N):              # d = receiver
                mask = sel & (d_p == d)
                send[(d - dd) % N] = ls[mask]
                recv[d] = lp[mask]
            rings.append((dd, _stack_pad(send, 0), _stack_pad(recv, oob)))

        fixp = m["fix_pos"]
        fixr = m["fix_row"]
        d_f, lf = _split_flat(fixp, cell, N) if fixp.size else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        zp = m["zero_pos"]
        d_z, lz = _split_flat(zp, cell, N) if zp.size else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))

        pl_.groups[grp] = dict(
            size_l=size_l,
            refill_pos=_stack_pad(loc_p, oob),
            refill_src=_stack_pad(loc_s, 0),
            rings=rings,
            fix_pos=_stack_pad([lf[d_f == d] for d in range(N)], oob),
            fix_row=_stack_pad([fixr[d_f == d] for d in range(N)], 0),
            zero_pos=_stack_pad([lz[d_z == d] for d in range(N)], oob),
        )

    # submesh gathers: per-device masked local sources (each submesh row
    # read on the device that owns its frame position)
    for nm in ("sub_cell", "sub_edge"):
        src = host(getattr(p, f"{nm}_src"))
        d_s, ls = _split_flat(src, cell, N)
        own = np.stack([d_s == d for d in range(N)])           # (N, nsub)
        loc = np.where(own, np.stack([ls] * N), 0)
        setattr(pl_, f"{nm}_src_l", loc.astype(np.int32))
        setattr(pl_, f"{nm}_own", own)
    info.cache[key] = pl_
    return pl_


def _rebase(offs, P, P_l):
    """Compact-table offsets ts*P + db*S + da re-based to a frame of P_l
    positions (the source class ts keeps its channel)."""
    ts = np.floor((offs.astype(np.int64) + P // 2) / P).astype(np.int64)
    return (offs - ts * P + ts * P_l).astype(np.int32)


def shard_prep(p, nshards: int, d: int, device):
    """The prep of shard d's frames (patches [d Pp, (d+1) Pp), Pp = 10 /
    nshards) on `device`: the compact table's and const planes' columns of
    those patches, offsets re-based to the shard's P_l, the plain
    version's weight and const planes cut to the same patches. Kept on the
    global prep."""
    key = (nshards, d, torch.device(device))
    cache = p.__dict__.setdefault("shards", {})
    if key in cache:
        return cache[key]
    Pp = 10 // nshards
    SS = p.S * p.S
    P_l = Pp * SS
    cols = slice(d * P_l, (d + 1) * P_l)
    pats = slice(d * Pp, (d + 1) * Pp)
    dev = torch.device(device)
    q = copy.copy(p)
    q.npatch, q.P, q.device = Pp, P_l, dev
    put = lambda t: t.to(dev).contiguous()
    q.offs = put(torch.as_tensor(_rebase(host(p.offs)[:, cols], p.P, P_l)))
    q.wts = put(p.wts[:, cols])
    q.cpl = put(p.cpl[:, cols])
    q.entries = {name: [(td, ts, da, db, put(w[pats]))
                        for (td, ts, da, db, w) in ents]
                 for name, ents in p.entries.items()}
    q.consts = {k: (v if isinstance(v, float) else put(v[:, pats]))
                for k, v in p.consts.items()}
    # the maps of the global frames do not apply to a shard's
    for f in ("fills", "outputs", "persist", "sub_mesh", "depth_row"):
        setattr(q, f, None)
    cache[key] = q
    return q


def _trim(plan: PatchShardPlan, devices):
    """Each shard's lists cut to their real entries, as long tensors on its
    device: {grp: dict(refill=(pos, src), rings=[(dd, send, recv)],
    fix=(pos, row), zero=pos)} a shard."""
    N = plan.N
    out = []
    for d, dev in enumerate(devices):
        lt = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.long, device=dev)
        per = {}
        for grp, g in plan.groups.items():
            oob = g["size_l"]
            ok = g["refill_pos"][d] != oob
            rings = []
            for dd, send, recv in g["rings"]:
                ok_r = recv[d] != oob
                ok_s = recv[(d + dd) % N] != oob    # what d sends, to d+dd
                rings.append((dd, lt(send[d][:ok_s.sum()]),
                              lt(recv[d][ok_r])))
            okf = g["fix_pos"][d] != oob
            okz = g["zero_pos"][d] != oob
            per[grp] = dict(refill=(lt(g["refill_pos"][d][ok]),
                                    lt(g["refill_src"][d][ok])),
                            rings=rings,
                            fix=(lt(g["fix_pos"][d][okf]),
                                 lt(g["fix_row"][d][okf])),
                            zero=lt(g["zero_pos"][d][okz]))
        per["sub_cell"] = (lt(plan.sub_cell_src_l[d][plan.sub_cell_own[d]]),
                           lt(np.flatnonzero(plan.sub_cell_own[d])))
        per["sub_edge"] = (lt(plan.sub_edge_src_l[d][plan.sub_edge_own[d]]),
                           lt(np.flatnonzero(plan.sub_edge_own[d])))
        out.append(per)
    return out


def _refresh_sharded(views, lists, grp, fix_rows):
    """The sharded counterpart of the framed-step refresh of one class,
    in place on each shard's (K, T P_l) view: local refill, the copies
    between shards by distance (every sender packs before any receiver
    unpacks), the fix scatter, the hole re-zero."""
    N = len(views)
    for d in range(N):
        pos, src = lists[d][grp]["refill"]
        views[d][:, pos] = views[d][:, src]
    for i in range(len(lists[0][grp]["rings"])):
        dd = lists[0][grp]["rings"][i][0]
        sent = [views[d][:, lists[d][grp]["rings"][i][1]] for d in range(N)]
        for d in range(N):
            recv = lists[d][grp]["rings"][i][2]
            views[d][:, recv] = sent[(d - dd) % N].to(views[d].device,
                                                      non_blocking=True)
    for d in range(N):
        pos, row = lists[d][grp]["fix"]
        if pos.numel():
            views[d][:, pos] = fix_rows[views[d].device][row].T
        z = lists[d][grp]["zero"]
        if z.numel():
            views[d][:, z] = 0.0


def _sub_state(p_dev, frames, lists, fix):
    """The pole submesh's state on one device: each shard's rows read from
    its own frames, the carried fix rows over them."""
    L = frames[0].shape[1] - 4
    K = frames[0].shape[0]
    dev = fix["h"].device
    nsc, nse = p_dev.sub_cells.numel(), p_dev.sub_edges.numel()
    h = frames[0].new_zeros((nsc, K), device=dev)
    u = frames[0].new_zeros((nse, K), device=dev)
    tr = frames[0].new_zeros((L, nsc, K), device=dev)
    for d, fr in enumerate(frames):
        src_c, row_c = lists[d]["sub_cell"]
        src_e, row_e = lists[d]["sub_edge"]
        h[row_c.to(dev)] = pm._cls_view(fr, 0, 1)[:, src_c].T.to(dev)
        u[row_e.to(dev)] = pm._cls_view(fr, 1, 3)[:, src_e].T.to(dev)
        for l in range(L):
            tr[l, row_c.to(dev)] = pm._cls_view(fr, 4 + l, 1)[:, src_c].T.to(
                dev)
    h[p_dev.fix_cells_local] = fix["h"]
    u[p_dev.fix_edges_local] = fix["u"]
    tr[:, p_dev.fix_cells_local] = fix["tr"]
    return ModelState(h=h, u=u, tracers=tr)


def supported(mesh, cfg, nshards: int) -> bool:
    """The sharded patch path's configurations: a patch mesh, nshards in
    {2, 5, 10}, and the FB step's fused configurations on the per-step API
    (`patch_megastep.supported`: center or upwind fluxes, wind, drag, PCR
    vertical mixing; no FCT)."""
    return (nshards in NSHARDS and getattr(mesh, "patch_info", None)
            is not None and pm.supported(mesh, cfg))


def make_patch_sharded_run(mesh, cfg: ModelConfig, nshards: int,
                           devices=None) -> Callable:
    """run(state, t0, dt, nsteps, wind_stress=None) -> state over
    `nshards` shards, each on its device (`devices`, default
    sharded.default_devices).

    The frames carry stays sharded across the nsteps steps (the analogue of
    the reference keeping halos device-resident between MPI exchanges); the
    flat state is split into frames at the start and read back at the
    end."""
    _check_nshards(nshards)
    if not supported(mesh, cfg, nshards):
        raise ValueError("the sharded patch path takes a patch mesh and the "
                         "FB step's fused configurations "
                         "(patch_megastep.supported)")
    devices = _devices(devices, nshards)
    N = nshards
    _preload(devices)

    def run(state: ModelState, t0, dt, nsteps: int,
            wind_stress=None) -> ModelState:
        from omega_tpu_torch.stepping.steppers import forward_backward_step
        dtype = state.h.dtype
        plan = build_patch_shard(mesh, N, dtype)
        lists = _trim(plan, devices)
        uniq = list(dict.fromkeys(devices))
        p_dev = {dev: pm.prep(mesh, dtype, dev) for dev in uniq}
        preps = [shard_prep(p_dev[dev], N, d, dev)
                 for d, dev in enumerate(devices)]
        frames_g, fix0 = pm.stack_frames(mesh, cfg, state)
        P_l = preps[0].P
        frames = [frames_g[..., d * P_l:(d + 1) * P_l].to(dev).contiguous()
                  for d, dev in enumerate(devices)]
        fix = {dev: {k: v.to(dev) for k, v in fix0.items()} for dev in uniq}
        wb = pm.make_wind(mesh, cfg, wind_stress, dtype)
        winds = [None] * N
        wsub = {dev: None for dev in uniq}
        if wb is not None:
            winds = [(wb[0][:, d * P_l:(d + 1) * P_l].to(dev).contiguous(),
                      None) for d, dev in enumerate(devices)]
            wsub = {dev: tuple(w.to(dev) for w in wb[1]) for dev in uniq}
        nxt = [torch.empty_like(f) for f in frames]
        work = [pm.new_work(f) for f in frames]
        coef = [pm.new_coef(f, cfg) for f in frames]
        t = t0
        L = frames[0].shape[1] - 4
        for _ in range(nsteps):
            outs = [pm.step(preps[d], cfg, frames[d], dt, out=nxt[d],
                            work=work[d], wind=winds[d], coef=coef[d])
                    for d in range(N)]
            # the pole-fix substep, once a device, from the carry's frames
            nfix = {}
            for dev in uniq:
                p = p_dev[dev]
                sub = forward_backward_step(
                    p.sub_mesh, cfg, _sub_state(p, frames, lists, fix[dev]),
                    t, dt, wind_stress=wsub[dev])
                nfix[dev] = pm._fix_rows(p, *sub)
            rows = lambda k: {dev: v[k] for dev, v in nfix.items()}
            _refresh_sharded([pm._cls_view(o, 0, 1) for o in outs], lists,
                             "cell", rows("h"))
            _refresh_sharded([pm._cls_view(o, 1, 3) for o in outs], lists,
                             "edge", rows("u"))
            for l in range(L):
                _refresh_sharded([pm._cls_view(o, 4 + l, 1) for o in outs],
                                 lists, "cell",
                                 {dev: v["tr"][l] for dev, v in nfix.items()})
            nxt, frames = frames, outs
            fix = nfix
            t = t + dt
        dev0 = devices[0]
        full = torch.cat([f.to(dev0) for f in frames], -1)
        return pm.unstack_frames(mesh, cfg, (full, fix[dev0]), type(state))

    return run
