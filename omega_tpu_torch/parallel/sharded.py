"""Sharded execution of the dycore by one controller over a list of shards.

Replaces the reference's MPI rank model (base/MachEnv.h:36) and the JAX
package's shard_map over a device mesh with a single controller: one
Python process holds every shard's local mesh and state in a list, each on
its shard's device (`default_devices`: the visible CUDA devices in turn, so
on one card every shard sits on cuda:0 and runs with real exchanges, never
folded into one unsharded run). The steppers run unchanged on each local
mesh; their `halo` callback is the exchange of parallel/halo.py (the
updateTimeLevels exchange of ocn/OceanState.cpp:333-365, RK4's mid-step
refresh, the split stepper's per-subcycle refreshes).

A stepper may call its halo anywhere inside a step, so the shards' steps run
in lockstep (`Lockstep`): one thread a shard, each running the stepper on
its own shard, taking turns from one exchange to the next; the last to
arrive at an exchange runs the list-level exchange for all of them.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np
import torch

from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.infra.logging import get_logger
from omega_tpu_torch.parallel import halo as halo_mod
from omega_tpu_torch.parallel.decomp import ShardedMesh

_LOGGED: set = set()


def default_devices(nshards: int) -> List[torch.device]:
    """`nshards` devices, cycling over the visible CUDA devices (the
    counterpart of the JAX package's default_device_mesh). Raises without
    a CUDA device: a CPU run names its devices (["cpu"] * nshards)."""
    if not torch.cuda.is_available():
        raise RuntimeError("sharded runs need a CUDA device; none is "
                           "available (pass devices=['cpu'] * nshards)")
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", s % n) for s in range(nshards)]
    key = (nshards, n)
    if key not in _LOGGED:
        _LOGGED.add(key)
        get_logger().info("shards: %d on %s", nshards,
                          ", ".join(str(d) for d in devs))
    return devs


def _devices(devices, nshards):
    devs = default_devices(nshards) if devices is None else \
        [torch.device(d) for d in devices]
    if len(devs) != nshards:
        raise ValueError(f"{len(devs)} devices for {nshards} shards")
    return devs


def _to_shards(arr, devices, dtype=torch.long):
    """A host (S, ...) array as one tensor per shard on its device."""
    return [torch.as_tensor(np.ascontiguousarray(arr[s])).to(
        device=d, dtype=dtype) for s, d in enumerate(devices)]


# ----------------------------------------------------------------------
# lockstep execution

class _Abort(Exception):
    """Another shard failed; this one stops at its next meeting."""


class Lockstep:
    """Runs one function a shard, each on its own thread, the shards taking
    turns: shard 0 runs until its next exchange (`meet`), then shard 1, and
    so on; the last to arrive runs the list-level exchange of every shard's
    value, and the shards resume in order, each with its own entry. One
    shard runs at a time, so the host work is the same sequence of
    operations a loop over the shards would issue (on the card, one
    stream's launches), and nothing is shared between concurrent threads.
    Every shard must meet the same number of times with the same kind of
    exchange, as every rank of an MPI job must post the same exchanges."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.n = len(self.devices)
        self._pool = ThreadPoolExecutor(max_workers=self.n,
                                        thread_name_prefix="shard")
        self._turn = [threading.Semaphore(0) for _ in range(self.n)]
        self._vals = [None] * self.n
        self._out = None
        self._abort = False

    def _wait(self, s):
        self._turn[s].acquire()
        if self._abort:
            raise _Abort()

    def meet(self, s: int, value, fn: Callable):
        """Shard s hands `value`; when every shard has, fn(values) runs once
        and shard s gets fn(values)[s]."""
        self._vals[s] = value
        if s + 1 < self.n:
            self._turn[s + 1].release()
            self._wait(s)
        else:
            self._out = fn(list(self._vals))
            self._turn[0].release()
            if self.n > 1:
                self._wait(s)
        return self._out[s]

    def _worker(self, fn, s):
        try:
            self._wait(s)
            dev = self.devices[s]
            ctx = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                out = fn(s)
            if s + 1 < self.n:
                self._turn[s + 1].release()
            return out
        except BaseException:
            self._abort = True
            for t in self._turn:
                t.release()
            raise

    def run(self, fn: Callable) -> list:
        """[fn(0), ..., fn(n-1)], each on its own thread, in turns."""
        self._abort = False
        self._turn = [threading.Semaphore(0) for _ in range(self.n)]
        futs = [self._pool.submit(self._worker, fn, s) for s in range(self.n)]
        self._turn[0].release()
        errs = [f.exception() for f in futs]
        real = [e for e in errs if e is not None
                and not isinstance(e, _Abort)]
        if real:
            raise real[0]
        return [f.result() for f in futs]


# ----------------------------------------------------------------------
# state scatter / gather

def shard_state(smesh: ShardedMesh, state: ModelState,
                devices=None) -> List[ModelState]:
    """Scatter a global state into per-shard local states, each on its
    shard's device (`devices`, default the sharded mesh's own)."""
    devices = list(devices or smesh.devices)
    out = []
    for s, dev in enumerate(devices):
        c = torch.as_tensor(np.maximum(smesh.cell_local_to_global[s], 0),
                            device=state.h.device, dtype=torch.long)
        e = torch.as_tensor(np.maximum(smesh.edge_local_to_global[s], 0),
                            device=state.h.device, dtype=torch.long)
        out.append(ModelState(h=state.h[c].to(dev), u=state.u[e].to(dev),
                              tracers=state.tracers[:, c].to(dev)))
    return out


def gather_state(smesh: ShardedMesh, states: Sequence[ModelState],
                 ncells: int, nedges: int) -> ModelState:
    """Reassemble the global state from the owned rows of every shard, on
    the first shard's device."""
    st0 = states[0]
    dev = st0.h.device
    K, L = st0.h.shape[-1], st0.tracers.shape[0]
    h = st0.h.new_zeros((ncells, K))
    u = st0.u.new_zeros((nedges, K))
    tr = st0.tracers.new_zeros((L, ncells, K))
    for s, st in enumerate(states):
        cm = smesh.owned_cell_mask[s] > 0
        em = smesh.owned_edge_mask[s] > 0
        cl = torch.as_tensor(np.flatnonzero(cm), device=st.h.device)
        el = torch.as_tensor(np.flatnonzero(em), device=st.h.device)
        cg = torch.as_tensor(smesh.cell_local_to_global[s][cm], device=dev,
                             dtype=torch.long)
        eg = torch.as_tensor(smesh.edge_local_to_global[s][em], device=dev,
                             dtype=torch.long)
        h[cg] = st.h[cl].to(dev)
        u[eg] = st.u[el].to(dev)
        tr[:, cg] = st.tracers[:, cl].to(dev)
    return ModelState(h=h, u=u, tracers=tr)


# ----------------------------------------------------------------------
# exchange lists

def build_permute_lists(smesh: ShardedMesh, kind: str):
    """Per-neighbor-distance exchange lists (host side; the analogue of
    Halo::generateExchangeLists, base/Halo.cpp:455-600).

    kind: 'cell' | 'edge' | 'vertex'. Returns a list of
      (d, send_idx (S, Nd), recv_dst (S, Nd))
    — for rank distance d, shard s sends rows send_idx[s] to (s+d) % S and
    scatters what it receives from (s-d) % S into recv_dst[s]. The send
    order is exactly the receiver's recv order, so no slot indirection is
    needed on the wire. Padded entries use each shard's dummy row."""
    S = smesh.nshards
    send_glob, rsrc, rslot, rdst = smesh.lists(kind)
    dummy_row = getattr(smesh, f"{kind}_local_to_global").shape[1] - 1

    # distance -> per-src (send rows, per-dst recv rows)
    per_d: dict = {}
    for dst in range(S):
        # real (non-dummy-targeting) halo entries of this shard
        real = rdst[dst] != dummy_row
        srcs = rsrc[dst][real]
        slots = rslot[dst][real]
        dsts = rdst[dst][real]
        for src in np.unique(srcs):
            d = int((dst - src) % S)
            if d == 0:
                continue
            sel = srcs == src
            pd = per_d.setdefault(d, {})
            # receiver order defines the wire order
            pd[int(src)] = (send_glob[src][slots[sel]], dsts[sel])
    out = []
    for d in sorted(per_d):
        pd = per_d[d]
        nd = max(len(v[0]) for v in pd.values())
        send = np.full((S, nd), dummy_row, np.int32)
        recv = np.full((S, nd), dummy_row, np.int32)
        for src, (s_rows, _) in pd.items():
            send[src, :len(s_rows)] = s_rows
        for src, (_, r_rows) in pd.items():
            recv[(src + d) % S, :len(r_rows)] = r_rows
        out.append((d, send, recv))
    return out


class ShardLists:
    """The exchange lists of a sharded mesh as long tensors on each shard's
    device: `gather[space]` (send, src shard, src slot, dst lists) and, for
    the permute form, `permute[space]` ([(d, send, recv)], one tensor a
    shard)."""

    def __init__(self, smesh: ShardedMesh, devices, permute: bool = True,
                 spaces=("cell", "edge", "vertex")):
        self.gather = {sp: tuple(_to_shards(a, devices)
                                 for a in smesh.lists(sp))
                       for sp in spaces}
        self.permute = None
        if permute:
            self.permute = {sp: [(d, _to_shards(s, devices),
                                  _to_shards(r, devices))
                                 for d, s, r in build_permute_lists(smesh, sp)]
                            for sp in spaces}


def exchange_any(lists: ShardLists, xs, space: str, permute: bool = True):
    """General halo refresh of ANY per-shard arrays on any of the three
    index spaces — the Halo::exchangeFullArrayHalo analogue
    (base/Halo.h:45, 769): (..., N_local, K) arrays on 'cell' | 'edge' |
    'vertex'. The step loop never needs the vertex space (aux vars
    recompute locally), but diagnostics that publish vertex fields
    (vorticity snapshots) do."""
    if permute and lists.permute is not None:
        return halo_mod.exchange_permute(xs, lists.permute[space])
    return halo_mod.exchange(xs, *lists.gather[space])


def make_halo_fn(lists: ShardLists, permute: bool = True) -> Callable:
    """The list-level halo exchange of a ModelState a shard: halo(states)
    -> states, with `.cell` / `.edge` for one array a shard. With the
    permute lists, h and the tracers ride one (1+L, Cl, K) bundle, halving
    the rounds; otherwise the all-gather form exchanges each field."""
    def cell_ex(xs):
        """Halo-refresh one cell array (..., Cl, K) a shard."""
        return exchange_any(lists, xs, "cell", permute)

    def edge_ex(xs):
        """Halo-refresh one edge array (..., El, K) a shard."""
        return exchange_any(lists, xs, "edge", permute)

    def halo_fn(states):
        if permute and lists.permute is not None:
            bundles = cell_ex([torch.cat([st.h[None], st.tracers], 0)
                               for st in states])
            us = edge_ex([st.u for st in states])
            return [ModelState(h=b[0], u=u, tracers=b[1:])
                    for b, u in zip(bundles, us)]
        hs = cell_ex([st.h for st in states])
        us = edge_ex([st.u for st in states])
        trs = cell_ex([st.tracers for st in states])
        return [ModelState(h=h, u=u, tracers=t)
                for h, u, t in zip(hs, us, trs)]

    halo_fn.cell = cell_ex
    halo_fn.edge = edge_ex
    return halo_fn


class _SideExchange:
    """A list-level exchange issued on a side stream of each shard's card:
    each shard hands (array, event recorded on its stream); the copies wait
    on those events, run on the side streams, and each shard gets (result,
    event recorded after the copies), which its stream waits on before it
    reads the result. On CPU arrays the exchange runs in place of this."""

    def __init__(self, fn):
        self.fn = fn
        self.streams = {}

    def _stream(self, dev):
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(device=dev)
        return self.streams[dev]

    def __call__(self, vals):
        xs = [x for x, _ in vals]
        for x, ev in vals:
            side = self._stream(x.device)
            side.wait_event(ev)
            x.record_stream(side)
        with contextlib.ExitStack() as stack:
            for dev in {x.device for x in xs}:
                stack.enter_context(torch.cuda.stream(self._stream(dev)))
            outs = self.fn(xs)
        done = {}
        for dev in {x.device for x in xs}:
            done[dev] = torch.cuda.Event()
            done[dev].record(self._stream(dev))
        return [(o, done[x.device]) for o, x in zip(outs, xs)]


def shard_halos(group: Lockstep, lhalo: Callable) -> list:
    """One halo callback a shard over a list-level halo `lhalo`
    (`make_halo_fn`, or the structured decomposition's block exchange): the
    full-state exchange, `.cell` / `.edge` for one array, and
    `.cell_async`, which starts a cell exchange and returns the function
    that yields its result (on CUDA the copies run on a side stream while
    the shard's stream goes on; forward_backward_step overlaps them with
    its momentum stage)."""
    side = _SideExchange(lhalo.cell)

    def make(s):
        def halo_s(st):
            return group.meet(s, st, lhalo)

        def cell_async(x):
            if not x.is_cuda:
                out = group.meet(s, x, lhalo.cell)
                return lambda: out
            ev = torch.cuda.Event()
            ev.record()
            out, done = group.meet(s, (x, ev), side)

            def fetch():
                cur = torch.cuda.current_stream()
                cur.wait_event(done)
                out.record_stream(cur)
                return out
            return fetch

        halo_s.cell = lambda x: group.meet(s, x, lhalo.cell)
        halo_s.edge = lambda x: group.meet(s, x, lhalo.edge)
        halo_s.cell_async = cell_async
        return halo_s

    return [make(s) for s in range(group.n)]


def _preload(devices):
    """Build the CUDA library on the calling thread before the shard
    threads may need it (one build, not one a thread)."""
    if any(d.type == "cuda" for d in devices):
        from omega_tpu_torch.ops import _build
        _build.load()


# ----------------------------------------------------------------------
# the sharded step

def make_sharded_step(smesh: ShardedMesh, cfg: ModelConfig, stepper,
                      devices=None, halo_impl: str = "permute",
                      wind_stress=None, post_phase=None, dtype=None):
    """Build a sharded step: (list of per-shard ModelState, t, dt, wind)
    -> list of per-shard ModelState.

    The same stepper used on a single device runs on each local mesh, one
    thread a shard (`Lockstep`); its `halo` callback is the exchange over
    the shard list (halo_impl: 'permute' = one round a rank distance,
    'allgather' = every buffer to every shard).

    post_phase: optional (fn, aux) pair applied per shard AFTER the stepper
    (the driver's p-star redistribution phase): `aux` is a dict of host
    (S, ...) local-row arrays, and `fn(local_mesh, state, aux_local)` ->
    state. The phase is column-local with an edge radius of 1 (the
    2-cell-mean edge thickness), so halo rows out to width-1-less-than-the-
    exchange stay exact — the driver bumps Decomp.HaloWidth accordingly."""
    devices = _devices(devices if devices is not None else smesh.devices,
                       smesh.nshards)
    if smesh.devices is None or list(smesh.devices) != devices:
        smesh = smesh.to(devices, dtype)
    if halo_impl not in ("permute", "allgather"):
        raise ValueError(f"unknown halo_impl {halo_impl!r}")
    lists = ShardLists(smesh, devices, permute=halo_impl == "permute",
                       spaces=("cell", "edge"))
    lhalo = make_halo_fn(lists, permute=halo_impl == "permute")
    group = Lockstep(devices)
    halos = shard_halos(group, lhalo)
    c_l2g = np.maximum(smesh.cell_local_to_global, 0)
    phase_fn, phase_aux = post_phase if post_phase is not None \
        else (None, None)
    if phase_aux is not None:
        phase_aux = {k: _to_shards(v, devices, dtype or torch.float64)
                     for k, v in phase_aux.items()}
    _preload(devices)

    def scatter_wind(w):
        """(zonal, merid) global (C,) arrays -> per-shard local rows (for
        time-varying forcing updates between segments)."""
        out = []
        for s, dev in enumerate(devices):
            c = torch.as_tensor(c_l2g[s], device=w[0].device)
            out.append(tuple(x[c].to(dev) for x in w))
        return out

    default_wind = None if wind_stress is None else scatter_wind(wind_stress)

    def step(states, t, dt, wind=None):
        wind = default_wind if wind is None else wind

        def local(s):
            w = None if wind is None else wind[s]
            out = stepper(smesh.meshes[s], cfg, states[s], t, dt, halos[s],
                          wind_stress=w)
            if phase_fn is not None:
                out = phase_fn(smesh.meshes[s], out,
                               {k: v[s] for k, v in phase_aux.items()})
            return out

        return group.run(local)

    step.scatter_wind = scatter_wind
    step.smesh = smesh
    step.devices = devices
    return step


def dcn_device_mesh(nshards: int, devices) -> list:
    """The first `nshards` of `devices` ordered host-major for multi-host
    runs (process, slice, id; a device without those attributes counts as
    process 0, slice 0, its index). The model's single distributed axis is
    the horizontal mesh and the decompositions give contiguous spatial
    blocks, so exchanges are dominated by rank distance 1; ordering the
    devices host-major makes consecutive ranks co-located, so the
    distance-1 ring stays inside a host and crosses hosts only at the
    seams — the analogue of the reference's node-aware MPI rank
    placement."""
    def key(d):
        return (getattr(d, "process_index", 0),
                getattr(d, "slice_index", 0) or 0,
                getattr(d, "id", getattr(d, "index", 0) or 0))
    devs = sorted(devices, key=key)
    if len(devs) < nshards:
        raise ValueError(f"need {nshards} devices, have {len(devs)}")
    return devs[:nshards]


def comm_volume_by_link(smesh: ShardedMesh, host_of) -> dict:
    """Per-step halo traffic split by link type for a host assignment.

    host_of: (nshards,) host index of each shard (rank order). Returns row
    counts {'ici': n, 'dcn': n, 'per_dcn_pair': {(ha, hb): n}} summed over
    the cell and edge exchange lists ('ici' within a host, 'dcn' between
    hosts; rows = elements, multiply by K * itemsize * fields for bytes):
    the planner's check that a layout keeps the cross-host share small."""
    host_of = np.asarray(host_of)
    S = smesh.nshards
    out = {"ici": 0, "dcn": 0, "per_dcn_pair": {}}
    for kind in ("cell", "edge"):
        dummy_row = getattr(smesh, f"{kind}_local_to_global").shape[1] - 1
        for (d, send, recv) in build_permute_lists(smesh, kind):
            for src in range(S):
                dst = (src + d) % S
                # recv-side padding identifies dead slots exactly (real
                # sends can legitimately name the last local row)
                n = int((recv[dst] != dummy_row).sum())
                if n == 0:
                    continue
                if host_of[src] == host_of[dst]:
                    out["ici"] += n
                else:
                    out["dcn"] += n
                    key = (int(min(host_of[src], host_of[dst])),
                           int(max(host_of[src], host_of[dst])))
                    out["per_dcn_pair"][key] = \
                        out["per_dcn_pair"].get(key, 0) + n
    return out


def energetics_keys(L: int) -> list:
    base = ["volume", "kinetic_energy", "potential_energy",
            "potential_enstrophy"]
    for l in range(L):
        base += [f"tracer{l}_mass", f"tracer{l}_min", f"tracer{l}_max"]
    return sorted(base)


def sharded_sampler(meshes, cfg, own_c, own_v):
    """sample(states, ssh_ref=None) -> (row dict, ssh_ref) of the
    energetics over per-shard local meshes and owned masks (lists): each
    shard's owned-masked budget terms combined by the cross-shard
    reductions — no global state gather at sample boundaries
    (analysis.energetics_local)."""
    from omega_tpu_torch import analysis as ana

    def sample(states, ssh_ref=None):
        if ssh_ref is None:
            ssh_ref = float(ana.mean_ssh_local(meshes, cfg, states, own_c))
        row = ana.energetics_local(meshes, cfg, states, own_c, own_v,
                                   ssh_ref)
        row = {k: float(row[k]) for k in energetics_keys(
            states[0].tracers.shape[0])}
        # host-side add (analysis.energetics' order)
        row["total_energy"] = row["kinetic_energy"] + row["potential_energy"]
        return row, ssh_ref

    return sample


def make_sharded_energetics(smesh: ShardedMesh, cfg, devices=None,
                            dtype=None):
    """Sharded energetics sampler for the SFC decomposition: each shard
    computes its owned-masked budget terms on its local mesh and the
    cross-shard reductions combine them. Returns sample(states,
    ssh_ref=None) -> (row dict, ssh_ref); ssh_ref None computes the t=0
    area-mean ssh (also sharded)."""
    devices = _devices(devices if devices is not None else smesh.devices,
                       smesh.nshards)
    if smesh.devices is None or list(smesh.devices) != devices:
        smesh = smesh.to(devices, dtype)
    own_c = _to_shards(smesh.owned_cell_mask > 0, devices, torch.bool)
    own_v = _to_shards(smesh.owned_vertex_mask > 0, devices, torch.bool)
    return sharded_sampler(smesh.meshes, cfg, own_c, own_v)
