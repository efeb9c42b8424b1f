"""The barotropic subcycles of a split-explicit step on an unstructured mesh,
in gather form.

The split-explicit stepper's fast 2-D system (stepping/split.py) runs on the
flat (E, 1) / (C, 1) arrays: with the frozen forcing g_slow and the column
edge thickness het, each of the M forward-backward subcycles is

    ub  += dt_bt * (mask (-g grad(ssh) + f_e tang(ub) - r ub) + g_slow)
    ssh -= dt_bt * div(het ub)          (the NEW ub)
    acc += ub

and the call returns (ub_final, ssh_final, <ubar> = acc / M). On the
icosahedral sphere the reference runs it as a `lax.scan` of the composed
operators (omega_tpu/ops/patch_megastep.py:2205-2226); it is not a Pallas
kernel there, and the planar Pallas kernel (ops/barotropic_kernel.py) takes
structured meshes only.

Beside the kernel stands its plain PyTorch version, `subcycles_plain`: the
composed subcycle loop of stepping/split.py through the mesh's own operators
(on a patch mesh the patch stencils). A CPU array takes it; a CUDA array
launches csrc/bt_gather.cu or raises: all M subcycles in ONE cooperative
launch, one grid barrier per subcycle. The cells are cut into contiguous
groups (`groups`), a block a group where the card holds that many blocks;
a block evaluates the new ub on every edge its cells name (an edge two
groups share on both, bit-equal; its owner writes it) and then the new ssh
of its cells. The kernel reads the mesh's stored connectivity
(`cells_on_edge` and `dc_edge` for the gradient, `edges_on_edge` and
`weights_on_edge` for the tangential reconstruction, `edges_on_cell` and
`w_div_cell` for the divergence): padded slots point at element 0 with
weight 0, a coast edge of a carved mesh has edge_mask 0, and the dead seam
slots of a patch mesh have cells (0, 0), zero weights and edge_mask 0, so
they stay 0. Its view of the mesh (`mesh_view`: int32 connectivity, the
weights in the working type, the groups) is built once per mesh, type,
device and group count.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from omega_tpu_torch.ops import _build, trisk

# launches since the last reset (one per call)
launches = 0
# groups per SM where the mesh is small enough that a group holds at most
# MAX_GROUP_CELLS cells (more groups than the card holds blocks: each block
# walks several); threads per block: a thread a list slot, at most
# MAX_THREADS (kMaxThreads in csrc/bt_gather.cu)
GROUPS_PER_SM = 1
MAX_GROUP_CELLS = 1024
MAX_THREADS = 1024


def block_threads(max_list):
    """Threads per block for lists of at most `max_list` slots: one a slot,
    in whole warps, at most MAX_THREADS."""
    return min(MAX_THREADS, 32 * -(-int(max_list) // 32))


def enabled(x) -> bool:
    """The kernel serves arrays that live on a CUDA device."""
    return x.is_cuda


def fast(mesh, ub, ssh, gravity, bt_drag=0.0):
    """The fast barotropic operator, re-evaluated every subcycle: the SSH
    gradient, the barotropic Coriolis term through the tangential
    reconstruction and the optional linear drag, gated by the edge mask."""
    out = (-gravity * trisk.grad_edge(mesh, ssh)
           + trisk.col(mesh, "f_edge") * trisk.tangential_edge(mesh, ub))
    if bt_drag:
        out = out - bt_drag * ub
    return trisk.col(mesh, "edge_mask") * out


def subcycles_plain(mesh, ubar, ssh, g_slow, h_edge_tot, *, gravity, dt_bt,
                    n_subcycles, bt_drag=0.0, edge_ex=None, cell_ex=None):
    """The plain version: the composed subcycle loop of stepping/split.py
    (`edge_ex` / `cell_ex`: a sharded halo's per-array exchanges after each
    update). Returns (ub_final, ssh_final, ubar_avg)."""
    ub, ssh_s, acc = ubar, ssh, torch.zeros_like(ubar)
    for _ in range(n_subcycles):
        ub = ub + dt_bt * (fast(mesh, ub, ssh_s, gravity, bt_drag) + g_slow)
        if edge_ex is not None:
            ub = edge_ex(ub)
        ssh_s = ssh_s - dt_bt * trisk.div_cell(mesh, h_edge_tot * ub)
        if cell_ex is not None:
            ssh_s = cell_ex(ssh_s)
        acc = acc + ub
    return ub, ssh_s, acc / n_subcycles


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def groups(mesh, ngroups):
    """The cell groups of the kernel, host numpy int32: (cell_start,
    edge_start (ngroups + 1 each), edge_list, lslot (C, MC)). Group g holds
    the cells [cell_start[g], cell_start[g+1]) and the list
    edge_list[edge_start[g]:edge_start[g+1]] of every edge its cells' slots
    name (padded slots included: they name edge 0), sorted, and the edges
    no slot names (the dead seam) spread evenly over the groups; the
    lowest group that lists an edge owns it (e in its list, ~e in the
    others'). lslot[c, j] is the position of edges_on_cell[c, j] in the list
    of c's group. Refuses connectivity with an index out of range (a -1
    pad: the kernel reads the stored, clamped arrays)."""
    coe = _host(mesh.cells_on_edge).astype(np.int64)
    eoc = _host(mesh.edges_on_cell).astype(np.int64)
    eoe = _host(mesh.edges_on_edge).astype(np.int64)
    C, E = eoc.shape[0], coe.shape[0]
    for name, a, n in (("cells_on_edge", coe, C), ("edges_on_cell", eoc, E),
                       ("edges_on_edge", eoe, E)):
        if a.size and (a.min() < 0 or a.max() >= n):
            raise ValueError(f"{name} holds an index outside [0, {n})")
    ngroups = int(ngroups)
    if not 1 <= ngroups <= C:
        raise ValueError(f"ngroups must lie in [1, {C}], got {ngroups}")
    cell_start = np.arange(ngroups + 1, dtype=np.int64) * C // ngroups
    gid = np.repeat(np.arange(ngroups), np.diff(cell_start))
    named = np.zeros(E, bool)
    named[eoc.ravel()] = True
    seam = np.flatnonzero(~named)
    spread = np.arange(seam.size) * ngroups // max(seam.size, 1)
    keys = np.unique(np.concatenate([(gid[:, None] * E + eoc).ravel(),
                                     spread * E + seam]))
    kg, ke = keys // E, keys % E
    edge_start = np.searchsorted(kg, np.arange(ngroups + 1))
    _, first = np.unique(ke, return_index=True)   # keys run by group
    owner = kg[first]
    edge_list = np.where(kg == owner[ke], ke, ~ke)
    lslot = (np.searchsorted(keys, gid[:, None] * E + eoc)
             - edge_start[gid][:, None])
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return i32(cell_start), i32(edge_start), i32(edge_list), i32(lslot)


def n_groups(mesh, device):
    """The group count on `device`: GROUPS_PER_SM a streaming
    multiprocessor, more where a group would hold more than
    MAX_GROUP_CELLS cells, at most one a cell."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    C = mesh.ncells
    return max(1, min(C, max(sms * GROUPS_PER_SM, -(-C // MAX_GROUP_CELLS))))


_VIEWS: dict = {}


def mesh_view(mesh, dtype, device, ngroups=None):
    """The kernel's view of the mesh, built once per (mesh, dtype, device,
    ngroups) and kept while the mesh lives: int32 connectivity, the weights
    in the working type, contiguous on `device`, and the groups (`groups`;
    ngroups None: `n_groups`), with ME, MC, the longest list, the most
    cells of a group and the arrays' pointers in the C call's order."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    hit = _VIEWS.get(id(mesh))
    if hit is None or hit[0]() is not mesh:
        hit = _VIEWS[id(mesh)] = (weakref.ref(
            mesh, lambda _, k=id(mesh): _VIEWS.pop(k, None)), {})
    key = (dtype, device, ngroups)
    if key not in hit[1]:
        if ngroups is None:
            ngroups = n_groups(mesh, device)
        i32 = lambda a: torch.as_tensor(a).to(device=device,
                                              dtype=torch.int32).contiguous()
        fl = lambda a: torch.as_tensor(a).to(device=device,
                                             dtype=dtype).contiguous()
        cs, es, el, ls = groups(mesh, ngroups)
        hit[1][key] = dict(
            coe=i32(mesh.cells_on_edge), dc=fl(mesh.dc_edge),
            eoe=i32(mesh.edges_on_edge), woe=fl(mesh.weights_on_edge),
            wdiv=fl(mesh.w_div_cell), f_e=fl(mesh.f_edge),
            mask=fl(mesh.edge_mask), cell_start=i32(cs), edge_start=i32(es),
            edge_list=i32(el), lslot=i32(ls),
            ME=int(mesh.edges_on_edge.shape[1]),
            MC=int(mesh.edges_on_cell.shape[1]), ngroups=int(ngroups),
            max_list=int(np.diff(es).max()),
            max_cells=int(np.diff(cs).max()))
        hit[1][key]["ptrs"] = [hit[1][key][k].data_ptr() for k in _MESH_PTRS]
    return hit[1][key]


# the mesh arrays of a call's pointer list, in the C entry's order
_MESH_PTRS = ("coe", "dc", "eoe", "woe", "wdiv", "f_e", "mask",
              "cell_start", "edge_start", "edge_list", "lslot")


def call_args(view, ins, out, work, *, gravity, dt_bt, n_subcycles,
              bt_drag=0.0, threads=None, grid=0):
    """(ptrs, consts, ints) of one C call: `ins` = (ubar, ssh, g_slow,
    het), `out` = (ub_out, ssh_out, avg), `work` = (ub_work, ssh_work);
    `threads` None: block_threads of the view's longest list."""
    threads = block_threads(view["max_list"]) if threads is None else threads
    arrays = (*ins, out[0], work[0], out[1], work[1], out[2])
    ptrs = np.array([a.data_ptr() for a in arrays] + view["ptrs"], np.uint64)
    consts = np.array([float(dt_bt), -float(gravity), float(bt_drag)],
                      np.float64)
    ints = np.array([view["ME"], view["MC"], int(n_subcycles),
                     view["ngroups"], view["max_list"], view["max_cells"],
                     threads, grid], np.int32)
    return ptrs, consts, ints


def new_buffers(ubar, ssh):
    """(out, work) for `bt_subcycles`: ((ub, ssh, avg), (ub, ssh)) like
    ubar (E, 1) and ssh (C, 1)."""
    e = lambda: torch.empty_like(ubar, memory_format=torch.contiguous_format)
    c = lambda: torch.empty_like(ssh, memory_format=torch.contiguous_format)
    return (e(), c(), e()), (e(), c())


def attrs(dtype, mesh=None, device=None):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the kernel in `dtype`, the blocks an SM holds and
    the co-resident grid (that times the SMs), for the resident form (a
    block a group) and the streamed one, at a list of 1024 slots or, with
    `mesh`, at the longest list of a call on it (its threads and shared
    memory), with that call's groups, list, threads, form and grid."""
    lib = _build.load()
    device = torch.device("cuda") if device is None else device
    view = None if mesh is None else mesh_view(mesh, dtype, device)
    max_list = 1024 if view is None else view["max_list"]
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    out = {}
    for name, resident in (("resident", 1), ("streamed", 0)):
        got = np.zeros(5, np.int32)
        _build.check(getattr(lib, f"omega_bt_gather_attrs_{suffix}")(
            resident, block_threads(max_list), max_list, got.ctypes.data),
            "cudaFuncGetAttributes")
        out[name] = dict(zip(("num_regs", "local_bytes", "shared_bytes",
                              "blocks_per_sm"), map(int, got[:4])),
                         co_resident_grid=int(got[3] * got[4]))
    if view is not None:
        n = view["ngroups"]
        form = ("resident" if n <= out["resident"]["co_resident_grid"]
                else "streamed")
        out["call"] = dict(groups=n, max_list=max_list,
                           threads=block_threads(max_list), form=form,
                           grid=min(n, out[form]["co_resident_grid"]))
    return out


def bt_subcycles(mesh, ubar, ssh, g_slow, h_edge_tot, *, gravity, dt_bt,
                 n_subcycles, bt_drag=0.0, out=None, work=None):
    """All M barotropic subcycles: ubar / g_slow / h_edge_tot (E, 1), ssh
    (C, 1). Returns (ub_final (E, 1), ssh_final (C, 1), ubar_avg (E, 1)),
    into `out` where given, with `work` the second ub and ssh buffers
    (`new_buffers`). For CUDA arrays one cooperative launch of
    csrc/bt_gather.cu on PyTorch's current stream runs all M subcycles; for
    CPU arrays the plain version runs. dt_bt, g and r are rounded to the
    working type once."""
    global launches
    if not ubar.is_cuda:
        got = subcycles_plain(mesh, ubar, ssh, g_slow, h_edge_tot,
                              gravity=gravity, dt_bt=dt_bt,
                              n_subcycles=n_subcycles, bt_drag=bt_drag)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return out
    E, C = mesh.nedges, mesh.ncells
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(ubar.dtype)
    if suffix is None:
        raise TypeError(f"the subcycle kernel takes float32/float64, not "
                        f"{ubar.dtype}")
    for a, n, name in ((ubar, E, "ubar"), (ssh, C, "ssh"),
                       (g_slow, E, "g_slow"), (h_edge_tot, E, "h_edge_tot")):
        if (tuple(a.shape) != (n, 1) or a.dtype != ubar.dtype
                or a.device != ubar.device):
            raise ValueError(f"`{name}` must be a ({n}, 1) array of ubar's "
                             "type and device")
    M = int(n_subcycles)
    if M < 1:
        raise ValueError("n_subcycles must be at least 1")
    if out is None or work is None:
        o, w = new_buffers(ubar, ssh)
        out = o if out is None else out
        work = w if work is None else work
    for a, n, name in ((out[0], E, "out[0]"), (out[1], C, "out[1]"),
                       (out[2], E, "out[2]"), (work[0], E, "work[0]"),
                       (work[1], C, "work[1]")):
        if (tuple(a.shape) != (n, 1) or a.dtype != ubar.dtype
                or a.device != ubar.device or not a.is_contiguous()):
            raise ValueError(f"`{name}` must be a contiguous ({n}, 1) array "
                             "of ubar's type and device")
    view = mesh_view(mesh, ubar.dtype, ubar.device)
    ins = tuple(a.contiguous() for a in (ubar, ssh, g_slow, h_edge_tot))
    ptrs, consts, ints = call_args(view, ins, out, work, gravity=gravity,
                                   dt_bt=dt_bt, n_subcycles=M,
                                   bt_drag=bt_drag)
    lib = _build.load()
    with torch.cuda.device(ubar.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_bt_gather_{suffix}")(
            ptrs.ctypes.data, consts.ctypes.data, ints.ctypes.data, stream)
    _build.check(code, "sphere barotropic subcycle launch")
    launches += 1
    return tuple(out)
