"""All barotropic subcycles of a split-explicit step in one call.

Counterpart of omega_tpu/ops/barotropic_kernel.py. The barotropic system of
stepping/split.py is 2-D: (ubar, ssh) plus the frozen forcing g_slow and the
column edge thickness het are 10 planes of (ny, nx). Each of the M
forward-backward subcycles is

    ub  += dt_bt * (-g/dc cdiff(ssh) + f_e tang(ub) - r ub + g_slow)
    ssh -= dt_bt * div(het ub)
    acc += ub

and the call returns (ub_final, ssh_final, <ubar> = acc / M).

The TPU kernel keeps the whole domain (2.6 MB at 256 x 256) resident in
VMEM for all M subcycles. The CUDA kernel (csrc/barotropic.cu) runs all M
subcycles in ONE cooperative launch whose blocks meet at a grid-wide
barrier between subcycles: a block owns a 16 x 32 tile (megastep.HEX_TILE)
with the ring of ONE subcycle (`ring`, probed from the chain below: (2, 2)
on the hex mesh) on the compiled slab geometry and entry pattern of
csrc/hex_slab.cuh, loads its slab of (ub, ssh) from one of two buffers,
evaluates ub_new on the slab, then ssh_new and ub_new at its owned points
into the other buffer (the planes stay in the 50 MB L2). With a block per
tile the frozen slab is staged once and the accumulator stays in registers;
a mesh with more tiles than the card holds blocks has each block walk
several. Nothing is recomputed across subcycles, so the result is exact
for any M.

Beside the kernel stands its plain PyTorch version, `bt_plain`, the same
subcycles on the whole periodic grid or tile by tile (`tile=(by, bx)`) as the
kernel cuts its slabs. A CPU array takes it; a CUDA array launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.ops import _build, megastep, structured
from omega_tpu_torch.ops.structured import apply_grid

# launches of the subcycle kernel since the last reset (one per call)
launches = 0

# slab arrays of the subcycle kernel (kSlots in csrc/barotropic.cu): ub x3,
# ssh, ub_new x3, het * ub_new x3, and the frozen g_slow x3, het x3
SLOTS = 16
_CONSTS = ("dt_bt", "ggrad", "f_e", "r")


def enabled(x) -> bool:
    """The kernel serves arrays that live on a CUDA device."""
    return x.is_cuda


def supported(mesh) -> bool:
    """Structured f-plane mesh with uniform geometry: uniform dc_edge and
    f_edge, edge_mask 1, and the shift tables and entry pattern the kernel
    is compiled for (megastep.hex_pattern_fits)."""
    if not structured.enabled(mesh):
        return False
    if any(structured.uniform_scalar(mesh, a) is None
           for a in ("dc_edge", "f_edge", "edge_mask")):
        return False
    if structured.uniform_scalar(mesh, "edge_mask") != 1.0:
        return False
    return megastep.tables_fit(mesh) and megastep.hex_pattern_fits(mesh)


def _subcycle(vols, p, even, tabs, c, pk):
    """One forward-backward subcycle, the JAX kernel's `_kernel` body, on
    the planes (ub x3, ssh, g_slow x3, het x3): (ub_new x3, ssh_new)."""
    ap = lambda name, vals, pd: apply_grid(tabs[name], vals, even, pd)
    ub, ssh, gsl, het = [p[0], p[1], p[2]], p[3], p[4:7], p[7:10]
    gssh = ap("cdiff", [ssh], 3)
    tg = ap("tang", ub, 3)
    ub = [ub[i] + c["dt_bt"] * (c["ggrad"] * gssh[i] + c["f_e"] * tg[i]
                                - c["r"] * ub[i] + gsl[i])
          for i in range(3)]
    dssh = ap("div", [het[i] * ub[i] for i in range(3)], 1)[0]
    return torch.stack(ub + [ssh - c["dt_bt"] * dssh])


def _tabs(mesh):
    return {n: structured.cached_table(mesh, n) for n in megastep.TABLE_NAMES}


def _consts(mesh, gravity, dt_bt, bt_drag):
    """The subcycle's constants: ggrad = -g * (1 / dc) folded in float64,
    as the JAX kernel folds -g * inv_dc."""
    us = lambda a: structured.uniform_scalar(mesh, a)
    return dict(dt_bt=float(dt_bt),
                ggrad=-float(gravity) * (1.0 / us("dc_edge")),
                f_e=us("f_edge"), r=float(bt_drag))


def ring(tabs):
    """The ring of one subcycle (megastep.probe_ring of `_subcycle`)."""
    key = (tuple((n, tuple(tabs[n])) for n in megastep.TABLE_NAMES), "bt")
    if key not in megastep._RADIUS_CACHE:
        megastep._RADIUS_CACHE[key] = megastep.probe_ring(
            _subcycle, tabs, dict.fromkeys(_CONSTS, 1.0), (), 10)
    return megastep._RADIUS_CACHE[key]


def bt_plain(mesh, stack, *, gravity, dt_bt, n_subcycles, bt_drag=0.0,
             tile=None):
    """The plain PyTorch version of the kernel: M subcycles of the stacked
    planes (ubar x3, ssh, g_slow x3, het x3), (10, ny, nx), on the whole
    grid or tile by tile with the probed ring. Returns (7, ny, nx):
    ub_final x3, ssh_final, <ubar> = acc / M."""
    tabs, c = _tabs(mesh), _consts(mesh, gravity, dt_bt, bt_drag)
    r = None if tile is None else ring(tabs)
    cur, acc = stack[:4], None
    for _ in range(int(n_subcycles)):
        cur = megastep._run_tiled(mesh, _subcycle, [],
                                  torch.cat([cur, stack[4:10]]), tabs, c,
                                  tile, r)
        acc = cur[:3] if acc is None else acc + cur[:3]
    return torch.cat([cur, acc / n_subcycles])


_PARAM_CACHE: dict = {}


def record(mesh, dtype):
    """The FbParams record of the subcycle kernel (K = 1, L = 0; the tables
    of the chain kernels, offsets for the compiled tile with the probed
    ring: hex_plan), packed once per mesh shape and type."""
    ft, suffix = megastep._FLOAT[dtype]
    nx, ny = mesh.structured_nx, mesh.structured_ny
    key = (nx, ny, mesh.structured_dc, suffix)
    rec = _PARAM_CACHE.get(key)
    if rec is None:
        tabs = _tabs(mesh)
        plan = megastep.hex_plan(np.dtype(ft).itemsize, ring(tabs), SLOTS)
        rec = megastep.pack_params(
            tabs, dict.fromkeys(megastep.CONST_FIELDS, 0.0), ft, plan)
        rec["L"], rec["K"], rec["ny"], rec["nx"] = 0, 1, ny, nx
        _PARAM_CACHE[key] = rec
    return rec


def _rec(mesh, dtype):
    """`record`, checked against the loaded library's layout."""
    rec = record(mesh, dtype)
    lib = _build.load()
    suffix = megastep._FLOAT[dtype][1]
    if (getattr(lib, f"omega_fb_params_size_{suffix}")() != rec.dtype.itemsize
            or lib.omega_bt_slots() != SLOTS):
        raise RuntimeError("barotropic kernel: FbParams or slab layout "
                           "differs between kernel and host")
    return rec


def tiles(mesh):
    """The kernel's tiles on `mesh` (a block each where the card holds
    them)."""
    by, bx, _ = megastep.HEX_TILE
    return (-(-mesh.structured_ny // by)) * (-(-mesh.structured_nx // bx))


def attrs(dtype, mesh=None):
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the kernel in `dtype`, the blocks an SM holds at its
    block and shared memory and the co-resident grid (that times the SMs),
    for the resident form (a block a tile) and the streamed one; with
    `mesh`, the form and grid a call on it launches."""
    lib = _build.load()
    out = {}
    for name, resident in (("resident", 1), ("streamed", 0)):
        got = np.zeros(5, np.int32)
        _build.check(getattr(lib, f"omega_barotropic_attrs_"
                                  f"{megastep._FLOAT[dtype][1]}")(
            resident, got.ctypes.data), "cudaFuncGetAttributes")
        out[name] = dict(zip(("num_regs", "local_bytes", "shared_bytes",
                              "blocks_per_sm"), map(int, got[:4])),
                         co_resident_grid=int(got[3] * got[4]))
    if mesh is not None:
        n = tiles(mesh)
        form = ("resident" if n <= out["resident"]["co_resident_grid"]
                else "streamed")
        out["call"] = dict(tiles=n, form=form, grid=min(
            n, out[form]["co_resident_grid"]))
    return out


def bt_planes(mesh, stack, *, gravity, dt_bt, n_subcycles, bt_drag=0.0,
              out=None, work=None):
    """All M subcycles of the stacked planes `stack` (10, ny, nx) into
    `out` (7, ny, nx): ub_final x3, ssh_final, <ubar>. For a CUDA array one
    cooperative launch on PyTorch's current stream runs all M, ping-ponging
    between `out` and `work` (4, ny, nx); for a CPU array the plain version
    runs. dt_bt is rounded to the working type once."""
    global launches
    ny, nx = mesh.structured_ny, mesh.structured_nx
    out = stack.new_empty((7, ny, nx)) if out is None else out
    if not stack.is_cuda:
        out.copy_(bt_plain(mesh, stack, gravity=gravity, dt_bt=dt_bt,
                           n_subcycles=n_subcycles, bt_drag=bt_drag))
        return out
    work = stack.new_empty((4, ny, nx)) if work is None else work
    if stack.dtype not in megastep._FLOAT:
        raise TypeError(f"barotropic kernel takes float32/float64, got "
                        f"{stack.dtype}")
    for a, n, name in ((stack, 10, "stack"), (out, 7, "out"),
                       (work, 4, "work")):
        if (tuple(a.shape) != (n, ny, nx) or a.dtype != stack.dtype
                or a.device != stack.device or not a.is_contiguous()):
            raise ValueError(f"`{name}` must be a contiguous ({n}, {ny}, "
                             f"{nx}) array of the stack's type and device")
    if int(n_subcycles) < 1:
        raise ValueError("n_subcycles must be at least 1")
    rec = _rec(mesh, stack.dtype)
    c = _consts(mesh, gravity, dt_bt, bt_drag)
    lib = _build.load()
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_barotropic_{megastep._FLOAT[stack.dtype][1]}")(
            stack.data_ptr(), out.data_ptr(), work.data_ptr(),
            rec.ctypes.data, c["dt_bt"], c["ggrad"], c["f_e"], c["r"],
            int(n_subcycles), 0, stream)
    _build.check(code, "barotropic subcycle launch")
    launches += 1
    return out


def bt_subcycles(mesh, ubar, ssh, g_slow, h_edge_tot, *, gravity, dt_bt,
                 n_subcycles, bt_drag=0.0):
    """All barotropic FB subcycles (the JAX package's bt_subcycles):
    ubar / g_slow / h_edge_tot (E, 1), ssh (C, 1). Returns (ub_final (E, 1),
    ssh_final (C, 1), ubar_avg (E, 1)), as the composed subcycle loop of
    split_forward_backward_step does."""
    nx, ny = mesh.structured_nx, mesh.structured_ny
    e2 = lambda x: x[:, 0].reshape(3, ny, nx)
    stack = torch.cat([e2(ubar), ssh[:, 0].reshape(1, ny, nx), e2(g_slow),
                       e2(h_edge_tot)])
    out = bt_planes(mesh, stack, gravity=gravity, dt_bt=dt_bt,
                    n_subcycles=n_subcycles, bt_drag=bt_drag)
    return (out[0:3].reshape(3 * ny * nx, 1), out[3].reshape(ny * nx, 1),
            out[4:7].reshape(3 * ny * nx, 1))
