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
launches csrc/bt_gather.cu or raises. The kernel reads the mesh's
connectivity directly (`cells_on_edge` and `dc_edge` for the gradient,
`edges_on_edge` and `weights_on_edge` for the tangential reconstruction,
`edges_on_cell` and `w_div_cell` for the divergence): padded slots point at
element 0 with weight 0, and the dead seam slots of a patch mesh have
cells (0, 0), zero weights and edge_mask 0, so they stay 0.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.ops import _build, trisk

# launches since the last reset: two per subcycle (edges, then cells)
launches = 0
LAUNCHES_PER_SUBCYCLE = 2
THREADS = 256


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


def _mesh_arrays(mesh, dtype, device):
    """The kernel's view of the mesh: int32 connectivity and the weights in
    the working type, contiguous (a mesh already on the device in that
    type is used as it is, without a copy)."""
    i32 = lambda a: torch.as_tensor(a).to(device=device,
                                          dtype=torch.int32).contiguous()
    fl = lambda a: torch.as_tensor(a).to(device=device,
                                         dtype=dtype).contiguous()
    return dict(coe=i32(mesh.cells_on_edge), dc=fl(mesh.dc_edge),
                eoe=i32(mesh.edges_on_edge), woe=fl(mesh.weights_on_edge),
                eoc=i32(mesh.edges_on_cell), wdiv=fl(mesh.w_div_cell),
                f_e=fl(mesh.f_edge), mask=fl(mesh.edge_mask))


def bt_subcycles(mesh, ubar, ssh, g_slow, h_edge_tot, *, gravity, dt_bt,
                 n_subcycles, bt_drag=0.0):
    """All M barotropic subcycles: ubar / g_slow / h_edge_tot (E, 1), ssh
    (C, 1). Returns (ub_final (E, 1), ssh_final (C, 1), ubar_avg (E, 1)).
    For CUDA arrays one C call launches the edge and the cell kernel of
    csrc/bt_gather.cu per subcycle on PyTorch's current stream (2 M
    launches: ssh reads the new ub of every neighbouring edge, so every edge
    finishes before any cell); for CPU arrays the plain version runs.
    dt_bt, g and r are rounded to the working type once."""
    global launches
    if not ubar.is_cuda:
        return subcycles_plain(mesh, ubar, ssh, g_slow, h_edge_tot,
                               gravity=gravity, dt_bt=dt_bt,
                               n_subcycles=n_subcycles, bt_drag=bt_drag)
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
    m = _mesh_arrays(mesh, ubar.dtype, ubar.device)
    ubar, ssh = ubar.contiguous(), ssh.contiguous()
    g_slow, het = g_slow.contiguous(), h_edge_tot.contiguous()
    ub_out, ub_work = torch.empty_like(ubar), torch.empty_like(ubar)
    ssh_out, avg = torch.empty_like(ssh), torch.empty_like(ubar)
    consts = np.array([float(dt_bt), -float(gravity), float(bt_drag)],
                      np.float64)
    ints = np.array([E, C, m["eoe"].shape[1], m["eoc"].shape[1], M,
                     THREADS], np.int32)
    lib = _build.load()
    with torch.cuda.device(ubar.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_bt_gather_{suffix}")(
            ubar.data_ptr(), ssh.data_ptr(), g_slow.data_ptr(),
            het.data_ptr(), ub_out.data_ptr(), ub_work.data_ptr(),
            ssh_out.data_ptr(), avg.data_ptr(), m["coe"].data_ptr(),
            m["dc"].data_ptr(), m["eoe"].data_ptr(), m["woe"].data_ptr(),
            m["eoc"].data_ptr(), m["wdiv"].data_ptr(), m["f_e"].data_ptr(),
            m["mask"].data_ptr(), consts.ctypes.data, ints.ctypes.data,
            stream)
    _build.check(code, "sphere barotropic subcycle launch")
    launches += LAUNCHES_PER_SUBCYCLE * M
    return ub_out, ssh_out, avg
