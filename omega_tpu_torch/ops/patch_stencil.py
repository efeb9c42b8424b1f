"""Stencils on patch-structured icosahedral meshes, composed.

Counterpart of omega_tpu/ops/patch_stencil.py: meshes renumbered by
mesh/icos_patches.py expose every TRiSK stencil as static slices of a
halo-padded per-patch frame (T, 10, n+2W, n+2W, K) with per-position
weight planes, plus a small exact gather fix-up (pentagons, seams, poles):

  1. one reshape paste of the class-major grid ids,
  2. one small gather + scatter filling halos and seam holes,
  3. a sum of statically sliced, weight-plane-multiplied terms,
  4. a fix-up scatter reproducing the exact gather-path value on the few
     destinations the lattice cannot serve.

Numerics match the gather path on every row (the fix-up recipe IS the
gather recipe), up to float summation order on the lattice rows. This is
the operator path of the composed stepper on a patch mesh; the fused sphere
step is ops/patch_megastep.py.
"""

from __future__ import annotations

import torch

from omega_tpu_torch.mesh.icos_patches import HALO, NPER, PatchInfo, \
    PatchTable


def enabled(mesh) -> bool:
    return getattr(mesh, "patch_info", None) is not None


def table(mesh, name: str):
    return mesh.patch_info.tables.get(name)


def _tensors(info: PatchInfo, key, make):
    """Per-(device, type) tensors derived from the host tables, made once
    and kept on the PatchInfo."""
    key = ("tensors",) + key
    if key not in info.cache:
        info.cache[key] = make()
    return info.cache[key]


def to_frame(info: PatchInfo, src_class: str, field):
    """(N_src, K) -> (T, 10, S, S, K) halo-padded patch frame."""
    T = NPER[src_class]
    n, NG = info.n, info.ngrid
    S = n + 2 * HALO
    K = field.shape[-1]
    grid = field[:T * NG].reshape(T, 10, n, n, K)
    padded = field.new_zeros((T, 10, S, S, K))
    padded[:, :, HALO:HALO + n, HALO:HALO + n] = grid
    pos, src = _tensors(info, ("fills", src_class, field.device), lambda: tuple(
        torch.as_tensor(a, dtype=torch.long, device=field.device)
        for a in info.fills[src_class]))
    if pos.numel():
        padded.view(-1, K)[pos] = field[src]
    return padded


def _apply2d(info: PatchInfo, tab: PatchTable, field):
    n, NG = info.n, info.ngrid
    K = field.shape[-1]
    Td = NPER[tab.dst_class]
    F = to_frame(info, tab.src_class, field)
    dev, dt = field.device, field.dtype

    def make():
        planes = [torch.as_tensor(wpl, dtype=dt, device=dev)[..., None]
                  for (_, _, _, _, wpl) in tab.entries]
        fix = (torch.as_tensor(tab.fix_ids, dtype=torch.long, device=dev),
               torch.as_tensor(tab.fix_idx, dtype=torch.long, device=dev),
               torch.as_tensor(tab.fix_w, dtype=dt, device=dev))
        return planes, fix

    planes, (fix_ids, fix_idx, fix_w) = _tensors(
        info, ("table", tab.name, dev, dt), make)
    outs = [None] * Td
    for (td, ts, da, db, _), wpl in zip(tab.entries, planes):
        sl = F[ts, :, HALO + db:HALO + db + n, HALO + da:HALO + da + n, :]
        term = wpl * sl
        outs[td] = term if outs[td] is None else outs[td] + term
    zero = field.new_zeros((10, n, n, K))
    flat = torch.stack([o if o is not None else zero
                        for o in outs]).reshape(Td * NG, K)
    tail = tab.n_dst - Td * NG
    if tail:
        flat = torch.cat([flat, field.new_zeros((tail, K))])
    if fix_ids.numel():
        g = field[fix_idx.reshape(-1)].reshape(fix_idx.shape + (K,))
        flat[fix_ids] = torch.einsum("fs,fsk->fk", fix_w, g)
    return flat


def apply_patch_stencil(mesh, tab: PatchTable, field):
    """out[d] = sum_s w[d, s] * field[idx[d, s]] via patch slices.

    field: (..., N_src, K) -> (..., N_dst, K)."""
    info = mesh.patch_info
    if field.ndim == 2:
        return _apply2d(info, tab, field)
    lead = field.shape[:-2]
    flat = field.reshape((-1,) + field.shape[-2:])
    out = torch.stack([_apply2d(info, tab, f) for f in flat])
    return out.reshape(lead + out.shape[-2:])
