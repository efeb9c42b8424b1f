"""One structured stencil pass: the CUDA kernel and its plain version.

    out[..., t_dst, y, x, :] = sum_e w_e * in[..., ts_e, y + dj_e,
                                              x + di_e(parity of y), :]

on the doubly periodic (ny, nx) hex lattice, for a shift table derived by
ops/structured.py. The kernel (csrc/stencil.cu) is the counterpart of the
JAX package's two Pallas stencil kernels (`pallas_stencil_dma._kernel` and
`pallas_stencil._stencil_kernel`, the same function in two layouts).

`apply` is what `structured.apply_stencil` calls: a CUDA field goes to the
kernel, a CPU field to the plain roll form. A field on the card never takes
the plain version, and a kernel that fails to build or launch raises.

`attrs` reads the compiled kernel's registers, spill and blocks per SM.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.ops import _build, structured

# launches of the CUDA kernel since the last reset (a plain integer; the
# smoke run zeroes it before driving a path and reads it after)
launches = 0

MAX_ENTRIES = 32      # kStencilMaxEntries in csrc/stencil.cu
_FLOAT = {torch.float32: (np.float32, "f32"), torch.float64: (np.float64, "f64")}


def entry_dtype(ft) -> np.dtype:
    """numpy mirror of `omega::Entry<T>` (csrc/stencil_common.cuh)."""
    return np.dtype([("w", ft), ("ts", "i1"), ("dj", "i1"),
                     ("di_e", "i1"), ("di_o", "i1")], align=True)


def pack_entries(tab, pd: int, ft):
    """Table entries grouped by destination class, table order kept within
    a class (so sums run in the plain version's order).
    Returns (entries record array, start offsets of length pd + 1)."""
    order = [i for t in range(pd) for i, e in enumerate(tab) if e[0] == t]
    ent = np.zeros(len(order), entry_dtype(ft))
    for n, i in enumerate(order):
        _, ts, dj, di_e, di_o, w = tab[i]
        ent[n] = (w, ts, dj, di_e, di_o)
    counts = [sum(1 for e in tab if e[0] == t) for t in range(pd)]
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return ent, start


def _params_dtype(ft) -> np.dtype:
    """numpy mirror of `omega::StencilParams<T>` (csrc/stencil.cu)."""
    return np.dtype([("e", entry_dtype(ft), (MAX_ENTRIES,)),
                     ("start", "i4", (4,)),
                     ("ps", "i4"), ("pd", "i4"), ("nb", "i4"),
                     ("ny", "i4"), ("nx", "i4"), ("K", "i4")], align=True)


_PARAM_CACHE: dict = {}


def _params(tab, ps, pd, nx, ny, ft):
    key = (tuple(tab), ps, pd, nx, ny, np.dtype(ft).str)
    rec = _PARAM_CACHE.get(key)
    if rec is None:
        if len(tab) > MAX_ENTRIES:
            raise ValueError(f"stencil table has {len(tab)} entries; the "
                             f"kernel takes at most {MAX_ENTRIES}")
        for (_, _, dj, di_e, di_o, _) in tab:
            if abs(dj) >= ny or max(abs(di_e), abs(di_o)) >= nx:
                raise ValueError("stencil shift exceeds the domain")
        ent, start = pack_entries(tab, pd, ft)
        rec = np.zeros((), _params_dtype(ft))
        rec["e"][:len(ent)] = ent
        rec["start"][:pd + 1] = start
        rec["start"][pd + 1:] = start[-1]
        rec["ps"], rec["pd"], rec["ny"], rec["nx"] = ps, pd, ny, nx
        _PARAM_CACHE[key] = rec
    return rec.copy()


def launch_record(tab, ps: int, pd: int, nx: int, ny: int, nb: int, K: int,
                  ft):
    """The record one launch takes (`omega::StencilParams<T>`). Raises for a
    table of more than MAX_ENTRIES entries or a shift that exceeds the
    domain."""
    rec = _params(tab, ps, pd, nx, ny, ft)
    rec["nb"], rec["K"] = nb, K
    return rec


def attrs(dtype=torch.float32, vector: bool = True) -> dict:
    """cudaFuncGetAttributes' numRegs, localSizeBytes (the spill) and
    sharedSizeBytes of the kernel (its 16-byte instance, or its
    one-element one), and the blocks of 256 threads an SM holds."""
    lib = _build.load()
    got = np.zeros(4, np.int32)
    _build.check(getattr(lib, f"omega_stencil_attrs_{_FLOAT[dtype][1]}")(
        int(vector), got.ctypes.data), "stencil attributes")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "blocks_per_sm"), map(int, got)))


def apply_stencil_plain(tab, ps: int, pd: int, nx: int, ny: int, field):
    """The plain PyTorch version: periodic rolls of the (ny, nx) grid with
    a row-parity select for the staggered column shifts.

    field (..., ps*ny*nx, K) -> (..., pd*ny*nx, K)."""
    G = structured._to_grid(field, ps, nx, ny)      # (..., ps, ny, nx, K)
    parts = [None] * pd
    for (t_dst, t_src, dj, di_e, di_o, w) in tab:
        src = G[..., t_src, :, :, :]                # (..., ny, nx, K)
        term = structured._shift(src, dj, di_e, di_o)
        term = term * w if w != 1.0 else term
        parts[t_dst] = term if parts[t_dst] is None else parts[t_dst] + term
    out = torch.stack(parts, dim=-4)                # (..., pd, ny, nx, K)
    return structured._from_grid(out)


def apply_stencil_cuda(tab, ps: int, pd: int, nx: int, ny: int, field):
    """Launch the CUDA kernel on PyTorch's current stream.

    field (..., ps*ny*nx, K) on a CUDA device, float32 or float64."""
    global launches
    if not field.is_cuda:
        raise ValueError("apply_stencil_cuda needs a CUDA tensor")
    if field.dtype not in _FLOAT:
        raise TypeError(f"stencil kernel takes float32/float64, "
                        f"got {field.dtype}")
    if field.ndim < 2 or field.shape[-2] != ps * ny * nx:
        raise ValueError(f"field shape {tuple(field.shape)} does not end in "
                         f"({ps * ny * nx}, K)")
    ft, suffix = _FLOAT[field.dtype]
    field = field.contiguous()
    lead, K = field.shape[:-2], field.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    out = torch.empty(lead + (pd * ny * nx, K), dtype=field.dtype,
                      device=field.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    rec = launch_record(tab, ps, pd, nx, ny, nb, K, ft)
    size = getattr(lib, f"omega_stencil_params_size_{suffix}")()
    if size != rec.dtype.itemsize:
        raise RuntimeError(f"StencilParams layout mismatch: kernel {size} "
                           f"bytes, host {rec.dtype.itemsize}")
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, f"omega_stencil_{suffix}")(
            field.data_ptr(), out.data_ptr(), rec.ctypes.data, stream)
    _build.check(code, "stencil kernel launch")
    launches += 1
    return out


def apply(tab, ps: int, pd: int, nx: int, ny: int, field):
    """Kernel for a CUDA field, plain version for a CPU field."""
    if field.is_cuda:
        return apply_stencil_cuda(tab, ps, pd, nx, ny, field)
    return apply_stencil_plain(tab, ps, pd, nx, ny, field)
