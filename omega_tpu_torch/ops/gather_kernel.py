"""One weighted gather pass over a host-built table: the CUDA kernel and its
plain version.

    out[..., n, k] = sum_j w[n, j] * field[..., idx[n, j], k]

for the TRiSK stencils of an unstructured mesh (ops/trisk.py's table
branch; the tables come from `trisk.warm_gather`, on a mesh renumbered by
mesh/reorder.py). The kernel (csrc/gather.cu) is the counterpart of the JAX
package's windowed Pallas gather (`omega_tpu/ops/pallas_gather.py:_kernel`),
which DMAs each 256-row block's source window into VMEM and multiplies a
weighted one-hot matrix into it on the MXU. On the card a gather is a direct
indexed load: a row's slots in registers, 16-byte loads of K through the
L2 (the fields of one step fit in the 50 MB L2), one launch over every
leading index; the window `W` of each block is kept as information.

`apply` is what trisk's operators call: a CUDA field launches the kernel, a
CPU field takes `apply_plain`, anything else raises. A kernel that fails to
build or launch raises; nothing falls back. The launch's arguments are
worked out once per (device, dtype, shape) and kept on the table, since a
one-index pass at icos48 x 100 takes the card about as long as a Python
call takes the host.
"""

from __future__ import annotations

import numpy as np
import torch

from omega_tpu_torch.ops import _build

# launches of the CUDA kernel since the last reset (a plain integer; the
# smoke run zeroes it before driving a path and reads it after)
launches = 0

BLOCK = 256          # rows per block of the table (the reference's BLOCK)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the current stream's handle without building a Stream object (PyTorch's
# CUDA builds have it; torch.cuda.current_stream otherwise)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class GatherTable:
    """Host-built gather plan for one stencil: `idx` int32 (N_pad, M) and
    `w` float64 (N_pad, M), the rows padded to blocks of BLOCK with zero
    weights, and every zero-weight slot pointed at row 0 (the semantics of
    the reference's GatherTable, `pallas_gather.py:43-90`). `nsrc` is the
    source length the table reads, `window` the widest span of source rows
    any block of BLOCK rows touches (information: a direct gather has no
    window to fit, so the reference's VMEM cap is not applied). Device
    copies of idx and w are made once per (device, dtype), at first use,
    and a launch's arguments once per (device, dtype, shape)."""

    def __init__(self, idx, weights, nsrc: int):
        idx = np.asarray(idx, np.int64)
        if idx.ndim == 1:
            idx = idx[:, None]
        w = np.asarray(weights, np.float64)
        if w.ndim == 1:
            w = w[:, None]
        if idx.shape != w.shape:
            raise ValueError(f"index {idx.shape} and weight {w.shape} "
                             "shapes differ")
        N, M = idx.shape
        nb = -(-N // BLOCK)
        idx_p = np.zeros((nb * BLOCK, M), np.int64)
        w_p = np.zeros((nb * BLOCK, M), np.float64)
        idx_p[:N] = idx
        w_p[:N] = w
        idx_p = np.where(w_p != 0.0, idx_p, 0)
        if idx_p.size and (idx_p.min() < 0 or idx_p.max() >= nsrc):
            raise ValueError(f"gather index out of [0, {nsrc})")
        span = 1
        for b in range(nb):
            sl = slice(b * BLOCK, (b + 1) * BLOCK)
            valid = idx_p[sl][w_p[sl] != 0.0]
            if valid.size:
                span = max(span, int(valid.max() - valid.min() + 1))
        self.n = N
        self.m = M
        self.nsrc = int(nsrc)
        self.nblocks = nb
        self.window = span
        self.idx = idx_p.astype(np.int32)
        self.w = w_p
        self._dev = {}
        self._calls = {}

    def on(self, device, dtype):
        """(idx int32, w in `dtype`) on `device`, contiguous, made once."""
        key = (torch.device(device), dtype)
        got = self._dev.get(key)
        if got is None:
            got = (torch.as_tensor(self.idx).to(device).contiguous(),
                   torch.as_tensor(self.w).to(device=device,
                                               dtype=dtype).contiguous())
            self._dev[key] = got
        return got


def _check(table: GatherTable, field):
    if field.dtype not in _SUFFIX:
        raise TypeError(f"the gather takes float32/float64 fields, not "
                        f"{field.dtype}")
    if field.ndim < 2 or field.shape[-2] != table.nsrc:
        raise ValueError(f"field of shape {tuple(field.shape)} does not "
                         f"match the table's ({table.nsrc}, K) sources")


def apply_plain(table: GatherTable, field):
    """The plain version: `index_select` of every slot's sources, then the
    weighted sum in slot order (each product rounded, then added), on the
    field's device. On the CPU it is the oracle; on the card what the kernel
    is held against."""
    _check(table, field)
    idx, w = table.on(field.device, field.dtype)
    N, M = table.n, table.m
    g = field.index_select(-2, idx[:N].reshape(-1))
    g = g.reshape(field.shape[:-2] + (N, M) + field.shape[-1:])
    out = w[:N, 0, None] * g[..., 0, :]
    for j in range(1, M):
        out = out + w[:N, j, None] * g[..., j, :]
    return out


def _call_of(table: GatherTable, f):
    """(entry point, ints array, idx and w pointers, output shape) of a
    launch on the contiguous CUDA field `f`."""
    _check(table, f)
    lead, K = tuple(f.shape[:-2]), f.shape[-1]
    L = int(np.prod(lead, dtype=np.int64))
    if K < 1 or L < 1:
        raise ValueError(f"field of shape {tuple(f.shape)}: the gather "
                         "needs K >= 1 and prod(leading dims) >= 1")
    idx, w = table.on(f.device, f.dtype)
    ints = np.array([table.n, table.m, K, table.nsrc, L], np.int32)
    fn = getattr(_build.load(), f"omega_gather_{_SUFFIX[f.dtype]}")
    return fn, ints, idx.data_ptr(), w.data_ptr(), lead + (table.n, K)


def apply(table: GatherTable, field):
    """sum_j w[n, j] * field[..., idx[n, j], :] -> (..., N, K) for a field
    of shape (..., N_src, K): one launch of csrc/gather.cu over every
    leading index for a CUDA field (made contiguous first), the plain
    version for a CPU field. Raises on any other device, dtype or shape."""
    global launches
    if field.device.type == "cpu":
        _check(table, field)
        return apply_plain(table, field)
    if not field.is_cuda:
        raise ValueError(f"the gather runs on CUDA or CPU fields, not "
                         f"{field.device}")
    f = field if field.is_contiguous() else field.contiguous()
    key = (f.device, f.dtype, f.shape)
    call = table._calls.get(key)
    if call is None:
        call = table._calls[key] = _call_of(table, f)
    fn, ints, idx, w, shape = call
    out = torch.empty(shape, dtype=f.dtype, device=f.device)
    dev = f.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            code = fn(f.data_ptr(), out.data_ptr(), idx, w, ints.ctypes.data,
                      torch.cuda.current_stream().cuda_stream)
    else:
        stream = (_raw_stream(dev) if _raw_stream is not None
                  else torch.cuda.current_stream().cuda_stream)
        code = fn(f.data_ptr(), out.data_ptr(), idx, w, ints.ctypes.data,
                  stream)
    _build.check(code, "gather launch")
    launches += 1
    return out
