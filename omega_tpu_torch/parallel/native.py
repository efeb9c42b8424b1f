"""ctypes binding of the port's native partition / halo library.

The C++ source is the port's own copy, omega_tpu_torch/native/partition.cpp.
At first use it is compiled by `g++ -O3 -shared -fPIC -std=c++17` into
omega_tpu_torch/build/ (git-ignored, beside the CUDA library), under a
name that carries a hash of the source, and loaded with ctypes. Exposes:

  hilbert_keys(x, y)          — SFC keys (better locality than the Morton
                                keys of decomp.py)
  partition_geom(x, y, n)     — owner per cell by Hilbert chunking
  halo_layers(...)            — BFS halo rings per shard
  refine_partition(...)       — greedy KL boundary refinement

Every entry point has a numpy twin, so the package works without a
compiler; `available()` reports whether the library loaded and `ROUTE`
records which route the last call took ("native" or "numpy"). The native
route matters at init time on 10^6+-cell meshes (the role ParMETIS plays in
base/Decomp.cpp:1213).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "partition.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# the route the last call of each entry point took: "native" or "numpy"
ROUTE: dict = {}


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libomega_partition_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library, compiled when missing (None without a compiler)."""
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.so"
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)          # atomic: concurrent compilations agree
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.omega_hilbert_keys.argtypes = [f64p, f64p, ctypes.c_int64,
                                       ctypes.c_int, u64p]
    lib.omega_hilbert_keys.restype = None
    lib.omega_partition_geom.argtypes = [f64p, f64p, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_int, i64p]
    lib.omega_partition_geom.restype = None
    lib.omega_halo_layers.argtypes = [i64p, i32p, ctypes.c_int64,
                                      ctypes.c_int, i64p, ctypes.c_int,
                                      ctypes.c_int, i64p, ctypes.c_int64,
                                      i64p]
    lib.omega_halo_layers.restype = ctypes.c_int64
    lib.omega_refine_partition.argtypes = [i64p, i32p, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_double,
                                           i64p]
    lib.omega_refine_partition.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def hilbert_keys(x: np.ndarray, y: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert SFC keys for points normalized to [0, 1)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n = len(x)
    if lib is not None:
        ROUTE["hilbert_keys"] = "native"
        keys = np.empty(n, np.uint64)
        lib.omega_hilbert_keys(x, y, n, bits, keys)
        return keys
    ROUTE["hilbert_keys"] = "numpy"
    return _hilbert_py(x, y, bits)


def partition_geom(x: np.ndarray, y: np.ndarray, nparts: int,
                   bits: int = 16) -> np.ndarray:
    """Owner shard per point: Hilbert sort + equal chunks."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n = len(x)
    if lib is not None:
        ROUTE["partition_geom"] = "native"
        owner = np.empty(n, np.int64)
        lib.omega_partition_geom(x, y, n, nparts, bits, owner)
        return owner
    ROUTE["partition_geom"] = "numpy"
    keys = _hilbert_py(x, y, bits)
    order = np.argsort(keys, kind="stable")
    owner = np.empty(n, np.int64)
    owner[order] = (np.arange(n, dtype=np.int64) * nparts) // n
    return owner


def halo_layers(cells_on_cell: np.ndarray, n_eoc: np.ndarray,
                owner: np.ndarray, nparts: int, width: int
                ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
    """Per shard: (owned cell ids, [ring1 ids, ..., ringW ids])."""
    lib = _load()
    C, M = cells_on_cell.shape
    if lib is None:
        ROUTE["halo_layers"] = "numpy"
        return _halo_py(cells_on_cell, n_eoc, owner, nparts, width)
    ROUTE["halo_layers"] = "native"
    coc = np.ascontiguousarray(cells_on_cell, np.int64)
    ne = np.ascontiguousarray(n_eoc, np.int32)
    own = np.ascontiguousarray(owner, np.int64)
    cap = np.int64(C * min(nparts, 4) + 16)   # generous first guess
    offsets = np.empty(nparts * (width + 1) + 1, np.int64)
    cells = np.empty(cap, np.int64)
    got = lib.omega_halo_layers(coc, ne, C, M, own, nparts, width,
                                cells, cap, offsets)
    if got < 0:
        cells = np.empty(-got, np.int64)
        lib.omega_halo_layers(coc, ne, C, M, own, nparts, width,
                              cells, -got, offsets)
    out = []
    for s in range(nparts):
        base = s * (width + 1)
        ownc = cells[offsets[base]:offsets[base + 1]].copy()
        rings = [cells[offsets[base + w]:offsets[base + w + 1]].copy()
                 for w in range(1, width + 1)]
        out.append((ownc, rings))
    return out


def refine_partition(cells_on_cell: np.ndarray, n_eoc: np.ndarray,
                     owner: np.ndarray, nparts: int, passes: int = 8,
                     imbalance: float = 0.02):
    """Greedy KL boundary refinement (C++). Works on a copy of `owner`;
    returns (refined owner, edge cut), or (owner, None) without the
    library (the numpy route keeps the geometric partition, as the
    reference's does)."""
    lib = _load()
    out = np.ascontiguousarray(owner, np.int64).copy()
    if lib is None:
        ROUTE["refine_partition"] = "numpy"
        return out, None
    ROUTE["refine_partition"] = "native"
    coc = np.ascontiguousarray(cells_on_cell, np.int64)
    ne = np.ascontiguousarray(n_eoc, np.int32)
    cut = lib.omega_refine_partition(coc, ne, coc.shape[0], coc.shape[1],
                                     nparts, passes, imbalance, out)
    return out, int(cut)


# ---------------- numpy twins ----------------

def _hilbert_py(x, y, bits):
    n = len(x)
    scale = float(1 << bits)
    xq = np.minimum((np.mod(x, 1.0) * scale), scale - 1).astype(np.uint64)
    yq = np.minimum((np.mod(y, 1.0) * scale), scale - 1).astype(np.uint64)
    d = np.zeros(n, np.uint64)
    x_, y_ = xq.copy(), yq.copy()
    s = np.uint64(1 << (bits - 1))
    while s > 0:
        rx = ((x_ & s) > 0).astype(np.uint64)
        ry = ((y_ & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - np.uint64(1) - x_, x_)
        y_f = np.where(flip, s - np.uint64(1) - y_, y_)
        x_, y_ = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= np.uint64(1)
    return d


def _halo_py(cells_on_cell, n_eoc, owner, nparts, width):
    C, M = cells_on_cell.shape
    valid = np.arange(M)[None, :] < np.asarray(n_eoc)[:, None]
    out = []
    for s in range(nparts):
        ownc = np.where(owner == s)[0]
        seen = np.zeros(C, bool)
        seen[ownc] = True
        rings = []
        frontier = ownc
        for _ in range(width):
            nbrs = cells_on_cell[frontier]
            ok = valid[frontier] & (nbrs >= 0)
            cand = np.unique(nbrs[ok])
            new = cand[~seen[cand]]
            seen[new] = True
            rings.append(new)
            frontier = new
        out.append((ownc, rings))
    return out
