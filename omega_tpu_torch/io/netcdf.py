"""Low-level NetCDF file IO.

The analogue of base/IO.h:50's thin typed wrapper over SCORPIO/PIO parallel
NetCDF: open/create/close, dims, vars, global metadata, array read/write.
Whole-array file access on host numpy arrays, plus the PIO decomposition's
per-shard region reads and writes (`RegionReader`, `write_sharded_frame`),
in both formats.

Backends (no netCDF4 library needed):
  * read:  NetCDF classic / 64-bit offset via scipy.io.netcdf_file,
           NetCDF4(=HDF5) via h5py — auto-detected from the magic bytes
  * write: NetCDF3 64-bit offset via scipy (universally readable, including
           by the reference's SCORPIO), or HDF5 via h5py with NetCDF4-style
           dimension scales

MPAS mesh files in the wild come in both flavors; both read paths return
identical dicts. h5py is imported only where an HDF5 file is read or
written, so NetCDF3 works without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from omega_tpu_torch.infra.errors import IOError_


def _detect_format(path: str) -> str:
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        return "netcdf3"
    if magic == b"\x89HDF\r\n\x1a\n":
        return "hdf5"
    raise IOError_(f"{path}: not a NetCDF file (magic {magic[:4]!r})")


@dataclasses.dataclass
class NCFile:
    """In-memory image of a NetCDF file: dims, variables, attributes."""
    dims: Dict[str, int]
    variables: Dict[str, np.ndarray]
    var_dims: Dict[str, Tuple[str, ...]]
    var_attrs: Dict[str, Dict[str, Any]]
    attrs: Dict[str, Any]

    def get(self, name: str) -> np.ndarray:
        if name not in self.variables:
            raise IOError_(f"variable {name!r} not in file "
                           f"(has {sorted(self.variables)[:20]}...)")
        return self.variables[name]

    def has(self, name: str) -> bool:
        return name in self.variables


def _h5py(what: str):
    """h5py, imported where an HDF5 (NetCDF4) file is read or written."""
    try:
        import h5py
    except ImportError as e:
        raise IOError_(f"{what}: the HDF5 (NetCDF4) format needs h5py, which "
                       f"is not installed; use the NetCDF3 format "
                       f"('Format: netcdf3', the default)") from e
    return h5py


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


def _read_scipy(path: str) -> NCFile:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        dims = {k: (v if v is not None else 0) for k, v in f.dimensions.items()}
        variables, var_dims, var_attrs = {}, {}, {}
        for name, var in f.variables.items():
            data = np.array(var.data)   # copy out of the mmap
            variables[name] = data
            var_dims[name] = tuple(var.dimensions)
            var_attrs[name] = {k: _decode(v) for k, v in var._attributes.items()}
        attrs = {k: _decode(v) for k, v in f._attributes.items()}
    # resolve the record dimension's actual length
    for name, vdims in var_dims.items():
        for ax, d in enumerate(vdims):
            if dims.get(d, 0) == 0:
                dims[d] = variables[name].shape[ax]
    return NCFile(dims, variables, var_dims, var_attrs, attrs)


def _read_h5py(path: str) -> NCFile:
    h5py = _h5py(path)
    dims: Dict[str, int] = {}
    variables, var_dims, var_attrs = {}, {}, {}
    with h5py.File(path, "r") as f:
        def attrs_of(obj):
            out = {}
            for k, v in obj.attrs.items():
                if k.startswith(("_Netcdf", "CLASS", "NAME", "REFERENCE_LIST",
                                 "DIMENSION_LIST")):
                    continue
                out[k] = _decode(v)
            return out

        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            is_dimscale = ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
            if is_dimscale:
                dims[name] = ds.shape[0] if ds.ndim else int(ds[()])
                # pure coordinate stubs ("This is a netCDF dimension...")
                nm = ds.attrs.get("NAME", b"")
                if isinstance(nm, bytes) and nm.startswith(b"This is a netCDF dimension"):
                    continue
            vdims = []
            if "DIMENSION_LIST" in ds.attrs:
                for ref_list in ds.attrs["DIMENSION_LIST"]:
                    ref = ref_list[0]
                    vdims.append(f[ref].name.lstrip("/"))
            variables[name] = ds[()]
            var_dims[name] = tuple(vdims)
            var_attrs[name] = attrs_of(ds)
        attrs = attrs_of(f)
    for name, vdims in var_dims.items():
        for ax, d in enumerate(vdims):
            dims.setdefault(d, variables[name].shape[ax])
    return NCFile(dims, variables, var_dims, var_attrs, attrs)


def read_netcdf(path: str) -> NCFile:
    """Read a whole NetCDF file (any flavor) into memory."""
    fmt = _detect_format(path)
    return _read_scipy(path) if fmt == "netcdf3" else _read_h5py(path)


def write_netcdf(path: str, *, dims: Dict[str, int],
                 variables: Dict[str, np.ndarray],
                 var_dims: Dict[str, Sequence[str]],
                 var_attrs: Optional[Dict[str, Dict[str, Any]]] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 fmt: str = "netcdf3",
                 unlimited: Optional[str] = None) -> None:
    """Write a NetCDF file.

    fmt='netcdf3': classic 64-bit-offset via scipy (interoperable with the
    reference's SCORPIO readers). fmt='hdf5': NetCDF4-style HDF5 via h5py.
    `unlimited` names the record dimension (e.g. 'Time').
    """
    var_attrs = var_attrs or {}
    attrs = attrs or {}
    if fmt == "netcdf3":
        _write_scipy(path, dims, variables, var_dims, var_attrs, attrs,
                     unlimited)
    elif fmt == "hdf5":
        _write_h5py(path, dims, variables, var_dims, var_attrs, attrs,
                    unlimited)
    else:
        raise IOError_(f"unknown NetCDF write format {fmt!r}")


def write_sharded_frame(path: str, svars: Dict[str, dict],
                        unlimited: str = "Time") -> None:
    """Region-write the latest frame of sharded variables — the
    PIO-decomposition analogue (base/IO.h:256,305): each shard's owned rows
    land at their global offsets, one shard at a time, without the global
    array ever being assembled.

    svars: {name: dict(vdims, shape (global, element axis first), dtype,
    shards (iterable of (rows, values)), time_dependent, attrs)}.

    hdf5: the dataset is created resizable on first use and grown one
    record per call for time-dependent variables (h5py).
    netcdf3: the variable must already be in the file — the stream writes
    the frame with a zero record of it, since a classic file declares
    every variable in its header and lays out each record whole — and its
    latest record is overwritten in place through a memory map at the
    variable's offset in the file."""
    if _detect_format(path) == "hdf5":
        _sharded_h5py(path, svars, unlimited)
        return
    from scipy.io import netcdf_file
    place = {}
    f = netcdf_file(path, "r", mmap=True)
    try:
        base = np.frombuffer(f._mm_buf, np.uint8).__array_interface__[
            "data"][0]
        for name in svars:
            if name not in f.variables:
                raise IOError_(f"{path}: sharded variable {name!r} has no "
                               "record in the file")
            d = f.variables[name].data
            place[name] = (d.__array_interface__["data"][0] - base,
                           d.shape, d.dtype, d.strides)
            del d
    finally:
        f.close()
    mm = np.memmap(path, dtype=np.uint8, mode="r+")
    try:
        for name, sv in svars.items():
            off, shape, dt, strides = place[name]
            arr = np.ndarray(shape, dt, buffer=mm, offset=off,
                             strides=strides)
            td = bool(sv.get("time_dependent", True))
            dst = arr[shape[0] - 1] if td else arr
            for rows, values in sv["shards"]:
                dst[np.asarray(rows)] = np.asarray(values)
            del arr, dst
        mm.flush()
    finally:
        del mm


def _sharded_h5py(path, svars, unlimited):
    h5py = _h5py(path)
    with h5py.File(path, "a") as f:
        for name, sv in svars.items():
            vdims = tuple(sv["vdims"])
            gshape = tuple(int(n) for n in sv["shape"])
            td = bool(sv.get("time_dependent", True))
            if td:
                vdims = (unlimited,) + vdims
            if name not in f:
                shape = ((1,) + gshape) if td else gshape
                maxshape = ((None,) + gshape) if td else None
                ds = f.create_dataset(name, shape=shape, dtype=sv["dtype"],
                                      maxshape=maxshape,
                                      chunks=True if td else None)
                for k, a in (sv.get("attrs") or {}).items():
                    ds.attrs[k] = a
                # dimension scales, so readers (RegionReader, netCDF4)
                # see the axis names, the leading Time record axis first
                for ax, dn in enumerate(vdims):
                    if dn in f and dn != name:
                        ds.dims[ax].attach_scale(f[dn])
                frame = 0
            else:
                ds = f[name]
                if td:
                    frame = ds.shape[0]
                    ds.resize(frame + 1, axis=0)
                else:
                    frame = None
            for rows, values in sv["shards"]:
                rows = np.asarray(rows)
                order = np.argsort(rows)   # h5py fancy idx must ascend
                values = np.asarray(values)
                if td:
                    ds[frame, rows[order]] = values[order]
                else:
                    ds[rows[order]] = values[order]


class RegionReader:
    """Row-region reads without materializing the global array — the
    read-side PIO-decomposition analogue (base/IO.h:256,305: distributed
    array reads land each task's rows only).

    hdf5: h5py dataset fancy-indexing reads just the requested rows.
    netcdf3: scipy with mmap=True exposes variables as memory-mapped
    views, so row indexing faults in only the touched pages. Either way
    peak host memory per call is O(len(rows)), not O(global)."""

    def __init__(self, path: str):
        self.path = path
        self.fmt = _detect_format(path)
        if self.fmt == "hdf5":
            h5py = _h5py(path)
            self._f = h5py.File(path, "r")
            self.attrs = {k: _decode(v) for k, v in self._f.attrs.items()
                          if not k.startswith(("_Netcdf",))}
            self._vdims = {}
            for name, ds in self._f.items():
                if not isinstance(ds, h5py.Dataset):
                    continue
                vdims = []
                if "DIMENSION_LIST" in ds.attrs:
                    for ref_list in ds.attrs["DIMENSION_LIST"]:
                        vdims.append(self._f[ref_list[0]].name.lstrip("/"))
                self._vdims[name] = tuple(vdims)
        else:
            from scipy.io import netcdf_file
            self._f = netcdf_file(path, "r", mmap=True)
            self.attrs = {k: _decode(v)
                          for k, v in self._f._attributes.items()}
            self._vdims = {name: tuple(v.dimensions)
                           for name, v in self._f.variables.items()}

    def has(self, name: str) -> bool:
        if self.fmt == "hdf5":
            import h5py
            return name in self._f and isinstance(self._f[name],
                                                  h5py.Dataset)
        return name in self._f.variables

    def var_dims(self, name: str):
        return self._vdims.get(name, ())

    def read_rows(self, name: str, rows: np.ndarray) -> np.ndarray:
        """rows of the element (first non-time) axis, latest time frame."""
        rows = np.asarray(rows)
        # h5py fancy indexing must be strictly increasing — read the
        # unique sorted rows once and fan duplicates back out
        uniq, inv = np.unique(rows, return_inverse=True)
        v = self._f[name] if self.fmt == "hdf5" else \
            self._f.variables[name].data
        if self._vdims.get(name, ())[:1] == ("Time",):
            out = np.array(v[v.shape[0] - 1][uniq])
        else:
            out = np.array(v[uniq])
        del v
        return out[inv.reshape(rows.shape)]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_attrs(path: str) -> Dict[str, Any]:
    """Global attributes only — no variable data is materialized (the
    restart clock reset needs just SimulationTime/StartTime)."""
    with RegionReader(path) as r:
        return dict(r.attrs)


def _write_scipy(path, dims, variables, var_dims, var_attrs, attrs,
                 unlimited):
    from scipy.io import netcdf_file
    with netcdf_file(path, "w", version=2) as f:   # version=2: 64-bit offset
        for k, v in attrs.items():
            setattr(f, k, v)
        for name, length in dims.items():
            f.createDimension(name, None if name == unlimited else int(length))
        for name, data in variables.items():
            data = np.asarray(data)
            if data.dtype == np.float16:
                data = data.astype(np.float32)
            if data.dtype in (np.int8, np.uint8, np.bool_):
                data = data.astype(np.int32)
            if data.dtype == np.int64:
                data = data.astype(np.int32)  # classic NetCDF has no int64
            v = f.createVariable(name, data.dtype, tuple(var_dims[name]))
            v[:] = data
            for k, a in var_attrs.get(name, {}).items():
                setattr(v, k, a)


def _write_h5py(path, dims, variables, var_dims, var_attrs, attrs,
                unlimited=None):
    h5py = _h5py(path)
    with h5py.File(path, "w") as f:
        for k, v in attrs.items():
            f.attrs[k] = v
        for name, length in dims.items():
            if name in variables:
                continue
            ds = f.create_dataset(name, shape=(int(length),), dtype="f4")
            ds.make_scale(name)
        for name, data in variables.items():
            data = np.asarray(data)
            vdims = tuple(var_dims[name])
            maxshape = None
            if unlimited and unlimited in vdims:
                maxshape = tuple(None if d == unlimited else n
                                 for d, n in zip(vdims, data.shape))
            ds = f.create_dataset(name, data=data, maxshape=maxshape,
                                  chunks=True if maxshape else None)
            for ax, d in enumerate(vdims):
                if d in f and d != name:
                    ds.dims[ax].attach_scale(f[d])
            for k, a in var_attrs.get(name, {}).items():
                ds.attrs[k] = a


def append_netcdf(path: str, *, variables: Dict[str, np.ndarray],
                  var_dims: Dict[str, Sequence[str]],
                  attrs: Optional[Dict[str, Any]] = None,
                  unlimited: str = "Time") -> bool:
    """Append one record along the unlimited dimension IN PLACE.

    hdf5: O(frame) — datasets created resizable by _write_h5py are grown
    and only the new slab is written. netcdf3: scipy's append mode writes
    the new record slot directly. Returns False when the file layout
    cannot take an in-place append (caller falls back to
    read-merge-rewrite)."""
    attrs = attrs or {}
    fmt = _detect_format(path)
    if fmt == "hdf5":
        h5py = _h5py(path)
        with h5py.File(path, "a") as f:
            for name, data in variables.items():
                data = np.asarray(data)
                if tuple(var_dims[name])[:1] != (unlimited,):
                    continue
                if name not in f or f[name].maxshape[0] is not None:
                    return False
                ds = f[name]
                n = ds.shape[0]
                ds.resize(n + data.shape[0], axis=0)
                ds[n:] = data
            for k, v in attrs.items():
                f.attrs[k] = v
        return True
    from scipy.io import netcdf_file
    try:
        with netcdf_file(path, "a", mmap=False, version=2) as f:
            for k, v in attrs.items():
                setattr(f, k, v)
            for name, data in variables.items():
                if tuple(var_dims[name])[:1] != (unlimited,):
                    continue
                if name not in f.variables:
                    return False
                v = f.variables[name]
                n = v.shape[0] if v.data is not None else 0
                for i in range(np.asarray(data).shape[0]):
                    v[n + i] = np.asarray(data)[i]
        return True
    except Exception:
        return False
