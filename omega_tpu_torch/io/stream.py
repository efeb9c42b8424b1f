"""Config-driven IO streams: alarm-cadenced NetCDF reads/writes.

Rewrite of infra/IOStream.h/.cpp (3,177 LoC): each stream couples a file
(or filename template), a read/write mode, an alarm-based frequency
(including OnStartup / OnShutdown / never), an optional active
[StartTime, EndTime) window, optional restart pointer-file chaining, and a
Contents list of field/group names resolved against the Field registry.

Semantics preserved from the reference:
  * filename templates $Y $M $D $h $m $s $SimTime $WallTime
    (infra/IOStream.h:228-243)
  * pointer files: a write stream records its last filename in the pointer
    file; the next job's read stream dereferences it (IOStream.h:129-134)
  * UseStartEnd: start inclusive, end exclusive (IOStream.h:136-140)
  * `write_all(clock)` once per step writes every ringing stream
    (IOStream.cpp:305); startup/shutdown phases handled by
    `read_on_startup` / `write_on_shutdown`
  * reduced precision per stream (Precision: single)
  * every written file carries SimulationTime metadata used by restart to
    reset the model clock (ocn/OceanInit.cpp:163-177)
  * multi-frame files: FileFreq/FileFreqUnits opens a new file on its own
    alarm cadence while frames accumulate on an unlimited Time dimension

Whole-array host IO: a field's attached data may be a tensor on the card;
it is copied to the host here, when a stream writes it, and at no other
time. A field attached as `ShardedFieldData` (the sharded driver's
ShardedIO) is written shard by shard into its global rows (the PIO
decomposition, base/IO.h:256,305), and `region_reader` reads each shard's
rows of a file without the global array.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from omega_tpu_torch.infra.config import Config
from omega_tpu_torch.infra.dimension import DimensionRegistry
from omega_tpu_torch.infra.errors import IOError_
from omega_tpu_torch.infra.field import FieldRegistry
from omega_tpu_torch.infra.logging import get_logger
from omega_tpu_torch.infra.time_manager import (Alarm, Calendar, Clock,
                                                TimeInstant, TimeInterval,
                                                TimeUnits)
from omega_tpu_torch.io.netcdf import (RegionReader, append_netcdf,
                                       read_attrs, read_netcdf, write_netcdf,
                                       write_sharded_frame)

_TIME_UNIT_NAMES = {u.value: u for u in TimeUnits}


def to_host(x) -> np.ndarray:
    """A field's attached data as a host numpy array (a tensor on the card
    is copied here, the one place IO reads the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ShardedFieldData:
    """Per-shard owned field data for distributed writes — the PIO
    decomposition analogue (base/IO.h:256,305). A field attached with this
    wrapper is written shard by shard into its global offsets (region
    writes), so the global array is never assembled: peak host memory is
    one shard's owned rows.

    shards: per-shard (Nl,) or (Nl, K) tensors (each copied to the host on
    its own), or a host (S, Nl[, K]) array; l2g: (S, Nl) global element
    ids; owned: (S, Nl) nonzero on owned rows."""

    def __init__(self, shards, l2g, owned, nglobal: Optional[int] = None):
        self.shards = list(shards)
        self.l2g = np.asarray(l2g)
        self.owned = np.asarray(owned) > 0
        self.nglobal = int(nglobal if nglobal is not None
                           else self.l2g.max() + 1)

    @property
    def global_shape(self):
        return (self.nglobal,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self):
        return to_host(self.shards[0][:0]).dtype

    def iter_owned(self, cast=None):
        """Yield (global_rows, owned_values) one shard at a time."""
        for s, x in enumerate(self.shards):
            m = self.owned[s]
            vals = to_host(x)[m]
            if cast is not None:
                vals = vals.astype(cast)
            yield self.l2g[s][m], vals


# reference field name -> MPAS mesh-file variable names
_MPAS_ALIASES = {
    "MinLayerCell": ("minLevelCell",),
    "MaxLayerCell": ("maxLevelCell",),
    "BottomDepth": ("bottomDepth",),
}


@dataclasses.dataclass
class StreamSpec:
    """Parsed per-stream config (the IOStreams: YAML schema)."""
    name: str
    mode: str                       # "read" | "write"
    filename: str = ""
    use_pointer: bool = False
    pointer_filename: str = ""
    if_exists: str = "replace"      # replace | append | fail
    precision: str = "double"       # double | single
    freq: int = 1
    freq_units: str = "OnStartup"   # time units | OnStartup | OnShutdown | never
    file_freq: Optional[int] = None
    file_freq_units: Optional[str] = None
    use_start_end: bool = False
    start_time: str = ""
    end_time: str = ""
    # netcdf3 (classic, universally readable) | hdf5 (NetCDF4-style;
    # O(frame) streaming appends; needs h5py)
    format: str = "netcdf3"
    contents: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_config(cls, name: str, c: Config) -> "StreamSpec":
        return cls(
            name=name,
            mode=c.get_str("Mode").lower(),
            filename=c.get("Filename", ""),
            use_pointer=bool(c.get("UsePointerFile", False)),
            pointer_filename=c.get("PointerFilename", ""),
            if_exists=str(c.get("IfExists", "replace")).lower(),
            precision=str(c.get("Precision", "double")).lower(),
            freq=int(c.get("Freq", 1)),
            freq_units=str(c.get("FreqUnits", "OnStartup")),
            file_freq=c.get("FileFreq", None),
            file_freq_units=c.get("FileFreqUnits", None),
            use_start_end=bool(c.get("UseStartEnd", False)),
            start_time=c.get("StartTime", ""),
            end_time=c.get("EndTime", ""),
            format=str(c.get("Format", "netcdf3")).lower(),
            contents=list(c.get("Contents", [])),
        )


def build_filename(template: str, clock: Clock,
                   wall_start: Optional[float] = None) -> str:
    """Expand $Y $M $D $h $m $s $SimTime $WallTime (IOStream.h:228-243)."""
    y, mo, d, hh, mm, ss = clock.get_current_time().to_date()
    subs = {
        "$SimTime": str(clock.get_current_time()),
        "$WallTime": str(int(_time.time() - (wall_start or 0.0))),
        "$Y": f"{y:04d}", "$M": f"{mo:02d}", "$D": f"{d:02d}",
        "$h": f"{hh:02d}", "$m": f"{mm:02d}", "$s": f"{int(ss):02d}",
    }
    out = template
    for k, v in subs.items():
        out = out.replace(k, v)
    return out


class IOStream:
    """One configured stream with its alarms."""

    def __init__(self, spec: StreamSpec, clock: Clock, calendar: Calendar,
                 directory: str = "."):
        self.spec = spec
        self.directory = directory
        self.calendar = calendar
        self.on_startup = spec.freq_units == "OnStartup"
        self.on_shutdown = spec.freq_units == "OnShutdown"
        self.never = spec.freq_units == "never"
        self.alarm: Optional[Alarm] = None
        self.file_alarm: Optional[Alarm] = None
        self.frame = 0
        self.current_file: Optional[str] = None
        self.wall_start = _time.time()

        units = _TIME_UNIT_NAMES.get(str(spec.freq_units).lower())
        if units is not None and not (self.on_startup or self.never):
            iv = TimeInterval.from_units(spec.freq, units)
            self.alarm = Alarm(f"{spec.name}Alarm", interval=iv,
                               start=clock.start_time)
            clock.attach_alarm(self.alarm)
        if spec.file_freq is not None and spec.file_freq_units:
            funits = _TIME_UNIT_NAMES.get(str(spec.file_freq_units).lower())
            if funits is not None:
                iv = TimeInterval.from_units(spec.file_freq, funits)
                self.file_alarm = Alarm(f"{spec.name}FileAlarm", interval=iv,
                                        start=clock.start_time)
                clock.attach_alarm(self.file_alarm)

        self.start: Optional[TimeInstant] = None
        self.end: Optional[TimeInstant] = None
        if spec.use_start_end:
            if spec.start_time:
                self.start = TimeInstant.from_string(calendar, spec.start_time)
            if spec.end_time:
                self.end = TimeInstant.from_string(calendar, spec.end_time)

    # ------------------------------------------------------------------
    def in_window(self, clock: Clock) -> bool:
        """Start inclusive, end exclusive (IOStream.h:136-140)."""
        now = clock.get_current_time()
        if self.start is not None and now < self.start:
            return False
        if self.end is not None and now >= self.end:
            return False
        return True

    def should_act(self, clock: Clock, phase: str) -> bool:
        """phase: 'startup' | 'step' | 'shutdown'."""
        if self.never:
            return False
        if not self.in_window(clock):
            return False
        if phase == "startup":
            return self.on_startup
        if phase == "shutdown":
            return self.on_shutdown
        return self.alarm is not None and self.alarm.is_ringing()

    # ------------------------------------------------------------------
    def resolve_read_path(self) -> str:
        if self.spec.use_pointer:
            ptr = os.path.join(self.directory, self.spec.pointer_filename)
            if not os.path.exists(ptr):
                raise IOError_(f"stream {self.spec.name!r}: pointer file "
                               f"{ptr} not found")
            with open(ptr) as f:
                fname = f.read().strip()
            return fname if os.path.isabs(fname) else \
                os.path.join(self.directory, fname)
        return os.path.join(self.directory, self.spec.filename)

    def resolve_write_path(self, clock: Clock) -> str:
        fname = build_filename(self.spec.filename, clock, self.wall_start)
        if not fname.endswith(".nc"):
            fname += ".nc"
        return os.path.join(self.directory, fname)

    def update_pointer(self, path: str) -> None:
        if self.spec.use_pointer and self.spec.pointer_filename:
            ptr = os.path.join(self.directory, self.spec.pointer_filename)
            with open(ptr, "w") as f:
                f.write(os.path.basename(path) + "\n")


class StreamManager:
    """All streams + the read/write machinery (IOStream static layer)."""

    def __init__(self, streams_cfg: Config, clock: Clock, calendar: Calendar,
                 fields: FieldRegistry, dims: DimensionRegistry,
                 directory: str = "."):
        self.clock = clock
        self.calendar = calendar
        self.fields = fields
        self.dims = dims
        self.directory = directory
        self.streams: Dict[str, IOStream] = {}
        for name in streams_cfg.keys():
            spec = StreamSpec.from_config(name, streams_cfg.get_group(name))
            self.streams[name] = IOStream(spec, clock, calendar, directory)

    def get(self, name: str) -> IOStream:
        if name not in self.streams:
            raise IOError_(f"unknown IO stream {name!r}")
        return self.streams[name]

    def validate_all(self) -> None:
        """Check every stream's Contents against the field registry
        (IOStream::validateAll, infra/IOStream.cpp:219)."""
        for s in self.streams.values():
            self.fields.resolve_contents(s.spec.contents)

    # ---------------- read path ----------------
    def read(self, name: str, force: bool = False,
             missing_ok: bool = False) -> Optional[Dict[str, Any]]:
        """Read a stream: fill registered fields from file, return global
        metadata (IOStream::read -> readStream, infra/IOStream.cpp:2229).

        Returns None when the stream does not act (not forced, not its
        phase) or when missing_ok and the file is absent.
        """
        s = self.get(name)
        if s.spec.mode != "read":
            raise IOError_(f"stream {name!r} is not a read stream")
        if not force and not s.should_act(self.clock, "step"):
            return None
        try:
            path = s.resolve_read_path()
        except IOError_:
            if missing_ok:
                return None
            raise
        if not os.path.exists(path):
            if missing_ok:
                return None
            raise IOError_(f"stream {name!r}: file {path} not found")
        nc = read_netcdf(path)
        for fname in self.fields.resolve_contents(s.spec.contents):
            # MPAS-file variable-name aliases (the InitialVertCoord
            # stream reads minLevelCell etc. straight from the mesh
            # file, VertCoord.cpp:149-206)
            src_name = fname
            if not nc.has(src_name):
                for alt in _MPAS_ALIASES.get(fname, ()):
                    if nc.has(alt):
                        src_name = alt
                        break
            if nc.has(src_name):
                data = np.asarray(nc.get(src_name))
                # drop a leading time frame if present (read latest)
                vdims = nc.var_dims.get(src_name, ())
                if vdims and vdims[0] == "Time":
                    data = data[-1]
                self.fields.attach(fname, data)
            else:
                get_logger().warning(
                    "stream %s: field %s not found in %s", name, fname, path)
        if s.alarm is not None:
            s.alarm.reset(self.clock.get_current_time())
        return dict(nc.attrs)

    def read_meta(self, name: str, force: bool = False,
                  missing_ok: bool = False) -> Optional[Dict[str, Any]]:
        """Global attributes of a read stream's file WITHOUT materializing
        any variable — the deferred (region-read) startup path still needs
        SimulationTime/StartTime for the restart clock reset
        (ocn/OceanInit.cpp:163-177)."""
        s = self.get(name)
        if s.spec.mode != "read":
            raise IOError_(f"stream {name!r} is not a read stream")
        if not force and not s.should_act(self.clock, "step"):
            return None
        try:
            path = s.resolve_read_path()
        except IOError_:
            if missing_ok:
                return None
            raise
        if not os.path.exists(path):
            if missing_ok:
                return None
            raise IOError_(f"stream {name!r}: file {path} not found")
        return read_attrs(path)

    def region_reader(self, name: str) -> RegionReader:
        """Open the stream's file for per-shard row-region reads (the
        read-side PIO decomposition, base/IO.h:256,305): callers pull each
        shard's global rows with reader.read_rows(field, rows), so the
        global array never exists on the host."""
        s = self.get(name)
        if s.spec.mode != "read":
            raise IOError_(f"stream {name!r} is not a read stream")
        return RegionReader(s.resolve_read_path())

    # ---------------- write path ----------------
    def write(self, name: str, force: bool = False) -> Optional[str]:
        """Write a stream if its alarm rings (or forced). Returns path,
        or None when the alarm is silent and force is not set."""
        s = self.get(name)
        if s.spec.mode != "write":
            raise IOError_(f"stream {name!r} is not a write stream")
        if not force and not s.should_act(self.clock, "step"):
            return None
        path = s.resolve_write_path(self.clock)

        multiframe = s.file_alarm is not None
        if multiframe:
            if s.current_file is None or s.file_alarm.is_ringing():
                s.current_file = path
                s.frame = 0
                s.file_alarm.reset(self.clock.get_current_time())
            path = s.current_file

        fnames = self.fields.resolve_contents(s.spec.contents)
        dims: Dict[str, int] = {"Time": 1}
        variables: Dict[str, np.ndarray] = {}
        var_dims: Dict[str, tuple] = {}
        var_attrs: Dict[str, Dict[str, Any]] = {}

        reduce_p = s.spec.precision == "single"
        sharded_vars: Dict[str, dict] = {}
        for fname in fnames:
            f = self.fields.get(fname)
            if f.data is None:
                raise IOError_(f"stream {name!r}: field {fname!r} has no "
                               f"attached data")
            if isinstance(f.data, ShardedFieldData):
                sv = f.data
                cast = (np.float32 if reduce_p else np.float64) \
                    if sv.dtype.kind == "f" else None
                dnames = tuple(f.dim_names) if f.dim_names else tuple(
                    f"dim{fname}{i}" for i in range(len(sv.global_shape)))
                for dn, ln in zip(dnames, sv.global_shape):
                    dims.setdefault(dn, int(ln))
                sharded_vars[fname] = dict(
                    vdims=dnames, shape=sv.global_shape,
                    dtype=cast or sv.dtype, shards=sv.iter_owned(cast),
                    time_dependent=f.time_dependent, attrs=f.cf_attrs())
                if s.spec.format == "hdf5":
                    continue
                # classic NetCDF: the frame carries a zero record of the
                # variable, overwritten shard by shard in place below
                data = np.zeros(sv.global_shape, cast or sv.dtype)
            else:
                data = to_host(f.data)
            if reduce_p and data.dtype == np.float64:
                data = data.astype(np.float32)
            elif not reduce_p and data.dtype == np.float32:
                # Precision: double writes a float32 state as float64
                # (exact both ways, so a restart reads back the same bits)
                data = data.astype(np.float64)
            dnames = tuple(f.dim_names) if f.dim_names else \
                tuple(f"dim{fname}{i}" for i in range(data.ndim))
            for dn, ln in zip(dnames, data.shape):
                dims.setdefault(dn, int(ln))
            if f.time_dependent:
                variables[fname] = data[None]
                var_dims[fname] = ("Time",) + dnames
            else:
                variables[fname] = data
                var_dims[fname] = dnames
            var_attrs[fname] = f.cf_attrs()

        attrs = {"SimulationTime": str(self.clock.get_current_time())}
        for meta_name in ("code", "simulation"):
            if self.fields.exists(meta_name):
                attrs.update({k: v for k, v in
                              self.fields.get(meta_name).meta.items()
                              if isinstance(v, (str, int, float))})

        append = os.path.exists(path) and \
            ((multiframe and s.frame > 0) or
             (not multiframe and s.spec.if_exists == "append"))
        if s.spec.if_exists == "fail" and os.path.exists(path) and s.frame == 0:
            raise IOError_(f"stream {name!r}: {path} exists (IfExists: fail)")

        if append:
            self._append_frame(path, variables, var_dims, attrs,
                               fmt=s.spec.format)
        else:
            write_netcdf(path, dims=dims, variables=variables,
                         var_dims=var_dims, var_attrs=var_attrs,
                         attrs=attrs, unlimited="Time", fmt=s.spec.format)
        if sharded_vars:
            write_sharded_frame(path, sharded_vars)
        s.frame += 1
        s.update_pointer(path)
        if s.alarm is not None:
            s.alarm.reset(self.clock.get_current_time())
        get_logger().info("stream %s wrote %s (frame %d)", name, path,
                          s.frame - 1)
        return path

    def _append_frame(self, path, variables, var_dims, attrs,
                      fmt="netcdf3") -> None:
        """Append a time frame: in place when the file layout allows it
        (hdf5 resizable datasets are O(frame); classic NetCDF record
        variables via scipy append mode), else read-merge-rewrite."""
        if append_netcdf(path, variables=variables, var_dims=var_dims,
                         attrs=attrs, unlimited="Time"):
            return
        nc = read_netcdf(path)
        dims = dict(nc.dims)
        merged = dict(nc.variables)
        mdims = dict(nc.var_dims)
        for fname, data in variables.items():
            if var_dims[fname][0] == "Time" and fname in merged:
                merged[fname] = np.concatenate([merged[fname], data], axis=0)
            else:
                merged[fname] = data
            mdims[fname] = var_dims[fname]
        dims["Time"] = merged[next(iter(variables))].shape[0] \
            if var_dims[next(iter(variables))][0] == "Time" else \
            dims.get("Time", 1)
        out_attrs = dict(nc.attrs)
        out_attrs.update(attrs)
        write_netcdf(path, dims=dims, variables=merged, var_dims=mdims,
                     var_attrs=nc.var_attrs, attrs=out_attrs,
                     unlimited="Time", fmt=fmt)

    # ---------------- phases ----------------
    def read_on_startup(self, missing_ok_streams=()) -> Dict[str, Dict]:
        """Run all OnStartup read streams (ocn/OceanInit.cpp:160-165).
        Returns {stream: metadata} for streams that actually read."""
        out = {}
        for name, s in self.streams.items():
            if s.spec.mode == "read" and s.should_act(self.clock, "startup"):
                meta = self.read(name, force=True,
                                 missing_ok=name in missing_ok_streams
                                 or s.spec.use_pointer)
                if meta is not None:
                    out[name] = meta
        return out

    def write_all(self, phase: str = "step") -> List[str]:
        """Write every ringing write stream; once per step
        (IOStream::writeAll, infra/IOStream.cpp:305)."""
        written = []
        for name, s in self.streams.items():
            if s.spec.mode == "write" and s.should_act(self.clock, phase):
                written.append(self.write(name, force=True))
        return written

    def finalize(self) -> List[str]:
        """On-shutdown writes (IOStream.h:125)."""
        return self.write_all(phase="shutdown")
