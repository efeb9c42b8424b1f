"""Hierarchical YAML configuration.

Host-side rewrite of the reference Config (infra/Config.h:32,88-367,
infra/Config.cpp): the full ``omega.yml`` is read once at init, modules
retrieve their named sub-group and typed values from it, values can be
added/set/removed, and the full (possibly updated) config can be written
back out for provenance (infra/Config.h:361-367).

The reference staggers file reads across MPI tasks in groups of 20
(infra/Config.cpp:95-100) and broadcasts the parsed text; under JAX's
single-controller SPMD model one host read suffices, so that machinery
disappears by construction.

Schema-compatible with the reference's ``configs/Default.yml`` (the root
document holds a single ``Omega:`` group).

PyYAML is needed only to read or write YAML text (`from_yaml`, `read_all`,
`write`, `to_yaml`) and is imported there: the defaults are a Python dict
and a Config is built from a dict directly, so a run configured in Python
needs no YAML package.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Iterator, List, Optional

from omega_tpu_torch.infra.errors import ConfigError

_SENTINEL = object()

# YAML 1.1 only tags floats whose exponent carries a sign ("1.0e+3");
# yaml-cpp (the reference's parser) also accepts "1.0e3". Recognize those.
_UNSIGNED_EXP_FLOAT = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)[eE]\d+$")


def _yaml():
    """PyYAML, imported where YAML text is read or written."""
    try:
        import yaml
    except ImportError as e:
        raise ConfigError("reading or writing YAML config text needs PyYAML, "
                          "which is not installed; build the Config from a "
                          "dict instead (Config('Omega', {...}))") from e
    return yaml


def _normalize(node):
    if isinstance(node, dict):
        return {k: _normalize(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_normalize(v) for v in node]
    if isinstance(node, str) and _UNSIGNED_EXP_FLOAT.match(node):
        return float(node)
    return node


class Config:
    """A (sub-)configuration: a named node in the YAML tree.

    Typed accessors mirror the reference's get/set/add/remove families
    (infra/Config.h:88-367); a missing key or a type mismatch raises
    ConfigError (the analogue of the reference's returned Error codes).
    """

    def __init__(self, name: str = "Omega", data: Optional[dict] = None):
        self.name = name
        self._data = {} if data is None else data

    # ---------------- construction ----------------
    @classmethod
    def from_yaml(cls, text: str, root: str = "Omega") -> "Config":
        doc = _normalize(_yaml().safe_load(text) or {})
        if root in doc:
            return cls(root, doc[root])
        return cls(root, doc)

    @classmethod
    def read_all(cls, path: str, root: str = "Omega") -> "Config":
        """Read the full config file (Config::readAll, infra/Config.cpp:95)."""
        with open(path) as f:
            return cls.from_yaml(f.read(), root)

    def write(self, path: str) -> None:
        """Write the full config back out (infra/Config.h:361-367)."""
        with open(path, "w") as f:
            _yaml().safe_dump({self.name: self._data}, f,
                           default_flow_style=False, sort_keys=False)

    def to_yaml(self) -> str:
        return _yaml().safe_dump({self.name: self._data},
                              default_flow_style=False, sort_keys=False)

    # ---------------- queries ----------------
    def exists(self, key: str) -> bool:
        return key in self._data

    def is_group(self, key: str) -> bool:
        return isinstance(self._data.get(key), dict)

    def keys(self) -> List[str]:
        return list(self._data)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    # ---------------- getters ----------------
    def get_group(self, key: str) -> "Config":
        """Retrieve a named sub-configuration."""
        val = self._require(key)
        if not isinstance(val, dict):
            raise ConfigError(f"config entry {key!r} in group {self.name!r} "
                              f"is a value, not a group")
        return Config(key, val)

    def get(self, key: str, default: Any = _SENTINEL) -> Any:
        if key not in self._data:
            if default is _SENTINEL:
                raise ConfigError(f"config key {key!r} not found in group "
                                  f"{self.name!r}")
            return default
        val = self._data[key]
        return Config(key, val) if isinstance(val, dict) else val

    def get_bool(self, key: str, default=None) -> bool:
        return self._typed(key, bool, default)

    def get_int(self, key: str, default=None) -> int:
        val = self._maybe(key, default)
        if isinstance(val, bool) or not isinstance(val, int):
            raise ConfigError(f"config key {key!r} is not an integer: {val!r}")
        return val

    def get_float(self, key: str, default=None) -> float:
        val = self._maybe(key, default)
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise ConfigError(f"config key {key!r} is not a number: {val!r}")
        return float(val)

    def get_str(self, key: str, default=None) -> str:
        return self._typed(key, str, default)

    def get_list(self, key: str, default=None) -> list:
        return self._typed(key, list, default)

    # typed vector accessors (the reference's getVector<I4/R8/bool/string>
    # overloads, infra/Config.h:190-240): every element must match
    def _typed_list(self, key: str, typ, default, cast=None) -> list:
        vals = self._typed(key, list, default)
        name = typ.__name__ if isinstance(typ, type) else "number"
        out = []
        for v in vals:
            if ((isinstance(v, bool) and typ is not bool)
                    or not isinstance(v, typ)):
                raise ConfigError(f"config list {key!r} element {v!r} is "
                                  f"not {name}")
            out.append(v if cast is None else cast(v))
        return out

    def get_int_list(self, key: str, default=None) -> list:
        return self._typed_list(key, int, default)

    def get_float_list(self, key: str, default=None) -> list:
        return self._typed_list(key, (int, float), default, float)

    def get_bool_list(self, key: str, default=None) -> list:
        return self._typed_list(key, bool, default)

    def get_str_list(self, key: str, default=None) -> list:
        return self._typed_list(key, str, default)

    # ---------------- setters ----------------
    def add(self, key: str, value: Any) -> None:
        """Add a new entry; error if it already exists (reference `add`)."""
        if key in self._data:
            raise ConfigError(f"config key {key!r} already exists in group "
                              f"{self.name!r}; use set")
        self._set(key, value)

    def set(self, key: str, value: Any) -> None:
        """Update an existing entry; error if missing (reference `set`)."""
        if key not in self._data:
            raise ConfigError(f"config key {key!r} not found in group "
                              f"{self.name!r}; use add")
        self._set(key, value)

    def update(self, key: str, value: Any) -> None:
        """Add-or-set."""
        self._set(key, value)

    def remove(self, key: str) -> None:
        if key not in self._data:
            raise ConfigError(f"config key {key!r} not found in group "
                              f"{self.name!r}")
        del self._data[key]

    def add_group(self, key: str) -> "Config":
        if key in self._data:
            raise ConfigError(f"config group {key!r} already exists")
        self._data[key] = {}
        return Config(key, self._data[key])

    # ---------------- helpers ----------------
    def _set(self, key: str, value: Any) -> None:
        self._data[key] = value._data if isinstance(value, Config) else value

    def _require(self, key: str) -> Any:
        if key not in self._data:
            raise ConfigError(f"config key {key!r} not found in group "
                              f"{self.name!r}")
        return self._data[key]

    def _maybe(self, key: str, default) -> Any:
        if key not in self._data and default is not None:
            return default
        return self._require(key)

    def _typed(self, key: str, typ, default) -> Any:
        val = self._maybe(key, default)
        if not isinstance(val, typ):
            raise ConfigError(f"config key {key!r} in group {self.name!r} has "
                              f"type {type(val).__name__}, expected "
                              f"{typ.__name__}")
        return val

    def as_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def __repr__(self) -> str:
        return f"Config({self.name!r}, {len(self._data)} entries)"


DEFAULT_CONFIG = {
    "Timing": {"Level": 2, "AutoFence": True, "TimingBarriers": False,
               "PrintAllRanks": False},
    "TimeIntegration": {
        "CalendarType": "No Leap",
        "TimeStepper": "Forward-Backward",
        "TimeStep": "0000_00:10:00",
        "StartTime": "0001-01-01_00:00:00",
        "StopTime": "0001-01-01_02:00:00",
        "RunDuration": "none",
    },
    "Decomp": {"HaloWidth": 3, "DecompMethod": "SFC"},
    "IO": {"IODefaultFormat": "NetCDF3"},
    "State": {"NTimeLevels": 2},
    "Advection": {"FluxThicknessType": "Center", "FluxTracerType": "Center"},
    "WindStress": {"InterpType": "Isotropic"},
    "VertCoord": {"MovementWeightType": "Uniform"},
    "Tendencies": {
        "ThicknessFluxTendencyEnable": True,
        "PVTendencyEnable": True,
        "KETendencyEnable": True,
        "SSHTendencyEnable": True,
        "VelDiffTendencyEnable": True,
        "ViscDel2": 1.0e3,
        "VelHyperDiffTendencyEnable": True,
        "ViscDel4": 1.2e11,
        "DivFactor": 1.0,
        "WindForcingTendencyEnable": False,
        "Density0": 1026.0,
        "BottomDragTendencyEnable": False,
        "BottomDragCoeff": 0.0,
        "TracerHorzAdvTendencyEnable": True,
        "TracerDiffTendencyEnable": True,
        "EddyDiff2": 10.0,
        "TracerHyperDiffTendencyEnable": True,
        "EddyDiff4": 0.0,
        "UseCustomTendency": False,
        "ManufacturedSolutionTendency": False,
    },
    "Tracers": {"Base": ["Temperature", "Salinity"]},
    "Eos": {"EosType": "linear",
            "Linear": {"DRhoDT": -0.2, "DRhoDS": 0.8, "RhoT0S0": 1000.0}},
    "IOStreams": {},
    "ManufacturedSolution": {"WavelengthX": 5.0e6, "WavelengthY": 4.33013e6,
                             "Amplitude": 1.0},
}


def default_config() -> Config:
    """The built-in default configuration (mirrors configs/Default.yml);
    a fresh copy on every call."""
    return Config("Omega", copy.deepcopy(DEFAULT_CONFIG))
