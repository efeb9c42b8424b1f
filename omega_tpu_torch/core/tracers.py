"""Tracer catalog and selection.

Rewrite of ocn/Tracers.h:14-51 + ocn/TracerDefs.inc:24-44: a compile-time
catalog of all known tracers with CF metadata, filtered at init by the
config's tracer groups (``Tracers: {Base: [...], Debug: [...]}``); selected
tracers are stored contiguously in one (tracer, cell, layer) array so each
config *group* is a (start, length) range over the tracer axis and
name <-> index maps are plain dicts.

Device data layout is unchanged from ModelState.tracers; this module owns
only the host-side catalog/bookkeeping and Field registration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from omega_tpu_torch.infra.errors import ConfigError
from omega_tpu_torch.infra.field import FieldRegistry


@dataclasses.dataclass(frozen=True)
class TracerDef:
    name: str
    description: str
    units: str
    std_name: str
    valid_min: float
    valid_max: float
    fill_value: float = 1.0e33


# All known tracers (the TracerDefs.inc catalog; CF names per convention)
TRACER_CATALOG: Dict[str, TracerDef] = {
    t.name: t for t in [
        TracerDef("Temperature", "Conservative Temperature", "degree_C",
                  "sea_water_conservative_temperature", -273.15, 100.0),
        TracerDef("Salinity", "Absolute Salinity", "g kg-1",
                  "sea_water_absolute_salinity", 0.0, 50.0),
        TracerDef("Debug1", "Debug Tracer 1", "none", "none", 0.0, 100.0),
        TracerDef("Debug2", "Debug Tracer 2", "none", "none", 0.0, 100.0),
        TracerDef("Debug3", "Debug Tracer 3", "none", "none", 0.0, 100.0),
    ]
}

# default group membership (configs/Default.yml Tracers section)
DEFAULT_GROUPS = {
    "Base": ["Temperature", "Salinity"],
    "Debug": ["Debug1", "Debug2", "Debug3"],
}

INDX_INVALID = -1


@dataclasses.dataclass(frozen=True)
class TracerSet:
    """Selected tracers: contiguous index space with group ranges
    (ocn/Tracers.h:48-51 group model)."""
    names: Tuple[str, ...]
    index: Dict[str, int]
    groups: Dict[str, Tuple[int, int]]    # group -> (start, length)

    @property
    def ntracers(self) -> int:
        return len(self.names)

    def get_index(self, name: str) -> int:
        return self.index.get(name, INDX_INVALID)

    def group_range(self, group: str) -> Tuple[int, int]:
        """Tracers::getGroupRange — (start, length) over the tracer axis."""
        if group not in self.groups:
            raise ConfigError(f"unknown tracer group {group!r}")
        return self.groups[group]

    def defs(self) -> List[TracerDef]:
        return [TRACER_CATALOG[n] for n in self.names]


def select_tracers(group_spec: Dict[str, Sequence[str]]) -> TracerSet:
    """Build the selected tracer set from the config ``Tracers:`` mapping.

    Groups are laid out contiguously in declaration order so each group is
    a dense (start, len) range (Tracers::init, ocn/Tracers.cpp:41).
    """
    names: List[str] = []
    groups: Dict[str, Tuple[int, int]] = {}
    for group, members in group_spec.items():
        start = len(names)
        for m in members:
            if m not in TRACER_CATALOG:
                raise ConfigError(f"unknown tracer {m!r} in group {group!r}; "
                                  f"catalog has {sorted(TRACER_CATALOG)}")
            if m in names:
                raise ConfigError(f"tracer {m!r} selected twice")
            names.append(m)
        groups[group] = (start, len(names) - start)
    return TracerSet(names=tuple(names),
                     index={n: i for i, n in enumerate(names)},
                     groups=groups)


def register_tracer_fields(reg: FieldRegistry, tset: TracerSet,
                           cell_dim: str = "NCells",
                           vert_dim: str = "NVertLayers") -> None:
    """Register one Field per selected tracer plus the 'Tracers' group
    (per-tracer Field registration, ocn/Tracers.cpp)."""
    if not reg.group_exists("Tracers"):
        reg.create_group("Tracers")
    for d in tset.defs():
        if not reg.exists(d.name):
            reg.create(d.name, description=d.description, units=d.units,
                       std_name=d.std_name, valid_min=d.valid_min,
                       valid_max=d.valid_max, fill_value=d.fill_value,
                       dim_names=(cell_dim, vert_dim), time_dependent=True)
        reg.add_to_group("Tracers", d.name)
