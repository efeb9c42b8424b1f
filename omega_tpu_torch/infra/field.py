"""Field / FieldGroup metadata registry.

Rewrite of infra/Field.h:43-487: every publishable array is registered as a
`Field` carrying CF-convention metadata (units, long/standard name, valid
range, fill value), its dimension names, and time-dependence; the actual
data array is attached (and re-attached as state evolves) separately, so IO
streams are decoupled from the modules that own the data. `FieldGroup` is a
named set of field names referenced by streams ("State", "Tracers",
"Restart"); global `CodeMeta` / `SimMeta` fields hold file-level provenance
attributes (infra/Field.h:36-38).

Data attachment: the reference stores a type-erased shared_ptr<void> to a
Kokkos view (infra/Field.h:80-83); here a field simply holds a reference to
a torch tensor (on the card during a run) or a numpy array; the copy to the
host happens in the IO layer, at write time only. Attaching is cheap and
done once per run segment for time-levelled arrays, mirroring
OceanState::updateTimeLevels re-attachment (ocn/OceanState.cpp:333-365).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from omega_tpu_torch.infra.errors import FieldError

# reserved names for global metadata holders (infra/Field.h:36-38)
CODE_META = "code"
SIM_META = "simulation"


@dataclasses.dataclass
class Field:
    name: str
    description: str = ""
    units: str = ""
    std_name: str = ""
    valid_min: Optional[float] = None
    valid_max: Optional[float] = None
    fill_value: Optional[float] = None
    dim_names: Sequence[str] = ()
    time_dependent: bool = False
    distributed: bool = True
    dtype: Any = None
    data: Any = None                      # attached tensor or numpy array
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ndims(self) -> int:
        return len(self.dim_names)

    def cf_attrs(self) -> Dict[str, Any]:
        """CF attribute dict for file output (infra/Field.h:108-120)."""
        attrs = {}
        if self.description:
            attrs["long_name"] = self.description
        if self.units:
            attrs["units"] = self.units
        if self.std_name:
            attrs["standard_name"] = self.std_name
        if self.valid_min is not None:
            attrs["valid_min"] = self.valid_min
        if self.valid_max is not None:
            attrs["valid_max"] = self.valid_max
        if self.fill_value is not None:
            attrs["_FillValue"] = self.fill_value
        attrs.update(self.meta)
        return attrs


class FieldRegistry:
    """Process-wide field + group registry (the reference's static maps)."""

    def __init__(self):
        self._fields: Dict[str, Field] = {}
        self._groups: Dict[str, List[str]] = {}

    # ---------------- fields ----------------
    def create(self, name: str, *, description: str = "", units: str = "",
               std_name: str = "", valid_min=None, valid_max=None,
               fill_value=None, dim_names: Sequence[str] = (),
               time_dependent: bool = False, distributed: bool = True,
               dtype=None, **meta) -> Field:
        """Field::create (infra/Field.h:43-120)."""
        if name in self._fields:
            raise FieldError(f"field {name!r} already defined")
        f = Field(name=name, description=description, units=units,
                  std_name=std_name, valid_min=valid_min,
                  valid_max=valid_max, fill_value=fill_value,
                  dim_names=tuple(dim_names), time_dependent=time_dependent,
                  distributed=distributed, dtype=dtype, meta=dict(meta))
        self._fields[name] = f
        return f

    def get(self, name: str) -> Field:
        if name not in self._fields:
            raise FieldError(f"field {name!r} not defined")
        return self._fields[name]

    def exists(self, name: str) -> bool:
        return name in self._fields

    def attach(self, name: str, data) -> None:
        """attachFieldData (infra/Field.h:327)."""
        self.get(name).data = data

    def destroy(self, name: str) -> None:
        self._fields.pop(name, None)
        for members in self._groups.values():
            if name in members:
                members.remove(name)

    # ---------------- metadata-only fields ----------------
    def create_meta(self, name: str, **attrs) -> Field:
        """Global non-distributed metadata holder (CodeMeta / SimMeta)."""
        f = self.create(name, distributed=False)
        f.meta.update(attrs)
        return f

    def update_meta(self, name: str, **attrs) -> None:
        self.get(name).meta.update(attrs)

    # ---------------- groups ----------------
    def create_group(self, group: str) -> None:
        if group in self._groups:
            raise FieldError(f"field group {group!r} already defined")
        self._groups[group] = []

    def group_exists(self, group: str) -> bool:
        return group in self._groups

    def add_to_group(self, group: str, *names: str) -> None:
        """FieldGroup::addFieldToGroup (infra/Field.h:402-487)."""
        if group not in self._groups:
            raise FieldError(f"field group {group!r} not defined")
        for n in names:
            if n not in self._fields:
                raise FieldError(f"cannot add unknown field {n!r} to group "
                                 f"{group!r}")
            if n not in self._groups[group]:
                self._groups[group].append(n)

    def group_members(self, group: str) -> List[str]:
        if group not in self._groups:
            raise FieldError(f"field group {group!r} not defined")
        return list(self._groups[group])

    def resolve_contents(self, contents: Sequence[str]) -> List[str]:
        """Expand a stream Contents list of field-or-group names into field
        names (IOStream contents validation, infra/IOStream.cpp:219)."""
        out: List[str] = []
        for item in contents:
            if item in self._groups:
                for n in self._groups[item]:
                    if n not in out:
                        out.append(n)
            elif item in self._fields:
                if item not in out:
                    out.append(item)
            else:
                raise FieldError(f"stream contents entry {item!r} is neither "
                                 f"a field nor a field group")
        return out

    def clear(self) -> None:
        self._fields.clear()
        self._groups.clear()

    def names(self):
        return list(self._fields)

    def groups(self):
        return list(self._groups)


_default = FieldRegistry()


def default_fields() -> FieldRegistry:
    return _default
