"""Named array dimensions for IO and metadata.

Rewrite of infra/Dimension.h:27-60: every array dimension used in IO is
registered once by name with its global length; *distributed* dimensions
additionally carry, per local entry, the 0-based global offset that entry
maps to in the global file layout (-1 marks halo/ghost entries excluded
from IO). Non-distributed dimensions (e.g. the vertical) have trivial
offsets.

Instances live in a process-wide registry like the reference's static maps,
but the registry object itself is explicit so tests can build isolated ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from omega_tpu_torch.infra.errors import FieldError


@dataclasses.dataclass(frozen=True)
class Dimension:
    name: str
    global_length: int
    distributed: bool = False
    # local->global offsets for distributed dims; -1 = ghost (excluded)
    offsets: Optional[np.ndarray] = None

    @property
    def local_length(self) -> int:
        return (len(self.offsets) if self.offsets is not None
                else self.global_length)

    def owned_mask(self) -> np.ndarray:
        if self.offsets is None:
            return np.ones(self.global_length, bool)
        return np.asarray(self.offsets) >= 0


class DimensionRegistry:
    def __init__(self):
        self._dims: Dict[str, Dimension] = {}

    def create(self, name: str, global_length: int,
               offsets: Optional[np.ndarray] = None) -> Dimension:
        """Register a dimension (Dimension::create, infra/Dimension.h:27).

        With `offsets` the dimension is distributed: offsets[i] is the
        global index of local entry i, -1 for ghosts.
        """
        if name in self._dims:
            raise FieldError(f"dimension {name!r} already defined")
        dim = Dimension(name=name, global_length=int(global_length),
                        distributed=offsets is not None,
                        offsets=None if offsets is None
                        else np.asarray(offsets, np.int64))
        self._dims[name] = dim
        return dim

    def get(self, name: str) -> Dimension:
        if name not in self._dims:
            raise FieldError(f"dimension {name!r} not defined")
        return self._dims[name]

    def exists(self, name: str) -> bool:
        return name in self._dims

    def destroy(self, name: str) -> None:
        self._dims.pop(name, None)

    def clear(self) -> None:
        self._dims.clear()

    def names(self):
        return list(self._dims)


# process-wide default registry (the reference's static instance map)
_default = DimensionRegistry()


def default_dimensions() -> DimensionRegistry:
    return _default
