"""Carries a model set-up across from the JAX package.

The system has no trained weights; what a run is made of is the mesh, the
configuration and the state. These functions take numpy arrays and plain
dicts only (the caller does the `np.asarray` / `dataclasses.asdict` on the
JAX side), so this module imports nothing of JAX.

    arrays = {name: np.asarray(getattr(jmesh, name)) for name in ARRAY_FIELDS}
    meta   = {name: getattr(jmesh, name) for name in META_FIELDS}
    mesh   = mesh_from_numpy(arrays, meta, device, dtype)
    cfg    = config_from_dict(dataclasses.asdict(jcfg))
    state  = state_from_numpy(h, u, tracers, device, dtype)
    wind   = wind_from_numpy(zonal, merid, device, dtype)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omega_tpu_torch import resolve_device
from omega_tpu_torch.core.config import (ManufacturedConfig, ModelConfig,
                                         TendencyConfig, VertMixConfig)
from omega_tpu_torch.core.state import ModelState
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS, META_FIELDS, HorzMesh
from omega_tpu_torch.ops import structured, trisk

__all__ = ["ARRAY_FIELDS", "META_FIELDS", "mesh_from_numpy",
           "config_from_dict", "state_from_numpy", "state_to_numpy",
           "wind_from_numpy", "sharded_state_from_numpy"]


def mesh_from_numpy(arrays: dict, meta: dict, device=None,
                    dtype=None) -> HorzMesh:
    """Build the port's HorzMesh from the array leaves (`ARRAY_FIELDS`) and
    static metadata (`META_FIELDS`) of a mesh, then move it to `device`
    (None: the CUDA device) with float leaves cast to `dtype`.

    The uniform scalars and the structured shift tables are rebuilt here
    from the arrays (while they are still host numpy); a
    `structured_scalars` entry in `meta` is ignored."""
    missing = [n for n in ARRAY_FIELDS if n not in arrays]
    if missing:
        raise KeyError(f"mesh arrays missing: {missing}")
    static = {n: meta[n] for n in META_FIELDS
              if n in meta and n != "structured_scalars"}
    host = {}
    for n in ARRAY_FIELDS:
        a = np.asarray(arrays[n])
        host[n] = a.astype(np.float64) if np.issubdtype(
            a.dtype, np.floating) else a.astype(np.int32)
    mesh = HorzMesh(**static, **host)
    if structured.enabled(mesh):
        mesh = dataclasses.replace(
            mesh, structured_scalars=structured.uniform_scalar_table(mesh))
        trisk.warm_structured(mesh)
    return mesh.to(device, dtype)


def config_from_dict(d: dict) -> ModelConfig:
    """ModelConfig from `dataclasses.asdict` of a ModelConfig (nested
    dicts for the `vert_mix`, `tendencies` and `manufactured` groups)."""
    d = dict(d)
    groups = {"vert_mix": VertMixConfig, "tendencies": TendencyConfig,
              "manufactured": ManufacturedConfig}
    for name, cls in groups.items():
        if isinstance(d.get(name), dict):
            d[name] = cls(**d[name])
    return ModelConfig(**d)


def _put(a, dev, dtype):
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def state_from_numpy(h, u, tracers, device=None, dtype=None) -> ModelState:
    """ModelState tensors from numpy arrays (C, K), (E, K), (L, C, K)."""
    dev = resolve_device(device)
    return ModelState(h=_put(h, dev, dtype), u=_put(u, dev, dtype),
                      tracers=_put(tracers, dev, dtype))


def sharded_state_from_numpy(h, u, tracers, devices, dtype=None) -> list:
    """The sharded state of parallel/ (one ModelState a shard, on its
    device) from stacked numpy arrays (S, Cl, K), (S, El, K), (S, L, Cl, K)
    — the JAX package's sharded layout."""
    return [state_from_numpy(h[s], u[s], tracers[s], d, dtype)
            for s, d in enumerate(devices)]


def wind_from_numpy(zonal, merid, device=None, dtype=None):
    """The `wind_stress` argument of the steppers, (zonal, merid) cell
    stresses [N m^-2], from two numpy arrays (C,)."""
    dev = resolve_device(device)
    return _put(zonal, dev, dtype), _put(merid, dev, dtype)


def state_to_numpy(state: ModelState):
    """(h, u, tracers) as host numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in state)
