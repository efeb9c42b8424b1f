"""Prognostic model state.

The reference keeps LayerThickness / NormalVelocity as vectors of device
arrays over 2-5 time levels with a circular index (ocn/OceanState.h:78-89)
and all tracers in one (tracer, cell, layer) array per level
(ocn/Tracers.h:48-51). Here the state is one NamedTuple of tensors and the
steppers are state -> state maps; the fused stepper double-buffers its own
stacked copy (ops/megastep.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from omega_tpu_torch import resolve_device
from omega_tpu_torch.mesh.horz_mesh import HorzMesh


class ModelState(NamedTuple):
    h: torch.Tensor        # (C, K)    layer thickness
    u: torch.Tensor        # (E, K)    normal velocity
    tracers: torch.Tensor  # (L, C, K) tracer concentrations


def init_state(mesh: HorzMesh, nvertlayers: int, ntracers: int,
               dtype=torch.float64, device=None) -> ModelState:
    """Resting state: uniform thickness column = bottom depth, zero flow.

    `device=None` means the CUDA device (omega_tpu_torch.default_device)."""
    dev = resolve_device(device)
    depth = torch.as_tensor(mesh.bottom_depth).to(device=dev, dtype=dtype)
    h = (depth / nvertlayers)[:, None].expand(
        mesh.ncells, nvertlayers).contiguous()
    u = torch.zeros((mesh.nedges, nvertlayers), dtype=dtype, device=dev)
    tr = torch.zeros((ntracers, mesh.ncells, nvertlayers), dtype=dtype,
                     device=dev)
    return ModelState(h=h, u=u, tracers=tr)
