"""Manufactured-solution forcing (Bishnu et al. 2024) for convergence tests.

Counterpart of ocn/CustomTendencyTerms.h:34-84 / .cpp. The exact solution
on a doubly periodic plane with flat bottom H0 and constant f is
    h(x,y,t)      = H0 + eta0 sin(kx x + ky y - omega t)
    u_east = v_north = eta0 cos(kx x + ky y - omega t)
    omega = sqrt(g H0 (kx^2 + ky^2))
and the forcing terms below make it an exact solution of the nonlinear
shallow-water equations. Fields come out on the mesh's device and type.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from omega_tpu_torch import constants
from omega_tpu_torch.core.config import ModelConfig
from omega_tpu_torch.mesh.horz_mesh import HorzMesh


@dataclasses.dataclass(frozen=True)
class ManufacturedParams:
    h0: float
    eta0: float
    kx: float
    ky: float
    ang_freq: float


def make_params(cfg: ModelConfig, h0: float) -> ManufacturedParams:
    kx = 2.0 * constants.PI / cfg.manufactured.wavelength_x
    ky = 2.0 * constants.PI / cfg.manufactured.wavelength_y
    ang = math.sqrt(h0 * cfg.gravity * (kx * kx + ky * ky))
    return ManufacturedParams(h0=h0, eta0=cfg.manufactured.amplitude,
                              kx=kx, ky=ky, ang_freq=ang)


def exact_ssh(p: ManufacturedParams, x, y, t):
    return p.eta0 * torch.sin(p.kx * x + p.ky * y - p.ang_freq * t)


def exact_normal_velocity(p: ManufacturedParams, mesh: HorzMesh, t):
    phase = (p.kx * mesh.x_edge + p.ky * mesh.y_edge - p.ang_freq * t)
    vel = p.eta0 * torch.cos(phase)
    return (torch.cos(mesh.angle_edge) + torch.sin(mesh.angle_edge)) * vel


def thickness_tendency(p: ManufacturedParams, mesh: HorzMesh, t):
    """Forcing added to the h equation (CustomTendencyTerms.cpp:108-143)."""
    phase = p.kx * mesh.x_cell + p.ky * mesh.y_cell - p.ang_freq * t
    ksum = p.kx + p.ky
    src = p.eta0 * (-p.h0 * ksum * torch.sin(phase)
                    - p.ang_freq * torch.cos(phase)
                    + p.eta0 * ksum * torch.cos(2.0 * phase))
    return src[:, None]   # broadcast over K


def velocity_tendency(p: ManufacturedParams, mesh: HorzMesh,
                      cfg: ModelConfig, t):
    """Forcing added to the u equation (CustomTendencyTerms.cpp:148-215)."""
    tc = cfg.tendencies
    g = cfg.gravity
    phase = p.kx * mesh.x_edge + p.ky * mesh.y_edge - p.ang_freq * t
    ksum = p.kx + p.ky
    src0 = (p.ang_freq * torch.sin(phase)
            - 0.5 * p.eta0 * ksum * torch.sin(2.0 * phase))
    U = p.eta0 * ((-mesh.f_edge + g * p.kx) * torch.cos(phase) + src0)
    V = p.eta0 * ((mesh.f_edge + g * p.ky) * torch.cos(phase) + src0)
    kx2, ky2 = p.kx ** 2, p.ky ** 2
    if tc.velocity_diffusion:
        d2 = tc.visc_del2 * p.eta0 * (kx2 + ky2) * torch.cos(phase)
        U = U + d2
        V = V + d2
    if tc.velocity_hyperdiff:
        d4 = tc.visc_del4 * p.eta0 * (kx2 * kx2 + ky2 * ky2 + kx2 * ky2) \
            * torch.cos(phase)
        U = U - d4
        V = V - d4
    normal = torch.cos(mesh.angle_edge) * U + torch.sin(mesh.angle_edge) * V
    return normal[:, None]
