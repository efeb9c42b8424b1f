"""Shared helpers of the tests/test_torch_*.py files: the same mesh,
configuration and seeded state in the JAX package and in the PyTorch port.

Inputs are made with numpy and handed to both packages; the JAX side stays
on the CPU in float64 (tests/conftest.py)."""

import dataclasses

import numpy as np
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import jax.numpy as jnp

from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.mesh import planar_hex_mesh as jax_planar_hex_mesh

from omega_tpu_torch import convert

MESHES = {"16x8": (16, 8), "32x16": (32, 16), "24x12": (24, 12)}


def jax_mesh(nx, ny, dc=5000.0, f0=1e-4, beta=0.0, bottom_depth=1000.0):
    return jax_planar_hex_mesh(nx, ny, dc=dc, f0=f0, beta=beta,
                               bottom_depth=bottom_depth)


def port_mesh(jmesh, dtype=torch.float64):
    """The JAX-side mesh carried into the port through convert (numpy and
    dicts only), on the CPU."""
    arrays = {n: np.asarray(getattr(jmesh, n)) for n in convert.ARRAY_FIELDS}
    meta = {n: getattr(jmesh, n) for n in convert.META_FIELDS}
    return convert.mesh_from_numpy(arrays, meta, device="cpu", dtype=dtype)


def port_cfg(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def flagship_cfg(K, L, **kw):
    tend = kw.pop("tendencies", {})
    return JModelConfig(nvertlayers=K, ntracers=L,
                        tendencies=JTendencyConfig(visc_del2=1e3,
                                                   visc_del4=1e9, **tend),
                        **kw)


def random_fields(jmesh, K, L, seed=0):
    """(h, u, tracers) numpy float64: positive thickness, small velocity."""
    rng = np.random.default_rng(seed)
    kx = 2 * np.pi / jmesh.x_period
    ky = 2 * np.pi / jmesh.y_period
    ssh = np.sin(kx * np.asarray(jmesh.x_cell)) * \
        np.sin(ky * np.asarray(jmesh.y_cell))
    h = (1000.0 + ssh[:, None]) / K * np.ones((1, K)) \
        + 0.1 * rng.standard_normal((jmesh.ncells, K))
    u = 0.01 * rng.standard_normal((jmesh.nedges, K))
    tr = 10.0 + rng.standard_normal((L, jmesh.ncells, K))
    return h, u, tr


def jax_state(h, u, tr):
    return JModelState(h=jnp.asarray(h), u=jnp.asarray(u),
                       tracers=jnp.asarray(tr))


def port_state(h, u, tr, dtype=torch.float64):
    return convert.state_from_numpy(h, u, tr, device="cpu", dtype=dtype)


def tt(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)
