"""Shared helpers of the tests/test_torch_*.py files: the same mesh,
configuration and seeded state in the JAX package and in the PyTorch port.

Inputs are made with numpy and handed to both packages; the JAX side stays
on the CPU in float64 (tests/conftest.py)."""

import dataclasses
import functools

import numpy as np
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig as JModelConfig
from omega_tpu.core import ModelState as JModelState
from omega_tpu.core import TendencyConfig as JTendencyConfig
from omega_tpu.core import VertMixConfig as JVertMixConfig
from omega_tpu.mesh import planar_hex_mesh as jax_planar_hex_mesh

from omega_tpu_torch import convert

MESHES = {"16x8": (16, 8), "32x16": (32, 16), "24x12": (24, 12)}

_COMPILED = {}
# these tests compile far more than they run: no optimisation passes
_CHEAP_COMPILE = {"xla_backend_optimization_level": 0,
                  "xla_llvm_disable_expensive_passes": True}


def jax_call(key, fn, *args):
    """fn(*args) on the JAX side as one jitted program, compiled once per
    (key, argument shapes) and kept for the tests that follow. `key` names
    everything `fn` closes over (mesh size, configuration). One program per
    call costs a fraction of what op-by-op dispatch spends compiling every
    primitive anew for every shape."""
    leaves = jax.tree_util.tree_leaves(args)
    k = (key, tuple((np.shape(a), str(np.result_type(a))) for a in leaves))
    if k not in _COMPILED:
        _COMPILED[k] = jax.jit(fn).lower(*args).compile(
            compiler_options=_CHEAP_COMPILE)
    return _COMPILED[k](*args)


@functools.lru_cache(maxsize=None)
def jax_mesh(nx, ny, dc=5000.0, f0=1e-4, beta=0.0, bottom_depth=1000.0):
    return jax_planar_hex_mesh(nx, ny, dc=dc, f0=f0, beta=beta,
                               bottom_depth=bottom_depth)


_PORT_MESHES = {}


def port_mesh(jmesh, dtype=torch.float64):
    """The JAX-side mesh carried into the port through convert (numpy and
    dicts only), on the CPU. One port mesh per JAX mesh object and type."""
    key = (id(jmesh), dtype)
    if key not in _PORT_MESHES:
        arrays = {n: np.asarray(getattr(jmesh, n))
                  for n in convert.ARRAY_FIELDS}
        meta = {n: getattr(jmesh, n) for n in convert.META_FIELDS}
        _PORT_MESHES[key] = (jmesh, convert.mesh_from_numpy(
            arrays, meta, device="cpu", dtype=dtype))
    return _PORT_MESHES[key][1]


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


def stratified_fields(jmesh, K, seed=0, u_amp=0.1):
    """(h, u, tracers) numpy float64 with tracers (T, S): T decreasing
    downward plus noise, S near 35, and a sheared u, so that the PP81
    Richardson number spans stable and unstable interfaces (the state of
    the JAX suite's own PP81 test)."""
    rng = np.random.default_rng(seed)
    kx = 2 * np.pi / jmesh.x_period
    ssh = np.sin(kx * np.asarray(jmesh.x_cell))
    h = (1000.0 + ssh[:, None]) / K * np.ones((1, K))
    T = 10.0 + 2.0 * np.arange(K)[::-1] / K \
        + 0.1 * rng.standard_normal((jmesh.ncells, K))
    S = 35.0 + 0.1 * rng.standard_normal((jmesh.ncells, K))
    u = u_amp * rng.standard_normal((jmesh.nedges, K))
    return h, u, np.stack([T, S])


def wind_fields(jmesh):
    """(zonal, merid) cell wind stress, numpy float64: zonal varies in y."""
    ky = 2 * np.pi / jmesh.y_period
    return (0.1 * np.sin(ky * np.asarray(jmesh.y_cell)),
            0.05 * np.ones(jmesh.ncells))


def jax_wind(wind):
    return tuple(jnp.asarray(w) for w in wind)


def port_wind(wind, dtype=torch.float64):
    return convert.wind_from_numpy(*wind, device="cpu", dtype=dtype)


# the configurations of the science slice, after the JAX suite's own
# (tests/test_structured.py): option name -> flagship_cfg keywords
WIND_DRAG = dict(wind_forcing=True, bottom_drag=True, bottom_drag_coeff=3.0e-3)
SCIENCE_CONFIGS = {
    "upwind": dict(flux_thickness_type="upwind", flux_tracer_type="upwind"),
    "upwind_thickness": dict(flux_thickness_type="upwind"),
    "upwind_tracer": dict(flux_tracer_type="upwind"),
    "wind_drag": dict(tendencies=WIND_DRAG),
    "pp81_wind_drag": dict(
        vert_mix=JVertMixConfig(enabled=True, scheme="pp81", nu0=1e-2,
                                alpha=5.0, n_exp=2, temp_index=0,
                                salt_index=1),
        tendencies=WIND_DRAG),
    "pp81_unstratified": dict(
        vert_mix=JVertMixConfig(enabled=True, scheme="pp81", n_exp=3)),
    "vmix_wind_drag": dict(
        vert_mix=JVertMixConfig(enabled=True, kappa_tracer=1e-3,
                                kappa_momentum=1e-2),
        tendencies=WIND_DRAG),
    "all": dict(
        flux_thickness_type="upwind", flux_tracer_type="upwind",
        vert_mix=JVertMixConfig(enabled=True, scheme="pp81", temp_index=0,
                                salt_index=1),
        tendencies=WIND_DRAG),
}


def science_cfg(name, K, L=2):
    kw = dict(SCIENCE_CONFIGS[name])
    return flagship_cfg(K, L, tendencies=dict(kw.pop("tendencies", {})), **kw)


def jax_state(h, u, tr):
    return JModelState(h=jnp.asarray(h), u=jnp.asarray(u),
                       tracers=jnp.asarray(tr))


def port_state(h, u, tr, dtype=torch.float64):
    return convert.state_from_numpy(h, u, tr, device="cpu", dtype=dtype)


def tt(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)
