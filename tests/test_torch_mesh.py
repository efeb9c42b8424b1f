"""The port's mesh generator and shift tables against the JAX package's:
every array bit-equal, every table entry and uniform scalar equal."""

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_mesh, port_mesh

from omega_tpu.ops import structured as jstructured

from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.mesh.horz_mesh import ARRAY_FIELDS, META_FIELDS
from omega_tpu_torch.ops import structured

CASES = {
    "16x8-fplane": dict(nx=16, ny=8, dc=5000.0, f0=1e-4, beta=0.0),
    "32x16-fplane": dict(nx=32, ny=16, dc=5000.0, f0=1e-4, beta=0.0),
    "24x12-beta": dict(nx=24, ny=12, dc=2500.0, f0=1e-4, beta=2e-11),
}
TABLES = ("div_pos", "div_neg", "div", "ke", "signed_div", "curl", "kite",
          "tang", "c0", "c1", "v0", "v1", "cdiff", "cmean", "vdiff",
          "vmean") + tuple(f"coc{j}" for j in range(6))


def _both(case):
    kw = dict(CASES[case])
    nx, ny, dc = kw.pop("nx"), kw.pop("ny"), kw.pop("dc")
    return (jax_mesh(nx, ny, dc=dc, **kw),
            planar_hex_mesh(nx, ny, dc=dc, bottom_depth=1000.0, **kw))


@pytest.mark.parametrize("case", CASES)
def test_mesh_arrays_bit_equal(case):
    jm, pm = _both(case)
    for name in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, name)), getattr(pm, name)
        assert isinstance(b, np.ndarray), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in META_FIELDS:
        assert getattr(jm, name) == getattr(pm, name), name


@pytest.mark.parametrize("case", CASES)
def test_stencil_tables_and_scalars_equal(case):
    jm, pm = _both(case)
    assert pm.structured_scalars == jm.structured_scalars
    has_f = "f_vertex" in dict(pm.structured_scalars)
    assert has_f == (CASES[case]["beta"] == 0.0)
    for name in TABLES:
        key = (pm.structured_nx, pm.structured_ny, pm.structured_dc, name)
        jt, pt = jstructured._TABLE_CACHE[key], structured._TABLE_CACHE[key]
        assert pt[1:3] == jt[1:3], name
        assert pt[0] is not None and pt[0] == jt[0], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_to_casts_float_leaves_only(dtype):
    pm = planar_hex_mesh(16, 8, dc=5000.0, f0=1e-4).to("cpu", dtype)
    for name in ARRAY_FIELDS:
        t = getattr(pm, name)
        assert isinstance(t, torch.Tensor), name
        if t.is_floating_point():
            assert t.dtype == dtype, name
        else:
            assert t.dtype == torch.int32, name
    assert pm.float_dtype == dtype


def test_convert_carries_the_jax_mesh_across():
    jm = jax_mesh(24, 12, beta=2e-11)
    pm = port_mesh(jm)
    for name in ARRAY_FIELDS:
        assert np.array_equal(np.asarray(getattr(jm, name)),
                              getattr(pm, name).numpy()), name
    for name in META_FIELDS:
        assert getattr(jm, name) == getattr(pm, name), name


def test_generator_rejects_bad_sizes():
    with pytest.raises(ValueError):
        planar_hex_mesh(8, 7)
    with pytest.raises(ValueError):
        planar_hex_mesh(3, 8)
