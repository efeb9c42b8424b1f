"""The slices as a whole: run_steps of the port against the JAX package's
(the flagship configuration and the science configuration with wind, drag,
upwind fluxes and PP81 vertical mixing), conservation, a float32 run, the
import hygiene of the package, and the device rule."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import (flagship_cfg, jax_mesh, jax_state, jax_wind,
                                port_cfg, port_mesh, port_state, port_wind,
                                random_fields, science_cfg,
                                stratified_fields, wind_fields)

from omega_tpu.stepping import forward_backward_step as jfb
from omega_tpu.stepping import run_steps as jrun_steps

import omega_tpu_torch
from omega_tpu_torch import convert
from omega_tpu_torch.core import ModelState, init_state
from omega_tpu_torch.mesh import planar_hex_mesh
from omega_tpu_torch.stepping import (forward_backward_step, make_stepper,
                                      rk4_step, run_steps)

NX, NY, K, L = 32, 16, 4, 2


@pytest.fixture(scope="module")
def setup():
    jm = jax_mesh(NX, NY)
    jcfg = flagship_cfg(K, L)
    return jm, port_mesh(jm), jcfg, port_cfg(jcfg), random_fields(jm, K, L, 5)


@pytest.fixture(scope="module")
def five_steps(setup):
    jm, pm, jcfg, cfg, fields = setup
    ref = jrun_steps(jm, jcfg, jax_state(*fields), 0.0, 30.0, 5, stepper=jfb)
    out = run_steps(pm, cfg, port_state(*fields), 0.0, 30.0, 5,
                    stepper=forward_backward_step)
    return ref, out


@pytest.mark.parametrize("name,rtol,atol", [("h", 1e-11, 0.0),
                                            ("tracers", 1e-11, 0.0),
                                            ("u", 1e-9, 1e-13)])
def test_run_steps_matches_jax(five_steps, name, rtol, atol):
    """Tolerances of the JAX suite's own full-step equivalence test."""
    ref, out = five_steps
    h, u, tr = convert.state_to_numpy(out)
    got = dict(h=h, u=u, tracers=tr)[name]
    np.testing.assert_allclose(got, np.asarray(getattr(ref, name)),
                               rtol=rtol, atol=atol)


def test_volume_and_tracer_content_conserved(setup, five_steps):
    jm, pm, _, _, fields = setup
    _, out = five_steps
    area = np.asarray(jm.area_cell)[:, None]
    h0, _, tr0 = fields
    h1, _, tr1 = convert.state_to_numpy(out)
    vol0, vol1 = np.sum(area * h0), np.sum(area * h1)
    assert abs(vol1 - vol0) / vol0 < 1e-13
    for l in range(L):
        c0, c1 = np.sum(area * h0 * tr0[l]), np.sum(area * h1 * tr1[l])
        assert abs(c1 - c0) / abs(c0) < 1e-13


def test_generic_loop_and_make_stepper_agree_with_fast_path(setup):
    _, pm, _, cfg, fields = setup
    st = port_state(*fields)
    a = run_steps(pm, cfg, st, 0.0, 30.0, 2)
    b = run_steps(pm, cfg, st, 0.0, 30.0, 2,
                  stepper=make_stepper("Forward-Backward"),
                  halo=lambda s: s)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-14)
    assert make_stepper("rungekutta4") is rk4_step
    with pytest.raises(ValueError):
        make_stepper("leapfrog")


# ---- the science configuration -----------------------------------------

@pytest.fixture(scope="module")
def science():
    jm = jax_mesh(NX, NY)
    jcfg = science_cfg("all", 5)
    return (jm, port_mesh(jm), jcfg, port_cfg(jcfg),
            stratified_fields(jm, 5, seed=9), wind_fields(jm))


@pytest.fixture(scope="module")
def science_3_steps(science):
    jm, pm, jcfg, cfg, fields, wind = science
    ref = jrun_steps(jm, jcfg, jax_state(*fields), 0.0, 30.0, 3, stepper=jfb,
                     wind_stress=jax_wind(wind))
    out = run_steps(pm, cfg, port_state(*fields), 0.0, 30.0, 3,
                    stepper=forward_backward_step,
                    wind_stress=port_wind(wind))
    return ref, out


@pytest.mark.parametrize("name", ["h", "u", "tracers"])
def test_science_run_steps_matches_jax(science_3_steps, name):
    """rtol = atol = 1e-10, the JAX suite's figure for its science runs."""
    ref, out = science_3_steps
    np.testing.assert_allclose(getattr(out, name).numpy(),
                               np.asarray(getattr(ref, name)),
                               rtol=1e-10, atol=1e-10)


def test_science_run_conserves_volume_and_tracer_content(science,
                                                         science_3_steps):
    """Wind and drag move momentum only, vertical mixing conserves the
    thickness-weighted columns: volume and content hold to roundoff."""
    jm, _, _, _, fields, _ = science
    _, out = science_3_steps
    area = np.asarray(jm.area_cell)[:, None]
    h0, _, tr0 = fields
    h1, _, tr1 = convert.state_to_numpy(out)
    assert abs(np.sum(area * h1) - np.sum(area * h0)) / np.sum(area * h0) \
        < 1e-13
    for l in range(2):
        c0, c1 = np.sum(area * h0 * tr0[l]), np.sum(area * h1 * tr1[l])
        assert abs(c1 - c0) / abs(c0) < 1e-13


def test_run_steps_with_wind_equals_per_step_calls(science):
    """The segment loop hands the same stress to every step, through the
    stepper's own signature and through make_stepper's."""
    _, pm, _, cfg, fields, wind = science
    pw = port_wind(wind)
    seg = run_steps(pm, cfg, port_state(*fields), 0.0, 30.0, 3,
                    wind_stress=pw)
    st = port_state(*fields)
    for i in range(3):
        st = forward_backward_step(pm, cfg, st, i * 30.0, 30.0,
                                   wind_stress=pw)
    for a, b in zip(seg, st):
        assert torch.equal(a, b)
    named = run_steps(pm, cfg, port_state(*fields), 0.0, 30.0, 3,
                      stepper=make_stepper("forward_backward"),
                      wind_stress=pw)
    for a, b in zip(named, st):
        assert torch.equal(a, b)
    calm = run_steps(pm, cfg, port_state(*fields), 0.0, 30.0, 3)
    assert float((calm.u[:, 0] - seg.u[:, 0]).abs().max()) > 0


def test_stacked_science_path_equals_the_composed_loop(science):
    """What run_steps does on the card, with the plain versions: the state
    stacked once, the wind plane packed once, three fused steps in two
    buffers; against the composed loop at the fused path's 1e-10."""
    from omega_tpu_torch.ops import megastep
    _, pm, _, cfg, fields, wind = science
    st = port_state(*fields)
    pw = port_wind(wind)
    ref = run_steps(pm, cfg, st, 0.0, 30.0, 3, wind_stress=pw)
    cur = megastep.stack_state(pm, st)
    nxt = cur.new_empty(cur.shape)
    plane = megastep.stack_wind(pm, cfg, pw, st.h.dtype)
    for _ in range(3):
        megastep.fb_megastep_stacked(pm, cfg, cur, 30.0, out=nxt, wind=plane)
        cur, nxt = nxt, cur
    out = megastep.unstack_state(pm, cur, 5, 2, ModelState)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_float32_science_run_is_finite_and_conserves():
    """The science path's dtype: 20 steps in float32 stay finite, keep
    volume and tracer content to float32 roundoff, spin up the top layer."""
    mesh = planar_hex_mesh(16, 16, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    jm = jax_mesh(16, 16)
    cfg = port_cfg(science_cfg("all", 6))
    h, u, tr = stratified_fields(jm, 6, seed=1, u_amp=0.01)
    st = convert.state_from_numpy(h, u, tr, device="cpu",
                                  dtype=torch.float32)
    pw = port_wind(wind_fields(jm), dtype=torch.float32)
    out = run_steps(mesh.to("cpu", torch.float32), cfg, st, 0.0, 30.0, 20,
                    wind_stress=pw)
    assert all(x.dtype == torch.float32 and bool(torch.isfinite(x).all())
               for x in out)
    h0, tr0 = st.h.double(), st.tracers.double()
    h1, tr1 = out.h.double(), out.tracers.double()
    assert abs(h1.sum() - h0.sum()) / h0.sum() < 5e-6
    for l in range(2):
        c0, c1 = (h0 * tr0[l]).sum(), (h1 * tr1[l]).sum()
        assert abs(c1 - c0) / c0 < 5e-6
    assert float((out.u[:, 0] - st.u[:, 0]).abs().max()) > 1e-5


def test_float32_run_conserves_and_tracks_float64():
    """The main path's dtype, in the style of tests/test_f32.py: volume
    and tracer content to f32 roundoff over 50 steps, finite and active,
    ssh within f32-roundoff growth of the f64 trajectory."""
    mesh = planar_hex_mesh(16, 16, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    cfg = port_cfg(flagship_cfg(3, 2))
    kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
    ssh = np.sin(kx * mesh.x_cell) * np.sin(ky * mesh.y_cell)
    h = (1000.0 + ssh[:, None]) / 3 * np.ones((1, 3))
    tr = np.stack([10.0 + np.cos(kx * mesh.x_cell)[:, None] * np.ones((1, 3)),
                   20.0 * np.ones((mesh.ncells, 3))])
    u = np.zeros((mesh.nedges, 3))
    area = mesh.area_cell[:, None]
    outs = {}
    for dtype in (torch.float32, torch.float64):
        st = convert.state_from_numpy(h, u, tr, device="cpu", dtype=dtype)
        out = run_steps(mesh.to("cpu", dtype), cfg, st, 0.0, 30.0, 50)
        assert out.h.dtype == dtype and out.u.dtype == dtype
        outs[dtype] = [x.astype(np.float64)
                       for x in convert.state_to_numpy(out)]
    h32, u32, tr32 = outs[torch.float32]
    h0 = h.astype(np.float32).astype(np.float64)
    tr0 = tr.astype(np.float32).astype(np.float64)
    vol0, vol1 = np.sum(area * h0), np.sum(area * h32)
    assert abs(vol1 - vol0) / vol0 < 5e-6
    c0, c1 = np.sum(area * h0 * tr0[0]), np.sum(area * h32 * tr32[0])
    assert abs(c1 - c0) / c0 < 5e-6
    assert np.isfinite(h32).all() and 0 < np.abs(u32).max() < 1.0
    err = np.abs(h32.sum(-1) - outs[torch.float64][0].sum(-1)).max()
    assert err < 1000.0 * 50 * np.finfo(np.float32).eps, err


def test_init_state_is_resting(setup):
    _, pm, _, _, _ = setup
    st = init_state(pm, K, L, dtype=torch.float64, device="cpu")
    assert isinstance(st, ModelState)
    assert tuple(st.h.shape) == (pm.ncells, K)
    assert tuple(st.tracers.shape) == (L, pm.ncells, K)
    assert torch.all(st.h == 1000.0 / K) and torch.all(st.u == 0)


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        assert omega_tpu_torch.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        omega_tpu_torch.default_device()
    mesh = planar_hex_mesh(16, 8)
    with pytest.raises(RuntimeError):
        mesh.to()
    with pytest.raises(RuntimeError):
        init_state(mesh, 2, 1)
    with pytest.raises(RuntimeError):
        convert.state_from_numpy(np.zeros((4, 2)), np.zeros((12, 2)),
                                 np.zeros((1, 4, 2)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import omega_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    omega_tpu_torch.__path__, 'omega_tpu_torch.')]\n"
        "assert len(names) >= 15, names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'omega_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             omega_tpu_torch.__file__).parent.parent))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_port_runs_without_pyyaml_and_h5py(tmp_path):
    """The card's machine has neither PyYAML nor h5py: with both absent,
    every module of the package imports, the defaults build, and the
    driver writes a NetCDF3 history file from a dict Config; YAML text and
    the HDF5 format raise errors that name what is missing."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "sys.modules['yaml'] = sys.modules['h5py'] = None\n"
        "import torch\n"
        "import omega_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    omega_tpu_torch.__path__, 'omega_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "from omega_tpu_torch.infra import Config, default_config\n"
        "from omega_tpu_torch.infra.errors import OmegaError\n"
        "from omega_tpu_torch import driver\n"
        "from omega_tpu_torch.io.netcdf import read_netcdf, write_netcdf\n"
        "d = default_config().as_dict()\n"
        "assert d['Tendencies']['ViscDel4'] == 1.2e11, d\n"
        "doc = default_config().as_dict()\n"
        "doc['TimeIntegration'].update(TimeStep='0000_00:01:00',\n"
        "    StopTime='0001-01-01_00:02:00')\n"
        "doc['Mesh'] = {'Generate': {'Kind': 'planar', 'Nx': 8, 'Ny': 8,\n"
        "    'Dc': 25000.0, 'F0': 1e-4}}\n"
        "doc['VertCoord']['NVertLayers'] = 2\n"
        "doc['IOStreams'] = {'History': {'Filename': 'hist.$SimTime',\n"
        "    'Mode': 'write', 'Freq': 1, 'FreqUnits': 'minutes',\n"
        "    'Contents': ['State', 'SshCell', 'Tracers']}}\n"
        "tmp = sys.argv[1]\n"
        "m = driver.ocn_init(Config('Omega', doc), directory=tmp,\n"
        "                    device='cpu', dtype=torch.float64)\n"
        "driver.ocn_finalize(driver.ocn_run(m))\n"
        "files = sorted(os.listdir(tmp))\n"
        "assert len(files) == 2, files\n"
        "nc = read_netcdf(os.path.join(tmp, files[-1]))\n"
        "assert nc.get('LayerThickness').shape == (1, 64, 2)\n"
        "for call in (lambda: Config.from_yaml('a: 1'),\n"
        "             lambda: write_netcdf(os.path.join(tmp, 'x.nc'),\n"
        "                 dims={'n': 1}, variables={}, var_dims={},\n"
        "                 fmt='hdf5')):\n"
        "    try:\n"
        "        call()\n"
        "    except OmegaError as e:\n"
        "        assert 'PyYAML' in str(e) or 'HDF5' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error without the package')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'omega_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(
                             omega_tpu_torch.__file__).parent.parent))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
