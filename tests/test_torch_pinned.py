"""The port's TRiSK operators (ops/trisk.py) against the pinned operator
error constants of the JAX suite (tests/test_pinned_errors.py, after the
reference's HorzOperatorsTest.cpp:33-44,84-95): the discretization errors
of the gradient, divergence and curl on the 48 x 48 planar mesh and of the
gradient and divergence on the icos-16 sphere, at the same RTOL. The
sphere runs through the gather branch and, on the patch-renumbered mesh,
through the patch branch; the planar mesh through its structured
tables. The expected constants are copied with their lines cited."""

import numpy as np
import pytest
import torch

from test_pinned_errors import RTOL

from omega_tpu_torch.mesh import patch_icos_mesh, planar_hex_mesh
from omega_tpu_torch.mesh import spherical_icos_mesh
from omega_tpu_torch.ops import trisk

# tests/test_pinned_errors.py:52-53, 58-59, 63-64 (planar48)
PLANAR = {"grad": (1.3435461112e-3, 1.2502607188e-3),
          "div": (1.2489200649e-3, 1.2489200649e-3),
          "curl": (2.7591945797e-3, 2.7670149948e-3)}
# tests/test_pinned_errors.py:79-80, 85-86 (sphere16)
SPHERE = {"grad": (9.5545970259e-4, 1.0875747029e-3),
          "div": (3.0116770862e-3, 4.4817905990e-3)}


def _norms(a, b):
    return (np.linalg.norm(a - b) / np.linalg.norm(b),
            np.abs(a - b).max() / np.abs(b).max())


def _col(x):
    return torch.as_tensor(np.asarray(x)[:, None], dtype=torch.float64)


@pytest.fixture(scope="module")
def planar48():
    return planar_hex_mesh(48, 48, dc=1.0).to("cpu", torch.float64)


@pytest.fixture(scope="module")
def sphere16():
    m = spherical_icos_mesh(16)
    return {"gather": m.to("cpu", torch.float64),
            "patch": patch_icos_mesh(m, 16).to("cpu", torch.float64)}


@pytest.mark.parametrize("op", PLANAR)
def test_planar_pinned(planar48, op):
    m = planar48
    a = lambda nm: getattr(m, nm).numpy()
    kx = 2 * np.pi / m.x_period
    ky = 2 * np.pi / m.y_period
    xc, yc, xe, ye = a("x_cell"), a("y_cell"), a("x_edge"), a("y_edge")
    xv, yv, ang = a("x_vertex"), a("y_vertex"), a("angle_edge")
    Fe = np.sin(kx * xe) * np.sin(ky * ye) * np.cos(ang)
    if op == "grad":
        psi_c = np.sin(kx * xc) * np.sin(ky * yc)
        gx = kx * np.cos(kx * xe) * np.sin(ky * ye)
        gy = ky * np.sin(kx * xe) * np.cos(ky * ye)
        got = trisk.grad_edge(m, _col(psi_c))
        want = gx * np.cos(ang) + gy * np.sin(ang)
    elif op == "div":
        got = trisk.div_cell(m, _col(Fe))
        want = kx * np.cos(kx * xc) * np.sin(ky * yc)
    else:
        got = trisk.curl_vertex(m, _col(Fe))
        want = -np.sin(kx * xv) * ky * np.cos(ky * yv)
    l2, li = _norms(got[:, 0].numpy(), want)
    np.testing.assert_allclose(l2, PLANAR[op][0], rtol=RTOL)
    np.testing.assert_allclose(li, PLANAR[op][1], rtol=RTOL)


@pytest.mark.parametrize("branch", ["gather", "patch"])
@pytest.mark.parametrize("op", SPHERE)
def test_sphere_pinned(sphere16, op, branch):
    m = sphere16[branch]
    a = lambda nm: getattr(m, nm).numpy()
    R = m.sphere_radius
    latc, lonc = a("lat_cell"), a("lon_cell")
    late, lone, ang = a("lat_edge"), a("lon_edge"), a("angle_edge")
    psi = np.sin(latc) * np.cos(latc) * np.cos(lonc)
    g = trisk.grad_edge(m, _col(psi))
    if op == "grad":
        ge = -np.sin(late) * np.cos(late) * np.sin(lone) / (R * np.cos(late))
        gn = np.cos(2 * late) * np.cos(lone) / R
        got, want = g, ge * np.cos(ang) + gn * np.sin(ang)
    else:
        got, want = trisk.div_cell(m, g), -6.0 / (R * R) * psi
    l2, li = _norms(got[:, 0].numpy(), want)
    np.testing.assert_allclose(l2, SPHERE[op][0], rtol=RTOL)
    np.testing.assert_allclose(li, SPHERE[op][1], rtol=RTOL)
