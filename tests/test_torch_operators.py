"""Each TRiSK operator of the port against the JAX one, on the structured
(shift) branch and on the gather branch; atol 1e-12 (sums of a few O(1)
terms in float64, taken in another order by the two einsums)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import MESHES, jax_mesh, port_mesh, tt

from omega_tpu.ops import trisk as jtrisk

from omega_tpu_torch.ops import trisk

K, L = 4, 2

# name -> (argument kind, takes the JAX/torch module and returns a callable)
OPS = {
    "div": ("u", lambda t: t.div_cell),
    "grad": ("h", lambda t: t.grad_edge),
    "curl": ("u", lambda t: t.curl_vertex),
    "tang": ("u", lambda t: t.tangential_edge),
    "tang_stacked": ("u2", lambda t: t.tangential_edge),
    "ke": ("u", lambda t: t.ke_cell),
    "kite": ("h", lambda t: t.cell_to_vertex_kite),
    "signed": ("u", lambda t: t.edge_to_cell_signed),
    "cdiff": ("h", lambda t: t.cell_diff_on_edge),
    "cmean": ("h", lambda t: t.cell_mean_on_edge),
    "cmean_tracers": ("tr", lambda t: t.cell_mean_on_edge),
    "vdiff": ("v", lambda t: t.vertex_diff_on_edge),
    "vmean_stacked": ("v2", lambda t: t.vertex_mean_on_edge),
    "cell_pair0": ("h", lambda t: lambda m, f: t.cell_pair_on_edge(m, f)[0]),
    "cell_pair1": ("tr", lambda t: lambda m, f: t.cell_pair_on_edge(m, f)[1]),
    "vertex_pair0": ("v", lambda t: lambda m, f: t.vertex_pair_on_edge(m, f)[0]),
    "vertex_pair1": ("v", lambda t: lambda m, f: t.vertex_pair_on_edge(m, f)[1]),
    "div_pos": ("u", lambda t: t.div_cell_pos),
    "div_neg": ("u", lambda t: t.div_cell_neg),
    "extrema_max": ("h", lambda t: lambda m, f: t.cell_neighbor_extrema(m, f)[0]),
    "extrema_min": ("h", lambda t: lambda m, f: t.cell_neighbor_extrema(m, f)[1]),
    "aniso": ("h", lambda t: t.interp_cell_to_edge_aniso),
    "aniso_1d": ("h1", lambda t: t.interp_cell_to_edge_aniso),
    "iso": ("h", lambda t: t.interp_cell_to_edge_iso),
    "iso_1d": ("h1", lambda t: t.interp_cell_to_edge_iso),
}


def _arg(kind, jm, rng):
    C, E, V = jm.ncells, jm.nedges, jm.nvertices
    shape = {"h": (C, K), "h1": (C,), "u": (E, K), "u2": (2, E, K),
             "tr": (L, C, K), "v": (V, K), "v2": (2, V, K)}[kind]
    return rng.standard_normal(shape)


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    jm = jax_mesh(*MESHES[request.param])
    pm = port_mesh(jm)
    return {"structured": (jm, pm),
            "gather": (dataclasses.replace(jm, structured_nx=0),
                       dataclasses.replace(pm, structured_nx=0))}


@pytest.mark.parametrize("branch", ["structured", "gather"])
@pytest.mark.parametrize("name", OPS)
def test_operator_matches_jax(meshes, name, branch):
    jm, pm = meshes[branch]
    kind, pick = OPS[name]
    f = _arg(kind, jm, np.random.default_rng(7))
    ref = np.asarray(pick(jtrisk)(jm, jnp.asarray(f)))
    out = pick(trisk)(pm, tt(f)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_col_is_scalar_on_structured_and_column_on_gather(meshes):
    _, pm = meshes["structured"]
    assert isinstance(trisk.col(pm, "dc_edge"), float)
    _, pg = meshes["gather"]
    assert tuple(trisk.col(pg, "dc_edge").shape) == (pg.nedges, 1)
