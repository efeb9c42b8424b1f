"""The module of the structured stencil kernel: its plain (roll) version
against the JAX package's roll path and against the Pallas stencil kernel
in interpret mode, for every cached table and leading dims () and (2,).
rtol 0, atol 1e-12: the figures of the JAX suite's own kernel-vs-roll test
(tests/test_structured.py); the sums run in table order in all three."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_call, jax_mesh, port_mesh, tt

from omega_tpu.ops import structured as jstructured
from omega_tpu.ops.pallas_stencil_dma import apply_stencil_dma

from omega_tpu_torch.ops import stencil_kernel, structured

NX, NY, K = 16, 8, 5
TABLES = ("div_pos", "div_neg", "div", "ke", "signed_div", "curl", "kite",
          "tang", "c0", "c1", "v0", "v1", "cdiff", "cmean", "vdiff",
          "vmean") + tuple(f"coc{j}" for j in range(6))


@pytest.fixture(scope="module")
def meshes():
    jm = jax_mesh(NX, NY)
    return jm, port_mesh(jm)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["lead0", "lead2"])
@pytest.mark.parametrize("name", TABLES)
def test_plain_stencil_matches_jax_roll_and_pallas(meshes, name, lead):
    jm, pm = meshes
    key = (NX, NY, jm.structured_dc, name)
    jtab, dst, src = jstructured._TABLE_CACHE[key][:3]
    ptab = structured._TABLE_CACHE[key]
    assert ptab[0] == jtab
    rng = np.random.default_rng(len(name) + len(lead))
    N = jm.ncells * jstructured._NPER[src]
    f = rng.standard_normal(lead + (N, K))

    out = structured.apply_stencil(pm, ptab, tt(f)).numpy()
    ref = np.asarray(jstructured.apply_stencil(jm, (jtab, dst, src),
                                               jnp.asarray(f)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    ker = np.asarray(jax_call(
        ("stencil kernel", name),
        lambda x: apply_stencil_dma(jm, name, x, interpret=True),
        jnp.asarray(f)))
    np.testing.assert_allclose(out, ker, rtol=0, atol=1e-12)


def test_cuda_wrapper_refuses_cpu_tensor_and_cpu_uses_plain(meshes):
    _, pm = meshes
    tab, dst, src = structured._TABLE_CACHE[(NX, NY, pm.structured_dc, "div")]
    f = torch.zeros((3 * NX * NY, K), dtype=torch.float64)
    with pytest.raises(ValueError):
        stencil_kernel.apply_stencil_cuda(tab, 3, 1, NX, NY, f)
    before = stencil_kernel.launches
    structured.apply_stencil(pm, (tab, dst, src), f)
    assert stencil_kernel.launches == before


@pytest.mark.parametrize("ft", [np.float32, np.float64])
def test_entry_packing_groups_by_destination_in_table_order(meshes, ft):
    _, pm = meshes
    tab = structured._TABLE_CACHE[(NX, NY, pm.structured_dc, "tang")][0]
    ent, start = stencil_kernel.pack_entries(tab, 3, ft)
    assert ent.dtype.itemsize == (8 if ft == np.float32 else 16)
    counts = [sum(1 for e in tab if e[0] == t) for t in range(3)]
    assert list(start) == [0] + list(np.cumsum(counts))
    assert len(ent) == len(tab) == 24
    for t in range(3):
        want = [e for e in tab if e[0] == t]
        got = ent[start[t]:start[t + 1]]
        assert [(t, int(g["ts"]), int(g["dj"]), int(g["di_e"]),
                 int(g["di_o"])) for g in got] == [e[:5] for e in want]
        np.testing.assert_array_equal(got["w"],
                                      np.asarray([e[5] for e in want], ft))
