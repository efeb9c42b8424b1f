"""The port's single-device reductions (omega_tpu_torch.parallel.reductions)
and online analysis (omega_tpu_torch.analysis) against the JAX package's.

dd_sum, reprod_sum and reprod_sum_f32 must give the JAX package's bits on
the same numpy input; the oracles are those of tests/test_reductions.py
and tests/test_infra.py (accuracy against math.fsum, any permutation and
masked padding the same bits). The energetics of a state agree at 1e-12:
their operators (the port's stencil path against JAX's) sum in different
orders."""

import math

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (forces the JAX CPU backend and x64)

import jax.numpy as jnp

from omega_tpu import analysis as j_analysis
from omega_tpu.parallel import reductions as J
from omega_tpu_torch import analysis as p_analysis
from omega_tpu_torch.parallel import reductions as P

import torch_port_helpers as H


def _ill_conditioned(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)
    x[: n // 2] = -x[n // 2: 2 * (n // 2)][::-1] * (1 + 1e-9)
    return np.float64(x)


def _wide(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
            ).astype(dtype)


INPUTS = {
    "one": lambda: np.array([0.125]),
    "empty_tail_7": lambda: _wide(7, 1),
    "ill_4096": lambda: _ill_conditioned(4096, 3),
    "ill_20001": lambda: _ill_conditioned(20_001),
    "wide_10001": lambda: _wide(10_001, 0),
    "wide_300000": lambda: _wide(300_000, 5),
    "matrix_64x100": lambda: _wide(6400, 6).reshape(64, 100),
    "zeros": lambda: np.zeros(33),
}


def _f(x):
    return float(x)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_sums_bit_equal(name):
    x = INPUTS[name]()
    xj, xp = jnp.asarray(x), torch.as_tensor(x)
    hj, lj = J.dd_sum(xj)
    hp, lp = P.dd_sum(xp)
    assert (_f(hp), _f(lp)) == (_f(hj), _f(lj))
    assert _f(P.reprod_sum(xp)) == _f(J.reprod_sum(xj))
    assert _f(P.global_sum(xp)) == _f(J.global_sum(xj))
    x32 = x.astype(np.float32)
    got32 = P.reprod_sum_f32(torch.as_tensor(x32))
    assert got32.dtype == torch.float32
    assert _f(got32) == _f(J.reprod_sum_f32(jnp.asarray(x32)))
    assert _f(P.global_sum(torch.as_tensor(x32))) == _f(got32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multiplier_and_mask_bit_equal(dtype):
    x, m = _wide(5000, 7, dtype), _wide(5000, 8, dtype)
    mask = np.random.default_rng(9).random(5000) < 0.6
    for kw_j, kw_p in (({"multiplier": jnp.asarray(m)},
                        {"multiplier": torch.as_tensor(m)}),
                       ({"mask": jnp.asarray(mask)},
                        {"mask": torch.as_tensor(mask)}),
                       ({"multiplier": jnp.asarray(m),
                         "mask": jnp.asarray(mask)},
                        {"multiplier": torch.as_tensor(m),
                         "mask": torch.as_tensor(mask)})):
        want = J.global_sum(jnp.asarray(x), **kw_j)
        got = P.global_sum(torch.as_tensor(x), **kw_p)
        assert _f(got) == _f(want)
        hj, lj = J.dd_sum(jnp.asarray(x), **kw_j)
        hp, lp = P.dd_sum(torch.as_tensor(x), **kw_p)
        assert (_f(hp), _f(lp)) == (_f(hj), _f(lj))


def test_oracles_accuracy_permutation_padding():
    """tests/test_reductions.py's oracles on the port."""
    x = _ill_conditioned(20_001)
    got = _f(P.global_sum(torch.as_tensor(x)))
    exact = math.fsum(x)
    assert abs(got - exact) <= 4 * abs(exact) * 2.0 ** -52 + 1e-300
    x = _ill_conditioned(8192, seed=2)
    base = _f(P.global_sum(torch.as_tensor(x)))
    for seed in range(4):
        p = np.random.default_rng(seed).permutation(len(x))
        assert _f(P.global_sum(torch.as_tensor(x[p]))) == base
    x = _ill_conditioned(1000, seed=4)
    base = _f(P.global_sum(torch.as_tensor(x)))
    for pad in (24, 1000, 5000):
        xp = np.concatenate([x, np.full(pad, 7.25)])
        mask = np.concatenate([np.ones(1000, bool), np.zeros(pad, bool)])
        assert _f(P.global_sum(torch.as_tensor(xp),
                               mask=torch.as_tensor(mask))) == base


def test_oracles_f32():
    rng = np.random.default_rng(9)
    x = np.float32(rng.standard_normal(8192)
                   * 10.0 ** rng.integers(-6, 6, 8192))
    base = _f(P.global_sum(torch.as_tensor(x)))
    exact = math.fsum(np.float64(x))
    assert abs(base - exact) <= 4 * abs(exact) * 2.0 ** -23 + 1e-30
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(len(x))
        assert _f(P.global_sum(torch.as_tensor(x[p]))) == base
    xp = np.concatenate([x, np.full(100, 3.25, np.float32)])
    mask = np.concatenate([np.ones(8192, bool), np.zeros(100, bool)])
    assert _f(P.global_sum(torch.as_tensor(xp),
                           mask=torch.as_tensor(mask))) == base


def test_dd_sum_exactness_and_min_max():
    """tests/test_infra.py's reduction cases on the port."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_001) * 10.0 ** rng.integers(-8, 8, 10_001)
    exact = float(np.sum(np.sort(np.float64(x)), dtype=np.longdouble))
    got = _f(P.global_sum(torch.as_tensor(x)))
    assert abs(got - exact) <= 1e-9 * abs(exact)
    x = torch.tensor([3.0, -7.0, 2.0, 100.0], dtype=torch.float64)
    mask = torch.tensor([True, True, True, False])
    assert _f(P.global_min(x, mask=mask)) == -7.0
    assert _f(P.global_max(x, mask=mask)) == 3.0
    assert _f(P.global_min(x)) == -7.0 and _f(P.global_max(x)) == 100.0
    x = torch.arange(6, dtype=torch.float64)
    assert _f(P.global_sum(x, multiplier=torch.full((6,), 2.0),
                           mask=x < 3)) == 6.0
    xi = torch.arange(10, dtype=torch.int64)
    assert int(P.global_sum(xi)) == int(J.global_sum(jnp.arange(10))) == 45


@pytest.mark.parametrize("fn", ["global_sum", "global_min", "global_max",
                                "reprod_sum", "reprod_sum_f32"])
def test_cross_device_axis_raises(fn):
    # the port names shards by list position: a collective axis names
    # nothing and is refused
    with pytest.raises(ValueError, match="no collective axis"):
        getattr(P, fn)(torch.ones(4), axis_name="x")


# ---------------------------------------------------------------- analysis

@pytest.fixture(scope="module")
def planar_case():
    jm = H.jax_mesh(16, 8)
    pm = H.port_mesh(jm)
    h, u, tr = H.random_fields(jm, 3, 2, seed=4)
    return jm, pm, (h, u, tr)


@pytest.mark.parametrize("ssh", ["stacked", "column"])
def test_energetics_against_jax(planar_case, ssh):
    jm, pm, (h, u, tr) = planar_case
    jcfg = H.flagship_cfg(3, 2, ssh_formulation=ssh)
    pcfg = H.port_cfg(jcfg)
    js, ps = H.jax_state(h, u, tr), H.port_state(h, u, tr)
    ref_j = j_analysis.mean_ssh(jm, jcfg, js)
    ref_p = p_analysis.mean_ssh(pm, pcfg, ps)
    assert ref_p == pytest.approx(ref_j, rel=1e-12, abs=1e-12)
    want = j_analysis.energetics(jm, jcfg, js, ref_j)
    got = p_analysis.energetics(pm, pcfg, ps, ref_j)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-9), k
    # the bitwise parts: the same sums of the same numbers
    assert got["volume"] == want["volume"]
    for l in range(2):
        assert got[f"tracer{l}_min"] == want[f"tracer{l}_min"]
        assert got[f"tracer{l}_max"] == want[f"tracer{l}_max"]


def test_energetics_monitor_csv(planar_case, tmp_path):
    jm, pm, (h, u, tr) = planar_case
    jcfg = H.flagship_cfg(3, 2)
    mj = j_analysis.EnergeticsMonitor(jm, jcfg, str(tmp_path / "j.csv"))
    mp = p_analysis.EnergeticsMonitor(pm, H.port_cfg(jcfg),
                                      str(tmp_path / "p.csv"))
    for i, s in enumerate((0.0, 0.5)):
        hh = h + s
        mj.sample(H.jax_state(hh, u, tr), f"t{i}")
        mp.sample(H.port_state(hh, u, tr), f"t{i}")
    lj = open(tmp_path / "j.csv").read().splitlines()
    lp = open(tmp_path / "p.csv").read().splitlines()
    assert lp[0] == lj[0] and len(lp) == len(lj) == 3
    for a, b in zip(lj[1:], lp[1:]):
        va, vb = a.split(","), b.split(",")
        assert va[0] == vb[0]
        np.testing.assert_allclose(np.float64(vb[1:]), np.float64(va[1:]),
                                   rtol=1e-12, atol=1e-9)
