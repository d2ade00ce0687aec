"""The port's quantizer schedule and censor test against the JAX package's.

The Eq. (18) bit schedule must agree exactly: one bit of difference changes
every later step size of a worker."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import censoring as jcens
from repro.core import quantization as jquant
from repro_torch.core import censoring as cens
from repro_torch.core import quantization as quant

B_PREV = [1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 15.0, 16.0]
RANGES = [0.0, 1e-13, 1e-12, 3e-7, 0.01, 0.37, 0.99, 1.0, 1.01, 2.5, 1e3]
INIT = [0.0, 1.0]


def schedule_grid():
    rows = list(itertools.product(B_PREV, RANGES, RANGES, INIT))
    b, r, rp, ini = (np.asarray(c, np.float32) for c in zip(*rows))
    return b, r, rp, ini


@pytest.mark.parametrize("omega,b0,b_max", [(0.99, 2, 16), (0.9, 3, 12),
                                            (0.5, 1, 8)])
def test_bit_schedule_table_matches_jax_exactly(omega, b0, b_max):
    b, r, rp, ini = schedule_grid()
    got = quant.bit_schedule(torch.from_numpy(b), torch.from_numpy(r),
                             torch.from_numpy(rp), torch.from_numpy(ini),
                             omega, b0, b_max)
    want = jquant.bit_schedule(jnp.asarray(b), jnp.asarray(r),
                               jnp.asarray(rp), jnp.asarray(ini),
                               omega, b0, b_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_required_bits_table_matches_jax_exactly():
    b, r, rp, ini = schedule_grid()
    got = quant.required_bits(torch.from_numpy(b), torch.from_numpy(r),
                              torch.from_numpy(rp), 0.99,
                              torch.from_numpy(ini), 2, 16)
    want = jquant.required_bits(jnp.asarray(b), jnp.asarray(r),
                                jnp.asarray(rp), 0.99, jnp.asarray(ini),
                                2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= set(np.arange(1.0, 17.0))


def test_stochastic_round_matches_jax():
    rng = np.random.default_rng(0)
    c = (10 * rng.standard_normal(4096)).astype(np.float32)
    u = rng.uniform(size=4096).astype(np.float32)
    got = quant.stochastic_round(torch.from_numpy(c), torch.from_numpy(u))
    want = jquant.stochastic_round(jnp.asarray(c), jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_config_defaults_and_validation():
    assert quant.QuantConfig() == quant.QuantConfig(b0=2, omega=0.99,
                                                    b_max=16, b_overhead=64)
    for bad in (dict(omega=1.0), dict(omega=0.0), dict(b0=0),
                dict(b0=17, b_max=16)):
        with pytest.raises(ValueError):
            quant.QuantConfig(**bad)


@pytest.mark.parametrize("tau0,xi", [(1.0, 0.8), (5.0, 0.97), (0.3, 0.5)])
def test_threshold_matches_jax(tau0, xi):
    cfg, jcfg = cens.CensorConfig(tau0, xi), jcens.CensorConfig(tau0, xi)
    for k in range(0, 300, 7):
        got = float(cens.threshold(cfg, k))
        want = float(jcens.threshold(jcfg, jnp.asarray(k)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0)


def test_censor_mask_matches_jax():
    rng = np.random.default_rng(1)
    last = rng.standard_normal((24, 50)).astype(np.float32)
    cand = (last + 0.3 * rng.standard_normal((24, 50))).astype(np.float32)
    for tau0, k in ((0.0, 3), (1.0, 0), (2.0, 1), (2.0, 4), (9.0, 2)):
        got = cens.censor_mask(torch.from_numpy(last), torch.from_numpy(cand),
                               cens.CensorConfig(tau0=tau0), k)
        want = jcens.censor_mask(jnp.asarray(last), jnp.asarray(cand),
                                 jcens.CensorConfig(tau0=tau0),
                                 jnp.asarray(k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_group_thresholds_and_masks_match_jax():
    tau = 0.7
    dims, total = (3, 47, 100), 150
    got = cens.group_thresholds(torch.tensor(tau), dims, total)
    want = jcens.group_thresholds(jnp.asarray(tau), dims, total)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    assert float((got ** 2).sum()) == pytest.approx(tau ** 2, rel=1e-6)
    change = np.random.default_rng(2).uniform(0, 1, (8, 3)).astype(
        np.float32)
    gm = cens.group_censor_mask(torch.from_numpy(change), got)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(
        jcens.group_censor_mask(jnp.asarray(change), want)))
    timeout = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    cm = gm.amax(dim=-1)
    got_tx = cens.compose_tx_mask(torch.from_numpy(timeout), cm, gm)
    want_tx = jcens.compose_tx_mask(jnp.asarray(timeout),
                                    jnp.asarray(cm.numpy()),
                                    jnp.asarray(gm.numpy()))
    for g, w in zip(got_tx, want_tx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_censor_config_validation():
    assert not cens.CensorConfig().enabled
    assert cens.CensorConfig(tau0=1.0).enabled
    for bad in (dict(tau0=-1.0), dict(xi=1.0), dict(xi=0.0)):
        with pytest.raises(ValueError):
            cens.CensorConfig(**bad)
