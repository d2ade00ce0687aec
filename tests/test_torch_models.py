"""The port's xLSTM model against the JAX package's at the smoke config,
with the JAX parameters carried across (``interop.tree_from_numpy``; the
port's own init draws from a ``torch.Generator``, not ``jax.random``).

Tolerances and their reasons:

* float32 activations (``dtype="float32"`` on both sides): logits and
  ``lm_loss`` within rel 1e-5 (summation order of the matrix products and
  the chunked mLSTM contractions), gradients within rel 1e-4 of each
  leaf's largest entry (the backward sums over more terms).
* bfloat16 activations (the config's own dtype): XLA on the CPU keeps
  excess precision between bf16 operations where PyTorch rounds every
  operation, so logits agree only to bf16 resolution: 4e-2 of the largest
  logit, and the loss to 1e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import lm as jlm
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.data import lm
from repro_torch.models import blocks, registry

B, S = 2, 16


def configs(dtype, layers=2):
    """The smoke config, float32 or bf16; 5 layers stack two (mLSTM,
    sLSTM) units on the depth axis and leave one mLSTM under ``rem``."""
    kw = dict(dtype=dtype, num_layers=layers)
    return (base.get_smoke_config("xlstm-125m").with_overrides(**kw),
            jbase.get_smoke_config("xlstm-125m").with_overrides(**kw))


@functools.lru_cache(maxsize=2)
def carried(layers):
    """JAX params of two workers (seeds 0, 1) and the port's copy of them
    with a leading worker axis, plus one batch per worker."""
    _, jcfg = configs("float32", layers)
    jps = [jregistry.init_params(jcfg, jax.random.PRNGKey(s)) for s in (0, 1)]
    flats = [{jax.tree_util.keystr(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(jp)[0]} for jp in jps]
    stacked = {k: np.stack([f[k] for f in flats]) for k in flats[0]}
    ptree = interop.tree_from_numpy(stacked, device="cpu")
    data = lm.SyntheticLM(lm.SyntheticLMConfig(jcfg.vocab_size, S, seed=3))
    raw = data.worker_batch(0, 2, B)
    return jps, ptree, raw


def _jax_batch(raw, w):
    return {k: jnp.asarray(v[w]) for k, v in raw.items()}


def _port_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.parametrize("layers", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_jax(dtype, layers):
    jps, ptree, raw = carried(layers)
    cfg, jcfg = configs(dtype, layers)
    logits = registry.apply_model(ptree, cfg, _port_batch(raw)).float()
    loss, _ = registry.lm_loss(ptree, cfg, _port_batch(raw))
    assert tuple(logits.shape) == (2, B, S, cfg.vocab_size)
    fwd = jax.jit(lambda p, b: (jregistry.apply_model(p, jcfg, b)[0],
                                jregistry.lm_loss(p, jcfg, b)[0]))
    for w in range(2):
        want, want_loss = fwd(jps[w], _jax_batch(raw, w))
        want, want_loss = np.asarray(want, np.float32), float(want_loss)
        scale = np.abs(want).max()
        err = np.abs(logits[w].numpy() - want).max()
        if dtype == "float32":
            assert err <= 1e-5 * scale, (err, scale)
            assert float(loss[w]) == pytest.approx(want_loss, rel=1e-5)
        else:
            assert err <= 4e-2 * scale, (err, scale)
            assert float(loss[w]) == pytest.approx(want_loss, rel=1e-2)


def test_gradients_match_jax():
    """At 5 layers: both unit kinds, the stacked depth axis and ``rem``."""
    jps, ptree, raw = carried(5)
    cfg, jcfg = configs("float32", 5)
    leaves = [x.clone().requires_grad_(True) for x in T.leaves(ptree)]
    losses, _ = registry.lm_loss(T.unflatten(ptree, leaves), cfg,
                                 _port_batch(raw))
    grads = torch.autograd.grad(losses.sum(), leaves)
    jgrad = jax.jit(jax.grad(lambda p, b: jregistry.lm_loss(p, jcfg, b)[0]))
    for w in range(2):
        jg = jgrad(jps[w], _jax_batch(raw, w))
        jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
        for (path, want), got, name in zip(jflat, grads, T.paths(ptree)):
            assert jax.tree_util.keystr(path) == name
            want = np.asarray(want)
            err = np.abs(got[w].numpy() - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-12, (name, err)


def test_synthetic_batches_match_jax():
    cfg = jlm.SyntheticLMConfig(512, 32, seed=7)
    a = lm.SyntheticLM(lm.SyntheticLMConfig(512, 32, seed=7))
    b = jlm.SyntheticLM(cfg)
    for step in (0, 5):
        got, want = a.worker_batch(step, 4, 2), b.worker_batch(step, 4, 2)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    t = lm.model_batch(None, got, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["tokens"].shape == (4, 2, 32)


def test_init_params_draws_the_jax_distributions():
    cfg = base.get_smoke_config("xlstm-125m")
    p = registry.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jregistry.init_params(jbase.get_smoke_config("xlstm-125m"),
                               jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, want), got in zip(jflat, T.leaves(p)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        # same scale per leaf: constants equal, draws within 10% in std
        if want.std() == 0:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.std().item() == pytest.approx(float(want.std()),
                                                     rel=0.1), path


def test_unported_block_kinds_raise():
    """Every kind the JAX package's ``blocks.init`` accepts is ported
    ("xattn" last); an unknown kind raises as the JAX package's does."""
    cfg = base.get_smoke_config("xlstm-125m")
    assert "xattn" in blocks.PORTED_KINDS
    x = torch.zeros(1, 1, 1, 1)
    for call in (lambda: blocks.apply("nope", {}, cfg, x),
                 lambda: blocks.init("nope", None, cfg, "meta"),
                 lambda: blocks.make_cache("nope", cfg, 1, 4)):
        with pytest.raises(ValueError, match="unknown block kind 'nope'"):
            call()
    with pytest.raises(ValueError, match="unknown block kind 'nope'"):
        jblocks.init("nope", jax.random.PRNGKey(0),
                     jbase.get_smoke_config("xlstm-125m"))
