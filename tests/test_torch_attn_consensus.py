"""Consensus training of an attention model through the port: tinyllama-smoke
(``launch.train.run_admm`` and the fleet driver, 4 workers, seq 16, 3
steps) against the JAX package's loops from the same initial parameters
(the JAX init, carried across), and the trainer's defaults against the JAX
CLI's.

The port's attention layer takes the consensus engine's worker axis (x
(W, B, S, D), per-worker weights); the JAX package ``vmap``s one model
over the workers. Tolerances are those of ``test_torch_consensus.py`` (the
xLSTM runs), for the same reasons: float32 activations on both sides;
without quantization the loss history within rel 1e-4 and theta within
1e-4 max|theta| on all but 1e-4 of its elements, every element within
1e-3 max|theta| (Adam divides each gradient by its own running magnitude,
so summation order decides a few near-zero steps); with the JAX draws
injected the bit widths per (worker, group) equal at steps 0 and 1 and the
loss within 1e-3 at every step.
"""
import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import engine as JE
from repro.core.censoring import CensorConfig as JCensor
from repro.core.quantization import QuantConfig as JQuant
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.launch import train
from repro_torch.models import layers, registry
from test_torch_fleet import jax_draws

ARCH = "tinyllama-1.1b"
N, BATCH, SEQ, STEPS = 4, 4, 16, 3
FLEET = ["--mix-backend", "sparse", "--fleet", "--fleet-participation",
         "0.75", "--fleet-staleness", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flags(quantize, fleet=False):
    return ["--arch", ARCH, "--smoke", "--workers", str(N),
            "--batch", str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
            "--local-steps", "2", "--lr", "2e-3", "--xi", "0.999",
            "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1"] + (
        FLEET if fleet else []) + (
        ["--tau0", "5.0"] if quantize else ["--no-quantize", "--tau0", "0"])


def jax_solver(jcfg):
    def grad_fn(theta, batch):
        return jax.vmap(lambda p, b: jax.grad(
            lambda pp: jregistry.lm_loss(pp, jcfg, b)[0])(p))(theta, batch)

    def loss_fn(theta, batch):
        return jnp.mean(jax.vmap(
            lambda p, b: jregistry.lm_loss(p, jcfg, b)[0])(theta, batch))

    return JE.InexactSolver(grad_fn=grad_fn, local_steps=2,
                            local_lr=2e-3), loss_fn


def jax_engine_config(quantize, mix_backend="dense"):
    return JE.EngineConfig(
        rho=0.01, censor=JCensor(tau0=5.0, xi=0.999) if quantize
        else JCensor(), quantize=JQuant(b0=6, omega=0.9995)
        if quantize else None, groups="leaf", mix_backend=mix_backend)


def jax_run_admm(jcfg, quantize):
    """The JAX package's run_admm loop, keeping every step's metrics and
    the final state."""
    graph = JST.worker_graph(N, "random")
    ecfg = jax_engine_config(quantize)
    solver, loss_fn = jax_solver(jcfg)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), one)
    state = JE.init_state(params, ecfg, solver)
    step = jax.jit(JE.make_step(graph, ecfg, solver,
                                extra_metrics=JE.consensus_metrics(loss_fn)))
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, SEQ))
    metrics = []
    for i in range(STEPS):
        raw = data.worker_batch(i, N, BATCH // N)
        batch = jlm.model_batch(jcfg, raw, key=jax.random.PRNGKey(i))
        state, m = step(state, batch, jax.random.PRNGKey(1000 + i))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return one, state, metrics


def jax_run_fleet(jcfg, quantize):
    """The JAX package's ``run_fleet`` at the same settings."""
    graph = JST.worker_graph(N, "random")
    ecfg = jax_engine_config(quantize, mix_backend="sparse")
    solver, loss_fn = jax_solver(jcfg)
    one = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), one)
    args = types.SimpleNamespace(
        steps=STEPS, batch=BATCH, workers=N, seed=0, log_every=1,
        fleet_participation=0.75, fleet_staleness=2, fleet_stale_frac=1.0,
        fleet_churn="", fleet_seed=0, ckpt_dir=None)
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(jcfg.vocab_size, SEQ))
    out = jtrain.run_fleet(jcfg, args, graph, ecfg, solver, loss_fn, params,
                           data)
    return one, out


def jax_step_draws(dim):
    """The JAX step's packed (N, D) uniforms: per step i the key
    PRNGKey(1000 + i), split into one key per phase."""
    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (N, dim), jnp.float32)))
    return uniforms


def jax_fleet_draws(dim):
    """The JAX fleet's per-round draws (``FleetSim`` keys each round's
    step with fold_in(PRNGKey(seed), round))."""
    draws = jax_draws(0)
    return lambda r, ph: draws(r, ph, N, dim)


def port_params(one):
    return interop.tree_from_numpy(
        {jax.tree_util.keystr(p): np.asarray(x) for p, x in
         jax.tree_util.tree_flatten_with_path(one)[0]}, device="cpu")


def smoke_configs():
    jcfg = jbase.get_smoke_config(ARCH).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(ARCH).with_overrides(dtype="float32")
    return jcfg, cfg


def run_admm_both(quantize):
    jcfg, cfg = smoke_configs()
    one, jstate, jm = jax_run_admm(jcfg, quantize)
    params = port_params(one)
    args = train.build_parser().parse_args(flags(quantize))
    dim = sum(x.numel() for x in T.leaves(params))
    out = train.run_admm(cfg, args, params=params,
                         uniforms=jax_step_draws(dim))
    return out, jstate, jm


def run_fleet_both(quantize):
    jcfg, cfg = smoke_configs()
    one, jout = jax_run_fleet(jcfg, quantize)
    params = port_params(one)
    args = train.build_parser().parse_args(flags(quantize, fleet=True))
    dim = sum(x.numel() for x in T.leaves(params))
    out = train.run_admm(cfg, args, params=params,
                         uniforms=jax_fleet_draws(dim))
    return out, jout


def test_attention_takes_the_worker_axis():
    """x (W, B, S, D) with per-worker weights equals each worker's model
    applied alone, and worker-stacked logits equal the unstacked ones."""
    cfg = base.get_smoke_config(ARCH).with_overrides(dtype="float32")
    gen = torch.Generator().manual_seed(3)
    models = [registry.init_params(cfg, gen) for _ in range(3)]
    stacked = T.tree_map(lambda *xs: torch.stack(xs), *models)
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 12), generator=gen)
    got = registry.apply_model(stacked, cfg, {"tokens": tokens})
    assert got.shape == (3, 2, 12, cfg.vocab_size)
    for w, p in enumerate(models):
        want = registry.apply_model(p, cfg, {"tokens": tokens[w]})
        torch.testing.assert_close(got[w], want, rtol=0, atol=1e-5 * float(
            want.abs().max()))
    dims = layers.AttnDims(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim)
    attn = T.tree_map(lambda *xs: torch.stack(xs),
                      *[m["stack"]["units"]["p0"]["attn"] for m in models])
    x = torch.randn((3, 2, 5, cfg.d_model), generator=gen)
    pos = torch.arange(5)[None].expand(2, 5)
    with pytest.raises(ValueError, match="worker axis"):
        layers.attention_apply(T.tree_map(lambda t: t[:, 0], attn), dims,
                               x, pos, cache={})


def test_ggadmm_theta_matches_jax():
    out, jstate, jm = run_admm_both(False)
    jflat = jax.tree_util.tree_flatten_with_path(jstate.theta)[0]
    scale = max(float(np.abs(np.asarray(x)).max()) for _, x in jflat)
    err = np.concatenate([
        np.abs(got.numpy() - np.asarray(want)).ravel()
        for (_, want), got in zip(jflat, T.leaves(out["state"].theta))])
    assert (err > 1e-4 * scale).mean() <= 1e-4, (err > 1e-4 * scale).sum()
    assert err.max() <= 1e-3 * scale, err.max()
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], rtol=1e-4)
    assert out["total_bits"] == sum(float(m["payload_bits"].sum())
                                    for m in jm)


def test_cq_ggadmm_bits_and_loss_match_jax():
    out, _, jm = run_admm_both(True)
    assert out["n_groups"] == len(T.leaves(out["state"].theta))
    for i in (0, 1):
        np.testing.assert_array_equal(out["bits_per_group"][i],
                                      jm[i]["bits_per_group"])
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], atol=1e-3)
    assert np.isfinite(out["history"]).all()


@pytest.mark.parametrize("quantize", [False, True])
def test_fleet_sparse_matches_jax_trainer(quantize):
    out, jout = run_fleet_both(quantize)
    assert out["n_groups"] == jout["n_groups"]
    if quantize:
        np.testing.assert_allclose(out["history"], jout["history"],
                                   atol=1e-3)
    else:
        assert (out["metrics"]["fleet_participation"] == 0).any()
        np.testing.assert_allclose(out["history"], jout["history"],
                                   rtol=1e-4)
        assert out["total_bits"] == jout["total_bits"]
    assert np.isfinite(out["history"]).all()


def _jax_parsed_defaults():
    """The JAX CLI's parsed namespace for no arguments (its parser lives
    inside ``main``): the first ``parse_args`` call is caught."""
    class Parsed(Exception):
        pass

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        seen["args"] = orig(self, args, namespace)
        raise Parsed

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Parsed):
            jtrain.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return vars(seen["args"])


def test_parsed_defaults_equal_the_jax_cli():
    want = _jax_parsed_defaults()
    got = vars(train.build_parser().parse_args([]))
    assert got["arch"] == want["arch"] == "tinyllama-1.1b"
    shared = sorted(set(got) & set(want))
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
