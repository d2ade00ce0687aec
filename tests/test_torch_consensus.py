"""Smoke-size consensus LM training (``launch.train.run_admm``: xlstm-smoke,
4 workers, seq 16, 3 steps) against the JAX package's ``run_admm`` loop,
from the same initial parameters (the JAX init, carried across).

Tolerances and their reasons:

* float32 activations on both sides (``dtype="float32"``); the point is
  the algorithm (engine, packed path, inexact Adam solver), and bf16
  rounds at other places in the two frameworks (test_torch_models.py).
* ggadmm without quantization, after 3 steps: the loss history within
  rel 1e-4, and theta within 1e-4 max|theta| on all but 1e-4 of its
  elements, every element within 1e-3 max|theta|. The two packages'
  float32 gradients differ by their summation order (~1e-7 relative), and
  Adam divides each gradient by its own running magnitude: where a
  gradient is near zero that rounding decides the step. On the CPU 88 of
  9.5 million elements sit beyond 1e-4 max|theta| (largest 1.6e-3,
  lr = 2e-3); the rest agree to 1e-5.
* cq-ggadmm with ``--groups leaf`` and the JAX draws injected: the bit
  widths per (worker, group) equal at steps 1 and 2 (Eq. 18 on ranges that
  agree to float32 rounding), the loss within 1e-3 at every step.
"""
import dataclasses

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
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import consensus
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.launch import train

N, BATCH, SEQ, STEPS = 4, 4, 16, 3


def flags(quantize):
    return ["--arch", "xlstm-125m", "--smoke", "--workers", str(N),
            "--batch", str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
            "--local-steps", "2", "--lr", "2e-3", "--xi", "0.999",
            "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1"] + (
        ["--tau0", "5.0"] if quantize else ["--no-quantize", "--tau0", "0"])


def jax_run_admm(jcfg, quantize):
    """The JAX package's run_admm loop, keeping every step's metrics and
    the final state."""
    graph = JST.worker_graph(N, "random")
    ecfg = JE.EngineConfig(
        rho=0.01, censor=JCensor(tau0=5.0, xi=0.999) if quantize
        else JCensor(), quantize=JQuant(b0=6, omega=0.9995)
        if quantize else None, groups="leaf")

    def grad_fn(theta, batch):
        return jax.vmap(lambda p, b: jax.grad(
            lambda pp: jregistry.lm_loss(pp, jcfg, b)[0])(p))(theta, batch)

    def loss_fn(theta, batch):
        return jnp.mean(jax.vmap(
            lambda p, b: jregistry.lm_loss(p, jcfg, b)[0])(theta, batch))

    solver = JE.InexactSolver(grad_fn=grad_fn, local_steps=2, local_lr=2e-3)
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


def jax_draws(dim):
    """The JAX step's packed (N, D) uniforms: per step i the key
    PRNGKey(1000 + i), split into one key per phase."""
    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (N, dim), jnp.float32)))
    return uniforms


def run_both(quantize):
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    one, jstate, jm = jax_run_admm(jcfg, quantize)
    params = interop.tree_from_numpy(
        {jax.tree_util.keystr(p): np.asarray(x) for p, x in
         jax.tree_util.tree_flatten_with_path(one)[0]}, device="cpu")
    cfg = base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")
    args = train.build_parser().parse_args(flags(quantize))
    dim = sum(x.numel() for x in T.leaves(params))   # one model, no N axis
    out = train.run_admm(cfg, args, params=params, uniforms=jax_draws(dim))
    return out, jstate, jm


@pytest.fixture(scope="module")
def quantized():
    return run_both(True)


def test_ggadmm_theta_matches_jax():
    out, jstate, jm = run_both(False)
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


def test_cq_ggadmm_bits_and_loss_match_jax(quantized):
    out, _, jm = quantized
    assert out["n_groups"] == 19
    for i in (0, 1):
        np.testing.assert_array_equal(out["bits_per_group"][i],
                                      jm[i]["bits_per_group"])
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], atol=1e-3)
    assert np.isfinite(out["history"]).all()


def test_multi_leaf_state_carries_across(quantized):
    """The JAX engine state after the run, flattened by keystr, becomes the
    port's state and flattens back to the same arrays."""
    _, jstate, _ = quantized
    flat = {"k": np.asarray(jstate.k)}
    for name, tree in (("theta", jstate.theta), ("theta_hat",
                                                  jstate.theta_hat),
                       ("alpha", jstate.alpha), ("quant.q_hat",
                                                 jstate.quant.q_hat),
                       ("opt_mu", jstate.opt_mu), ("opt_nu", jstate.opt_nu)):
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[name + jax.tree_util.keystr(p)] = np.asarray(x)
    for f in interop.SIDE_FIELDS:
        flat[f"quant.{f}"] = np.asarray(getattr(jstate.quant, f))
    state = interop.engine_state_from_numpy(flat, device="cpu")
    assert state.k == STEPS and state.quant.n_groups == 19
    assert T.paths(state.theta) == T.paths(state.opt_nu)
    back = interop.engine_state_to_numpy(state)
    assert set(back) == set(flat)
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k])


def test_consensus_adapter_builds_the_engine_step():
    cfg = consensus.ConsensusConfig(
        censor=CensorConfig(tau0=5.0, xi=0.999),
        quantize=QuantConfig(b0=6, omega=0.9995), local_steps=1,
        groups="block:embed,mlp,norm", censor_mode="group")
    ecfg = cfg.engine_config()
    assert ecfg == E.EngineConfig(rho=0.01, censor=cfg.censor,
                                  quantize=cfg.quantize,
                                  groups="block:embed,mlp,norm",
                                  censor_mode="group")
    assert dataclasses.asdict(cfg.solver()) == dataclasses.asdict(
        E.InexactSolver(local_steps=1, local_lr=1e-3))
    theta = {"embed": torch.ones((2, 3)), "mlp": {"w": torch.ones((2, 4))},
             "norm": torch.ones((2, 2)), "x": torch.ones((2, 5))}
    state = consensus.init_consensus_state(theta, cfg)
    assert state.quant.n_groups == 4
    assert T.paths(state.opt_mu) == T.paths(theta)

    def grad_fn(th, batch):
        return T.tree_map(lambda x: x - batch, th)

    step = consensus.make_consensus_step(
        E_graph(), cfg, grad_fn,
        loss_fn=lambda th, batch: torch.tensor(0.0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, m = step(state, lambda ph: torch.rand((2, 14), generator=gen),
                    torch.full((2, 1), 0.5))
    assert m["group_tx"].shape == (2, 4) and state.k == 1
    assert set(m) >= {"loss", "consensus_err", "censor_mask",
                      "offered_payload_bits"}


def E_graph():
    from repro_torch.runtime.steps import worker_graph
    return worker_graph(2)
