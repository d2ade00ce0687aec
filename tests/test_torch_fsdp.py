"""The FSDP-Adam baseline trainer (``launch.train --mode fsdp``,
``optim/adamw.py``, ``registry.lm_loss_tokens``) against the JAX package,
on the CPU, from the same initial parameters (the JAX init, carried
across).

Tolerances and their reasons:

* ``adamw_update`` against the JAX update under ``jax.jit`` (as its
  trainer runs it): float32 parameters and moments within 2 ulp, bf16
  parameters equal but at rounding ties. The port evaluates XLA's fused
  multiply-adds and its ``a/b/c -> a/(b·c)`` rewrite (optim/adamw.py), so
  on the CPU the two agree bit for bit; the 2 ulp allow for the rare
  double rounding of the float64 emulation.
* the token-weighted loss: rel 1e-6 (float32 logits, sums in other
  orders).
* ``run_fsdp`` for 3 steps with float32 activations: the loss within rel
  1e-4 at every step; parameters as ROADMAP C holds Adam: at most 1e-4 of
  the elements beyond 1e-4·max|θ|, the largest within 1e-3·max|θ|. The
  two packages' gradients differ by summation order (~1e-7 relative) and
  Adam divides each by its own running magnitude, so a near-zero gradient
  can flip its step.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import npz as jckpt
from repro.configs import base as jbase
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro_torch import interop
from repro_torch.checkpoint import npz as ckpt
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.optim import adamw

BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and under the
    suite's parallel workers an 8-thread pool per op oversubscribes the
    CPU (a 7x slowdown measured with 5 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _tree(rng, make):
    return {"embed": {"table": make(rng, (37, 19))},
            "stack": {"w": make(rng, (3, 4, 5)), "b": make(rng, (101,))}}


# ----------------------------------------------------------- adamw --
def _synced_steps(dtype, wd, update):
    """Five updates (counts 1-5) of ``update`` and of the jitted JAX
    update on a random tree with gradients over eight decades, the port
    restarted from the JAX state before each step. Yields (count, JAX
    params, JAX state, port params, port state) after each."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng, lambda r, s: r.standard_normal(s).astype(np.float32))
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), p_np)
    tdt = getattr(torch, dtype)
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=wd)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=wd)
    jupd = jax.jit(jadamw.adamw_update, static_argnums=3)
    js = jadamw.adamw_init(jp)
    for count in range(1, 6):
        g_np = _tree(rng, lambda r, s: (
            r.standard_normal(s) * 10.0 ** r.integers(-6, 2, s)
        ).astype(np.float32))
        tp = T.from_paths({k: torch.from_numpy(np.array(
            v.astype(jnp.float32))).to(tdt) for k, v in _paths(jp).items()})
        ts = adamw.AdamWState(
            *(T.from_paths({k: torch.from_numpy(np.asarray(v).copy())
                            for k, v in _paths(t).items()})
              for t in (js.mu, js.nu)), count - 1)
        jp, js = jupd(jax.tree_util.tree_map(jnp.asarray, g_np), js, jp,
                      jcfg)
        tp, ts = update(
            T.from_paths({k: torch.from_numpy(v) for k, v in
                          _paths(g_np).items()}), ts, tp, cfg)
        yield count, jp, js, tp, ts


def _moment_ulps(js, ts):
    return max(int(_ulps(T.to_paths(tt)[path].numpy(), np.asarray(want)
                         ).max())
               for tt, jt in ((ts.mu, js.mu), (ts.nu, js.nu))
               for path, want in _paths(jt).items())


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, wd):
    tdt = getattr(torch, dtype)
    for count, jp, js, tp, ts in _synced_steps(dtype, wd,
                                               adamw.adamw_update):
        assert ts.count == count == int(js.count)
        for path, want in _paths(jp).items():
            got = T.to_paths(tp)[path]
            assert got.dtype == tdt
            want32 = np.asarray(want.astype(jnp.float32))
            got32 = got.to(torch.float32).numpy()
            if dtype == "float32":
                assert _ulps(got32, want32).max() <= 2, (path, count)
            else:
                # a bf16 parameter may differ only where its float32
                # update sat on a rounding tie: one bf16 step, rarely
                steps = _ulps(got32, want32) >> 16
                assert steps.max() <= 1, (path, count)
                assert (steps > 0).mean() <= 1e-3, (path, count)
        assert _moment_ulps(js, ts) <= 2, count


def _plain_float32_update(grads, state, params, cfg):
    """The update in plain float32 ``torch._foreach_*`` operations: every
    product and sum rounded on its own, no fused multiply-add, the step
    as ``(m/b1c)/(sqrt(v/b2c)+eps)`` as written."""
    count = state.count + 1
    b1c, b2c = adamw.bias_corrections(count, cfg)
    g = [x.to(torch.float32) for x in T.leaves(grads)]
    p32 = [x.to(torch.float32) for x in T.leaves(params)]
    m = torch._foreach_add(torch._foreach_mul(T.leaves(state.mu), cfg.b1),
                           torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_add(torch._foreach_mul(T.leaves(state.nu), cfg.b2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - cfg.b2))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, b2c)),
                             cfg.eps)
    step = torch._foreach_div(torch._foreach_div(m, b1c), den)
    step = torch._foreach_add(step,
                              torch._foreach_mul(p32, cfg.weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(step, cfg.lr))
    return (T.unflatten(params, [x.to(p.dtype) for x, p in
                                 zip(new_p, T.leaves(params))]),
            adamw.AdamWState(T.unflatten(params, m), T.unflatten(params, v),
                             count))


def test_plain_float32_update_is_further_than_two_ulp_from_jax():
    """Why ``optim/adamw.py`` evaluates XLA's fused multiply-adds in
    float64: the same formula in plain float32 operations misses the
    jitted JAX update by more than the 2 ulp allowed above, in the
    parameters and far more in the moments, where ``b1·m + (1-b1)·g``
    cancels (8 and 446 ulp on this tree)."""
    worst_p = worst_m = 0
    for count, jp, js, tp, ts in _synced_steps("float32", 0.1,
                                               _plain_float32_update):
        for path, want in _paths(jp).items():
            worst_p = max(worst_p, int(_ulps(T.to_paths(tp)[path].numpy(),
                                             np.asarray(want)).max()))
        worst_m = max(worst_m, _moment_ulps(js, ts))
    print(f"plain float32 AdamW vs jitted JAX: parameters {worst_p} ulp, "
          f"moments {worst_m} ulp")
    assert worst_p > 2 and worst_m > 2, (worst_p, worst_m)


def _paths(tree):
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_adamw_differs_from_torch_optim_adamw_at_weight_decay():
    """The port is the JAX package's AdamW, not torch.optim.AdamW (which
    decays the parameter by a separate multiply): at wd 0.1 the two move
    a parameter differently."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1)
    ours, _ = adamw.adamw_update({"p": g}, adamw.adamw_init({"p": p}),
                                 {"p": p}, cfg)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([q], lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1)
    q.grad = g.clone()
    opt.step()
    assert not torch.equal(ours["p"], q.detach())
    # at count 1 the JAX step is sign(g)·|g|/(|g|+eps) + wd·p
    want = p - 1e-2 * (g / (g.abs() + 1e-8) * 1.0 + 0.1 * p)
    torch.testing.assert_close(ours["p"], want, rtol=0, atol=1e-6)


def test_sgd_update_matches_jax():
    rng = np.random.default_rng(2)
    p_np = _tree(rng, lambda r, s: r.standard_normal(s).astype(np.float32))
    g_np = _tree(rng, lambda r, s: r.standard_normal(s).astype(np.float32))
    want = jax.jit(jadamw.sgd_update, static_argnums=2)(
        jax.tree_util.tree_map(jnp.asarray, g_np),
        jax.tree_util.tree_map(jnp.asarray, p_np), 0.05)
    got = adamw.sgd_update(T.tree_map(torch.from_numpy, g_np),
                           T.tree_map(torch.from_numpy, p_np), 0.05)
    for path, w in _paths(want).items():
        assert _ulps(T.to_paths(got)[path].numpy(),
                     np.asarray(w)).max() <= 1


# ----------------------------------------------------------- loss --
@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, port cfg, port params), tinyllama smoke with
    float32 activations."""
    jcfg = jbase.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    cfg = base.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, interop.model_params_from_numpy(
        {k: np.asarray(v) for k, v in _paths(jp).items()}, cfg, "cpu")


def test_token_weighted_loss_matches_jax_with_masked_labels(tiny):
    """Rows with different numbers of valid labels: the batch's
    token-weighted mean (JAX's ``lm_loss``), not the mean of row means
    (the worker-stacked ``lm_loss`` per row)."""
    jcfg, jp, cfg, p = tiny
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    labels[0, 2:] = -1                      # 2, 9 and 12 valid labels
    labels[1, :3] = -1
    jl, jm = jregistry.lm_loss(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                          "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    loss = registry.lm_loss_tokens(p, cfg, batch)
    assert loss.shape == () and float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jm["ce"]), rtol=1e-6)
    rows, _ = registry.lm_loss(p, cfg, batch)        # one CE per row
    assert abs(float(rows.mean()) - float(loss)) > 1e-4 * float(loss)


# ------------------------------------------------------- run_fsdp --
def _args(arch, tmp, **kw):
    ns = dict(arch=arch, smoke=True, mode="fsdp", steps=STEPS, batch=BATCH,
              seq=SEQ, lr=LR, seed=0, log_every=1, ckpt_dir=str(tmp),
              ckpt_every=100, device="cpu", fleet=False)
    ns.update(kw)
    return argparse.Namespace(**ns)


def _close_theta(got: dict, want: dict):
    """ROADMAP C's rule for Adam, as test_torch_consensus.py applies it:
    over the whole tree, against the largest |θ| of any leaf."""
    scale = max(float(np.abs(w).max()) for w in want.values())
    err = np.concatenate([np.abs(got[p] - w).ravel()
                          for p, w in want.items()])
    assert (err > 1e-4 * scale).mean() <= 1e-4, (err > 1e-4 * scale).sum()
    assert err.max() <= 1e-3 * scale, (err.max(), scale)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-125m"])
def test_run_fsdp_matches_jax(arch, tmp_path):
    """Three steps from the JAX init: the loss at every step and the final
    parameters (the JAX run's checkpoint) against the port's."""
    jcfg = jbase.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(arch).with_overrides(dtype="float32")
    jout = jtrain.run_fsdp(jcfg, _args(arch, tmp_path / "jax"))
    jp0 = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    flat0 = {k: np.asarray(v) for k, v in _paths(jp0).items()}
    out = train.run_fsdp(cfg, _args(arch, tmp_path / "port"),
                         params=interop.model_params_from_numpy(flat0, cfg,
                                                                "cpu"))
    np.testing.assert_allclose(out["history"], jout["history"], rtol=1e-4)
    assert len(out["history"]) == STEPS and out["total_bits"] == 0.0
    want, step = jckpt.restore(tmp_path / "jax", jp0)
    assert step == STEPS
    _close_theta({k: v.numpy() for k, v in T.to_paths(out["params"]).items()},
                 {k: np.asarray(v) for k, v in _paths(want).items()})
    assert out["opt"].count == STEPS


def test_data_batches_are_the_jax_package_batches():
    a = jlm.SyntheticLM(jlm.SyntheticLMConfig(512, SEQ, seed=0)).batch(2, 3)
    from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig
    b = SyntheticLM(SyntheticLMConfig(512, SEQ, seed=0)).batch(2, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ CLI --
def test_fsdp_cli_runs_and_its_checkpoint_restores_in_jax(tmp_path):
    out = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--mode",
                      "fsdp", "--device", "cpu", "--batch", "2", "--seq",
                      "8", "--steps", "2", "--log-every", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(out["history"]).all() and len(out["history"]) == 2
    assert out["peak_device_bytes"] == 0
    jcfg = jbase.get_smoke_config("tinyllama-1.1b")
    template = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    template = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype), template)
    got, step = jckpt.restore(tmp_path, template)
    assert step == 2
    mine, _ = ckpt.restore(tmp_path, T.tree_map(torch.zeros_like,
                                                out["params"]))
    for path, leaf in _paths(got).items():
        np.testing.assert_array_equal(np.asarray(leaf),
                                      T.to_paths(mine)[path].numpy())
        np.testing.assert_array_equal(
            np.asarray(leaf), T.to_paths(out["params"])[path].numpy())


def test_fsdp_with_fleet_exits_with_the_jax_message():
    with pytest.raises(SystemExit, match="--fleet only applies to --mode "
                                         "admm"):
        train.main(["--smoke", "--mode", "fsdp", "--fleet", "--device",
                    "cpu", "--steps", "1"])


def test_fsdp_batch_need_not_divide_by_workers():
    """As in the JAX package, ``--workers`` does not constrain the FSDP
    batch (one model, no worker axis)."""
    out = train.main(["--arch", "xlstm-125m", "--smoke", "--mode", "fsdp",
                      "--device", "cpu", "--batch", "3", "--workers", "4",
                      "--seq", "8", "--steps", "1"])
    assert len(out["history"]) == 1
