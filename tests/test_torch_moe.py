"""The mixture-of-experts family through the port: ``models/moe.py``, the
"moe" block kind, the olmoe-1b-7b and grok-1-314b configs, the loss with the
router's auxiliary term, consensus and FSDP training, and paged and
lockstep serving, against the JAX package on numpy-seeded inputs (the JAX
init carried across with ``interop``).

Tolerances and their reasons:

* ``moe_apply`` and logits, float32 activations: 1e-5 of max|out| (the two
  frameworks' float32 products add in different orders); aux to rtol 1e-6
  (a float32 mean over T tokens); the chosen experts equal, except where
  two probabilities lie within 1 ulp (summation order decides those);
* the loss with aux: rtol 1e-5; gradients of ce + 0.01·aux: 1e-4 of
  max|grad|;
* counts, leaf paths, bucket names, packed offsets, greedy token streams:
  equal;
* consensus training: C5's tolerances, as ``test_torch_attn_consensus.py``
  (the bit widths per (worker, group) equal at steps 0 and 1 and the loss
  within 1e-3 at every step, the JAX draws injected); FSDP: the loss
  within rtol 1e-4 at every step, as ``test_torch_fsdp.py``.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import engine as JE
from repro.core import packing as JP
from repro.core.censoring import CensorConfig as JCensor
from repro.core.quantization import QuantConfig as JQuant
from repro.data import lm as jlm
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import packing as P
from repro_torch.core import tree as T
from repro_torch.launch import serve, train
from repro_torch.models import blocks, moe, registry
from repro_torch.serving.scheduler import Scheduler, ServeConfig
from test_torch_serving_load import _shared_prefix_stream

MOE_ARCHS = ("olmoe-1b-7b", "grok-1-314b")
NEW_ARCHS = MOE_ARCHS + ("zamba2-7b",)
CONFIG_FIELDS = (
    "name", "arch_type", "num_layers", "d_model", "num_heads",
    "num_kv_heads", "d_ff", "vocab_size", "block_unit", "resolved_head_dim",
    "num_experts", "experts_per_token", "capacity_factor", "ssm_state",
    "ssm_conv", "ssm_expand", "ssm_head_dim", "rope_theta", "norm_eps",
    "dtype", "source", "long_context", "long_context_window")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def pair(arch, **overrides):
    """(JAX cfg, JAX params, port cfg, port params), float32 activations."""
    overrides = dict(dtype="float32", **overrides)
    jcfg = jbase.get_smoke_config(arch).with_overrides(**overrides)
    cfg = base.get_smoke_config(arch).with_overrides(**overrides)
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, interop.model_params_from_numpy(flat(jp), cfg,
                                                          "cpu")


def close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= tol, (what, err, tol)


def tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def lm_batch(shape, seed):
    toks = tokens(shape, seed)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    return toks, labels


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_registered_as_in_jax(arch):
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in CONFIG_FIELDS:
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.block_kinds == jcfg.block_kinds
        for active in (False, True):
            assert registry.count_params(cfg, active_only=active) == \
                jregistry.count_params(jcfg, active_only=active), (
                    cfg.name, active)
    assert arch in base.list_architectures()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_leaf_paths_buckets_and_offsets_match_jax(arch):
    jcfg, cfg = jbase.get_smoke_config(arch), base.get_smoke_config(arch)
    jt = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    pt = registry.init_params(cfg, device="meta")
    jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
    assert T.paths(pt) == tuple(jax.tree_util.keystr(p) for p, _ in jflat)
    assert [tuple(x.shape) for x in T.leaves(pt)] == [
        tuple(x.shape) for _, x in jflat]
    assert registry.param_bucket_names(cfg) == \
        jregistry.param_bucket_names(jcfg)
    assert registry.param_buckets(cfg) == jregistry.param_buckets(jcfg)
    jw = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), jt)
    pw = T.tree_map(lambda x: torch.empty((2,) + tuple(x.shape),
                                          device="meta"), pt)
    for spec in ("leaf", "block:attn,mlp,ssm"):
        try:
            jids = JE.resolve_groups(jw, spec)
        except JP.GroupSpecError:
            with pytest.raises(P.GroupSpecError):
                E.resolve_groups(pw, spec)
            continue
        ids = E.resolve_groups(pw, spec)
        assert tuple(ids) == tuple(jids), spec
        pk, jpk = P.make_packing(pw, ids), JP.make_packing(jw, jids)
        assert pk.offsets == tuple(jpk.offsets) and pk.dim == jpk.dim
        assert pk.group_runs == jpk.group_runs


def test_moe_kind_is_ported_and_unported_kinds_still_raise():
    assert {"moe", "mamba2", "shared_attn"} <= set(blocks.PORTED_KINDS)
    assert blocks.ATTN_KINDS == ("attn", "swa", "moe", "shared_attn")
    cfg = base.get_smoke_config("olmoe-1b-7b")
    p = blocks.init("moe", torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(p) == ["attn", "ln1", "ln2", "moe"]
    assert tuple(p["moe"]["wi_gate"]["w"].shape) == (4, 256, 128)
    # every kind the JAX package's blocks.init accepts is ported now, and
    # an unknown one raises as there
    assert set(blocks.PORTED_KINDS) == {"attn", "swa", "shared_attn",
                                        "xattn", "moe", "mamba2", "mlstm",
                                        "slstm"}
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.init("mlp", None, cfg, "meta")


# ----------------------------------------------------------- moe_apply --
def moe_pair(e=4, k=2, d=32, f=48, seed=0, workers=None):
    """JAX ``moe_init`` weights (one set, or ``workers`` sets stacked on a
    leading axis) as (JAX tree, port tree)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), workers or 1)
    sets = [jmoe.moe_init(kk, d, f, e) for kk in keys]
    jp = sets[0] if workers is None else jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *sets)
    return jp, interop.tree_from_numpy(flat(jp), "cpu")


def jax_route(jp, x, k):
    logits = np.asarray(x.reshape(-1, x.shape[-1]) @ np.asarray(
        jp["router"]["w"]), np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1]), np.asarray(probs)


def assert_same_picks(got_idx, want_idx, probs):
    """Equal expert picks, except where the two probabilities involved lie
    within 1 ulp (float32 summation order decides those)."""
    got_idx, want_idx = np.asarray(got_idx), np.asarray(want_idx)
    for t, kk in zip(*np.nonzero(got_idx != want_idx)):
        a, b = probs[t, got_idx[t, kk]], probs[t, want_idx[t, kk]]
        assert abs(a - b) <= np.spacing(np.float32(max(a, b))), (t, kk, a, b)


@pytest.mark.parametrize("cf,shape", [(1.25, (2, 24)), (0.5, (3, 16)),
                                      (4.0, (1, 7))],
                         ids=["cf1.25", "drops", "roomy"])
def test_moe_apply_matches_jax(cf, shape):
    """cf 0.5 drops assignments; (1, 7) gives C = max(int(7·2/4·4), 2) =
    14 >= T: nothing dropped."""
    jp, p = moe_pair()
    x = np.random.default_rng(1).standard_normal(
        shape + (32,)).astype(np.float32)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), num_experts=4,
                                experts_per_token=2, capacity_factor=cf)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), num_experts=4,
                             experts_per_token=2, capacity_factor=cf)
    close(got.numpy(), want, "out")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert aux.dtype == torch.float32 and aux.shape == ()
    widx, probs = jax_route(jp, x, 2)
    _, gidx = moe.route(torch.from_numpy(probs), 2)
    assert_same_picks(gidx.numpy(), widx, probs)
    t = shape[0] * shape[1]
    cap = moe.capacity(t, 4, 2, cf)
    assert cap == max(int(t * 2 / 4 * cf), 2)
    counts = np.bincount(widx.ravel(), minlength=4)
    if cf == 0.5:
        assert counts.max() > cap                      # drops happen
    if cf == 4.0:
        assert counts.max() <= cap


def test_moe_capacity_is_computed_in_python_floats():
    """olmoe's prefill chunk (64 tokens: C 10), its full-width decode tick
    (8 tokens: C 8) and the smoke decode (4 slots, E 4, k 2: C 2)."""
    assert moe.capacity(64, 64, 8, 1.25) == 10
    assert moe.capacity(8, 64, 8, 1.25) == 8
    assert moe.capacity(4, 4, 2, 1.25) == 2
    assert moe.capacity(8, 64, 8, 64 / 8) == 8      # cf = E/k: C = T
    assert moe.capacity(3, 7, 3, 1.1) == max(int(3 * 3 / 7 * 1.1), 3)


def test_moe_zero_router_ties_pick_the_lowest_experts():
    """Zero router weights: every probability ties at 1/E, and JAX's top_k
    picks experts 0..k-1 for every token, so the first tokens fill experts
    0 and 1 and the rest are dropped; the port picks the same."""
    jp, p = moe_pair(e=8, k=3, seed=2)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    x = np.random.default_rng(3).standard_normal((2, 9, 32)).astype(
        np.float32)
    vals, idx = moe.route(torch.full((18, 8), 0.125), 3)
    assert (idx == torch.tensor([0, 1, 2])).all()
    widx, _ = jax_route(jp, x, 3)
    assert (widx == np.array([0, 1, 2])).all()
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), num_experts=8,
                                experts_per_token=3, capacity_factor=1.25)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), num_experts=8,
                             experts_per_token=3, capacity_factor=1.25)
    close(got.numpy(), want, "tied out")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    cap = moe.capacity(18, 8, 3, 1.25)
    # tokens past the capacity get nothing from any expert
    assert np.abs(got.numpy().reshape(18, 32)[cap:]).max() == 0.0


def test_moe_apply_under_a_worker_axis_matches_jax_vmap():
    """Three workers, each with its own weights and tokens: each routes its
    own T = B·S tokens with its own capacity and aux (JAX's vmap)."""
    jp, p = moe_pair(workers=3, seed=4)
    x = np.random.default_rng(5).standard_normal((3, 2, 10, 32)).astype(
        np.float32)
    want, jaux = jax.vmap(lambda pp, xx: jmoe.moe_apply(
        pp, xx, num_experts=4, experts_per_token=2, capacity_factor=0.75))(
            jp, jnp.asarray(x))
    got, aux = moe.moe_apply(p, torch.from_numpy(x), num_experts=4,
                             experts_per_token=2, capacity_factor=0.75)
    assert aux.shape == (3,)
    close(got.numpy(), want, "out")
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-6)
    for w in range(3):
        one, a = moe.moe_apply(T.tree_map(lambda t, w=w: t[w], p),
                               torch.from_numpy(x[w]), num_experts=4,
                               experts_per_token=2, capacity_factor=0.75)
        close(got[w].numpy(), one.numpy(), f"worker {w}")
        np.testing.assert_allclose(float(aux[w]), float(a), rtol=1e-6)


# -------------------------------------------------------------- models --
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_logits_and_loss_with_aux_match_jax(arch):
    jcfg, jp, cfg, p = pair(arch)
    toks, labels = lm_batch((2, 24), seed=6)
    want, jaux, _ = jregistry.apply_model(jp, jcfg,
                                          {"tokens": jnp.asarray(toks)})
    got = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)})
    close(got.numpy(), want, f"{arch} logits")
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    jloss, jm = jregistry.lm_loss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(labels)})
    assert float(jm["aux"]) > 0
    loss = registry.lm_loss_tokens(p, cfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(
        float(loss), float(jm["ce"]) + 0.01 * float(jm["aux"]), rtol=1e-5)
    # the worker-stacked loss: ce + 0.01·aux per worker, as JAX's vmap
    stacked = T.tree_map(lambda t: torch.stack([t, t]), p)
    wb = {"tokens": torch.from_numpy(np.stack([toks, toks[::-1]])),
          "labels": torch.from_numpy(np.stack([labels, labels[::-1]]))}
    losses, m = registry.lm_loss(stacked, cfg, wb)
    jl2, jm2 = jax.vmap(lambda b: jregistry.lm_loss(jp, jcfg, b))(
        {k: jnp.asarray(v.numpy()) for k, v in wb.items()})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl2), rtol=1e-5)
    np.testing.assert_allclose(m["aux"].numpy(), np.asarray(jm2["aux"]),
                               rtol=1e-5)
    torch.testing.assert_close(losses, m["ce"] + 0.01 * m["aux"])


def test_loss_gradients_match_jax():
    """Gradients of ce + 0.01·aux of olmoe-smoke (the router's weight gets
    the aux term's share through the mean probabilities)."""
    jcfg, jp, cfg, p = pair("olmoe-1b-7b")
    toks, labels = lm_batch((2, 16), seed=7)
    jg = jax.grad(lambda pp: jregistry.lm_loss(
        pp, jcfg, {"tokens": jnp.asarray(toks),
                   "labels": jnp.asarray(labels)})[0])(jp)
    leaves = [x.detach().requires_grad_(True) for x in T.leaves(p)]
    loss = registry.lm_loss_tokens(
        T.unflatten(p, leaves), cfg,
        {"tokens": torch.from_numpy(toks),
         "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves)
    want = flat(jg)
    for path, g in zip(T.paths(p), grads):
        close(g.numpy(), want[path], path, rel=1e-4)
    router = T.paths(p).index(
        "['stack']['units']['p0']['moe']['router']['w']")
    assert float(grads[router].abs().max()) > 0


def test_aux_is_zero_without_experts():
    """The other kinds' loss is the cross entropy itself, bit for bit."""
    _, _, cfg, p = pair("tinyllama-1.1b")
    toks, labels = lm_batch((2, 12), seed=8)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss, m = registry.lm_loss(T.tree_map(lambda t: t[None], p), cfg,
                               {k: v[None] for k, v in batch.items()})
    assert float(m["aux"][0]) == 0.0 and torch.equal(loss, m["ce"])


def test_interop_round_trips_the_expert_stacks():
    jcfg, jp, cfg, p = pair("grok-1-314b")
    back = interop.tree_to_numpy(p)
    want = flat(jp)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    assert back["['stack']['units']['p0']['moe']['wo']['w']"].shape == (
        2, 4, 512, 256)


# ------------------------------------------------------------ training --
N, BATCH, SEQ, STEPS = 2, 2, 16, 3


def train_flags(arch, extra=()):
    return ["--arch", arch, "--smoke", "--workers", str(N), "--batch",
            str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
            "--local-steps", "2", "--lr", "2e-3", "--xi", "0.999",
            "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1", "--tau0", "5.0",
            *extra]


def jax_run_admm(jcfg):
    """The JAX package's run_admm loop (quantized), every step's
    metrics."""
    graph = JST.worker_graph(N, "random")
    ecfg = JE.EngineConfig(rho=0.01, censor=JCensor(tau0=5.0, xi=0.999),
                           quantize=JQuant(b0=6, omega=0.9995),
                           groups="leaf")

    def grad_fn(theta, batch):
        return jax.vmap(lambda pp, b: jax.grad(
            lambda q: jregistry.lm_loss(q, jcfg, b)[0])(pp))(theta, batch)

    def loss_fn(theta, batch):
        return jnp.mean(jax.vmap(
            lambda pp, b: jregistry.lm_loss(pp, jcfg, b)[0])(theta, batch))

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
    return one, metrics


def jax_step_draws(dim):
    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (N, dim), jnp.float32)))
    return uniforms


def run_admm_pair(arch):
    """The port's ``run_admm`` and the JAX loop from the JAX init, the JAX
    draws injected: C5's tolerances."""
    jcfg = jbase.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(arch).with_overrides(dtype="float32")
    one, jm = jax_run_admm(jcfg)
    params = interop.tree_from_numpy(flat(one), "cpu")
    params["stack"].setdefault("rem", {})
    args = train.build_parser().parse_args(train_flags(arch))
    dim = sum(x.numel() for x in T.leaves(params))
    out = train.run_admm(cfg, args, params=params,
                         uniforms=jax_step_draws(dim))
    assert out["n_groups"] == len(T.leaves(out["state"].theta))
    for i in (0, 1):
        np.testing.assert_array_equal(out["bits_per_group"][i],
                                      jm[i]["bits_per_group"])
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], atol=1e-3)
    assert np.isfinite(out["history"]).all()
    return out


def test_cq_ggadmm_olmoe_smoke_matches_jax():
    run_admm_pair("olmoe-1b-7b")


def test_fsdp_step_of_olmoe_smoke_matches_jax(tmp_path):
    """One AdamW step of the FSDP baseline on ce + 0.01·aux."""
    jcfg = jbase.get_smoke_config("olmoe-1b-7b").with_overrides(
        dtype="float32")
    cfg = base.get_smoke_config("olmoe-1b-7b").with_overrides(
        dtype="float32")

    def args(tmp):
        return argparse.Namespace(
            arch="olmoe-1b-7b", smoke=True, mode="fsdp", steps=2, batch=2,
            seq=16, lr=1e-3, seed=0, log_every=1, ckpt_dir=str(tmp),
            ckpt_every=100, device="cpu", fleet=False)

    jout = jtrain.run_fsdp(jcfg, args(tmp_path / "jax"))
    jp0 = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    out = train.run_fsdp(cfg, args(tmp_path / "port"),
                         params=interop.model_params_from_numpy(
                             flat(jp0), cfg, "cpu"))
    np.testing.assert_allclose(out["history"], jout["history"], rtol=1e-4)
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(512, 16, seed=0))
    b0 = {k: jnp.asarray(v) for k, v in data.batch(0, 2).items()}
    _, jm = jregistry.lm_loss(jp0, jcfg, b0)
    np.testing.assert_allclose(
        out["history"][0], float(jm["ce"]) + 0.01 * float(jm["aux"]),
        rtol=1e-4)


# ------------------------------------------------------------- serving --
PAGE, PPS = 4, 16


def serve_cfg(cls, **kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("num_pages", 48)
    kw.setdefault("pages_per_seq", PPS)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_bits", 32)
    kw.setdefault("cache_dtype", "float32")
    return cls(**kw)


def prompts(vocab, lens, seed=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def run_stream(sched, ps, news):
    rids = [sched.submit(p, m) for p, m in zip(ps, news)]
    out = sched.run()
    assert sched.pool.in_use == 0
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_scheduler_tokens_match_jax_with_inactive_slots(arch, monkeypatch):
    """Three slots for four requests of different lengths: decode ticks run
    with inactive slots (fed token 0 at position -1, whose tokens still
    take expert capacity in both packages), at the configured
    ``capacity_factor``; 0 pages in use at the end."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair(arch)
    ps, news = prompts(512, (9, 14, 6, 11)), (12, 5, 10, 7)
    want = run_stream(JScheduler(jcfg, jp, serve_cfg(JServeConfig)), ps,
                      news)
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig), device="cpu")
    assert run_stream(sched, ps, news) == want
    assert sched.decode_steps > 0


def test_lockstep_tokens_match_jax():
    """Two waves of a mixed stream (padded to the longest prompt by
    repeating the last token, and bf16 K/V caches, as in both
    packages)."""
    jcfg, jp, cfg, p = pair("olmoe-1b-7b")
    ps = prompts(512, (9, 14, 6, 11), seed=5)
    want = jserve.LockstepEngine(jcfg, jp, batch=2).run(ps, 6)
    got = serve.LockstepEngine(cfg, p, batch=2, device="cpu").run(ps, 6)
    for i in range(len(ps)):
        assert got["outputs"][i].tolist() == want["outputs"][i].tolist(), i


def test_prefix_sharing_takes_moe_stacks_as_jax(monkeypatch):
    """share_prefix on a pure attention-family stack including "moe":
    allowed, the same tokens as JAX's shared run; swa_recycle refused."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair("olmoe-1b-7b")
    ps, news = _shared_prefix_stream(512)
    kw = dict(share_prefix=True)
    want = run_stream(JScheduler(jcfg, jp, serve_cfg(JServeConfig, **kw)),
                      ps, news)
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig, **kw), device="cpu")
    assert run_stream(sched, ps, news) == want
    assert sched.shared_page_hits > 0
    with pytest.raises(ValueError, match="swa_recycle"):
        Scheduler(cfg, p, serve_cfg(ServeConfig, swa_recycle=True),
                  device="cpu")


def test_paged_and_lockstep_part_where_a_chunk_drops_as_in_jax(
        monkeypatch):
    """ROADMAP C18: expert capacity depends on the step's token count. The
    paged engine prefills 4-token chunks (C = max(int(4·2/4·1.25), 2) = 2)
    and decodes four slots at once; the lockstep engine prefills the whole
    12-token wave of four (C = 30). Where a chunk drops an assignment the
    two engines compute different functions, in both packages alike: the
    port's paged tokens equal JAX's paged ones, its lockstep tokens JAX's
    lockstep ones, and the two engines part at the same (request, step)
    pairs. bf16 K/V in both engines (the lockstep engine's, as in the JAX
    package), so capacity is what parts them: with C = T in both engines
    (``capacity_factor`` = E/k) they agree."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair("olmoe-1b-7b")
    ps = jserve.make_prompts(jcfg, [12] * 4, 0)
    geom = dict(max_seqs=4, prefill_chunk=4, cache_dtype="bfloat16")

    def parts(a, b):
        return [next((k for k, (x, y) in enumerate(zip(u, v)) if x != y),
                     None) for u, v in zip(a, b)]

    jpaged = run_stream(JScheduler(jcfg, jp, serve_cfg(JServeConfig,
                                                       **geom)), ps, [6] * 4)
    jlock = jserve.LockstepEngine(jcfg, jp, batch=4).run(ps, 6)
    jlock = [jlock["outputs"][i].tolist() for i in range(4)]
    paged = run_stream(Scheduler(cfg, p, serve_cfg(ServeConfig, **geom),
                                 device="cpu"), ps, [6] * 4)
    lock = serve.LockstepEngine(cfg, p, batch=4, device="cpu").run(ps, 6)
    lock = [lock["outputs"][i].tolist() for i in range(4)]
    assert paged == jpaged and lock == jlock
    assert parts(paged, lock) == parts(jpaged, jlock)
    assert any(k is not None for k in parts(paged, lock))
    # with C = T in both engines (capacity_factor = E/k) nothing is
    # dropped and the engines agree
    jcfg2, jp2, cfg2, p2 = pair("olmoe-1b-7b", capacity_factor=2.0)
    paged = run_stream(Scheduler(cfg2, p2, serve_cfg(ServeConfig, **geom),
                                 device="cpu"), ps, [6] * 4)
    lock = serve.LockstepEngine(cfg2, p2, batch=4, device="cpu").run(ps, 6)
    assert paged == [lock["outputs"][i].tolist() for i in range(4)]


def test_serve_cli_serves_olmoe_smoke(capsys):
    out = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--prompt-lens", "9,5", "--decode-tokens", "3"])
    assert out["final_pages_in_use"] == 0
    assert "olmoe-smoke" in capsys.readouterr().out
