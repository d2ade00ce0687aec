"""M-RoPE and qwen2-vl-7b through the port: three-plane rotary embeddings,
``registry.build_positions``, the stub vision embeddings of
``data.lm.model_batch``, logits with and without the worker axis, cached
decode, paged and lockstep serving, a ``window_override`` ring and
consensus training, against the JAX package on numpy-seeded inputs (the JAX
init and the JAX stub draws carried across).

Tolerances and their reasons:

* ``apply_rope``: 1e-6 of max|x| (float32 sin/cos of the same angles in
  two libraries); plain RoPE against M-RoPE on equal planes: bit for bit
  (every band takes the same angle);
* logits with float32 activations: 1e-5 of max|logit| (the two
  frameworks' float32 products add in different orders); with bf16
  activations: ROADMAP C7's 4e-2 (XLA on the CPU keeps excess precision
  between bf16 operations);
* positions, greedy token streams and page counters: equal;
* consensus training: C5's tolerances, as ``test_torch_moe.py``.
"""
import functools

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
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.runtime import steps as JST
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.data import lm
from repro_torch.launch import serve, train
from repro_torch.models import layers, registry
from repro_torch.serving.scheduler import Scheduler, ServeConfig

ARCH = "qwen2-vl-7b"
CONFIG_FIELDS = (
    "name", "arch_type", "num_layers", "d_model", "num_heads",
    "num_kv_heads", "d_ff", "vocab_size", "block_unit", "resolved_head_dim",
    "mrope_sections", "rope_theta", "vision_tokens", "encoder_layers",
    "source_positions", "pos_embedding", "tie_embeddings", "norm_eps",
    "dtype", "source", "long_context", "long_context_window",
    "is_encoder_decoder")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The JAX init of a smoke config (seed 0; the activation dtype does
    not enter it), made once per module."""
    return jregistry.init_params(jbase.get_smoke_config(arch),
                                 jax.random.PRNGKey(0))


def pair(arch=ARCH, **overrides):
    """(JAX cfg, JAX params, port cfg, port params), float32 activations
    unless ``dtype`` is given."""
    overrides.setdefault("dtype", "float32")
    jcfg = jbase.get_smoke_config(arch).with_overrides(**overrides)
    cfg = base.get_smoke_config(arch).with_overrides(**overrides)
    jp = _jax_init(arch)
    return jcfg, jp, cfg, interop.model_params_from_numpy(flat(jp), cfg,
                                                          "cpu")


def close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= tol, (what, err, tol)


def tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def jax_stub_batch(jcfg, raw, step):
    """The JAX package's ``model_batch`` (stubs keyed by ``PRNGKey(step)``)
    and the same batch through the port with those stubs injected."""
    jb = jlm.model_batch(jcfg, raw, key=jax.random.PRNGKey(step))
    stubs = {k: interop.tensor_from_numpy(jb[k], "cpu")
             for k in ("vision_embeds", "frames") if k in jb}
    return jb, stubs


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small"])
def test_configs_registered_as_in_jax(arch):
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in CONFIG_FIELDS:
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.block_kinds == jcfg.block_kinds
    assert base.list_architectures() == jbase.list_architectures()
    assert len(base.list_architectures()) == 10


# -------------------------------------------------------------- M-RoPE --
def test_apply_rope_with_sections_matches_jax_on_distinct_planes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9, 3)).astype(np.int32)
    for sections in ((8, 12, 12), (16, 8, 8)):
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  1_000_000.0, sections)
        got = layers.apply_rope(torch.from_numpy(x), layers.rope_tables(
            torch.from_numpy(pos), 64, 1_000_000.0, sections))
        close(got.numpy(), want, sections, rel=1e-6)
    # without sections a three-plane position takes plane 0, as in JAX
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, None)
    got = layers.apply_rope(torch.from_numpy(x), layers.rope_tables(
        torch.from_numpy(pos), 64, 1e4))
    close(got.numpy(), want, "plane 0", rel=1e-6)


def test_mrope_planes_differ():
    """The port passes the JAX package's property: varying only the height
    plane changes the height-section bands and nothing else."""
    b, s, h, d = 1, 4, 2, 32
    x = torch.ones((b, s, h, d))
    sections = (4, 6, 6)
    pos_a = torch.zeros((b, s, 3), dtype=torch.int32)
    pos_b = pos_a.clone()
    pos_b[..., 1] = 7
    a = layers.apply_rope(x, layers.rope_tables(pos_a, d, 1e4, sections))
    bb = layers.apply_rope(x, layers.rope_tables(pos_b, d, 1e4, sections))
    diff = (a - bb).abs().sum(dim=(0, 1, 2)).numpy()
    half = d // 2
    for i in range(half):
        in_height = 4 <= i < 10
        assert (diff[i] > 1e-6) == in_height, (i, diff[i])
        assert (diff[half + i] > 1e-6) == in_height


def test_mrope_text_degenerates_to_rope():
    """Equal (t, h, w) planes give plain RoPE at the same positions, bit
    for bit."""
    b, s, h, d = 2, 6, 2, 16
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, h, d)).astype(np.float32))
    pos1d = torch.arange(s, dtype=torch.int32).expand(b, s)
    pos3d = pos1d[..., None].expand(b, s, 3)
    plain = layers.apply_rope(x, layers.rope_tables(pos1d, d, 1e4))
    mrope = layers.apply_rope(x, layers.rope_tables(pos3d, d, 1e4,
                                                    (2, 3, 3)))
    assert torch.equal(mrope, plain)


def test_sections_without_three_planes_raise():
    """The JAX package asserts three-plane positions whenever sections are
    set; the port raises, and invents no default positions."""
    with pytest.raises(ValueError, match="M-RoPE"):
        layers.rope_tables(torch.zeros((1, 4), dtype=torch.int32), 64, 1e4,
                           (8, 12, 12))
    cfg = base.get_smoke_config(ARCH)
    p = registry.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="M-RoPE"):
        registry.apply_model(p, cfg, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)})


def test_build_positions_and_model_batch_match_jax():
    jcfg, cfg = jbase.get_smoke_config(ARCH), base.get_smoke_config(ARCH)
    pos = np.array([[3, 4, 5], [-1, 0, 1]], np.int32)
    got = registry.build_positions(cfg, pos)
    want = np.asarray(jregistry.build_positions(jcfg, jnp.asarray(pos)))
    assert got.shape == (2, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    tiny = base.get_smoke_config("tinyllama-1.1b")
    np.testing.assert_array_equal(
        registry.build_positions(tiny, pos).numpy(), pos)
    raw = lm.SyntheticLM(lm.SyntheticLMConfig(512, 24)).worker_batch(3, 2, 2)
    jb, stubs = jax_stub_batch(jcfg, raw, 3)
    for s in (None, stubs):
        b = lm.model_batch(cfg, raw, "cpu", step=3, stubs=s)
        assert sorted(b) == sorted(jb)
        np.testing.assert_array_equal(b["positions"].numpy(),
                                      np.asarray(jb["positions"]))
        v = b["vision_embeds"]
        assert v.dtype == torch.bfloat16 and v.shape == (2, 2, 16, 256)
    np.testing.assert_array_equal(
        b["vision_embeds"].float().numpy(),
        np.asarray(jb["vision_embeds"], np.float32))
    # the port's own draws: seeded by the step, 0.02-scaled
    a = lm.model_batch(cfg, raw, "cpu", step=3)["vision_embeds"]
    assert torch.equal(a, lm.model_batch(cfg, raw, "cpu",
                                         step=3)["vision_embeds"])
    assert not torch.equal(a, lm.model_batch(cfg, raw, "cpu",
                                             step=4)["vision_embeds"])
    assert 0.015 < float(a.float().std()) < 0.025
    assert lm.model_batch(None, raw, "cpu").keys() == raw.keys()


# -------------------------------------------------------------- logits --
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 4e-2)])
def test_logits_with_vision_embeds_match_jax(dtype, rel):
    """24 tokens of which the first 16 slots take the patch embeddings,
    alone and under a worker axis of 2 (the JAX package's vmap)."""
    jcfg, jp, cfg, p = pair(dtype=dtype)
    raw = lm.SyntheticLM(lm.SyntheticLMConfig(512, 24, seed=1)
                         ).worker_batch(0, 2, 2)
    jb, stubs = jax_stub_batch(jcfg, raw, 0)
    b = lm.model_batch(cfg, raw, "cpu", stubs=stubs)
    one = {k: v[0] for k, v in jb.items()}
    want, _, _ = jregistry.apply_model(jp, jcfg, one)
    got = registry.apply_model(p, cfg, {k: v[0] for k, v in b.items()})
    close(got.float().numpy(), want, "one model", rel)
    without = registry.apply_model(p, cfg, {
        k: v[0] for k, v in b.items() if k != "vision_embeds"})
    assert not torch.allclose(got, without)
    stacked = T.tree_map(lambda t: torch.stack([t, 1.01 * t]), p)
    jstacked = jax.tree_util.tree_map(lambda t: jnp.stack([t, 1.01 * t]),
                                      jp)
    want = jax.vmap(lambda pp, bb: jregistry.apply_model(pp, jcfg, bb)[0])(
        jstacked, jb)
    got = registry.apply_model(stacked, cfg, b)
    close(got.float().numpy(), want, "worker axis", rel)


def test_prefill_and_cached_decode_match_the_uncached_forward():
    """Text only (serving passes no vision embeds, as in the JAX package):
    a 12-token prefill into a contiguous cache and four decode steps on
    three-plane positions give the uncached forward's logits, the JAX
    package's."""
    jcfg, jp, cfg, p = pair()
    seq = tokens((2, 16), seed=2)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    truth, _, _ = jregistry.apply_model(jp, jcfg, {
        "tokens": jnp.asarray(seq),
        "positions": jregistry.build_positions(jcfg, jnp.asarray(pos))})
    truth = np.asarray(truth)
    cache = registry.init_cache(cfg, 2, 16, dtype=torch.float32)
    logits = registry.apply_model(p, cfg, {
        "tokens": torch.from_numpy(seq[:, :12]),
        "positions": registry.build_positions(cfg, pos[:, :12])},
        caches=cache)
    close(logits.numpy(), truth[:, :12], "prefill")
    for i in range(12, 16):
        logits, _ = registry.decode_step(
            p, cfg, torch.from_numpy(seq[:, i:i + 1]),
            registry.build_positions(cfg, np.full((2, 1), i, np.int32)),
            cache)
        close(logits.numpy()[:, 0], truth[:, i], f"decode {i}")


def test_window_override_ring_on_three_plane_positions():
    """A window of 4 in a 32-slot cache (a ring of 4 slots): an 11-token
    prefill and three decode steps equal the uncached forward with the
    same window, and the JAX package's; the ring's ``kv_pos`` holds plane
    0's positions."""
    jcfg, jp, cfg, p = pair()
    seq = tokens((2, 14), seed=3)
    pos = np.tile(np.arange(14, dtype=np.int32), (2, 1))
    truth, _, _ = jregistry.apply_model(jp, jcfg, {
        "tokens": jnp.asarray(seq),
        "positions": jregistry.build_positions(jcfg, jnp.asarray(pos))},
        window_override=4)
    truth = np.asarray(truth)
    cache = registry.init_cache(cfg, 2, 32, dtype=torch.float32,
                                window_override=4)
    ring = cache["units"]["p0"]
    assert ring["k"].shape[2] == 4
    logits = registry.apply_model(p, cfg, {
        "tokens": torch.from_numpy(seq[:, :11]),
        "positions": registry.build_positions(cfg, pos[:, :11])},
        caches=cache, window_override=4)
    close(logits.numpy(), truth[:, :11], "prefill")
    assert sorted(ring["kv_pos"][0, 0].tolist()) == [7, 8, 9, 10]
    for i in range(11, 14):
        logits, _ = registry.decode_step(
            p, cfg, torch.from_numpy(seq[:, i:i + 1]),
            registry.build_positions(cfg, np.full((2, 1), i, np.int32)),
            cache, window_override=4)
        close(logits.numpy()[:, 0], truth[:, i], f"decode {i}")


# ------------------------------------------------------------- serving --
def serve_cfg(cls, **kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 48)
    kw.setdefault("pages_per_seq", 16)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_bits", 32)
    kw.setdefault("cache_dtype", "float32")
    return cls(**kw)


def prompts(vocab, lens, seed=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def test_paged_and_lockstep_tokens_match_jax(monkeypatch):
    """Four requests for three slots through both schedulers (the paged
    decode kernel route, inactive slots at position -1 on every plane),
    and a two-wave mixed stream through both lockstep engines (bf16 K/V
    caches, as in both packages): equal token for token, 0 pages in use."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair()
    ps, news = prompts(512, (9, 14, 6, 11)), (10, 5, 8, 7)
    js = JScheduler(jcfg, jp, serve_cfg(JServeConfig))
    jr = [js.submit(q, m) for q, m in zip(ps, news)]
    jout = js.run()
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig), device="cpu")
    rids = [sched.submit(q, m) for q, m in zip(ps, news)]
    out = sched.run()
    assert sched.pool.in_use == 0 and sched.decode_steps > 0
    for a, b in zip(rids, jr):
        assert out[a].tolist() == jout[b].tolist()
    want = jserve.LockstepEngine(jcfg, jp, batch=2).run(ps, 6)
    got = serve.LockstepEngine(cfg, p, batch=2, device="cpu").run(ps, 6)
    for i in range(len(ps)):
        assert got["outputs"][i].tolist() == want["outputs"][i].tolist(), i


def test_serve_cli_serves_qwen2_vl_smoke(capsys):
    out = serve.main(["--device", "cpu", "--arch", "qwen2-vl-7b", "--smoke",
                      "--prompt-lens", "9,5", "--decode-tokens", "3"])
    assert "arch=qwen2-vl-smoke engine=paged" in capsys.readouterr().out
    assert out["final_pages_in_use"] == 0
    assert all(len(v) == 3 for v in out["outputs"].values())


# ------------------------------------------------------------ training --
N, BATCH, SEQ, STEPS = 2, 2, 24, 2


def train_flags(arch, extra=()):
    return ["--arch", arch, "--smoke", "--workers", str(N), "--batch",
            str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
            "--local-steps", "2", "--lr", "2e-3", "--xi", "0.999",
            "--bits", "6", "--omega", "0.9995", "--groups", "leaf",
            "--device", "cpu", "--log-every", "1", "--tau0", "5.0",
            *extra]


def jax_run_admm(jcfg):
    """The JAX package's run_admm loop (quantized): the JAX init, every
    step's metrics, and each step's stub draws (``PRNGKey(step)``)."""
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
    metrics, stubs = [], []
    for i in range(STEPS):
        batch, st = jax_stub_batch(jcfg, data.worker_batch(i, N, BATCH // N),
                                   i)
        state, m = step(state, batch, jax.random.PRNGKey(1000 + i))
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
        stubs.append(st)
    return one, metrics, stubs


def jax_step_draws(dim):
    def uniforms(i, phase):
        k = jax.random.split(jax.random.PRNGKey(1000 + i))[phase]
        return torch.from_numpy(np.array(
            jax.random.uniform(k, (N, dim), jnp.float32)))
    return uniforms


def run_admm_pair(arch):
    """The port's ``run_admm`` and the JAX loop from the JAX init, the JAX
    rounding and stub draws injected: C5's tolerances."""
    jcfg = jbase.get_smoke_config(arch).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(arch).with_overrides(dtype="float32")
    one, jm, stubs = jax_run_admm(jcfg)
    params = interop.model_params_from_numpy(flat(one), cfg, "cpu")
    args = train.build_parser().parse_args(train_flags(arch))
    dim = sum(x.numel() for x in T.leaves(params))
    out = train.run_admm(cfg, args, params=params,
                         uniforms=jax_step_draws(dim),
                         stubs=lambda i: stubs[i])
    assert out["n_groups"] == len(T.leaves(out["state"].theta))
    for i in range(STEPS):
        np.testing.assert_array_equal(out["bits_per_group"][i],
                                      jm[i]["bits_per_group"])
    np.testing.assert_allclose(out["history"],
                               [float(m["loss"]) for m in jm], atol=1e-3)
    assert np.isfinite(out["history"]).all()
    return out


def test_cq_ggadmm_qwen2_vl_smoke_matches_jax():
    run_admm_pair(ARCH)
