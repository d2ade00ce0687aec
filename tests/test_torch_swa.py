"""The sliding-window family through the port: the ``swa`` block kind, the
h2o-danube-1.8b, gemma3-4b and mistral-large-123b configs, ``window_override``,
windowed contiguous and paged caches, and SWA page recycling, against the
JAX package on numpy-seeded inputs (the JAX init carried across).

Tolerances and their reasons:

* logits, float32 activations: 1e-5 of max|logit| (the two frameworks'
  float32 products add in different orders);
* greedy token streams, block tables, ``kv_pos`` and page counters: equal
  (host decisions on logits that agree to float32 rounding, and the same
  allocator);
* ``unmap_pages``: every leaf bit for bit (it only rewrites table entries
  and positions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import registry as jregistry
from repro.serving import paging as jpaging
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.models import blocks, registry
from repro_torch.launch import serve
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig

PAGE, PPS = 4, 16
SWA_ARCHS = ("h2o-danube-1.8b", "gemma3-4b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch, **overrides):
    """(JAX cfg, JAX params, port cfg, port params), float32 activations."""
    overrides = dict(dtype="float32", **overrides)
    jcfg = jbase.get_smoke_config(arch).with_overrides(**overrides)
    cfg = base.get_smoke_config(arch).with_overrides(**overrides)
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jcfg, jp, cfg, interop.model_params_from_numpy(flat, cfg, "cpu")


def close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, tol = np.abs(got - want).max(), 1e-5 * np.abs(want).max()
    assert err <= tol, (what, err, tol)


def tokens(shape, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def prompts(vocab, lens, seed=4):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def serve_cfg(cls, **kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("num_pages", 48)
    kw.setdefault("pages_per_seq", PPS)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_bits", 32)
    kw.setdefault("cache_dtype", "float32")
    return cls(**kw)


def run_stream(sched, ps, news):
    rids = [sched.submit(p, m) for p, m in zip(ps, news)]
    out = sched.run()
    assert sched.pool.in_use == 0
    return [out[r].tolist() for r in rids]


# ------------------------------------------------------ configs, blocks --
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma3-4b",
                                  "mistral-large-123b"])
def test_configs_registered_as_in_jax(arch):
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "block_unit", "resolved_head_dim",
                  "sliding_window", "rope_theta", "long_context",
                  "long_context_window", "source"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.block_kinds == jcfg.block_kinds
        assert (cfg.for_long_context().sliding_window
                == jcfg.for_long_context().sliding_window)
    assert arch in base.list_architectures()
    smoke = base.get_smoke_config(arch)
    assert registry.count_params(smoke) == jregistry.count_params(
        jbase.get_smoke_config(arch))


def test_swa_kind_is_ported():
    assert "swa" in blocks.PORTED_KINDS
    cfg = base.get_smoke_config("h2o-danube-1.8b")
    p = blocks.init("swa", torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(p) == ["attn", "ln1", "ln2", "mlp"]
    ctx = blocks.BlockCtx(positions=None)
    assert blocks._window_for("swa", cfg, ctx) == cfg.sliding_window
    assert blocks._window_for("attn", cfg, ctx) is None
    over = blocks.BlockCtx(positions=None, window_override=5)
    assert blocks._window_for("attn", cfg, over) == 5


# ---------------------------------------------------------------- logits --
@pytest.mark.parametrize("arch", SWA_ARCHS)
def test_apply_model_logits_match_jax(arch):
    """80 tokens against a 64-token window: the window masks."""
    jcfg, jp, cfg, p = pair(arch)
    toks = tokens((2, 80), seed=1)
    want, _, _ = jregistry.apply_model(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)})
    close(got.numpy(), want, arch)


def test_long_context_window_override():
    """The analogue of the JAX package's test: a window of 4 changes the
    attention output of tinyllama-smoke, and equals the JAX package's with
    the same override (also through the losses)."""
    jcfg, jp, cfg, p = pair("tinyllama-1.1b")
    toks = tokens((2, 12), seed=2)
    a = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)})
    b = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                             window_override=4)
    assert not np.allclose(a.numpy(), b.numpy())
    jb, _, _ = jregistry.apply_model(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                     window_override=4)
    close(b.numpy(), jb, "window_override")
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    jloss, _ = jregistry.lm_loss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)},
                                 window_override=4)
    got = registry.lm_loss_tokens(p, cfg, batch, window_override=4)
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    assert float(got) != float(registry.lm_loss_tokens(p, cfg, batch))


@pytest.mark.parametrize("arch", SWA_ARCHS)
def test_contiguous_ring_cache_matches_the_uncached_forward(arch):
    """A window of 8 in a 32-slot cache: the ring holds min(32, 8) slots,
    as in the JAX package. A 12-token prefill and three decode steps give
    the logits of the JAX package's forward over the whole sequence
    without a cache. The JAX package's own ring prefill does not: it
    attends over the ring after the chunk's writes, which have overwritten
    keys the chunk's earlier queries see (ROADMAP C17); the port attends
    over the ring as it was and the chunk."""
    jcfg, jp, cfg, p = pair(arch, sliding_window=8)
    jcache = jregistry.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    cache = registry.init_cache(cfg, 2, 32, dtype=torch.float32)
    for i, kind in enumerate(cfg.block_unit):
        want = 8 if kind == "swa" else 32
        assert cache["units"][f"p{i}"]["k"].shape[2] == want
        assert jcache["units"][f"p{i}"]["k"].shape[2] == want
    seq = tokens((2, 15), seed=3)
    truth, _, _ = jregistry.apply_model(jp, jcfg,
                                        {"tokens": jnp.asarray(seq)})
    truth = np.asarray(truth)
    logits = registry.apply_model(
        p, cfg, {"tokens": torch.from_numpy(seq[:, :12])}, caches=cache)
    close(logits.numpy(), truth[:, :12], "prefill")
    for i in range(12, 15):
        pos = np.full((2, 1), i, np.int32)
        logits, _ = registry.decode_step(p, cfg,
                                         torch.from_numpy(seq[:, i:i + 1]),
                                         torch.from_numpy(pos), cache)
        close(logits.numpy()[:, 0], truth[:, i], f"decode {i}")
    jl, _, _ = jregistry.apply_model(
        jp, jcfg, {"tokens": jnp.asarray(seq[:, :12])}, caches=jcache)
    assert np.abs(np.asarray(jl)[:, -1] - truth[:, 11]).max() > 1e-2
    over = registry.init_cache(cfg, 1, 32, window_override=4)
    assert all(c["k"].shape[2] == 4 for c in over["units"].values())


@pytest.mark.parametrize("arch", SWA_ARCHS)
def test_windowed_paged_prefill_and_decode_match_jax(arch, monkeypatch):
    """A window of 4, shorter than one 8-token prefill chunk, on the paged
    cache: the chunk gathers its pages and masks by the window
    (``paged_gather`` + ``mha``), and each decode step of an SWA layer
    does the same (the kernel route is for windowless layers), with an
    inactive slot in every step."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair(arch, sliding_window=4)
    jcache = jpaging.init_paged_cache(jcfg, 3, 64, PAGE, PPS, jnp.float32)
    cache = paging.init_paged_cache(cfg, 3, 64, PAGE, PPS, torch.float32)
    pool = paging.PagePool(64)
    for b in range(3):
        row = paging.build_block_table_row(pool.alloc(PPS), PPS)
        jcache = jpaging.admit_slot(jcache, jnp.int32(b), jnp.asarray(row))
        paging.admit_slot(cache, b, row)
    toks = tokens((3, 8), seed=5)
    jl, _, jcache = jregistry.apply_model(jp, jcfg,
                                          {"tokens": jnp.asarray(toks)},
                                          caches=jcache)
    logits = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                                  caches=cache)
    close(logits.numpy(), jl, "prefill")
    t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.full((3, 1), 8 + i, np.int32)
        pos[1] = -1
        jl, jcache = jregistry.decode_step(jp, jcfg, jnp.asarray(t),
                                           jnp.asarray(pos), jcache)
        logits, _ = registry.decode_step(p, cfg, torch.from_numpy(t),
                                         torch.from_numpy(pos), cache)
        close(logits.numpy()[[0, 2]], np.asarray(jl)[[0, 2]], f"decode {i}")
        t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


# ------------------------------------------------------------- serving --
@pytest.mark.parametrize("arch", SWA_ARCHS)
def test_scheduler_and_lockstep_tokens_match_jax(arch, monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair(arch, sliding_window=8)
    ps, news = prompts(512, (9, 14, 6)), (12, 8, 10)
    want = run_stream(JScheduler(jcfg, jp, serve_cfg(JServeConfig)), ps,
                      news)
    got = run_stream(Scheduler(cfg, p, serve_cfg(ServeConfig),
                               device="cpu"), ps, news)
    assert got == want
    # the lockstep engine (one request a wave: no padding) gives the paged
    # tokens; the JAX package's lockstep ring prefill does not (ROADMAP C17)
    for prompt, m, toks in zip(ps, news, got):
        lock = serve.run_lockstep(cfg, p, [prompt], m, batch=1,
                                  device="cpu")
        assert lock["outputs"][0].tolist() == toks


def test_swa_recycling_zero_leak_and_identical():
    """The analogue of the JAX package's test: h2o-danube-smoke with a
    window of 8 frees the pages wholly behind the window mid-request,
    gives the tokens of the run without recycling, leaks no page, and
    recycles the pages the JAX scheduler recycles."""
    jcfg, jp, cfg, p = pair("h2o-danube-1.8b", sliding_window=8)
    ps, news = prompts(512, (9, 14, 6)), (20, 12, 16)
    plain_sched = Scheduler(cfg, p, serve_cfg(ServeConfig), device="cpu")
    plain = run_stream(plain_sched, ps, news)
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig, swa_recycle=True),
                      device="cpu")
    recycled = run_stream(sched, ps, news)
    assert recycled == plain
    assert sched.swa_recycled_pages > 0
    jsched = JScheduler(jcfg, jp, serve_cfg(JServeConfig, swa_recycle=True))
    assert run_stream(jsched, ps, news) == recycled
    assert jsched.swa_recycled_pages == sched.swa_recycled_pages
    assert jsched.peak_pages_in_use == sched.peak_pages_in_use
    # full reservation at admission fixes the peak at tick 0; under
    # watermark admission pages are mapped as the sequences reach them,
    # and recycling lowers the peak
    peaks = []
    for recycle in (False, True):
        s2 = Scheduler(cfg, p, serve_cfg(ServeConfig, preempt=True,
                                         swa_recycle=recycle), device="cpu")
        assert run_stream(s2, ps, news) == plain
        peaks.append(s2.peak_pages_in_use)
    assert peaks[1] < peaks[0], peaks


def test_swa_recycling_rejects_a_stack_that_is_not_pure_swa():
    gemma = base.get_smoke_config("gemma3-4b")
    assert ServeConfig(swa_recycle=True).swa_recycle
    with pytest.raises(ValueError, match="swa_recycle"):
        Scheduler(gemma, None, serve_cfg(ServeConfig, swa_recycle=True),
                  device="cpu")
    with pytest.raises(ValueError, match="swa_recycle"):
        JScheduler(jbase.get_smoke_config("gemma3-4b"), None,
                   serve_cfg(JServeConfig, swa_recycle=True))


def test_unmap_pages_matches_jax_bitwise():
    """After the port's prefill of two sequences, the same cache in both
    packages; drop logical pages of slot 0 of which only some are recycled
    (the others are still mapped elsewhere): every leaf equal to the JAX
    package's, bit for bit."""
    _, _, cfg, p = pair("h2o-danube-1.8b", sliding_window=8)
    cache = paging.init_paged_cache(cfg, 2, 64, PAGE, PPS, torch.float32)
    for b in range(2):
        paging.admit_slot(cache, b, paging.build_block_table_row(
            range(b * PPS, (b + 1) * PPS), PPS))
    registry.apply_model(p, cfg, {"tokens": torch.from_numpy(
        tokens((2, 20), seed=6))}, caches=cache)
    jcache = {k: {n: {leaf: jnp.asarray(x.numpy()) for leaf, x in c.items()}
                  for n, c in v.items()} for k, v in cache.items()}
    recycled = paging.build_block_table_row([0, 2], PPS)
    jcache = jpaging.unmap_pages(jcache, jnp.int32(0),
                                 jnp.asarray([0, 1, 2], jnp.int32),
                                 jnp.asarray(recycled))
    paging.unmap_pages(cache, 0, [0, 1, 2], recycled)
    jc, c = jcache["units"]["p0"], cache["units"]["p0"]
    assert (c["block_tables"][:, 0, :3] == -1).all()
    assert (c["kv_pos"][:, [0, 2]] == -1).all()
    assert (c["kv_pos"][:, 1] >= 0).all()
    for name in c:
        np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)


def test_serve_swa_recycle_flag(capsys):
    """``--swa-recycle`` disables itself on a stack that is not pure SWA,
    with the JAX package's message, and recycles on h2o-danube-smoke."""
    out = serve.main(["--device", "cpu", "--smoke", "--prompt-lens", "9,5",
                      "--decode-tokens", "3", "--swa-recycle"])
    said = capsys.readouterr().out
    assert ("[serve] tinyllama-smoke is not pure sliding-window attention: "
            "disabling --swa-recycle") in said
    assert out["swa_recycled_pages"] == 0
    out = serve.main(["--device", "cpu", "--arch", "h2o-danube-1.8b",
                      "--smoke", "--prompt-lens", "90,40", "--decode-tokens",
                      "8", "--swa-recycle"])
    assert "swa_recycled=" in capsys.readouterr().out
    assert out["swa_recycled_pages"] > 0
    assert out["final_pages_in_use"] == 0
