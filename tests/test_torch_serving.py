"""The port's serving path (paged cache, continuous-batching scheduler,
lockstep engine, serve CLI) against the JAX package, on the CPU, at the
tinyllama smoke config (2 layers, d_model 256, 8 heads, 2 KV heads, vocab
512) with the JAX parameters carried across by ``interop``.

Tolerances and their reasons:

* logits, float32 activations: 1e-5 of the largest logit (the two
  frameworks sum the matrix products in different orders). The JAX side
  runs with ``REPRO_PAGED_ATTN_KERNEL=1``, so that its single-token paged
  decode takes the one-shot kernel (interpret mode), which is the port's
  decode route on every device.
* greedy tokens: equal, with float32 activations and pools (bf16 rounds
  at other places in XLA and PyTorch, ROADMAP C); the int8-against-f32
  check is the JAX package's own test at its own setting (bf16
  activations, a float32 cache), run on the port.
* temperature sampling: the JAX package's threefry keys cannot be
  reproduced, so only the port's own replay determinism is held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.serving import paging as jpaging
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig

PAGE, PPS = 4, 16                       # page_size, pages_per_seq
CACHE_LEN = PAGE * PPS
LENS, NEWS = (9, 17, 5, 13), (5, 3, 6, 4)


@pytest.fixture(scope="module")
def smoke():
    """(JAX cfg, JAX params, port cfg, port params), float32 activations."""
    jcfg = jbase.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    cfg = base.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jcfg, jp, cfg, interop.model_params_from_numpy(flat, cfg, "cpu")


@pytest.fixture
def jax_kernel_route(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    monkeypatch.delenv("REPRO_PAGED_ATTN_ONLINE", raising=False)


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _serve_cfg(cls, **kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("num_pages", 48)
    kw.setdefault("pages_per_seq", PPS)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_bits", 32)
    kw.setdefault("cache_dtype", "float32")
    return cls(**kw)


def _port_sched(cfg, params, **kw):
    return Scheduler(cfg, params, _serve_cfg(ServeConfig, **kw),
                     device="cpu")


def _serve(sched, prompts, news):
    rids = [sched.submit(p, m) for p, m in zip(prompts, news)]
    out = sched.run()
    return [out[r].tolist() for r in rids]


def _paged_pair(jcfg, cfg, batch, kv_bits):
    """JAX and port paged caches with the same slots bound."""
    jcache = jpaging.init_paged_cache(jcfg, batch, 64, PAGE, PPS,
                                      jnp.float32, kv_bits=kv_bits)
    cache = paging.init_paged_cache(cfg, batch, 64, PAGE, PPS,
                                    torch.float32, kv_bits=kv_bits)
    pool = paging.PagePool(64)
    for b in range(batch):
        row = paging.build_block_table_row(pool.alloc(PPS), PPS)
        jcache = jpaging.admit_slot(jcache, jnp.int32(b), jnp.asarray(row))
        paging.admit_slot(cache, b, row)
    return jcache, cache


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


# ------------------------------------------------------------- logits --
@pytest.mark.parametrize("kv_bits", [32, 8, 4])
def test_paged_prefill_and_decode_logits_match_jax(smoke, jax_kernel_route,
                                                   kv_bits):
    """Prefill (S > 1: gather + mha) and three decode steps (S = 1: the
    paged-attention route) on a paged cache, with an inactive slot (-1)
    in every decode step."""
    jcfg, jp, cfg, p = smoke
    jcache, cache = _paged_pair(jcfg, cfg, 3, kv_bits)
    toks = np.random.default_rng(1).integers(0, 512, (3, 7)).astype(np.int32)
    jl, _, jcache = jregistry.apply_model(jp, jcfg,
                                          {"tokens": jnp.asarray(toks)},
                                          caches=jcache)
    logits = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                                  caches=cache)
    _close(logits.numpy(), jl, "prefill")
    t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.full((3, 1), 7 + i, np.int32)
        pos[1] = -1                                   # an inactive slot
        jl, jcache = jregistry.decode_step(jp, jcfg, jnp.asarray(t),
                                           jnp.asarray(pos), jcache)
        logits, _ = registry.decode_step(p, cfg, torch.from_numpy(t),
                                         torch.from_numpy(pos), cache)
        _close(logits.numpy()[[0, 2]], np.asarray(jl)[[0, 2]],
               f"decode {i}")
        t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jc = jcache["units"]["p0"]
    c = cache["units"]["p0"]
    np.testing.assert_array_equal(c["kv_pos"].numpy(), np.asarray(jc["kv_pos"]))
    np.testing.assert_array_equal(c["block_tables"].numpy(),
                                  np.asarray(jc["block_tables"]))
    if kv_bits == 32:
        _close(c["k_pages"].numpy(), jc["k_pages"], "k pool")
        _close(c["v_pages"].numpy(), jc["v_pages"], "v pool")
    else:
        _close(c["k_scale"].numpy(), jc["k_scale"], "k ranges")


def test_contiguous_prefill_and_decode_logits_match_jax(smoke):
    jcfg, jp, cfg, p = smoke
    toks = np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32)
    jcache = jregistry.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    cache = registry.init_cache(cfg, 2, 32, dtype=torch.float32)
    jl, _, jcache = jregistry.apply_model(jp, jcfg,
                                          {"tokens": jnp.asarray(toks)},
                                          caches=jcache)
    logits = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                                  caches=cache)
    _close(logits.numpy(), jl, "prefill")
    t = np.array([[3], [5]], np.int32)
    for i in range(3):
        pos = np.full((2, 1), 9 + i, np.int32)
        jl, jcache = jregistry.decode_step(jp, jcfg, jnp.asarray(t),
                                           jnp.asarray(pos), jcache)
        logits, _ = registry.decode_step(p, cfg, torch.from_numpy(t),
                                         torch.from_numpy(pos), cache)
        _close(logits.numpy(), jl, f"decode {i}")


def test_paged_decode_with_no_active_slot_leaves_the_pools(smoke):
    """A decode step whose every position is -1 writes nothing (the JAX
    package drops such writes; the port does without a host sync)."""
    _, _, cfg, p = smoke
    _, cache = _paged_pair(jbase.get_smoke_config("tinyllama-1.1b"), cfg, 2,
                           32)
    registry.apply_model(p, cfg, {"tokens": torch.ones((2, 5), dtype=torch.int32)},
                         caches=cache)
    before = {k: v.clone() for k, v in cache["units"]["p0"].items()}
    registry.decode_step(p, cfg, torch.ones((2, 1), dtype=torch.int32),
                         torch.full((2, 1), -1, dtype=torch.int32), cache)
    for k, v in cache["units"]["p0"].items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------- scheduler --
def test_scheduler_greedy_tokens_match_jax_scheduler(smoke,
                                                     jax_kernel_route):
    jcfg, jp, cfg, p = smoke
    prompts = _prompts(512, LENS)
    jsched = JScheduler(jcfg, jp, _serve_cfg(JServeConfig))
    want = _serve(jsched, prompts, NEWS)
    got = _serve(_port_sched(cfg, p), prompts, NEWS)
    assert got == want


def test_scheduler_matches_lockstep_and_contiguous_reference(smoke):
    """Paged greedy tokens equal the lockstep engine's (one request per
    wave: no padding) and a per-request contiguous decode."""
    _, _, cfg, p = smoke
    prompts = _prompts(512, LENS)
    got = _serve(_port_sched(cfg, p), prompts, NEWS)
    for prompt, m, toks in zip(prompts, NEWS, got):
        lock = serve.LockstepEngine(cfg, p, batch=1, device="cpu").run(
            [prompt], m)
        assert lock["outputs"][0].tolist() == toks
        cache = registry.init_cache(cfg, 1, CACHE_LEN, dtype=torch.float32)
        logits = registry.apply_model(
            p, cfg, {"tokens": torch.from_numpy(prompt[None])}, caches=cache)
        ref = [int(torch.argmax(logits[0, -1]))]
        for i in range(m - 1):
            pos = torch.full((1, 1), len(prompt) + i, dtype=torch.int32)
            logits, cache = registry.decode_step(
                p, cfg, torch.tensor([[ref[-1]]], dtype=torch.int32), pos,
                cache)
            ref.append(int(torch.argmax(logits[0, -1])))
        assert ref == toks


def test_scheduler_mixed_stream_completes_without_leaks(smoke):
    _, _, cfg, p = smoke
    sched = _port_sched(cfg, p)
    lens, news = (9, 17, 5, 13, 9, 3), (5, 3, 7, 4, 6, 2)
    out = _serve(sched, _prompts(512, lens), news)
    assert [len(o) for o in out] == list(news)
    assert sched.pool.in_use == 0
    assert sched.pool.free_count == sched.cfg.num_pages
    assert 0 < sched.peak_pages_in_use <= sched.cfg.num_pages


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_scheduler_quantized_stream_completes_without_leaks(smoke, kv_bits):
    _, _, cfg, p = smoke
    sched = _port_sched(cfg, p, kv_bits=kv_bits)
    out = _serve(sched, _prompts(512, LENS), NEWS)
    assert [len(o) for o in out] == list(NEWS)
    assert sched.pool.in_use == 0


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_scheduler_quantized_greedy_tokens_match_jax(smoke, jax_kernel_route,
                                                     kv_bits):
    jcfg, jp, cfg, p = smoke
    prompts = _prompts(512, LENS)
    want = _serve(JScheduler(jcfg, jp, _serve_cfg(JServeConfig,
                                                  kv_bits=kv_bits)),
                  prompts, NEWS)
    assert _serve(_port_sched(cfg, p, kv_bits=kv_bits), prompts,
                  NEWS) == want


def test_scheduler_int8_greedy_matches_f32_cache(smoke):
    """The JAX package's claim at its own setting (the config's bf16
    activations, a float32 cache): int8 pages decode the same greedy
    tokens as float32 pages on this stream. (With float32 activations the
    last token of the fourth request differs, in both packages alike.)"""
    _, _, cfg, p = smoke
    cfg = cfg.with_overrides(dtype="bfloat16")
    runs = [_serve(_port_sched(cfg, p, kv_bits=bits), _prompts(512, LENS),
                   NEWS) for bits in (8, 32)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("sample", ["greedy", "temp"])
def test_scheduler_deterministic_replay(smoke, sample):
    _, _, cfg, p = smoke
    runs = [_serve(_port_sched(cfg, p, sample=sample, temperature=0.8,
                               seed=7), _prompts(512, LENS), NEWS)
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_scheduler_defrag_is_content_preserving(smoke):
    _, _, cfg, p = smoke
    prompts = _prompts(512, (9, 5, 13, 9, 7))
    news = (6, 3, 5, 4, 6)
    plain = _serve(_port_sched(cfg, p, num_pages=32), prompts, news)
    sched = _port_sched(cfg, p, num_pages=32, defrag_every=3)
    assert _serve(sched, prompts, news) == plain
    assert sched.pool.in_use == 0


def test_scheduler_admission_blocks_until_pages_free(smoke):
    _, _, cfg, p = smoke
    need = paging.pages_needed(9 + 4, PAGE)
    sched = _port_sched(cfg, p, num_pages=need, max_seqs=2)
    rids = [sched.submit(q, 4) for q in _prompts(512, (9, 9, 9))]
    peak = 0
    while sched.busy:
        sched.step()
        peak = max(peak, sum(s is not None for s in sched.slots))
    assert sorted(sched.finished) == sorted(rids)
    assert peak == 1
    assert sched.pool.in_use == 0


def test_scheduler_rejects_oversized_request(smoke):
    _, _, cfg, p = smoke
    sched = _port_sched(cfg, p)
    with pytest.raises(ValueError, match="exceeds the serve capacity"):
        sched.submit(np.zeros((CACHE_LEN,), np.int32), 1)
    with pytest.raises(ValueError):
        sched.submit([], 1)


def test_peak_pages_counts_same_tick_admit_and_evict(smoke):
    _, _, cfg, p = smoke
    sched = _port_sched(cfg, p)
    sched.submit(_prompts(512, (1,))[0], 1)
    sched.run()
    assert sched.pool.in_use == 0
    assert sched.peak_pages_in_use > 0


def test_scheduler_decodes_through_the_paged_attention_route(
        smoke, monkeypatch):
    """Every decode tick calls ``ops.paged_attention_decode`` once per
    layer (on the CPU it runs the plain version and counts no launch)."""
    _, _, cfg, p = smoke
    calls = []
    real = ops.paged_attention_decode
    monkeypatch.setattr(ops, "paged_attention_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sched = _port_sched(cfg, p)
    _serve(sched, _prompts(512, LENS), NEWS)
    assert len(calls) == cfg.num_layers * sched.decode_steps


# ----------------------------------------------------- config and pool --
def test_serve_config_defaults_and_unported_policies(monkeypatch):
    monkeypatch.delenv("REPRO_SERVE_KV_BITS", raising=False)
    assert ServeConfig().kv_bits == 32
    monkeypatch.setenv("REPRO_SERVE_KV_BITS", "8")
    assert ServeConfig().kv_bits == 8
    assert ServeConfig(kv_bits=4).kv_bits == 4
    with pytest.raises(ValueError, match="kv_bits"):
        ServeConfig(kv_bits=16)
    for kw in (dict(share_prefix=True), dict(preempt=True),
               dict(preempt_mode="swap"), dict(swa_recycle=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeConfig(**kw)


def test_quantized_cache_pools_and_page_bytes():
    cfg = base.get_smoke_config("tinyllama-1.1b")
    jcfg = jbase.get_smoke_config("tinyllama-1.1b")
    page_bytes = {}
    for bits in (32, 8, 4):
        cache = paging.init_paged_cache(
            cfg, 2, 16, PAGE, PPS,
            torch.float32 if bits == 32 else torch.bfloat16, kv_bits=bits)
        jcache = jpaging.init_paged_cache(
            jcfg, 2, 16, PAGE, PPS,
            jnp.float32 if bits == 32 else jnp.bfloat16, kv_bits=bits)
        c = cache["units"]["p0"]
        for name, leaf in jcache["units"]["p0"].items():
            assert tuple(c[name].shape) == leaf.shape, name
            assert str(c[name].dtype).split(".")[-1] == str(leaf.dtype), name
        page_bytes[bits] = paging.cache_page_bytes(cache)
        assert page_bytes[bits] == jpaging.cache_page_bytes(jcache)
    assert page_bytes[32] / page_bytes[8] >= 3.5
    assert page_bytes[32] / page_bytes[4] >= 6.0


def test_paging_updaters_match_jax(smoke):
    """admit / map_pages / release / defrag remap, applied to both
    packages' paged caches after a prefill: equal block tables and kv_pos,
    and pools equal to 1e-5 (their content comes from the models)."""
    jcfg, jp, cfg, p = smoke
    jcache, cache = _paged_pair(jcfg, cfg, 2, 32)
    toks = np.arange(10, dtype=np.int32).reshape(2, 5)
    _, _, jcache = jregistry.apply_model(jp, jcfg,
                                         {"tokens": jnp.asarray(toks)},
                                         caches=jcache)
    registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                         caches=cache)
    steps = [
        lambda j, t: (jpaging.release_slot(j, jnp.int32(1), jnp.asarray(
            paging.build_block_table_row(range(16, 32), PPS))),
            paging.release_slot(t, 1, paging.build_block_table_row(
                range(16, 32), PPS))),
        lambda j, t: (jpaging.map_pages(j, jnp.int32(0),
                                        jnp.asarray([3, 5], jnp.int32),
                                        jnp.asarray([40, 41], jnp.int32)),
                      paging.map_pages(t, 0, [3, 5], [40, 41])),
        lambda j, t: (jpaging.admit_slot(j, jnp.int32(1), jnp.asarray(
            paging.build_block_table_row([50, 2, 60], PPS))),
            paging.admit_slot(t, 1, paging.build_block_table_row(
                [50, 2, 60], PPS))),
    ]
    o2n = np.roll(np.arange(64, dtype=np.int32), 7)
    n2o = np.argsort(o2n).astype(np.int32)
    steps.append(lambda j, t: (
        jpaging.apply_page_remap(j, jnp.asarray(o2n), jnp.asarray(n2o)),
        paging.apply_page_remap(t, o2n, n2o)))
    for step in steps:
        jcache, cache = step(jcache, cache)
        jc, c = jcache["units"]["p0"], cache["units"]["p0"]
        for name in ("block_tables", "kv_pos"):
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]))
        _close(c["k_pages"].numpy(), jc["k_pages"], "k pool")


def test_page_pool_deterministic_and_safe():
    pool = paging.PagePool(8)
    assert pool.alloc(3) == [0, 1, 2]
    assert pool.alloc(2) == [3, 4]
    pool.free([0, 1, 2])
    assert pool.alloc(1) == [0]
    with pytest.raises(paging.PageAllocError):
        pool.alloc(8)
    with pytest.raises(paging.PageAllocError):
        pool.free([3, 3])


def test_page_pool_defrag_matches_jax():
    pools = [paging.PagePool(8), jpaging.PagePool(8)]
    for pool in pools:
        pool.alloc(2)
        b = pool.alloc(2)
        pool.alloc(2)
        pool.free(b)
    maps = [pool.defrag() for pool in pools]
    np.testing.assert_array_equal(maps[0], maps[1])
    assert sorted(maps[0][p] for p in (0, 1, 4, 5)) == [0, 1, 2, 3]
    assert pools[0].in_use == 4 and pools[0].alloc(1) == [4]


# ------------------------------------------------------------ the CLI --
def test_make_prompts_match_jax():
    cfg = base.get_smoke_config("tinyllama-1.1b")
    jcfg = jbase.get_smoke_config("tinyllama-1.1b")
    for prefix in (0, 5):
        got = serve.make_prompts(cfg, [9, 3, 17], 4, prefix_len=prefix)
        want = jserve.make_prompts(jcfg, [9, 3, 17], 4, prefix_len=prefix)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", [["--share-prefix"], ["--preempt"],
                                  ["--preempt-mode", "swap"],
                                  ["--swa-recycle"], ["--trace", "t.json"]])
def test_serve_flags_not_ported_exit_naming_roadmap(argv):
    with pytest.raises(SystemExit, match="ROADMAP"):
        serve.main(["--device", "cpu"] + argv)


@pytest.mark.parametrize("engine", ["paged", "lockstep"])
def test_serve_cli_runs_on_the_cpu(engine):
    out = serve.main(["--device", "cpu", "--engine", engine,
                      "--prompt-lens", "9,17,5", "--decode-tokens", "4",
                      "--kv-bits", "8", "--batch", "2"])
    assert sorted(out["outputs"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in out["outputs"].values())
    if engine == "paged":
        assert out["final_pages_in_use"] == 0
