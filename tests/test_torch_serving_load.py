"""Production-load serving (prefix sharing, watermark admission, recompute
and swap preemption, ``AsyncServer``) and the metrics module, the port
against the JAX package, on the CPU, at the tinyllama smoke config with
the JAX parameters carried across by ``interop``.

Tolerances and their reasons:

* host structures (``PagePool``, ``PrefixIndex``, ``obs.metrics``): equal,
  value for value and byte for byte; they are the same numpy/Python
  algorithm.
* ``fork_pages`` and the swap payload: bit for bit (copies).
* scheduler streams against the JAX scheduler: greedy tokens and every
  counter equal, with float32 activations and pools (bf16 rounds at other
  places in XLA and PyTorch, ROADMAP C); the JAX side decodes through its
  one-shot kernel (``REPRO_PAGED_ATTN_KERNEL=1``), the port's route.
* the port against itself (temperature sampling, xLSTM swap, AsyncServer):
  equal token for token; the same host decisions run the same device
  programs.
"""
import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import registry as jregistry
from repro.obs import metrics as jmetrics
from repro.serving import paging as jpaging
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.obs import metrics
from repro_torch.serving import paging
from repro_torch.serving.scheduler import AsyncServer, Scheduler, ServeConfig
from test_torch_cuda import ALIAS_POOLS, aliased_inputs

PAGE, PPS = 4, 16                       # page_size, pages_per_seq
COUNTERS = ("shared_page_hits", "cow_forks", "preemptions",
            "forced_preemptions", "pages_alloc_events", "peak_pages_in_use")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and under the
    suite's parallel workers an 8-thread pool per op oversubscribes the
    CPU (a 7x slowdown measured with 5 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def smoke():
    """(JAX cfg, JAX params, port cfg, port params), tinyllama smoke with
    float32 activations."""
    jcfg = jbase.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    cfg = base.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, interop.model_params_from_numpy(_flat(jp), cfg,
                                                          "cpu")


@pytest.fixture(scope="module")
def xlstm():
    cfg = base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, interop.model_params_from_numpy(_flat(jp), cfg, "cpu")


@pytest.fixture(autouse=True)
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


def _port(cfg, params, **kw):
    return Scheduler(cfg, params, _serve_cfg(ServeConfig, **kw),
                     device="cpu")


def _stream(sched, prompts, news, priorities=None):
    rids = [sched.submit(p, m, priority=0 if priorities is None
                         else priorities[i])
            for i, (p, m) in enumerate(zip(prompts, news))]
    out = sched.run()
    assert sched.pool.in_use == 0
    if sched.index is not None:
        assert len(sched.index) == 0          # the index drains with the pool
    return [out[r].tolist() for r in rids]


def _both(smoke, prompts, news, priorities=None, **kw):
    """The same stream through the JAX scheduler and the port's: tokens
    and counters of each."""
    jcfg, jp, cfg, p = smoke
    js = JScheduler(jcfg, jp, _serve_cfg(JServeConfig, **kw))
    ps = _port(cfg, p, **kw)
    return [(_stream(s, prompts, news, priorities),
             {c: getattr(s, c) for c in COUNTERS}) for s in (js, ps)]


def _shared_prefix_stream(vocab, n=5, prefix_tokens=8, seed=11):
    """The JAX package's: n prompts opening with the same full-page
    prefix, staggered suffix and decode lengths so early requests are
    still live (donors) when the later ones are admitted."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, prefix_tokens).astype(np.int32)
    prompts, news = [], []
    for i in range(n):
        suffix = rng.randint(0, vocab, 1 + 2 * i).astype(np.int32)
        prompts.append(np.concatenate([prefix, suffix]))
        news.append(9 - i if i % 2 == 0 else 3 + i)
    return prompts, news


# ------------------------------------------------------ metrics copy --
def test_metrics_match_the_jax_module():
    """The same observations into both modules: percentiles, bounded
    windows, bucket counts, snapshots and deltas equal."""
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.01, 300)
    regs = [metrics.Registry(), jmetrics.Registry()]
    hists, dicts = [], []
    for mod, reg in zip((metrics, jmetrics), regs):
        h = reg.histogram("lat", window=64)
        c = reg.counter("req", labels=("kind",), max_series=2)
        g = reg.gauge("free")
        d = mod.BoundedDict(5)
        for i, v in enumerate(samples):
            h.observe(v)
            c.inc(kind=f"k{i % 3}")
            g.set(i)
            d[i] = v
        hists.append(h)
        dicts.append(d)
    assert len(hists[0]) == len(hists[1]) == 64
    for p in (50, 90, 99):
        assert hists[0].percentile(p) == hists[1].percentile(p)
    assert list(hists[0]) == list(hists[1]) == list(samples[-64:])
    assert list(dicts[0].items()) == list(dicts[1].items())
    assert len(dicts[0]) == 5 and 294 not in dicts[0] and 299 in dicts[0]
    snaps = [r.snapshot() for r in regs]
    assert snaps[0] == snaps[1]
    assert regs[0].delta(snaps[0]) == regs[1].delta(snaps[1])
    assert metrics.Histogram("e").percentile(50) != \
        metrics.Histogram("e").percentile(50)            # NaN when empty
    with pytest.raises(TypeError):
        regs[0].gauge("lat")


def test_scheduler_latency_windows_are_bounded(smoke):
    """The scheduler keeps its latency samples in the JAX package's
    bounded windows (4,096 ticks, 8,192 gaps, 4,096 requests)."""
    _, _, cfg, p = smoke
    sched = _port(cfg, p)
    assert sched.decode_step_s._window.maxlen == 4096
    assert sched.prefill_chunk_s._window.maxlen == 4096
    assert sched.itl_s._window.maxlen == 8192
    assert sched.ttft_s.maxsize == sched.ttft_queue_s.maxsize == 4096
    rids = [sched.submit(q, m) for q, m in
            zip(_prompts(512, (9, 5, 17)), (4, 3, 2))]
    sched.run()
    assert len(sched.decode_step_s) == sched.decode_steps >= 3
    assert len(sched.prefill_chunk_s) == sched.prefill_chunks
    assert len(sched.itl_s) == (4 - 1) + (3 - 1) + (2 - 1)
    assert set(sched.ttft_s) == set(rids)


# ------------------------------------------------------ page pool --
def _pool_ops(seed, n_ops=120):
    rng = np.random.RandomState(seed)
    return (int(rng.randint(1, 12)),
            [(int(rng.randint(4)), int(rng.randint(1 << 16)))
             for _ in range(n_ops)])


@pytest.mark.parametrize("seed", range(5))
def test_page_pool_refcount_walk_matches_jax(seed):
    """The JAX package's seeded pool walk (alloc, retain, free, defrag)
    on both pools: equal ids, recycled lists, refcounts, ref_stats and
    defrag maps at every step, and both drain to empty."""
    num_pages, ops = _pool_ops(seed)
    pools = [paging.PagePool(num_pages), jpaging.PagePool(num_pages)]
    for op, arg in ops:
        live = sorted(p for p in range(num_pages) if pools[1].refcount(p))
        outs = []
        for pool in pools:
            if op == 0:
                n = 1 + arg % 3
                outs.append(pool.alloc(n) if pool.can_alloc(n) else None)
            elif op == 1 and live:
                pool.retain([live[arg % len(live)]])
            elif op == 2 and live:
                outs.append(pool.free([live[arg % len(live)]]))
            elif op == 3:
                outs.append(pool.defrag().tolist())
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]
        assert pools[0].ref_stats() == pools[1].ref_stats()
        assert (pools[0].in_use, pools[0].free_count) == \
            (pools[1].in_use, pools[1].free_count)
        assert [pools[0].refcount(p) for p in range(num_pages)] == \
            [pools[1].refcount(p) for p in range(num_pages)]
    for p in range(num_pages):
        for _ in range(pools[0].refcount(p)):
            assert pools[0].free([p]) == pools[1].free([p])
    assert pools[0].in_use == 0 and pools[0].free_count == num_pages
    with pytest.raises(paging.PageAllocError):
        pools[0].free([num_pages - 1])
    with pytest.raises(paging.PageAllocError):
        pools[0].retain([0])


# ---------------------------------------------------- prefix index --
@pytest.mark.parametrize("seed", range(3))
def test_prefix_index_walk_matches_jax(seed):
    """Register / drop / defrag-remap walks on both indexes: equal
    lookups (the lowest live page) and sizes at every step."""
    rng = np.random.RandomState(seed)
    idx = [paging.PrefixIndex(PAGE), jpaging.PrefixIndex(PAGE)]
    hashes = [bytes([h]) * 32 for h in range(4)]
    for _ in range(80):
        op, arg = int(rng.randint(3)), int(rng.randint(1 << 16))
        for ix in idx:
            if op == 0:
                ix.register(hashes[arg % 4], arg % 32)
            elif op == 1:
                ix.drop_page(arg % 32)
            else:
                ix.remap(np.random.RandomState(arg % 97).permutation(32))
        assert [idx[0].lookup(h) for h in hashes] == \
            [idx[1].lookup(h) for h in hashes]
        assert len(idx[0]) == len(idx[1])


def test_prefix_index_hash_bytes_match_jax():
    rng = np.random.RandomState(4)
    toks = rng.randint(0, 32000, 3 * PAGE + 2).astype(np.int32)
    assert paging.PrefixIndex.ROOT == jpaging.PrefixIndex.ROOT
    got = paging.PrefixIndex(PAGE).hash_chain(toks)
    assert len(got) == 3
    assert got == jpaging.PrefixIndex(PAGE).hash_chain(toks)
    assert paging.PrefixIndex.chain(got[0], toks[:PAGE]) == \
        jpaging.PrefixIndex.chain(got[0], toks[:PAGE])
    window = np.arange(PAGE, dtype=np.int32)
    twice = paging.PrefixIndex(PAGE).hash_chain(np.tile(window, 2))
    assert twice[0] != twice[1]              # the chain is depth-sensitive


# -------------------------------------------------------- CoW fork --
def _random_pool(cache, rng, stacked):
    """Fill a block cache's pool leaves with seeded values (codes and
    ranges for code pools) in both packages' layouts."""
    out = {}
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        if name in cache:
            shape = tuple(cache[name].shape)
            out[name] = (rng.randint(1, 200, shape).astype(np.uint8)
                         if cache[name].dtype in (torch.uint8,)
                         else rng.standard_normal(shape).astype(np.float32))
    kv = np.full(tuple(cache["kv_pos"].shape), -1, np.int32)
    kv[..., 1, :] = np.arange(PAGE)
    out["kv_pos"] = kv
    return out


@pytest.mark.parametrize("kv_bits", [32, 8, 4])
def test_fork_pages_matches_jax_bit_for_bit(smoke, kv_bits):
    """A fork of page 1 into page 3 for slot 0, on the stacked caches of
    both packages: every pool leaf of the copy equals the donor's (and
    JAX's copy), kv_pos masked at the write point, only slot 0's row
    rebound."""
    jcfg, _, cfg, _ = smoke
    jcache = jpaging.init_paged_cache(jcfg, 2, 6, PAGE, 2, jnp.float32,
                                      kv_bits=kv_bits)
    cache = paging.init_paged_cache(cfg, 2, 6, PAGE, 2, torch.float32,
                                    kv_bits=kv_bits)
    rng = np.random.RandomState(kv_bits)
    vals = _random_pool(cache["units"]["p0"], rng, True)
    row = np.array([1, 2], np.int32)
    for name, v in vals.items():
        cache["units"]["p0"][name].copy_(torch.from_numpy(v))
    jc = dict(jcache["units"]["p0"])
    for name, v in vals.items():
        jc[name] = jnp.asarray(v)
    jcache = {"units": {"p0": jc}, "rem": {}}
    for slot in (0, 1):
        jcache = jpaging.admit_slot(jcache, jnp.int32(slot), jnp.asarray(row),
                                    jnp.asarray(np.full(2, -1, np.int32)))
        paging.admit_slot(cache, slot, row, np.full(2, -1, np.int32))
    write_pos = PAGE // 2
    jcache = jpaging.fork_pages(jcache, jnp.int32(0),
                                jnp.asarray([0], jnp.int32),
                                jnp.asarray([1], jnp.int32),
                                jnp.asarray([3], jnp.int32),
                                jnp.int32(write_pos))
    paging.fork_pages(cache, 0, [0], [1], [3], write_pos)
    c, jc = cache["units"]["p0"], jcache["units"]["p0"]
    for name in c:
        np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        if name in c:
            assert torch.equal(c[name][:, 3], c[name][:, 1]), name
    np.testing.assert_array_equal(
        c["kv_pos"][:, 3].numpy(),
        np.broadcast_to(np.where(np.arange(PAGE) < write_pos,
                                 np.arange(PAGE), -1), (2, PAGE)))
    assert c["block_tables"][:, 0].tolist() == [[3, 2]] * 2
    assert c["block_tables"][:, 1].tolist() == [[1, 2]] * 2


# ------------------------------------------------------ swap payload --
@pytest.mark.parametrize("kv_bits", [32, 8])
def test_swap_payload_round_trips_bf16_pools(smoke, kv_bits):
    """Extract three pages of a bf16 pool (or codes and ranges) to host
    numpy, insert them into three other pages: bit for bit, bf16 stored
    as its raw uint16 bits under the JAX package's leaf paths."""
    jcfg, _, cfg, _ = smoke
    cache = paging.init_paged_cache(cfg, 2, 10, PAGE, 4, torch.bfloat16,
                                    kv_bits=kv_bits)
    c = cache["units"]["p0"]
    gen = torch.Generator().manual_seed(0)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        if name in c:
            x = c[name]
            x.copy_(torch.randint(0, 250, x.shape, generator=gen).to(x.dtype)
                    if x.dtype == torch.uint8 else
                    torch.randn(x.shape, generator=gen).to(x.dtype))
    c["kv_pos"].copy_(torch.arange(c["kv_pos"].numel(), dtype=torch.int32
                                   ).reshape(c["kv_pos"].shape))
    slabs = paging.extract_pages(cache, [2, 5, 7])
    jkeys = set(jpaging.extract_pages(jpaging.init_paged_cache(
        jcfg, 2, 10, PAGE, 4, jnp.bfloat16, kv_bits=kv_bits), [0]))
    assert set(slabs) == jkeys
    if kv_bits == 32:
        assert slabs["['units']['p0']['k_pages']"].dtype == np.uint16
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"swap-test-{os.getpid()}-{kv_bits}.npz")
    np.savez(path, **slabs)
    with np.load(path) as data:
        back = {k: data[k] for k in data.files}
    os.remove(path)
    before = {k: v.clone() for k, v in c.items()}
    paging.insert_pages(cache, back, [0, 1, 9])
    for name, x in c.items():
        if name == "block_tables":
            continue
        for src, dst in ((2, 0), (5, 1), (7, 9)):
            assert torch.equal(x[:, dst], before[name][:, src]), name
        assert torch.equal(x[:, 3], before[name][:, 3]), name


def test_swap_payload_carries_xlstm_slot_state(xlstm):
    """The per-sequence leaves of an xLSTM slot, extracted from slot 1
    and inserted into slot 0, bit for bit (bf16 leaves included)."""
    cfg, _ = xlstm
    cache = paging.init_paged_cache(cfg, 3, 4, PAGE, 2, torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    for part in cache.values():
        for c in part.values():
            for name, x in c.items():
                if x.is_floating_point():
                    x.copy_(torch.randn(x.shape, generator=gen).to(x.dtype))
    state = paging.extract_seq_state(cache, 1)
    assert state and all(v.shape[1 if "['units']" in k else 0] == 1
                         for k, v in state.items())
    assert any(v.dtype == np.uint16 for v in state.values()) or all(
        x.dtype != torch.bfloat16 for part in cache.values()
        for c in part.values() for x in c.values())
    paging.insert_seq_state(cache, state, 0)
    for part, stacked in (("units", True), ("rem", False)):
        for c in cache[part].values():
            for name, x in c.items():
                ax = 1 if stacked else 0
                assert torch.equal(x.select(ax, 0), x.select(ax, 1)), name


# ----------------------------------------- scheduler against JAX --
@pytest.mark.parametrize("kv_bits", [32, 8])
def test_shared_prefix_matches_jax_and_saves_pages(smoke, kv_bits):
    """Copy-on-write sharing: the port's tokens and counters equal the
    JAX scheduler's, equal the unshared run's tokens, and allocate fewer
    pages."""
    prompts, news = _shared_prefix_stream(512)
    (jt, jc), (pt, pc) = _both(smoke, prompts, news, kv_bits=kv_bits,
                               share_prefix=True)
    assert pt == jt and pc == jc
    _, _, cfg, p = smoke
    plain = _port(cfg, p, kv_bits=kv_bits)
    assert _stream(plain, prompts, news) == pt
    assert pc["shared_page_hits"] > 0
    assert pc["pages_alloc_events"] < plain.pages_alloc_events


def test_page_aligned_prompt_forks_at_admission_as_jax(smoke):
    """A prompt that is an exact full-page prefix of a live sequence
    forks its last shared page at admission; the port's tokens and
    counters equal JAX's and the unshared run's."""
    jcfg, jp, cfg, p = smoke
    rng = np.random.RandomState(5)
    donor = rng.randint(0, 512, 3 * PAGE).astype(np.int32)
    extended = np.concatenate([donor,
                               rng.randint(0, 512, 3).astype(np.int32)])

    def run(sched):
        r0 = sched.submit(donor, 12)
        for _ in range(4):
            sched.step()                    # the donor live and indexed
        r1 = sched.submit(np.copy(donor), 4)
        r2 = sched.submit(extended, 5)
        out = sched.run()
        assert sched.pool.in_use == 0
        return ([out[r].tolist() for r in (r0, r1, r2)],
                {c: getattr(sched, c) for c in COUNTERS})

    jt, jc = run(JScheduler(jcfg, jp, _serve_cfg(JServeConfig,
                                                 share_prefix=True)))
    pt, pc = run(_port(cfg, p, share_prefix=True))
    assert (pt, pc) == (jt, jc)
    assert run(_port(cfg, p))[0] == pt
    assert pc["cow_forks"] >= 1 and pc["shared_page_hits"] >= 5


def test_watermark_admission_overcommits_as_jax(smoke):
    """A pool too small for two full reservations but big enough for two
    near-term footprints: reservation serializes, watermark runs both;
    tokens and counters as JAX's."""
    jcfg, jp, cfg, p = smoke
    prompts, news = _prompts(512, (9, 9)), (4, 4)

    def peak(sched):
        rids = [sched.submit(q, m) for q, m in zip(prompts, news)]
        most = 0
        while sched.busy:
            sched.step()
            most = max(most, sum(s is not None for s in sched.slots))
        assert sched.pool.in_use == 0
        return most, [sched.finished[r].tolist() for r in rids], \
            {c: getattr(sched, c) for c in COUNTERS}

    kw = dict(num_pages=7, max_seqs=2)
    reserve = peak(_port(cfg, p, **kw))
    wm = peak(_port(cfg, p, preempt=True, decode_watermark=1, **kw))
    jwm = peak(JScheduler(jcfg, jp, _serve_cfg(
        JServeConfig, preempt=True, decode_watermark=1, **kw)))
    assert reserve[0] == 1 and wm[0] == 2
    assert wm == jwm
    assert wm[1] == reserve[1]


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preempt_readmit_matches_jax_and_the_uninterrupted_run(smoke, mode):
    """Evict -> requeue -> readmit under pool pressure: tokens and
    counters equal JAX's, tokens equal the uninterrupted run's."""
    _, _, cfg, p = smoke
    prompts, news = _prompts(512, (9, 13), seed=2), (14, 10)
    (jt, jc), (pt, pc) = _both(smoke, prompts, news, max_seqs=2,
                               num_pages=8, preempt=True, preempt_mode=mode,
                               decode_watermark=1)
    assert pt == jt and pc == jc
    assert pc["preemptions"] + pc["forced_preemptions"] >= 1
    assert _stream(_port(cfg, p, max_seqs=2), prompts, news) == pt


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preempted_priority_stream_matches_jax(smoke, mode):
    """The JAX package's seeded preemption workload (three requests,
    priorities alternating 0/1, 8 pages): tokens and counters as JAX's,
    tokens as the uninterrupted run's, twice (replay); the swap directory
    is empty after."""
    _, _, cfg, p = smoke
    rng = np.random.RandomState(1234)
    lens = [int(rng.randint(5, 14)) for _ in range(3)]
    news = [int(rng.randint(3, 12)) for _ in range(3)]
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in lens]
    prios = [i % 2 for i in range(3)]
    kw = dict(max_seqs=2, num_pages=8, preempt=True, preempt_mode=mode,
              decode_watermark=1, prefill_chunk=8)
    (jt, jc), (pt, pc) = _both(smoke, prompts, news, prios, **kw)
    assert pt == jt and pc == jc
    plain = _stream(_port(cfg, p, max_seqs=2), prompts, news, prios)
    assert pt == plain
    again = _port(cfg, p, **kw)
    assert _stream(again, prompts, news, prios) == pt
    if mode == "swap" and again.swap_dir is not None:
        assert os.listdir(again.swap_dir) == []


def test_priority_preemption_evicts_lowest_priority(smoke):
    """A high-priority arrival with the one slot held by lower priority:
    the low one is evicted and re-queued; both complete with the tokens
    of the uninterrupted run, as in JAX."""
    jcfg, jp, cfg, p = smoke
    prompts = _prompts(512, (9, 9), seed=3)
    plain = _stream(_port(cfg, p, max_seqs=2), prompts, (12, 6))

    def run(sched):
        lo = sched.submit(prompts[0], 12, priority=0)
        for _ in range(3):
            sched.step()
        hi = sched.submit(prompts[1], 6, priority=5)
        first = None
        while sched.busy:
            done = sched.step()
            first = first if first is not None or not done else done[0]
        assert sched.pool.in_use == 0
        return ([sched.finished[lo].tolist(), sched.finished[hi].tolist()],
                first == hi, {c: getattr(sched, c) for c in COUNTERS})

    kw = dict(num_pages=8, max_seqs=1, preempt=True, decode_watermark=1)
    got = run(_port(cfg, p, **kw))
    assert got == run(JScheduler(jcfg, jp, _serve_cfg(JServeConfig, **kw)))
    assert got[0] == plain and got[1]
    assert got[2]["preemptions"] + got[2]["forced_preemptions"] >= 1


def test_aging_prevents_starvation(smoke):
    """A priority-0 request against a continuous priority-3 stream on a
    one-request pool: aging pushes it through, at the tick JAX does."""
    jcfg, jp, cfg, p = smoke
    prompt = _prompts(512, (5,))[0]

    def run(sched):
        lo = sched.submit(prompt, 3, priority=0)
        served_before, ticks = 0, 0
        for ticks in range(40):
            if lo in sched.finished:
                break
            if not any(e.req.priority == 3 for e in sched.waiting):
                sched.submit(prompt, 3, priority=3)
            served_before += sum(1 for r in sched.step() if r != lo)
        return lo in sched.finished, served_before, ticks

    kw = dict(num_pages=4, max_seqs=1, preempt=True, decode_watermark=1,
              aging_ticks=2)
    got = run(_port(cfg, p, **kw))
    assert got == run(JScheduler(jcfg, jp, _serve_cfg(JServeConfig, **kw)))
    assert got[0] and got[1] >= 1


def test_deadline_escalation(smoke):
    """A missed deadline raises a waiter's preemption priority by 1 +
    (ticks past it) // aging_ticks, as JAX's; aging alone does not."""
    _, _, cfg, p = smoke
    sched = _port(cfg, p, preempt=True, aging_ticks=4)
    jsched = JScheduler(smoke[0], smoke[1], _serve_cfg(
        JServeConfig, preempt=True, aging_ticks=4))
    for s in (sched, jsched):
        s.submit(_prompts(512, (5,))[0], 2, priority=1, deadline=3)
        s.submit(_prompts(512, (5,))[0], 2, priority=1)
    for steps in (0, 3, 4, 9, 20):
        for s in (sched, jsched):
            s.steps = steps
        got = [(sched._preempt_priority(e), sched._eff_priority(e))
               for e in sched.waiting]
        want = [(jsched._preempt_priority(e), jsched._eff_priority(e))
                for e in jsched.waiting]
        assert got == want
    assert got[0][0] == 1 + 1 + (20 - 3) // 4 and got[1][0] == 1


def test_replay_deterministic_with_sharing_preemption_defrag(smoke):
    """Temperature sampling, prefix sharing, watermark preemption and a
    defrag every 3 ticks: two runs give the same tokens; greedy, the same
    stream equals the JAX scheduler's, counters included."""
    _, _, cfg, p = smoke
    prompts, news = _shared_prefix_stream(512)
    kw = dict(share_prefix=True, preempt=True, num_pages=24,
              decode_watermark=1, defrag_every=3)
    runs = [_stream(_port(cfg, p, sample="temp", temperature=0.8, seed=7,
                          **kw), prompts, news) for _ in range(2)]
    assert runs[0] == runs[1]
    (jt, jc), (pt, pc) = _both(smoke, prompts, news, **kw)
    assert pt == jt and pc == jc


def test_defrag_preserves_sharing(smoke):
    _, _, cfg, p = smoke
    prompts, news = _shared_prefix_stream(512)
    plain = _stream(_port(cfg, p), prompts, news)
    sched = _port(cfg, p, share_prefix=True, defrag_every=4)
    assert _stream(sched, prompts, news) == plain
    assert sched.shared_page_hits > 0


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_temperature_sampling_survives_preemption(smoke, mode):
    """Draws are seeded by (seed, request, position): a preempted and
    readmitted request draws the tokens of the uninterrupted run."""
    _, _, cfg, p = smoke
    prompts, news = _prompts(512, (9, 13), seed=2), (14, 10)
    kw = dict(sample="temp", temperature=0.9, seed=3)
    plain = _stream(_port(cfg, p, max_seqs=2, **kw), prompts, news)
    sched = _port(cfg, p, max_seqs=2, num_pages=8, preempt=True,
                  preempt_mode=mode, decode_watermark=1, **kw)
    assert _stream(sched, prompts, news) == plain
    assert sched.preemptions >= 1


def test_ttft_clocks_from_submit_with_queue_component(smoke):
    _, _, cfg, p = smoke
    sched = _port(cfg, p, max_seqs=1)
    rids = [sched.submit(q, 3) for q in _prompts(512, (9, 9, 9))]
    sched.run()
    assert set(sched.ttft_s) == set(sched.ttft_queue_s) == set(rids)
    for r in rids:
        assert 0.0 < sched.ttft_queue_s[r] <= sched.ttft_s[r]
    assert sched.ttft_queue_s[rids[2]] > sched.ttft_queue_s[rids[0]]


def test_submit_keeps_watermark_headroom(smoke):
    """Under preemption a request must leave 1 + decode_watermark pages
    of headroom, as in JAX."""
    _, _, cfg, p = smoke
    need = paging.pages_needed(9 + 3, PAGE)
    with pytest.raises(ValueError, match="exceeds the serve capacity"):
        _port(cfg, p, num_pages=need + 2, preempt=True).submit(
            np.zeros(9, np.int32), 3)
    _port(cfg, p, num_pages=need + 3, preempt=True).submit(
        np.zeros(9, np.int32), 3)
    _port(cfg, p, num_pages=need).submit(np.zeros(9, np.int32), 3)


def test_serve_config_validation_matches_jax():
    for kw in (dict(wm_low=0.5, wm_high=0.2), dict(wm_high=1.0),
               dict(decode_watermark=0), dict(aging_ticks=0),
               dict(preempt_mode="both")):
        with pytest.raises(ValueError):
            JServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    ServeConfig(preempt=True, wm_low=0.1, wm_high=0.3, share_prefix=True,
                preempt_mode="swap")


# -------------------------------------- decode on aliased tables --
@pytest.mark.parametrize("kv_bits,pool_dtype", ALIAS_POOLS)
@pytest.mark.parametrize("online", [False, True])
def test_plain_decode_on_aliased_and_forked_tables(online, kv_bits,
                                                   pool_dtype):
    """The card case's inputs (test_torch_cuda.py) through the plain
    versions: a table whose rows share pages decodes as the same table
    over private copies of them, and the forked page's stale slots past
    the write point do not count."""
    kw, _ = aliased_inputs(kv_bits, pool_dtype or torch.float32)
    bad, _ = aliased_inputs(kv_bits, pool_dtype or torch.float32,
                            poison=True)
    plain = (ref.paged_attention_online_ref if online
             else ref.paged_attention_ref)

    def call(k):
        k = dict(k)
        return plain(k.pop("q"), k.pop("k_pages"), k.pop("v_pages"),
                     torch.clamp(k.pop("block_tables"), 0), k.pop("ctx_lens"),
                     **k)

    got = call(kw)
    assert torch.equal(got, call(bad))
    bt = kw["block_tables"]
    rows, pages = torch.nonzero(bt >= 0, as_tuple=True)
    assert len(torch.unique(bt[rows, pages])) < len(rows)     # aliased
    # private copies: every (row, logical page) gets a page of its own
    private = dict(kw)
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        if name in kw:
            private[name] = kw[name][bt[rows, pages].long()]
    table = torch.full_like(bt, -1)
    table[rows, pages] = torch.arange(len(rows), dtype=torch.int32)
    private["block_tables"] = table
    assert torch.equal(call(private), got)


# ------------------------------------------------------------ xLSTM --
def test_xlstm_swap_preemption_equals_the_uninterrupted_stream(xlstm):
    """Swap carries an xLSTM slot's recurrent state byte for byte: the
    preempted stream equals the uninterrupted one; recompute too."""
    cfg, p = xlstm
    prompts, news = _prompts(512, (9, 13), seed=2), (14, 10)
    plain = _stream(_port(cfg, p, max_seqs=2), prompts, news)
    for mode in ("swap", "recompute"):
        sched = _port(cfg, p, max_seqs=2, num_pages=8, preempt=True,
                      preempt_mode=mode, decode_watermark=1)
        assert _stream(sched, prompts, news) == plain, mode
        assert sched.preemptions + sched.forced_preemptions >= 1


def test_share_prefix_refused_on_xlstm(xlstm):
    cfg, p = xlstm
    with pytest.raises(ValueError, match="share_prefix"):
        _port(cfg, p, share_prefix=True)


# ------------------------------------------------------ AsyncServer --
def test_async_server_matches_sync(smoke):
    _, _, cfg, p = smoke
    prompts, news = _prompts(512, (9, 17, 5)), (4, 3, 5)
    sync = _stream(_port(cfg, p), prompts, news)

    async def serve_all():
        server = AsyncServer(_port(cfg, p))
        return await asyncio.gather(*[server.generate(q, m)
                                      for q, m in zip(prompts, news)])

    assert [a.tolist() for a in asyncio.run(serve_all())] == sync


def test_async_server_survives_cancellation(smoke):
    _, _, cfg, p = smoke
    prompts = _prompts(512, (9, 9))

    async def scenario():
        server = AsyncServer(_port(cfg, p))
        doomed = asyncio.ensure_future(server.generate(prompts[0], 30))
        await asyncio.sleep(0)
        doomed.cancel()
        try:
            await doomed
        except asyncio.CancelledError:
            pass
        out = await server.generate(prompts[1], 3)
        if server._pump_task is not None:
            await server._pump_task
        return out, server

    out, server = asyncio.run(scenario())
    assert out.shape == (3,)
    assert server.scheduler.finished == {}
    assert server._abandoned == set()
    assert server.scheduler.pool.in_use == 0


# ------------------------------------------------------------- CLI --
def test_serve_cli_production_flags_match_jax_counters(smoke, capsys):
    """``--share-prefix --preempt --preempt-mode swap --repeat 2`` with a
    shared system prompt on the CPU: the JAX package's fields, 0 pages in
    use, the duplicates hitting the index."""
    argv = ["--prompt-lens", "9,17,5", "--prefix-len", "8", "--repeat", "2",
            "--decode-tokens", "6", "--batch", "3", "--share-prefix",
            "--preempt", "--preempt-mode", "swap", "--num-pages", "24",
            "--kv-bits", "32"]
    out = serve.main(["--device", "cpu"] + argv)
    for key in ("pages_alloc_events", "shared_page_hits", "cow_forks",
                "preemptions", "peak_pages_in_use", "final_pages_in_use",
                "ttft_p50_s", "ttft_queue_p50_s"):
        assert key in out, key
    assert sorted(out["outputs"]) == list(range(6))
    assert out["final_pages_in_use"] == 0 and out["shared_page_hits"] > 0
    assert out["outputs"][3].tolist() == out["outputs"][0].tolist()
    assert "shared_hits=" in capsys.readouterr().out
