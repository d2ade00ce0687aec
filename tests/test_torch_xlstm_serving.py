"""The port's xLSTM serving path (recurrent caches, the lockstep engine and
the paged scheduler with per-slot recurrent state) against the JAX
package, on the CPU, at the xlstm smoke config (2 layers: one (mLSTM,
sLSTM) unit, d_model 256, 4 heads, vocab 512) with the JAX parameters
carried across by ``interop``, float32 activations.

Tolerances and their reasons:

* block outputs and caches: 1e-5 of the largest value (the two frameworks
  sum the matrix products and the chunked mLSTM contractions in different
  orders); the port's cached sLSTM forward runs ``ops.slstm_cell`` (its
  plain version here) where the JAX package runs its scan (ROADMAP C);
* logits: 1e-5 of the largest logit;
* greedy tokens: equal.

The paged scheduler zeroes every recurrent leaf of an admitted slot, the
stabilizer ``m`` too, as the JAX package's ``admit_slot`` does, where a
fresh contiguous cache starts ``m`` at -1e30; the port copies that, and
:func:`test_paged_and_lockstep_part_where_the_jax_package_does` pins it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro.serving import paging as jpaging
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import registry, xlstm
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig

LENS, NEWS = (9, 17, 5, 13), (5, 3, 6, 4)
GEOM = dict(max_seqs=3, page_size=4, num_pages=48, pages_per_seq=16,
            prefill_chunk=4, kv_bits=32, cache_dtype="float32")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def smoke():
    """(JAX cfg, JAX params, port cfg, port params), float32 activations."""
    jcfg = jbase.get_smoke_config("xlstm-125m").with_overrides(
        dtype="float32")
    cfg = base.get_smoke_config("xlstm-125m").with_overrides(dtype="float32")
    jp = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, interop.model_params_from_numpy(_flat(jp), cfg,
                                                          "cpu")


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


def _cache_close(cache, jcache, what):
    for name, leaf in jcache.items():
        want = np.asarray(leaf)
        if name == "m":                 # the -1e30 identity, or log-space
            fresh = want <= -1e29
            np.testing.assert_array_equal(cache[name].numpy() <= -1e29,
                                          fresh, err_msg=f"{what} m")
            want = np.where(fresh, 0.0, want)
            got = np.where(fresh, 0.0, cache[name].numpy())
            _close(got, want, f"{what} {name}")
        else:
            _close(cache[name].numpy(), want, f"{what} {name}")


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def _serve(sched, prompts, news):
    rids = [sched.submit(p, m) for p, m in zip(prompts, news)]
    out = sched.run()
    return [out[r].tolist() for r in rids]


# ------------------------------------------------------- cached blocks --
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["whole", "token_by_token", "two_chunks"])
def test_cached_xlstm_block_matches_jax(smoke, kind, mode):
    """mLSTM and sLSTM forwards from a decode cache: a whole sequence at
    once (S > 1: the chunked mLSTM, the port's ``ops.slstm_cell`` route),
    token by token (the S = 1 recurrences), and a 300-token sequence
    (two mLSTM chunks of 256) after a 5-token prefix."""
    jcfg, _, cfg, _ = smoke
    init, apply_ = {"mlstm": (jxlstm.mlstm_init, jxlstm.mlstm_apply),
                    "slstm": (jxlstm.slstm_init, jxlstm.slstm_apply)}[kind]
    jp = init(jax.random.PRNGKey(3), jcfg)
    p = interop.tree_from_numpy(_flat(jp), device="cpu")
    s = 300 if mode == "two_chunks" else 11
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (2, s, cfg.d_model))).astype(np.float32)
    jcache = getattr(jxlstm, f"{kind}_cache")(jcfg, 2)
    cache = getattr(xlstm, f"{kind}_cache")(cfg, 2)
    port_apply = getattr(xlstm, f"{kind}_apply")
    kw = {"use_kernel": True} if kind == "slstm" else {}
    if mode == "whole":
        cuts = [0, s]
    elif mode == "token_by_token":
        cuts = list(range(s + 1))
    else:
        cuts = [0, 5, s]
    for a, b in zip(cuts[:-1], cuts[1:]):
        want, jcache = apply_(jp, jcfg, jnp.asarray(x[:, a:b]), cache=jcache)
        got = port_apply(p, cfg, torch.from_numpy(x[:, a:b]), cache=cache,
                         **kw)
        _close(got.numpy(), want, f"{kind} {mode} out [{a}:{b}]")
        _cache_close(cache, jcache, f"{kind} {mode} [{a}:{b}]")


def test_init_cache_matches_jax(smoke):
    jcfg, _, cfg, _ = smoke
    for jc, c in ((jregistry.init_cache(jcfg, 3, 16),
                   registry.init_cache(cfg, 3, 16)),
                  (jpaging.init_paged_cache(jcfg, 3, 8, 4, 2),
                   paging.init_paged_cache(cfg, 3, 8, 4, 2))):
        want, got = _flat(jc), interop.tree_to_numpy(c)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert paging.cache_page_bytes(c) == 0 == jpaging.cache_page_bytes(
            jc)


def test_decode_step_logits_match_jax(smoke):
    """A 7-token prefill into a contiguous cache, then three decode steps
    (one slot at position -1, which the recurrent blocks ignore)."""
    jcfg, jp, cfg, p = smoke
    toks = np.random.default_rng(1).integers(0, 512, (3, 7)).astype(np.int32)
    jcache = jregistry.init_cache(jcfg, 3, 16)
    cache = registry.init_cache(cfg, 3, 16)
    jl, _, jcache = jregistry.apply_model(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, caches=jcache)
    logits = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                                  caches=cache)
    _close(logits.numpy(), jl, "prefill")
    t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for i in range(3):
        pos = np.full((3, 1), 7 + i, np.int32)
        pos[1] = -1
        jl, jcache = jregistry.decode_step(jp, jcfg, jnp.asarray(t),
                                           jnp.asarray(pos), jcache)
        logits, _ = registry.decode_step(p, cfg, torch.from_numpy(t),
                                         torch.from_numpy(pos), cache)
        _close(logits.numpy(), jl, f"decode {i}")
        t = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for key in ("p0", "p1"):
        _cache_close({k: v[0] for k, v in cache["units"][key].items()},
                     {k: v[0] for k, v in jcache["units"][key].items()},
                     key)


def test_cached_slstm_forward_goes_through_ops(smoke, monkeypatch):
    """The serving prefill sends each sLSTM layer's multi-token forward
    through ``ops.slstm_cell`` once; decode (one token) never does; the
    training forward (no cache) never does."""
    _, _, cfg, p = smoke
    calls = []
    real = ops.slstm_cell
    monkeypatch.setattr(ops, "slstm_cell",
                        lambda *a: calls.append(tuple(a[0].shape))
                        or real(*a))
    cache = registry.init_cache(cfg, 2, 16)
    toks = torch.ones((2, 6), dtype=torch.int32)
    registry.apply_model(p, cfg, {"tokens": toks}, caches=cache)
    assert calls == [(2, 6, 4, 256)]
    registry.decode_step(p, cfg, toks[:, :1], torch.zeros((2, 1),
                                                          dtype=torch.int32),
                         cache)
    registry.apply_model(p, cfg, {"tokens": toks})
    assert len(calls) == 1


# ------------------------------------------------------------- engines --
def test_lockstep_greedy_tokens_match_jax(smoke):
    """One wave of the mixed stream (prompts padded to the longest by
    repeating their last token, as both packages do)."""
    jcfg, jp, cfg, p = smoke
    prompts = _prompts(512, LENS)
    want = jserve.LockstepEngine(jcfg, jp, batch=4).run(prompts, 6)
    got = serve.LockstepEngine(cfg, p, batch=4, device="cpu",
                               cache_dtype=torch.float32).run(prompts, 6)
    for i in range(len(prompts)):
        assert got["outputs"][i].tolist() == want["outputs"][i].tolist(), i


def test_scheduler_greedy_tokens_match_jax_scheduler(smoke, monkeypatch):
    """The mixed stream through both schedulers: 3 slots for 4 requests
    (a slot is re-admitted after its first owner leaves), bulk prefill in
    4-token chunks (the plain B9 at B = 1, S = 4), the rest of each prompt
    and decode at S = 1; 0 pages in use at the end."""
    jcfg, jp, cfg, p = smoke
    prompts = _prompts(512, LENS)
    want = _serve(JScheduler(jcfg, jp, JServeConfig(**GEOM)), prompts, NEWS)
    calls = []
    real = ops.slstm_cell
    monkeypatch.setattr(ops, "slstm_cell",
                        lambda *a: calls.append(tuple(a[0].shape))
                        or real(*a))
    sched = Scheduler(cfg, p, ServeConfig(**GEOM), device="cpu")
    assert _serve(sched, prompts, NEWS) == want
    assert sched.pool.in_use == 0
    assert sched.prefill_chunks == sum((n - 1) // 4 for n in LENS)
    assert calls == [(1, 4, 4, 256)] * sched.prefill_chunks


def test_paged_and_lockstep_part_where_the_jax_package_does(smoke,
                                                            monkeypatch):
    """Four equal-length prompts: the paged scheduler admits each slot
    with ``m`` = 0 and the lockstep engine starts from -1e30, so their
    greedy tokens may part. The port's paged tokens equal the JAX
    package's paged ones, its lockstep tokens the JAX lockstep ones, so
    they part at the same (request, step) pairs; with ``m`` set to -1e30
    at admission the port's paged tokens equal lockstep's."""
    jcfg, jp, cfg, p = smoke
    prompts = jserve.make_prompts(jcfg, [12] * 4, 0)
    geom = dict(GEOM, max_seqs=4, prefill_chunk=16)

    def parts(a, b):
        return [next((k for k, (x, y) in enumerate(zip(u, v)) if x != y),
                     None) for u, v in zip(a, b)]

    jpaged = _serve(JScheduler(jcfg, jp, JServeConfig(**geom)), prompts,
                    [6] * 4)
    jlock = jserve.LockstepEngine(jcfg, jp, batch=4).run(prompts, 6)
    jlock = [jlock["outputs"][i].tolist() for i in range(4)]
    paged = _serve(Scheduler(cfg, p, ServeConfig(**geom), device="cpu"),
                   prompts, [6] * 4)
    lock = serve.LockstepEngine(cfg, p, batch=4, device="cpu",
                                cache_dtype=torch.float32).run(prompts, 6)
    lock = [lock["outputs"][i].tolist() for i in range(4)]
    assert paged == jpaged and lock == jlock
    assert parts(paged, lock) == parts(jpaged, jlock)
    assert sum(k is None for k in parts(paged, lock)) == 3   # 3 of 4 agree

    real = paging.admit_slot

    def admit_fresh_m(cache, slot, row, fresh_row=None):
        real(cache, slot, row, fresh_row)
        for c in cache["units"].values():
            if "m" in c:
                c["m"][:, slot] = -1e30
        return cache

    monkeypatch.setattr(paging, "admit_slot", admit_fresh_m)
    fixed = _serve(Scheduler(cfg, p, ServeConfig(**geom), device="cpu"),
                   prompts, [6] * 4)
    assert fixed == lock


def test_paging_updaters_on_recurrent_state_match_jax(smoke):
    """admit (zeroes the slot's state, m too), release (leaves it),
    slice_slot / merge_slot around a batch-1 prefill chunk: the same
    recurrent leaves as the JAX package's updaters."""
    jcfg, jp, cfg, p = smoke
    jcache = jpaging.init_paged_cache(jcfg, 3, 8, 4, 4)
    cache = paging.init_paged_cache(cfg, 3, 8, 4, 4, torch.float32)
    toks = np.random.default_rng(2).integers(0, 512, (3, 5)).astype(np.int32)
    _, _, jcache = jregistry.apply_model(jp, jcfg,
                                         {"tokens": jnp.asarray(toks)},
                                         caches=jcache)
    registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)},
                         caches=cache)
    row = paging.build_block_table_row([1, 2], 4)
    jcache = jpaging.admit_slot(jcache, jnp.int32(1), jnp.asarray(row))
    paging.admit_slot(cache, 1, row)
    jcache = jpaging.release_slot(jcache, jnp.int32(2), jnp.asarray(
        paging.build_block_table_row([5], 4)))
    paging.release_slot(cache, 2, paging.build_block_table_row([5], 4))
    chunk = toks[1:2, :4]
    jcache = jax.jit(lambda c: jpaging.merge_slot(
        c, jregistry.apply_model(
            jp, jcfg, {"tokens": jnp.asarray(chunk)},
            caches=jpaging.slice_slot(c, jnp.int32(1)))[2], jnp.int32(1)))(
        jcache)
    sliced = paging.slice_slot(cache, 1)
    registry.apply_model(p, cfg, {"tokens": torch.from_numpy(chunk)},
                         caches=sliced)
    paging.merge_slot(cache, sliced, 1)
    for key in ("p0", "p1"):
        got = {k: v[0] for k, v in cache["units"][key].items()}
        want = {k: v[0] for k, v in jcache["units"][key].items()}
        _cache_close(got, want, key)
    assert not (cache["units"]["p1"]["m"][0, 1] <= -1e29).any()


@pytest.mark.parametrize("engine", ["paged", "lockstep"])
def test_serve_cli_serves_the_smoke_xlstm(engine):
    argv = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
            "--prompt-lens", "9,17,5,13", "--decode-tokens", "8",
            "--engine", engine]
    out = serve.main(argv)
    assert sorted(out["outputs"]) == [0, 1, 2, 3]
    assert all(len(o) == 8 for o in out["outputs"].values())
    if engine == "paged":
        assert out["final_pages_in_use"] == 0 and out["prefill_chunks"] > 0


def test_serve_cli_xlstm_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "xlstm-125m", "--smoke", "--decode-tokens",
                    "1"])
