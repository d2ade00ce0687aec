"""The Mamba2 hybrid through the port: ``models/ssm.py``, the "mamba2" and
"shared_attn" block kinds, zamba2-7b's config, its weight-shared block,
Mamba2 decode state in the paged cache (admission, swap preemption), and
consensus training, against the JAX package on numpy-seeded inputs (the JAX
init carried across with ``interop``).

Tolerances and their reasons:

* ``_causal_conv``, ``_ssd_chunked``, ``mamba2_apply`` and logits, float32:
  1e-5 of max|out|, the final state 1e-5 of max|state| (float32 products
  added in different orders);
* the chunked scan against the recurrent step: 2e-3, the JAX package's own
  test (``tests/test_recurrent_parity.py``) at its tolerance; against a
  float64 recurrence where the JAX package's exp overflows (ROADMAP C19):
  1e-5 of max|y|;
* paging updaters, the swap payload: bit for bit (copies and zeros);
* greedy token streams: equal; consensus training: C5's tolerances (see
  ``test_torch_moe.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.serving import paging as jpaging
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import ServeConfig as JServeConfig
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import tree as T
from repro_torch.launch import serve, train
from repro_torch.models import registry, ssm
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig
from test_torch_moe import (close, flat, pair, prompts, run_admm_pair,
                            run_stream, serve_cfg)

ARCH = "zamba2-7b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """(cfg, JAX mamba2 params, port mamba2 params), zamba2-smoke."""
    cfg = base.get_smoke_config(ARCH)
    jp = jssm.mamba2_init(jax.random.PRNGKey(0),
                          jbase.get_smoke_config(ARCH))
    # non-trivial a_log, d_skip, dt_bias (the init's are constants)
    rng = np.random.default_rng(11)
    h = jp["a_log"].shape[0]
    jp = dict(jp, a_log=jnp.asarray(rng.normal(0, 0.3, h), jnp.float32),
              d_skip=jnp.asarray(rng.normal(1, 0.2, h), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(-2, 0.5, h), jnp.float32))
    return cfg, jp, interop.tree_from_numpy(flat(jp), "cpu")


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------- components --
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(with_tail):
    x, w = randn((2, 13, 40), 1), randn((4, 40), 2)
    tail = randn((2, 3, 40), 3) if with_tail else None
    jy, jt = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if tail is None else jnp.asarray(tail))
    y, t = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if tail is None else torch.from_numpy(tail))
    close(y.numpy(), jy, "conv")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_causal_conv_rounds_every_tap_in_bf16():
    """bf16 x: each tap's product and partial sum round to bf16, as the
    JAX loop does; ``F.conv1d``'s float32 sum rounded once gives other
    bits."""
    x = torch.from_numpy(randn((2, 33, 64), 4)).to(torch.bfloat16)
    w = torch.from_numpy(randn((4, 64), 5)).to(torch.bfloat16)
    y, _ = ssm._causal_conv(x, w, None)
    full = torch.cat([torch.zeros(2, 3, 64, dtype=torch.bfloat16), x], 1)
    want = torch.zeros_like(x)
    for j in range(4):
        want = want + full[:, j:j + 33] * w[j]
    assert torch.equal(y, want)
    once = torch.nn.functional.conv1d(
        full.float().transpose(1, 2), w.float().t().flip(1)[:, None, :],
        groups=64).transpose(1, 2).to(torch.bfloat16)
    assert not torch.equal(y, once)


@pytest.mark.parametrize("chunk,s", [(16, 40), (256, 40), (16, 64),
                                     (256, 300)])
def test_ssd_chunked_matches_jax(chunk, s):
    """Chunks of 16 (S = 40: three chunks, the last padded) and 256 (S not
    a multiple), from a non-zero state."""
    b, h, p, n = 2, 3, 8, 5
    xbar = randn((b, s, h, p), 6)
    la = -np.abs(randn((b, s, h), 7, 0.1))
    bm, cm = randn((b, s, n), 8), randn((b, s, n), 9)
    st = randn((b, h, p, n), 10)
    jy, js = jssm._ssd_chunked(*(jnp.asarray(a) for a in
                                 (xbar, la, bm, cm, st)), chunk)
    y, fs = ssm._ssd_chunked(*(torch.from_numpy(a) for a in
                               (xbar, la, bm, cm, st)), chunk)
    assert y.shape == (b, s, h, p) and fs.dtype == torch.float32
    close(y.numpy(), jy, "y")
    close(fs.numpy(), js, "state")


def _recurrence(xbar, la, bm, cm, st):
    """The SSD recurrence one step at a time in float64: state_t =
    exp(la_t) state_{t-1} + xbar_t B_t^T, y_t = state_t C_t."""
    xbar, la, bm, cm, st = (np.asarray(a, np.float64) for a in
                            (xbar, la, bm, cm, st))
    ys = []
    for t in range(xbar.shape[1]):
        st = (st * np.exp(la[:, t])[:, :, None, None]
              + np.einsum("bhp,bn->bhpn", xbar[:, t], bm[:, t]))
        ys.append(np.einsum("bhpn,bn->bhp", st, cm[:, t]))
    return np.stack(ys, 1), st


def test_ssd_masks_before_the_exp_where_jax_overflows():
    """ROADMAP C19: a log-decay of -0.5 a step over a 256-token chunk puts
    seg at up to 127.5 above the diagonal, where exp overflows. The JAX
    package multiplies exp(seg) by the mask after the exp (inf * 0 = NaN);
    the port masks before it and equals the recurrence. Where exp does not
    overflow the two agree (``test_ssd_chunked_matches_jax``)."""
    b, s, h, p, n = 1, 256, 2, 4, 3
    xbar = randn((b, s, h, p), 20)
    la = np.full((b, s, h), -0.5, np.float32)
    bm, cm = randn((b, s, n), 21), randn((b, s, n), 22)
    st = np.zeros((b, h, p, n), np.float32)
    jy, _ = jssm._ssd_chunked(*(jnp.asarray(a) for a in
                                (xbar, la, bm, cm, st)), 256)
    jy = np.asarray(jy)
    assert np.isnan(jy[:, 0]).all()      # row 0 sees seg = 127.5 at j = 255
    assert np.isfinite(jy[:, 200:]).all()    # seg <= 27.5 from row 200 on
    y, fs = ssm._ssd_chunked(*(torch.from_numpy(a) for a in
                               (xbar, la, bm, cm, st)), 256)
    want, wstate = _recurrence(xbar, la, bm, cm, st)
    assert torch.isfinite(y).all()
    close(y.numpy(), want, "y")
    close(fs.numpy(), wstate, "state")


@pytest.mark.parametrize("cached", [False, True])
def test_mamba2_apply_matches_jax(block, cached):
    """A 40-token forward (chunk 16), without a cache, and from a cache
    followed by three recurrent steps; the cache is written in place."""
    cfg, jp, p = block
    jcfg = jbase.get_smoke_config(ARCH)
    x = randn((2, 40, cfg.d_model), 12, 0.5)
    if not cached:
        jy, _ = jssm.mamba2_apply(jp, jcfg, jnp.asarray(x), chunk=16)
        y = ssm.mamba2_apply(p, cfg, torch.from_numpy(x), chunk=16)
        close(y.numpy(), jy, "out")
        return
    jc = jssm.mamba2_cache(jcfg, 2, dtype=jnp.float32)
    c = ssm.mamba2_cache(cfg, 2, dtype=torch.float32)
    state, conv = c["state"], c["conv"]
    jy, jc = jssm.mamba2_apply(jp, jcfg, jnp.asarray(x[:, :37]), cache=jc,
                               chunk=16)
    y = ssm.mamba2_apply(p, cfg, torch.from_numpy(x[:, :37]), cache=c,
                         chunk=16)
    close(y.numpy(), jy, "prefill")
    for t in range(37, 40):
        jy, jc = jssm.mamba2_apply(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                   cache=jc)
        y = ssm.mamba2_apply(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                             cache=c)
        close(y.numpy(), jy, f"step {t}")
    assert c["state"] is state and c["conv"] is conv      # in place
    close(c["state"].numpy(), jc["state"], "state")
    close(c["conv"].numpy(), jc["conv"], "conv tail")


def test_mamba2_chunked_matches_stepwise_decode(block):
    """The JAX package's check on the port: a chunked prefill of S then one
    recurrent step equals the chunked pass over S+1 (chunk 16 < S)."""
    cfg, _, p = block
    b, s = 2, 33
    x = torch.from_numpy(randn((b, s + 1, cfg.d_model), 13, 0.5))
    full = ssm.mamba2_apply(p, cfg, x, chunk=16)
    cache = ssm.mamba2_cache(cfg, b, dtype=torch.float32)
    out_prefill = ssm.mamba2_apply(p, cfg, x[:, :s], cache=cache, chunk=16)
    out_step = ssm.mamba2_apply(p, cfg, x[:, s:], cache=cache)
    np.testing.assert_allclose(out_prefill.numpy(), full[:, :s].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out_step[:, 0].numpy(), full[:, s].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_mamba2_takes_the_worker_axis(block):
    """x (W, B, S, D) with per-worker parameters equals each worker's block
    applied alone (JAX's vmap)."""
    cfg, jp, p = block
    jcfg = jbase.get_smoke_config(ARCH)
    scaled = [jax.tree_util.tree_map(lambda a, s=s: a * s, jp)
              for s in (1.0, 0.9, 1.1)]
    jw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *scaled)
    pw = interop.tree_from_numpy(flat(jw), "cpu")
    x = randn((3, 2, 20, cfg.d_model), 14, 0.5)
    want = jax.vmap(lambda pp, xx: jssm.mamba2_apply(pp, jcfg, xx)[0])(
        jw, jnp.asarray(x))
    got = ssm.mamba2_apply(pw, cfg, torch.from_numpy(x))
    close(got.numpy(), want, "workers")
    with pytest.raises(ValueError, match="training layout"):
        ssm.mamba2_apply(pw, cfg, torch.from_numpy(x),
                         cache=ssm.mamba2_cache(cfg, 2))


# -------------------------------------------------------------- models --
def test_zamba2_logits_match_jax_and_the_shared_block_is_stored_once():
    jcfg, jp, cfg, p = pair(ARCH)
    assert sorted(p["stack"]) == ["rem", "shared", "units"]
    assert sorted(p["stack"]["units"]) == ["p0"]            # no p1
    assert "mamba" in p["stack"]["units"]["p0"]
    assert p["stack"]["shared"]["attn"]["q"]["w"].dim() == 2  # no depth
    toks = np.random.default_rng(15).integers(0, 512, (2, 30)).astype(
        np.int32)
    want, jaux, _ = jregistry.apply_model(jp, jcfg,
                                          {"tokens": jnp.asarray(toks)})
    got = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(toks)})
    close(got.numpy(), want, "logits")
    assert float(jaux) == 0.0
    back, jflat = interop.tree_to_numpy(p), flat(jp)
    assert list(back) == list(jflat)          # rem < shared < units
    for k in jflat:
        np.testing.assert_array_equal(back[k], jflat[k])
    full = registry.init_params(base.get_config(ARCH), device="meta")
    assert sorted(full["stack"]["units"]) == [f"p{i}" for i in range(5)]
    assert sorted(full["stack"]["rem"]) == ["p0", "p1", "p2"]
    assert full["stack"]["units"]["p0"]["mamba"]["in_proj"]["w"].shape == (
        13, 3584, 2 * 7168 + 2 * 64 + 112)


def test_shared_weights_get_the_summed_gradient():
    """Every occurrence uses ``stack.shared``: its gradient is the sum of
    the occurrences', and equals JAX's."""
    over = dict(num_layers=4)
    jcfg, jp, cfg, p = pair(ARCH, **over)
    assert cfg.block_kinds.count("shared_attn") == 2
    toks = np.random.default_rng(16).integers(0, 512, (1, 12)).astype(
        np.int32)
    labels = np.roll(toks, -1, 1)
    jg = jax.grad(lambda pp: jregistry.lm_loss(
        pp, jcfg, {"tokens": jnp.asarray(toks),
                   "labels": jnp.asarray(labels)})[0])(jp)
    leaves = [x.detach().requires_grad_(True) for x in T.leaves(p)]
    loss = registry.lm_loss_tokens(
        T.unflatten(p, leaves), cfg, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
    grads = dict(zip(T.paths(p), torch.autograd.grad(loss, leaves)))
    want = flat(jg)
    for path, g in grads.items():
        close(g.numpy(), want[path], path, rel=1e-4)


def test_cache_trees_match_jax():
    """A cache per occurrence (the shared block's too), Mamba2's float32
    state and its conv tail in the cache dtype."""
    jcfg, cfg = jbase.get_smoke_config(ARCH), base.get_smoke_config(ARCH)
    for make, jmake in ((lambda: registry.init_cache(cfg, 3, 32),
                         lambda: jregistry.init_cache(jcfg, 3, 32)),
                        (lambda: paging.init_paged_cache(cfg, 3, 20, 4, 8),
                         lambda: jpaging.init_paged_cache(jcfg, 3, 20, 4,
                                                          8))):
        got, want = make(), jmake()
        wflat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert T.paths(got) == tuple(jax.tree_util.keystr(k)
                                     for k, _ in wflat)
        for x, (_, y) in zip(T.leaves(got), wflat):
            assert tuple(x.shape) == y.shape
            assert str(x.dtype).removeprefix("torch.") == str(y.dtype)


# ------------------------------------------------------------- serving --
def test_admission_zeroes_the_mamba2_slot_and_swap_carries_it():
    """``admit_slot`` zeroes a slot's Mamba2 state and conv tail (JAX's
    ``admit_slot``); ``extract_seq_state`` / ``insert_seq_state`` carry
    them to another slot byte for byte (the extracted payload is a copy,
    not a view of the slot, on the CPU too)."""
    cfg = base.get_smoke_config(ARCH)
    cache = paging.init_paged_cache(cfg, 3, 20, 4, 8, torch.bfloat16)
    mamba = cache["units"]["p0"]
    gen = torch.Generator().manual_seed(0)
    for name in ("state", "conv"):
        mamba[name].copy_(torch.randn(mamba[name].shape, generator=gen))
    saved = paging.extract_seq_state(cache, 1)
    assert sorted(saved) == ["['units']['p0']['conv']",
                             "['units']['p0']['state']"]
    assert saved["['units']['p0']['conv']"].dtype == np.uint16   # bf16 bits
    before = {k: v.clone() for k, v in mamba.items()}
    paging.admit_slot(cache, 1, paging.build_block_table_row([0, 1], 8))
    assert (mamba["state"][:, 1] == 0).all() and (mamba["conv"][:, 1] == 0
                                                  ).all()
    for name in ("state", "conv"):
        assert torch.equal(mamba[name][:, 0], before[name][:, 0])
    paging.insert_seq_state(cache, saved, 2)
    for name in ("state", "conv"):
        assert torch.equal(mamba[name][:, 2], before[name][:, 1])
    jcache = jpaging.init_paged_cache(jbase.get_smoke_config(ARCH), 3, 20,
                                      4, 8)
    jcache = jax.tree_util.tree_map(lambda a: a + 1, jcache)
    jcache = jpaging.admit_slot(jcache, jnp.int32(1),
                                jnp.asarray(paging.build_block_table_row(
                                    [0, 1], 8)))
    assert float(jnp.abs(jcache["units"]["p0"]["state"][:, 1]).max()) == 0


def test_scheduler_and_lockstep_tokens_match_jax(monkeypatch):
    """Three slots for four requests (admission re-zeroes a used slot),
    inactive slots in decode ticks, prefill chunks of 8 against the SSD
    chunk of 256; the lockstep engine on a mixed wave."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair(ARCH)
    ps, news = prompts(512, (9, 14, 6, 11)), (12, 5, 10, 7)
    want = run_stream(JScheduler(jcfg, jp, serve_cfg(JServeConfig)), ps,
                      news)
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig), device="cpu")
    assert run_stream(sched, ps, news) == want
    jlock = jserve.LockstepEngine(jcfg, jp, batch=2).run(ps, 6)
    lock = serve.LockstepEngine(cfg, p, batch=2, device="cpu").run(ps, 6)
    for i in range(len(ps)):
        assert lock["outputs"][i].tolist() == jlock["outputs"][i].tolist()


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_preempted_stream_matches_jax_and_the_uninterrupted_run(
        mode, monkeypatch):
    """Watermark admission on 8 pages, two slots: a request is preempted
    and resumed (its Mamba2 state rebuilt by recompute, or restored from
    the swap file); tokens equal JAX's and the uninterrupted run's."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    jcfg, jp, cfg, p = pair(ARCH)
    ps, news = prompts(512, (9, 13), seed=2), (14, 10)
    kw = dict(max_seqs=2, num_pages=8, preempt=True, preempt_mode=mode,
              decode_watermark=1)
    jsched = JScheduler(jcfg, jp, serve_cfg(JServeConfig, **kw))
    want = run_stream(jsched, ps, news)
    sched = Scheduler(cfg, p, serve_cfg(ServeConfig, **kw), device="cpu")
    saved = []
    real = paging.extract_seq_state

    def spy(cache, slot):
        out = real(cache, slot)
        saved.append(out)
        return out

    monkeypatch.setattr(paging, "extract_seq_state", spy)
    assert run_stream(sched, ps, news) == want
    assert sched.preemptions + sched.forced_preemptions >= 1
    assert sched.preemptions == jsched.preemptions
    if mode == "swap":
        assert saved and all(
            "['units']['p0']['state']" in s for s in saved)
        if sched.swap_dir is not None:
            assert os.listdir(sched.swap_dir) == []
    plain = Scheduler(cfg, p, serve_cfg(ServeConfig, max_seqs=2),
                      device="cpu")
    assert run_stream(plain, ps, news) == want


def test_swap_restores_the_mamba2_state_byte_for_byte(monkeypatch):
    """The state a swap-out saved is the state the swap-in puts back: the
    slot's Mamba2 leaves right after readmission equal the saved payload
    bit for bit."""
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", "1")
    _, _, cfg, p = pair(ARCH)
    ps, news = prompts(512, (9, 13), seed=2), (14, 10)
    sched = Scheduler(cfg, p, serve_cfg(
        ServeConfig, max_seqs=2, num_pages=8, preempt=True,
        preempt_mode="swap", decode_watermark=1), device="cpu")
    saved, restored = [], []
    ext, ins = paging.extract_seq_state, paging.insert_seq_state

    def spy_out(cache, slot):
        out = ext(cache, slot)
        saved.append({k: v.copy() for k, v in out.items()})
        return out

    def spy_in(cache, state, slot):
        ins(cache, state, slot)
        restored.append({k: v.copy() for k, v in ext(cache, slot).items()})
        return cache

    monkeypatch.setattr(paging, "extract_seq_state", spy_out)
    monkeypatch.setattr(paging, "insert_seq_state", spy_in)
    run_stream(sched, ps, news)
    assert saved and len(restored) == len(saved)
    for a, b in zip(saved, restored):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_share_prefix_is_refused_on_the_hybrid():
    _, _, cfg, p = pair(ARCH)
    with pytest.raises(ValueError, match="share_prefix"):
        Scheduler(cfg, p, serve_cfg(ServeConfig, share_prefix=True),
                  device="cpu")
    with pytest.raises(ValueError, match="share_prefix"):
        JScheduler(*pair(ARCH)[:2], serve_cfg(JServeConfig,
                                              share_prefix=True))


# ------------------------------------------------------------ training --
def test_cq_ggadmm_zamba2_smoke_matches_jax():
    out = run_admm_pair(ARCH)
    paths = T.paths(out["state"].theta)
    assert sum("['shared']" in s for s in paths) == 9     # packed once


@pytest.mark.parametrize("extra", [[], ["--mix-backend", "sparse",
                                          "--fleet"],
                                   ["--mode", "fsdp"]],
                         ids=["admm", "fleet", "fsdp"])
def test_train_cli_takes_the_new_archs(extra):
    for arch in ("zamba2-7b", "olmoe-1b-7b"):
        out = train.main(["--arch", arch, "--smoke", "--workers", "2",
                          "--batch", "2", "--seq", "8", "--steps", "2",
                          "--device", "cpu", *extra])
        assert np.isfinite(out["history"]).all()
