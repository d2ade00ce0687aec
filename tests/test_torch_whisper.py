"""The encoder-decoder (whisper-small) through the port: sinusoidal
positions, the gelu MLP, cross-attention, the "xattn" block kind,
``registry._encode`` and ``prefill_cross_cache``, the parameter tree, logits
with stub audio frames (also under the worker axis), cached decode, the
lockstep engine and the CLI's switch to it, the paging raises, and
consensus and FSDP training, against the JAX package on numpy-seeded
inputs (the JAX init and the JAX frame draws carried across).

Tolerances and their reasons:

* float32 functions and logits: 1e-5 of max|out| (the two frameworks'
  float32 products add in different orders). ``sinusoidal_positions`` is
  held at the smoke config's positions (below 128): XLA's float32 ``exp``
  rounds 44 of whisper-small's 384 frequencies one ulp away from
  torch's, and the angle's error grows with the position (1.2e-4 at
  1,500);
* greedy token streams, leaf paths, shapes, bucket names, packed offsets
  and parameter counts: equal;
* consensus training: C5's tolerances; FSDP: the loss within rtol 1e-4,
  as ``test_torch_fsdp.py``.
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
from repro.data import lm as jlm
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.serving import paging as jpaging
from repro_torch import interop
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import packing as P
from repro_torch.core import tree as T
from repro_torch.data import lm
from repro_torch.launch import serve, train
from repro_torch.models import blocks, layers, registry
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig
from test_torch_mrope import (close, flat, jax_stub_batch, pair,
                              run_admm_pair, tokens)

ARCH = "whisper-small"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def jax_frames(cfg, batch, key=99):
    """The JAX lockstep engine's stub frames for a wave of ``batch``."""
    return interop.tensor_from_numpy(0.02 * jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(0), key),
        (batch, cfg.source_positions, cfg.d_model), jnp.bfloat16), "cpu")


# ----------------------------------------------------------- functions --
def test_sinusoidal_positions_match_jax():
    pos = np.arange(2 * 64, dtype=np.int32).reshape(2, 64)
    for dim in (256, 768):
        want = jregistry.sinusoidal_positions(jnp.asarray(pos), dim)
        got = registry.sinusoidal_positions(torch.from_numpy(pos), dim)
        assert got.dtype == torch.float32 and got.shape == (2, 64, dim)
        close(got.numpy(), want, dim)
        np.testing.assert_array_equal(got[0, 0].numpy(),
                                      np.asarray(want)[0, 0])


def test_gelu_mlp_matches_jax():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's gelu
    MLP takes the same (and differs from the exact erf form)."""
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 64, 96)
    p = interop.tree_from_numpy(flat(jp), "cpu")
    x = normal((2, 5, 64), 2)
    for act in ("gelu", "silu"):
        want = jlayers.mlp_apply(jp, jnp.asarray(x), activation=act)
        got = layers.mlp_apply(p, torch.from_numpy(x), activation=act)
        close(got.numpy(), want, act)
    exact = layers.dense(p["wo"], torch.nn.functional.gelu(
        layers.dense(p["wi_gate"], torch.from_numpy(x)))
        * layers.dense(p["wi_up"], torch.from_numpy(x)))
    assert not torch.allclose(exact, layers.mlp_apply(
        p, torch.from_numpy(x), activation="gelu"), rtol=0, atol=1e-7)


def test_cross_attention_matches_jax():
    """The query from x without a rotary embedding, the given K/V, every
    key visible; also under a worker axis (the JAX package's vmap)."""
    dims = layers.AttnDims(64, 4, 2, 16)
    jp = jlayers.attention_init(jax.random.PRNGKey(2),
                                jlayers.AttnDims(64, 4, 2, 16))
    p = interop.tree_from_numpy(flat(jp), "cpu")
    x, k, v = normal((2, 5, 64), 3), normal((2, 9, 2, 16), 4), \
        normal((2, 9, 2, 16), 5)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want, _ = jlayers.attention_apply(
        jp, jlayers.AttnDims(64, 4, 2, 16), jnp.asarray(x),
        jnp.asarray(pos), kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, _ = layers.attention_apply(
        p, dims, torch.from_numpy(x), torch.from_numpy(pos),
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    close(got.numpy(), want, "cross-attention")
    stacked = T.tree_map(lambda t: torch.stack([t, 0.5 * t]), p)
    xw = np.stack([x, x[::-1]])
    kw, vw = np.stack([k, 2 * k]), np.stack([v, v[::-1]])
    got, _ = layers.attention_apply(
        stacked, dims, torch.from_numpy(xw), torch.from_numpy(pos),
        kv_override=(torch.from_numpy(kw), torch.from_numpy(vw)))
    for w in range(2):
        jw = jax.tree_util.tree_map(lambda t: t * (1.0, 0.5)[w], jp)
        want, _ = jlayers.attention_apply(
            jw, jlayers.AttnDims(64, 4, 2, 16), jnp.asarray(xw[w]),
            jnp.asarray(pos),
            kv_override=(jnp.asarray(kw[w]), jnp.asarray(vw[w])))
        close(got[w].numpy(), want, f"worker {w}")


def test_xattn_block_matches_jax():
    jcfg, jp, cfg, p = pair(ARCH)
    one = T.tree_map(lambda t: t[0], p["stack"]["units"]["p0"])
    jone = jax.tree_util.tree_map(lambda t: t[0],
                                  jp["stack"]["units"]["p0"])
    x, enc = normal((2, 6, 256), 6), normal((2, 10, 256), 7)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want, _, _ = jblocks.apply("xattn", jone, jcfg, jnp.asarray(x),
                               jblocks.BlockCtx(positions=jnp.asarray(pos),
                                                cross_kv=jnp.asarray(enc)))
    got, aux = blocks.apply("xattn", one, cfg, torch.from_numpy(x),
                            blocks.BlockCtx(positions=torch.from_numpy(pos),
                                            cross_kv=torch.from_numpy(enc)))
    close(got.numpy(), want, "xattn block")
    assert aux == 0.0


def test_encode_and_prefill_cross_cache_match_jax():
    """The encoder over float32 frames, and every decoder layer's cross K/V
    written into a float32 cache (the port in place)."""
    jcfg, jp, cfg, p = pair(ARCH)
    frames = normal((2, 64, 256), 8, 0.02)
    want = jregistry._encode(jp, jcfg, jnp.asarray(frames))
    got = registry._encode(p, cfg, torch.from_numpy(frames))
    close(got.numpy(), want, "encoder")
    jcache = jregistry.prefill_cross_cache(
        jp, jcfg, jnp.asarray(frames),
        jregistry.init_cache(jcfg, 2, 8, dtype=jnp.float32))
    cache = registry.init_cache(cfg, 2, 8, dtype=torch.float32)
    assert registry.prefill_cross_cache(p, cfg, torch.from_numpy(frames),
                                        cache) is cache
    unit, junit = cache["units"]["p0"], jcache["units"]["p0"]
    assert sorted(unit) == sorted(junit) == ["cross_k", "cross_v", "self"]
    for name in ("cross_k", "cross_v"):
        assert unit[name].shape == (2, 2, 64, 4, 64)
        close(unit[name].numpy(), junit[name], name)


def test_prefill_cross_cache_takes_the_activation_dtype():
    """ROADMAP C20: the JAX package runs this encoder at the frames' dtype,
    so its engine's bf16 frames give a float32 config a bf16 encoder,
    unlike its uncached forward; the port casts the frames to the
    activation dtype, as its uncached forward does."""
    jcfg, jp, cfg, p = pair(ARCH)
    frames = jax_frames(cfg, 2)
    f32 = frames.float().numpy()
    ref = np.asarray(jregistry.prefill_cross_cache(
        jp, jcfg, jnp.asarray(f32), jregistry.init_cache(
            jcfg, 2, 8, dtype=jnp.float32))["units"]["p0"]["cross_k"])
    jbf = np.asarray(jregistry.prefill_cross_cache(
        jp, jcfg, jnp.asarray(f32, jnp.bfloat16), jregistry.init_cache(
            jcfg, 2, 8, dtype=jnp.float32))["units"]["p0"]["cross_k"])
    assert np.abs(jbf - ref).max() > 1e-3 * np.abs(ref).max()
    cache = registry.init_cache(cfg, 2, 8, dtype=torch.float32)
    registry.prefill_cross_cache(p, cfg, frames, cache)
    close(cache["units"]["p0"]["cross_k"].numpy(), ref, "cast frames")


# ---------------------------------------------------------------- tree --
@pytest.mark.parametrize("arch,n", [("whisper-small", 294_683_904),
                                    ("qwen2-vl-7b", 7_070_490_112)])
def test_parameter_counts_match_jax(arch, n):
    smoke = {"whisper-small": 3_279_872, "qwen2-vl-7b": 1_312_000}[arch]
    assert registry.count_params(base.get_config(arch)) == n
    assert registry.count_params(base.get_smoke_config(arch)) == smoke
    assert jregistry.count_params(jbase.get_smoke_config(arch)) == smoke


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
def test_leaf_paths_buckets_and_offsets_match_jax(arch):
    jcfg, cfg = jbase.get_smoke_config(arch), base.get_smoke_config(arch)
    jt = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    pt = registry.init_params(cfg, device="meta")
    jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
    assert T.paths(pt) == tuple(jax.tree_util.keystr(p) for p, _ in jflat)
    assert [tuple(x.shape) for x in T.leaves(pt)] == [
        tuple(x.shape) for _, x in jflat]
    names = registry.param_bucket_names(cfg)
    assert names == jregistry.param_bucket_names(jcfg)
    if arch == ARCH:
        assert names == ("attn", "embed", "mlp", "norm", "rest")
        assert "['encoder']['attn']['q']['w']" in T.paths(pt)
        assert "['stack']['units']['p0']['xattn']['k']['w']" in T.paths(pt)
    assert registry.param_buckets(cfg) == jregistry.param_buckets(jcfg)
    jw = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), jt)
    pw = T.tree_map(lambda x: torch.empty((2,) + tuple(x.shape),
                                          device="meta"), pt)
    for spec in ("model", "leaf", "block:embed,mlp,norm", "block:attn"):
        jids = JE.resolve_groups(jw, spec)
        ids = E.resolve_groups(pw, spec)
        assert tuple(ids) == tuple(jids), spec
        pk, jpk = P.make_packing(pw, ids), JP.make_packing(jw, jids)
        assert pk.offsets == tuple(jpk.offsets) and pk.dim == jpk.dim


def test_interop_round_trips_the_encoder_and_xattn_stack():
    _, jp, _, p = pair(ARCH)
    back, want = interop.tree_to_numpy(p), flat(jp)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    assert back["['encoder']['mlp']['wo']['w']"].shape == (2, 512, 256)
    assert back["['stack']['units']['p0']['lnx']['scale']"].shape == (2, 256)


def test_xattn_is_a_ported_kind_with_its_cache():
    cfg = base.get_smoke_config(ARCH)
    assert "xattn" in blocks.PORTED_KINDS
    p = blocks.init("xattn", torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(p) == ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]
    c = registry.init_cache(cfg, 3, 10)
    unit = c["units"]["p0"]
    assert unit["self"]["k"].shape == (2, 3, 10, 4, 64)
    assert unit["cross_k"].shape == (2, 3, 64, 4, 64)
    assert unit["cross_v"].dtype == torch.bfloat16


# -------------------------------------------------------------- logits --
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 4e-2)])
def test_logits_with_frames_match_jax(dtype, rel):
    """The JAX stub frames injected; alone and under a worker axis of 2
    (each worker's encoder on its own weights)."""
    jcfg, jp, cfg, p = pair(ARCH, dtype=dtype)
    raw = lm.SyntheticLM(lm.SyntheticLMConfig(512, 12, seed=1)
                         ).worker_batch(0, 2, 2)
    jb, stubs = jax_stub_batch(jcfg, raw, 0)
    b = lm.model_batch(cfg, raw, "cpu", stubs=stubs)
    assert b["frames"].shape == (2, 2, 64, 256)
    want, _, _ = jregistry.apply_model(jp, jcfg, {k: v[0]
                                                  for k, v in jb.items()})
    got = registry.apply_model(p, cfg, {k: v[0] for k, v in b.items()})
    close(got.float().numpy(), want, "one model", rel)
    stacked = T.tree_map(lambda t: torch.stack([t, 1.01 * t]), p)
    jstacked = jax.tree_util.tree_map(lambda t: jnp.stack([t, 1.01 * t]),
                                      jp)
    want = jax.vmap(lambda pp, bb: jregistry.apply_model(pp, jcfg, bb)[0])(
        jstacked, jb)
    got = registry.apply_model(stacked, cfg, b)
    close(got.float().numpy(), want, "worker axis", rel)


def test_cached_decode_matches_the_uncached_forward_and_jax():
    """Cross K/V prefilled from float32 frames, a 7-token prefill and three
    decode steps: the uncached forward's logits (port and JAX), and the
    JAX package's cached ones."""
    jcfg, jp, cfg, p = pair(ARCH)
    frames = normal((2, 64, 256), 9, 0.02)
    seq = tokens((2, 10), seed=10)
    truth, _, _ = jregistry.apply_model(jp, jcfg, {
        "tokens": jnp.asarray(seq), "frames": jnp.asarray(frames)})
    truth = np.asarray(truth)
    own = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(seq),
                                        "frames": torch.from_numpy(frames)})
    close(own.numpy(), truth, "uncached")
    cache = registry.init_cache(cfg, 2, 10, dtype=torch.float32)
    registry.prefill_cross_cache(p, cfg, torch.from_numpy(frames), cache)
    jcache = jregistry.prefill_cross_cache(
        jp, jcfg, jnp.asarray(frames),
        jregistry.init_cache(jcfg, 2, 10, dtype=jnp.float32))
    logits = registry.apply_model(p, cfg, {"tokens": torch.from_numpy(
        seq[:, :7])}, caches=cache)
    _, _, jcache = jregistry.apply_model(
        jp, jcfg, {"tokens": jnp.asarray(seq[:, :7])}, caches=jcache)
    close(logits.numpy(), truth[:, :7], "prefill")
    for i in range(7, 10):
        pos = np.full((2, 1), i, np.int32)
        logits, _ = registry.decode_step(p, cfg, torch.from_numpy(
            seq[:, i:i + 1]), torch.from_numpy(pos), cache)
        jl, jcache = jregistry.decode_step(jp, jcfg,
                                           jnp.asarray(seq[:, i:i + 1]),
                                           jnp.asarray(pos), jcache)
        close(logits.numpy()[:, 0], truth[:, i], f"decode {i}")
        close(logits.numpy(), jl, f"decode {i} cached")


# ------------------------------------------------------------- serving --
def test_lockstep_tokens_match_jax():
    """Two waves of a mixed stream, the JAX engine's frames injected (bf16
    K/V caches in both packages); the port's own frames are seeded and the
    same every wave, as the JAX engine's."""
    jcfg, jp, cfg, p = pair(ARCH)
    rng = np.random.RandomState(4)
    ps = [rng.randint(0, 512, n).astype(np.int32) for n in (9, 14, 6, 11)]
    want = jserve.LockstepEngine(jcfg, jp, batch=2).run(ps, 8)
    engine = serve.LockstepEngine(cfg, p, batch=2, device="cpu",
                                  frames=jax_frames(cfg, 2))
    got = engine.run(ps, 8)
    for i in range(len(ps)):
        assert got["outputs"][i].tolist() == want["outputs"][i].tolist(), i
    own = serve.LockstepEngine(cfg, p, batch=2, device="cpu", seed=3)
    assert torch.equal(own.wave_frames(2), own.wave_frames(2))
    assert own.wave_frames(1).shape == (1, 64, 256)
    assert own.wave_frames(2).dtype == torch.bfloat16


def test_serve_cli_switches_to_lockstep(capsys):
    """The analogue of the JAX package's test: ``--engine paged`` (the
    default) on an encoder-decoder serves through the lockstep engine
    with the encoder and cross-K/V prefill, and says so."""
    out = serve.main(["--device", "cpu", "--arch", "whisper-small",
                      "--smoke", "--batch", "2", "--prompt-len", "8",
                      "--decode-tokens", "3"])
    said = capsys.readouterr().out
    assert ("[serve] whisper-smoke is encoder-decoder: falling back to "
            "--engine lockstep") in said
    assert "engine=lockstep" in said
    assert all(v.shape == (3,) for v in out["outputs"].values())


def test_paging_raises_for_encoder_decoder_caches():
    cfg, jcfg = base.get_smoke_config(ARCH), jbase.get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="not paged"):
        paging.make_paged_block_cache("xattn", cfg, 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="not paged"):
        paging.init_paged_cache(cfg, 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="not paged"):
        jpaging.init_paged_cache(jcfg, 2, 8, 4, 4)
    with pytest.raises(NotImplementedError, match="not paged"):
        Scheduler(cfg, None, ServeConfig(max_seqs=2, page_size=4,
                                         num_pages=8, pages_per_seq=4),
                  device="cpu")


# ------------------------------------------------------------ training --
def test_cq_ggadmm_whisper_smoke_matches_jax():
    run_admm_pair(ARCH)


def test_fsdp_step_of_whisper_smoke_matches_jax(tmp_path):
    """AdamW steps of the FSDP baseline with the JAX frame draws
    injected."""
    jcfg = jbase.get_smoke_config(ARCH).with_overrides(dtype="float32")
    cfg = base.get_smoke_config(ARCH).with_overrides(dtype="float32")

    def args(tmp):
        return argparse.Namespace(
            arch=ARCH, smoke=True, mode="fsdp", steps=2, batch=2, seq=16,
            lr=1e-3, seed=0, log_every=1, ckpt_dir=str(tmp),
            ckpt_every=100, device="cpu", fleet=False)

    jout = jtrain.run_fsdp(jcfg, args(tmp_path / "jax"))
    jp0 = jregistry.init_params(jcfg, jax.random.PRNGKey(0))
    data = jlm.SyntheticLM(jlm.SyntheticLMConfig(512, 16, seed=0))
    stubs = [jax_stub_batch(jcfg, data.batch(i, 2), i)[1] for i in range(2)]
    out = train.run_fsdp(cfg, args(tmp_path / "port"),
                         params=interop.model_params_from_numpy(
                             flat(jp0), cfg, "cpu"),
                         stubs=lambda i: stubs[i])
    np.testing.assert_allclose(out["history"], jout["history"], rtol=1e-4)
