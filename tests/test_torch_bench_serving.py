"""The serve-smoke campaign's port (``repro_torch/bench/serving.py``) on
the CPU:

* its constants, the scheduler geometry of ``_serve_cfg``, the stream,
  agreement and long-context prompts and the Zipf load requests equal the
  JAX package's (``benchmarks/bench_serving.py``) token for token;
* ``paging.cache_bytes_per_token`` equals the JAX package's for float32,
  int8 and int4 pools;
* each stage's section and claim names are the JAX stage's (read from its
  source: running the JAX stages compiles for minutes);
* the four stages run through ``--campaign serve-smoke --device cpu`` at
  the smoke width (2 layers, d_model 256) and hold every correctness
  claim. The speed claims are printed, not gated. The smoke model runs in
  float32 activations here: in bf16 its logits hold an exact bf16 tie at
  the agreement stream's request 2, step 1 (0.9375 against 0.9375), where
  greedy paged and lockstep decoding part as any two paths part at a tie
  (ROADMAP C11); the campaign's own 4x-width bf16 model holds the claim.
"""
import ast
import inspect
import json

import pytest
import torch

import benchmarks.bench_serving as JS
from repro.configs import base as jbase
from repro.launch.serve import make_prompts as jax_make_prompts
from repro.serving import paging as jpaging
from repro_torch.bench import serving as BS
from repro_torch.configs import base
from repro_torch.launch import serve, train
from repro_torch.serving import paging

CONSTANTS = ("ARCH", "BATCH", "PROMPT_LEN", "SHORT", "LONG", "DECODE_LENS",
             "PAGE_SIZE", "ZIPF_S", "N_PREFIX", "PREFIX_PAGES", "LOAD_REQS",
             "LOAD_BURSTS", "BURST_EVERY", "LOAD_POOL", "LOAD_SEQS")
STAGES = ("stage_stream", "stage_agreement", "stage_long_context",
          "stage_serve_load")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_and_geometry_equal_the_jax_stages():
    for name in CONSTANTS:
        assert getattr(BS, name) == getattr(JS, name), name
    jcfg, pcfg = JS._serve_cfg(), BS._serve_cfg()
    for f in ("max_seqs", "page_size", "num_pages", "pages_per_seq",
              "prefill_chunk", "sample", "seed"):
        assert getattr(pcfg, f) == getattr(jcfg, f), f
    jmodel = jbase.get_smoke_config(JS.ARCH).with_overrides(
        num_layers=4, d_model=512, d_ff=1024)
    pmodel = BS.config()
    for f in ("num_layers", "d_model", "d_ff", "num_heads", "num_kv_heads",
              "vocab_size", "dtype"):
        assert getattr(pmodel, f) == getattr(jmodel, f), f


def test_prompts_and_load_requests_equal_the_jax_packages():
    jcfg = jbase.get_smoke_config(JS.ARCH)
    pcfg = base.get_smoke_config(BS.ARCH)
    for n, seed in ((len(BS.DECODE_LENS), 0), (4, 1), (BS.BATCH, 2)):
        want = jax_make_prompts(jcfg, [JS.PROMPT_LEN] * n, seed=seed)
        got = serve.make_prompts(pcfg, [BS.PROMPT_LEN] * n, seed=seed)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    want = JS._zipf_load_workload(jcfg)
    got = BS._zipf_load_workload(pcfg)
    assert len(got) == len(want) == BS.LOAD_REQS
    for (p, d, i), (jp, jd, ji) in zip(got, want):
        assert (p.tolist(), d, i) == (jp.tolist(), jd, ji)


@pytest.mark.parametrize("bits", [32, 8, 4])
def test_cache_bytes_per_token_equals_the_jax_packages(bits):
    import jax.numpy as jnp
    cfg, jcfg = BS.config(), jbase.get_smoke_config(JS.ARCH).with_overrides(
        num_layers=4, d_model=512, d_ff=1024)
    dt = (torch.float32, jnp.float32) if bits == 32 else (torch.bfloat16,
                                                          jnp.bfloat16)
    got = paging.cache_bytes_per_token(paging.init_paged_cache(
        cfg, 4, 12, BS.PAGE_SIZE, 3, dtype=dt[0], kv_bits=bits))
    want = jpaging.cache_bytes_per_token(jpaging.init_paged_cache(
        jcfg, 4, 12, JS.PAGE_SIZE, 3, dtype=dt[1], kv_bits=bits))
    assert got == want
    with pytest.raises(ValueError, match="not a paged cache"):
        paging.cache_bytes_per_token({"units": {}, "rem": {"p0": {}}})


def _claims_in_source(fn):
    """(section, claim names) of a stage function, read from its source:
    every ``Claim("name", ...)`` and the ``section=`` tuple."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    names, section = [], None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = getattr(node.func, "id", getattr(node.func, "attr", ""))
            if fname == "Claim":
                names.append(node.args[0].value)
            for kw in node.keywords:
                if kw.arg == "section":
                    section = ast.literal_eval(kw.value)
    return section, names


@pytest.mark.parametrize("name", STAGES)
def test_stage_sections_and_claims_are_the_jax_stages(name):
    assert _claims_in_source(getattr(BS, name)) == _claims_in_source(
        getattr(JS, name))


@pytest.fixture
def smoke_width(monkeypatch):
    monkeypatch.setattr(BS, "config", lambda: base.get_smoke_config(
        BS.ARCH).with_overrides(dtype="float32"))
    BS._setup.cache_clear()
    yield
    BS._setup.cache_clear()


def test_serve_smoke_at_smoke_width_holds_every_correctness_claim(
        tmp_path, smoke_width, capsys):
    out = train.main(["--campaign", "serve-smoke", "--device", "cpu",
                      "--campaign-dir", str(tmp_path)])
    assert out == {"campaign": "serve-smoke", "executed": 4, "skipped": 0,
                   "failed": 0, "claim_failures": out["claim_failures"]}
    doc = json.loads((tmp_path / "BENCH_engine.json").read_text())
    serving = doc["serving"]
    assert set(serving) == {"stream", "agreement", "long_context", "load",
                            "claims"}
    want = [n for s in STAGES for n in _claims_in_source(getattr(JS, s))[1]]
    assert sorted(serving["claims"]) == sorted(want)
    bad = {k for k, ok in serving["claims"].items()
           if not ok and k not in BS.SPEED_CLAIMS}
    assert not bad, bad
    assert out["claim_failures"] == sum(
        not serving["claims"][k] for k in BS.SPEED_CLAIMS)
    # the scheduler's decisions are host decisions: equal on any device
    stream, load = serving["stream"], serving["load"]
    assert (stream["continuous_decode_steps"],
            stream["lockstep_decode_steps"]) == (76, 192)
    assert load["shared"]["shared_page_hits"] > 0
    assert stream["final_pages_in_use"] == 0
    text = capsys.readouterr().out
    assert "[train] campaign serve-smoke: kernel calls" in text
    assert "claim,serving-load,serve_load_no_page_leaks,PASS" in text


def test_teacher_forced_fidelity_agrees_with_itself_at_float32(smoke_width):
    """A short teacher-forced run: agreement rates are rates, and the int8
    pools' flips (if any) sit at near-ties."""
    cfg, params, dev = BS._setup("cpu")
    fid = BS._teacher_forced_fidelity(cfg, params, 4, dev)
    assert fid["decode_tokens"] == 4 and fid["f32_median_argmax_margin"] > 0
    for bits in (8, 4):
        assert 0.0 <= fid[f"int{bits}"]["step_agreement"] <= 1.0
    assert fid["int8"]["flips_are_near_ties"]

