"""Serving benchmark stages (campaign ``serve-smoke``): the port of
``benchmarks/bench_serving.py``, with the same constants, workloads,
sections and claims, on the card (or the CPU when the run context asks).

The stream is the pathology the scheduler exists for: a mixed-length
request stream where every fixed batch ("wave") holds one long generation.
The lockstep engine cannot admit new work until a whole wave finishes, so
each wave costs max(decode_len) steps while its short requests sit idle;
the paged scheduler evicts the shorts mid-flight, recycles their pages and
admits the next requests into the freed slots. Stages:

* ``stream``: continuous batching against lockstep tokens/s (>= 1.5x);
* ``agreement``: paged greedy equal to lockstep greedy token for token,
  and no page leak over the stream and agreement runs (it reads the stream
  section through ``ctx.store``);
* ``long_context``: float32, int8 and int4-packed KV pages of 8 tokens:
  the modeled cache bytes per token (>= 3.5x and >= 6x smaller), no page
  leak, and the int8 pages' teacher-forced greedy fidelity against the
  float32 pools (>= 0.95 step agreement, flips only at near-ties);
* ``serve_load``: Zipf-weighted shared prefixes in bursts against a pool
  of a third of the unshared demand: prefix sharing against private
  copies (equal tokens, >= 1.3x tokens/s, >= 2x fewer pages per request,
  p99 TTFT <= 0.8x, no leaks).

The model is tinyllama's smoke config at 4x its width (4 layers, d_model
512, d_ff 1024; head dim 64), random weights from seed 0 (the port's
generator, not ``jax.random``), bf16 activations. Every windowless decode
runs the paged-attention kernel (B7) on the card. The prompts, decode
lengths and load requests are the JAX package's, token for token.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign \\
        serve-smoke [--device cpu]
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch.campaign.measure import percentiles as _pcts
from repro_torch.campaign.runner import FatalError
from repro_torch.campaign.store import Claim, Record
from repro_torch.configs import base
from repro_torch.device import resolve_device
from repro_torch.launch.serve import LockstepEngine, make_prompts
from repro_torch.models import registry
from repro_torch.serving import paging
from repro_torch.serving.scheduler import Scheduler, ServeConfig

ARCH = "tinyllama-1.1b"
BATCH = 4                    # lockstep wave width == scheduler slots
PROMPT_LEN = 17              # 2 exact prefill chunks + 1 decode-ride token
SHORT, LONG = 4, 64
# one long per lockstep wave: each of the three waves pays LONG decode
# steps for BATCH requests while its three shorts sit finished-but-held;
# the scheduler overlaps the three longs instead
DECODE_LENS = (LONG, SHORT, SHORT, SHORT,
               LONG, SHORT, SHORT, SHORT,
               SHORT, SHORT, LONG, SHORT)
PAGE_SIZE = 8
# the claims that time the system; the rest are correctness claims
SPEED_CLAIMS = ("serving_continuous_speedup_geq_1_5",
                "serve_load_shared_tps_geq_1_3x",
                "serve_load_p99_ttft_shared_leq_unshared")


def _serve_cfg(**kw) -> ServeConfig:
    pages_per_seq = paging.pages_needed(PROMPT_LEN + LONG, PAGE_SIZE)
    return ServeConfig(
        max_seqs=BATCH, page_size=PAGE_SIZE,
        num_pages=BATCH * pages_per_seq, pages_per_seq=pages_per_seq,
        prefill_chunk=16, sample="greedy", seed=0, **kw)


def bench_continuous_vs_lockstep(cfg, params, dev) -> dict:
    prompts = make_prompts(cfg, [PROMPT_LEN] * len(DECODE_LENS), seed=0)

    tokens = float(sum(DECODE_LENS))
    repeats = 2     # best-of-N, the bench_engine timing convention

    # --- lockstep: warm one full-shape wave, then time the stream -------
    lock = LockstepEngine(cfg, params, batch=BATCH, device=dev)
    lock.run(prompts[:BATCH], LONG)                        # warm-up
    lock_out = lock.run(prompts, LONG)  # every wave pays its longest member
    lock_wall = min([lock_out["wall_s"]]
                    + [lock.run(prompts, LONG)["wall_s"]
                       for _ in range(repeats - 1)])
    lock_tps = tokens / max(lock_wall, 1e-9)

    # --- scheduler: warm up, then time the same stream ------------------
    sched = Scheduler(cfg, params, _serve_cfg(), device=dev)
    warm = sched.submit(prompts[0], 2)
    sched.run()
    assert warm in sched.finished and sched.pool.in_use == 0
    sched_walls, decode_steps, prefill_chunks = [], 0, 0
    lat0 = len(sched.decode_step_s)          # drop the warm-up samples
    timed_rids = []
    for _ in range(repeats):
        steps0, chunks0 = sched.decode_steps, sched.prefill_chunks
        rids = [sched.submit(p, n) for p, n in zip(prompts, DECODE_LENS)]
        t0 = time.time()
        sched.run()
        sched_walls.append(time.time() - t0)
        decode_steps = sched.decode_steps - steps0
        prefill_chunks = sched.prefill_chunks - chunks0
        assert all(sched.finished[r].shape == (n,)
                   for r, n in zip(rids, DECODE_LENS))
        assert sched.pool.in_use == 0
        timed_rids += rids
    sched_wall = min(sched_walls)
    sched_tps = tokens / max(sched_wall, 1e-9)
    step_lat = _pcts(list(sched.decode_step_s)[lat0:])
    # TTFT from submit (queueing included); ttft_queue is its submit ->
    # first-admission part
    ttft = _pcts(sched.ttft_s[r] for r in timed_rids)
    ttft_queue = _pcts(sched.ttft_queue_s[r] for r in timed_rids)

    return {
        "workload": {"arch": cfg.name, "batch": BATCH,
                     "prompt_len": PROMPT_LEN,
                     "decode_lens": list(DECODE_LENS)},
        "lockstep_wall_s": lock_wall,
        "lockstep_tokens_per_s": lock_tps,
        "lockstep_decode_steps": lock_out["decode_steps"],
        "continuous_wall_s": sched_wall,
        "continuous_tokens_per_s": sched_tps,
        "continuous_decode_steps": decode_steps,
        "continuous_prefill_chunks": prefill_chunks,
        "speedup": sched_tps / max(lock_tps, 1e-9),
        "decode_step_latency": step_lat,
        "ttft": ttft,
        "ttft_queue": ttft_queue,
        "peak_pages_in_use": int(sched.peak_pages_in_use),
        "final_pages_in_use": int(sched.pool.in_use),
        "num_pages": sched.cfg.num_pages,
        "page_pool_bytes": int(paging.cache_page_bytes(sched.cache)),
    }


def bench_agreement(cfg, params, dev) -> dict:
    """Greedy paged scheduler against greedy lockstep on an equal-length
    stream (no padding distortion): outputs must match token for token."""
    n_req, dec = 4, 6
    prompts = make_prompts(cfg, [PROMPT_LEN] * n_req, seed=1)
    lock_out = LockstepEngine(cfg, params, batch=BATCH,
                              device=dev).run(prompts, dec)
    sched = Scheduler(cfg, params, _serve_cfg(), device=dev)
    rids = [sched.submit(p, dec) for p in prompts]
    sched.run()
    agree = all(
        sched.finished[r].tolist() == lock_out["outputs"][i].tolist()
        for i, r in enumerate(rids))
    return {"requests": n_req, "decode_tokens": dec,
            "paged_matches_lockstep": bool(agree),
            "final_pages_in_use": int(sched.pool.in_use)}


def _teacher_forced_fidelity(cfg, params, dec: int, dev) -> dict:
    """Per-step greedy fidelity of the quantized caches against float32
    pages. Whole-trajectory identity is no gate at this length (random
    weights put the vocab logits within ~0.1 of each other, so one
    near-tie flip diverges the rest of a sequence). Decode the float32
    greedy trajectory once, then teacher-force the same tokens through the
    int8 and int4 caches (bf16 pools hold the codes' activations, as in
    the JAX package) and compare each step's logits: the agreement rate,
    the worst logit perturbation, and whether every argmax flip happened
    at a float32 top-2 margin below twice that perturbation."""
    B = BATCH
    prompts = np.stack(make_prompts(cfg, [PROMPT_LEN] * B, seed=2))
    pages_per_seq = paging.pages_needed(PROMPT_LEN + dec, PAGE_SIZE)
    num_pages = B * pages_per_seq

    def trajectory(bits, forced=None):
        cache = paging.init_paged_cache(
            cfg, B, num_pages, PAGE_SIZE, pages_per_seq,
            dtype=torch.float32 if bits == 32 else torch.bfloat16,
            kv_bits=bits, device=dev)
        pool = paging.PagePool(num_pages)
        for b in range(B):
            row = paging.build_block_table_row(
                pool.alloc(pages_per_seq), pages_per_seq)
            paging.admit_slot(cache, b, row)
        logits = registry.apply_model(
            params, cfg, {"tokens": torch.as_tensor(prompts, device=dev)},
            caches=cache)
        steps = [logits[:, -1].float().cpu().numpy()]

        def pick(logits, i):
            if forced is None:
                return torch.argmax(logits[:, -1], dim=-1)
            return torch.as_tensor(forced[:, i], device=dev)

        t = pick(logits, 0)[:, None].to(torch.int32)
        toks = [t[:, 0].cpu().numpy()]
        for i in range(dec - 1):
            pos = registry.build_positions(
                cfg, np.full((B, 1), PROMPT_LEN + i, np.int32)).to(dev)
            logits, cache = registry.decode_step(params, cfg, t, pos, cache)
            steps.append(logits[:, -1].float().cpu().numpy())
            t = pick(logits, i + 1)[:, None].to(torch.int32)
            toks.append(t[:, 0].cpu().numpy())
        return np.stack(toks, 1), np.stack(steps, 1)   # (B,dec) (B,dec,V)

    f32_toks, f32_logits = trajectory(32)
    srt = np.sort(f32_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    out = {"decode_tokens": dec,
           "f32_median_argmax_margin": float(np.median(margin))}
    for bits in (8, 4):
        _, ql = trajectory(bits, forced=f32_toks)
        agree = ql.argmax(-1) == f32_logits.argmax(-1)
        dev_max = float(np.abs(ql - f32_logits).max())
        flips = margin[~agree]
        out[f"int{bits}"] = {
            "step_agreement": float(agree.mean()),
            "flips": int((~agree).sum()),
            "max_logit_dev": dev_max,
            "max_flip_margin": float(flips.max()) if flips.size else 0.0,
            # a flip at a margin wider than twice the logit perturbation
            # cannot be explained by quantization noise -> codec bug
            "flips_are_near_ties":
                bool(flips.size == 0 or flips.max() < 2.0 * dev_max),
        }
    return out


def bench_long_context(cfg, params, dev) -> dict:
    """A long-decode stream served from float32, int8 and int4-packed KV
    pages: the modeled cache footprint (bytes per cached token, exact from
    the pools' shapes and dtypes), the measured decode step latency and a
    leak check per bit width (scheduler runs), and the teacher-forced
    greedy fidelity of the quantized caches against the float32 pools."""
    dec = LONG
    prompts = make_prompts(cfg, [PROMPT_LEN] * BATCH, seed=2)
    per_bits = {}
    for bits in (32, 8, 4):
        scfg = _serve_cfg(
            kv_bits=bits,
            # float32 pools anchor the reduction ratio
            **({"cache_dtype": "float32"} if bits == 32 else {}))
        sched = Scheduler(cfg, params, scfg, device=dev)
        warm = sched.submit(prompts[0], 2)
        sched.run()
        assert warm in sched.finished and sched.pool.in_use == 0
        lat0 = len(sched.decode_step_s)
        rids = [sched.submit(p, dec) for p in prompts]
        t0 = time.time()
        sched.run()
        wall = time.time() - t0
        assert all(sched.finished[r].shape == (dec,) for r in rids)
        per_bits[bits] = {
            "cache_bytes_per_token":
                float(paging.cache_bytes_per_token(sched.cache)),
            "page_pool_bytes": int(paging.cache_page_bytes(sched.cache)),
            "wall_s": wall,
            "decode_step_latency":
                _pcts(list(sched.decode_step_s)[lat0:]),
            "final_pages_in_use": int(sched.pool.in_use),
        }
    f32 = per_bits[32]["cache_bytes_per_token"]
    out = {
        "workload": {"arch": cfg.name, "batch": BATCH,
                     "prompt_len": PROMPT_LEN, "decode_tokens": dec},
        "bytes_reduction_int8": f32 / per_bits[8]["cache_bytes_per_token"],
        "bytes_reduction_int4": f32 / per_bits[4]["cache_bytes_per_token"],
        "fidelity": _teacher_forced_fidelity(cfg, params, dec, dev),
        "no_page_leaks": all(v["final_pages_in_use"] == 0
                             for v in per_bits.values()),
    }
    for bits, v in per_bits.items():
        out[f"kv{bits}"] = v
    return out


# ------------------------------------------------------------ serve load --
# Production-shaped pressure: N_PREFIX system prompts drawn Zipf(ZIPF_S),
# each followed by a short unique suffix and a varied decode budget,
# arriving in bursts against a pool sized well below the unshared worst
# case. The shared arm maps the hot prefix pages copy-on-write; the
# unshared arm pays for private copies and queues at admission. Both arms
# run watermark admission and preemption, so the gap isolates sharing.
ZIPF_S = 1.1
N_PREFIX = 4
PREFIX_PAGES = 10            # 80-token shared system prompt
LOAD_REQS = 24
LOAD_BURSTS = 4
BURST_EVERY = 6              # scheduler ticks between arrival bursts
LOAD_POOL = 56               # ~1/3 of the unshared worst-case demand
LOAD_SEQS = 8


def _zipf_load_workload(cfg, seed: int = 3):
    """(prompt, decode_len, prefix_id) per request: a Zipf-weighted
    prefix, a unique suffix of 3-10 tokens, a decode budget of 12-28 (the
    JAX package's draws, from ``np.random.RandomState``)."""
    rng = np.random.RandomState(seed)
    plen = PREFIX_PAGES * PAGE_SIZE
    prefixes = [rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
                for _ in range(N_PREFIX)]
    weights = 1.0 / np.arange(1, N_PREFIX + 1) ** ZIPF_S
    weights /= weights.sum()
    reqs = []
    for _ in range(LOAD_REQS):
        pid = int(rng.choice(N_PREFIX, p=weights))
        suffix = rng.randint(0, cfg.vocab_size,
                             3 + int(rng.randint(8))).astype(np.int32)
        dec = 12 + int(rng.randint(17))
        reqs.append((np.concatenate([prefixes[pid], suffix]), dec, pid))
    return reqs


def _run_serve_load(cfg, params, reqs, dev, *, share: bool) -> dict:
    max_ctx = max(len(p) + d for p, d, _ in reqs)
    scfg = ServeConfig(
        max_seqs=LOAD_SEQS, page_size=PAGE_SIZE, num_pages=LOAD_POOL,
        pages_per_seq=paging.pages_needed(max_ctx, PAGE_SIZE),
        prefill_chunk=16, sample="greedy", seed=0,
        share_prefix=share, preempt=True, decode_watermark=2,
        wm_low=0.05, wm_high=0.2)
    sched = Scheduler(cfg, params, scfg, device=dev)
    warm = sched.submit(reqs[0][0][:PROMPT_LEN], 2)    # warm-up
    sched.run()
    assert warm in sched.finished and sched.pool.in_use == 0
    alloc0, hits0 = sched.pages_alloc_events, sched.shared_page_hits
    itl0, tick0 = len(sched.itl_s), sched.steps
    per_burst = (LOAD_REQS + LOAD_BURSTS - 1) // LOAD_BURSTS
    bursts = [reqs[b * per_burst:(b + 1) * per_burst]
              for b in range(LOAD_BURSTS)]
    rids, b = [], 0
    t0 = time.time()
    while b < LOAD_BURSTS or sched.busy:
        while b < LOAD_BURSTS and sched.steps - tick0 >= b * BURST_EVERY:
            rids += [sched.submit(p, d) for p, d, _ in bursts[b]]
            b += 1
        sched.step()
    wall = time.time() - t0
    assert sched.pool.in_use == 0, "page leak under load"
    tokens = float(sum(d for _, d, _ in reqs))
    return {
        "share_prefix": share,
        "wall_s": wall,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "ttft": _pcts(sched.ttft_s[r] for r in rids),
        "ttft_queue": _pcts(sched.ttft_queue_s[r] for r in rids),
        "itl": _pcts(list(sched.itl_s)[itl0:]),
        "pages_alloc_events": sched.pages_alloc_events - alloc0,
        "pages_alloc_per_request":
            (sched.pages_alloc_events - alloc0) / len(reqs),
        "shared_page_hits": sched.shared_page_hits - hits0,
        "cow_forks": int(sched.cow_forks),
        "preemptions": int(sched.preemptions),
        "forced_preemptions": int(sched.forced_preemptions),
        "peak_pages_in_use": int(sched.peak_pages_in_use),
        "final_pages_in_use": int(sched.pool.in_use),
        "outputs": {r: sched.finished[r].tolist() for r in rids},
    }


def bench_serve_load(cfg, params, dev) -> dict:
    reqs = _zipf_load_workload(cfg)
    unshared = _run_serve_load(cfg, params, reqs, dev, share=False)
    shared = _run_serve_load(cfg, params, reqs, dev, share=True)
    # greedy and deterministic replay: sharing and preemption must be
    # invisible in the tokens, or the speedup measures a wrong answer
    identical = shared["outputs"] == unshared["outputs"]
    out_shared = {k: v for k, v in shared.items() if k != "outputs"}
    out_unshared = {k: v for k, v in unshared.items() if k != "outputs"}
    return {
        "workload": {
            "arch": cfg.name, "requests": LOAD_REQS,
            "zipf_s": ZIPF_S, "n_prefixes": N_PREFIX,
            "prefix_tokens": PREFIX_PAGES * PAGE_SIZE,
            "bursts": LOAD_BURSTS, "burst_every_ticks": BURST_EVERY,
            "num_pages": LOAD_POOL, "max_seqs": LOAD_SEQS,
            "page_size": PAGE_SIZE},
        "shared": out_shared,
        "unshared": out_unshared,
        "tokens_identical": bool(identical),
        "shared_over_unshared_tps":
            shared["tokens_per_s"] / max(unshared["tokens_per_s"], 1e-9),
        "pages_per_request_reduction":
            unshared["pages_alloc_per_request"]
            / max(shared["pages_alloc_per_request"], 1e-9),
        "ttft_p99_shared_over_unshared":
            shared["ttft"]["p99_ms"] / max(unshared["ttft"]["p99_ms"],
                                           1e-9),
        "no_page_leaks": (shared["final_pages_in_use"] == 0
                          and unshared["final_pages_in_use"] == 0),
    }


# ------------------------------------------------------- campaign stages --
def config():
    """4x the smoke width: per-step device work large enough that the
    measured ratio tracks the decode-step ratio, not tick overhead."""
    return base.get_smoke_config(ARCH).with_overrides(
        num_layers=4, d_model=512, d_ff=1024)


@functools.lru_cache(maxsize=2)
def _setup(device: str):
    """Model and parameters shared by the serving runs on ``device``
    (cached per process)."""
    dev = resolve_device(device)
    cfg = config()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, params, dev


def _ctx_setup(ctx):
    return _setup(str(resolve_device(ctx.device if ctx is not None
                                     else None)))


def stage_stream(ctx=None) -> Record:
    cfg, params, dev = _ctx_setup(ctx)
    stream = bench_continuous_vs_lockstep(cfg, params, dev)
    print(f"# serving: lockstep {stream['lockstep_tokens_per_s']:.1f} tok/s "
          f"({stream['lockstep_decode_steps']} steps) vs continuous "
          f"{stream['continuous_tokens_per_s']:.1f} tok/s "
          f"({stream['continuous_decode_steps']} steps, "
          f"{stream['continuous_prefill_chunks']} prefill chunks) -> "
          f"speedup {stream['speedup']:.2f}x")
    print(f"# serving: pages peak={stream['peak_pages_in_use']}/"
          f"{stream['num_pages']} final={stream['final_pages_in_use']} "
          f"pool={stream['page_pool_bytes'] / 1e6:.1f}MB")
    print(f"# serving: decode step "
          f"p50={stream['decode_step_latency']['p50_ms']:.2f}ms "
          f"p99={stream['decode_step_latency']['p99_ms']:.2f}ms, "
          f"ttft p50={stream['ttft']['p50_ms']:.1f}ms "
          f"p99={stream['ttft']['p99_ms']:.1f}ms "
          f"(queue p50={stream['ttft_queue']['p50_ms']:.1f}ms "
          f"p99={stream['ttft_queue']['p99_ms']:.1f}ms)")
    return Record(
        section=("serving", "stream"), data=stream,
        claims=(
            Claim("serving_continuous_speedup_geq_1_5",
                  stream["speedup"] >= 1.5, value=stream["speedup"],
                  gate=">= 1.5x lockstep tokens/s"),),
        claims_path=("serving", "claims"))


def stage_agreement(ctx=None) -> Record:
    cfg, params, dev = _ctx_setup(ctx)
    agreement = bench_agreement(cfg, params, dev)
    print(f"# serving: agreement paged==lockstep="
          f"{agreement['paged_matches_lockstep']} "
          f"({agreement['requests']}x{agreement['decode_tokens']} greedy)")
    # the leak gate spans the stream and agreement runs: read the stream
    # section the store already merged (this stage depends on it)
    stream = (ctx.store.section(("serving", "stream"))
              if ctx is not None else None)
    if stream is None:
        raise FatalError("serving.stream section missing — run the "
                         "serving-stream stage first")
    no_leaks = (stream["final_pages_in_use"] == 0
                and agreement["final_pages_in_use"] == 0)
    return Record(
        section=("serving", "agreement"), data=agreement,
        claims=(
            Claim("serving_paged_matches_lockstep",
                  agreement["paged_matches_lockstep"],
                  gate="greedy tokens identical"),
            Claim("serving_no_page_leaks", no_leaks,
                  value={"stream": stream["final_pages_in_use"],
                         "agreement": agreement["final_pages_in_use"]},
                  gate="0 pages in use after drain"),),
        claims_path=("serving", "claims"))


def stage_long_context(ctx=None) -> Record:
    cfg, params, dev = _ctx_setup(ctx)
    lc = bench_long_context(cfg, params, dev)
    fid = lc["fidelity"]
    print(f"# long_context: cache bytes/token f32="
          f"{lc['kv32']['cache_bytes_per_token']:.0f} -> int8 "
          f"{lc['bytes_reduction_int8']:.2f}x, int4 "
          f"{lc['bytes_reduction_int4']:.2f}x")
    print(f"# long_context: teacher-forced step agreement int8="
          f"{fid['int8']['step_agreement']:.4f} "
          f"(max|dlogits|={fid['int8']['max_logit_dev']:.3f}, "
          f"near-ties={fid['int8']['flips_are_near_ties']}) int4="
          f"{fid['int4']['step_agreement']:.4f}")
    print(f"# long_context: decode step p50 f32="
          f"{lc['kv32']['decode_step_latency']['p50_ms']:.2f}ms "
          f"int8={lc['kv8']['decode_step_latency']['p50_ms']:.2f}ms "
          f"int4={lc['kv4']['decode_step_latency']['p50_ms']:.2f}ms")
    return Record(
        section=("serving", "long_context"), data=lc,
        claims=(
            Claim("long_context_int8_bytes_reduction_geq_3_5",
                  lc["bytes_reduction_int8"] >= 3.5,
                  value=lc["bytes_reduction_int8"], gate=">= 3.5x vs f32"),
            Claim("long_context_int4_bytes_reduction_geq_6",
                  lc["bytes_reduction_int4"] >= 6.0,
                  value=lc["bytes_reduction_int4"], gate=">= 6x vs f32"),
            Claim("long_context_int8_step_agreement_geq_0_95",
                  fid["int8"]["step_agreement"] >= 0.95,
                  value=fid["int8"]["step_agreement"], gate=">= 0.95"),
            Claim("long_context_int8_flips_are_near_ties",
                  fid["int8"]["flips_are_near_ties"],
                  value=fid["int8"]["max_flip_margin"],
                  gate="flip margin < 2 * max|dlogits|"),
            Claim("long_context_no_page_leaks", lc["no_page_leaks"],
                  gate="0 pages in use after drain, all bit widths"),),
        claims_path=("serving", "claims"))


def stage_serve_load(ctx=None) -> Record:
    cfg, params, dev = _ctx_setup(ctx)
    load = bench_serve_load(cfg, params, dev)
    sh, un = load["shared"], load["unshared"]
    print(f"# serve_load: unshared {un['tokens_per_s']:.1f} tok/s "
          f"({un['pages_alloc_per_request']:.1f} pages/req, "
          f"{un['preemptions']} preempt) vs shared "
          f"{sh['tokens_per_s']:.1f} tok/s "
          f"({sh['pages_alloc_per_request']:.1f} pages/req, "
          f"{sh['shared_page_hits']} hits, {sh['cow_forks']} forks) -> "
          f"{load['shared_over_unshared_tps']:.2f}x tps, "
          f"{load['pages_per_request_reduction']:.2f}x fewer pages/req")
    print(f"# serve_load: ttft p99 shared={sh['ttft']['p99_ms']:.0f}ms "
          f"(queue {sh['ttft_queue']['p99_ms']:.0f}ms) unshared="
          f"{un['ttft']['p99_ms']:.0f}ms "
          f"(queue {un['ttft_queue']['p99_ms']:.0f}ms); itl p50 "
          f"shared={sh['itl']['p50_ms']:.1f}ms "
          f"unshared={un['itl']['p50_ms']:.1f}ms; "
          f"tokens_identical={load['tokens_identical']}")
    return Record(
        section=("serving", "load"), data=load,
        claims=(
            Claim("serve_load_tokens_identical",
                  load["tokens_identical"],
                  gate="shared greedy tokens == unshared greedy tokens"),
            Claim("serve_load_shared_tps_geq_1_3x",
                  load["shared_over_unshared_tps"] >= 1.3,
                  value=load["shared_over_unshared_tps"],
                  gate=">= 1.3x unshared tokens/s at pool pressure"),
            Claim("serve_load_pages_per_request_reduction_geq_2x",
                  load["pages_per_request_reduction"] >= 2.0,
                  value=load["pages_per_request_reduction"],
                  gate=">= 2x fewer physical pages per request"),
            Claim("serve_load_p99_ttft_shared_leq_unshared",
                  load["ttft_p99_shared_over_unshared"] <= 0.8,
                  value=load["ttft_p99_shared_over_unshared"],
                  gate="shared p99 TTFT <= 0.8x unshared"),
            Claim("serve_load_no_page_leaks", load["no_page_leaks"],
                  gate="0 pages in use after drain, both arms"),),
        claims_path=("serving", "claims"))
