"""Serving driver on the card: the paged continuous-batching scheduler
(default) or the lockstep fixed-batch baseline (the port of
``repro.launch.serve``).

``--engine paged`` serves a stream of (possibly mixed-length) requests
through ``repro_torch.serving.scheduler``: paged KV cache (or per-slot
recurrent state for xlstm-125m), admission on free pages, chunked
prefill, eviction mid-flight; its single-token decode attention runs the
paged-attention kernels, and an xLSTM prefill chunk the sLSTM cell
kernel. ``--engine lockstep`` is the fixed-batch baseline with one
contiguous cache per wave: no admission until the whole wave has
finished.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --prompt-lens 9,17,5 --decode-tokens 8 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --smoke --prompt-lens 9,17,5,13 --decode-tokens 8 [--engine lockstep]

Without ``--device cpu`` it runs on the CUDA card and raises when there is
none; ``--full`` serves the full-width model. ``--share-prefix``,
``--preempt``, ``--preempt-mode swap``, ``--swa-recycle`` and ``--trace``
are not ported yet (ROADMAP.md) and exit with a message.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving import paging
from repro_torch.serving.scheduler import (Scheduler, ServeConfig,
                                           draw_seed, sample_tokens)

NOT_PORTED = "is not ported yet (ROADMAP.md queue A: serving)"


def make_prompts(cfg, prompt_lens, seed: int, prefix_len: int = 0):
    """Deterministic synthetic prompts, one per requested length (the JAX
    package's, token for token). With ``prefix_len`` > 0 every prompt
    starts with the same ``prefix_len`` tokens."""
    rows = len(prompt_lens) + (1 if prefix_len else 0)
    data = SyntheticLM(SyntheticLMConfig(
        cfg.vocab_size, prefix_len + max(prompt_lens), seed=seed))
    raw = data.batch(0, rows)["tokens"]
    prefix = (np.asarray(raw[-1, :prefix_len], np.int32) if prefix_len
              else np.zeros((0,), np.int32))
    return [np.concatenate([prefix, np.asarray(raw[i, :n], np.int32)])
            for i, n in enumerate(prompt_lens)]


# ------------------------------------------------------------- lockstep --
class LockstepEngine:
    """Fixed-batch baseline, as the JAX package's: pad every prompt to the
    longest prompt of the whole stream (by repeating its last token),
    prefill each wave into a contiguous cache of ``longest +
    decode_tokens`` slots, decode until the whole wave has its tokens. A
    stream of equal-length prompts carries no padding and is the
    per-request contiguous reference of the paged path. The cache holds
    bf16 K/V, as the JAX package's does; ``cache_dtype`` float32 makes it
    the reference of a float32 paged cache."""

    def __init__(self, cfg, params, *, sample: str = "greedy",
                 temperature: float = 1.0, batch: int = 4, seed: int = 0,
                 device=None, cache_dtype=torch.bfloat16):
        self.cfg, self.params = cfg, params
        self.cache_dtype = cache_dtype
        self.sample, self.temperature = sample, temperature
        self.batch, self.seed = batch, seed
        self.device = resolve_device(device)

    def _next(self, logits, wave: int, step: int) -> torch.Tensor:
        seeds = [draw_seed(self.seed, wave, step, j)
                 for j in range(logits.shape[0])]
        return sample_tokens(logits[:, -1, :], self.sample,
                             self.temperature, seeds)

    def run(self, prompts, decode_tokens: int, *,
            keep_top: int = 0) -> dict:
        """Serve ``prompts``, ``decode_tokens`` new tokens each, in waves
        of ``self.batch``. With ``keep_top`` = k > 0 the result also holds,
        per request, the k largest logits and their token ids at every
        sampled position, (decode_tokens, k) arrays on the host."""
        cfg, dev = self.cfg, self.device
        waves = [list(range(i, min(i + self.batch, len(prompts))))
                 for i in range(0, len(prompts), self.batch)]
        plen = max(len(p) for p in prompts)
        outputs, top = {}, {}
        t0 = time.perf_counter()
        for wi, wave in enumerate(waves):
            wb = len(wave)
            toks = np.zeros((wb, plen), np.int32)
            for j, i in enumerate(wave):
                toks[j, :len(prompts[i])] = prompts[i]
                toks[j, len(prompts[i]):] = prompts[i][-1]
            cache = registry.init_cache(cfg, wb, plen + decode_tokens,
                                        dtype=self.cache_dtype, device=dev)
            positions = torch.broadcast_to(
                torch.arange(plen, dtype=torch.int32, device=dev)[None],
                (wb, plen))
            logits = registry.apply_model(
                self.params, cfg,
                {"tokens": torch.as_tensor(toks, device=dev),
                 "positions": positions}, caches=cache)
            nxt = self._next(logits, wi, 0)
            gen, kept = [nxt], []
            if keep_top:
                kept.append(torch.topk(logits[:, -1].float(), keep_top,
                                       dim=-1))
            for i in range(decode_tokens - 1):
                pos = registry.build_positions(
                    cfg, np.full((wb, 1), plen + i, np.int32)).to(dev)
                logits, cache = registry.decode_step(
                    self.params, cfg, nxt[:, None].to(torch.int32), pos,
                    cache)
                nxt = self._next(logits, wi, i + 1)
                gen.append(nxt)
                if keep_top:
                    kept.append(torch.topk(logits[:, -1].float(), keep_top,
                                           dim=-1))
            stacked = torch.stack(gen, dim=1).cpu().numpy().astype(np.int32)
            if keep_top:
                vals = torch.stack([k.values for k in kept], 1).cpu().numpy()
                ids = torch.stack([k.indices for k in kept], 1).cpu().numpy()
            for j, i in enumerate(wave):
                outputs[i] = stacked[j]
                if keep_top:
                    top[i] = (vals[j], ids[j])
        wall = time.perf_counter() - t0
        total = decode_tokens * len(prompts)
        out = {"outputs": outputs, "wall_s": wall,
               "tokens_per_s": total / max(wall, 1e-9),
               "decode_steps": decode_tokens * len(waves)}
        if keep_top:
            out["top"] = top
        return out


def run_lockstep(cfg, params, prompts, decode_tokens: int, *,
                 sample: str = "greedy", temperature: float = 1.0,
                 batch: int = 4, seed: int = 0, device=None) -> dict:
    return LockstepEngine(cfg, params, sample=sample,
                          temperature=temperature, batch=batch, seed=seed,
                          device=device).run(prompts, decode_tokens)


# ---------------------------------------------------------------- paged --
def run_paged(cfg, params, prompts, decode_tokens: int, *,
              serve_cfg: ServeConfig, device=None) -> dict:
    sched = Scheduler(cfg, params, serve_cfg, device=device)
    rids = [sched.submit(p, decode_tokens) for p in prompts]
    t0 = time.perf_counter()
    finished = sched.run()
    wall = time.perf_counter() - t0
    total = decode_tokens * len(prompts)
    return {"outputs": {i: finished[r] for i, r in enumerate(rids)},
            "wall_s": wall, "tokens_per_s": total / max(wall, 1e-9),
            "decode_steps": sched.decode_steps,
            "prefill_chunks": sched.prefill_chunks,
            "peak_pages_in_use": sched.peak_pages_in_use,
            "final_pages_in_use": sched.pool.in_use,
            "page_bytes": paging.cache_page_bytes(sched.cache),
            "pages_alloc_events": sched.pages_alloc_events,
            "scheduler": sched}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=base.list_architectures())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the CUDA card otherwise")
    ap.add_argument("--engine", choices=("paged", "lockstep"),
                    default="paged")
    ap.add_argument("--batch", type=int, default=4,
                    help="lockstep wave width / paged max_seqs")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-lens", type=str, default=None,
                    help="comma-separated per-request prompt lengths "
                         "(mixed-length stream); overrides --prompt-len")
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests (default: one batch)")
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--sample", choices=("greedy", "temp"), default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--kv-bits", type=int, choices=(32, 8, 4), default=None,
                    help="KV-page width: 32 = full precision, 8/4 = code "
                         "pools (default: REPRO_SERVE_KV_BITS or 32)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="prepend the same n synthetic tokens to every "
                         "prompt")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical pool size (default: 2x the worst case)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="repeat the prompt list this many times")
    ap.add_argument("--share-prefix", action="store_true",
                    help=f"prefix page sharing {NOT_PORTED}")
    ap.add_argument("--preempt", action="store_true",
                    help=f"watermark admission and preemption {NOT_PORTED}")
    ap.add_argument("--preempt-mode", choices=("recompute", "swap"),
                    default="recompute")
    ap.add_argument("--swa-recycle", action="store_true",
                    help=f"sliding-window page recycling {NOT_PORTED}")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help=f"Chrome-trace output {NOT_PORTED}")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, *, params=None) -> dict:
    args = build_parser().parse_args(argv)
    for flag, given in (("--share-prefix", args.share_prefix),
                        ("--preempt", args.preempt),
                        ("--preempt-mode swap", args.preempt_mode == "swap"),
                        ("--swa-recycle", args.swa_recycle),
                        ("--trace", args.trace)):
        if given:
            raise SystemExit(f"[serve] {flag} {NOT_PORTED}")
    dev = resolve_device(args.device)
    cfg = (base.get_smoke_config(args.arch) if args.smoke
           else base.get_config(args.arch))
    if args.prompt_lens:
        prompt_lens = [int(x) for x in args.prompt_lens.split(",")]
    else:
        prompt_lens = [args.prompt_len] * (args.requests or args.batch)
    print(f"[serve] arch={cfg.name} engine={args.engine} "
          f"requests={len(prompt_lens)} prompt_lens={prompt_lens} "
          f"decode={args.decode_tokens} sample={args.sample} device={dev}",
          flush=True)
    if params is None:
        params = registry.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed),
            device=dev)
    prompts = make_prompts(cfg, prompt_lens, args.seed,
                           prefix_len=args.prefix_len)
    prompts = prompts * max(1, args.repeat)
    prompt_lens = [len(p) for p in prompts]
    with torch.no_grad():
        if args.engine == "lockstep":
            out = run_lockstep(cfg, params, prompts, args.decode_tokens,
                               sample=args.sample,
                               temperature=args.temperature,
                               batch=args.batch, seed=args.seed, device=dev)
        else:
            max_ctx = max(prompt_lens) + args.decode_tokens
            pages_per_seq = paging.pages_needed(max_ctx, args.page_size)
            scfg = ServeConfig(
                max_seqs=args.batch, page_size=args.page_size,
                num_pages=args.num_pages or args.batch * pages_per_seq * 2,
                pages_per_seq=pages_per_seq,
                prefill_chunk=args.prefill_chunk, sample=args.sample,
                temperature=args.temperature, seed=args.seed,
                **({} if args.kv_bits is None
                   else {"kv_bits": args.kv_bits}))
            out = run_paged(cfg, params, prompts, args.decode_tokens,
                            serve_cfg=scfg, device=dev)
    print(f"[serve] {len(prompt_lens)}x{args.decode_tokens} tokens in "
          f"{out['wall_s']:.2f}s ({out['tokens_per_s']:.1f} tok/s "
          f"aggregate, {out['decode_steps']} decode steps)")
    if args.engine == "paged":
        print(f"[serve] pages: alloc_events={out['pages_alloc_events']} "
              f"peak_in_use={out['peak_pages_in_use']} "
              f"final_in_use={out['final_pages_in_use']}")
    print(f"[serve] sample continuation (req 0): "
          f"{out['outputs'][0].tolist()}")
    return out


if __name__ == "__main__":
    main()
