#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each run with nothing caught (any failure exits non-zero), each
with its time printed:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together) and time the build;
2. print the card's name and power limit as nvidia-smi reports them;
3. hold ``stoch_quantize`` and ``bipartite_mix`` against their plain
   PyTorch versions on the card, at the convex path's shapes and ragged
   ones, and time kernel, plain version and (for the mix) ``torch.matmul``
   with CUDA events and the profiler: the mix and ``torch.matmul`` at the
   convex (64, 2000), the LM trainer's (4, 134,277,912) and a 1,024-worker
   (1024, 2000) shape (checked there too), ``stoch_quantize`` at (64,
   2000) and the paper's (24, 50) beside an empty kernel on its grid, and
   what a ctypes launch pays on the host (an empty call, ``torch.empty``,
   the stream handle); B2 at the convex shape also through
   ``campaign.measure.time_per_call`` (printed, not a gate);
4. paper size: quickstart part 1 (24 workers, synth-linear d=50, p=0.35,
   300 iterations) for ggadmm and cq-ggadmm on the card: distance to the
   optimum below 1e-8, 7200 rounds, and ggadmm's trajectory equal to the
   same run on the CPU within 1e-4 max|theta*|;
5. full size: cq-ggadmm on synth-linear at the width of the LIBSVM epsilon
   set (d=2000) over 64 workers of a p=0.35 random bipartite graph, 2048
   samples per worker (cut from epsilon's 400,000 rows to keep host-side
   generation near 5 GB), 20 iterations: the distance to the optimum falls
   and every kernel launch is counted (2 quantizes and 3 mixes per
   iteration); then the same run with bf16 replicas (``hat_dtype``): the
   distance falls, 2 B1 launches (float32 operands) and 3 B2 launches on
   bf16 values per iteration;
6. ``run_dynamic`` at full size (the same problem, a new p=0.35 graph
   every 5 iterations, 20 iterations of cq-ggadmm) on the sparse backend,
   then with the same draws on the dense one: exactly 3 ``edge_gather_mix``
   launches per iteration, tx_mask equal, theta within 1e-4 max|theta*|;
7. the fleet on the convex path (sparse backend): the full size under
   faults (participation 0.8, staleness 2, 20 rounds), dark workers
   charged 0 bits, 3 B6 launches per round; a fault-free fleet at the
   paper size bit for bit equal to ``run_synchronous``, run untraced and
   traced (the same launches, a valid trace with a round span a round);
8. the three grouped quantize kernels (``stoch_quantize_grouped_fused``,
   its D-tiled twin, ``stoch_quantize_grouped``) against their plain
   versions at (64, 2000) G=1, the xlstm-smoke tree (4, 1,905,668) G=19,
   a ragged (5, 4099) layout with degenerate groups and the full-width
   xlstm-125m buffer (4, 134,277,912) G=19: the (N, G) outputs bit for bit,
   ``out`` bit for bit or one step Δ apart only at a rounding boundary;
   kernel and plain times at the full-width shape;
9. ``edge_gather_mix`` (B6) against its plain version, bit for bit, at
   (6, 7), (24, 50), (64, 2000), ``star_graph(257)`` and a 1,024-worker
   p=0.05 graph at d=2000, and the LM trainer's (4, 134,277,912) buffer
   (S=2), and with a poisoned table; the plan's regime and geometry,
   device time, time per call, plain time, bytes bounds, ``torch.matmul``
   and ``torch.sparse.mm`` (CSR) over the adjacency and B2 on the dense
   adjacency, per call, at each; then the narrowed storage of slice 10 in
   bf16 and f16, each against its float32 route bit for bit: B2 at the
   convex (64, 2000), the LM buffer, (1024, 2000) and a ragged misaligned
   V; B6 at the six shapes and the poisoned table (and its plan's geometry
   as float32's); B3 with a narrowed q_hat at the full-width buffer and
   the ragged layout with degenerate groups; at the LM shape each timed
   beside the float32 kernel and the cast route it replaces (B2 also
   beside ``torch.matmul`` in bf16), with its bytes bound;
10. full-width consensus training of xlstm-125m through
   ``repro_torch.launch.train.main`` with the example's flags (4 workers,
   batch 16, seq 128, 2 local steps, ``--groups leaf``, 3 steps): a finite
   loss, below the seeded initial model's after the last step, exactly 2
   fused quantize and 3 mix launches per step;
   s/step, peak device memory, and the top device activities of one more
   step from torch.profiler; then the same 3 steps with bf16 replicas
   (``train.main(..., hat_dtype="bfloat16")``) and ``--trace``: a finite
   loss, exactly 2 B3 and 3 B2 launches per step on bf16 q_hat and
   theta_hat, bf16 replica leaves, a valid trace with 3 round spans, the
   ledger's transmissions and bits equal to ``build_comm_log``; loss,
   s/step and peak memory beside the float32 run's;
11. the same training with ``--mix-backend sparse
   --fleet --fleet-participation 0.75 --fleet-staleness 2 --fleet-churn
   2:1:1`` for 3 rounds: a finite loss every round, the churn applied at
   round 2, dark workers charged 0 bits, exactly 3 B6 and 2 fused
   quantize launches per round; s/round and peak device memory;
12. the tiled path: the smoke config for 2 steps with
   ``REPRO_QUANT_TILE_D=512``, ``--groups block:embed,mlp,norm`` and
   ``--censor-mode group``: 2 tiled quantize launches per step;
13. one packed quantize step at the smoke width through the two-pass path
   (``stoch_quantize_grouped``) and the fused one: value-identical;
14. the paged-attention decode kernel under its two contracts (B7
   one-shot, B8 online softmax) against their plain versions, and B8
   against B7, to 1e-5 of max|V|, at the smoke model's heads and at
   tinyllama's (H 32, KV 4, hd 64, ps 16, B 8, tables of 64, 84 and 256
   pages, ctx 0 to 4096, poisoned table slots, every sequence on or around
   a split boundary), with bf16, float32, 8-bit and 4-bit pools; B7 at
   ctx 0 against the uniform average of V; every call repeated, equal bit
   for bit; kernel, plain and SDPA times at the shapes the serving path
   gives them (B7 also at the 84-page table, float32 pools); B8 at
   64, 128, 256 and 512 slots per split, B7 at 64, 128 and 256;
15. serving tinyllama-1.1b at full width (random float32 weights from
   seed 0, bf16 activations) through the paged scheduler: 16 greedy
   requests (prompt lengths 17..700, 128 new tokens, max_seqs 8, pages of
   16, 64-page tables, 64-token prefill chunks), exactly 22 one-shot
   launches per decode tick, the first 8 requests (each length once) held
   against the lockstep engine's contiguous decode (each parting only at a
   near-tie), those 8 again with float32 activations and pools; kv_bits 8
   and 4 streams; one request at ~4000
   tokens, where the shared-memory threshold picks the online kernel; 0
   pages in use after each; decode ms per tick, tokens/s, peak memory and
   the top device activities of one profiled tick;
16. the sLSTM cell kernel (B9, ``slstm_cell``) against its plain version
   at xlstm-125m's heads (H 4, dh 192, clusters of 4): the lockstep
   prefill (8, 700) and the paged bulk chunk (1, 64), bf16 and float32 wx,
   an odd (3, 129), from m0 = -1e30, 0 and a carried state, and at dh 64
   (a cluster of 1) and 256 (of 8); hs and every final state within 1e-4
   of max|hs|, a second call equal bit for bit; device time, time per
   call, plain time and bound; the (8, 700) prefill at 1, 2, 4 and 8 batch
   rows per cluster;
17. serving xlstm-125m at full width (random float32 weights from seed 0):
   a (8, 700) prefill forward through ``registry.apply_model`` with B9
   (exactly 6 launches) against the port's time loop, logits and every
   layer's final state (bf16 and float32 activations); the 16-request
   stream of phase 15 through the paged scheduler in bf16 and float32
   activations, exactly 6 B9 launches per bulk prefill chunk, 0 pages in
   use after, four requests (prompts 17, 255, 700, 384) held to the same
   request served alone (equal, or parting at a near-tie), the lockstep
   engine on equal-length waves beside it (printed, not a gate: a paged
   admission zeroes the stabilizer m, as in the JAX package), and the
   float32 stream once more with m set to -1e30 at each admission held
   to the lockstep engine (every request equal, or parting at a
   near-tie); one decode tick and one prefill chunk profiled;
18. the FSDP-Adam baseline: ``repro_torch.launch.train.main`` with
   ``--arch tinyllama-1.1b --mode fsdp --batch 8 --seq 512 --lr 1e-3
   --steps 5`` at full width: a finite loss every step, the last below
   step 0's, no kernel of the port launched; s/step, peak device memory,
   one more step profiled;
19. production-load serving of tinyllama-1.1b at full width (random
   float32 weights from seed 0, bf16 activations, float32 pools), with
   the card case ``test_paged_attention_on_aliased_and_forked_pages_on_card``
   (B7 and B8 on 84-page block tables whose rows share pages and on a
   forked page) in a child pytest beside it: phase 15's eight lengths behind one 512-token
   system prompt, the list served twice verbatim (16 requests, 128 new
   tokens, ``max_seqs`` 8, 84-page tables): (a) the reservation FIFO, (b)
   with prefix sharing, (c) watermark admission with recompute
   preemption on a 336-page pool (priorities 0/1 alternating), (d) the
   same with swap, (e) sharing, recompute and a defrag every 32 ticks;
   (a) and (b) again in float32; eight requests of (b) through the
   ``AsyncServer``. Run (b) runs traced: its counters as recorded
   untraced (303 shared hits, peak 455 pages, 108 prefill chunks, 382
   decode ticks, 8,404 B7 launches), 16 request spans, each closed, and a
   page_pool counter each tick. Gates: 0 pages in use after every run, an empty swap
   directory after (d), 22 B7 launches per decode tick, sharing hits and
   a lower page peak in (b), preemptions in (c)-(e), every run equal to
   (a) or parting only at a near-tie (the float32 pair at a top-2 gap <=
   1e-3), the AsyncServer equal to ``Scheduler.run`` bit for bit; each
   run's decode tick, tokens/s, TTFT with its queueing part, ITL and
   paging counters printed;
20. the paper's Figs. 2-6 through ``python -m repro_torch.bench.figures``
   at the paper's settings with the port's own draws on the card, one
   process a figure, each a one-run ``paper-figures`` campaign through the
   campaign runner (spec, runner and store on the card; the full
   campaign's run key), started with phase 19 and run beside it (with the
   aliased-table card cases of phases 19 and 21): every claim holds (the JAX
   campaign's gate), each figure's rows printed beside the JAX package's
   rows (CPU), B1 and B2 launched; Theorem 3's
   certificate (``core/theory.py``) against the measured contraction of
   ggadmm on ``tests/test_theory.py``'s setup (12 workers, d = 12, rho =
   1e-3, 120 iterations): measured <= rate + 1e-6;
21. B7/B8 at the head dims of the sliding-window family and the other
   configs, against their plain versions (both contracts, bf16, float32,
   8- and 4-bit pools, ctx 0, on and around split edges): (4, 32, 8, 80)
   h2o-danube, (4, 32, 32, 112) zamba2, (4, 96, 8, 128) mistral-large (G =
   12 over three blocks), (8, 8, 4, 256) gemma3, on 84-page tables; the
   aliased and forked tables at those heads in a child pytest; each timed
   at the production-load shape (84 pages) with its bytes bound and SDPA
   over the gathered K/V;
22. serving gemma3-4b at full width (34 layers, d_model 2560, 8 heads, kv
   4, head dim 256, vocab 262,144; random float32 weights, bf16
   activations): 8 greedy requests (prompts 17 to 2,500 against a 1,024
   window, 64 new tokens, ``max_seqs`` 8, pages of 16, 64-token chunks,
   161-page tables): exactly 5 B7/B8 launches per decode tick (its global
   layers), held against the lockstep engine (equal, or parting at a
   near-tie), 0 pages in use; peak memory, ms per tick, prefill tokens/s;
23. serving h2o-danube-1.8b at full width (24 layers, d_model 2560, 32
   heads, kv 8, head dim 80, window 4,096) with ``swa_recycle``: 4 greedy
   requests (prompts 64, 700, 2,000 and 4,600, 128 new tokens) under
   watermark admission: pages recycled, 0 in use at the end, tokens equal
   bit for bit to the same stream without recycling, a lower page peak;
   no B7/B8 launch (windowed decode gathers its pages);
24. consensus training of an attention model: ``train.main`` on
   tinyllama-smoke (2 workers, batch 2, seq 16, 2 steps): a finite loss,
   2 B3 and 3 B2 launches per step;
25. serving olmoe-1b-7b at full width (16 layers, d_model 2048, 16 heads,
   kv 16, head dim 128, 64 experts top-8 of d_ff 1024, vocab 50,304;
   6,816,073,728 random float32 parameters, bf16 activations and pages): 8
   greedy requests (prompts 17 to 2,000, 64 new tokens, ``max_seqs`` 8,
   pages of 16, 64-token chunks): exactly 16 B7 launches per decode tick, 0
   pages in use; the first 4 requests' lockstep agreement at
   ``capacity_factor`` 1.25 printed, not a gate (expert capacity depends
   on a step's token count: ROADMAP C18); one decode tick profiled; the
   first 4 requests rerun with ``capacity_factor`` = E/k (C = T: nothing
   dropped) in float32, held against the lockstep engine (equal, or parting
   at a 1e-3 near-tie); B7 at olmoe's geometry (B 4, H 16, KV 16, hd 128)
   is in phase 14's and 21's checks;
26. serving zamba2-7b at full width (81 layers: 13 x (5 Mamba2 + the shared
   attention block) + 3 Mamba2, d_model 3584, 32 heads, head dim 112, SSM
   state 64, 112 SSM heads; 5,622,231,872 random float32 parameters): the
   same stream shape, exactly 13 B7 launches per decode tick, 0 pages in
   use; the first 4 requests' lockstep agreement printed (the two engines
   split the SSD scan at other points, and 81 bf16 layers carry that past a
   bf16 step of the top logit); one decode tick profiled; the first 4 requests
   in float32 held against the lockstep engine (equal, or parting at a 1e-3
   near-tie);
27. consensus training of olmoe-smoke and zamba2-smoke through
   ``train.main`` (2 workers, batch 2, seq 16, 2 steps): finite losses, 2
   B3 and 3 B2 launches per step, the trained workers' loss equal to ce +
   0.01 x aux (aux > 0 with experts, 0 without);
28. serving qwen2-vl-7b at full width (28 layers, d_model 3584, 28 heads,
   kv 4, head dim 128, M-RoPE sections (16, 24, 24), vocab 152,064;
   7,070,490,112 random float32 parameters, bf16 activations and pages),
   text only (three-plane positions, no vision embeds, as in the JAX
   package): phase 25's stream (8 greedy requests of 17 to 2,000 prompt
   tokens, 64 new, 129-page tables): exactly 28 B7 launches per decode
   tick, 0 pages in use; the first 4 requests' bf16 lockstep agreement
   printed; one decode tick profiled; those 4 in float32 held against the
   lockstep engine (equal, or parting at a 1e-3 near-tie); B7/B8 at its
   geometry (H 28, KV 4, hd 128: G 7) are in phase 14's and 21's checks;
29. serving whisper-small at full width (12 encoder and 12 decoder
   layers, d_model 768, 12 heads, vocab 51,865, 1,500 stub frames;
   294,683,904 random float32 parameters) through the lockstep engine
   (its caches are not paged, as in the JAX package): 8 requests of 8 to
   384 prompt tokens, 64 new, waves of 4 (within the decoder's 448
   positions), each wave encoding its frames and filling the cross K/V
   first; no kernel launch; in bf16 (printed) and float32, where every
   generated token is the argmax of the uncached forward given the same
   history, or within a 1e-3 near-tie of it;
30. consensus training of qwen2-vl-smoke (stub vision embeds, three-plane
   positions) and whisper-smoke (stub frames; each worker's encoder on its
   own weights) through ``train.main`` (2 workers, batch 2, seq 32, 2
   steps): finite losses, 2 B3 and 3 B2 launches per step, the trained
   workers' loss equal to ce (aux 0);
31. the campaigns through ``train.main(["--campaign", ...])`` on the card,
   at the JAX package's configs: ``fleet-sweep`` (8 workers, 80 rounds, d
   20; 12 fleet arms and 2 synchronous runs) and ``lm-sweep``
   (tinyllama-smoke: the quantized/unquantized baseline pair of 12 steps,
   then the 8-point grid of 6), each with every run done and every claim
   true (printed with its value) and exactly the CPU rehearsal's launches
   (``CAMPAIGN_LAUNCHES``); then ``lm-sweep`` in a child process killed by
   SIGKILL once its first run is done and its second has a mid-run
   checkpoint, and run again with ``--resume``: the first run skipped, the
   second resumed from its checkpoint, every run's loss history and total
   bits equal to the uninterrupted campaign's bit for bit;
32. the sharded topology (``mix_backend="sharded"``), run right after
   phase 10: B2 on the row blocks of 2 and 4 ranks ((32, 64) x (64, 2000),
   (16, 64) x (64, 2000), (2, 4) x (4, 2^22), (1, 4) x (4, 2^22)) against
   its plain version (``check_mix_parity``'s gate; bf16 equal to the float32
   kernel rounded once), each timed per call; then a real NCCL process
   group of one (``train.init_sharded_group``): the convex full size of
   phase 5 (64 workers, d 2000, 20 iterations), tx_mask, bits and theta
   equal to phase 5's bit for bit, 3 B2 launches and 4 all-gathers an
   iteration; xlstm-125m at full width through ``train.main(LM_FLAGS +
   ["--mix-backend", "sharded"])``, 3 steps, loss history, bits and
   transmissions equal to phase 10's bit for bit, 9 B2 launches; s/step
   and peak memory beside phase 10's. With two or more cards the same LM
   run under ``torch.distributed.run --nproc-per-node 2`` (this script's
   ``--sharded-rank`` mode), one rank a card, bits and transmissions
   equal to the world-1 run's and the loss within 1e-6; with one card a
   line says it was not run;
33. the speed campaigns ``engine-smoke`` (``bench/engine.py``: the engine
   against the seed stepper, payload, pytree fusion, fused range, group
   specs, the three topology backends, the mix sweep) and ``serve-smoke``
   (``bench/serving.py``: continuous against lockstep batching, paged
   against lockstep greedy, int8/int4 pages of 8 tokens, shared prefixes
   under load) through ``train.main(["--campaign", ...])`` at the JAX
   package's configs, after every child has ended: every run done, every
   correctness claim true, every speed claim printed with its value, and
   exactly the CPU rehearsal's launches (``CAMPAIGN_LAUNCHES``); B7 at their
   8-token pages is in phase 14's checks;
34. the ``kernels`` and ``roofline`` stages of campaign ``all`` on the
   quiet card: B1 and B2 against their plain versions at (8, 512), (16,
   4096) and (24, 16384) (the rehearsal's launches), and every kernel at
   its full-width shapes against its bound (``bench/roofline.py``, whose
   bytes and operations every bound of this script uses): each row launched
   and at most 1.05 of its bound, printed with the card's name and power
   limit.

Phases 25-27 run in a child process (``--child-phases family``, output
in ``build/chip_smoke_family.log``, printed when it ends) and phase 31 in
another (``--child-phases campaign``) beside phases 15, 17 and 18 (phase
16 runs before 15), and phases 22-23 and 28-30 in a third (``--child-phases
sliding``) beside phase 19, to keep the script inside its time limit: all
of them are host-paced, and the phases that time kernels (3, 8, 9, 14, 16,
21) run while no child does.

Before the last line it prints one JSON line with each kernel's launches
(counted over the path it serves, with the counts set to 0 just before
that path ran), parity error, times and bound, then nvidia-smi's
name/power-limit line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""
import atexit
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FULL_N, FULL_D, FULL_S, FULL_ITERS = 64, 2000, 2048, 20
PAPER_ITERS = 300
LM_STEPS, TILED_STEPS = 3, 2
# the example's settings (examples/consensus_lm_training.py), full width
LM_FLAGS = ["--arch", "xlstm-125m", "--mode", "admm", "--workers", "4",
            "--batch", "16", "--seq", "128", "--local-steps", "2",
            "--lr", "2e-3", "--tau0", "5.0", "--xi", "0.999", "--bits", "6",
            "--omega", "0.9995", "--groups", "leaf", "--log-every", "1"]
GROUPED_KW = dict(omega=0.9995, b0=6, b_max=16)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Time of one call on the card: CUDA events around a run of ``reps``
    back-to-back calls, over the count; the median of ``rounds`` runs. For
    a kernel shorter than its launch this is the launch rate the host
    sustains, which is what the main path pays per call."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_times(fn, calls: int = 1):
    """Run ``fn`` ``calls`` times under torch.profiler (CUPTI, device
    activity only). Returns the wall time in ms and, per device activity
    name, (count, total ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a profile that caught nothing is repeated
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, t = acts.get(e.name, (0, 0.0))
                acts[e.name] = (n + 1, t + e.device_time_total / 1e3)
        if acts:
            break
    return wall_ms, acts


def roofline():
    """``repro_torch.bench.roofline``: the card's peaks and every kernel's
    bytes and operations, reckoned in one place (the roofline stage of
    campaign ``all`` reads the same functions)."""
    from repro_torch.bench import roofline as rl
    return rl


def bound(n_bytes: float, n_ops: float):
    """Least time in ms of the given bytes and float32 operations on one
    H100 at 700 W (3.35 TB/s, 67 TF/s), and which of the two sets it."""
    return roofline().bound(n_bytes, n_ops)


def check_quant_parity(ops, ref, dev):
    """Kernel vs plain version: bitwise, or one step Δ apart only where the
    rounding decision sits within one float32 ulp of its boundary."""
    max_err = 0.0
    for n, d in ((64, 2000), (24, 50), (7, 1), (5, 4099)):
        rng = np.random.default_rng(n * 10007 + d)
        theta = (3.0 * rng.standard_normal((n, d))).astype(np.float32)
        qprev = (3.0 * rng.standard_normal((n, d))).astype(np.float32)
        unif = rng.uniform(size=(n, d)).astype(np.float32)
        theta[0] = qprev[0]                       # a degenerate row, R = 0
        qrange = np.max(np.abs(theta - qprev), axis=1).astype(np.float32)
        bits = rng.integers(2, 17, size=n).astype(np.float32)
        delta = (np.float32(2.0) * qrange
                 / (np.exp2(bits) - np.float32(1.0))).astype(np.float32)
        args = [torch.from_numpy(a).to(dev)
                for a in (theta, qprev, unif, delta, qrange)]
        got = ops.stoch_quantize(*args)
        torch.cuda.synchronize()
        want = ref.stoch_quantize_ref(*args)
        torch.cuda.synchronize()
        diff = (got - want).abs().cpu().numpy().astype(np.float64)
        sd = np.maximum(delta, np.float32(1e-12))[:, None]
        c = (theta - qprev + qrange[:, None]) / sd
        frac = c - np.floor(c)
        bad = diff > 0
        step = np.broadcast_to(sd, diff.shape)[bad]
        ok = ((np.abs(diff[bad] - step) <= 1e-5 * step)
              & (np.abs(frac[bad] - unif[bad]) <= np.spacing(unif[bad])))
        if not ok.all():
            raise AssertionError(f"stoch_quantize ({n}, {d}): {bad.sum()} "
                                 f"coordinates differ from the plain version")
        assert (got[0] == args[1][0]).all(), "degenerate row not passed"
        max_err = max(max_err, float(diff.max()))
        log(f"parity stoch_quantize ({n}, {d}): {int(bad.sum())} boundary "
            f"flips, max |err| {diff.max():.3e}")
    return max_err


def check_mix_parity(ops, ref, dev):
    """Kernel vs plain version: each entry within 1e-6 of the sum of the
    magnitudes of its terms (the two sum in different orders)."""
    max_err = 0.0
    for m, n, d in ((64, 64, 2000), (24, 24, 50), (12, 24, 513)):
        rng = np.random.default_rng(m * 131 + n * 7 + d)
        adj = torch.from_numpy(
            (rng.uniform(size=(m, n)) < 0.35).astype(np.float32)).to(dev)
        vals = torch.from_numpy(
            rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        got = ops.bipartite_mix(adj, vals)
        torch.cuda.synchronize()
        want = ref.bipartite_mix_ref(adj, vals)
        torch.cuda.synchronize()
        scale = (adj.double().abs() @ vals.double().abs())
        err = (got.double() - want.double()).abs()
        if not bool((err <= 1e-6 * scale).all()):
            raise AssertionError(f"bipartite_mix ({m}, {n}) x ({n}, {d}): "
                                 f"max |err| {float(err.max()):.3e}")
        max_err = max(max_err, float(err.max()))
        log(f"parity bipartite_mix ({m}, {n}) x ({n}, {d}): max |err| "
            f"{float(err.max()):.3e}")
    return max_err


def device_ms(fn, calls: int = 20):
    """Device time of one call of ``fn``: every device activity of
    ``calls`` calls under torch.profiler, summed, over the count. The
    profiler at times records fewer launches than were made; where a name
    was seen fewer than ``calls`` times, its mean per launch counts once
    per call instead. None if it saw nothing."""
    _, acts = device_times(fn, calls)
    if not acts:
        return None
    if all(n >= calls for n, _ in acts.values()):
        return sum(ms for _, ms in acts.values()) / calls
    return sum(ms / n for n, ms in acts.values())


# B2 timing shapes (M, N, d): the convex main path, the LM trainer's
# packed buffer and a 1,024-worker dense mix
MIX_TIMES = {
    "convex (64, 64) x (64, 2000)": (64, 64, 2000),
    "LM (4, 4) x (4, 134277912)": (4, 4, 134277912),
    "(1024, 1024) x (1024, 2000)": (1024, 1024, 2000),
}


def mix_bound(m, n, d):
    return bound(*roofline().mix_work(m, n, d))


def launch_floor(dev):
    """What a ctypes launch pays on this host before any kernel runs: an
    empty call into B2's library (m = 0 returns at once), the allocation of
    a (64, 2000) output three ways and the current stream's handle two
    ways, timed as :func:`time_ms` times a call."""
    from repro_torch.kernels import bipartite_mix as bm

    fn = bm._lib().bipartite_mix
    stream = torch.cuda.current_stream(dev).cuda_stream
    like = torch.empty((64, 2000), device=dev)
    floor = {"empty ctypes call": time_ms(
                 lambda: fn(None, None, None, 0, 0, 0, 0, stream), 1000),
             "torch.empty((64, 2000))": time_ms(
                 lambda: torch.empty((64, 2000), device=dev), 1000),
             "torch.empty_like(V (64, 2000))": time_ms(
                 lambda: torch.empty_like(like), 1000),
             "V.new_empty((64, 2000))": time_ms(
                 lambda: like.new_empty((64, 2000)), 1000),
             "torch.cuda.current_stream().cuda_stream": time_ms(
                 lambda: torch.cuda.current_stream(dev).cuda_stream, 1000),
             "torch._C._cuda_getCurrentRawStream": time_ms(
                 lambda: torch._C._cuda_getCurrentRawStream(like.get_device()),
                 1000)}
    log("launch floor per call: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in floor.items()))
    return floor


def time_mix(ops, ref, dev):
    """B2 against ``torch.matmul`` (its plain version, the library call)
    at each ``MIX_TIMES`` shape: device time (profiler, all activities of
    one call) and time per call (CUDA events), with B2's parity there; at
    the convex shape also through ``campaign.measure.time_per_call`` (host
    clock, one synchronization after the calls; printed, not a gate).
    Returns the convex shape's numbers, the ones the main path pays."""
    from repro_torch.campaign import measure

    gen = torch.Generator(device=dev).manual_seed(0)
    out = None
    for label, (m, n, d) in MIX_TIMES.items():
        adj = (torch.rand((m, n), generator=gen, device=dev) < 0.35).float()
        vals = torch.randn((n, d), generator=gen, device=dev)
        big = n * d > 1e8
        reps = 10 if big else 100
        got = ops.bipartite_mix(adj, vals)
        want = ref.bipartite_mix_ref(adj, vals)
        scale = adj.abs() @ vals.abs()
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= 1e-6 * scale).all()):
            raise AssertionError(f"bipartite_mix {label}: max |err| {err:.3e}")
        del got, want, scale
        t = {"ms": time_ms(lambda: ops.bipartite_mix(adj, vals), reps),
             "plain_ms": time_ms(lambda: ref.bipartite_mix_ref(adj, vals),
                                 reps),
             "library_ms": time_ms(lambda: torch.matmul(adj, vals), reps),
             "device_ms": device_ms(lambda: ops.bipartite_mix(adj, vals)),
             "library_device_ms": device_ms(lambda: torch.matmul(adj, vals)),
             "bound": mix_bound(m, n, d), "max_abs_err": err}
        log(f"time bipartite_mix {label}: device {t['device_ms']} ms, per "
            f"call {t['ms']:.5f} ms; torch.matmul device "
            f"{t['library_device_ms']} ms, per call {t['library_ms']:.5f} "
            f"ms; plain {t['plain_ms']:.5f} ms; bound {t['bound'][0]:.5f} "
            f"ms ({t['bound'][1]}); max |err| {err:.3e}")
        if out is None:
            out = t
            us, _ = measure.time_per_call(ops.bipartite_mix, adj, vals,
                                          reps=reps)
            log(f"time bipartite_mix {label} through "
                f"campaign.measure.time_per_call: {us:.2f} us per call "
                f"(CUDA events above: {t['ms'] * 1e3:.2f} us)")
        del adj, vals
        torch.cuda.empty_cache()
    return out


def time_kernels(ops, ref, dev):
    """Kernel, plain and library times at the main path's shapes, with
    warm inputs (the main path finds them in L2): B1 at the full size
    (64, 2000) and the paper's (24, 50), beside an empty kernel on B1's
    grid through the same ctypes path (the floor no launch goes under)."""
    from repro_torch.kernels import stoch_quant as sq

    gen = torch.Generator(device=dev).manual_seed(0)
    out = None
    for n, d in ((FULL_N, FULL_D), (24, 50)):
        theta = torch.randn((n, d), generator=gen, device=dev)
        qprev = torch.randn((n, d), generator=gen, device=dev)
        unif = torch.rand((n, d), generator=gen, device=dev)
        qrange = (theta - qprev).abs().amax(dim=1)
        delta = 2.0 * qrange / 255.0
        q_args = (theta, qprev, unif, delta, qrange)
        t = {"ms": time_ms(lambda: ops.stoch_quantize(*q_args)),
             "plain_ms": time_ms(lambda: ref.stoch_quantize_ref(*q_args)),
             "library_ms": None,
             "device_ms": device_ms(lambda: ops.stoch_quantize(*q_args), 50),
             "empty_ms": time_ms(lambda: sq.empty_launch(n * d, dev)),
             "empty_device_ms": device_ms(
                 lambda: sq.empty_launch(n * d, dev), 50),
             "bound": bound(*roofline().quant_work(n, d))}
        log(f"time stoch_quantize ({n}, {d}), {sq.blocks(n * d)} blocks: "
            f"per call {t['ms']:.5f} ms (device only {t['device_ms']} ms), "
            f"plain {t['plain_ms']:.5f} ms, bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]}); empty kernel on its grid: per call "
            f"{t['empty_ms']:.5f} ms, device {t['empty_device_ms']} ms")
        out = out or t
    launch_floor(dev)
    return {"stoch_quantize": out, "bipartite_mix": time_mix(ops, ref, dev)}


def paper_size(ops, dev):
    from repro_torch import quickstart

    ops.reset_launches()
    res = quickstart.part1(dev, PAPER_ITERS)
    counts = dict(ops.launches)
    for scheme, r in res.items():
        lg = r["log"]
        log(f"paper {scheme:10s} dist-to-opt={r['dist']:.3e}  rounds="
            f"{lg.cumulative_rounds[-1]:.0f}  bits="
            f"{lg.cumulative_bits[-1]:.4e}  energy="
            f"{lg.cumulative_energy[-1]:.3e} J")
        assert r["dist"] < 1e-8, (scheme, r["dist"])
        assert lg.cumulative_rounds[-1] == 7200, scheme
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize=2 * PAPER_ITERS,
                bipartite_mix=2 * 3 * PAPER_ITERS)
    assert counts == want, counts
    log(f"paper launches {counts}")

    # the same ggadmm run on the CPU: the path on the card agrees with it
    cpu = quickstart.part1("cpu", PAPER_ITERS, schemes=("ggadmm",))
    th_gpu = res["ggadmm"]["metrics"]["theta"].cpu().numpy()
    th_cpu = cpu["ggadmm"]["metrics"]["theta"].numpy()
    err = float(np.abs(th_gpu - th_cpu).max())
    tol = 1e-4 * float(np.abs(th_cpu[-1]).max())
    log(f"paper ggadmm card vs CPU trajectory max |err| {err:.3e} "
        f"(tolerance {tol:.3e})")
    assert err <= tol


def full_size(ops, dev):
    from repro_torch import interop
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import engine as E
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.data import regression as R

    t0 = time.perf_counter()
    data = R.synth_linear(n=FULL_N * FULL_S, d=FULL_D, seed=0)
    x, y = R.partition_uniform(data, FULL_N)
    del data
    graph = random_bipartite_graph(FULL_N, 0.35, seed=0)
    log(f"full data: x {x.shape} generated in "
        f"{time.perf_counter() - t0:.1f} s; graph {graph.num_edges} edges")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = interop.problem_from_numpy(x, y, "linear", device=dev)
    del x, y
    theta_star = prob.optimum()
    cfg = ab.cq_ggadmm(rho=1.0)
    theta0 = torch.zeros((FULL_N, FULL_D), device=dev)
    torch.cuda.synchronize()
    log(f"full problem on the card (Gram stack, optimum) in "
        f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    t0 = time.perf_counter()
    state, out = E.run(graph, cfg, E.ExactSolver(prob), theta0, FULL_ITERS,
                       extra_metrics=E.flat_metrics(graph, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    dist = ((out["theta"] - theta_star[None, None]) ** 2).sum(dim=(1, 2))
    dist = dist.cpu().numpy()
    assert np.isfinite(dist).all() and np.isfinite(
        out["theta"].cpu().numpy()).all()
    assert tuple(state.theta.shape) == (FULL_N, FULL_D)
    assert dist[-1] < dist[0], dist
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize=2 * FULL_ITERS, bipartite_mix=3 * FULL_ITERS)
    assert launches == want, launches
    bits = float(out["payload_bits"].sum())
    log(f"full cq-ggadmm N={FULL_N} d={FULL_D} s={FULL_S}: "
        f"{wall / FULL_ITERS * 1e3:.2f} ms/iteration over {FULL_ITERS} "
        f"iterations, dist-to-opt {dist[0]:.4e} -> {dist[-1]:.4e}, "
        f"bits {bits:.4e}, peak device memory {peak_gb:.2f} GB")
    log(f"full launches {launches}")

    # one phase's parts, timed alone at the same shapes
    rho_d = cfg.rho * torch.as_tensor(graph.degrees, device=dev)
    v = torch.randn((FULL_N, FULL_D), device=dev)
    adj = torch.as_tensor(graph.adjacency, device=dev)
    u = torch.rand((FULL_N, FULL_D), device=dev)
    t0 = time.perf_counter()
    parts = {
        "solve": time_ms(lambda: prob.primal_solve(v, rho_d), 10, 2),
        "quantize": time_ms(lambda: E.grouped_quantize_step_unfused(
            state.quant, state.theta, u, cfg.quantize), 20, 3),
        "mix": time_ms(lambda: ops.bipartite_mix(adj, state.theta_hat.contiguous()),
                       50, 5),
    }
    log("full per-phase parts (ms, alone): "
        + ", ".join(f"{k} {t:.3f}" for k, t in parts.items())
        + f"; timed in {time.perf_counter() - t0:.1f} s")
    profile_steps(graph, cfg, E.ExactSolver(prob), state, dev)
    full = {"theta": state.theta, "tx_mask": out["tx_mask"],
            "payload_bits": out["payload_bits"],
            "ms_per_iteration": wall / FULL_ITERS * 1e3}
    return launches, prob, theta_star, full


def profile_steps(graph, cfg, solver, state, dev):
    """Device activity share and the top device activities over one
    full-size step, from torch.profiler."""
    from repro_torch.core import engine as E

    step = E.make_step(graph, cfg, solver, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step(holder["state"], lambda phase: torch.rand(
            state.theta.shape, generator=gen, device=dev))

    t0 = time.perf_counter()
    wall_ms, acts = device_times(one_step)
    busy_ms = sum(t for _, t in acts.values())
    log(f"profile 1 full-size step: wall {wall_ms:.2f} ms, device "
        f"activities {busy_ms:.2f} ms ({100.0 * busy_ms / wall_ms:.1f}% of "
        f"wall; not measured if 0); profiling took "
        f"{time.perf_counter() - t0:.1f} s")
    for key, (n, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:8]:
        log(f"profile   {t:10.3f} ms  x{n:<5d} {key[:80]}")


def grouped_layouts():
    """name -> (rows, per-leaf dims, leaf -> group ids, degenerate
    (row, group) pairs) of the grouped kernel checks."""
    from repro_torch.configs import base
    from repro_torch.core import tree as T
    from repro_torch.models import registry

    def dims(cfg):
        tree = registry.init_params(cfg, device="meta")
        return tuple(int(np.prod(x.shape)) for x in T.leaves(tree))

    return {
        "(64, 2000) G=1": (64, (2000,), (0,), ()),
        "xlstm-smoke (4, 1905668) G=19": (
            4, dims(base.get_smoke_config("xlstm-125m")), tuple(range(19)),
            ((2, 3),)),
        "ragged (5, 4099) G=3": (5, (1000, 3, 1, 2048, 1047),
                                 (0, 1, 0, 2, 1), ((0, 1), (3, 2))),
        "xlstm-125m (4, 134277912) G=19": (
            4, dims(base.get_config("xlstm-125m")), tuple(range(19)),
            ((1, 0),)),
    }


def grouped_inputs(dev, n, dims, gids, seed, degenerate):
    """Packed (N, D) theta, q_prev, uniforms and (N, G) quantizer state on
    the card, drawn from a seeded generator, and the packing. Integer bit
    widths 2..8, some first-round and zero-range groups; each (row, group)
    of ``degenerate`` has theta == q_prev on its columns."""
    from repro_torch.core import packing

    tree = {f"k{i:02d}": torch.empty((n, d), device="meta")
            for i, d in enumerate(dims)}
    pk = packing.make_packing(tree, gids)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape, g = (n, pk.dim), pk.n_groups
    theta = 3.0 * torch.randn(shape, generator=gen, device=dev)
    qprev = 3.0 * torch.randn(shape, generator=gen, device=dev)
    unif = torch.rand(shape, generator=gen, device=dev)
    for row, grp in degenerate:
        for off, size in pk.group_runs[grp]:
            theta[row, off:off + size] = qprev[row, off:off + size]
    bits = torch.randint(2, 9, (n, g), generator=gen, device=dev).float()
    rprev = 8.0 * torch.rand((n, g), generator=gen, device=dev)
    rprev[torch.rand((n, g), generator=gen, device=dev) < 0.2] = 0.0
    init = (torch.rand((n, g), generator=gen, device=dev) < 0.8).float()
    return (theta, qprev, unif, bits, rprev, init), pk


def column_groups(pk, cols):
    """Group id of each column in ``cols`` (a CUDA index tensor), from the
    packing's runs."""
    runs = sorted((off, g) for g, rs in enumerate(pk.group_runs)
                  for off, _ in rs)
    starts = torch.tensor([r[0] for r in runs], device=cols.device)
    gids = torch.tensor([r[1] for r in runs], device=cols.device)
    return gids[torch.searchsorted(starts, cols, right=True) - 1]


def check_out(name, got, want, theta, qprev, unif, delta, qrange, pk):
    """``out`` bit for bit, or exactly one step Δ apart where the rounding
    decision sits within one float32 ulp of its boundary (the rule of
    ``stoch_quantize``). Checked on the card; returns max |err|."""
    bad = got != want
    nbad = int(bad.sum())
    if nbad:
        rows, cols = bad.nonzero(as_tuple=True)
        g = column_groups(pk, cols)
        sd = torch.clamp_min(delta[rows, g], 1e-12)
        r = qrange[rows, g]
        c = (theta[rows, cols] - qprev[rows, cols] + r) / sd
        frac = c - torch.floor(c)
        u = unif[rows, cols]
        diff = (got[rows, cols].double() - want[rows, cols].double()).abs()
        ulp = torch.nextafter(u, torch.full_like(u, 2.0)) - u
        ok = ((diff - sd.double()).abs() <= 1e-5 * sd.double()) \
            & ((frac - u).abs() <= ulp)
        if not bool(ok.all()):
            raise AssertionError(f"{name}: {int((~ok).sum())} of {nbad} "
                                 f"differing coordinates are not one-step "
                                 f"flips at a rounding boundary")
    return nbad, float((got.double() - want.double()).abs().max())


def check_grouped_parity(ops, ref, dev):
    """B3/B4/B5 against their plain versions at the four layouts."""
    from repro_torch.core.quantization import bit_schedule

    errs = {k: 0.0 for k in ("stoch_quantize_grouped_fused",
                             "stoch_quantize_grouped_fused_tiled",
                             "stoch_quantize_grouped")}
    for seed, (label, (n, dims, gids, degen)) in enumerate(
            grouped_layouts().items()):
        args, pk = grouped_inputs(dev, n, dims, gids, seed, degen)
        theta, qprev, unif = args[:3]
        kw = dict(group_runs=pk.group_runs, **GROUPED_KW)
        gid = torch.from_numpy(pk.col_group_ids).to(dev)
        want = ref.stoch_quantize_grouped_fused_ref(*args, gid, **kw)
        torch.cuda.synchronize()
        runs = {"stoch_quantize_grouped_fused":
                ops.stoch_quantize_grouped_fused(*args, None, **kw),
                "stoch_quantize_grouped_fused_tiled":
                ops.stoch_quantize_grouped_fused_tiled(*args, None,
                                                       block_d=512, **kw)}
        torch.cuda.synchronize()
        for name, got in runs.items():
            for a, b, what in zip(got[1:], want[1:],
                                  ("range", "bits", "delta")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {label}: {what} (N, G) "
                                         f"differs from the plain version")
            nbad, err = check_out(name, got[0], want[0], theta, qprev, unif,
                                  want[3], want[1], pk)
            for row, grp in degen:
                for off, size in pk.group_runs[grp]:
                    assert torch.equal(got[0][row, off:off + size],
                                       qprev[row, off:off + size]), label
            errs[name] = max(errs[name], err)
            log(f"parity {name} {label}: (N, G) bitwise, {nbad} boundary "
                f"flips, max |err| {err:.3e}")
        del runs
        # B5 with the plain schedule's (N, G) side information
        rng_new = ref.grouped_range_ref(theta - qprev, pk.group_runs)
        _, delta, _ = bit_schedule(args[3], rng_new, args[4], args[5],
                                   **GROUPED_KW)
        got = ops.stoch_quantize_grouped(theta, qprev, unif, delta, rng_new,
                                         None, group_runs=pk.group_runs)
        want5 = ref.stoch_quantize_grouped_ref(theta, qprev, unif, delta,
                                               rng_new, gid)
        torch.cuda.synchronize()
        nbad, err = check_out("stoch_quantize_grouped", got, want5, theta,
                              qprev, unif, delta, rng_new, pk)
        errs["stoch_quantize_grouped"] = max(errs["stoch_quantize_grouped"],
                                             err)
        log(f"parity stoch_quantize_grouped {label}: {nbad} boundary flips, "
            f"max |err| {err:.3e}")
        del args, want, want5, got, gid, theta, qprev, unif
        torch.cuda.empty_cache()
    return errs


def time_grouped(ops, ref, dev):
    """Kernel and plain times of B3/B4/B5 at the full-width xlstm-125m
    buffer, per call (CUDA events) and device only (torch.profiler)."""
    from repro_torch.core.quantization import bit_schedule

    n, dims, gids, _ = grouped_layouts()["xlstm-125m (4, 134277912) G=19"]
    args, pk = grouped_inputs(dev, n, dims, gids, 99, ())
    theta, qprev, unif = args[:3]
    kw = dict(group_runs=pk.group_runs, **GROUPED_KW)
    gid = torch.from_numpy(pk.col_group_ids).to(dev)
    rng_new = ref.grouped_range_ref(theta - qprev, pk.group_runs)
    _, delta, _ = bit_schedule(args[3], rng_new, args[4], args[5],
                               **GROUPED_KW)
    n_el = theta.numel()
    b = bound(*roofline().grouped_work(n_el))
    fns = {
        "stoch_quantize_grouped_fused": (
            lambda: ops.stoch_quantize_grouped_fused(*args, None, **kw),
            lambda: ref.stoch_quantize_grouped_fused_ref(*args, gid, **kw),
            ("grouped_fused_kernel",)),
        "stoch_quantize_grouped_fused_tiled": (
            lambda: ops.stoch_quantize_grouped_fused_tiled(
                *args, None, block_d=512, **kw),
            lambda: ref.stoch_quantize_grouped_fused_ref(*args, gid, **kw),
            ("tiled_reduce_kernel", "tiled_quantize_kernel")),
        "stoch_quantize_grouped": (
            lambda: ops.stoch_quantize_grouped(
                theta, qprev, unif, delta, rng_new, None,
                group_runs=pk.group_runs),
            lambda: ref.stoch_quantize_grouped_ref(theta, qprev, unif, delta,
                                                   rng_new, gid),
            ("grouped_quant_kernel",)),
    }
    out = {}
    for name, (kern, plain, knames) in fns.items():
        t = {"ms": time_ms(kern, 20, 5), "plain_ms": time_ms(plain, 2, 3),
             "library_ms": None, "bound": b}
        _, acts = device_times(kern, 10)
        hits = [(c, ms) for k, (c, ms) in acts.items()
                if any(kn in k for kn in knames)]
        t["device_ms"] = (sum(ms for _, ms in hits) / 10 if hits else None)
        out[name] = t
        log(f"time {name} (4, 134277912) G=19: per call {t['ms']:.4f} ms "
            f"(device only {t['device_ms']} ms), plain "
            f"{t['plain_ms']:.4f} ms, library none, bound {b[0]:.4f} ms "
            f"({b[1]})")
    del args, theta, qprev, unif, gid, rng_new, delta, fns
    torch.cuda.empty_cache()
    return out


def lm_initial(dev):
    """The trainer's seeded initial model (the same generator seed on the
    same device): its mean loss over the four workers' step-0 batches, the
    embedding table, and the table rows no batch of the run touches."""
    from repro_torch.configs import base
    from repro_torch.core import tree as T
    from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = train.build_parser().parse_args(LM_FLAGS)
    cfg = base.get_config(args.arch)
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, args.seq,
                                         seed=args.seed))
    per = args.batch // args.workers
    raws = [data.worker_batch(i, args.workers, per) for i in range(LM_STEPS)]
    theta = T.tree_map(lambda x: x[None].expand((args.workers,) + x.shape),
                       params)
    with torch.no_grad():
        loss0 = float(registry.lm_loss(theta, cfg, model_batch(
            cfg, raws[0], dev))[0].mean())
    seen = np.zeros(cfg.vocab_size, bool)
    for raw in raws:
        seen[raw["tokens"]] = True
        seen[raw["labels"]] = True
    return loss0, params["embed"]["table"], torch.from_numpy(~seen).to(dev)


def lm_full_width(ops, dev):
    """Full-width xlstm-125m consensus training through the trainer's
    entry point, with its kernel launches counted."""
    from repro_torch.launch import train

    loss0, table0, unseen = lm_initial(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train.main(LM_FLAGS + ["--steps", str(LM_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    assert np.isfinite(hist).all(), hist
    # the loss falls from the seeded model's; past step 0 it rises at these
    # flags in the JAX reference too (tests/torch_vocab_probe.py)
    assert hist[-1] < loss0, (loss0, hist)
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize_grouped_fused=2 * LM_STEPS,
                bipartite_mix=3 * LM_STEPS)
    assert launches == want, launches
    assert out["n_groups"] == 19
    table = out["state"].theta["embed"]["table"]
    log(f"lm xlstm-125m 4 workers x 134277912 params: loss {loss0:.4f} "
        f"(seeded init) -> {' -> '.join(f'{x:.4f}' for x in hist)}, cum "
        f"bits {out['total_bits']:.4e}, s/step "
        f"{', '.join(f'{x:.3f}' for x in out['step_seconds'])} (wall "
        f"{wall:.1f} s with init), peak device memory {peak_gb:.2f} GB")
    log(f"lm embedding rows no batch touched: {int(unseen.sum())} of "
        f"{unseen.numel()}; their mean |entry| {float(table0[unseen].abs().mean()):.5f}"
        f" at init -> {float(table[:, unseen].abs().mean()):.5f} after "
        f"{LM_STEPS} steps; touched rows "
        f"{float(table0[~unseen].abs().mean()):.5f} -> "
        f"{float(table[:, ~unseen].abs().mean()):.5f}")
    log(f"lm launches {launches}")
    del table0, table
    profile_lm_step(out["state"], dev)
    return launches, {"history": hist, "peak_gb": peak_gb,
                      "step_seconds": out["step_seconds"],
                      "total_bits": out["total_bits"],
                      "tx_counts": out["tx_counts"]}


# B2 on the sharded backend's (N/w, N) adjacency row blocks: the convex full
# size and the LM trainer's buffer split over 2 and 4 ranks
ROW_BLOCKS = {
    "convex 2 ranks (32, 64) x (64, 2000)": (32, 64, 2000),
    "convex 4 ranks (16, 64) x (64, 2000)": (16, 64, 2000),
    "LM 2 ranks (2, 4) x (4, 4194304)": (2, 4, 1 << 22),
    "LM 4 ranks (1, 4) x (4, 4194304)": (1, 4, 1 << 22),
}


def check_row_blocks(ops, ref, dev):
    """B2 on row blocks against its plain version on the card: float32
    within ``check_mix_parity``'s gate (1e-6 of the sum of the terms'
    magnitudes), bf16 values equal to the float32 kernel rounded once, bit
    for bit (the narrowed gate); time per call of each (CUDA events), with
    ``torch.matmul``'s and the bytes bound beside."""
    gen = torch.Generator(device=dev).manual_seed(25)
    for label, (m, n, d) in ROW_BLOCKS.items():
        adj = (torch.rand((m, n), generator=gen, device=dev) < 0.5).float()
        vals = torch.randn((n, d), generator=gen, device=dev)
        got = ops.bipartite_mix(adj, vals)
        want = ref.bipartite_mix_ref(adj, vals)
        scale = adj.double().abs() @ vals.double().abs()
        err = (got.double() - want.double()).abs()
        if not bool((err <= 1e-6 * scale).all()):
            raise AssertionError(f"bipartite_mix row block {label}: max "
                                 f"|err| {float(err.max()):.3e}")
        narrow = vals.to(torch.bfloat16)
        got16 = ops.bipartite_mix(adj, narrow)
        assert got16.dtype == torch.bfloat16 and torch.equal(
            got16, ops.bipartite_mix(adj, narrow.float()).to(
                torch.bfloat16)), label
        reps = 100
        t32 = time_ms(lambda: ops.bipartite_mix(adj, vals), reps)
        t16 = time_ms(lambda: ops.bipartite_mix(adj, narrow), reps)
        tlib = time_ms(lambda: torch.matmul(adj, vals), reps)
        b32, b16 = mix_bound(m, n, d)[0], bound(
            4.0 * m * n + 2.0 * (n * d + m * d), 2.0 * m * n * d)[0]
        log(f"parity and time bipartite_mix row block {label}: max |err| "
            f"{float(err.max()):.3e}, bf16 equal to the float32 kernel "
            f"rounded once; per call float32 {t32 * 1e3:.2f} us (bound "
            f"{b32 * 1e3:.2f} us), bf16 {t16 * 1e3:.2f} us (bound "
            f"{b16 * 1e3:.2f} us), torch.matmul {tlib * 1e3:.2f} us")
        del adj, vals, narrow, got, want, got16, scale, err
        torch.cuda.empty_cache()


@contextlib.contextmanager
def counted_gathers():
    """Count the sharded topology's all-gathers (its one collective a
    mix; the residuals' and metrics' gathers too)."""
    from repro_torch.core import topology as TP

    real, calls = TP._all_gather, []

    def counting(out, inp, group=None):
        calls.append(tuple(inp.shape))
        return real(out, inp, group=group)

    TP._all_gather = counting
    try:
        yield calls
    finally:
        TP._all_gather = real


def sharded_topology(ops, ref, dev, full, parked, lm32):
    """The sharded topology (``mix_backend="sharded"``): B2 on row blocks,
    then a world of one over a real NCCL group: the convex full size and
    xlstm-125m at full width, each bit for bit with its dense run of
    phases 5 and 10; then the LM run over two ranks, one a card, where the
    host has two cards."""
    import torch.distributed as dist

    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import engine as E
    from repro_torch.core import topology as TP
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.core.solvers import LinearRegressionProblem
    from repro_torch.launch import train

    check_row_blocks(ops, ref, dev)
    end = train.init_sharded_group(None)
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == (
            "nccl" if dev.type == "cuda" else "gloo")
        graph = random_bipartite_graph(FULL_N, 0.35, seed=0)
        prob = LinearRegressionProblem(*(t.to(dev) for t in parked))
        topo = TP.build(graph, "sharded", device=dev)
        # NCCL makes its communicator at the first collective: not timed
        t0 = time.perf_counter()
        topo.gather(torch.zeros((1, 1), device=dev))
        torch.cuda.synchronize()
        log(f"sharded: NCCL communicator of one rank made in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0),
                                  mix_backend="sharded")
        ops.reset_launches()
        with counted_gathers() as gathers:
            t0 = time.perf_counter()
            state, out = E.run(graph, cfg, E.ExactSolver(prob),
                               torch.zeros((FULL_N, FULL_D), device=dev),
                               FULL_ITERS,
                               extra_metrics=E.flat_metrics(graph, topo),
                               topology=topo)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        want = {k: 0 for k in ops.KERNELS}
        want.update(stoch_quantize=2 * FULL_ITERS,
                    bipartite_mix=3 * FULL_ITERS)
        assert launches == want, launches
        # three mixes and the primal residual's gather an iteration
        assert len(gathers) == 4 * FULL_ITERS, len(gathers)
        assert torch.equal(out["tx_mask"], full["tx_mask"])
        assert torch.equal(out["payload_bits"], full["payload_bits"])
        assert torch.equal(state.theta, full["theta"])
        log(f"sharded convex full size, world 1 over NCCL: "
            f"{wall / FULL_ITERS * 1e3:.2f} ms/iteration (dense, phase 5: "
            f"{full['ms_per_iteration']:.2f}), tx_mask, bits and theta equal "
            f"to the dense run bit for bit; {len(gathers)} all-gathers, "
            f"launches {launches}")
        del prob, state, out, topo
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with counted_gathers() as gathers:
            t0 = time.perf_counter()
            lm = train.main(LM_FLAGS + ["--steps", str(LM_STEPS),
                                        "--mix-backend", "sharded"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {k: 0 for k in ops.KERNELS}
        want.update(stoch_quantize_grouped_fused=2 * LM_STEPS,
                    bipartite_mix=3 * LM_STEPS)
        assert launches == want, launches
        mixes = [g for g in gathers if g == (4, LM_DIM)]
        assert len(mixes) == 3 * LM_STEPS, gathers
        assert lm["history"] == lm32["history"], (lm["history"],
                                                  lm32["history"])
        assert lm["total_bits"] == lm32["total_bits"]
        assert lm["tx_counts"] == lm32["tx_counts"]
        log(f"sharded lm xlstm-125m, world 1 over NCCL: loss "
            f"{' -> '.join(f'{x:.4f}' for x in lm['history'])} and cum bits "
            f"{lm['total_bits']:.4e} equal to phase 10's bit for bit, tx "
            f"{lm['tx_counts']}; s/step "
            f"{', '.join(f'{x:.3f}' for x in lm['step_seconds'])} (dense: "
            f"{', '.join(f'{x:.3f}' for x in lm32['step_seconds'])}; wall "
            f"{wall:.1f} s with init), peak device memory {peak_gb:.2f} GB "
            f"(dense {lm32['peak_gb']:.2f}); {len(mixes)} mix all-gathers of "
            f"{4 * LM_DIM * 4 / 1e9:.2f} GB, {len(gathers)} in all; launches "
            f"{launches}")
        result = {k: lm[k] for k in ("history", "total_bits", "tx_counts")}
        del lm
    finally:
        end()
    torch.cuda.empty_cache()
    sharded_two_cards(result)


SHARDED_RANKS = Path(__file__).resolve().parent / "build" / "sharded_ranks"


def sharded_two_cards(world1):
    """The LM run of :func:`sharded_topology` under ``torch.distributed.run
    --nproc-per-node 2``, one rank a card: bits and transmissions equal,
    the loss within 1e-6 (the cross-rank mean); each rank's peak memory.
    Needs two cards; with one it says so and passes nothing."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"sharded lm 2 ranks: needs 2 cards, this host has {n}; not run "
            f"(not counted as passed)")
        return
    SHARDED_RANKS.mkdir(parents=True, exist_ok=True)
    for old in SHARDED_RANKS.glob("rank*.json"):
        old.unlink()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(Path(__file__).resolve()),
         "--sharded-rank", str(SHARDED_RANKS)] + LM_FLAGS
        + ["--steps", str(LM_STEPS), "--mix-backend", "sharded"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ranks = [json.loads((SHARDED_RANKS / f"rank{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        assert r["total_bits"] == world1["total_bits"], r
        assert r["tx_counts"] == world1["tx_counts"], r
        np.testing.assert_allclose(r["history"], world1["history"],
                                   rtol=1e-6)
    log(f"sharded lm 2 ranks on 2 cards: loss "
        f"{' -> '.join(f'{x:.6f}' for x in ranks[0]['history'])}, bits and "
        f"tx equal to world 1; s/step {ranks[0]['step_seconds']}; peak "
        f"device memory per rank {[r['peak_gb'] for r in ranks]} GB; "
        f"{time.perf_counter() - t0:.1f} s with start-up")


def sharded_rank_main(out_dir: str, flags) -> int:
    """``--sharded-rank DIR FLAGS...``, one rank under ``torch.distributed
    .run``: the trainer with ``FLAGS`` on ``cuda:LOCAL_RANK``; rank r writes
    its result to ``DIR/rank<r>.json``."""
    from repro_torch.launch import train

    cuda = "--device" not in flags
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.cuda.reset_peak_memory_stats()
    out = train.main(flags)
    res = {k: out[k] for k in ("history", "total_bits", "tx_counts",
                               "step_seconds")}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    Path(out_dir, f"rank{os.environ['RANK']}.json").write_text(
        json.dumps(res))
    return 0


def profile_lm_step(state, dev):
    """Top device activities of one more full-width step (torch.profiler,
    device activity only)."""
    from repro_torch.configs import base
    from repro_torch.core import engine as E
    from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
    from repro_torch.launch import train
    from repro_torch.runtime import steps as ST

    args = train.build_parser().parse_args(LM_FLAGS)
    cfg = base.get_config(args.arch)
    solver = E.InexactSolver(grad_fn=train.lm_grad_fn(cfg),
                             local_steps=args.local_steps, local_lr=args.lr)
    ecfg = E.EngineConfig(
        rho=args.rho, censor=E.CensorConfig(tau0=args.tau0, xi=args.xi),
        quantize=E.QuantConfig(b0=args.bits, omega=args.omega),
        groups=args.groups)
    step = E.make_step(ST.worker_graph(args.workers), ecfg, solver,
                       extra_metrics=E.consensus_metrics(
                           train.lm_loss_fn(cfg)), device=dev)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, args.seq))
    batch = model_batch(cfg, data.worker_batch(LM_STEPS, args.workers,
                                               args.batch // args.workers),
                        dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (args.workers, E.tree_dim(state.theta))
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step(holder["state"], lambda ph: torch.rand(
            shape, generator=gen, device=dev), batch)

    t0 = time.perf_counter()
    wall_ms, acts = device_times(one_step)
    busy_ms = sum(t for _, t in acts.values())
    log(f"profile 1 full-width lm step: wall {wall_ms:.1f} ms, device "
        f"activities {busy_ms:.1f} ms ({100.0 * busy_ms / wall_ms:.1f}% of "
        f"wall), {sum(c for c, _ in acts.values())} device activities; "
        f"profiling took {time.perf_counter() - t0:.1f} s")
    for key, (c, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:10]:
        log(f"profile   {t:10.3f} ms  x{c:<6d} {key[:80]}")
    holder.clear()


def lm_tiled(ops):
    """The D-tiled fused quantize on the training path (smoke config)."""
    from repro_torch.launch import train

    flags = [f for f in LM_FLAGS]
    flags[flags.index("leaf")] = "block:embed,mlp,norm"
    os.environ["REPRO_QUANT_TILE_D"] = "512"
    try:
        ops.reset_launches()
        out = train.main(flags + ["--smoke", "--steps", str(TILED_STEPS),
                                  "--censor-mode", "group"])
        torch.cuda.synchronize()
        launches = dict(ops.launches)
    finally:
        del os.environ["REPRO_QUANT_TILE_D"]
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize_grouped_fused_tiled=2 * TILED_STEPS,
                bipartite_mix=3 * TILED_STEPS)
    assert launches == want, launches
    assert out["n_groups"] == 4 and np.isfinite(out["history"]).all()
    log(f"tiled xlstm-smoke block:embed,mlp,norm group censoring: loss "
        f"{' -> '.join(f'{x:.4f}' for x in out['history'])}; launches "
        f"{launches}")
    return launches


def twopass_vs_fused(ops, dev):
    """One packed quantize step at the smoke width through the two-pass
    path (B5) and the fused one (B3): value-identical."""
    from repro_torch.configs import base
    from repro_torch.core import engine as E
    from repro_torch.core import tree as T
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models import registry

    cfg = base.get_smoke_config("xlstm-125m")
    gen = torch.Generator(device=dev).manual_seed(5)
    theta = T.tree_map(lambda x: torch.stack([x, 1.01 * x, x + 1e-3, -x]),
                       registry.init_params(cfg, gen, device=dev))
    ids = E.resolve_groups(theta, "leaf")
    q_hat = T.tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, generator=gen, device=dev), theta)
    leaf = q_hat["final_norm"]["scale"]
    leaf[2] = theta["final_norm"]["scale"][2]          # a degenerate group
    side = dict(range_prev=0.02 * torch.ones((4, 19), device=dev),
                bits_prev=torch.full((4, 19), 6.0, device=dev),
                delta_prev=torch.zeros((4, 19), device=dev),
                initialized=torch.ones((4, 19), device=dev))
    state = E.GroupQuantState(q_hat=q_hat, **side)
    u = torch.rand((4, E.tree_dim(theta)), generator=gen, device=dev)
    qcfg = QuantConfig(b0=6, omega=0.9995)
    ops.reset_launches()
    two = E.grouped_quantize_step_twopass(state, theta, u, qcfg, ids)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    fused = E.grouped_quantize_step(state, theta, u, qcfg, ids)
    torch.cuda.synchronize()
    assert launches["stoch_quantize_grouped"] == 1, launches
    for a, b in zip(T.leaves(two[1]), T.leaves(fused[1])):
        assert torch.equal(a, b)
    for f in ("range_prev", "bits_prev", "delta_prev", "initialized"):
        assert torch.equal(getattr(two[0], f), getattr(fused[0], f)), f
    assert torch.equal(two[2], fused[2]) and torch.equal(two[3], fused[3])
    assert torch.equal(fused[1]["final_norm"]["scale"][2], leaf[2])
    log(f"two-pass vs fused xlstm-smoke (4, {E.tree_dim(theta)}) G=19: "
        f"candidate, (N, G) state, bits and payload identical; launches "
        f"{launches}")
    return launches


# slice 4: the sparse topology (B6), time-varying graphs and the fleet
DYN_ITERS, DYN_REFRESH, FLEET_ROUNDS, PAPER_FLEET_ROUNDS = 20, 5, 20, 60
LM_FLEET_ROUNDS = 3
LM_FLEET_FLAGS = LM_FLAGS + ["--mix-backend", "sparse", "--fleet",
                             "--fleet-participation", "0.75",
                             "--fleet-staleness", "2",
                             "--fleet-churn", "2:1:1"]
LM_DIM = 134277912          # xlstm-125m parameters per worker


def edge_cases():
    """label -> (graph, d) of the B6 checks: an odd width, the paper and
    full convex sizes, a star (S = 256, heavy padding), a 1,024-worker
    sparse graph and the LM trainer's 4-worker graph at full width."""
    from repro_torch.core import graph as G
    from repro_torch.runtime import steps as ST

    return {
        "(6, 7)": (G.random_bipartite_graph(6, 0.5, seed=1), 7),
        "paper (24, 50)": (G.random_bipartite_graph(24, 0.35, seed=0), 50),
        "full (64, 2000)": (G.random_bipartite_graph(64, 0.35, seed=0),
                            2000),
        "star_graph(257) d=2000": (G.star_graph(257), 2000),
        "random(1024, 0.05) d=2000": (
            G.random_bipartite_graph(1024, 0.05, seed=0), 2000),
        "lm (4, 134277912)": (ST.worker_graph(4), LM_DIM),
    }


def edge_inputs(graph, d, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    table, valid = graph.neighbor_table
    return (torch.randn((graph.n, d), generator=gen, device=dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(valid).to(dev))


def edge_bytes(graph, d):
    """(unique, gathered) bytes of one call: V's rows that a valid slot
    reads, once, or every slot's row, padded ones included; plus out
    written once and the (N, S) table and validity read once."""
    return roofline().edge_bytes(graph, d)


def check_edge_parity(ops, ref, dev):
    """B6 against its plain version on the card, bit for bit, at every
    shape of ``edge_cases`` and with a poisoned table (pad ids out of
    range at both ends, NaN and inf in the rows they clamp to)."""
    from repro_torch.core import graph as G

    max_err = 0.0
    for seed, (label, (graph, d)) in enumerate(edge_cases().items()):
        vals, table, valid = edge_inputs(graph, d, dev, seed)
        got = ops.edge_gather_mix(vals, table, valid)
        torch.cuda.synchronize()
        want = ref.edge_gather_mix_ref(vals, table, valid)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"edge_gather_mix {label}: max |err| "
                                 f"{err:.3e}, not bit for bit")
        log(f"parity edge_gather_mix {label} S={table.shape[1]} "
            f"(N·S {table.numel()}, {int(valid.sum())} valid): bit for bit "
            f"(max |err| {err:.3e})")
        del vals, got, want
    g = G.random_bipartite_graph(6, 0.5, seed=1)
    table, valid = (x.copy() for x in g.neighbor_table)
    pads = valid == 0
    table[pads] = np.resize(np.array([7, -3, 100, -1], np.int32),
                            int(pads.sum()))
    vals = torch.randn((6, 1001), device=dev)
    vals[0, 2], vals[5, 1] = float("nan"), float("inf")
    args = (torch.from_numpy(table).to(dev), torch.from_numpy(valid).to(dev))
    got = ops.edge_gather_mix(vals, *args)
    want = ref.edge_gather_mix_ref(vals, *args)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan) and bool(nan.any())
    # the rest, inf included, equal bit for bit
    assert torch.equal(got[~nan], want[~nan])
    log(f"parity edge_gather_mix poisoned table (ids {sorted(set(table[pads].tolist()))} "
        f"in pad slots, NaN/inf rows): NaN where the plain version has NaN "
        f"({int(nan.sum())}), the other {int((~nan).sum())} entries "
        f"({int(want.isinf().sum())} inf) bit for bit")
    torch.cuda.empty_cache()
    return max_err


def time_edge(ops, ref, dev):
    """B6 per shape: device time (torch.profiler) and time per call (CUDA
    events), the plain version, the unique- and gathered-bytes bounds,
    the library calls for the same function (``torch.matmul`` over the
    dense 0/1 adjacency, the library column, and ``torch.sparse.mm`` with
    a CSR float32 adjacency) and B2 on the dense adjacency. Returns the LM
    shape's numbers, the ones the main path pays."""
    from repro_torch.kernels import edge_gather_mix as EG
    from repro_torch.kernels.bipartite_mix import bipartite_mix_cuda

    out = None
    for label, (graph, d) in edge_cases().items():
        vals, table, valid = edge_inputs(graph, d, dev, 7)
        big = graph.n * d > 1e8
        reps, plain_reps = (10, 2) if big else (50, 5)
        nnz = int(valid.sum())
        unique, gathered = edge_bytes(graph, d)
        b = bound(*roofline().edge_work(graph, d))
        t = {"ms": time_ms(lambda: ops.edge_gather_mix(vals, table, valid),
                           reps, 5),
             "plain_ms": time_ms(lambda: ref.edge_gather_mix_ref(
                 vals, table, valid), plain_reps, 3),
             "bound": b}
        _, acts = device_times(
            lambda: ops.edge_gather_mix(vals, table, valid), 10)
        hits = [(c, ms) for k, (c, ms) in acts.items() if "edge_gather" in k]
        t["device_ms"] = (sum(ms for _, ms in hits)
                          / sum(c for c, _ in hits) if hits else None)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(graph.csr_offsets.astype(np.int64)).to(dev),
            torch.from_numpy(graph.csr_indices.astype(np.int64)).to(dev),
            torch.ones(graph.csr_indices.size, device=dev),
            size=(graph.n, graph.n), check_invariants=True)
        adj = torch.as_tensor(graph.adjacency, device=dev).contiguous()
        want = ref.edge_gather_mix_ref(vals, table, valid)
        # a library call counts only where it computes the same function:
        # within 1e-6 S max|V| of the plain version (another summation
        # order). torch.matmul over the dense 0/1 adjacency is the
        # library column; torch.sparse.mm (CSR) is printed beside it
        lib_tol = 1e-6 * table.shape[1] * float(vals.abs().max())
        lib = {}
        for name, fn in (("torch.matmul (dense)", lambda: torch.matmul(
                              adj, vals)),
                         ("torch.sparse.mm (CSR)", lambda: torch.sparse.mm(
                              csr, vals))):
            cols = (fn() - want).abs().amax(0)
            bad = torch.nonzero(cols > lib_tol)
            lib[name] = (time_ms(fn, reps, 5), float(cols.max()),
                         int(bad[0, 0]) if bad.numel() else None)
        del want
        mm_ms, mm_err, mm_bad = lib["torch.matmul (dense)"]
        t["library_ms"] = mm_ms if mm_bad is None else None
        b2 = time_ms(lambda: bipartite_mix_cuda(adj, vals), reps, 5)
        lib_txt = "; ".join(
            f"{name} {ms:.5f} ms (max |diff| {err:.3e}: "
            + ("the same function" if first is None else
               f"WRONG from column {first} of {d}, not reported") + ")"
            for name, (ms, err, first) in lib.items())
        p = EG.plan(graph.n, table.shape[1], d, vals.data_ptr() % 16 == 0)
        log(f"time edge_gather_mix {label} S={table.shape[1]} nnz {nnz} "
            f"({p.regime}, tile {p.tile}, rows {p.rows}, grid {p.grid}, "
            f"{p.smem} B): "
            f"device {t['device_ms']} ms, per call {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms; {lib_txt}, tolerance {lib_tol:.3e}; "
            f"B2 on the dense adjacency {b2:.5f} ms; bound {b[0]:.5f} ms "
            f"({b[1]}; {unique / 1e9:.4f} GB unique, gathered "
            f"{gathered / 1e9:.4f} GB = {gathered / roofline().PEAK_BYTES_PER_S * 1e3:.5f}"
            f" ms)")
        if label.startswith("lm"):
            out = t
        del vals, table, valid, csr, adj
        torch.cuda.empty_cache()
    return out


def dynamic_full_size(ops, dev, prob, theta_star):
    """``run_dynamic`` at full size (64 workers, d=2000, p=0.35, a new
    graph every 5 iterations, 20 iterations of cq-ggadmm) on the sparse
    backend, then with the same draws on the dense one: exactly 3 B6
    launches per iteration, the same tx_mask, theta within 1e-4
    max|theta*|."""
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import dynamic as D

    topo = D.DynamicTopology(FULL_N, p=0.35, refresh_every=DYN_REFRESH,
                             seed=0)

    def draws(it, phase):
        gen = torch.Generator(device=dev).manual_seed(2 * it + phase + 11)
        return torch.rand((FULL_N, FULL_D), generator=gen, device=dev)

    runs = {}
    for backend in ("sparse", "dense"):
        cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0), mix_backend=backend)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = D.run_dynamic(topo, prob, cfg, FULL_D, DYN_ITERS,
                                   theta_star=theta_star, uniforms=draws,
                                   device=dev)
        torch.cuda.synchronize()
        runs[backend] = (state, out, dict(ops.launches),
                         time.perf_counter() - t0)
    (s_state, s_out, s_l, s_t), (d_state, d_out, d_l, d_t) = (
        runs["sparse"], runs["dense"])
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize=2 * DYN_ITERS, edge_gather_mix=3 * DYN_ITERS)
    assert s_l == want, s_l
    want.update(edge_gather_mix=0, bipartite_mix=3 * DYN_ITERS)
    assert d_l == want, d_l
    flips = int((s_out["tx_mask"] != d_out["tx_mask"]).sum())
    err = float((s_state.theta - d_state.theta).abs().max())
    tol = 1e-4 * float(theta_star.abs().max())
    assert flips == 0, f"{flips} tx_mask entries differ"
    assert err <= tol, (err, tol)
    dist = s_out["dist_to_opt"]
    assert np.isfinite(dist).all() and dist[-1] < dist[0], dist
    log(f"dynamic cq-ggadmm N={FULL_N} d={FULL_D} p=0.35 refresh "
        f"{DYN_REFRESH}, {DYN_ITERS} iterations: sparse "
        f"{s_t / DYN_ITERS * 1e3:.2f} ms/iteration, dense "
        f"{d_t / DYN_ITERS * 1e3:.2f} ms/iteration; dist-to-opt "
        f"{dist[0]:.4e} -> {dist[-1]:.4e}; tx_mask equal ({int(s_out['tx_mask'].sum())} "
        f"transmissions), theta sparse vs dense max |diff| {err:.3e} "
        f"(tolerance {tol:.3e}), bitwise {bool(torch.equal(s_state.theta, d_state.theta))}")
    log(f"dynamic launches sparse {s_l}")
    return s_l


def fleet_convex(ops, dev, prob, theta_star):
    """The fleet on the convex path, sparse backend, cq-ggadmm: full size
    under faults (participation 0.8, staleness 2, 20 rounds; no churn,
    the exact solver holds per-member data), then a fault-free fleet at
    the paper size against ``run_synchronous``, bit for bit."""
    from repro_torch import interop
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import engine as E
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.data import regression as R
    from repro_torch.fleet import FaultConfig, FleetConfig, FleetSim
    from repro_torch.fleet import run_synchronous
    from repro_torch.obs import trace as obs_trace

    cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0), mix_backend="sparse")
    graph = random_bipartite_graph(FULL_N, 0.35, seed=0)
    fcfg = FleetConfig(rounds=FLEET_ROUNDS, faults=FaultConfig(
        participation=0.8, staleness=2, seed=0), seed=0)
    ops.reset_launches()
    t0 = time.perf_counter()
    fs, m = FleetSim(FULL_N, cfg, fcfg,
                     torch.zeros((FULL_N, FULL_D), device=dev),
                     solver=E.ExactSolver(prob), graph0=graph).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize=2 * FLEET_ROUNDS,
                edge_gather_mix=3 * FLEET_ROUNDS)
    assert launches == want, launches
    dark = (m["fleet_participation"] == 0) & (m["fleet_deliver"] == 0)
    assert dark.any() and (m["payload_bits"][dark] == 0).all()
    assert (m["payload_bits"][m["tx_mask"] == 0] == 0).all()
    theta = fs.engine.theta
    dist0 = float(FULL_N * (theta_star ** 2).sum())
    dist = float(((theta - theta_star[None]) ** 2).sum())
    assert np.isfinite(dist) and dist < dist0, (dist, dist0)
    log(f"fleet full size N={FULL_N} d={FULL_D} participation 0.8 "
        f"staleness 2, {FLEET_ROUNDS} rounds: {wall / FLEET_ROUNDS * 1e3:.2f}"
        f" ms/round, {int(dark.sum())} dark worker-rounds (0 bits each), "
        f"{int(m['fleet_deliver'].sum())} stale deliveries, tx "
        f"{int(m['tx_mask'].sum())} of {FLEET_ROUNDS * FULL_N}, bits "
        f"{m['payload_bits_total'].sum():.4e}, dist-to-opt {dist0:.4e} -> "
        f"{dist:.4e}; launches {launches}")

    x, y = R.partition_uniform(R.synth_linear(), 24)
    pprob = interop.problem_from_numpy(x, y, "linear", device=dev)
    pgraph = random_bipartite_graph(24, 0.35, seed=0)
    metrics = E.flat_metrics(pgraph, "sparse", device=dev)
    theta0 = torch.zeros((24, 50), device=dev)
    sync_state, sync_m = run_synchronous(
        pgraph, cfg, E.ExactSolver(pprob), theta0, PAPER_FLEET_ROUNDS,
        extra_metrics=metrics)
    # untraced, then traced: each bit for bit equal to run_synchronous,
    # with the same launches
    runs = []
    for traced in (False, True):
        path = TRACE_DIR / "fleet_paper.json"
        if traced:
            TRACE_DIR.mkdir(parents=True, exist_ok=True)
            obs_trace.enable(str(path))
        ops.reset_launches()
        try:
            sim = FleetSim(24, cfg, FleetConfig(rounds=PAPER_FLEET_ROUNDS),
                           theta0, solver=E.ExactSolver(pprob),
                           extra_metrics=metrics, graph0=pgraph)
            fs, fm = sim.run()
            torch.cuda.synchronize()
            if traced:
                obs_trace.save()
        finally:
            obs_trace.disable(save=False)
        runs.append(dict(ops.launches))
        for k in sync_m:
            assert np.array_equal(fm[k], sync_m[k]), f"fleet metric {k}"
        for name in ("theta", "theta_hat", "alpha"):
            assert torch.equal(getattr(fs.engine, name),
                               getattr(sync_state, name)), name
    assert runs[0] == runs[1], runs
    with open(path) as f:
        doc = json.load(f)
    assert obs_trace.validate_events(doc) == []
    spans = sum(e["ph"] == "B" and e["name"] == "round"
                for e in doc["traceEvents"])
    assert spans == PAPER_FLEET_ROUNDS, spans
    assert sim.ledger.cum_bits == float(fm["payload_bits_total"].sum())
    log(f"fleet fault-free paper size (24, 50), {PAPER_FLEET_ROUNDS} rounds: "
        f"{len(sync_m)} metrics and the final theta, theta_hat, alpha bit "
        f"for bit equal to run_synchronous, untraced and traced ({spans} "
        f"round spans, the ledger's {sim.ledger.cum_bits:.4e} bits; "
        f"launches {runs[1]} both ways)")
    return launches


def lm_fleet_full_width(ops, dev):
    """The slice's main path: full-width xlstm-125m consensus training
    through ``train.main`` with ``--mix-backend sparse --fleet``
    (participation 0.75, staleness 2, churn at round 2), its launches
    counted; then one faulted round (a worker timed out) under
    torch.profiler."""
    from repro_torch.core import engine as E
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train.main(LM_FLEET_FLAGS + ["--steps", str(LM_FLEET_ROUNDS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m, hist = out["metrics"], out["history"]
    assert len(hist) == LM_FLEET_ROUNDS and np.isfinite(hist).all(), hist
    assert [ev["round"] for ev in out["churn_log"]] == [2], out["churn_log"]
    assert m["n_members"].tolist() == [4] * LM_FLEET_ROUNDS
    want = {k: 0 for k in ops.KERNELS}
    want.update(edge_gather_mix=3 * LM_FLEET_ROUNDS,
                stoch_quantize_grouped_fused=2 * LM_FLEET_ROUNDS)
    assert launches == want, launches
    dark = (m["fleet_participation"] == 0) & (m["fleet_deliver"] == 0)
    assert dark.any() and (m["payload_bits"][dark] == 0).all()
    assert (m["payload_bits"][m["tx_mask"] == 0] == 0).all()
    log(f"lm fleet xlstm-125m sparse 4 workers x "
        f"{E.tree_dim(out['fleet_state'].engine.theta)} params: loss "
        f"{' -> '.join(f'{x:.4f}' for x in hist)}; churn "
        f"{out['churn_log']}; dark worker-rounds "
        f"{int(dark.sum())} (0 bits each), stale deliveries "
        f"{int(m['fleet_deliver'].sum())}, tx {m['tx_count'].tolist()}, "
        f"bits {out['total_bits']:.4e}; s/round "
        f"{', '.join(f'{x:.3f}' for x in out['step_seconds'])} (wall "
        f"{wall:.1f} s with init); peak device memory {peak_gb:.2f} GB")
    log(f"lm fleet launches {launches} (= 3 B6 and 2 B3 per round)")
    return launches



# serving: tinyllama-1.1b at full width (arXiv:2401.02385), the request
# stream of the paged scheduler and the contiguous lockstep reference
SERVE_LENS = (17, 96, 255, 512, 700, 33, 384, 128)
SERVE_REQUESTS, SERVE_NEW = 16, 128
SERVE_HELD = 8   # requests held to the lockstep engine (each length once)
SERVE_GEOM = dict(max_seqs=8, page_size=16, pages_per_seq=64,
                  prefill_chunk=64)
SHORT_REQUESTS, SHORT_NEW = 4, 32
LONG_PROMPT, LONG_NEW, LONG_PAGES = 3968, 32, 256
GAP_TOL = 1e-3
TOP_K = 8        # logits kept per generated position for the comparison
# (B, H, KV, hd, ps, P) and ctx lens of the paged-attention checks: the
# smoke model's heads; tinyllama's with the main stream's table (64 pages),
# the production-load stream's (84 pages: 11 splits of 128 slots, the last
# half filled) and the long request's (256 pages); poisoned slots past ctx
PAGED_CHECKS = {
    "smoke": ((3, 8, 2, 32, 4, 16), (0, 1, 37)),
    "tinyllama P=64": ((8, 32, 4, 64, 16, 64),
                       (0, 1, 81, 160, 319, 576, 764, 1024)),
    "tinyllama P=256": ((8, 32, 4, 64, 16, 256),
                        (0, 1, 700, 1500, 2500, 3300, 4000, 4096)),
    # every sequence live, ctx on and around the split boundaries (at 128
    # and 256 slots per split), at both tables
    "tinyllama P=256 split edges": ((8, 32, 4, 64, 16, 256),
                                    (127, 128, 129, 255, 256, 257, 513,
                                     4095)),
    "tinyllama P=64 split edges": ((8, 32, 4, 64, 16, 64),
                                   (127, 128, 129, 255, 256, 257, 513,
                                    1023)),
    # the load stream's contexts (529 to 1,340 of 1,344 slots), on and
    # around the last full split's edge
    "tinyllama P=84 load": ((8, 32, 4, 64, 16, 84),
                            (0, 529, 1024, 1212, 1279, 1280, 1281, 1340)),
    # serve-smoke's model (4x the smoke width): 8-token pages, 11-page
    # tables, ctx on and around page edges up to the full table
    "serve-smoke ps 8": ((4, 8, 2, 64, 8, 11), (0, 1, 7, 8)),
    "serve-smoke ps 8 full": ((4, 8, 2, 64, 8, 11), (9, 17, 81, 88)),
}
# the wider head dims (B, H, KV, hd, ps, P): h2o-danube (80, G 4), zamba2
# (112, G 1), olmoe (128, G 1), mistral-large (128, G 12 over three
# blocks), qwen2-vl (128, G 7 over two), gemma3's global layers (256, G 2);
# 84-page tables, ctx 0 and on the split edges
WIDE_SHAPES = {"h2o-danube hd 80": (4, 32, 8, 80, 16, 84),
               "zamba2 hd 112": (4, 32, 32, 112, 16, 84),
               "olmoe hd 128": (4, 16, 16, 128, 16, 84),
               "mistral-large hd 128": (4, 96, 8, 128, 16, 84),
               "qwen2-vl hd 128": (4, 28, 4, 128, 16, 84),
               "gemma3 hd 256": (8, 8, 4, 256, 16, 84)}
for _label, _shape in WIDE_SHAPES.items():
    _edges = (0, 1, 127, 128, 129, 1279, 1280, 1340)
    if _shape[0] == 8:
        PAGED_CHECKS[_label] = (_shape, _edges)
    else:
        PAGED_CHECKS[_label] = (_shape, _edges[:4])
        PAGED_CHECKS[_label + " split edges"] = (_shape, _edges[4:])
# (kv_bits, dtype of a 32-bit pool) of every paged check
PAGED_POOLS = ((32, torch.bfloat16), (32, torch.float32), (8, None),
               (4, None))


def paged_inputs(dev, shape, ctx, kv_bits, seed,
                 pool_dtype=torch.bfloat16):
    """Decode inputs on the card from a seeded generator: q (B, H, hd) float32;
    K/V pools of B*P+3 pages as ``pool_dtype`` values (kv_bits 32) or as
    ``kv_page_quantize`` codes with their ranges; a table of distinct pages
    whose slots past ctx are poisoned (-1, or ids past the pool). Returns
    (q, keyword arguments, max |V| as the kernels read it)."""
    from repro_torch.kernels import ref

    bsz, heads, num_kv, hd, ps, pps = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_pages = bsz * pps + 3
    q = torch.randn((bsz, heads, hd), generator=gen, device=dev)
    pool = (num_pages, ps, num_kv, hd)
    k = torch.randn(pool, generator=gen, device=dev)
    v = 2.0 * torch.randn(pool, generator=gen, device=dev)
    ctx = torch.tensor(ctx, dtype=torch.int32, device=dev)
    bt = torch.randperm(num_pages, generator=gen, device=dev)[:bsz * pps]
    bt = bt.reshape(bsz, pps)
    used = ((ctx.long() + ps - 1) // ps)[:, None]
    lidx = torch.arange(pps, device=dev)[None]
    poison = torch.where((lidx - used) % 2 == 0, -1, num_pages + 7)
    bt = torch.where(lidx >= used, poison, bt).to(torch.int32).contiguous()
    kw = dict(block_tables=bt, ctx_lens=ctx, kv_bits=kv_bits)
    if kv_bits == 32:
        kw.update(k_pages=k.to(pool_dtype), v_pages=v.to(pool_dtype))
        vmax = float(kw["v_pages"].float().abs().max())
    else:
        kc, kr = ref.kv_page_quantize(k, kv_bits=kv_bits)
        vc, vr = ref.kv_page_quantize(v, kv_bits=kv_bits)
        kw.update(k_pages=kc, v_pages=vc, k_scale=kr, v_scale=vr)
        vmax = float(ref.kv_page_dequantize(vc, vr, kv_bits=kv_bits,
                                            head_dim=hd).abs().max())
    return q, kw, vmax


def paged_kernel(q, kw, online):
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    kw = dict(kw)
    return paged_attention_cuda(q, kw.pop("k_pages"), kw.pop("v_pages"),
                                kw.pop("block_tables"), kw.pop("ctx_lens"),
                                online=online, **kw)


def paged_plain(ref, q, kw, online):
    kw = dict(kw)
    fn = ref.paged_attention_online_ref if online else ref.paged_attention_ref
    return fn(q, kw.pop("k_pages"), kw.pop("v_pages"),
              kw.pop("block_tables"), kw.pop("ctx_lens"), **kw)


def uniform_average(ref, kw, shape):
    """What the one-shot contract gives where ctx = 0: per KV head, the
    mean of V over every slot of the clamped table, for each query head."""
    bsz, heads, num_kv, hd, ps, pps = shape
    v_pages = kw["v_pages"]
    bt = torch.clamp(kw["block_tables"].long(), 0, v_pages.shape[0] - 1)
    if kw["kv_bits"] == 32:
        v = v_pages[bt].float()
    else:
        v = ref.kv_page_dequantize(v_pages[bt], kw["v_scale"][bt],
                                   kv_bits=kw["kv_bits"], head_dim=hd)
    mean = v.reshape(bsz, pps * ps, num_kv, hd).mean(1)
    return mean.repeat_interleave(heads // num_kv, dim=1)


def check_paged_parity(ref, dev):
    """B7 (the one-shot contract) and B8 (online) against their plain versions,
    and B8 against B7 where ctx > 0, to 1e-5 of max|V|, at every shape and
    kv_bits 32 (bf16 and float32 pools), 8 and 4; B7 where ctx = 0 against
    the uniform average of V over the table (as ``uniform_average`` computes
    it, to the same tolerance); a second call of each equal bit for bit (the
    ticket counters were reset). The kernels get the poisoned table as it is
    (they clamp it)."""
    errs = {"paged_attention_decode": 0.0,
            "paged_attention_decode_online": 0.0}
    seed = 0
    for label, (shape, ctx) in PAGED_CHECKS.items():
        for bits, pool_dtype in PAGED_POOLS:
            seed += 1
            pools = (str(pool_dtype).removeprefix("torch.") + " pools"
                     if pool_dtype else "code pools")
            q, kw, vmax = paged_inputs(dev, shape, ctx, bits, seed,
                                       pool_dtype)
            got = {o: paged_kernel(q, kw, o) for o in (False, True)}
            again = {o: paged_kernel(q, kw, o) for o in (False, True)}
            torch.cuda.synchronize()
            assert all(torch.equal(got[o], again[o]) for o in got), label
            line = []
            for online, name in ((False, "paged_attention_decode"),
                                 (True, "paged_attention_decode_online")):
                err = float((got[online] - paged_plain(ref, q, kw, online)
                             ).abs().max())
                if not err <= 1e-5 * vmax:
                    raise AssertionError(f"{name} {label} kv_bits {bits} "
                                         f"{pools}: max |err| {err:.3e} > "
                                         f"1e-5 x {vmax:.3f}")
                errs[name] = max(errs[name], err)
                line.append(f"{name} {err:.3e}")
            live = kw["ctx_lens"] > 0
            cross = float((got[True][live] - got[False][live]).abs().max())
            if not cross <= 1e-5 * vmax:
                raise AssertionError(f"B8 vs B7 {label} kv_bits {bits} "
                                     f"{pools}: {cross:.3e}")
            assert bool((got[True][~live] == 0).all()), "B8 ctx 0 not zero"
            if bool((~live).any()):
                uni = float((got[False][~live] - uniform_average(
                    ref, kw, shape)[~live]).abs().max())
                if not uni <= 1e-5 * vmax:
                    raise AssertionError(f"B7 ctx 0 {label} kv_bits "
                                         f"{bits} {pools}: {uni:.3e} from "
                                         f"the average")
                line.append(f"B7 at ctx 0 vs the uniform average {uni:.3e}")
            log(f"parity paged {label} kv_bits {bits} {pools}: max "
                f"|err| {', '.join(line)}, B8 vs B7 {cross:.3e} (max|V| "
                f"{vmax:.3f}); second calls equal bit for bit")
            del q, kw, got, again
    return errs


def paged_bound(shape, ctx, kv_bits, online, pool_bytes=2):
    """Least time for one call: the K/V entries (and ranges) of the pages
    up to ctx (where ctx = 0: all P pages for the one-shot kernel's uniform
    average, none for the online kernel), q, out, table and ctx, each read
    or written once, at the card's memory rate; against 4·H·hd float32
    operations per slot."""
    return bound(*roofline().paged_work(shape, ctx, kv_bits, online,
                                        pool_bytes))


def gathered_sdpa_ms(q, kw, shape, dev) -> float:
    """Time per call of the same function after the gather: SDPA over
    contiguous K/V of the whole table in the pool's dtype, masked by
    ctx."""
    import torch.nn.functional as F

    bsz, heads, num_kv, hd, ps, pps = shape
    bt = torch.clamp(kw["block_tables"].long(), 0,
                     kw["k_pages"].shape[0] - 1)

    def gather(pool):
        g = pool[bt].reshape(bsz, pps * ps, num_kv, hd)
        return g.permute(0, 2, 1, 3).contiguous()

    kg, vg = gather(kw["k_pages"]), gather(kw["v_pages"])
    qb = q.to(kw["k_pages"].dtype)[:, :, None, :]
    mask = (torch.arange(pps * ps, device=dev)[None]
            < kw["ctx_lens"][:, None])[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qb, kg, vg, attn_mask=mask, enable_gqa=True), 50, 5)


def time_paged(ref, dev):
    """Kernel, plain and library times of B7 and B8 at the shapes the
    serving path gives them (bf16 pools): B7 at the main stream's table
    with its mid-decode contexts, B8 at the long request's table with one
    sequence at ~4000 tokens; also each at the other's shape, at kv_bits 8
    and 4, and B7 at the production-load stream's table with float32
    pools and its mid-decode contexts (printed only)."""
    b7_ctx = tuple(n + SERVE_NEW // 2 for n in SERVE_LENS)
    b8_ctx = (LONG_PROMPT + LONG_NEW // 2,) + (0,) * 7
    load_ctx = tuple(LOAD_PREFIX + n + SERVE_NEW // 2 for n in SERVE_LENS)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "paged_attention_decode": ((8, 32, 4, 64, 16, 64), b7_ctx, False,
                                   bf16),
        "paged_attention_decode_online": ((8, 32, 4, 64, 16, 256), b8_ctx,
                                          True, bf16),
    }
    extra = {
        "B8 at B7's shape": ((8, 32, 4, 64, 16, 64), b7_ctx, True, bf16),
        "B7 at B8's shape": ((8, 32, 4, 64, 16, 256), b8_ctx, False, bf16),
        "B7 P=256, 8 x ~4000": ((8, 32, 4, 64, 16, 256), (4000,) * 8, False,
                                bf16),
        "B8 P=256, 8 x ~4000": ((8, 32, 4, 64, 16, 256), (4000,) * 8, True,
                                bf16),
        "B7 P=84 load, float32 pools": ((8, 32, 4, 64, 16, LOAD_PPS),
                                        load_ctx, False, f32),
    }
    out = {}
    for label, (shape, ctx, online, pool) in {**cases, **extra}.items():
        for bits in ((32, 8, 4) if label in cases else (32,)):
            q, kw, _ = paged_inputs(dev, shape, ctx, bits, 50, pool)
            b = paged_bound(shape, ctx, bits, online, pool.itemsize)
            t = {"ms": time_ms(lambda: paged_kernel(q, kw, online), 50, 5),
                 "plain_ms": time_ms(lambda: paged_plain(ref, q, kw, online),
                                     3, 3),
                 "bound": b, "library_ms": None}
            # every kernel one call launches, summed
            t["device_ms"] = device_ms(lambda: paged_kernel(q, kw, online))
            if bits == 32:
                t["library_ms"] = gathered_sdpa_ms(q, kw, shape, dev)
            log(f"time {label} kv_bits {bits} ctx {ctx}: per call "
                f"{t['ms']:.5f} ms (device only {t['device_ms']} ms), plain "
                f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']} ms, bound "
                f"{b[0]:.5f} ms ({b[1]})")
            if label in cases and bits == 32:
                out[label] = t
            del q, kw
    torch.cuda.empty_cache()
    return out


def time_paged_wide(ref, dev):
    """B7 and B8 at the wider head dims (``WIDE_SHAPES``) at the
    production-load shape: 84-page tables, the load stream's mid-decode
    contexts, bf16 pools; device time, time per call, plain, SDPA over the
    gathered K/V, and the bytes bound (printed; PERF.md's kernel table)."""
    from repro_torch.kernels import paged_attention as pa

    load_ctx = tuple(LOAD_PREFIX + n + SERVE_NEW // 2 for n in SERVE_LENS)
    for label, shape in WIDE_SHAPES.items():
        hd = shape[3]
        ctx = load_ctx[:shape[0]]
        q, kw, _ = paged_inputs(dev, shape, ctx, 32, 60)
        sdpa = gathered_sdpa_ms(q, kw, shape, dev)
        for online, name in ((False, "B7"), (True, "B8")):
            fn = lambda: paged_kernel(q, kw, online)
            b = paged_bound(shape, ctx, 32, online, 2)
            tile, groups, hdp = pa.geometry(hd, 2 * hd)
            log(f"time {name} {label} P=84 load bf16 pools ctx {ctx}: "
                f"device {device_ms(fn)} ms, per call "
                f"{time_ms(fn, 50, 5):.5f} ms, plain "
                f"{time_ms(lambda: paged_plain(ref, q, kw, online), 3, 3):.4f}"
                f" ms, SDPA {sdpa:.5f} ms, bound {b[0]:.5f} ms ({b[1]}); "
                f"tile {tile}, {groups} query heads a block, padded hd "
                f"{hdp}")
        del q, kw
    torch.cuda.empty_cache()


def time_split_rows(dev):
    """Slots per block, the one setting of the split design (both
    contracts): device time and time per call at each of 64, 128, 256 and
    512 slots for B8 at its shape (one sequence at ~4000 tokens) and with
    all eight sequences at ~4000, and at each of 64, 128 and 256 for B7 at
    the main stream's shape (bf16 pools); the wrapper's ``SPLIT_ROWS`` is
    the one chosen from these."""
    # ops first: importing paged_attention alone runs into the kernels
    # package's import cycle (ref -> core -> topology -> ops)
    from repro_torch.kernels import ops  # noqa: F401
    from repro_torch.kernels import paged_attention as pa

    long = (8, 32, 4, 64, 16, LONG_PAGES)
    cases = {
        "B8 at its shape": (long, (LONG_PROMPT + LONG_NEW // 2,) + (0,) * 7,
                            True, (64, 128, 256, 512)),
        "B8 at 8 x ~4000": (long, (4000,) * 8, True, (64, 128, 256, 512)),
        "B7 at its shape": ((8, 32, 4, 64, 16, SERVE_GEOM["pages_per_seq"]),
                            tuple(n + SERVE_NEW // 2 for n in SERVE_LENS),
                            False, (64, 128, 256)),
    }
    chosen = pa.SPLIT_ROWS
    try:
        for label, (shape, ctx, online, choices) in cases.items():
            q, kw, _ = paged_inputs(dev, shape, ctx, 32, 50)
            line = []
            for rows in choices:
                pa.SPLIT_ROWS = rows
                fn = lambda: paged_kernel(q, kw, online)
                line.append(f"{rows}: {device_ms(fn)} / "
                            f"{time_ms(fn, 50, 5):.5f}")
            log(f"time split_rows, {label} (device / per call ms; "
                f"SPLIT_ROWS {chosen}): " + ", ".join(line))
            del q, kw
    finally:
        pa.SPLIT_ROWS = chosen
    torch.cuda.empty_cache()


def bf16_spacing(x: float) -> float:
    """Distance between neighbouring bfloat16 values at |x| (8 significant
    bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def first_divergence(name, got, want, bf16: bool, gate: bool = True):
    """Compare two greedy streams ((tokens, (top-k values, top-k ids)) per
    request). Where they part, print the step and both runs' top-2 logit
    gaps there. A divergence fails unless, in one of the runs, the other
    run's token is within a near-tie tolerance of the top logit: GAP_TOL
    for float32 logits, one bfloat16 step at the top logit for bf16 logits
    (whose resolution, 2^-8 to 2^-6 at these magnitudes, is coarser than
    GAP_TOL). With ``gate`` False the partings are only printed."""
    diverged = 0
    for r in sorted(got):
        a, (va, ia) = got[r]
        b, (vb, ib) = want[r]
        diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
        if not len(diff):
            continue
        k = int(diff[0])
        diverged += 1
        gap_a = float(va[k][0] - va[k][1])
        gap_b = float(vb[k][0] - vb[k][1])
        tol_a = bf16_spacing(va[k][0]) if bf16 else GAP_TOL
        tol_b = bf16_spacing(vb[k][0]) if bf16 else GAP_TOL
        log(f"{name} request {r} diverges at step {k}: paged token "
            f"{a[k]} (top-2 gap {gap_a:.4e}), lockstep token {b[k]} "
            f"(top-2 gap {gap_b:.4e}); near-tie tolerance {tol_a:.4e} / "
            f"{tol_b:.4e}")
        def tied(v, ids, other, tol):
            hit = np.nonzero(ids == other)[0]
            return bool(len(hit)) and v[0] - v[hit[0]] <= tol

        if gate and not (tied(va[k], ia[k], b[k], tol_a)
                         or tied(vb[k], ib[k], a[k], tol_b)):
            raise AssertionError(f"{name} request {r}: a divergence at step "
                                 f"{k} with top-2 gaps {gap_a:.4e} / "
                                 f"{gap_b:.4e}")
    return diverged


def compare_with_lockstep(name, cfg, params, dev, prompts, new, sched, outs,
                          batch, cache_dtype=torch.bfloat16, gate=True,
                          want=None):
    """Run the lockstep engine on ``prompts`` grouped by length, one
    ``run`` per length in waves of ``batch`` (the engine pads every wave
    to its stream's longest prompt, so a group of equal lengths carries no
    padding), and hold the scheduler's greedy streams against it
    (:func:`first_divergence`; with ``gate`` False only count and print
    the partings). ``want``, what an earlier call on the same prompts
    returned, stands in for the lockstep run. Returns the lockstep
    streams."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    if want is None:
        groups = {}
        for i in range(len(prompts)):
            groups.setdefault(len(prompts[i]), []).append(i)
        engine = serve.LockstepEngine(cfg, params, batch=batch, device=dev,
                                      cache_dtype=cache_dtype)
        want = {}
        for n in sorted(groups):
            idx = groups[n]
            with torch.no_grad():
                lock = engine.run([prompts[i] for i in idx], new,
                                  keep_top=TOP_K)
            want.update({i: (lock["outputs"][j], lock["top"][j])
                         for j, i in enumerate(idx)})
        torch.cuda.synchronize()
    got = {i: (outs[i], (np.stack([v for v, _ in sched.top[i]]),
                         np.stack([t for _, t in sched.top[i]])))
           for i in range(len(outs))}
    n_div = first_divergence(name, got, want, cfg.dtype == "bfloat16", gate)
    same = sum(int((got[i][0] == want[i][0]).all()) for i in got)
    log(f"{name} lockstep reference ({cfg.dtype} activations): "
        f"{time.perf_counter() - t0:.1f} s; {same} of {len(got)} requests "
        f"equal token for token, {n_div} part"
        + (" at a near-tie" if gate else " (not a gate)"))
    return want


def serve_stream(sched_cls, cfg, params, dev, prompts, new, scfg, ops,
                 record_top=0, priorities=None):
    """Serve ``prompts`` (request i at ``priorities[i]``, default 0)
    through a fresh scheduler with the kernel counts and the peak-memory
    mark set just before; returns (scheduler, outputs by request,
    launches, wall seconds)."""
    sched = sched_cls(cfg, params, scfg, device=dev, record_top=record_top)
    rids = [sched.submit(p, new, priority=0 if priorities is None
                         else priorities[i]) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        finished = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    assert all(len(finished[r]) == new for r in rids)
    assert sched.pool.in_use == 0, sched.pool.in_use
    return sched, [finished[r] for r in rids], launches, wall


def serve_long(ops, dev, cfg, params):
    """One ~4000-token request through the paged scheduler (a 256-page
    table: the threshold picks B8, exactly 22 launches per decode tick),
    held against the lockstep engine; prints its median decode tick and
    returns its launches."""
    from repro_torch.launch import serve
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    geom = SERVE_GEOM
    long_prompt = serve.make_prompts(cfg, [LONG_PROMPT], 1)[0]
    lcfg = ServeConfig(
        max_seqs=geom["max_seqs"], page_size=geom["page_size"],
        pages_per_seq=LONG_PAGES, prefill_chunk=geom["prefill_chunk"],
        num_pages=2 * paging.pages_needed(LONG_PROMPT + LONG_NEW,
                                          geom["page_size"]), kv_bits=32)
    s3, outs3, l3, w3 = serve_stream(Scheduler, cfg, params, dev,
                                     [long_prompt], LONG_NEW, lcfg, ops,
                                     record_top=TOP_K)
    peak3 = torch.cuda.max_memory_allocated() / 1e9
    variant = [k for k, n in l3.items() if n]
    want = {k: 0 for k in ops.KERNELS}
    want["paged_attention_decode_online"] = cfg.num_layers * s3.decode_steps
    assert l3 == want, l3
    compare_with_lockstep("serve long", cfg, params, dev, [long_prompt],
                          LONG_NEW, s3, outs3, 1)
    log(f"serve long request: prompt {LONG_PROMPT} + {LONG_NEW} tokens "
        f"(ctx up to {LONG_PROMPT + LONG_NEW}), table {LONG_PAGES} pages: "
        f"variant {variant} ran, {s3.decode_steps} decode ticks (median "
        f"{np.median(list(s3.decode_step_s)) * 1e3:.3f} ms), prefill "
        f"{s3.prefill_chunks} chunks in {np.sum(list(s3.prefill_chunk_s)):.2f} s, "
        f"{w3:.2f} s wall, peak device memory {peak3:.2f} GB, final pages "
        f"0")
    return l3


def serve_full_width(ops, dev):
    """tinyllama-1.1b at full width through the port's scheduler: the
    16-request greedy stream (B7 on every decode tick), held against the
    lockstep engine's contiguous decode; short kv_bits 8 and 4 streams; one
    request at ~4000 tokens (B8 by the threshold); one profiled tick."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    cfg = base.get_config("tinyllama-1.1b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = registry.count_params(cfg)
    lens = list(SERVE_LENS) * (SERVE_REQUESTS // len(SERVE_LENS))
    prompts = serve.make_prompts(cfg, lens, 0)
    log(f"serve tinyllama-1.1b: {n_params} float32 parameters on the card "
        f"in {time.perf_counter() - t0:.1f} s; {len(prompts)} requests, "
        f"prompt lengths {lens}, {SERVE_NEW} new tokens each")
    geom = dict(SERVE_GEOM)
    worst = geom["max_seqs"] * geom["pages_per_seq"]
    scfg = ServeConfig(num_pages=2 * worst, kv_bits=32, **geom)
    sched, outs, launches, wall = serve_stream(
        Scheduler, cfg, params, dev, prompts, SERVE_NEW, scfg, ops,
        record_top=TOP_K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in ops.KERNELS}
    want["paged_attention_decode"] = cfg.num_layers * sched.decode_steps
    assert launches == want, (launches, sched.decode_steps)
    ticks = np.asarray(list(sched.decode_step_s)) * 1e3
    pre = float(np.sum(list(sched.prefill_chunk_s)))
    log(f"serve paged stream: {wall:.2f} s wall, {sched.steps} ticks, "
        f"{sched.decode_steps} decode ticks (median {np.median(ticks):.3f} ms"
        f", mean {ticks.mean():.3f} ms, p90 {np.percentile(ticks, 90):.3f} "
        f"ms), {sched.decode_tokens / (ticks.sum() / 1e3):.1f} decode "
        f"tokens/s ({sched.decode_tokens} tokens fed by decode ticks), "
        f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} generated tokens/s end to "
        f"end, prefill {sched.prefill_tokens} tokens in "
        f"{sched.prefill_chunks} chunks, {sched.prefill_tokens / pre:.1f} "
        f"prefill tokens/s; peak device memory {peak_gb:.2f} GB; peak pages "
        f"{sched.peak_pages_in_use} of {scfg.num_pages}, final 0")
    log(f"serve launches {launches} (= {cfg.num_layers} x "
        f"{sched.decode_steps} decode ticks, one variant: B7)")

    # the lockstep references cover the first SERVE_HELD requests (each
    # of the eight lengths once), to keep the script inside its limit
    held = prompts[:SERVE_HELD]
    compare_with_lockstep("serve", cfg, params, dev, held, SERVE_NEW,
                          sched, outs[:SERVE_HELD], 2)
    del sched

    # those requests with float32 activations and pools: paged (B7 on
    # float32 pages) against lockstep at GAP_TOL
    cfg32 = cfg.with_overrides(dtype="float32")
    s32cfg = ServeConfig(num_pages=2 * worst, kv_bits=32,
                         cache_dtype="float32", **geom)
    s32, outs32, l32, w32 = serve_stream(
        Scheduler, cfg32, params, dev, held, SERVE_NEW, s32cfg, ops,
        record_top=TOP_K)
    assert l32["paged_attention_decode"] == cfg.num_layers * s32.decode_steps
    log(f"serve float32 stream ({SERVE_HELD} requests): {w32:.2f} s wall, "
        f"{s32.decode_steps} decode ticks (median "
        f"{np.median(list(s32.decode_step_s)) * 1e3:.3f} ms)")
    compare_with_lockstep("serve float32", cfg32, params, dev, held,
                          SERVE_NEW, s32, outs32, 2, torch.float32)
    del s32

    # short streams with quantized pages
    for bits in (8, 4):
        s2cfg = ServeConfig(num_pages=2 * worst, kv_bits=bits, **geom)
        s2, outs2, l2, w2 = serve_stream(
            Scheduler, cfg, params, dev, prompts[:SHORT_REQUESTS], SHORT_NEW,
            s2cfg, ops)
        want = {k: 0 for k in ops.KERNELS}
        want["paged_attention_decode"] = cfg.num_layers * s2.decode_steps
        assert l2 == want, l2
        agree = sum(int((a == outs[i][:SHORT_NEW]).all())
                    for i, a in enumerate(outs2))
        log(f"serve kv_bits {bits}: {SHORT_REQUESTS} x {SHORT_NEW} tokens in "
            f"{w2:.2f} s, {s2.decode_steps} decode ticks (median "
            f"{np.median(list(s2.decode_step_s)) * 1e3:.3f} ms), page bytes "
            f"{paging.cache_page_bytes(s2.cache)}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, final pages "
            f"0, {agree} of "
            f"{SHORT_REQUESTS} streams equal to the bf16 pages' first "
            f"{SHORT_NEW} tokens; launches {l2}")
        del s2

    l3 = serve_long(ops, dev, cfg, params)

    # one steady-state decode tick (8 active sequences) under the profiler
    s4 = Scheduler(cfg, params, scfg, device=dev)
    for p in prompts[:geom["max_seqs"]]:
        s4.submit(p, 8)
    with torch.no_grad():
        s4.step()
        s4.step()
        wall_ms, acts = device_times(s4.step)
        s4.run()
    busy_ms = sum(t for _, t in acts.values())
    log(f"profile 1 decode tick (8 sequences): wall {wall_ms:.3f} ms, device "
        f"activities {busy_ms:.3f} ms ({100.0 * busy_ms / wall_ms:.1f}% of "
        f"wall), {sum(c for c, _ in acts.values())} device activities")
    for key, (c, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:10]:
        log(f"profile   {t:10.3f} ms  x{c:<6d} {key[:80]}")
    del s4, params
    torch.cuda.empty_cache()
    return {"paged_attention_decode": launches["paged_attention_decode"],
            "paged_attention_decode_online":
                l3["paged_attention_decode_online"]}


# sLSTM cell (B9) and xlstm-125m serving at full width (arXiv:2405.04517):
# H = 4 heads of dh = 192 in each of the 6 sLSTM layers
SLSTM_H, SLSTM_DH = 4, 192
# label: ((B, S), wx dtype, initial state): the lockstep prefill of the
# longest wave, the paged bulk chunk (bf16 is the main path's, timed for
# the kernels line), an odd shape; m0 = 0 (a paged admission) and -1e30 (a
# fresh contiguous cache)
SLSTM_CHECKS = {
    "lockstep prefill (8, 700) bf16, m0 -1e30": ((8, 700), torch.bfloat16,
                                                 "fresh"),
    "lockstep prefill (8, 700) bf16, m0 0": ((8, 700), torch.bfloat16,
                                             "admitted"),
    "paged chunk (1, 64) bf16, m0 0": ((1, 64), torch.bfloat16, "admitted"),
    "paged chunk (1, 64) f32, m0 0": ((1, 64), torch.float32, "admitted"),
    "paged chunk (1, 64) f32, carried state": ((1, 64), torch.float32,
                                               "carried"),
    "odd (3, 129) f32, m0 -1e30": ((3, 129), torch.float32, "fresh"),
    "odd (3, 129) bf16, m0 0": ((3, 129), torch.bfloat16, "admitted"),
    # other head widths: C follows dh (1 CTA at 64, 8 at 256)
    "dh 64, a cluster of 1: (9, 33) x 4 heads bf16, carried state": (
        (9, 33, 4, 64), torch.bfloat16, "carried"),
    "dh 256, a cluster of 8: (2, 9) x 1 head f32, carried state": (
        (2, 9, 1, 256), torch.float32, "carried"),
}
SLSTM_MAIN = "paged chunk (1, 64) bf16, m0 0"
SLSTM_TOL = 1e-4         # of max|hs|: fmaf in k order against cuBLAS sums
XLSTM_PREFILL = (8, 700)
XLSTM_ALONE = (0, 2, 4, 6)    # prompts 17, 255, 700, 384: the shortest and
                              # the longest of the stream among them


def slstm_dims(shape):
    """(B, S, H, dh) of a (B, S) shape at xlstm-125m's heads, or of a
    (B, S, H, dh) one."""
    return tuple(shape) if len(shape) == 4 else (*shape, SLSTM_H, SLSTM_DH)


def slstm_inputs(dev, shape, wx_dtype, state, seed):
    """B9's inputs on the card from a seeded generator, at xlstm-125m's
    heads unless ``shape`` names them: wx (B, S, 4, 768), R (4, 192, 768) /
    sqrt(192), fbias 3.0 (the init's), and a fresh (m -1e30), admitted (all
    0) or carried state."""
    b, s, h, dh = slstm_dims(shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wx = (0.5 * torch.randn((b, s, h, 4 * dh), generator=gen, device=dev)
          ).to(wx_dtype)
    r_w = torch.randn((h, dh, 4 * dh), generator=gen, device=dev) / dh ** 0.5
    fb = torch.full((h, dh), 3.0, device=dev)
    zero = torch.zeros((b, h, dh), device=dev)
    if state == "fresh":
        st = [zero, zero.clone(), torch.full_like(zero, -1e30), zero.clone()]
    elif state == "admitted":
        st = [zero, zero.clone(), zero.clone(), zero.clone()]
    else:
        st = [torch.randn((b, h, dh), generator=gen, device=dev),
              1.0 + torch.rand((b, h, dh), generator=gen, device=dev),
              torch.randn((b, h, dh), generator=gen, device=dev),
              0.5 * torch.randn((b, h, dh), generator=gen, device=dev)]
    return [wx, r_w, fb] + st


def slstm_bound(shape, wx_dtype):
    """Least time of one call: wx, R, fbias and the state read once, hs and
    the state written once, at the memory rate; against the product's
    2 B S H dh 4dh and 31 operations per (row, step, unit) at the float32
    rate (``roofline.slstm_work``)."""
    wx_bytes = 2 if wx_dtype == torch.bfloat16 else 4
    return bound(*roofline().slstm_work(slstm_dims(shape), wx_bytes))


def check_slstm_parity(ref, dev):
    """B9 against its plain version on the same card tensors at every
    SLSTM_CHECKS shape: max |err| of hs and of each final state, each
    within SLSTM_TOL of max|hs|; a second call equal bit for bit. Returns
    the largest max |err|."""
    from repro_torch.kernels.slstm_cell import cluster_size, slstm_cell_cuda

    worst = 0.0
    for seed, (label, (shape, wx_dtype, state)) in enumerate(
            SLSTM_CHECKS.items()):
        args = slstm_inputs(dev, shape, wx_dtype, state, seed)
        got = slstm_cell_cuda(*args)
        again = slstm_cell_cuda(*args)
        want = ref.slstm_cell_ref(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(
            (got[0],) + got[1], (again[0],) + again[1])), f"{label}: repeat"
        hmax = float(want[0].abs().max())
        errs = [float((got[0] - want[0]).abs().max())] + [
            float((a - b).abs().max()) for a, b in zip(got[1], want[1])]
        rel = [e / hmax for e in errs]
        assert all(np.isfinite(float(x.float().abs().max()))
                   for x in (got[0],) + tuple(got[1])), label
        if not max(rel) <= SLSTM_TOL:
            raise AssertionError(f"slstm_cell {label}: max |err| / max|hs| "
                                 f"{rel} > {SLSTM_TOL}")
        worst = max(worst, max(errs))
        log(f"parity slstm_cell {label} (cluster of "
            f"{cluster_size(slstm_dims(shape)[3])}): max |err| / max|hs| "
            f"({hmax:.4f}): hs {rel[0]:.3e}, c {rel[1]:.3e}, n {rel[2]:.3e}, "
            f"m {rel[3]:.3e}, h {rel[4]:.3e}; a second call equal bit for "
            f"bit")
        del args, got, again, want
    return worst


def time_slstm(ref, dev):
    """Device time (profiler), time per call (CUDA events), plain time and
    bound of B9 at the lockstep prefill and paged chunk shapes; the main
    path's (the bf16 paged chunk) is returned for the kernels line. Then
    the (8, 700) prefill with each number of batch rows per cluster, beside
    the wrapper's choice."""
    from repro_torch.kernels import slstm_cell as sc
    from repro_torch.kernels.slstm_cell import slstm_cell_cuda

    out = {}
    for label in ("lockstep prefill (8, 700) bf16, m0 -1e30",
                  "paged chunk (1, 64) bf16, m0 0",
                  "paged chunk (1, 64) f32, m0 0"):
        shape, wx_dtype, state = SLSTM_CHECKS[label]
        args = slstm_inputs(dev, shape, wx_dtype, state, 99)
        reps = 5 if shape[1] > 100 else 50
        t = {"ms": time_ms(lambda: slstm_cell_cuda(*args), reps, 3),
             "plain_ms": time_ms(lambda: ref.slstm_cell_ref(*args), 2, 3),
             "bound": slstm_bound(shape, wx_dtype), "library_ms": None}
        _, acts = device_times(lambda: slstm_cell_cuda(*args), 5)
        hits = [(c, ms) for k, (c, ms) in acts.items()
                if "slstm_cluster_kernel" in k]
        t["device_ms"] = (sum(ms for _, ms in hits)
                          / sum(c for c, _ in hits)) if hits else None
        steps = shape[1]
        log(f"time slstm_cell {label}: per call {t['ms']:.4f} ms (device "
            f"only {t['device_ms']} ms, {1e3 * t['ms'] / steps:.3f} us per "
            f"step), plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound'][0]:.5f} ms ({t['bound'][1]}); no single PyTorch "
            f"call computes this cell")
        out[label] = t
        del args
    label = "lockstep prefill (8, 700) bf16, m0 -1e30"
    shape, wx_dtype, state = SLSTM_CHECKS[label]
    b, s, h, dh = slstm_dims(shape)
    args = slstm_inputs(dev, shape, wx_dtype, state, 99)
    fit = sc.max_clusters(dev, h, dh, sc.cluster_size(dh), True)
    line = []
    for rows in sc.ROW_CHOICES:
        fn = lambda: slstm_cell_cuda(*args, rows=rows)
        line.append(f"{rows}: {device_ms(fn, 5)} / {time_ms(fn, 5, 3):.4f}")
    log(f"time slstm_cell {label} by batch rows per cluster (device / per "
        f"call ms; {fit} clusters of {sc.cluster_size(dh)} fit the card at "
        f"once, the wrapper takes {sc.rows_per_cluster(b, h, fit)}): "
        + ", ".join(line))
    return out[SLSTM_MAIN]


def xlstm_state_errors(cache, ref_cache):
    """max |a - b| / max|b| over every cache leaf of every layer."""
    worst = {}
    for key in ref_cache["units"]:
        for name, want in ref_cache["units"][key].items():
            got = cache["units"][key][name]
            scale = float(want.abs().max())
            worst[f"{key}.{name}"] = float((got - want).abs().max()) / scale
    return worst


def xlstm_prefill_full_width(ops, dev, cfg, params):
    """A full-width xlstm-125m prefill forward of (8, 700) tokens into
    fresh contiguous caches through ``registry.apply_model``, with the
    serving route (B9, 6 launches) and with ``slstm_apply(use_kernel=
    False)`` (the port's time loop): logits and every layer's final state,
    bf16 activations to 4e-2 of the largest value (bf16 rounds the sLSTM
    output into the next layer, so a float32 difference in the cell can
    flip a bf16 step), float32 activations to 1e-4."""
    from repro_torch.models import registry, xlstm

    real = xlstm.slstm_apply
    b, s = XLSTM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)

    def forward(c, route):
        cache = registry.init_cache(c, b, 0, device=dev)
        if route == "loop":
            xlstm.slstm_apply = lambda *a, **k: real(
                *a, **{**k, "use_kernel": False})
        try:
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = registry.apply_model(params, c, {"tokens": toks},
                                              caches=cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            xlstm.slstm_apply = real
        return logits, cache, wall, ops.launches["slstm_cell"]

    for dtype, tol, rounds in (("bfloat16", 4e-2, 2), ("float32", 1e-4, 1)):
        c = cfg.with_overrides(dtype=dtype)
        runs = {}
        for _ in range(rounds):
            for route in ("B9", "loop"):
                runs[route] = forward(c, route)
        (lk, ck, tk, nk), (ll, cl, tl, nl) = runs["B9"], runs["loop"]
        # one launch per sLSTM layer: 6 at xlstm-125m's 12 layers
        assert (nk, nl) == (cfg.block_kinds.count("slstm"), 0), (nk, nl)
        lk, ll = lk.float(), ll.float()
        assert bool(torch.isfinite(lk).all()), "non-finite logits"
        assert tuple(lk.shape) == (b, s, cfg.vocab_size)
        err = float((lk - ll).abs().max()) / float(ll.abs().max())
        st = xlstm_state_errors(ck, cl)
        agree = float((lk[:, -1].argmax(-1) == ll[:, -1].argmax(-1)
                       ).float().mean())
        log(f"xlstm prefill {b}x{s} {dtype}: B9 route {tk * 1e3:.1f} ms "
            f"({nk} B9 launches), time loop {tl * 1e3:.1f} ms; logits max "
            f"|diff| / max|logit| {err:.3e}, last-token argmax agree "
            f"{agree:.3f}; worst final state {max(st.values()):.3e} "
            f"({max(st, key=st.get)}); tolerance {tol}")
        if not (err <= tol and max(st.values()) <= tol):
            raise AssertionError(f"xlstm prefill {dtype}: logits {err:.3e},"
                                 f" states {st}")
        del runs, lk, ll, ck, cl
        torch.cuda.empty_cache()


def admit_fresh_m(real):
    """``paging.admit_slot`` (``real``) followed by setting the admitted
    slot's stabilizer ``m`` to -1e30 in every recurrent block, where the
    JAX package's admission leaves it at 0."""
    def admit(cache, slot, row, fresh_row=None):
        real(cache, slot, row, fresh_row)
        for c in cache["units"].values():
            if "m" in c:
                c["m"][:, slot] = -1e30
        return cache

    return admit


def serve_xlstm_full_width(ops, dev):
    """xlstm-125m at full width (random float32 weights from seed 0)
    through the port's paged scheduler: the prefill forward with B9
    against the time loop; the 16-request greedy stream (B9 at (1, 64) on
    every bulk prefill chunk) in bf16 and float32 activations, four
    requests held to the same request served alone, the lockstep engine on
    equal-length waves beside it (not a gate: the paged admission zeroes
    m, ROADMAP C); the float32 stream with m at -1e30 from each admission
    held to the lockstep engine (a gate); one decode tick and one prefill
    chunk profiled."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    cfg = base.get_config("xlstm-125m")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_slstm = cfg.block_kinds.count("slstm")
    log(f"serve xlstm-125m: {registry.count_params(cfg)} float32 parameters"
        f" on the card in {time.perf_counter() - t0:.1f} s; {n_slstm} sLSTM "
        f"layers")
    t0 = time.perf_counter()
    xlstm_prefill_full_width(ops, dev, cfg, params)
    log(f"xlstm prefill forwards: {time.perf_counter() - t0:.1f} s")

    lens = list(SERVE_LENS) * (SERVE_REQUESTS // len(SERVE_LENS))
    prompts = serve.make_prompts(cfg, lens, 0)
    geom = dict(SERVE_GEOM)
    scfg = ServeConfig(num_pages=2 * geom["max_seqs"] * geom["pages_per_seq"],
                       kv_bits=32, **geom)
    launches = None
    for dtype in ("bfloat16", "float32"):
        c = cfg.with_overrides(dtype=dtype)
        sched, outs, l1, wall = serve_stream(
            Scheduler, c, params, dev, prompts, SERVE_NEW, scfg, ops,
            record_top=TOP_K)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {k: 0 for k in ops.KERNELS}
        want["slstm_cell"] = n_slstm * sched.prefill_chunks
        assert l1 == want, (l1, sched.prefill_chunks)
        if launches is None:
            launches = l1
        ticks = np.asarray(list(sched.decode_step_s)) * 1e3
        pre = float(np.sum(list(sched.prefill_chunk_s)))
        log(f"serve xlstm {dtype} stream: {wall:.2f} s wall, {sched.steps} "
            f"ticks, {sched.decode_steps} decode ticks (median "
            f"{np.median(ticks):.3f} ms, p90 {np.percentile(ticks, 90):.3f} "
            f"ms), {sched.decode_tokens / (ticks.sum() / 1e3):.1f} decode "
            f"tokens/s ({sched.decode_tokens} tokens fed by decode ticks), "
            f"{SERVE_REQUESTS * SERVE_NEW / wall:.1f} generated tokens/s end "
            f"to end, prefill {sched.prefill_tokens} tokens in "
            f"{sched.prefill_chunks} chunks ({1e3 * pre / sched.prefill_chunks:.3f}"
            f" ms each), {sched.prefill_tokens / pre:.1f} prefill tokens/s; "
            f"peak device memory {peak_gb:.2f} GB; final pages in use 0; "
            f"B9 launches {l1['slstm_cell']} = {n_slstm} x "
            f"{sched.prefill_chunks} bulk chunks")
        got, alone = {}, {}
        for i in XLSTM_ALONE:
            s1, o1, l2, _ = serve_stream(Scheduler, c, params, dev,
                                         [prompts[i]], SERVE_NEW, scfg, ops,
                                         record_top=TOP_K)
            assert l2["slstm_cell"] == n_slstm * s1.prefill_chunks, l2
            alone[i] = (o1[0], (np.stack([v for v, _ in s1.top[0]]),
                                np.stack([t for _, t in s1.top[0]])))
            got[i] = (outs[i], (np.stack([v for v, _ in sched.top[i]]),
                                np.stack([t for _, t in sched.top[i]])))
        n_div = first_divergence(f"xlstm {dtype} alone", got, alone,
                                 dtype == "bfloat16")
        log(f"serve xlstm {dtype}: requests {list(XLSTM_ALONE)} (prompts "
            f"{[lens[i] for i in XLSTM_ALONE]}) served alone: "
            f"{len(XLSTM_ALONE) - n_div} equal token for token, {n_div} "
            f"part at a near-tie")
        lock = compare_with_lockstep(f"serve xlstm {dtype}", c, params,
                                     dev, prompts, SERVE_NEW, sched, outs, 2,
                                     gate=False)
        del sched

    # the float32 stream again with m set to -1e30 at each admission, as a
    # fresh contiguous cache starts: the only difference left from the
    # lockstep engine's start, so held to it with the gate on
    real = paging.admit_slot
    paging.admit_slot = admit_fresh_m(real)
    try:
        sched, outs, l1, _ = serve_stream(Scheduler, c, params, dev, prompts,
                                          SERVE_NEW, scfg, ops,
                                          record_top=TOP_K)
    finally:
        paging.admit_slot = real
    assert l1["slstm_cell"] == n_slstm * sched.prefill_chunks, l1
    compare_with_lockstep("serve xlstm float32, m -1e30 at admission", c,
                          params, dev, prompts, SERVE_NEW, sched, outs, 2,
                          want=lock)
    del sched

    # one steady-state decode tick (8 active sequences) and one bulk
    # prefill chunk (1, 64) under the profiler, bf16 activations
    s4 = Scheduler(cfg, params, scfg, device=dev)
    for p in prompts[:geom["max_seqs"]]:
        s4.submit(p, 8)
    chunk = geom["prefill_chunk"]
    toks = np.asarray(prompts[4][:chunk], np.int32)[None]
    pos = np.arange(chunk, dtype=np.int32)[None]
    with torch.no_grad():
        s4.step()
        s4.step()
        for name, fn in (("decode tick (8 sequences)", s4.step),
                         (f"prefill chunk (1, {chunk})",
                          lambda: s4._prefill_chunk(0, toks, pos))):
            wall_ms, acts = device_times(fn)
            busy_ms = sum(t for _, t in acts.values())
            log(f"profile xlstm 1 {name}: wall {wall_ms:.3f} ms, device "
                f"activities {busy_ms:.3f} ms ({100.0 * busy_ms / wall_ms:.1f}"
                f"% of wall), {sum(c for c, _ in acts.values())} device "
                f"activities")
            for key, (n, t) in sorted(acts.items(),
                                      key=lambda r: -r[1][1])[:10]:
                log(f"profile   {t:10.3f} ms  x{n:<6d} {key[:80]}")
        s4.run()
    del s4, params
    torch.cuda.empty_cache()
    return launches


# the FSDP-Adam baseline: tinyllama-1.1b at full width (arXiv:2401.02385)
FSDP_STEPS = 5
FSDP_FLAGS = ["--arch", "tinyllama-1.1b", "--mode", "fsdp", "--batch", "8",
              "--seq", "512", "--lr", "1e-3", "--steps", str(FSDP_STEPS),
              "--log-every", "1"]


def profile_busy(name, fn, top=10):
    """One call of ``fn`` under the profiler: its wall, device-busy share
    and top device activities."""
    wall_ms, acts = device_times(fn)
    busy_ms = sum(t for _, t in acts.values())
    log(f"profile {name}: wall {wall_ms:.1f} ms, device activities "
        f"{busy_ms:.1f} ms ({100.0 * busy_ms / wall_ms:.1f}% of wall), "
        f"{sum(c for c, _ in acts.values())} device activities")
    for key, (c, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:top]:
        log(f"profile   {t:10.3f} ms  x{c:<6d} {key[:80]}")


def fsdp_full_width(ops, dev):
    """Phase 18: the FSDP-Adam baseline on tinyllama-1.1b at full width
    through the trainer's entry point: a finite loss every step, the last
    below step 0's, no kernel of the port launched (its products are
    torch.matmul); s/step, peak memory, one more step profiled."""
    from repro_torch.configs import base
    from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig

    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train.main(FSDP_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    hist = out["history"]
    assert len(hist) == FSDP_STEPS and np.isfinite(hist).all(), hist
    assert hist[-1] < hist[0], hist
    assert not any(launches.values()), launches
    secs = out["step_seconds"]
    log(f"fsdp tinyllama-1.1b batch 8 x seq 512, AdamW lr 1e-3: loss "
        f"{' -> '.join(f'{x:.4f}' for x in hist)}; s/step "
        f"{', '.join(f'{x:.3f}' for x in secs)} (median after step 0 "
        f"{statistics.median(secs[1:]):.3f}; wall {wall:.1f} s with init); "
        f"peak device memory {out['peak_device_bytes'] / 1e9:.2f} GB; "
        f"launches of the port's kernels {sum(launches.values())}")
    args = train.build_parser().parse_args(FSDP_FLAGS)
    cfg = base.get_config(args.arch)
    step = train.fsdp_step(cfg, AdamWConfig(lr=args.lr))
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, args.seq,
                                         seed=args.seed))
    batch = model_batch(cfg, data.batch(FSDP_STEPS, args.batch), dev)
    holder = {"p": out["params"], "o": out["opt"]}
    del out

    def one_step():
        holder["p"], holder["o"], _ = step(holder["p"], holder["o"], batch)

    profile_busy("1 fsdp step (tinyllama-1.1b, 8 x 512)", one_step)
    holder.clear()
    torch.cuda.empty_cache()


# production-load serving of tinyllama-1.1b at full width: phase 15's
# lengths behind one 512-token system prompt, the list served twice
# verbatim (four duplicates are page-aligned: 608, 640, 896, 1,024 tokens)
LOAD_PREFIX, LOAD_REPEAT, LOAD_PPS, LOAD_DEFRAG = 512, 2, 84, 32
LOAD_ASYNC, LOAD_ASYNC_NEW = 8, 32


def load_run(name, cfg, params, dev, prompts, scfg, ops, priorities=None):
    """Serve ``prompts`` (``SERVE_NEW`` tokens each) through a fresh
    scheduler with the counts and the peak mark set just before: 0 pages
    in use after, every decode tick through B7 (22 launches a tick).
    Prints the run's latency and paging numbers; returns (scheduler,
    outputs, launches)."""
    from repro_torch.serving.scheduler import Scheduler

    sched, outs, launches, wall = serve_stream(
        Scheduler, cfg, params, dev, prompts, SERVE_NEW, scfg, ops,
        record_top=TOP_K, priorities=priorities)
    want = {k: 0 for k in ops.KERNELS}
    want["paged_attention_decode"] = cfg.num_layers * sched.decode_steps
    assert launches == want, (name, launches, sched.decode_steps)
    ticks = np.asarray(list(sched.decode_step_s)) * 1e3
    itl = np.asarray(list(sched.itl_s)) * 1e3
    ttft = np.asarray(list(sched.ttft_s.values())) * 1e3
    queue = np.asarray(list(sched.ttft_queue_s.values())) * 1e3
    log(f"load {name} ({scfg.cache_dtype} pools): {wall:.2f} s wall, "
        f"{sched.steps} ticks, "
        f"{sched.decode_steps} decode ticks (median "
        f"{np.median(ticks):.3f} ms, p90 {np.percentile(ticks, 90):.3f} ms)"
        f", {len(prompts) * SERVE_NEW / wall:.1f} generated tokens/s end to "
        f"end, {sched.decode_tokens / (ticks.sum() / 1e3):.1f} decode "
        f"tokens/s; TTFT p50 {np.median(ttft):.1f} ms (queueing "
        f"{np.median(queue):.1f} ms); ITL p50 {np.median(itl):.3f} ms, p99 "
        f"{np.percentile(itl, 99):.3f} ms; prefill {sched.prefill_chunks} "
        f"chunks; shared_page_hits {sched.shared_page_hits}, cow_forks "
        f"{sched.cow_forks}, preemptions {sched.preemptions}, "
        f"forced_preemptions {sched.forced_preemptions}, "
        f"pages_alloc_events {sched.pages_alloc_events}, peak pages "
        f"{sched.peak_pages_in_use} of {scfg.num_pages}, final 0; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return sched, outs, launches


def load_streams(sched, outs):
    """Each request's (tokens, (top-k values, top-k ids)) by submission
    index (request ids of a fresh scheduler are 0, 1, ...)."""
    assert sorted(sched.top) == list(range(len(outs)))
    return {r: (outs[r], (np.stack([v for v, _ in sched.top[r]]),
                          np.stack([t for _, t in sched.top[r]])))
            for r in range(len(outs))}


def serve_production_load(ops, dev):
    """Phase 19: the production-load stream through the port's scheduler
    (prefix sharing, watermark admission, recompute and swap preemption,
    defrag, the AsyncServer), each run held against the reservation FIFO
    reference (a); B7 on every decode tick over aliased and forked pages.
    Returns B7's launches over run (b)."""
    import asyncio

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving.scheduler import (AsyncServer, Scheduler,
                                               ServeConfig)

    cfg = base.get_config("tinyllama-1.1b")
    torch.cuda.empty_cache()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = serve.make_prompts(cfg, list(SERVE_LENS), 0,
                                 prefix_len=LOAD_PREFIX) * LOAD_REPEAT
    lens = [len(p) for p in prompts]
    assert max(lens) + SERVE_NEW <= LOAD_PPS * 16
    log(f"load tinyllama-1.1b: {len(prompts)} requests behind a "
        f"{LOAD_PREFIX}-token system prompt, lengths {lens}, {SERVE_NEW} "
        f"new tokens each; page-aligned duplicates "
        f"{sorted({n for n in lens if n % 16 == 0})}")
    geom = dict(max_seqs=8, page_size=16, pages_per_seq=LOAD_PPS,
                prefill_chunk=64, kv_bits=32, cache_dtype="float32")
    roomy = 2 * geom["max_seqs"] * LOAD_PPS
    tight = 4 * LOAD_PPS
    prio = [i % 2 for i in range(len(prompts))]
    runs = {
        "(a) reservation FIFO": (dict(num_pages=roomy), None),
        "(b) + share_prefix": (dict(num_pages=roomy, share_prefix=True),
                               None),
        "(c) preempt recompute": (dict(num_pages=tight, preempt=True,
                                       decode_watermark=2), prio),
        "(d) preempt swap": (dict(num_pages=tight, preempt=True,
                                  decode_watermark=2, preempt_mode="swap"),
                             prio),
        "(e) share + preempt + defrag": (dict(
            num_pages=tight, preempt=True, decode_watermark=2,
            share_prefix=True, defrag_every=LOAD_DEFRAG), prio),
    }
    # each run's counters are kept, not its scheduler: its pools are freed
    # before the next run, whose peak device memory is then its own
    got, scheds, b7 = {}, {}, 0
    for name, (kw, pr) in runs.items():
        traced = name.startswith("(b)")     # (b) runs with a tracer on
        path = TRACE_DIR / "load_b.json"
        if traced:
            TRACE_DIR.mkdir(parents=True, exist_ok=True)
            obs_trace.enable(str(path))
        try:
            sched, outs, launches = load_run(
                name, cfg, params, dev, prompts, ServeConfig(**geom, **kw),
                ops, pr)
            if traced:
                obs_trace.save()
        finally:
            obs_trace.disable(save=False)
        if traced:
            load_b_traced_checks(sched, launches, path)
        got[name] = load_streams(sched, outs)
        scheds[name] = types.SimpleNamespace(**{
            k: getattr(sched, k) for k in ("shared_page_hits", "cow_forks",
                                           "peak_pages_in_use",
                                           "preemptions")})
        if name.startswith("(b)"):
            b7 = launches["paged_attention_decode"]
        if name.startswith("(d)"):
            assert sched.swap_dir is not None, "no swap-out happened"
            assert os.listdir(sched.swap_dir) == [], sched.swap_dir
            os.rmdir(sched.swap_dir)
        del sched
    a, b = scheds["(a) reservation FIFO"], scheds["(b) + share_prefix"]
    assert b.shared_page_hits > 0 and b.cow_forks > 0
    assert b.peak_pages_in_use < a.peak_pages_in_use, (
        b.peak_pages_in_use, a.peak_pages_in_use)
    for name in list(runs)[2:]:
        assert scheds[name].preemptions > 0, name
    ref_name = "(a) reservation FIFO"
    for name in list(runs)[1:]:
        n_div = first_divergence(f"load {name}", got[name], got[ref_name],
                                 True)
        same = sum(int((got[name][i][0] == got[ref_name][i][0]).all())
                   for i in got[name])
        log(f"load {name} against (a): {same} of {len(prompts)} requests "
            f"equal token for token, {n_div} part at a near-tie")
    scheds.clear()

    # (a) and (b) with float32 activations and pools: part only at a
    # top-2 gap <= GAP_TOL
    cfg32 = cfg.with_overrides(dtype="float32")
    g32 = {}
    for name, kw in (("(a) float32", dict(num_pages=roomy)),
                     ("(b) float32", dict(num_pages=roomy,
                                          share_prefix=True))):
        sched, outs, _ = load_run(name, cfg32, params, dev, prompts,
                                  ServeConfig(**geom, **kw), ops)
        g32[name] = load_streams(sched, outs)
        del sched
    n_div = first_divergence("load float32 (b)", g32["(b) float32"],
                             g32["(a) float32"], False)
    log(f"load float32 (b) against (a): {n_div} requests part (at a top-2 "
        f"gap <= {GAP_TOL})")

    # eight requests of (b) through the AsyncServer from concurrent tasks,
    # against Scheduler.run on the same requests: the same host decisions
    # run the same device programs
    scfg = ServeConfig(**geom, num_pages=roomy, share_prefix=True)
    sync = Scheduler(cfg, params, scfg, device=dev)
    rids = [sync.submit(p, LOAD_ASYNC_NEW) for p in prompts[:LOAD_ASYNC]]
    with torch.no_grad():
        want = sync.run()
    want = [want[r] for r in rids]

    async def clients():
        server = AsyncServer(Scheduler(cfg, params, scfg, device=dev))
        return await asyncio.gather(*[
            server.generate(p, LOAD_ASYNC_NEW) for p in prompts[:LOAD_ASYNC]])

    t0 = time.perf_counter()
    with torch.no_grad():
        async_out = asyncio.run(clients())
    wall = time.perf_counter() - t0
    assert all(np.array_equal(x, y) for x, y in zip(async_out, want))
    log(f"load AsyncServer: {LOAD_ASYNC} concurrent requests x "
        f"{LOAD_ASYNC_NEW} tokens in {wall:.2f} s, equal to Scheduler.run "
        f"bit for bit")
    del sync, params
    torch.cuda.empty_cache()
    return b7



# slice 10: narrowed replicas (hat_dtype) through B2, B6 and B3, and the
# observability layer behind --trace
NARROW = (torch.bfloat16, torch.float16)
TRACE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_traces"
# B2 shapes (M, N, d, storage offset of V in values) of the narrowed
# checks: the convex path, the LM trainer's buffer, 1,024 workers, and a
# ragged V one value into its buffer (rows off the 16-byte boundary)
NARROW_MIX = {"convex (64, 64) x (64, 2000)": (64, 64, 2000, 0),
              "LM (4, 4) x (4, 134277912)": (4, 4, LM_DIM, 0),
              "(1024, 1024) x (1024, 2000)": (1024, 1024, 2000, 0),
              "ragged misaligned (12, 24) x (24, 513)": (12, 24, 513, 1)}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@contextlib.contextmanager
def operand_dtypes(ops, names):
    """Record the storage dtype each named ``ops`` entry point is handed
    (the values of a mix, q_hat_prev of a quantize round) while the real
    entry point runs and counts its launches as ever."""
    pos = {"bipartite_mix": 1, "edge_gather_mix": 0, "stoch_quantize": 1,
           "stoch_quantize_grouped_fused": 1}
    seen = {n: [] for n in names}
    real = {n: getattr(ops, n) for n in names}

    def spy(n):
        def call(*a, **kw):
            seen[n].append(a[pos[n]].dtype)
            return real[n](*a, **kw)
        return call

    for n in names:
        setattr(ops, n, spy(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(ops, n, real[n])


def narrow_values(n, d, offset, dtype, seed, dev):
    """A contiguous (N, d) V of ``dtype`` starting ``offset`` values into
    its buffer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = (3.0 * torch.randn(n * d + offset, generator=gen,
                             device=dev)).to(dtype)
    return buf[offset:].view(n, d)


def check_narrow_parity(ops, dev):
    """Narrowed B2, B6 and B3 against their float32 routes on the card,
    bit for bit, in bf16 and f16: B2(A, V) == B2(A, V.float()).to(dtype),
    B6(V) == B6(V.float()), B3 with a narrowed q_prev == B3 on
    q_prev.float() with out rounded to the storage type and the (N, G)
    outputs equal."""
    from repro_torch.core import graph as G
    from repro_torch.kernels import edge_gather_mix as EG

    gen = torch.Generator(device=dev).manual_seed(21)
    for label, (m, n, d, off) in NARROW_MIX.items():
        adj = (torch.rand((m, n), generator=gen, device=dev) < 0.35).float()
        for dt in NARROW:
            vals = narrow_values(n, d, off, dt, m + off, dev)
            got = ops.bipartite_mix(adj, vals)
            want = ops.bipartite_mix(adj, vals.float()).to(dt)
            assert got.dtype == dt and torch.equal(got, want), (label, dt)
            del vals, got, want
        log(f"parity narrowed bipartite_mix {label}: bf16 and f16 equal "
            f"the float32 kernel rounded once, bit for bit")
        torch.cuda.empty_cache()

    for seed, (label, (graph, d)) in enumerate(edge_cases().items()):
        table, valid = (torch.from_numpy(x).to(dev)
                        for x in graph.neighbor_table)
        for dt in NARROW:
            vals = narrow_values(graph.n, d, 0, dt, seed, dev)
            got = ops.edge_gather_mix(vals, table, valid)
            want = ops.edge_gather_mix(vals.float(), table, valid)
            assert torch.equal(got, want), (label, dt)
            del vals, got, want
        p16 = EG.plan(graph.n, table.shape[1], d, True, elem=2)
        p32 = EG.plan(graph.n, table.shape[1], d, True)
        assert p16._replace(smem=0) == p32._replace(smem=0), label
        log(f"parity narrowed edge_gather_mix {label}: bf16 and f16 V equal "
            f"the float32 kernel on V.float(), bit for bit ({p16.regime} "
            f"as float32, shared memory {p16.smem} B against {p32.smem})")
        torch.cuda.empty_cache()
    g = G.random_bipartite_graph(6, 0.5, seed=1)
    table, valid = (x.copy() for x in g.neighbor_table)
    pads = valid == 0
    table[pads] = np.resize(np.array([7, -3, 100, -1], np.int32),
                            int(pads.sum()))
    args = (torch.from_numpy(table).to(dev), torch.from_numpy(valid).to(dev))
    for dt in NARROW:
        vals = torch.randn((6, 1001), device=dev).to(dt)
        vals[0, 2], vals[5, 1] = float("nan"), float("inf")
        got = ops.edge_gather_mix(vals, *args)
        want = ops.edge_gather_mix(vals.float(), *args)
        nan = want.isnan()
        assert bool(nan.any()) and torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan], want[~nan]), dt
    log("parity narrowed edge_gather_mix poisoned table: bf16 and f16 equal "
        "the float32 kernel (NaN where it has NaN, the rest bit for bit)")

    layouts = grouped_layouts()
    for label in ("xlstm-125m (4, 134277912) G=19", "ragged (5, 4099) G=3"):
        n, dims, gids, degen = layouts[label]
        args, pk = grouped_inputs(dev, n, dims, gids, 5, ())
        theta, qprev = args[0], args[1]
        kw = dict(group_runs=pk.group_runs, **GROUPED_KW)
        for dt in NARROW:
            qn = qprev.to(dt)
            th = theta.clone()
            for row, grp in degen:      # theta equals the stored replica
                for off, size in pk.group_runs[grp]:
                    th[row, off:off + size] = qn[row, off:off + size].float()
            got = ops.stoch_quantize_grouped_fused(th, qn, *args[2:], None,
                                                   **kw)
            want = ops.stoch_quantize_grouped_fused(th, qn.float(),
                                                    *args[2:], None, **kw)
            assert got[0].dtype == dt
            assert torch.equal(got[0], want[0].to(dt)), (label, dt)
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b), (label, dt)
            for row, grp in degen:
                for off, size in pk.group_runs[grp]:
                    assert torch.equal(got[0][row, off:off + size],
                                       qn[row, off:off + size]), label
            del qn, th, got, want
        log(f"parity narrowed stoch_quantize_grouped_fused {label}: bf16 and "
            f"f16 q_hat equal the float32 kernel on q_hat.float(), out "
            f"rounded once and the (N, G) outputs bit for bit; degenerate "
            f"groups {degen} keep q_hat")
        del args, theta, qprev
        torch.cuda.empty_cache()


def narrow_times(label, fns, b):
    """Device time (profiler, all activities of one call) and time per
    call (CUDA events) of each entry of ``fns``, printed beside the bound
    ``b``; returns them by name."""
    t = {}
    for name, fn in fns.items():
        t[name] = (device_ms(fn, 10), time_ms(fn, 10, 5))
    log(f"time narrowed {label}: " + "; ".join(
        f"{name} device {dv} ms, per call {pc:.4f} ms"
        for name, (dv, pc) in t.items())
        + f"; bound {b[0]:.4f} ms ({b[1]})")
    return t


def time_narrow(ops, dev):
    """The narrowed kernels at the LM shape beside the float32 kernel, the
    route each replaces (the cast pass plus the float32 kernel; for B2 and
    B3 the cast back as well) and, for B2, torch.matmul in bf16."""
    from repro_torch.runtime import steps as ST

    out = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    adj = (torch.rand((4, 4), generator=gen, device=dev) < 0.6).float()
    vb = narrow_values(4, LM_DIM, 0, bf, 11, dev)
    v32 = vb.float()
    out["bipartite_mix"] = narrow_times(
        "bipartite_mix (4, 4) x (4, 134277912)", {
            "bf16 kernel": lambda: ops.bipartite_mix(adj, vb),
            "float32 kernel": lambda: ops.bipartite_mix(adj, v32),
            "replaced route (cast, float32 kernel, cast)":
                lambda: ops.bipartite_mix(adj, vb.float()).to(bf),
            "torch.matmul bf16": lambda: torch.matmul(adj.to(bf), vb)},
        bound(2.0 * (4 * LM_DIM + 4 * LM_DIM) + 4.0 * 16,
              2.0 * 16 * LM_DIM))
    graph = ST.worker_graph(4)
    table, valid = (torch.from_numpy(x).to(dev) for x in graph.neighbor_table)
    referenced = np.unique(graph.neighbor_table[0][
        graph.neighbor_table[1] > 0]).size
    out["edge_gather_mix"] = narrow_times(
        "edge_gather_mix (4, 134277912)", {
            "bf16 kernel": lambda: ops.edge_gather_mix(vb, table, valid),
            "float32 kernel": lambda: ops.edge_gather_mix(v32, table, valid),
            "replaced route (cast, float32 kernel)":
                lambda: ops.edge_gather_mix(vb.float(), table, valid)},
        bound(2.0 * referenced * LM_DIM + 4.0 * 4 * LM_DIM
              + 8.0 * table.numel(), 2.0 * int(valid.sum()) * LM_DIM))
    del vb, v32
    torch.cuda.empty_cache()
    n, dims, gids, _ = grouped_layouts()["xlstm-125m (4, 134277912) G=19"]
    args, pk = grouped_inputs(dev, n, dims, gids, 99, ())
    kw = dict(group_runs=pk.group_runs, **GROUPED_KW)
    qn = args[1].to(bf)
    rest = args[2:]
    n_el = args[0].numel()
    out["stoch_quantize_grouped_fused"] = narrow_times(
        "stoch_quantize_grouped_fused (4, 134277912) G=19", {
            "bf16 q_hat kernel": lambda: ops.stoch_quantize_grouped_fused(
                args[0], qn, *rest, None, **kw),
            "float32 kernel": lambda: ops.stoch_quantize_grouped_fused(
                args[0], args[1], *rest, None, **kw),
            "replaced route (cast, float32 kernel, cast)":
                lambda: ops.stoch_quantize_grouped_fused(
                    args[0], qn.float(), *rest, None, **kw)[0].to(bf)},
        bound(12.0 * n_el, roofline().QUANT_OPS_PER_ELEM * n_el))
    del args, qn, rest
    torch.cuda.empty_cache()
    return out


def full_size_bf16(ops, dev, prob, theta_star):
    """Phase 5's problem with bf16 replicas (``hat_dtype="bfloat16"``):
    the distance to the optimum falls, and every iteration makes exactly
    2 B1 launches (on float32 operands, the engine's casts) and 3 B2
    launches on bf16 values."""
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import engine as E
    from repro_torch.core.graph import random_bipartite_graph

    cfg = dataclasses.replace(ab.cq_ggadmm(rho=1.0), hat_dtype="bfloat16")
    graph = random_bipartite_graph(FULL_N, 0.35, seed=0)
    ops.reset_launches()
    t0 = time.perf_counter()
    with operand_dtypes(ops, ("bipartite_mix", "stoch_quantize")) as seen:
        state, out = E.run(graph, cfg, E.ExactSolver(prob),
                           torch.zeros((FULL_N, FULL_D), device=dev),
                           FULL_ITERS,
                           extra_metrics=E.flat_metrics(graph, device=dev))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize=2 * FULL_ITERS, bipartite_mix=3 * FULL_ITERS)
    assert launches == want, launches
    assert seen["bipartite_mix"] == [torch.bfloat16] * (3 * FULL_ITERS)
    assert seen["stoch_quantize"] == [torch.float32] * (2 * FULL_ITERS)
    for x in (state.theta_hat, state.alpha, state.quant.q_hat):
        assert x.dtype == torch.bfloat16
    dist = ((out["theta"] - theta_star[None, None]) ** 2).sum(
        dim=(1, 2)).cpu().numpy()
    assert np.isfinite(dist).all() and dist[-1] < dist[0], dist
    log(f"full cq-ggadmm bf16 replicas N={FULL_N} d={FULL_D}: "
        f"{wall / FULL_ITERS * 1e3:.2f} ms/iteration, dist-to-opt "
        f"{dist[0]:.4e} -> {dist[-1]:.4e}, bits "
        f"{float(out['payload_bits'].sum()):.4e}; launches {launches}, B2 "
        f"on bf16 values, B1 on float32")


def lm_bf16_traced(ops, dev, lm32):
    """Phase 10's training with bf16 replicas (``hat_dtype``, the library
    entry: ``train.main(..., hat_dtype=...)`` builds the engine config),
    traced: a finite loss, exactly 2 B3 and 3 B2 launches per step on
    bf16 q_hat and theta_hat, bf16 replica leaves; the trace valid with a
    round span a step, and the ledger equal to build_comm_log over the
    same tx_mask and payload_bits. Loss, s/step and peak memory beside
    phase 10's."""
    from repro_torch.core import comm
    from repro_torch.core import tree as T
    from repro_torch.launch import train
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime import steps as ST

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "lm_bf16.json"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with operand_dtypes(ops, ("bipartite_mix",
                                  "stoch_quantize_grouped_fused")) as seen:
            out = train.main(LM_FLAGS + ["--steps", str(LM_STEPS),
                                         "--trace", str(path)],
                             hat_dtype="bfloat16")
            torch.cuda.synchronize()
    finally:
        obs_trace.disable(save=False)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    assert np.isfinite(hist).all(), hist
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize_grouped_fused=2 * LM_STEPS,
                bipartite_mix=3 * LM_STEPS)
    assert launches == want, launches
    assert seen["bipartite_mix"] == [torch.bfloat16] * (3 * LM_STEPS)
    assert seen["stoch_quantize_grouped_fused"] == \
        [torch.bfloat16] * (2 * LM_STEPS)
    st = out["state"]
    for tree in (st.theta_hat, st.alpha, st.quant.q_hat):
        assert {x.dtype for x in T.leaves(tree)} == {torch.bfloat16}
    with open(path) as f:
        doc = json.load(f)
    errors = obs_trace.validate_events(doc)
    assert errors == [], errors[:5]
    spans = sum(e["ph"] == "B" and e["name"] == "round"
                for e in doc["traceEvents"])
    assert spans == LM_STEPS, spans
    ms = out["traced_metrics"]
    clog = comm.build_comm_log([m["tx_mask"] for m in ms],
                               [m["payload_bits"] for m in ms],
                               ST.worker_graph(4, "random"))
    led = out["ledger"]
    assert led["cum_transmissions"] == clog.cumulative_rounds[-1], led
    assert led["cum_bits"] == clog.cumulative_bits[-1], led
    log(f"lm xlstm-125m bf16 replicas (traced): loss "
        f"{' -> '.join(f'{x:.4f}' for x in hist)} (float32 replicas, phase "
        f"10: {' -> '.join(f'{x:.4f}' for x in lm32['history'])}); s/step "
        f"{', '.join(f'{x:.3f}' for x in out['step_seconds'])} (phase 10: "
        f"{', '.join(f'{x:.3f}' for x in lm32['step_seconds'])}; wall "
        f"{wall:.1f} s with init); peak device memory {peak_gb:.2f} GB "
        f"(phase 10: {lm32['peak_gb']:.2f} GB); launches {launches}, B2 "
        f"and B3 on bf16; trace {len(doc['traceEvents'])} events, "
        f"{spans} round spans, valid; ledger {led['cum_transmissions']:.0f} "
        f"transmissions, {led['cum_bits']:.6e} bits = build_comm_log")


def load_b_traced_checks(sched, launches, path):
    """Run (b) of phase 19 ran traced: its host decisions as recorded
    untraced (PERF.md section 5: 303 shared page hits, peak 455 pages, 108
    prefill chunks; 22 B7 launches on each of 382 decode ticks), the trace
    valid with every request span closed and a page_pool counter each
    tick."""
    from repro_torch.obs import trace as obs_trace

    with open(path) as f:
        doc = json.load(f)
    errors = obs_trace.validate_events(doc)
    assert errors == [], errors[:5]
    ev = doc["traceEvents"]
    requests = sum(e["ph"] == "B" and e["name"] == "request" for e in ev)
    closed = sum(e["ph"] == "E" and e["name"] == "request"
                 and not e.get("args", {}).get("truncated") for e in ev)
    pools = sum(e["ph"] == "C" and e["name"] == "page_pool" for e in ev)
    assert requests == closed == SERVE_REQUESTS, (requests, closed)
    assert pools == sched.steps, (pools, sched.steps)
    counters = (sched.shared_page_hits, sched.peak_pages_in_use,
                sched.prefill_chunks, sched.decode_steps,
                launches["paged_attention_decode"])
    assert counters == (303, 455, 108, 382, 8404), counters
    log(f"load (b) traced: {len(ev)} events, {requests} request spans all "
        f"closed, {pools} page_pool counters, valid; shared hits, peak "
        f"pages, prefill chunks, decode ticks, B7 launches {counters} as "
        f"untraced")


# the JAX package's rows of Figs. 2-5 at the target, (iters, bits), on the
# CPU with its own draws (seed 0), for the printout beside the port's
JAX_FIGURE_ROWS = {
    "fig2_linreg_synth": {"c-admm": (274, 4403200), "ggadmm": (87, 3340800),
                          "c-ggadmm": (111, 2092800),
                          "cq-ggadmm": (125, 1125318),
                          "q-ggadmm": (102, 807922)},
    "fig3_linreg_real": {"c-admm": (334, 956480), "ggadmm": (265, 2136960),
                         "c-ggadmm": (94, 358400), "cq-ggadmm": (153, 338134),
                         "q-ggadmm": (282, 1291340)},
    "fig4_logreg_synth": {"c-admm": (373, 10267200),
                          "ggadmm": (152, 5836800),
                          "c-ggadmm": (218, 4707200),
                          "cq-ggadmm": (224, 2587726),
                          "q-ggadmm": (151, 1614836)},
    "fig5_logreg_real": {"c-admm": (226, 1704896), "ggadmm": (74, 1449216),
                         "c-ggadmm": (78, 767040), "cq-ggadmm": (87, 409596),
                         "q-ggadmm": (75, 324808)},
}
FIGURES_DIR = Path(__file__).resolve().parent / "build" / "figures"


def start_figures():
    """Start the paper's figures, one ``repro_torch.bench.figures``
    process per figure on the card, all at once: each iteration is host-
    paced (a few small launches), so the five share the card and the host's
    cores. Each process runs its figure through the campaign runner as a
    one-run ``paper-figures`` campaign (the full campaign's run key), its
    results document and run state in a directory of its own. Returns the
    processes by figure; :func:`finish_figures` waits."""
    from repro_torch.bench import figures

    FIGURES_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = {}
    for fig in figures.ALL_FIGURES:
        path = FIGURES_DIR / f"{fig}.json"
        path.unlink(missing_ok=True)
        procs[fig] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.bench.figures", "--figures",
             fig, "--out", str(path), "--campaign-dir",
             str(FIGURES_DIR / fig)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path, time.perf_counter())
    return procs


def finish_figures(procs, dev):
    """Wait for the figures: every claim holds (the JAX campaign's gate),
    each figure's rows beside the JAX package's, B1 and B2 launched; then
    Theorem 3's certificate against the measured contraction. Returns the
    figures' launches, summed."""
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import cq_ggadmm as cq
    from repro_torch.core import theory
    from repro_torch.core.graph import random_bipartite_graph
    from repro_torch.core.solvers import LinearRegressionProblem
    from repro_torch.data import regression as R

    launches, failed = {}, []
    for fig, (proc, path, t0) in procs.items():
        out, _ = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        assert proc.returncode in (0, 1) and path.exists(), out[-3000:]
        with open(path) as f:
            v = json.load(f)[fig]
        jax_rows = JAX_FIGURE_ROWS.get(fig, {})
        log(f"figure {fig} (exit {proc.returncode}, done within {wall:.1f} "
            f"s): " + "; ".join(
                f"{s} {row['iters']} iters, {row['bits']} bits"
                + (f" (JAX package, CPU: {jax_rows[s][0]}, {jax_rows[s][1]})"
                   if s in jax_rows else "")
                for s, row in v["rows"].items()))
        assert v["claims"], (fig, out[-3000:])
        bad = [c for c, ok in v["claims"].items() if not ok]
        log(f"figure {fig} claims: {v['claims']}; launches "
            f"{ {k: n for k, n in v['launches'].items() if n} }")
        assert (proc.returncode == 1) == bool(bad), (proc.returncode, bad)
        failed += [f"{fig}_{c}" for c in bad]
        for k, n in v["launches"].items():
            launches[k] = launches.get(k, 0) + n
    log(f"figures: {len(procs)} figures, launches {launches}, failed claims "
        f"{failed}")
    assert not failed, failed
    assert launches["stoch_quantize"] > 0 and launches["bipartite_mix"] > 0

    data = R.synth_linear(n=720, d=12, seed=5)
    g = random_bipartite_graph(12, 0.4, seed=5)
    x, y = R.partition_uniform(data, 12)
    prob = LinearRegressionProblem(
        torch.as_tensor(x.astype(np.float32), device=dev),
        torch.as_tensor(y.astype(np.float32), device=dev))
    mu, lips = theory.linreg_convexity(np.asarray(x))
    rho = 1e-3
    cert = theory.best_rate_bound(g, mu, lips, rho=rho)
    assert cert is not None and cert.feasible
    _, out = cq.run(g, prob, ab.ggadmm(rho=rho), dim=prob.dim, iters=120,
                    theta_star=prob.optimum(), device=dev)
    d = np.maximum(out["dist_to_opt"], 1e-30)[10:80]
    measured = float((d[-1] / d[0]) ** (1.0 / (len(d) - 1)))
    log(f"theorem 3: certified rate {cert.rate:.9f} (rho_bar "
        f"{cert.rho_bar:.4e}, kappa {cert.kappa:.4e}) against the measured "
        f"contraction {measured:.9f} of ggadmm (12 workers, d 12, rho "
        f"{rho}, iterations 10-79)")
    assert measured <= cert.rate + 1e-6, (measured, cert.rate)
    return launches


GEMMA_LENS, GEMMA_NEW = (17, 300, 700, 1000, 1100, 1500, 2047, 2500), 64
DANUBE_LENS, DANUBE_NEW = (64, 700, 2000, 4600), 128


def serve_gemma3_full_width(ops, dev):
    """gemma3-4b at full width through the paged scheduler: B7/B8 on its
    five global layers every decode tick (hd 256), the SWA layers through
    the gather route; held against the lockstep engine."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    cfg = base.get_config("gemma3-4b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = serve.make_prompts(cfg, list(GEMMA_LENS), 0)
    pps = paging.pages_needed(max(GEMMA_LENS) + GEMMA_NEW, 16)
    scfg = ServeConfig(max_seqs=8, page_size=16, pages_per_seq=pps,
                       prefill_chunk=64, num_pages=8 * pps, kv_bits=32)
    log(f"serve gemma3-4b: {registry.count_params(cfg)} float32 parameters "
        f"in {time.perf_counter() - t0:.1f} s; prompts {GEMMA_LENS}, "
        f"{GEMMA_NEW} new tokens, window {cfg.sliding_window}, {pps}-page "
        f"tables")
    sched, outs, launches, wall = serve_stream(
        Scheduler, cfg, params, dev, prompts, GEMMA_NEW, scfg, ops,
        record_top=TOP_K)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_global = sum(k == "attn" for k in cfg.block_kinds)
    b78 = (launches["paged_attention_decode"]
           + launches["paged_attention_decode_online"])
    assert n_global == 5 and b78 == n_global * sched.decode_steps, (
        launches, sched.decode_steps)
    assert all(n == 0 for k, n in launches.items()
               if not k.startswith("paged_attention")), launches
    ticks = np.asarray(list(sched.decode_step_s)) * 1e3
    pre = float(np.sum(list(sched.prefill_chunk_s)))
    log(f"serve gemma3-4b paged stream: {wall:.2f} s wall, "
        f"{sched.decode_steps} decode ticks (median {np.median(ticks):.3f} "
        f"ms, p90 {np.percentile(ticks, 90):.3f} ms), prefill "
        f"{sched.prefill_tokens} tokens in {sched.prefill_chunks} chunks, "
        f"{sched.prefill_tokens / pre:.1f} prefill tokens/s; peak device "
        f"memory {peak_gb:.2f} GB; peak pages {sched.peak_pages_in_use}, "
        f"final 0; launches {launches} (= {n_global} x "
        f"{sched.decode_steps} decode ticks)")
    compare_with_lockstep("serve gemma3-4b", cfg, params, dev, prompts,
                          GEMMA_NEW, sched, outs, 1)
    del params, sched
    torch.cuda.empty_cache()
    return launches


def serve_danube_recycling(ops, dev):
    """h2o-danube-1.8b at full width with SWA page recycling against the
    same stream without it (watermark admission: pages are mapped as a
    sequence reaches them, so recycling lowers the peak)."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    cfg = base.get_config("h2o-danube-1.8b")
    torch.cuda.empty_cache()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = serve.make_prompts(cfg, list(DANUBE_LENS), 0)
    pps = paging.pages_needed(max(DANUBE_LENS) + DANUBE_NEW, 16)
    runs = {}
    for recycle in (False, True):
        scfg = ServeConfig(max_seqs=4, page_size=16, pages_per_seq=pps,
                           prefill_chunk=64, num_pages=4 * pps, kv_bits=32,
                           preempt=True, swa_recycle=recycle)
        sched, outs, launches, wall = serve_stream(
            Scheduler, cfg, params, dev, prompts, DANUBE_NEW, scfg, ops)
        assert all(n == 0 for n in launches.values()), launches
        ticks = np.asarray(list(sched.decode_step_s)) * 1e3
        log(f"serve h2o-danube-1.8b swa_recycle={recycle}: {wall:.2f} s "
            f"wall, {sched.decode_steps} decode ticks (median "
            f"{np.median(ticks):.3f} ms), {sched.prefill_chunks} prefill "
            f"chunks, recycled {sched.swa_recycled_pages} pages, peak pages "
            f"{sched.peak_pages_in_use} of {scfg.num_pages}, preemptions "
            f"{sched.preemptions}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, final 0")
        runs[recycle] = (sched.swa_recycled_pages, sched.peak_pages_in_use,
                         outs)
        del sched
    (n0, peak0, plain), (n1, peak1, recycled) = runs[False], runs[True]
    same = all(np.array_equal(a, b) for a, b in zip(plain, recycled))
    log(f"serve h2o-danube-1.8b: {registry.count_params(cfg)} float32 "
        f"parameters; recycling freed {n1} pages, peak {peak1} pages "
        f"against {peak0} without; tokens equal bit for bit: {same}")
    assert n0 == 0 and n1 > 0 and peak1 < peak0 and same
    del params
    torch.cuda.empty_cache()


def attention_consensus(ops, dev):
    """Consensus training of an attention model (tinyllama-smoke) through
    ``train.main``, 2 workers, 2 steps: a finite loss and the fused
    quantize and mix kernels."""
    from repro_torch.launch import train

    ops.reset_launches()
    out = train.main(["--arch", "tinyllama-1.1b", "--smoke", "--workers",
                      "2", "--batch", "2", "--seq", "16", "--steps", "2",
                      "--log-every", "1"])
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    assert np.isfinite(out["history"]).all(), out["history"]
    want = {k: 0 for k in ops.KERNELS}
    want.update(stoch_quantize_grouped_fused=4, bipartite_mix=6)
    assert launches == want, launches
    log(f"train tinyllama-smoke consensus (2 workers): loss "
        f"{' -> '.join(f'{x:.4f}' for x in out['history'])}, launches "
        f"{launches}")


# the MoE and Mamba2-hybrid families at full width: olmoe-1b-7b
# (arXiv:2409.02060, 64 experts top-8) and zamba2-7b (arXiv:2411.15242,
# 13 x (5 Mamba2 + the shared attention block) + 3 Mamba2), random float32
# weights from seed 0, bf16 activations and pages
FAMILY_LENS, FAMILY_NEW = (17, 300, 700, 1000, 1200, 1500, 1800, 2000), 64
FAMILY_GATED = 4         # requests held to the lockstep engine


def family_stream(ops, dev, cfg, params, prompts, new, cache_dtype,
                  label):
    """``prompts`` through the paged scheduler (8 slots, pages of 16,
    64-token chunks): exactly one B7 launch per attention-family layer per
    decode tick and no other kernel, 0 pages in use after; prints the
    stream's times. Returns (scheduler, outputs, launches)."""
    from repro_torch.models import blocks
    from repro_torch.serving import paging
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    pps = paging.pages_needed(max(len(p) for p in prompts) + new, 16)
    scfg = ServeConfig(max_seqs=8, page_size=16, pages_per_seq=pps,
                       prefill_chunk=64, num_pages=8 * pps, kv_bits=32,
                       cache_dtype=cache_dtype)
    sched, outs, launches, wall = serve_stream(
        Scheduler, cfg, params, dev, prompts, new, scfg, ops,
        record_top=TOP_K)
    n_attn = sum(k in blocks.ATTN_KINDS for k in cfg.block_kinds)
    want = {k: 0 for k in ops.KERNELS}
    want["paged_attention_decode"] = n_attn * sched.decode_steps
    assert launches == want, (launches, n_attn, sched.decode_steps)
    ticks = np.asarray(list(sched.decode_step_s)) * 1e3
    chunks = list(sched.prefill_chunk_s) or [0.0]
    pre = max(float(np.sum(chunks)), 1e-9)
    log(f"{label}: {wall:.2f} s wall, {sched.decode_steps} decode ticks "
        f"(median {np.median(ticks):.3f} ms, p90 "
        f"{np.percentile(ticks, 90):.3f} ms), "
        f"{len(prompts) * new / wall:.1f} generated tokens/s end to end, "
        f"prefill {sched.prefill_tokens} tokens in {sched.prefill_chunks} "
        f"chunks ({np.median(chunks) * 1e3:.3f} ms median), {sched.prefill_tokens / pre:.1f} prefill tokens/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"peak pages {sched.peak_pages_in_use} of {scfg.num_pages}, final "
        f"0; launches {launches} (= {n_attn} x {sched.decode_steps} decode "
        f"ticks)")
    return sched, outs, launches


def profile_family_tick(cfg, params, dev, prompts, label):
    """One steady decode tick of 8 sequences under the profiler: its wall
    time beside the device's busy time, and the top device activities."""
    from repro_torch.serving.scheduler import Scheduler, ServeConfig

    short = [p[:64] for p in prompts[:8]]
    scfg = ServeConfig(max_seqs=8, page_size=16, pages_per_seq=8,
                       prefill_chunk=64, num_pages=64, kv_bits=32)
    sched = Scheduler(cfg, params, scfg, device=dev)
    for p in short:
        sched.submit(p, 8)
    with torch.no_grad():
        while sched.decode_steps < 2:
            sched.step()
        wall_ms, acts = device_times(sched.step)
        sched.run()
    assert sched.pool.in_use == 0
    busy_ms = sum(t for _, t in acts.values())
    share = 100.0 * busy_ms / wall_ms
    log(f"profile {label} 1 decode tick (8 sequences): wall {wall_ms:.3f} "
        f"ms, device activities {busy_ms:.3f} ms ({share:.1f}% of wall), "
        f"{sum(c for c, _ in acts.values())} device activities")
    for key, (c, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:8]:
        log(f"profile   {t:10.3f} ms  x{c:<6d} {key[:80]}")


def serve_family_full_width(ops, dev, cfg, params, exact):
    """The 8-request stream through the paged scheduler in bf16 (exactly
    one B7 launch per attention-family layer a decode tick), the agreement
    of its first ``FAMILY_GATED`` requests with the lockstep engine
    printed, not a gate; one decode tick profiled; those requests rerun with
    ``exact`` (float32 activations and pools) and held to the lockstep
    engine (equal, or parting at a near-tie). Returns the bf16 stream's
    launches."""
    from repro_torch.launch import serve

    def tag(c):
        return c.dtype + (f", capacity_factor {c.capacity_factor}"
                          if c.num_experts else "")

    prompts = serve.make_prompts(cfg, list(FAMILY_LENS), 0)
    sched, outs, launches = family_stream(
        ops, dev, cfg, params, prompts, FAMILY_NEW, "bfloat16",
        f"serve {cfg.name} paged stream")
    sub = prompts[:FAMILY_GATED]
    compare_with_lockstep(f"serve {cfg.name} ({tag(cfg)})", cfg, params,
                          dev, sub, FAMILY_NEW, sched, outs[:FAMILY_GATED],
                          1, gate=False)
    del sched
    profile_family_tick(cfg, params, dev, prompts, cfg.name)
    s2, outs2, _ = family_stream(
        ops, dev, exact, params, sub, FAMILY_NEW, "float32",
        f"serve {cfg.name} ({tag(exact)}) paged stream")
    compare_with_lockstep(f"serve {cfg.name} ({tag(exact)})", exact, params,
                          dev, sub, FAMILY_NEW, s2, outs2, 1, torch.float32)
    return launches


def serve_olmoe_full_width(ops, dev):
    """olmoe-1b-7b at full width (B7 16 times a decode tick). Expert
    capacity depends on a step's token count (ROADMAP C18), and bf16
    router logits tie often, so the bf16 stream's agreement with the
    lockstep engine is printed only; the gated rerun takes
    ``capacity_factor`` = E/k (C = T: nothing dropped in either engine)."""
    from repro_torch.configs import base
    from repro_torch.models import moe, registry

    cfg = base.get_config("olmoe-1b-7b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    e, k = cfg.num_experts, cfg.experts_per_token
    experts = cfg.num_layers * 3 * e * cfg.d_model * cfg.d_ff
    log(f"serve olmoe-1b-7b: {registry.count_params(cfg)} float32 "
        f"parameters ({registry.count_params(cfg, active_only=True)} "
        f"active) in {time.perf_counter() - t0:.1f} s; {experts} expert "
        f"weights cast to bf16 each decode tick ({experts * 8 / 1e9:.1f} GB "
        f"read and written); capacity at a 64-token chunk "
        f"{moe.capacity(64, e, k, cfg.capacity_factor)}, at an 8-slot tick "
        f"{moe.capacity(8, e, k, cfg.capacity_factor)}; prompts "
        f"{FAMILY_LENS}, {FAMILY_NEW} new tokens")
    exact = cfg.with_overrides(dtype="float32", capacity_factor=e / k)
    assert moe.capacity(64, e, k, exact.capacity_factor) == 64
    launches = serve_family_full_width(ops, dev, cfg, params, exact)
    del params
    torch.cuda.empty_cache()
    return launches


def serve_zamba2_full_width(ops, dev):
    """zamba2-7b at full width (B7 13 times a decode tick, the Mamba2
    layers' state per slot). The paged engine's 64-token chunks and the
    lockstep engine's whole prompts split the SSD scan at other points,
    and 81 bf16 layers carry the difference past a bf16 step of the top
    logit, so the bf16 stream's agreement is printed only; the float32
    rerun is gated."""
    from repro_torch.configs import base
    from repro_torch.models import registry, ssm

    cfg = base.get_config("zamba2-7b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    d_inner, heads, n = ssm.dims(cfg)
    n_mamba = cfg.block_kinds.count("mamba2")
    state_mb = n_mamba * heads * cfg.ssm_head_dim * n * 4 / 1e6
    log(f"serve zamba2-7b: {registry.count_params(cfg)} float32 parameters "
        f"in {time.perf_counter() - t0:.1f} s ({len(params['stack']['shared'])}"
        f" shared-block leaves stored once); {n_mamba} Mamba2 layers, "
        f"d_inner {d_inner}, {heads} SSM heads, {state_mb:.1f} MB of float32 "
        f"SSM state a slot; prompts {FAMILY_LENS}, {FAMILY_NEW} new tokens")
    launches = serve_family_full_width(
        ops, dev, cfg, params, cfg.with_overrides(dtype="float32"))
    del params
    torch.cuda.empty_cache()
    return launches


def smoke_consensus(ops, dev, archs, seq):
    """Consensus training of the smoke configs of ``archs`` through
    ``train.main``, 2 workers, batch 2, ``seq`` tokens, 2 steps: finite
    losses, 2 B3 and 3 B2 launches a step, and the trained workers' loss
    equal to ce + 0.01·aux (aux > 0 with experts, 0 without)."""
    from repro_torch.configs import base
    from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
    from repro_torch.launch import train
    from repro_torch.models import registry

    for arch in archs:
        ops.reset_launches()
        out = train.main(["--arch", arch, "--smoke", "--workers", "2",
                          "--batch", "2", "--seq", str(seq), "--steps", "2",
                          "--log-every", "1"])
        torch.cuda.synchronize()
        launches = dict(ops.launches)
        assert np.isfinite(out["history"]).all(), out["history"]
        want = {k: 0 for k in ops.KERNELS}
        want.update(stoch_quantize_grouped_fused=4, bipartite_mix=6)
        assert launches == want, launches
        cfg = base.get_smoke_config(arch)
        data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq, seed=0))
        batch = model_batch(cfg, data.worker_batch(0, 2, 1), dev)
        with torch.no_grad():
            loss, m = registry.lm_loss(out["state"].theta, cfg, batch)
        assert torch.isfinite(loss).all()
        assert torch.equal(loss, m["ce"] + 0.01 * m["aux"])
        assert bool((m["aux"] > 0).all()) == (cfg.num_experts > 0)
        log(f"train {cfg.name} consensus (2 workers, seq {seq}; stub "
            f"inputs {sorted(set(batch) - {'tokens', 'labels'})}): loss "
            f"{' -> '.join(f'{x:.4f}' for x in out['history'])}; trained "
            f"workers' loss {loss.tolist()} = ce {m['ce'].tolist()} + 0.01 x "
            f"aux {m['aux'].tolist()}; launches {launches}")


def family_consensus(ops, dev):
    smoke_consensus(ops, dev, ("olmoe-1b-7b", "zamba2-7b"), 16)


def vlm_audio_consensus(ops, dev):
    smoke_consensus(ops, dev, ("qwen2-vl-7b", "whisper-small"), 32)


def serve_qwen2_vl_full_width(ops, dev):
    """qwen2-vl-7b at full width, text only (three-plane M-RoPE positions,
    no vision embeds, as both engines of the JAX package serve it): B7 on
    all 28 layers every decode tick at hd 128 and G 7 (a 129-page table,
    below the 178 pages where B8 takes over at G 7); the bf16 stream's
    lockstep agreement printed, 4 requests in float32 gated."""
    from repro_torch.configs import base
    from repro_torch.models import registry

    cfg = base.get_config("qwen2-vl-7b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(f"serve qwen2-vl-7b: {registry.count_params(cfg)} float32 "
        f"parameters in {time.perf_counter() - t0:.1f} s; M-RoPE sections "
        f"{cfg.mrope_sections}, theta {cfg.rope_theta:g}, G "
        f"{cfg.num_heads // cfg.num_kv_heads}; text only; prompts "
        f"{FAMILY_LENS}, {FAMILY_NEW} new tokens")
    launches = serve_family_full_width(
        ops, dev, cfg, params, cfg.with_overrides(dtype="float32"))
    del params
    torch.cuda.empty_cache()
    return launches


# whisper-small at full width (arXiv:2212.04356; 12 + 12 layers, d_model
# 768): prompts of 8-384 tokens and 64 new stay within the decoder's 448
# positions (the lockstep engine pads every wave to the longest prompt)
WHISPER_LENS = (8, 384, 100, 256, 33, 200, 64, 300)
WHISPER_NEW, WHISPER_BATCH = 64, 4


def lockstep_against_uncached(cfg, params, dev, prompts, new, engine,
                              outs):
    """Teacher-forced check of the lockstep engine's greedy streams: the
    uncached forward (encoder over the engine's frames, then the decoder
    over each padded prompt and the engine's tokens) at every generated
    position; returns (positions where the engine's token is not the
    argmax, the largest gap between the top logit and the engine's
    token's)."""
    from repro_torch.models import registry

    plen = max(len(p) for p in prompts)
    frames = engine.wave_frames(engine.batch)
    parted, worst = 0, 0.0
    for w0 in range(0, len(prompts), engine.batch):
        idx = range(w0, min(w0 + engine.batch, len(prompts)))
        toks = np.zeros((len(idx), plen + new - 1), np.int32)
        for j, i in enumerate(idx):
            toks[j, :len(prompts[i])] = prompts[i]
            toks[j, len(prompts[i]):plen] = prompts[i][-1]
            toks[j, plen:] = outs[i][:-1]
        with torch.no_grad():
            logits = registry.apply_model(params, cfg, {
                "tokens": torch.as_tensor(toks, device=dev),
                "frames": frames[:len(idx)]})[:, plen - 1:].float()
        gen = torch.as_tensor(np.stack([outs[i] for i in idx]),
                              device=dev).long()
        gaps = (logits.max(-1).values
                - torch.gather(logits, -1, gen[..., None])[..., 0])
        parted += int((gaps > 0).sum())
        worst = max(worst, float(gaps.max()))
        del logits
    return parted, worst


def serve_whisper_full_width(ops, dev):
    """whisper-small at full width through the lockstep engine (its caches
    are not paged): each wave runs the encoder over 1,500 stub frames and
    fills every layer's cross K/V, then prefills and decodes; no kernel of
    the port. bf16 (printed) and float32 (gated: every generated token the
    argmax of the uncached forward given the same history, or within a
    1e-3 near-tie of it)."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = base.get_config("whisper-small")
    torch.cuda.empty_cache()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = serve.make_prompts(cfg, list(WHISPER_LENS), 0)
    assert max(WHISPER_LENS) + WHISPER_NEW <= 448
    cross_mb = (2 * cfg.num_layers * cfg.source_positions
                * cfg.num_kv_heads * cfg.resolved_head_dim * 2 / 1e6)
    log(f"serve whisper-small: {registry.count_params(cfg)} float32 "
        f"parameters ({cfg.encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers), {cross_mb:.1f} MB of bf16 cross K/V a request; "
        f"prompts {WHISPER_LENS}, {WHISPER_NEW} new tokens, waves of "
        f"{WHISPER_BATCH}")
    for exact in (False, True):
        c = cfg.with_overrides(dtype="float32") if exact else cfg
        engine = serve.LockstepEngine(
            c, params, batch=WHISPER_BATCH, device=dev,
            cache_dtype=torch.float32 if exact else torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = engine.run(prompts, WHISPER_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        assert all(n == 0 for n in launches.values()), launches
        outs = [out["outputs"][i] for i in range(len(prompts))]
        t1 = time.perf_counter()
        parted, worst = lockstep_against_uncached(
            c, params, dev, prompts, WHISPER_NEW, engine, outs)
        log(f"serve whisper-small lockstep ({c.dtype}): {wall:.2f} s wall "
            f"for {len(prompts)} x {WHISPER_NEW} tokens "
            f"({len(prompts) * WHISPER_NEW / wall:.1f} tokens/s, "
            f"{out['decode_steps']} decode steps, "
            f"{wall / out['decode_steps'] * 1e3:.2f} ms a step with the "
            f"waves' encoder and prefill), "
            f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" GB; against the uncached forward ({time.perf_counter() - t1:.1f}"
            f" s): {parted} of {len(prompts) * WHISPER_NEW} tokens not its "
            f"argmax, largest gap {worst:.4e}"
            + ("" if exact else " (not a gate)"))
        if exact:
            assert worst <= GAP_TOL, (parted, worst)
    del params
    torch.cuda.empty_cache()


# phase 31: the campaigns through ``train.main(["--campaign", ...])``. Each
# whole campaign's kernel calls as the CPU rehearsal counts them (``python
# -m repro_torch.launch.train --campaign NAME --device cpu`` prints them
# from the kernel_dispatch counter): lm-sweep's 2 x 12 + 8 x 6 steps, 2 B3
# and 3 mixes a quantized step, 3 mixes an unquantized one, 3 of the 6 mixes
# of 4 grid runs on B6; fleet-sweep's 2 partitions x 7 runs (one
# synchronous, six fleets) x 80 rounds, 2 B1 and 3 B2 a round
CAMPAIGN_LAUNCHES = {
    "fleet-sweep": {"stoch_quantize": 2240, "bipartite_mix": 3360},
    "lm-sweep": {"bipartite_mix": 144, "stoch_quantize_grouped_fused": 120,
                 "edge_gather_mix": 72},
    # engine-smoke: walltime's 12 runs of 200 iterations (engine and seed,
    # warm-up and 5 timed each), mix_backends' 3 backends x 5 rollouts of
    # 60, the 16-leaf per-leaf loop 63 times, ... (every loop counted, none
    # timed to a deadline); serve-smoke: 4 layers a decode tick
    "engine-smoke": {"stoch_quantize": 7608, "bipartite_mix": 10561,
                     "stoch_quantize_grouped": 241,
                     "stoch_quantize_grouped_fused": 1184,
                     "edge_gather_mix": 1261},
    "serve-smoke": {"paged_attention_decode": 3300},
    # the kernels stage of all: 4 calls (a warm-up and 3) of each kernel at
    # each of 3 shapes
    "kernels": {"stoch_quantize": 12, "bipartite_mix": 12},
}
CAMPAIGN_DIR = Path(__file__).resolve().parent / "build" / "campaigns"


def campaign_records(root, name):
    """Every run's ``record.json`` of campaign ``name`` under ``root``, by
    the run's display name."""
    from repro_torch.bench import campaigns

    out = {}
    for st in campaigns.get(name).stages:
        for spec in st.runs:
            with open(root / name / spec.key / "record.json") as f:
                out[spec.display] = json.load(f)
    return out


def run_campaign(ops, name, root, *extra):
    """``train.main(["--campaign", name, ...])`` on the card with the
    launch counts set to 0 just before; returns its summary, the launches
    and the wall seconds."""
    from repro_torch.launch import train

    ops.reset_launches()
    t0 = time.perf_counter()
    out = train.main(["--campaign", name, "--campaign-dir", str(root),
                      *extra])
    wall = time.perf_counter() - t0
    return out, {k: n for k, n in ops.launches.items() if n}, wall


def kill_lm_sweep(root, run_dir):
    """Start ``lm-sweep`` in a child process and SIGKILL it as soon as the
    run at ``run_dir`` has a complete mid-run checkpoint. Returns the
    seconds from the start to the kill."""
    import signal

    from repro_torch.checkpoint import npz

    here = Path(__file__).resolve().parent
    log_path = root.parent / f"{root.name}.log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--campaign",
             "lm-sweep", "--campaign-dir", str(root)], cwd=here,
            env=dict(os.environ, PYTHONPATH=str(here / "src")), stdout=out,
            stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        try:
            while npz.latest_step(run_dir / "ckpt") is None:
                assert proc.poll() is None, log_path.read_text()[-3000:]
                assert time.perf_counter() - t0 < 600, "no checkpoint"
                time.sleep(0.005)
            proc.send_signal(signal.SIGKILL)
            waited = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGKILL, proc.returncode
    return waited


def campaigns_on_card(ops, dev):
    """Phase 31: ``fleet-sweep`` and ``lm-sweep`` whole through the
    trainer's ``--campaign`` on the card (every run done, every claim true,
    the launches the CPU rehearsal's), then ``lm-sweep`` killed by SIGKILL
    in a child process once its first run is done and its second has a
    mid-run checkpoint, and resumed with ``--resume``: the completed run
    skipped, the killed one resumed past step 0, and every run's loss
    history and total bits equal to the uninterrupted campaign's bit for
    bit."""
    import shutil

    from repro_torch.bench import campaigns
    from repro_torch.checkpoint import npz

    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)
    whole = CAMPAIGN_DIR / "whole"
    for name in ("fleet-sweep", "lm-sweep"):
        n_runs = sum(len(st.runs) for st in campaigns.get(name).stages)
        out, launches, wall = run_campaign(ops, name, whole)
        claims = {c["name"]: (c["ok"], c["value"])
                  for r in campaign_records(whole, name).values()
                  for c in r["claims"]}
        log(f"campaign {name}: {out} in {wall:.1f} s; launches {launches} "
            f"(CPU rehearsal: {CAMPAIGN_LAUNCHES[name]}); claims (ok, "
            f"value): {claims}")
        assert out == {"campaign": name, "executed": n_runs, "skipped": 0,
                       "failed": 0, "claim_failures": 0}, out
        assert claims and all(ok for ok, _ in claims.values()), claims
        assert launches == CAMPAIGN_LAUNCHES[name], launches

    killed = CAMPAIGN_DIR / "killed"
    first, second = campaigns.LM_BASELINE_STAGE.runs
    run_dir = killed / "lm-sweep" / second.key
    waited = kill_lm_sweep(killed, run_dir)
    at = npz.latest_step(run_dir / "ckpt")
    log(f"campaign lm-sweep killed (SIGKILL) {waited:.1f} s after its "
        f"start: {first.display} done, {second.display} checkpointed at "
        f"step {at}")
    assert (killed / "lm-sweep" / first.key / "record.json").exists()
    assert not (run_dir / "record.json").exists()
    out, launches, wall = run_campaign(ops, "lm-sweep", killed, "--resume")
    events = [json.loads(ln) for ln in (killed / "lm-sweep" / "events.jsonl")
              .read_text().splitlines()]
    skipped = [e["key"] for e in events if e.get("status") == "skipped"]
    got = campaign_records(killed, "lm-sweep")
    want = campaign_records(whole, "lm-sweep")
    parted = sorted({n for n in want for k in ("loss_history", "total_bits")
                     if got[n]["data"][k] != want[n]["data"][k]})
    log(f"campaign lm-sweep --resume: {out} in {wall:.1f} s; launches "
        f"{launches}; skipped {skipped}; {second.display} resumed from step "
        f"{got[second.display]['data']['resumed_from']}, loss history "
        f"{got[second.display]['data']['loss_history']} (uninterrupted: "
        f"{want[second.display]['data']['loss_history']}), total bits "
        f"{got[second.display]['data']['total_bits']!r} (uninterrupted: "
        f"{want[second.display]['data']['total_bits']!r}); runs whose loss "
        f"history or total bits part from the uninterrupted campaign's: "
        f"{parted} ({first.display} ran uninterrupted in the killed "
        f"process)")
    assert out == {"campaign": "lm-sweep", "executed": 9, "skipped": 1,
                   "failed": 0, "claim_failures": 0}, out
    assert skipped == [first.key], skipped
    assert got[second.display]["data"]["resumed_from"] == at > 0
    assert launches == {"bipartite_mix": 72 + 3 * (12 - at),
                        "stoch_quantize_grouped_fused": 96,
                        "edge_gather_mix": 72}, launches
    assert not parted, parted
    shutil.rmtree(CAMPAIGN_DIR, ignore_errors=True)


def speed_campaigns(ops, dev):
    """Phase 33: ``engine-smoke`` and ``serve-smoke`` through the
    trainer's ``--campaign`` on the card at the JAX package's configs:
    every run done, every correctness claim true, every speed claim printed
    with its value (a speed claim that fails is a finding, PERF.md), and
    exactly the CPU rehearsal's launches (``CAMPAIGN_LAUNCHES``)."""
    import shutil

    from repro_torch.bench import campaigns
    from repro_torch.bench import engine as BE
    from repro_torch.bench import serving as BS

    speed = set(BE.SPEED_CLAIMS) | set(BS.SPEED_CLAIMS)
    root = CAMPAIGN_DIR / "speed"
    shutil.rmtree(root, ignore_errors=True)
    for name in ("engine-smoke", "serve-smoke"):
        n_runs = sum(len(st.runs) for st in campaigns.get(name).stages)
        out, launches, wall = run_campaign(ops, name, root)
        claims = {c["name"]: (c["ok"], c["value"])
                  for r in campaign_records(root, name).values()
                  for c in r["claims"]}
        log(f"campaign {name}: {out} in {wall:.1f} s; launches {launches} "
            f"(CPU rehearsal: {CAMPAIGN_LAUNCHES[name]})")
        for kind, names in (("correctness", sorted(set(claims) - speed)),
                            ("speed", sorted(set(claims) & speed))):
            log(f"campaign {name} {kind} claims (ok, value): "
                + "; ".join(f"{k} {claims[k]}" for k in names))
        assert (out["executed"], out["failed"]) == (n_runs, 0), out
        bad = {k: v for k, v in claims.items() if not v[0] and k not in speed}
        assert claims and not bad, bad
        assert launches == CAMPAIGN_LAUNCHES[name], launches
    return root


def kernels_and_roofline(ops, dev, root):
    """Phase 34, on a quiet card after every child has ended: the
    ``kernels`` and ``roofline`` stages of ``all`` (``--campaign all
    --campaign-only ...``): the parity claims true and the CPU rehearsal's
    launches; every roofline row ``ok`` (it launched, and its share of its
    bound is at most 1.05), each printed with the card's name and power
    limit."""
    import shutil

    out, launches, wall = run_campaign(ops, "all", root, "--campaign-only",
                                       "kernels")
    log(f"campaign all --campaign-only kernels: {out} in {wall:.1f} s; "
        f"launches {launches}")
    assert out == {"campaign": "all", "executed": 3, "skipped": 0,
                   "failed": 0, "claim_failures": 0}, out
    assert launches == CAMPAIGN_LAUNCHES["kernels"], launches
    out, _, wall = run_campaign(ops, "all", root, "--campaign-only",
                                "roofline")
    doc = json.loads((root / "BENCH_engine.json").read_text())
    for shape, rec in sorted(doc["kernels"].items()):
        if shape != "claims":
            log(f"kernels {shape}: {rec}")
    sec = doc["roofline"]
    rows = sec["single"] + sec["multi"]
    for r in rows:
        log(f"roofline {r['kernel']} {r['name']} {r['shape']}: "
            f"{r['status']}, {r.get('ms')} ms against a bound of "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), share "
            f"{r.get('share')}, {r['library']} {r.get('library_ms')} ms "
            f"({r.get('card')})" + (f"; {r['error']}" if "error" in r
                                    else ""))
    log(f"campaign all --campaign-only roofline: {out} in {wall:.1f} s; "
        f"{sec['multi_note']}")
    assert out["failed"] == 0 and sec["claims"] == {
        "roofline_no_failed_records": True}, (out, sec["claims"])
    assert all(r["status"] == "ok" and r["share"] <= 1.05 for r in rows)
    shutil.rmtree(root, ignore_errors=True)


# phases run in a child process (this script with ``--child-phases
# <group>``) beside host-paced phases of the main one: the card has room
# for both and the kernels are built. Each phase sets and reads its own
# process's launch counts.
CHILD_GROUPS = {
    # phases 25-27 beside 15, 17, 18 (olmoe's 29.8 GB beside FSDP's 35.9)
    "family": (("olmoe-1b-7b serving", "serve_olmoe_full_width"),
               ("zamba2-7b serving", "serve_zamba2_full_width"),
               ("olmoe-smoke and zamba2-smoke consensus training",
                "family_consensus")),
    # phases 22-23 and 28-30 beside 19 and the figures (gemma3's 19.9 GB,
    # then qwen2-vl-7b's 28.3 GB of weights)
    # phase 31 beside 15, 17, 18 and the family group: host-paced small
    # steps (tinyllama-smoke, the paper-size fleet), under 1 GB
    "campaign": (("the campaigns: fleet-sweep, lm-sweep, kill and resume",
                  "campaigns_on_card"),),
    "sliding": (("gemma3-4b serving", "serve_gemma3_full_width"),
                ("h2o-danube-1.8b recycling", "serve_danube_recycling"),
                ("qwen2-vl-7b serving", "serve_qwen2_vl_full_width"),
                ("whisper-small serving", "serve_whisper_full_width"),
                ("qwen2-vl-smoke and whisper-smoke consensus training",
                 "vlm_audio_consensus")),
}


def child_log(group: str) -> Path:
    return (Path(__file__).resolve().parent / "build"
            / f"chip_smoke_{group}.log")


def start_child_phases(group: str):
    """Start the phases of ``CHILD_GROUPS[group]`` in a child process, its
    output to :func:`child_log`; :func:`finish_child_phases` waits and
    prints it."""
    path = child_log(group)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = open(path, "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--child-phases",
         group], cwd=Path(__file__).resolve().parent, stdout=out,
        stderr=subprocess.STDOUT, text=True)
    # a failure in this process must not leave the child running
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return group, proc, out, time.perf_counter()


def finish_child_phases(started) -> None:
    group, proc, out, t0 = started
    try:
        rc = proc.wait(timeout=1100)
    finally:
        if proc.poll() is None:
            proc.kill()
        out.close()
    text = child_log(group).read_text()
    for line in text.splitlines():
        if not line.startswith(("  ", "/", "[train]", "step ")):
            print(line, flush=True)
    log(f"phases {[n for n, _ in CHILD_GROUPS[group]]} in a child process: "
        f"done within {time.perf_counter() - t0:.1f} s")
    assert rc == 0, text[-4000:]


def child_main(group: str) -> int:
    """``--child-phases <group>``: the phases of ``CHILD_GROUPS[group]``
    in order."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device("cuda")
    for name, fn in CHILD_GROUPS[group]:
        t0 = time.perf_counter()
        globals()[fn](ops, dev)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return 0


def start_card_case(name: str):
    """Start one card test of tests/test_torch_cuda.py in a child pytest;
    :func:`finish_card_case` waits for it."""
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", f"tests/test_torch_cuda.py::{name}"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, proc, time.perf_counter()


def finish_card_case(case) -> None:
    name, proc, t0 = case
    out, err = proc.communicate(timeout=900)
    tail = out.strip().splitlines()[-1:]
    log(f"card test {name}: {tail} (done within "
        f"{time.perf_counter() - t0:.1f} s)")
    assert proc.returncode == 0, out[-4000:] + err[-2000:]



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops, ref

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    errs = {"stoch_quantize": check_quant_parity(ops, ref, dev),
            "bipartite_mix": check_mix_parity(ops, ref, dev)}
    times = time_kernels(ops, ref, dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper_size(ops, dev)
    log(f"phase paper size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, prob, theta_star, full = full_size(ops, dev)
    log(f"phase full size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full_size_bf16(ops, dev, prob, theta_star)
    log(f"phase full size bf16 replicas: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dynamic_full_size(ops, dev, prob, theta_star)
    log(f"phase dynamic full size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet_convex(ops, dev, prob, theta_star)
    # the sharded phase solves the same problem: its data and Gram matrices
    # wait on the host
    parked = tuple(t.cpu() for t in (prob.x, prob.y, prob.gram, prob.xty))
    del prob, theta_star
    torch.cuda.empty_cache()
    log(f"phase fleet convex: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs.update(check_grouped_parity(ops, ref, dev))
    times.update(time_grouped(ops, ref, dev))
    log(f"phase grouped kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["edge_gather_mix"] = check_edge_parity(ops, ref, dev)
    times["edge_gather_mix"] = time_edge(ops, ref, dev)
    log(f"phase edge_gather_mix kernel: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_narrow_parity(ops, dev)
    time_narrow(ops, dev)
    log(f"phase narrowed kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm, lm32 = lm_full_width(ops, dev)
    log(f"phase lm full width: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_topology(ops, ref, dev, full, parked, lm32)
    del full, parked
    log(f"phase sharded topology: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_bf16_traced(ops, dev, lm32)
    log(f"phase lm full width bf16 replicas, traced: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_fleet = lm_fleet_full_width(ops, dev)
    log(f"phase lm fleet full width: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tiled = lm_tiled(ops)
    log(f"phase lm tiled: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    two = twopass_vs_fused(ops, dev)
    log(f"phase two-pass vs fused: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs.update(check_paged_parity(ref, dev))
    times.update(time_paged(ref, dev))
    time_split_rows(dev)
    log(f"phase paged-attention kernels: {time.perf_counter() - t0:.1f} s")
    # phase 16 times a kernel: it runs before the child starts
    t0 = time.perf_counter()
    errs["slstm_cell"] = check_slstm_parity(ref, dev)
    times["slstm_cell"] = time_slstm(ref, dev)
    log(f"phase slstm_cell kernel: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    family = start_child_phases("family")
    campaign = start_child_phases("campaign")
    t0 = time.perf_counter()
    served = serve_full_width(ops, dev)
    log(f"phase serving full width: {time.perf_counter() - t0:.1f} s")
    launches.update(served)
    t0 = time.perf_counter()
    launches["slstm_cell"] = serve_xlstm_full_width(ops, dev)["slstm_cell"]
    log(f"phase xlstm serving full width: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fsdp_full_width(ops, dev)
    log(f"phase fsdp full width: {time.perf_counter() - t0:.1f} s")
    finish_child_phases(family)
    finish_child_phases(campaign)
    # host-paced work that needs neither this process nor a quiet card runs
    # beside the production-load phase: the paper's figures (one process a
    # figure) and the aliased-table card case at the wider head dims; the
    # load phase's counters and gates do not depend on timing, and its
    # printed times are taken with these running (PERF.md)
    t0 = time.perf_counter()
    figure_procs = start_figures()
    cases = [start_card_case(f"test_paged_attention_{name}_on_card")
             for name in ("on_aliased_and_forked_pages",
                          "aliased_pages_at_wider_head_dims")]
    sliding = start_child_phases("sliding")
    launches["paged_attention_decode"] = serve_production_load(ops, dev)
    log(f"phase production-load serving (the figures, the aliased-table "
        f"card cases and phases 22-23 and 28-30 beside it): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    finish_figures(figure_procs, dev)
    log(f"phase figures and theorem 3 (after the load phase): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for case in cases:
        finish_card_case(case)
    finish_child_phases(sliding)
    # timed on a quiet card, after every child has ended
    time_paged_wide(ref, dev)
    log(f"phase paged attention at the wider head dims: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attention_consensus(ops, dev)
    log(f"phase attention consensus training: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    speed_root = speed_campaigns(ops, dev)
    log(f"phase engine-smoke and serve-smoke: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels_and_roofline(ops, dev, speed_root)
    log(f"phase kernels and roofline stages: "
        f"{time.perf_counter() - t0:.1f} s")
    launches.update(
        stoch_quantize_grouped_fused=lm["stoch_quantize_grouped_fused"],
        stoch_quantize_grouped_fused_tiled=tiled[
            "stoch_quantize_grouped_fused_tiled"],
        stoch_quantize_grouped=two["stoch_quantize_grouped"],
        edge_gather_mix=lm_fleet["edge_gather_mix"])
    assert all(launches[k] > 0 for k in ops.KERNELS), launches

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "stoch_quantize": (src + "stoch_quant.cu",
                           "src/repro/kernels/stoch_quant.py:57"),
        "bipartite_mix": (src + "bipartite_mix.cu",
                          "src/repro/kernels/bipartite_mix.py:28"),
        "stoch_quantize_grouped_fused": (src + "grouped_fused.cu",
                                         "src/repro/kernels/stoch_quant.py:117"),
        "stoch_quantize_grouped_fused_tiled": (
            src + "grouped_fused_tiled.cu",
            "src/repro/kernels/stoch_quant.py:235"),
        "stoch_quantize_grouped": (src + "grouped_quant.cu",
                                   "src/repro/kernels/stoch_quant.py:75"),
        "paged_attention_decode": (src + "paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:120"),
        "paged_attention_decode_online": (
            src + "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:157"),
        "edge_gather_mix": (src + "edge_gather_mix.cu",
                            "src/repro/kernels/edge_gather_mix.py:32"),
        "slstm_cell": (src + "slstm_cell.cu",
                       "src/repro/kernels/slstm_cell.py:33"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child-phases"]:
        sys.exit(child_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
