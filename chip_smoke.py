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
   the stream handle);
4. paper size: quickstart part 1 (24 workers, synth-linear d=50, p=0.35,
   300 iterations) for ggadmm and cq-ggadmm on the card: distance to the
   optimum below 1e-8, 7200 rounds, and ggadmm's trajectory equal to the
   same run on the CPU within 1e-4 max|theta*|;
5. full size: cq-ggadmm on synth-linear at the width of the LIBSVM epsilon
   set (d=2000) over 64 workers of a p=0.35 random bipartite graph, 2048
   samples per worker (cut from epsilon's 400,000 rows to keep host-side
   generation near 5 GB), 20 iterations: the distance to the optimum falls
   and every kernel launch is counted (2 quantizes and 3 mixes per
   iteration);
6. ``run_dynamic`` at full size (the same problem, a new p=0.35 graph
   every 5 iterations, 20 iterations of cq-ggadmm) on the sparse backend,
   then with the same draws on the dense one: exactly 3 ``edge_gather_mix``
   launches per iteration, tx_mask equal, theta within 1e-4 max|theta*|;
7. the fleet on the convex path (sparse backend): the full size under
   faults (participation 0.8, staleness 2, 20 rounds), dark workers
   charged 0 bits, 3 B6 launches per round; a fault-free fleet at the
   paper size bit for bit equal to ``run_synchronous``;
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
   adjacency, per call, at each;
10. full-width consensus training of xlstm-125m through
   ``repro_torch.launch.train.main`` with the example's flags (4 workers,
   batch 16, seq 128, 2 local steps, ``--groups leaf``, 3 steps): a finite
   loss, below the seeded initial model's after the last step, exactly 2
   fused quantize and 3 mix launches per step;
   s/step, peak device memory, and the top device activities of one more
   step from torch.profiler;
11. the slice's main path: the same training with ``--mix-backend sparse
   --fleet --fleet-participation 0.75 --fleet-staleness 2 --fleet-churn
   2:1:1`` for 4 rounds: a finite loss every round, the churn applied at
   round 2, dark workers charged 0 bits, exactly 3 B6 and 2 fused
   quantize launches per round; s/round, peak device memory, and one more
   round with a worker timed out under torch.profiler;
12. the tiled path: the smoke config for 2 steps with
   ``REPRO_QUANT_TILE_D=512``, ``--groups block:embed,mlp,norm`` and
   ``--censor-mode group``: 2 tiled quantize launches per step;
13. one packed quantize step at the smoke width through the two-pass path
   (``stoch_quantize_grouped``) and the fused one: value-identical;
14. the paged-attention decode kernel under its two contracts (B7
   one-shot, B8 online softmax) against their plain versions, and B8
   against B7, to 1e-5 of max|V|, at the smoke model's heads and at
   tinyllama's (H 32, KV 4, hd 64, ps 16, B 8, tables of 64 and 256 pages,
   ctx 0 to 4096, poisoned table slots, every sequence on or around a split
   boundary), with bf16, 8-bit and 4-bit pools; B7 at ctx 0 against the
   uniform average of V; every call repeated, equal bit for bit; kernel,
   plain and SDPA times at the shapes the serving path gives them; B8 at
   64, 128, 256 and 512 slots per split, B7 at 64, 128 and 256;
15. serving tinyllama-1.1b at full width (random float32 weights from
   seed 0, bf16 activations) through the paged scheduler: 16 greedy
   requests (prompt lengths 17..700, 128 new tokens, max_seqs 8, pages of
   16, 64-page tables, 64-token prefill chunks), exactly 22 one-shot
   launches per decode tick, held against the lockstep engine's
   contiguous decode (each parting only at a near-tie), again with float32
   activations and pools; kv_bits 8 and 4 streams; one request at ~4000
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
   near-tie); one decode tick and one prefill chunk profiled.

Before the last line it prints one JSON line with each kernel's launches
(counted over the path it serves, with the counts set to 0 just before
that path ran), parity error, times and bound, then nvidia-smi's
name/power-limit line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# HBM bandwidth and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of the quantizer per element: sub, add, div, floor,
# sub, compare, add, max, min, mul, add, sub (and 2 per row for 2R/Δ)
QUANT_OPS_PER_ELEM = 12

FULL_N, FULL_D, FULL_S, FULL_ITERS = 64, 2000, 2048, 20
PAPER_ITERS = 300
LM_STEPS, TILED_STEPS = 3, 2
# the example's settings (examples/consensus_lm_training.py), full width
LM_FLAGS = ["--arch", "xlstm-125m", "--mode", "admm", "--workers", "4",
            "--batch", "16", "--seq", "128", "--local-steps", "2",
            "--lr", "2e-3", "--tau0", "5.0", "--xi", "0.999", "--bits", "6",
            "--omega", "0.9995", "--groups", "leaf", "--log-every", "1"]
GROUPED_KW = dict(omega=0.9995, b0=6, b_max=16)
# bytes per element of a grouped quantize round: three operands read once
# and the reconstruction written once (the (N, G) side arrays, 76 entries
# at full width, are left out)
GROUPED_BYTES_PER_ELEM = 16


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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return bound(4.0 * (m * n + n * d + m * d), 2.0 * m * n * d)


def launch_floor(dev):
    """What a ctypes launch pays on this host before any kernel runs: an
    empty call into B2's library (m = 0 returns at once), the allocation of
    a (64, 2000) output three ways and the current stream's handle two
    ways, timed as :func:`time_ms` times a call."""
    from repro_torch.kernels import bipartite_mix as bm

    fn = bm._lib().bipartite_mix_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    like = torch.empty((64, 2000), device=dev)
    floor = {"empty ctypes call": time_ms(
                 lambda: fn(None, None, None, 0, 0, 0, stream), 1000),
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
    one call) and time per call (CUDA events), with B2's parity there.
    Returns the convex shape's numbers, the ones the main path pays."""
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
             "bound": bound(4.0 * (4 * n * d + 2 * n),
                            QUANT_OPS_PER_ELEM * n * d + 2 * n)}
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
    return launches, prob, theta_star


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
    b = bound(GROUPED_BYTES_PER_ELEM * n_el, QUANT_OPS_PER_ELEM * n_el)
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
    return launches


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
LM_FLEET_ROUNDS = 4
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
    table, valid = graph.neighbor_table
    side = 4.0 * graph.n * d + 8.0 * table.size
    referenced = np.unique(table[valid > 0]).size
    return 4.0 * referenced * d + side, 4.0 * table.size * d + side


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
        b = bound(unique, 2.0 * nnz * d)
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
            f"{gathered / 1e9:.4f} GB = {gathered / PEAK_BYTES_PER_S * 1e3:.5f}"
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
    fs, fm = FleetSim(24, cfg, FleetConfig(rounds=PAPER_FLEET_ROUNDS),
                      theta0, solver=E.ExactSolver(pprob),
                      extra_metrics=metrics, graph0=pgraph).run()
    for k in sync_m:
        assert np.array_equal(fm[k], sync_m[k]), f"fleet metric {k}"
    for name in ("theta", "theta_hat", "alpha"):
        assert torch.equal(getattr(fs.engine, name),
                           getattr(sync_state, name)), name
    log(f"fleet fault-free paper size (24, 50), {PAPER_FLEET_ROUNDS} rounds: "
        f"{len(sync_m)} metrics and the final theta, theta_hat, alpha bit "
        f"for bit equal to run_synchronous; bits "
        f"{fm['payload_bits_total'].sum():.4e}")
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
    profile_lm_fleet_round(out, dev)
    return launches


def profile_lm_fleet_round(out, dev):
    """One more round of the run's own ``FleetSim`` (its fault step on its
    last state, graph and batches) with a worker timed out, under
    torch.profiler: device-busy share and top device activities."""
    from repro_torch.core import engine as E
    from repro_torch.fleet.sim import round_draws

    sim = out.pop("sim")
    holder = {"fs": out.pop("fleet_state")}
    n = len(sim.members)
    batch = sim.batch_fn(LM_FLEET_ROUNDS, tuple(sim.members))
    draw = round_draws(sim.fleet_cfg.seed, LM_FLEET_ROUNDS,
                       (n, E.tree_dim(holder["fs"].engine.theta)), dev)
    # time out a worker with no packet in flight (nothing lands for it)
    late = int(np.flatnonzero(holder["fs"].timer.cpu().numpy() == 0)[0])
    drop = torch.zeros(n, device=dev)
    drop[late] = 1.0
    lag = torch.zeros(n, dtype=torch.int32, device=dev)

    def one_round():
        holder["fs"], holder["m"] = sim._step(holder["fs"], draw, batch,
                                              drop, lag)

    t0 = time.perf_counter()
    wall_ms, acts = device_times(one_round)
    busy_ms = sum(t for _, t in acts.values())
    m = holder["m"]
    assert float(m["fleet_participation"][late]) == 0.0
    assert float(m["payload_bits"][late]) == 0.0
    assert float(m["tx_mask"][late]) == 0.0
    log(f"profile 1 faulted full-width lm fleet round (worker {late} timed "
        f"out: tx 0, 0 bits; offered "
        f"{float(m['offered_payload_bits'][late]):.0f}): wall "
        f"{wall_ms:.1f} ms, device activities {busy_ms:.1f} ms "
        f"({100.0 * busy_ms / wall_ms:.1f}% of wall), "
        f"{sum(c for c, _ in acts.values())} device activities; profiling "
        f"took {time.perf_counter() - t0:.1f} s")
    for key, (c, t) in sorted(acts.items(), key=lambda r: -r[1][1])[:10]:
        log(f"profile   {t:10.3f} ms  x{c:<6d} {key[:80]}")
    holder.clear()
    del sim, batch
    torch.cuda.empty_cache()



# serving: tinyllama-1.1b at full width (arXiv:2401.02385), the request
# stream of the paged scheduler and the contiguous lockstep reference
SERVE_LENS = (17, 96, 255, 512, 700, 33, 384, 128)
SERVE_REQUESTS, SERVE_NEW = 16, 128
SERVE_GEOM = dict(max_seqs=8, page_size=16, pages_per_seq=64,
                  prefill_chunk=64)
SHORT_REQUESTS, SHORT_NEW = 4, 32
LONG_PROMPT, LONG_NEW, LONG_PAGES = 3968, 32, 256
GAP_TOL = 1e-3
TOP_K = 8        # logits kept per generated position for the comparison
# (B, H, KV, hd, ps, P) and ctx lens of the paged-attention checks: the
# smoke model's heads; tinyllama's with the main stream's table (64 pages)
# and with the long request's (256 pages); poisoned slots past ctx
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
}


def paged_inputs(dev, shape, ctx, kv_bits, seed):
    """Decode inputs on the card from a seeded generator: q (B, H, hd)
    float32; K/V pools of B*P+3 pages as bf16 values (kv_bits 32) or as
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
        kw.update(k_pages=k.to(torch.bfloat16), v_pages=v.to(torch.bfloat16))
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
    """B7 (the one-shot contract) and B8 (online) against their plain
    versions, and B8 against B7 where ctx > 0, to 1e-5 of max|V|, at every
    shape and kv_bits 32 (bf16 pools), 8 and 4; B7 where ctx = 0 against
    the uniform average of V over the table (as ``uniform_average``
    computes it, to the same tolerance); a second call of each equal bit
    for bit (the ticket counters were reset). The kernels get the poisoned
    table as it is (they clamp it)."""
    errs = {"paged_attention_decode": 0.0,
            "paged_attention_decode_online": 0.0}
    seed = 0
    for label, (shape, ctx) in PAGED_CHECKS.items():
        for bits in (32, 8, 4):
            seed += 1
            q, kw, vmax = paged_inputs(dev, shape, ctx, bits, seed)
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
                    raise AssertionError(f"{name} {label} kv_bits {bits}: "
                                         f"max |err| {err:.3e} > 1e-5 x "
                                         f"{vmax:.3f}")
                errs[name] = max(errs[name], err)
                line.append(f"{name} {err:.3e}")
            live = kw["ctx_lens"] > 0
            cross = float((got[True][live] - got[False][live]).abs().max())
            if not cross <= 1e-5 * vmax:
                raise AssertionError(f"B8 vs B7 {label} kv_bits {bits}: "
                                     f"{cross:.3e}")
            assert bool((got[True][~live] == 0).all()), "B8 ctx 0 not zero"
            if bool((~live).any()):
                uni = float((got[False][~live] - uniform_average(
                    ref, kw, shape)[~live]).abs().max())
                if not uni <= 1e-5 * vmax:
                    raise AssertionError(f"B7 ctx 0 {label} kv_bits {bits}: "
                                         f"{uni:.3e} from the average")
                line.append(f"B7 at ctx 0 vs the uniform average {uni:.3e}")
            log(f"parity paged {label} kv_bits {bits}: max |err| "
                f"{', '.join(line)}, B8 vs B7 {cross:.3e} (max|V| "
                f"{vmax:.3f}); second calls equal bit for bit")
            del q, kw, got, again
    return errs


def paged_bound(shape, ctx, kv_bits, online):
    """Least time for one call: the K/V entries (and ranges) of the pages
    up to ctx (where ctx = 0: all P pages for the one-shot kernel's uniform
    average, none for the online kernel), q, out, table and ctx, each read
    or written once, at the card's memory rate; against 4·H·hd float32
    operations per slot."""
    bsz, heads, num_kv, hd, ps, pps = shape
    slots = sum((-(-c // ps) if c else (0 if online else pps)) * ps
                for c in ctx)
    entry = {32: 2 * hd, 8: hd + 4, 4: hd // 2 + 4}[kv_bits]
    n_bytes = (2 * slots * num_kv * entry + 2 * 4 * bsz * heads * hd
               + 4 * bsz * pps + 4 * bsz)
    return bound(n_bytes, 4.0 * heads * hd * slots)


def time_paged(ref, dev):
    """Kernel, plain and library times of B7 and B8 at the shapes the
    serving path gives them (bf16 pools): B7 at the main stream's table
    with its mid-decode contexts, B8 at the long request's table with one
    sequence at ~4000 tokens; also each at the other's shape, and at
    kv_bits 8 and 4 (printed only)."""
    import torch.nn.functional as F

    b7_ctx = tuple(n + SERVE_NEW // 2 for n in SERVE_LENS)
    b8_ctx = (LONG_PROMPT + LONG_NEW // 2,) + (0,) * 7
    cases = {
        "paged_attention_decode": ((8, 32, 4, 64, 16, 64), b7_ctx, False),
        "paged_attention_decode_online": ((8, 32, 4, 64, 16, 256), b8_ctx,
                                          True),
    }
    extra = {
        "B8 at B7's shape": ((8, 32, 4, 64, 16, 64), b7_ctx, True),
        "B7 at B8's shape": ((8, 32, 4, 64, 16, 256), b8_ctx, False),
        "B7 P=256, 8 x ~4000": ((8, 32, 4, 64, 16, 256), (4000,) * 8, False),
        "B8 P=256, 8 x ~4000": ((8, 32, 4, 64, 16, 256), (4000,) * 8, True),
    }
    out = {}
    for label, (shape, ctx, online) in {**cases, **extra}.items():
        for bits in ((32, 8, 4) if label in cases else (32,)):
            q, kw, _ = paged_inputs(dev, shape, ctx, bits, 50)
            b = paged_bound(shape, ctx, bits, online)
            t = {"ms": time_ms(lambda: paged_kernel(q, kw, online), 50, 5),
                 "plain_ms": time_ms(lambda: paged_plain(ref, q, kw, online),
                                     3, 3),
                 "bound": b, "library_ms": None}
            # every kernel one call launches, summed
            t["device_ms"] = device_ms(lambda: paged_kernel(q, kw, online))
            if bits == 32:
                # the same function after the gather: SDPA over contiguous
                # bf16 K/V of the whole table, masked by ctx
                bsz, heads, num_kv, hd, ps, pps = shape
                bt = torch.clamp(kw["block_tables"].long(), 0,
                                 kw["k_pages"].shape[0] - 1)

                def gather(pool):
                    g = pool[bt].reshape(bsz, pps * ps, num_kv, hd)
                    return g.permute(0, 2, 1, 3).contiguous()

                kg, vg = gather(kw["k_pages"]), gather(kw["v_pages"])
                qb = q.to(torch.bfloat16)[:, :, None, :]
                mask = (torch.arange(pps * ps, device=dev)[None]
                        < kw["ctx_lens"][:, None])[:, None, None, :]
                t["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qb, kg, vg, attn_mask=mask, enable_gqa=True), 50, 5)
                del kg, vg
            log(f"time {label} kv_bits {bits} ctx {ctx}: per call "
                f"{t['ms']:.5f} ms (device only {t['device_ms']} ms), plain "
                f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']} ms, bound "
                f"{b[0]:.5f} ms ({b[1]})")
            if label in cases and bits == 32:
                out[label] = t
            del q, kw
    torch.cuda.empty_cache()
    return out


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
                 record_top=0):
    """Serve ``prompts`` through a fresh scheduler with the kernel counts
    and the peak-memory mark set just before; returns (scheduler, outputs
    by request, launches, wall seconds)."""
    sched = sched_cls(cfg, params, scfg, device=dev, record_top=record_top)
    rids = [sched.submit(p, new) for p in prompts]
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
        f"{np.median(s3.decode_step_s) * 1e3:.3f} ms), prefill "
        f"{s3.prefill_chunks} chunks in {np.sum(s3.prefill_chunk_s):.2f} s, "
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
    ticks = np.asarray(sched.decode_step_s) * 1e3
    pre = float(np.sum(sched.prefill_chunk_s))
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

    compare_with_lockstep("serve", cfg, params, dev, prompts, SERVE_NEW,
                          sched, outs, 2)
    del sched

    # the same stream with float32 activations and pools: paged (B7 on
    # float32 pages) against lockstep at GAP_TOL
    cfg32 = cfg.with_overrides(dtype="float32")
    s32cfg = ServeConfig(num_pages=2 * worst, kv_bits=32,
                         cache_dtype="float32", **geom)
    s32, outs32, l32, w32 = serve_stream(
        Scheduler, cfg32, params, dev, prompts, SERVE_NEW, s32cfg, ops,
        record_top=TOP_K)
    assert l32["paged_attention_decode"] == cfg.num_layers * s32.decode_steps
    log(f"serve float32 stream: {w32:.2f} s wall, {s32.decode_steps} decode "
        f"ticks (median {np.median(s32.decode_step_s) * 1e3:.3f} ms)")
    compare_with_lockstep("serve float32", cfg32, params, dev, prompts,
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
            f"{np.median(s2.decode_step_s) * 1e3:.3f} ms), page bytes "
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
# float32 operations per (row, step, unit) outside the product: 4 pre adds,
# fbias add, logsigmoid (min, abs, neg, exp, log1p, sub), m' (add, max),
# the two exponentials (3 + 2), c' (tanh, 2 mul, add), n' (2 ops + max),
# h' (neg, exp, add, div, mul, div)
SLSTM_GATE_OPS = 31
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
    2 B S H dh 4dh and SLSTM_GATE_OPS per (row, step, unit) at the float32
    rate."""
    b, s, h, dh = slstm_dims(shape)
    wx_bytes = 2 if wx_dtype == torch.bfloat16 else 4
    n_bytes = (b * s * h * 4 * dh * wx_bytes + 4 * b * s * h * dh
               + 4 * h * dh * 4 * dh + 4 * h * dh + 8 * 4 * b * h * dh)
    n_ops = 2.0 * b * s * h * dh * 4 * dh + SLSTM_GATE_OPS * b * s * h * dh
    return bound(n_bytes, n_ops)


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
        ticks = np.asarray(sched.decode_step_s) * 1e3
        pre = float(np.sum(sched.prefill_chunk_s))
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
    launches, prob, theta_star = full_size(ops, dev)
    log(f"phase full size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dynamic_full_size(ops, dev, prob, theta_star)
    log(f"phase dynamic full size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet_convex(ops, dev, prob, theta_star)
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
    lm = lm_full_width(ops, dev)
    log(f"phase lm full width: {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    served = serve_full_width(ops, dev)
    log(f"phase serving full width: {time.perf_counter() - t0:.1f} s")
    launches.update(served)
    t0 = time.perf_counter()
    errs["slstm_cell"] = check_slstm_parity(ref, dev)
    times["slstm_cell"] = time_slstm(ref, dev)
    log(f"phase slstm_cell kernel: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["slstm_cell"] = serve_xlstm_full_width(ops, dev)["slstm_cell"]
    log(f"phase xlstm serving full width: {time.perf_counter() - t0:.1f} s")
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
    sys.exit(main())
