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
   with CUDA events;
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
6. the three grouped quantize kernels (``stoch_quantize_grouped_fused``,
   its D-tiled twin, ``stoch_quantize_grouped``) against their plain
   versions at (64, 2000) G=1, the xlstm-smoke tree (4, 1,905,668) G=19,
   a ragged (5, 4099) layout with degenerate groups and the full-width
   xlstm-125m buffer (4, 134,277,912) G=19: the (N, G) outputs bit for bit,
   ``out`` bit for bit or one step Δ apart only at a rounding boundary;
   kernel and plain times at the full-width shape;
7. full-width consensus training of xlstm-125m through
   ``repro_torch.launch.train.main`` with the example's flags (4 workers,
   batch 16, seq 128, 2 local steps, ``--groups leaf``, 3 steps): a finite
   loss, below the seeded initial model's after the last step, exactly 2
   fused quantize and 3 mix launches per step;
   s/step, peak device memory, and the top device activities of one more
   step from torch.profiler;
8. the tiled path: the smoke config for 2 steps with
   ``REPRO_QUANT_TILE_D=512``, ``--groups block:embed,mlp,norm`` and
   ``--censor-mode group``: 2 tiled quantize launches per step;
9. one packed quantize step at the smoke width through the two-pass path
   (``stoch_quantize_grouped``) and the fused one: value-identical.

Before the last line it prints one JSON line with each kernel's launches
(counted over the path it serves, with the counts set to 0 just before
that path ran), parity error, times and bound, then nvidia-smi's
name/power-limit line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""
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


def time_kernels(ops, ref, dev):
    """Kernel, plain and library times at the main path's full-size
    shapes, with warm inputs (the main path finds them in L2)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n, d = FULL_N, FULL_D
    theta = torch.randn((n, d), generator=gen, device=dev)
    qprev = torch.randn((n, d), generator=gen, device=dev)
    unif = torch.rand((n, d), generator=gen, device=dev)
    qrange = (theta - qprev).abs().amax(dim=1)
    delta = 2.0 * qrange / 255.0
    q_args = (theta, qprev, unif, delta, qrange)
    adj = (torch.rand((n, n), generator=gen, device=dev) < 0.35).float()
    out = {"stoch_quantize": {
        "ms": time_ms(lambda: ops.stoch_quantize(*q_args)),
        "plain_ms": time_ms(lambda: ref.stoch_quantize_ref(*q_args)),
        "library_ms": None,
        "bound": bound(4.0 * (4 * n * d + 2 * n),
                       QUANT_OPS_PER_ELEM * n * d + 2 * n)}}
    out["bipartite_mix"] = {
        "ms": time_ms(lambda: ops.bipartite_mix(adj, theta)),
        "plain_ms": time_ms(lambda: ref.bipartite_mix_ref(adj, theta)),
        "library_ms": time_ms(lambda: torch.matmul(adj, theta)),
        "bound": bound(4.0 * (n * n + n * d + n * d), 2.0 * n * n * d)}
    kernel_fns = {
        "stoch_quantize": (lambda: ops.stoch_quantize(*q_args),
                           "stoch_quantize_kernel"),
        "bipartite_mix": (lambda: ops.bipartite_mix(adj, theta),
                          "bipartite_mix_kernel")}
    for name, t in out.items():
        fn, kname = kernel_fns[name]
        _, acts = device_times(fn, 50)
        hits = [(n, ms) for k, (n, ms) in acts.items() if kname in k]
        dev = (f"{sum(ms for _, ms in hits) / sum(n for n, _ in hits):.5f}"
               if hits else "not measured")
        log(f"time {name}: per call {t['ms']:.5f} ms (device only {dev} ms)"
            f", plain {t['plain_ms']:.5f} ms, library {t['library_ms']} ms, "
            f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
    return out


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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops, ref

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {len(build.SOURCES)} kernels in "
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
    launches = full_size(ops, dev)
    log(f"phase full size: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs.update(check_grouped_parity(ops, ref, dev))
    times.update(time_grouped(ops, ref, dev))
    log(f"phase grouped kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm = lm_full_width(ops, dev)
    log(f"phase lm full width: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tiled = lm_tiled(ops)
    log(f"phase lm tiled: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    two = twopass_vs_fused(ops, dev)
    log(f"phase two-pass vs fused: {time.perf_counter() - t0:.1f} s")
    launches.update(
        stoch_quantize_grouped_fused=lm["stoch_quantize_grouped_fused"],
        stoch_quantize_grouped_fused_tiled=tiled[
            "stoch_quantize_grouped_fused_tiled"],
        stoch_quantize_grouped=two["stoch_quantize_grouped"])
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
