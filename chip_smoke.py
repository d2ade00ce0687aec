#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each run with nothing caught (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together) and time the build;
2. print the card's name and power limit as nvidia-smi reports them;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and ragged ones, and time kernel, plain version and
   (for the mix) ``torch.matmul`` with CUDA events;
4. paper size: quickstart part 1 (24 workers, synth-linear d=50, p=0.35,
   300 iterations) for ggadmm and cq-ggadmm on the card: distance to the
   optimum below 1e-8, 7200 rounds, and ggadmm's trajectory equal to the
   same run on the CPU within 1e-4 max|theta*|;
5. full size: cq-ggadmm on synth-linear at the width of the LIBSVM epsilon
   set (d=2000) over 64 workers of a p=0.35 random bipartite graph, 2048
   samples per worker (cut from epsilon's 400,000 rows to keep host-side
   generation near 5 GB), 20 iterations: the distance to the optimum falls
   and every kernel launch is counted (2 quantizes and 3 mixes per
   iteration).

Before the last line it prints one JSON line with each kernel's launches,
parity error, times and bound, then nvidia-smi's name/power-limit line;
the last line is ``{"ok": true, "device": {...}}``. Without CUDA it exits
non-zero before printing any result.
"""
import json
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
    assert counts == {"stoch_quantize": 2 * PAPER_ITERS,
                      "bipartite_mix": 2 * 3 * PAPER_ITERS}, counts
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
    assert launches == {"stoch_quantize": 2 * FULL_ITERS,
                        "bipartite_mix": 3 * FULL_ITERS}, launches
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

    meta = {
        "stoch_quantize": ("src/repro_torch/kernels/csrc/stoch_quant.cu",
                           "src/repro/kernels/stoch_quant.py:57"),
        "bipartite_mix": ("src/repro_torch/kernels/csrc/bipartite_mix.cu",
                          "src/repro/kernels/bipartite_mix.py:28"),
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
