"""Decentralized (CQ-GGADMM) LM trainer on the card.

The port of ``repro.launch.train``'s consensus path (``run_admm``): N
workers, each holding a full model, train on their own shards of the
synthetic token stream; every step runs the engine's head and tail phases
(``local_steps`` Adam steps on the augmented Lagrangian, grouped quantize,
censor) and the dual update, with the quantize and mix kernels on the
card. It logs loss, consensus error, transmitted bits and s/step, and
checkpoints the worker-stacked parameters in the JAX package's npz layout.
``--arch`` defaults to tinyllama-1.1b, as in the JAX CLI; every block
kind takes the engine's worker axis. qwen2-vl's and whisper's batches
carry their stub inputs (``data.lm.model_batch``: M-RoPE positions, vision
patch embeddings, audio frames, drawn with the step as their seed), and
whisper's encoder runs once per worker, on that worker's weights:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 1 --workers 2 --batch 2 --seq 16

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --smoke --workers 4 --batch 16 --seq 128 --local-steps 2 \\
        --lr 2e-3 --tau0 5.0 --xi 0.999 --bits 6 --omega 0.9995 \\
        --groups leaf --steps 3 [--device cpu]

Without ``--device cpu`` it runs on the CUDA card and raises when there is
none. ``REPRO_QUANT_TILE_D=<n>`` routes the fused quantize through its
D-tiled kernel. ``--mix-backend sparse`` mixes through the
``edge_gather_mix`` kernel. ``--fleet`` drives the run through the fleet
simulator (``fleet/sim.py``: straggler timeouts, bounded staleness, churn):

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --workers 4 --batch 16 --seq 128 --local-steps 2 --bits 6 \
        --groups leaf --mix-backend sparse --fleet \
        --fleet-participation 0.75 --fleet-staleness 2 \
        --fleet-churn 2:1:1 --steps 4

``--mix-backend sharded`` splits the worker rows over the ranks of a
``torch.distributed`` process group (``core/topology.py``): each rank holds
N/w workers' parameters, optimizer moments, quantizer state and batch rows,
and each mix is one all-gather of the value rows and ``bipartite_mix`` on
the rank's adjacency row block. Under ``torchrun`` each rank runs on
``cuda:LOCAL_RANK`` over NCCL, or over gloo with ``--device cpu``; started
alone, the trainer makes a group of one over a ``FileStore`` in a temporary
directory, so the collective runs in one process too. Rank 0 alone prints
and writes the checkpoint (theta gathered from every rank: the dense run's
file); the returned loss history, bits and group count are the same on
every rank. The rounding draws are made whole, (N, D), on every rank and cut
to its rows, so a run equals the world-1 run of the same seed:

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 2 \
        --mix-backend sharded [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --smoke --steps 2 \
        --mix-backend sharded [--device cpu]

``--fleet`` takes the sharded backend at world size 1 only (churn changes
N); ``--campaign`` runs it at world size 1.

``--mode fsdp`` is the FSDP-Adam baseline (:func:`run_fsdp`): one model, no
worker axis, AdamW (``optim/adamw.py``) on the token-weighted loss of the
whole batch every step. The JAX package's ``run_fsdp`` is one ``jax.jit``
program with no device mesh; this is the same single-device trainer (the
JAX package shards FSDP only in its mesh bundles, ``runtime/steps.py``,
which are not ported):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --mode fsdp --batch 8 --seq 512 --lr 1e-3 --steps 5 --log-every 1

``--trace out.json`` writes a Chrome-trace/Perfetto JSON of the run (as
``REPRO_TRACE=out.json`` does): a span per round and the communication
ledger's counters (cumulative transmissions, bits, transmit energy, censor
rate), with the fleet's fault and churn instants under ``--fleet``.
Tracing observes only: the run's results and kernel launches are those of
an untraced run, and the ledger's one host copy of a round's metrics is the
only synchronisation it adds.

``--campaign NAME`` runs a registered campaign (``bench/campaigns.py``:
``engine-smoke``, ``serve-smoke``, ``paper-figures``, ``lm-sweep``,
``fleet-sweep``, ``all``) through the resumable runner (``campaign/``) on
the card, or on the CPU with ``--device cpu``; ``--resume`` skips completed
runs and ``--campaign-only STAGE`` runs one stage plus its incomplete
dependencies (``kernels`` and ``roofline`` are stages of ``all``: ``--campaign
all --campaign-only roofline``). An unknown name raises ``KeyError``, as
the JAX package's ``get_campaign`` does. :func:`campaign_lm_run` is
``lm-sweep``'s stage function: one consensus-LM run of the smoke config
with its whole engine state checkpointed through the run context, so a
killed sweep resumes mid-run bit for bit. Results and run state go under
``--campaign-dir`` (``campaigns/torch``):

    PYTHONPATH=src python -m repro_torch.launch.train --campaign lm-sweep \
        [--resume] [--campaign-only lm-grid] [--device cpu]

Narrowed replicas (``hat_dtype``) have no flag here, as in the JAX
package: :func:`main` and :func:`run_admm` take ``hat_dtype=`` from a
caller, and the library's entries are ``EngineConfig`` and
``core.consensus.ConsensusConfig``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import npz as ckpt
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import topology as topo_lib
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
from repro_torch.device import resolve_device
from repro_torch.fleet import ChurnEvent, FaultConfig, FleetConfig, FleetSim
from repro_torch.fleet.sim import round_draws
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import registry
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import CommLedger
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import steps as ST


def lm_grad_fn(cfg):
    """Per-worker gradients of each worker's own loss: the losses of the
    workers are independent, so the gradient of their sum is each
    worker's gradient on its own rows."""
    def grad_fn(theta, batch):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in T.leaves(theta)]
            losses, _ = registry.lm_loss(T.unflatten(theta, leaves), cfg,
                                         batch)
            grads = torch.autograd.grad(losses.sum(), leaves)
        return T.unflatten(theta, list(grads))
    return grad_fn


def lm_loss_fn(cfg):
    def loss_fn(theta, batch):
        with torch.no_grad():
            return torch.mean(registry.lm_loss(theta, cfg, batch)[0])
    return loss_fn


def parse_churn(spec: str):
    """Parse ``--fleet-churn`` "round:leave:join[,round:leave:join...]"
    into a tuple of :class:`repro_torch.fleet.ChurnEvent`."""
    if not spec:
        return ()
    events = []
    for item in spec.split(","):
        parts = item.split(":")
        if len(parts) != 3:
            raise SystemExit(
                f"[train] bad --fleet-churn item {item!r}: expected "
                f"round:leave:join (e.g. '10:2:1,20:1:0')")
        try:
            events.append(ChurnEvent(round=int(parts[0]),
                                     leave=int(parts[1]),
                                     join=int(parts[2])))
        except (ValueError, AssertionError) as e:
            raise SystemExit(
                f"[train] bad --fleet-churn item {item!r}: {e}") from e
    return tuple(events)


def run_fleet(cfg, args, graph, ecfg, solver, loss_fn, theta, data, dev,
              uniforms=None, stubs=None) -> dict:
    """Drive the consensus run through FleetSim: straggler timeouts fold
    into the censor mask, late updates land through the bounded-staleness
    buffer, churn redraws the graph and remaps the state. Rounds without a
    fault run the plain synchronous step; per-round draws derive from
    ``(--seed, round)`` (or ``uniforms(round, phase)``), so the trajectory
    differs from :func:`run_admm`'s loop through its draws only. A round's
    stub inputs are drawn with the round as their seed (or taken from
    ``stubs(round)``), as the JAX package keys them."""
    fcfg = FleetConfig(
        rounds=args.steps,
        faults=FaultConfig(participation=args.fleet_participation,
                           staleness=args.fleet_staleness,
                           stale_frac=args.fleet_stale_frac,
                           churn=parse_churn(args.fleet_churn),
                           seed=args.fleet_seed),
        graph_seed=args.seed, seed=args.seed)
    per = args.batch // args.workers

    def batch_fn(r, members):
        return model_batch(cfg, data.worker_batch(r, len(members), per), dev,
                           step=r, stubs=None if stubs is None else stubs(r))

    try:
        sim = FleetSim(args.workers, ecfg, fcfg, theta, solver=solver,
                       extra_metrics=E.consensus_metrics(loss_fn),
                       batch_fn=batch_fn, graph0=graph, uniforms=uniforms)
    except ValueError as e:      # the sharded backend at world size > 1
        raise SystemExit(f"[train] --fleet: {e}") from e
    # the fleet traces its own rounds, faults and churn (FleetSim.run)
    t0 = time.perf_counter()
    fs, m = sim.run()
    history = [float(x) for x in m["loss"]]
    total_bits = float(np.sum(m["payload_bits_total"]))
    for i in range(args.steps):
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"round {i:4d}  loss={history[i]:.4f}  "
                  f"tx={int(m['tx_count'][i])}/{int(m['n_members'][i])}  "
                  f"bits={float(m['payload_bits_total'][i]):.3e}  "
                  f"({float(m['round_seconds'][i]):.2f}s)")
    for ev in m["churn_log"]:
        print(f"[fleet] round {ev['round']}: left={ev['left']} "
              f"joined={ev['joined']} -> {ev['n_members']} members")
    print(f"[fleet] {args.steps} rounds, participation="
          f"{args.fleet_participation} staleness={args.fleet_staleness}: "
          f"final_loss={history[-1]:.4f} cum_bits={total_bits:.3e} "
          f"({(time.perf_counter() - t0) / args.steps:.2f}s/round)",
          flush=True)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, fs.engine.theta)
    return {"final_loss": history[-1], "history": history,
            "total_bits": total_bits,
            "n_groups": fs.engine.quant.n_groups,
            "churn_log": m["churn_log"], "metrics": m,
            "step_seconds": [float(x) for x in m["round_seconds"]],
            "ledger": sim.ledger.totals() if sim.ledger else None,
            "sim": sim, "fleet_state": fs}


def run_admm(cfg, args, *, params=None,
             uniforms: Optional[Callable[[int, int], torch.Tensor]] = None,
             hat_dtype: Optional[str] = None,
             stubs: Optional[Callable[[int], dict]] = None) -> dict:
    """Train ``args.steps`` consensus steps. ``params`` (one model's tree,
    no worker axis) replaces the seeded init, ``uniforms(step, phase)``
    the (N, D) rounding draws and ``stubs(step)`` the step's stub inputs
    (``data.lm.model_batch``: vision embeds, audio frames); all serve
    parity tests. ``hat_dtype``
    narrows the replicas (``EngineConfig.hat_dtype``). Returns the loss
    history, total bits, group count, per-step (N, G) bit widths,
    transmitting workers and seconds, the final engine state and, with a
    tracer active, the ledger's totals and each step's host copy of the
    metrics.

    On the sharded backend (``--mix-backend sharded``; the process group
    from :func:`init_sharded_group`) this rank builds its own N/w workers
    and takes their rows of every step's batch and draws; the history,
    bits and group count come from metrics gathered over the ranks, the
    same on each, and ``state`` holds the rank's rows."""
    dev = rank_device(args.device)
    graph = ST.worker_graph(args.workers, args.topology)
    try:
        ecfg = E.EngineConfig(
            rho=args.rho,
            censor=CensorConfig(tau0=args.tau0, xi=args.xi)
            if args.tau0 > 0 else CensorConfig(),
            quantize=QuantConfig(b0=args.bits, omega=args.omega)
            if args.quantize else None,
            groups=args.groups,
            censor_mode=args.censor_mode,
            mix_backend=args.mix_backend,
            hat_dtype=hat_dtype,
            regroup_every=args.regroup_every)
    except E.GroupSpecError as e:
        raise SystemExit(
            f"[train] bad --groups spec: {e}\n"
            f"[train] buckets available for {cfg.name}: "
            f"{registry.param_bucket_names(cfg)}") from e

    try:
        topo = topo_lib.build(graph, ecfg.mix_backend, device=dev)
    except ValueError as e:      # workers not divisible by the ranks
        raise SystemExit(f"[train] {e}") from e
    rows = topo.worker_rows(args.workers)
    talk = topo.rank == 0          # rank 0 alone prints
    solver = E.InexactSolver(grad_fn=lm_grad_fn(cfg),
                             local_steps=args.local_steps, local_lr=args.lr)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = registry.init_params(cfg, gen, device=dev)
    # identical worker initialization: one shared init, workers diverge
    # only through their local data; each rank builds its own rows
    theta = T.tree_map(lambda x: x.to(dev)[None].repeat(
        (rows.stop - rows.start,) + (1,) * x.dim()), params)
    del params
    try:
        cur_ids = E.resolve_groups(theta, ecfg.groups)
    except E.GroupSpecError as e:
        raise SystemExit(
            f"[train] bad --groups spec for {cfg.name}: {e}\n"
            f"[train] buckets: {registry.param_buckets(cfg)}") from e
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, args.seq,
                                         seed=args.seed))
    if args.fleet:
        if args.regroup_every:
            raise SystemExit(
                "[train] --fleet is incompatible with --regroup-every: "
                "auto regrouping rebuilds the step on a schedule the fleet "
                "driver owns (churn already rebuilds it)")
        return run_fleet(cfg, args, graph, ecfg, solver, lm_loss_fn(cfg),
                         theta, data, dev, uniforms, stubs)
    state = E.init_state(theta, ecfg, solver)
    n_groups = state.quant.n_groups
    grouper = E.AutoGrouper.from_config(ecfg)

    def build_step(cfg_):
        return E.make_step(graph, cfg_, solver,
                           extra_metrics=E.consensus_metrics(
                               lm_loss_fn(cfg), topology=topo),
                           topology=topo)

    step = build_step(ecfg)
    # whole draws, cut to the rank's rows (2.15 GB a phase at the
    # xlstm-125m shape, on every rank)
    shape = (args.workers, E.tree_dim(theta))
    ugen = torch.Generator(device=dev).manual_seed(args.seed + 1000)
    # observers only: the ledger folds a host copy of the metrics the step
    # already returned, made inside the round span (so on the card the span
    # covers the round's device work); untraced, each site is one test
    tr = obs_trace.tracer()
    ledger = CommLedger(graph) if tr is not None else None
    rounds_tid = tr.track("engine", "rounds") if tr is not None else 0
    traced = []
    total_bits = 0.0
    history, seconds, bits_hist, tx_counts = [], [], [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t_step = time.perf_counter()
        if grouper is not None and grouper.should_regroup(i):
            new_ids = grouper.regroup(state.theta, state.quant.q_hat, topo)
            if new_ids != cur_ids:
                # stable-id regroup: carry conservative (R, b, Δ) per new
                # group and pin the spec to the explicit ids
                state = dataclasses.replace(
                    state, quant=E.remap_group_state(state.quant, cur_ids,
                                                     new_ids))
                ecfg = dataclasses.replace(ecfg, groups=new_ids)
                step = build_step(ecfg)
                cur_ids = new_ids
                n_groups = max(new_ids) + 1
                if talk:
                    print(f"[train] step {i}: regrouped to G={n_groups} "
                          f"({new_ids})")
        raw = data.worker_batch(i, args.workers, args.batch // args.workers)
        batch = E.cut_workers(model_batch(
            cfg, raw, dev, step=i, stubs=None if stubs is None else stubs(i)),
            topo)

        def draw(phase, i=i):
            if uniforms is not None:
                u = uniforms(i, phase).to(device=dev, dtype=torch.float32)
            else:
                u = torch.rand(shape, generator=ugen, device=dev)
            return u[rows]

        if tr is not None:
            tr.begin("round", "engine", rounds_tid, args={"round": i})
        state, m = step(state, draw, batch)
        m = E.gather_workers(m, topo)
        if ledger is not None:
            host = {k: v.cpu().numpy() for k, v in m.items()}
            ledger.update(host)
            traced.append(host)
        if tr is not None:
            tr.end("engine", rounds_tid)
        bits = float(m["payload_bits"].sum())   # already tx-masked
        total_bits += bits
        mean_bits = float(m["bits_per_group"].mean())
        history.append(float(m["loss"]))
        bits_hist.append(m["bits_per_group"].cpu().numpy())
        tx_counts.append(int(m["tx_mask"].sum()))
        seconds.append(time.perf_counter() - t_step)
        if talk and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss={history[-1]:.4f}  "
                  f"consensus_err={float(m['consensus_err']):.3e}  "
                  f"tx={tx_counts[-1]}/{args.workers}  "
                  f"groups={n_groups}  b/group={mean_bits:.1f}  "
                  f"cum_bits={total_bits:.3e}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_workers(args.ckpt_dir, i + 1, state.theta, topo)
    if args.ckpt_dir:
        save_workers(args.ckpt_dir, args.steps, state.theta, topo)
    return {"final_loss": history[-1], "history": history,
            "total_bits": total_bits, "n_groups": n_groups,
            "bits_per_group": bits_hist, "tx_counts": tx_counts,
            "step_seconds": seconds, "state": state,
            "ledger": ledger.totals() if ledger is not None else None,
            "traced_metrics": traced if ledger is not None else None}


def save_workers(ckpt_dir, step: int, theta, topo) -> None:
    """Checkpoint the worker-stacked parameters: on the sharded backend
    gathered from every rank (a collective: every rank calls this) and
    written by rank 0 alone."""
    theta = E.gather_workers(theta, topo)
    if topo.rank == 0:
        ckpt.save(ckpt_dir, step, theta)


def rank_device(device) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` under ``torchrun`` with a
    process group, unless ``--device`` names one."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None and dist.is_initialized()
            and "LOCAL_RANK" in os.environ):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def init_sharded_group(device) -> Optional[Callable[[], None]]:
    """The process group of ``--mix-backend sharded``: NCCL for the card,
    gloo for ``--device cpu``. Under ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` set) it joins the launcher's
    rendezvous; started alone, it is a group of one over a ``FileStore`` in
    a temporary directory. Returns the call that ends it, or None when the
    caller made the group already (it stays the caller's)."""
    if dist.is_initialized():
        return None
    cpu = resolve_device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return dist.destroy_process_group
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)

    def end():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return end


def fsdp_step(cfg, acfg: AdamWConfig):
    """One FSDP-Adam step, ``(params, opt, batch) -> (params, opt,
    loss)``: forward, backward and :func:`adamw_update` of one model on the
    batch's token-weighted loss."""
    def step(params, opt, batch):
        leaves = [x.detach().requires_grad_(True) for x in T.leaves(params)]
        with torch.enable_grad():
            loss = registry.lm_loss_tokens(T.unflatten(params, leaves),
                                           cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        params, opt = adamw_update(T.unflatten(params, list(grads)), opt,
                                   params, acfg)
        return params, opt, loss.detach()
    return step


def run_fsdp(cfg, args, *, params=None, stubs=None) -> dict:
    """The FSDP-Adam baseline: ``args.steps`` AdamW steps (lr ``args.lr``,
    the JAX package's defaults otherwise) of one model on
    ``data.batch(i, args.batch)``, the loss token-weighted over the whole
    batch (``registry.lm_loss_tokens``). ``params`` (one model's tree)
    replaces the seeded init for parity tests. Checkpoints hold the
    unstacked tree in the JAX npz layout. ``stubs(step)`` replaces a
    step's stub inputs, as in :func:`run_admm`. Returns the loss history,
    s/step and the peak device memory (bytes; 0 on the CPU)."""
    dev = resolve_device(args.device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = registry.init_params(cfg, gen, device=dev)
    params = T.tree_map(lambda x: x.to(dev), params)
    opt = adamw_init(params)
    step = fsdp_step(cfg, AdamWConfig(lr=args.lr))
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, args.seq,
                                         seed=args.seed))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history, seconds = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t_step = time.perf_counter()
        batch = model_batch(cfg, data.batch(i, args.batch), dev, step=i,
                            stubs=None if stubs is None else stubs(i))
        params, opt, loss = step(params, opt, batch)
        history.append(float(loss))              # waits for the device
        seconds.append(time.perf_counter() - t_step)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={history[-1]:.4f}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, params)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, params)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(f"[train] fsdp: {args.steps} steps, final_loss={history[-1]:.4f}, "
          f"peak device memory {peak / 1e9:.2f} GB", flush=True)
    return {"final_loss": history[-1], "history": history,
            "total_bits": 0.0, "step_seconds": seconds,
            "peak_device_bytes": peak, "params": params, "opt": opt}


# ------------------------------------------------------- campaign entry --
def calls_since(before: dict) -> dict:
    """Kernel-wrapper calls made since ``before = kernel_ops.calls()``, by
    kernel (on the card, its launches)."""
    return {k: n - before[k] for k, n in kernel_ops.calls().items()
            if n > before[k]}


def campaign_lm_run(section, quantize=True, groups="model",
                    censor_mode="global", mix_backend="dense",
                    workers=4, steps=12, batch=8, seq=64, local_steps=2,
                    arch="tinyllama-1.1b", rho=0.01, tau0=5.0, xi=0.995,
                    bits=4, omega=0.999, lr=1e-3, seed=0, ckpt_every=3,
                    compare_with=None, ctx=None, *, params=None,
                    uniforms=None):
    """One consensus-LM training run as a campaign stage function, on
    ``ctx.device`` (the card without a context).

    Deterministic given the config: step i's rounding draws come from a
    generator seeded from ``(seed, 1000 + i)`` (``fleet.sim.round_draws``;
    the JAX package keys the step with ``PRNGKey(1000 + i)``), never from
    one generator carried across steps, so a resumed run draws what an
    uninterrupted one does. The whole ``EngineState`` and the loss/bits
    histories are checkpointed through ``ctx`` every ``ckpt_every`` steps
    and at the end; a killed campaign restarts from the last complete
    checkpoint and finishes bit for bit where an uninterrupted run would.
    Emits the run's metrics at ``section``; with ``compare_with`` (the
    section of an earlier quantized run), also the paper's
    quantization-saves-bits claim against it. ``params`` (one model's
    tree) and ``uniforms(step, phase)`` replace the seeded init and draws
    (parity tests; neither is part of the run key).
    """
    from repro_torch.campaign.runner import FatalError
    from repro_torch.campaign.store import Claim, Record

    dev = resolve_device(ctx.device if ctx is not None else None)
    cfg = base.get_smoke_config(arch)
    graph = ST.worker_graph(workers, "random")
    ecfg = E.EngineConfig(
        rho=rho, censor=CensorConfig(tau0=tau0, xi=xi),
        quantize=QuantConfig(b0=bits, omega=omega) if quantize else None,
        groups=groups, censor_mode=censor_mode, mix_backend=mix_backend)
    solver = E.InexactSolver(grad_fn=lm_grad_fn(cfg),
                             local_steps=local_steps, local_lr=lr)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = registry.init_params(cfg, gen, device=dev)
    theta = T.tree_map(lambda x: x.to(dev)[None].repeat(
        (workers,) + (1,) * x.dim()), params)
    state = E.init_state(theta, ecfg, solver)
    step = E.make_step(graph, ecfg, solver,
                       extra_metrics=E.consensus_metrics(lm_loss_fn(cfg)),
                       device=dev)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq, seed=seed))
    shape = (workers, E.tree_dim(theta))

    loss_hist = np.full(steps, np.nan)
    bits_hist = np.full(steps, np.nan)
    start = 0
    if ctx is not None:
        restored = ctx.restore({"state": state, "loss": loss_hist,
                                "bits": bits_hist})
        if restored is not None:
            tree, start = restored
            state, loss_hist, bits_hist = (tree["state"], tree["loss"],
                                           tree["bits"])
            print(f"[lm-campaign] resumed {section[-1]} at step {start}")
    calls0 = kernel_ops.calls()
    for i in range(start, steps):
        raw = data.worker_batch(i, workers, batch // workers)
        b = model_batch(cfg, raw, dev, step=i)
        if uniforms is None:
            draw = round_draws(seed, 1000 + i, shape, dev)
        else:
            def draw(phase, i=i):
                return uniforms(i, phase).to(device=dev, dtype=torch.float32)
        state, m = step(state, draw, b)
        loss_hist[i] = float(m["loss"])
        bits_hist[i] = float(m["payload_bits"].sum())   # already tx-masked
        if ctx is not None and ((i + 1) % ckpt_every == 0
                                or i == steps - 1):
            ctx.checkpoint(i + 1, {"state": state, "loss": loss_hist,
                                   "bits": bits_hist})

    label = section[-1]
    total_bits = float(np.nansum(bits_hist))
    final_loss = float(loss_hist[-1])
    out = {"arch": cfg.name, "workers": workers, "steps": steps,
           "quantize": bool(quantize), "groups": groups,
           "censor_mode": censor_mode, "mix_backend": mix_backend,
           "final_loss": final_loss, "total_bits": total_bits,
           "loss_history": [float(x) for x in loss_hist],
           "resumed_from": start}
    print(f"[lm-campaign] {label}: final_loss={final_loss:.4f} "
          f"total_bits={total_bits:.4g} (groups={groups} "
          f"censor={censor_mode} backend={mix_backend})")
    print(f"[lm-campaign] {label}: kernel calls over steps {start}-"
          f"{steps - 1}: {calls_since(calls0)}", flush=True)
    claims = [Claim(f"lm_{label}_loss_finite".replace("|", "_"),
                    bool(np.isfinite(final_loss)), value=final_loss,
                    gate="finite")]
    if compare_with is not None:
        if ctx is None:
            raise FatalError("compare_with needs a run context")
        ref = ctx.store.section(tuple(compare_with))
        if ref is None:
            raise FatalError(f"section {compare_with} missing — run the "
                             f"quantized baseline first")
        saved = 1.0 - ref["total_bits"] / max(total_bits, 1e-9)
        ok = (ref["total_bits"] < 0.5 * total_bits
              and ref["final_loss"] < final_loss + 1.0)
        print(f"claim basis: quantization saved {saved:.0%} of bits, "
              f"dloss={ref['final_loss'] - final_loss:+.3f}")
        claims.append(Claim(
            "lm_quantization_saves_bits", ok, value=saved,
            gate="quantized bits < 0.5x unquantized, loss within 1.0"))
    return Record(section=tuple(section), data=out, claims=tuple(claims),
                  claims_path=("lm_sweep", "claims"))


def run_campaign(args) -> dict:
    """``--campaign``: the named campaign through the runner on
    ``--device``; the summary as the JAX trainer returns it. Each claim is
    printed with its value."""
    from repro_torch.bench import campaigns
    from repro_torch.campaign.runner import Runner
    from repro_torch.campaign.store import Record, ResultStore

    campaign = campaigns.get(args.campaign)
    resolve_device(args.device)      # no card and no --device cpu: raise
    root = Path(args.campaign_dir)
    calls0 = kernel_ops.calls()
    runner = Runner(campaign, store=ResultStore(root / "BENCH_engine.json"),
                    state_root=root, resume=args.resume,
                    only=args.campaign_only, device=args.device)
    summary = runner.run()
    for res in summary.results:
        if runner.completed(res.spec):
            with open(runner.run_dir(res.spec) / "record.json") as f:
                for c in Record.from_json(json.load(f)).claims:
                    print(f"# claim {c.name}: {c.ok} (value {c.value}; "
                          f"gate {c.gate})")
    print(f"[train] campaign {args.campaign}: kernel calls "
          f"{calls_since(calls0)}", flush=True)
    return {"campaign": args.campaign, "executed": summary.executed,
            "skipped": summary.skipped, "failed": summary.failed,
            "claim_failures": summary.claims_failed}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=base.list_architectures())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--mode", default="admm", choices=("admm", "fsdp"))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the CUDA card otherwise")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--topology", default="random",
                    choices=("random", "chain", "complete"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--tau0", type=float, default=5.0)
    ap.add_argument("--xi", type=float, default=0.995)
    ap.add_argument("--quantize", action="store_true", default=True)
    ap.add_argument("--no-quantize", dest="quantize", action="store_false")
    ap.add_argument("--groups", default="model",
                    help="quantization group spec: 'model' (G=1), 'leaf', "
                         "'block:embed,mlp,norm[,rest]', 'auto:K'")
    ap.add_argument("--regroup-every", type=int, default=0,
                    help="for --groups auto:K, re-cluster every this many "
                         "steps (0 keeps the initial partition)")
    ap.add_argument("--censor-mode", default="global",
                    choices=("global", "group"))
    ap.add_argument("--mix-backend", default="dense",
                    choices=("dense", "sparse", "sharded"))
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--omega", type=float, default=0.999)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet", action="store_true",
                    help="drive the run through FleetSim: straggler "
                         "timeouts, bounded-staleness delivery, churn")
    ap.add_argument("--fleet-participation", type=float, default=1.0,
                    help="per-round P(a worker's update arrives on time)")
    ap.add_argument("--fleet-staleness", type=int, default=0,
                    help="max delivery lag (rounds) of late updates; 0 "
                         "drops them")
    ap.add_argument("--fleet-stale-frac", type=float, default=1.0,
                    help="P(a late update is delayed rather than dropped)")
    ap.add_argument("--fleet-churn", default="",
                    help="membership changes as round:leave:join[,...], "
                         "e.g. '10:2:1,20:1:0'")
    ap.add_argument("--fleet-seed", type=int, default=0,
                    help="fault-schedule seed (replays the same trace)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of this run "
                         "to PATH (as REPRO_TRACE=PATH does); it observes "
                         "only: results and kernel launches are unchanged")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--campaign", default=None, metavar="NAME",
                    help="run a registered experiment campaign (e.g. "
                         "'lm-sweep') through the resumable campaign "
                         "runner instead of a single training run")
    ap.add_argument("--resume", action="store_true",
                    help="with --campaign: skip completed runs")
    ap.add_argument("--campaign-only", default=None, metavar="STAGE",
                    help="with --campaign: run one stage (plus its "
                         "incomplete dependencies)")
    ap.add_argument("--campaign-dir", default="campaigns/torch",
                    metavar="DIR",
                    help="with --campaign: results document and per-run "
                         "state (default campaigns/torch)")
    return ap


def main(argv=None, *, params=None, uniforms=None,
         hat_dtype: Optional[str] = None, stubs=None) -> dict:
    """The trainer's entry point. ``params``, ``uniforms`` and ``stubs``
    replace the seeded init, the rounding draws and the stub inputs
    (parity tests); ``hat_dtype`` narrows the consensus replicas (no flag,
    as in the JAX package)."""
    args = build_parser().parse_args(argv)
    if args.campaign:
        if args.trace:
            obs_trace.enable(args.trace)
        out = run_campaign(args)
        if args.trace:
            obs_trace.save()
        return out
    if args.mode == "admm" and args.batch % args.workers:
        raise SystemExit(f"[train] --batch {args.batch} is not a multiple of "
                         f"--workers {args.workers}")
    cfg = (base.get_smoke_config(args.arch) if args.smoke
           else base.get_config(args.arch))
    if args.mode == "fsdp" and args.fleet:
        raise SystemExit("[train] --fleet only applies to --mode admm "
                         "(the fleet simulator drives the consensus "
                         "engine, not the FSDP baseline)")
    sharded = args.mode == "admm" and args.mix_backend == "sharded"
    end_group = init_sharded_group(args.device) if sharded else None
    try:
        # on the sharded backend rank 0 alone prints and traces
        talk = not sharded or dist.get_rank() == 0
        if talk:
            print(f"[train] arch={cfg.name} mode={args.mode} workers="
                  f"{args.workers} batch={args.batch} seq={args.seq} "
                  f"steps={args.steps}" + (f" ranks={dist.get_world_size()}"
                                           if sharded else ""), flush=True)
        if args.trace and talk:
            obs_trace.enable(args.trace)
        if args.mode == "admm":
            out = run_admm(cfg, args, params=params, uniforms=uniforms,
                           hat_dtype=hat_dtype, stubs=stubs)
        else:
            out = run_fsdp(cfg, args, params=params, stubs=stubs)
        if args.trace and talk:
            obs_trace.save()
    finally:
        if end_group is not None:
            end_group()
    return out


if __name__ == "__main__":
    main()
