"""Decentralized (CQ-GGADMM) LM trainer on the card.

The port of ``repro.launch.train``'s consensus path (``run_admm``): N
workers, each holding a full model, train on their own shards of the
synthetic token stream; every step runs the engine's head and tail phases
(``local_steps`` Adam steps on the augmented Lagrangian, grouped quantize,
censor) and the dual update, with the quantize and mix kernels on the
card. It logs loss, consensus error, transmitted bits and s/step, and
checkpoints the worker-stacked parameters in the JAX package's npz layout.

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

``--mode fsdp``, ``--campaign`` and ``--trace`` are not ported yet
(ROADMAP.md) and exit with a message.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import npz as ckpt
from repro_torch.configs import base
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.lm import SyntheticLM, SyntheticLMConfig, model_batch
from repro_torch.device import resolve_device
from repro_torch.fleet import ChurnEvent, FaultConfig, FleetConfig, FleetSim
from repro_torch.models import registry
from repro_torch.runtime import steps as ST

NOT_PORTED = "is not ported yet (ROADMAP.md queue A)"


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
              uniforms=None) -> dict:
    """Drive the consensus run through FleetSim: straggler timeouts fold
    into the censor mask, late updates land through the bounded-staleness
    buffer, churn redraws the graph and remaps the state. Rounds without a
    fault run the plain synchronous step; per-round draws derive from
    ``(--seed, round)`` (or ``uniforms(round, phase)``), so the trajectory
    differs from :func:`run_admm`'s loop through its draws only."""
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
        return model_batch(cfg, data.worker_batch(r, len(members), per), dev)

    sim = FleetSim(args.workers, ecfg, fcfg, theta, solver=solver,
                   extra_metrics=E.consensus_metrics(loss_fn),
                   batch_fn=batch_fn, graph0=graph, uniforms=uniforms)
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
            "sim": sim, "fleet_state": fs}


def run_admm(cfg, args, *, params=None,
             uniforms: Optional[Callable[[int, int], torch.Tensor]] = None
             ) -> dict:
    """Train ``args.steps`` consensus steps. ``params`` (one model's tree,
    no worker axis) replaces the seeded init, and ``uniforms(step, phase)``
    the (N, D) rounding draws; both serve parity tests. Returns the loss
    history, total bits, group count, per-step (N, G) bit widths and
    seconds, and the final engine state."""
    dev = resolve_device(args.device)
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
            regroup_every=args.regroup_every)
    except E.GroupSpecError as e:
        raise SystemExit(
            f"[train] bad --groups spec: {e}\n"
            f"[train] buckets available for {cfg.name}: "
            f"{registry.param_bucket_names(cfg)}") from e
    except NotImplementedError as e:
        raise SystemExit(f"[train] {e}") from e

    solver = E.InexactSolver(grad_fn=lm_grad_fn(cfg),
                             local_steps=args.local_steps, local_lr=args.lr)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = registry.init_params(cfg, gen, device=dev)
    # identical worker initialization: one shared init, workers diverge
    # only through their local data
    theta = T.tree_map(lambda x: x.to(dev)[None].repeat(
        (args.workers,) + (1,) * x.dim()), params)
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
                         theta, data, dev, uniforms)
    state = E.init_state(theta, ecfg, solver)
    n_groups = state.quant.n_groups
    grouper = E.AutoGrouper.from_config(ecfg)

    def build_step(cfg_):
        return E.make_step(graph, cfg_, solver,
                           extra_metrics=E.consensus_metrics(lm_loss_fn(cfg)),
                           device=dev)

    step = build_step(ecfg)
    shape = (args.workers, E.tree_dim(theta))
    ugen = torch.Generator(device=dev).manual_seed(args.seed + 1000)
    total_bits = 0.0
    history, seconds, bits_hist = [], [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        t_step = time.perf_counter()
        if grouper is not None and grouper.should_regroup(i):
            new_ids = grouper.regroup(state.theta, state.quant.q_hat)
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
                print(f"[train] step {i}: regrouped to G={n_groups} "
                      f"({new_ids})")
        raw = data.worker_batch(i, args.workers, args.batch // args.workers)
        batch = model_batch(cfg, raw, dev)

        def draw(phase, i=i):
            if uniforms is not None:
                return uniforms(i, phase).to(device=dev, dtype=torch.float32)
            return torch.rand(shape, generator=ugen, device=dev)

        state, m = step(state, draw, batch)
        bits = float(m["payload_bits"].sum())   # already tx-masked
        total_bits += bits
        mean_bits = float(m["bits_per_group"].mean())
        history.append(float(m["loss"]))
        bits_hist.append(m["bits_per_group"].cpu().numpy())
        seconds.append(time.perf_counter() - t_step)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={history[-1]:.4f}  "
                  f"consensus_err={float(m['consensus_err']):.3e}  "
                  f"tx={int(m['tx_mask'].sum())}/{args.workers}  "
                  f"groups={n_groups}  b/group={mean_bits:.1f}  "
                  f"cum_bits={total_bits:.3e}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, state.theta)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state.theta)
    return {"final_loss": history[-1], "history": history,
            "total_bits": total_bits, "n_groups": n_groups,
            "bits_per_group": bits_hist, "step_seconds": seconds,
            "state": state}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="xlstm-125m",
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
                    help=f"Chrome-trace output {NOT_PORTED}")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--campaign", default=None, metavar="NAME",
                    help=f"the campaign runner {NOT_PORTED}")
    return ap


def main(argv=None, *, params=None, uniforms=None) -> dict:
    args = build_parser().parse_args(argv)
    for flag, given in (("--trace", args.trace), ("--campaign", args.campaign),
                        ("--mode fsdp", args.mode == "fsdp")):
        if given:
            raise SystemExit(f"[train] {flag} {NOT_PORTED}")
    if args.batch % args.workers:
        raise SystemExit(f"[train] --batch {args.batch} is not a multiple of "
                         f"--workers {args.workers}")
    cfg = (base.get_smoke_config(args.arch) if args.smoke
           else base.get_config(args.arch))
    print(f"[train] arch={cfg.name} mode={args.mode} workers={args.workers} "
          f"batch={args.batch} seq={args.seq} steps={args.steps}", flush=True)
    return run_admm(cfg, args, params=params, uniforms=uniforms)


if __name__ == "__main__":
    main()
