"""The LM driver: CQ-GGADMM consensus training of a language model through
the program's trainer step, step after step, or through its fleet
simulator, round after round.

The configuration names its plain reference model (``reference``: a
module of ``perfbench/reference/`` that exports ``MODEL_KEYS``,
``layout``, ``init_scales``, ``losses``, ``Act``, ``fp8`` and
``token_flops``), the program's architecture (``arch``) and the worker
count (``workers``); nothing here names a model.

The loop is built as ``launch/train.py::run_admm`` builds it: the worker
graph of ``runtime/steps.worker_graph``, the engine configuration from the
trainer's flags, ``InexactSolver`` over ``train.lm_grad_fn`` (the model's
per-worker loss and autograd), ``engine.make_step`` with the consensus
metrics (the workers' mean loss after the step), one shared initial model
repeated over the workers. The benchmark makes the model's weights
(``inputs.lm_params``), each step's token rows (``inputs.lm_tokens``) and the
stochastic-rounding uniforms from the seed.

A mix with a ``fleet`` section runs ``launch/train.py::run_fleet``'s
``FleetSim`` on that graph, with the mix's faults drawn from the run's
seed, and steps it one round at a time as the loop body of
``FleetSim.run`` does: the schedule's ``round_faults``, ``round_draws``
(fed the benchmark's uniforms through the simulator's ``uniforms`` hook,
as the trainer's parity runs feed theirs), the synchronous step on a round
without a fault and nothing in flight and the fleet step otherwise, the
host copy of the round's metrics, and, in a traced run, the workers' fault
instants (``_trace_worker_events``) on an in-memory tracer of every round.
Churn is not driven.

Set-up builds the program's model from the configuration, checks that its
parameters are the reference's layout and that its state starts where
the reference's does, and runs ``setup_steps`` steps through the window's
own loop and feed. The window runs whole steps until ``seconds`` have
passed and ends at a device synchronisation; every worker computes in
every step (a fleet's late worker too), so a step consumes ``batch x seq``
tokens.

Every set-up step, and ``window_checks`` window steps among the first
``check_span`` drawn from the seed, are judged: their states before and
after, and what the solve's gradient function was handed and gave back
(``reference/lm_consensus.Recorder``), are copied to host memory, so that
the peak device memory stays the program's. The copies of a window step are
the harness's work, not the program's: their seconds are left out of the
window's time. After the window the program's state is freed and the
float32 reference judges each kept step stage by stage
(``reference/lm_consensus.check_step``). A fleet's every round is also
held to the fault draw and the delivery buffer worked out again
(``reference/fleet.check_rounds``), its judged rounds stage by stage under
those masks.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs
from perfbench import trace as trace_lib
from perfbench.drivers.planted import planted
from perfbench.reference import fleet as fleet_ref
from perfbench.reference import graph as ref_graph
from perfbench.reference import lm_consensus as ref

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")
# a fleet's own: a late packet delivered at once, a timeout not applied
FLEET_FAULTS = FAULTS + ("deliver_now", "no_timeout")
SAMPLE_STREAM = 3


def faults_of(mix: dict) -> tuple:
    """The faults the cell's comparison is shown to catch."""
    return FLEET_FAULTS if "fleet" in mix else FAULTS


def arch_of(cfg: dict) -> ModuleType:
    """The configuration's plain reference model,
    ``perfbench/reference/<cfg["reference"]>.py``."""
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def model_of(cfg: dict) -> dict:
    return {k: cfg[k] for k in arch_of(cfg).MODEL_KEYS}


def losses_of(cfg: dict) -> ref.LossFn:
    """Each worker's loss by the reference model, at the configuration's
    sizes."""
    arch, model = arch_of(cfg), model_of(cfg)

    def losses(params, tokens, labels, act):
        return arch.losses(params, tokens, labels, model, act)
    return losses


def nest(flat: Dict[tuple, torch.Tensor]) -> dict:
    """A tree of nested dicts from leaves by path."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def reference_graph(cfg: dict):
    return ref_graph.random_bipartite_graph(cfg["workers"], cfg["graph_p"],
                                            cfg["graph_seed"])


def program_model(cfg: dict):
    """The program's model configuration for the benchmark's, checked
    against the reference's parameter layout."""
    from repro_torch.configs import base
    from repro_torch.core import tree as T
    from repro_torch.models import registry

    mcfg = base.get_config(cfg["arch"]).with_overrides(
        dtype=cfg["dtype"], **model_of(cfg))
    meta = registry.init_params(mcfg, device="meta")
    got = [(p, tuple(x.shape)) for p, x in T.flatten_with_path(meta)]
    want = list(arch_of(cfg).layout(model_of(cfg)).items())
    if got != want:
        raise ValueError(f"the program's {cfg['arch']} is not the "
                         f"configuration's model: {got} != {want}")
    return mcfg


def rows_of(cfg, mix, seed, step, fault=None):
    """A step's (N, B, S) tokens and labels; with a planted fault, the
    rows the faulty program is fed."""
    n, per, seq = cfg["workers"], cfg["batch"] // cfg["workers"], cfg["seq"]
    tokens, labels = inputs.lm_tokens(mix, cfg["vocab_size"], seed, step, n,
                                      per, seq)
    if fault == "half_batch":
        tokens, labels = tokens[:, :per // 2], labels[:, :per // 2]
    elif fault == "altered":
        labels = labels.copy()
        labels[0] = (labels[0] + 1) % cfg["vocab_size"]
    return tokens, labels


def sampled_steps(mix: dict, seed: int) -> set:
    """The window steps judged, drawn from the seed."""
    rng = np.random.default_rng(inputs.stream_seed(seed, SAMPLE_STREAM))
    return set(int(i) for i in rng.choice(
        mix["check_span"], size=mix["window_checks"], replace=False))


def fleet_faults(mix: dict) -> Optional[fleet_ref.Faults]:
    return fleet_ref.Faults.of(mix["fleet"]) if "fleet" in mix else None


def attach_fleet(records: List[dict], rounds: List[dict], seed: int,
                 faults: fleet_ref.Faults, n: int) -> List[dict]:
    """Every round's reported masks and bits held to the draw and buffer
    worked out again; each judged record gets its round's part of the
    judge (``lm_consensus.check_step``'s ``fleet``) and the wrong entries
    of the rounds since the record before it (the last record those of the
    rounds after it too). Returns the masks worked out, by round."""
    errors, masks = fleet_ref.check_rounds(rounds, seed, faults, range(n))
    done = 0
    for j, rec in enumerate(records):
        i = rec["step"]
        upto = len(rounds) if j == len(records) - 1 else i + 1
        rec["fleet"] = {"before": rec["before"]["buffer"],
                        "after": rec["after"]["buffer"],
                        "reported": rounds[i], "want": masks[i],
                        "round_errors": sum(errors[done:upto])}
        done = upto
    return masks


class _Steps:
    """The consensus loop of ``run_admm``: one engine step a step."""

    def __init__(self, graph, ecfg, solver, metrics, theta, draw, batch_of,
                 fault):
        from repro_torch.core import engine as E
        from repro_torch.core import topology as topo_lib
        from repro_torch.core import tree as T

        self.topo = topo_lib.build(graph, ecfg.mix_backend,
                                   device=T.leaves(theta)[0].device)
        self.state = E.init_state(theta, ecfg, solver)
        self.step = E.make_step(graph, ecfg, solver,
                                extra_metrics=metrics(self.topo),
                                topology=self.topo)
        self.draw, self.batch_of, self.fault = draw, batch_of, fault

    @property
    def engine(self):
        return self.state

    def buffer(self) -> Optional[dict]:
        return None

    def advance(self, i: int) -> dict:
        new, m = self.step(self.state, lambda phase: self.draw(),
                           self.batch_of(i))
        if self.fault != "unchanged":
            self.state = new
        return m

    def close(self) -> None:
        del self.state, self.step, self.topo


class _Rounds:
    """``FleetSim.run``'s loop body, a round at a time, on the program's
    ``FleetSim``; the host copy of each round's masks and bits kept for
    the judge."""

    def __init__(self, graph, ecfg, solver, metrics, theta, draw, batch_of,
                 fault, mix, seed):
        from repro_torch.core import engine as E
        from repro_torch.fleet import (FaultConfig, FleetConfig, FleetSim,
                                       init_fleet_state)

        f = mix["fleet"]
        fcfg = FleetConfig(
            rounds=1,
            faults=FaultConfig(participation=f["participation"],
                               staleness=f["staleness"],
                               stale_frac=f["stale_frac"],
                               skew=f.get("skew", 0.0), seed=seed),
            graph_seed=0, seed=seed)
        self.sim = FleetSim(
            graph.n, ecfg, fcfg, theta, solver=solver,
            extra_metrics_factory=lambda members, graph_, topo: metrics(
                topo),
            batch_fn=lambda r, members: batch_of(r), graph0=graph,
            uniforms=lambda r, phase: draw())
        self.fs = init_fleet_state(E.init_state(theta, ecfg,
                                                self.sim.solver))
        self.width = E.tree_dim(theta)
        self.fault = fault
        self.rounds: List[dict] = []
        self.tracer = None           # the fault instants' tracer, if any

    @property
    def engine(self):
        return self.fs.engine

    def buffer(self) -> dict:
        from repro_torch.core import tree as T

        fs = self.fs
        return ref.buffer_snapshot(dict(T.flatten_with_path(fs.held_hat)),
                                   fs.held_payload, fs.timer)

    def advance(self, r: int) -> dict:
        from repro_torch.core import engine as E
        from repro_torch.fleet import sim as sim_lib

        sim = self.sim
        rf = sim.schedule.round_faults(r, sim.members)
        batch = sim._cut(sim.batch_fn(r, tuple(sim.members)))
        n = len(sim.members)
        draw = sim_lib.round_draws(sim.fleet_cfg.seed, r, (n, self.width),
                                   sim.device, sim.uniforms)
        if (not rf.drop.any() and not rf.lag.any()
                and not sim._host_timer.any()):
            state, m = sim._sync_step(self.fs.engine, draw, batch)
            new = dataclasses.replace(self.fs, engine=state)
            del state
            host = sim_lib._to_host(E.gather_workers(m, sim.topo))
            host["fleet_participation"] = np.ones(n, np.float32)
            host["fleet_start"] = np.zeros(n, np.float32)
            host["fleet_deliver"] = np.zeros(n, np.float32)
            host["fleet_timer"] = np.zeros(n, np.int32)
        else:
            new, m = sim._step(
                self.fs, draw, batch,
                sim._cut(torch.as_tensor(rf.drop, device=sim.device)),
                sim._cut(torch.as_tensor(rf.lag, device=sim.device)))
            host = sim_lib._to_host(E.gather_workers(m, sim.topo))
            sim._host_timer = host["fleet_timer"].astype(np.int32)
        del m
        if self.fault != "unchanged":
            self.fs = new
        if self.tracer is not None:
            sim._trace_worker_events(self.tracer, r, rf, host)
        self.rounds.append({k: host[k] for k in fleet_ref.REPORTED})
        return host

    def close(self) -> None:
        del self.fs, self.sim


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, fault: Optional[str] = None) -> dict:
    from repro_torch.core import engine as E
    from repro_torch.core import tree as T
    from repro_torch.core.censoring import CensorConfig
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.data.lm import model_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime import steps as ST

    cuda = torch.device(device).type == "cuda"
    n = cfg["workers"]
    arch, faults = arch_of(cfg), fleet_faults(mix)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def flat(tree):
        return dict(T.flatten_with_path(tree))

    recorder = ref.Recorder(cfg["local_steps"])
    t_built = time.perf_counter()
    with planted(fault):
        mcfg = program_model(cfg)
        params = inputs.lm_params(arch, model_of(cfg), seed, device)
        theta = T.tree_map(lambda x: x[None].repeat((n,) + (1,) * x.dim()),
                           nest(params))
        graph = ST.worker_graph(n, "random")
        ecfg = E.EngineConfig(
            rho=cfg["rho"],
            censor=CensorConfig(tau0=cfg["tau0"], xi=cfg["xi"]),
            quantize=QuantConfig(b0=cfg["bits"], omega=cfg["omega"],
                                 b_max=cfg["b_max"]),
            groups=cfg["groups"], censor_mode="global",
            mix_backend=mix["mix_backend"])
        solver = E.InexactSolver(
            grad_fn=recorder.wrap(train.lm_grad_fn(mcfg), flat),
            local_steps=cfg["local_steps"], local_lr=cfg["lr"])
        width = E.tree_dim(theta)
        gen = inputs.draw_generator(seed, device)

        def draw() -> torch.Tensor:
            return torch.rand((n, width), generator=gen, device=device)

        def batch_of(i: int):
            tokens, labels = rows_of(cfg, mix, seed, i, fault)
            return model_batch(mcfg, {"tokens": tokens, "labels": labels},
                               device, step=i)

        def metrics(topo):
            return E.consensus_metrics(train.lm_loss_fn(mcfg), topology=topo)

        args = (graph, ecfg, solver, metrics, theta, draw, batch_of, fault)
        loop = (_Rounds(*args, mix, seed) if faults is not None
                else _Steps(*args))
        del theta, args
        if trace and faults is not None:
            loop.tracer = obs_trace.Tracer(None)

        def view(st) -> dict:
            q = st.quant
            return {"theta": flat(st.theta), "theta_hat": flat(st.theta_hat),
                    "alpha": flat(st.alpha), "q_hat": flat(q.q_hat),
                    "mu": flat(st.opt_mu), "nu": flat(st.opt_nu),
                    "range": q.range_prev, "bits": q.bits_prev,
                    "delta": q.delta_prev, "init": q.initialized, "k": st.k}

        n_groups = loop.engine.quant.n_groups
        start_errors = ref.state_errors(view(loop.engine), ref.initial_state(
            params, n, n_groups, cfg["bits"]))
        params = ref.to_host(params)

        def start() -> dict:
            out = ref.initial_state(params, n, n_groups, cfg["bits"])
            if faults is not None:
                out["buffer"] = ref.empty_buffer(n)
            return out

        def snap() -> dict:
            out = ref.snapshot(view(loop.engine))
            if faults is not None:
                out["buffer"] = loop.buffer()
            return out

        counter = {"steps": 0}

        def advance():
            i = counter["steps"]
            counter["steps"] += 1
            return loop.advance(i)

        records = []

        def judged() -> float:
            """One step, kept for the judge; the seconds spent copying."""
            sync()
            t0 = time.perf_counter()
            i = counter["steps"]
            before = ref.state_before(records, i, start(), snap)
            draws = gen.get_state()
            copying = time.perf_counter() - t0
            recorder.on = True
            m = advance()
            loss = float(m["loss"])
            recorder.on = False
            t1 = time.perf_counter()
            records.append({"step": i, "before": before, "after": snap(),
                            "calls": recorder.take(), "draws": draws,
                            "loss": loss})
            copying += time.perf_counter() - t1 + recorder.seconds
            recorder.seconds = 0.0
            return copying

        built = time.perf_counter()
        for _ in range(mix["setup_steps"]):
            judged()
        sync()
        setup_end = time.perf_counter()

        sampled = sampled_steps(mix, seed)
        summary, traced_from = None, None
        steps, copying = 0, 0.0
        t0 = time.perf_counter()
        ends = []
        while True:
            if trace and steps == mix["trace_after"]:
                traced_from = counter["steps"]
                summary = trace_lib.traced(advance, mix["trace_steps"],
                                           lambda: ops.launches)
                steps += mix["trace_steps"]
            elif steps in sampled:
                copying += judged()
                steps += 1
            else:
                advance()
                steps += 1
            ends.append(time.perf_counter() - t0 - copying)
            if (ends[-1] >= seconds
                    and steps >= mix["check_span"]
                    and (not trace or summary is not None)):
                break
        sync()
        window_s = time.perf_counter() - t0 - copying
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        work = {"workers": n, "width": width,
                "token_flops": arch.token_flops(model_of(cfg), cfg["seq"]),
                "tokens_per_step": cfg["batch"] * cfg["seq"],
                "local_steps": cfg["local_steps"]}
        if faults is not None:
            work["table"], work["valid"] = loop.sim.graph.neighbor_table
            rounds = loop.rounds
            if loop.tracer is not None:
                work["fleet_events"] = loop.tracer.events()
                work["traced_rounds"] = (traced_from,
                                         traced_from + mix["trace_steps"])
        loop.close()
        del loop, solver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"[perfbench] set-up: built in {built - t_built:.3f} s, "
          f"{mix['setup_steps']} judged steps in {setup_end - built:.3f} s; "
          f"window {window_s:.3f} s of steps ending at {ends} s, "
          f"{copying:.3f} s copying judged steps to host", file=sys.stderr)
    t_judge = time.perf_counter()
    dark = None
    if faults is not None:
        masks = attach_fleet(records, rounds, seed, faults, n)
        if "traced_rounds" in work:
            lo, hi = work["traced_rounds"]
            dark = 100.0 * fleet_ref.dark_rounds(masks, lo, hi) / (
                n * (hi - lo))
            print(f"[perfbench] fleet: rounds {lo}-{hi - 1} dark "
                  f"{dark!r}% of worker-rounds by the judge's draw",
                  file=sys.stderr)
    readings, each = ref.judge_steps(
        records, lambda rec: step_inputs(cfg, mix, seed, rec, device),
        reference_graph(cfg), losses_of(cfg), ref.Settings.of(cfg), device,
        start_errors)
    for rec, r in zip(records, each):
        print(f"[perfbench] step {rec['step']}: {r}", file=sys.stderr)
    print(f"[perfbench] judged {len(records)} steps in "
          f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    tokens = steps * cfg["batch"] * cfg["seq"]
    return {"iterations": steps, "done": tokens, "window_s": window_s,
            "setup_end": setup_end, "peak_bytes": peak, "readings": readings,
            "per_iteration": each, "attempted": steps,
            "summary": summary, "work": work, "dark_share": dark}


def step_inputs(cfg, mix, seed, rec, device):
    """A judged step's rows (as the benchmark made them, whatever the
    program was fed) and its two uniform draws, drawn again from the
    generator's state before the step (``rec["draws"]``)."""
    tokens, labels = rows_of(cfg, mix, seed, rec["step"])
    gen = torch.Generator(device=device)
    gen.set_state(rec["draws"])
    n = cfg["workers"]
    width = sum(int(np.prod(s)) for s in
                arch_of(cfg).layout(model_of(cfg)).values())
    u0 = torch.rand((n, width), generator=gen, device=device)
    u1 = torch.rand((n, width), generator=gen, device=device)
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(labels, device=device), u0, u1)
