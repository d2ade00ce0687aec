"""FleetSim: the consensus engine under injected fleet faults
(DESIGN.md §Fleet).

The port of ``repro.fleet.sim``. It runs ``core/engine.py`` through
straggler timeouts, bounded-staleness delivery and worker churn, and keeps
the fault-free path bit-identical to the synchronous engine:

* **Partial participation.** Each round's :class:`~repro_torch.fleet.
  faults.FaultSchedule` draw becomes the engine step's ``participation``
  mask. A timed-out worker is a censored one (``censoring.compose_tx_mask``):
  its primal and quantizer chain advance, its ``theta_hat`` replica stays
  stale, and it is charged zero bits.
* **Bounded staleness.** A one-slot delivery buffer per worker. A delayed
  worker computes its round-r update on time; if its censor test passes,
  its committed reconstruction (``quant.q_hat``) and offered bits are
  parked and the worker goes dark for ``lag`` rounds. When the timer runs
  out the held value lands in ``theta_hat`` and the held bits are charged.
* **Churn.** Join and leave events redraw the graph
  (``graph.membership_graph``), rebuild the topology (``Topology.rebuild``)
  and remap every worker-axis row of the engine and buffer state; joiners
  start from the survivors' mean (or zeros) with a fresh b0-bit quantizer,
  and the duals are re-initialized in ``col(M_-)`` of the new graph
  (``dynamic.reinit_duals``).

On the sharded backend (``core/topology.py``) each rank of the process
group holds the rows ``[r·N/w, (r+1)·N/w)`` of every worker-axis quantity:
the engine state, the delivery buffer, the round's draws, fault masks and
batch, and the solver's data. Every rank keeps the whole fleet's host
bookkeeping (the fault schedule, the members, the staleness-timer shadow and
the round's metrics, gathered from every rank), so each rank takes the same
step at every round and enters the same collectives. At a churn event the
whole fleet state is gathered from every rank, remapped the same way on
each, and cut to the rows of the rebuilt topology; a new worker count the
world does not divide raises the topology's divisibility ``ValueError`` at
that round on every rank. A sharded fleet's state equals the world-1 run's.

The host loop (:class:`FleetSim`) steps one round at a time. Per-round
rounding draws come from a ``torch.Generator`` seeded from ``(seed,
round)`` (:func:`round_draws`), or from a ``uniforms(round, phase)`` hook
(the parity tests feed the JAX package's draws through it); the fault
schedule is a pure function of its config. With a tracer active
(``obs.trace``, ``--trace``) each round is a span on the ``fleet/rounds``
track, churn an instant there, each worker's drop, lag_start and deliver an
instant on its ``fleet/worker <gid>`` track, and a ``CommLedger`` streams
the cumulative transmissions, bits and energy; all of it reads the round's
fault draw and the host copy of its metrics the loop makes anyway, so a
traced run is the untraced one bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dynamic as dyn_lib
from repro_torch.core import engine as E
from repro_torch.core import topology as topo_lib
from repro_torch.core import tree as T
from repro_torch.core.graph import WorkerGraph, membership_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.fleet.faults import FaultConfig, FaultSchedule
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import CommLedger

Tree = Any


# ---------------------------------------------------------------- state --
@dataclasses.dataclass(frozen=True)
class FleetState:
    """Engine state and the bounded-staleness delivery buffer (worker axis
    N throughout). ``held_hat`` rows mean something only where
    ``timer > 0`` (one packet in flight per worker)."""

    engine: E.EngineState
    held_hat: Tree               # parked transmissions (theta_hat dtype)
    held_payload: torch.Tensor   # (N,) float32 bits to charge at delivery
    timer: torch.Tensor          # (N,) int32 rounds until delivery (0 idle)


def init_fleet_state(state: E.EngineState) -> FleetState:
    first = T.leaves(state.theta_hat)[0]
    n = first.shape[0]
    return FleetState(
        engine=state,
        held_hat=T.tree_map(torch.zeros_like, state.theta_hat),
        held_payload=torch.zeros((n,), dtype=torch.float32,
                                 device=first.device),
        timer=torch.zeros((n,), dtype=torch.int32, device=first.device),
    )


def round_draws(seed: int, r: int, shape: Tuple[int, int], device,
                uniforms: Optional[E.Uniforms] = None
                ) -> Callable[[int], torch.Tensor]:
    """``draw(phase)`` of round ``r``: (N, D) float32 uniforms from a
    generator seeded from ``(seed, r)`` (phase 0, then phase 1), or
    ``uniforms(r, phase)`` when given."""
    gen = None
    if uniforms is None:
        derived = int(np.random.SeedSequence([seed, r]).generate_state(1)[0])
        gen = torch.Generator(device=device).manual_seed(derived)

    def draw(phase: int) -> torch.Tensor:
        if uniforms is not None:
            return uniforms(r, phase).to(device=device, dtype=torch.float32)
        return torch.rand(shape, generator=gen, device=device)
    return draw


# ----------------------------------------------------------- fleet step --
def make_fleet_step(graph: WorkerGraph, cfg: E.EngineConfig, solver,
                    extra_metrics: Optional[E.MetricsFn] = None, *,
                    topology: Optional[topo_lib.Topology] = None,
                    device=None):
    """Wrap the engine step with the staleness-buffer automaton:
    ``fstep(fleet_state, draw, batch, drop, lag) -> (fleet_state,
    metrics)``, ``drop`` (N,) float32 and ``lag`` (N,) int32 from the
    fault schedule, on the state's device. :class:`FleetSim` runs it only
    on rounds that carry a fault.

    Metrics are the engine's, with ``payload_bits``/``tx_mask`` turned into
    arrival accounting (a stale packet delivered this round counts as a
    transmission and charges its held bits), plus ``fleet_participation``,
    ``fleet_start``, ``fleet_deliver`` and ``fleet_timer``."""
    engine_step = E.make_step(graph, cfg, solver, extra_metrics,
                              topology=topology, device=device)

    def fstep(fs: FleetState, draw, batch, drop: torch.Tensor,
              lag: torch.Tensor):
        inflight = fs.timer > 0
        start = (lag > 0) & (drop == 0) & ~inflight
        startf = start.to(torch.float32)
        inflightf = inflight.to(torch.float32)
        # a worker is dark while dropped, buffering, or in flight
        participation = (1.0 - drop) * (1.0 - startf) * (1.0 - inflightf)

        state, m = engine_step(fs.engine, draw, batch, participation)

        # buffer a delayed packet only if its censor test passed
        started = startf * m["censor_mask"]
        held_hat = E.tree_where_worker(started, state.quant.q_hat,
                                       fs.held_hat)
        timer_dec = torch.where(inflight, fs.timer - 1,
                                torch.zeros_like(fs.timer))
        deliverf = (inflight & (timer_dec == 0)).to(torch.float32)
        timer = torch.where(started > 0, lag, timer_dec).to(torch.int32)
        held_payload = torch.where(
            started > 0, m["offered_payload_bits"],
            torch.where(deliverf > 0, torch.zeros_like(fs.held_payload),
                        fs.held_payload))

        # delivery: the parked value becomes the fleet-visible theta_hat
        theta_hat = E.tree_where_worker(deliverf, fs.held_hat,
                                        state.theta_hat)
        state = dataclasses.replace(state, theta_hat=theta_hat)

        metrics = dict(m)
        metrics["payload_bits"] = m["payload_bits"] \
            + fs.held_payload * deliverf
        metrics["tx_mask"] = torch.clamp_max(m["tx_mask"] + deliverf, 1.0)
        metrics["fleet_participation"] = participation
        metrics["fleet_start"] = started
        metrics["fleet_deliver"] = deliverf
        metrics["fleet_timer"] = timer
        return FleetState(engine=state, held_hat=held_hat,
                          held_payload=held_payload, timer=timer), metrics

    return fstep


# -------------------------------------------------------- churn remapping --
def _gather_rows(x: torch.Tensor, idx: np.ndarray, fill) -> torch.Tensor:
    """Worker-axis row gather: new row i takes old row ``idx[i]``; rows
    with ``idx[i] < 0`` (joiners) take ``fill`` (a scalar or a (1, ...)
    tensor)."""
    idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                            device=x.device)
    out = x.index_select(0, torch.clamp(idx_t, 0, x.shape[0] - 1))
    mask = (idx_t >= 0).reshape((len(idx),) + (1,) * (x.dim() - 1))
    fill = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    return torch.where(mask, out, fill)


def _tmap(fn, tree):
    """``tree_map`` that keeps the empty moments of an exact solver."""
    return tree if isinstance(tree, tuple) and not tree else T.tree_map(
        fn, tree)


def remap_fleet_state(fs: FleetState, idx: np.ndarray, graph: WorkerGraph,
                      cfg: E.EngineConfig, join_init: str = "mean",
                      dual_reinit: str = "zero", *,
                      old: Optional[topo_lib.Topology] = None,
                      new: Optional[topo_lib.Topology] = None) -> FleetState:
    """Carry fleet and engine state across a membership change.

    ``idx[i]`` is the old worker-axis row of new member i (-1 for a
    joiner). Survivors keep their primal, censor reference, quantizer
    chain, optimizer moments and any packet in flight; joiners get
    ``theta`` = the survivors' mean (``join_init="mean"``) or zeros, an
    all-zero ``theta_hat``/``q_hat`` and a fresh b0-bit uninitialized
    quantizer. The duals are re-initialized in ``col(M_-)`` of the new
    graph (:func:`repro_torch.core.dynamic.reinit_duals`).

    ``old`` and ``new`` are the topologies before and after the change. On
    a sharded one of more than one rank ``fs`` holds the rank's rows of
    ``old``: each array is gathered from every rank, remapped whole (the
    same on every rank) and cut to the rank's rows of ``new``, one array at
    a time, so the whole fleet is held at once only for the duals. Without
    them (or at one rank) ``fs`` is the whole fleet."""
    if join_init not in ("mean", "zeros"):
        raise ValueError(f"unknown join_init {join_init!r}")
    st = fs.engine
    idx = np.asarray(idx)
    surv = idx[idx >= 0]
    sharded = old is not None and old.world > 1

    def whole(x):
        return old.gather(x) if sharded else x

    def cut(x):
        # a copy: a view would keep the whole fleet's rows alive
        return x[new.worker_rows(new.n)].clone() if sharded else x

    def move(x, fill):
        return cut(_gather_rows(whole(x), idx, fill))

    def move_theta(x):
        x = whole(x)
        if join_init == "mean":
            rows = torch.as_tensor(surv, dtype=torch.int64, device=x.device)
            fill = torch.mean(x.index_select(0, rows).to(torch.float32),
                              dim=0, keepdim=True).to(x.dtype)
        else:
            fill = 0
        return cut(_gather_rows(x, idx, fill))

    def move0(x):
        return move(x, 0)

    qcfg = cfg.quantize or QuantConfig()
    quant = E.GroupQuantState(
        q_hat=T.tree_map(move0, st.quant.q_hat),
        range_prev=move(st.quant.range_prev, 0.0),
        bits_prev=move(st.quant.bits_prev, float(qcfg.b0)),
        delta_prev=move(st.quant.delta_prev, 0.0),
        initialized=move(st.quant.initialized, 0.0),
    )
    alpha = dyn_lib.reinit_duals(
        T.tree_map(lambda x: _gather_rows(whole(x), idx, 0), st.alpha),
        graph, mode=dual_reinit)
    engine = E.EngineState(
        theta=T.tree_map(move_theta, st.theta),
        theta_hat=T.tree_map(move0, st.theta_hat),
        alpha=T.tree_map(cut, alpha),
        quant=quant,
        opt_mu=_tmap(move0, st.opt_mu),
        opt_nu=_tmap(move0, st.opt_nu),
        k=st.k,
    )
    return FleetState(
        engine=engine,
        held_hat=T.tree_map(move0, fs.held_hat),
        held_payload=move(fs.held_payload, 0.0),
        timer=move(fs.timer, 0),
    )


# ------------------------------------------------------------ the harness --
@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """One fleet scenario: fault schedule, graph redraw and churn policy."""

    rounds: int
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    graph_p: float = 0.4          # density of membership_graph redraws
    graph_seed: int = 0
    join_init: str = "mean"       # "mean" | "zeros"
    dual_reinit: str = "zero"     # "zero" | "project" (Thm-3 either way)
    seed: int = 0                 # per-round draw seed

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")


def _to_host(metrics: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in metrics.items()}


class FleetSim:
    """Host-side driver, one round at a time.

    **Golden-path dispatch.** Whether a round carries a fault is known on
    the host before stepping (the fault schedule is host-side and the
    staleness timers are shadowed from the last faulted round's metrics).
    A round with no drop, no delay and no packet in flight runs the plain
    synchronous engine step, so a fault-free fleet is bit-identical to
    :func:`run_synchronous` by construction.

    Args follow the JAX package's ``FleetSim``: ``n_workers``,
    ``engine_cfg``, ``fleet_cfg``, ``theta0`` (leading axis ``n_workers``,
    on the device the run uses), exactly one of ``solver`` and
    ``solver_factory(member_gids, graph)`` (rebuilt at every churn event;
    data-dependent exact solvers need it), ``extra_metrics`` or
    ``extra_metrics_factory(member_gids, graph, topology)``, ``batch_fn
    (round, member_gids)``, ``graph0`` (the initial graph; defaults to a
    ``membership_graph`` epoch-0 draw) and ``on_churn(round, graph,
    fleet_state)``. ``uniforms(round, phase)`` replaces the seeded draws.

    On the sharded backend of more than one rank ``theta0``, an exact
    solver's problem (that of ``solver`` or of each ``solver_factory``
    build), the draws, the fault masks and ``batch_fn``'s output are whole
    (every member's rows) and cut here to the rank's rows (``take_workers``
    and ``engine.cut_workers``, as ``engine.run`` cuts them); the metrics
    fns see the rank's rows and the topology. The returned state holds the
    rank's rows (``engine.gather_workers`` collects them); the metrics are
    the whole fleet's on every rank, and ``on_churn`` sees the rank's
    state.
    """

    def __init__(self, n_workers: int, engine_cfg: E.EngineConfig,
                 fleet_cfg: FleetConfig, theta0: Tree, *,
                 solver=None, solver_factory: Optional[Callable] = None,
                 extra_metrics: Optional[E.MetricsFn] = None,
                 extra_metrics_factory: Optional[Callable] = None,
                 batch_fn: Optional[Callable] = None,
                 graph0: Optional[WorkerGraph] = None,
                 on_churn: Optional[Callable] = None,
                 uniforms: Optional[E.Uniforms] = None):
        if (solver is None) == (solver_factory is None):
            raise ValueError("pass exactly one of solver / solver_factory")
        self.engine_cfg = engine_cfg
        self.fleet_cfg = fleet_cfg
        self.theta0 = theta0
        self.device = T.leaves(theta0)[0].device
        self._solver = solver
        self._solver_factory = solver_factory
        self._extra_metrics = extra_metrics
        self._extra_metrics_factory = extra_metrics_factory
        self.batch_fn = batch_fn
        self.on_churn = on_churn
        self.uniforms = uniforms
        self.schedule = FaultSchedule(fleet_cfg.faults)
        self.members: List[int] = list(range(n_workers))
        self.next_gid = n_workers
        self.epoch = 0
        self.graph = graph0 if graph0 is not None else membership_graph(
            n_workers, fleet_cfg.graph_p, fleet_cfg.graph_seed, epoch=0)
        if self.graph.n != n_workers:
            raise ValueError(f"graph0 has {self.graph.n} workers, the fleet "
                             f"{n_workers}")
        self.topo = topo_lib.build(self.graph, engine_cfg.mix_backend,
                                   device=self.device)
        self.churn_log: List[Dict[str, Any]] = []
        # host shadow of the staleness timers (fleet_timer of the last
        # faulted round): is any packet in flight before this round?
        self._host_timer = np.zeros(n_workers, np.int32)
        self.ledger: Optional[CommLedger] = None   # set by a traced run
        self._rebuild_step()

    # ------------------------------------------------------- internals --
    def _cut(self, tree: Tree) -> Tree:
        """The rank's rows of a tree of whole worker-axis arrays (None, a
        batch-free round's batch, stays None)."""
        if tree is None or self.topo.world == 1:
            return tree
        return E.cut_workers(tree, self.topo)

    def _rebuild_step(self) -> None:
        self.solver = E.cut_solver(
            self._solver_factory(tuple(self.members), self.graph)
            if self._solver_factory is not None else self._solver, self.topo)
        metrics_fn = (self._extra_metrics_factory(
            tuple(self.members), self.graph, self.topo)
            if self._extra_metrics_factory is not None
            else self._extra_metrics)
        # the fault program and the plain synchronous step: fault-free
        # rounds take the latter
        self._step = make_fleet_step(self.graph, self.engine_cfg,
                                     self.solver, metrics_fn,
                                     topology=self.topo)
        self._sync_step = E.make_step(self.graph, self.engine_cfg,
                                      self.solver, metrics_fn,
                                      topology=self.topo)

    def _apply_churn(self, r: int, fs: FleetState, event) -> FleetState:
        leavers = set(self.schedule.pick_leavers(r, self.members,
                                                 event.leave))
        survivors = [g for g in self.members if g not in leavers]
        joiners = list(range(self.next_gid, self.next_gid + event.join))
        self.next_gid += event.join
        new_members = survivors + joiners
        idx = np.asarray([self.members.index(g) if g in self.members
                          else -1 for g in new_members], np.int32)
        self.epoch += 1
        self.graph = membership_graph(len(new_members),
                                      self.fleet_cfg.graph_p,
                                      self.fleet_cfg.graph_seed,
                                      epoch=self.epoch)
        # on the sharded backend a new N the world does not divide raises
        # here, at this round on every rank, before any collective
        topo = self.topo.rebuild(self.graph)
        fs = remap_fleet_state(fs, idx, self.graph, self.engine_cfg,
                               join_init=self.fleet_cfg.join_init,
                               dual_reinit=self.fleet_cfg.dual_reinit,
                               old=self.topo, new=topo)
        self.topo = topo
        self.members = new_members
        self._host_timer = np.where(
            idx >= 0, self._host_timer[np.clip(idx, 0, None)], 0
        ).astype(np.int32)
        self._rebuild_step()
        self.churn_log.append({"round": r, "left": sorted(leavers),
                               "joined": joiners,
                               "n_members": len(new_members)})
        if self.on_churn is not None:
            self.on_churn(r, self.graph, fs)
        return fs

    def _trace_worker_events(self, tr, r: int, rf, host) -> None:
        """Per-worker fault instants on ``fleet/worker <gid>`` tracks: drop
        (straggler timeout), lag_start (packet parked), deliver (stale
        packet landed), from the round's fault draw and host metrics."""
        start = np.asarray(host["fleet_start"])
        deliver = np.asarray(host["fleet_deliver"])
        for i, gid in enumerate(self.members):
            if rf.drop[i]:
                tr.instant("drop", "fleet",
                           tr.track("fleet", f"worker {gid}"),
                           args={"round": r})
            if start[i] > 0:
                tr.instant("lag_start", "fleet",
                           tr.track("fleet", f"worker {gid}"),
                           args={"round": r, "lag": int(rf.lag[i])})
            if deliver[i] > 0:
                tr.instant("deliver", "fleet",
                           tr.track("fleet", f"worker {gid}"),
                           args={"round": r})

    # ------------------------------------------------------------- run --
    def run(self) -> Tuple[FleetState, Dict[str, Any]]:
        """Drive ``fleet_cfg.rounds`` rounds; returns the final state and
        the stacked per-round metrics as numpy (keys whose worker axis
        changes across churn stay lists; ``payload_bits_total``,
        ``tx_count``, ``n_members`` and ``round_seconds`` are (rounds,)
        arrays, ``churn_log`` a list)."""
        fcfg = self.fleet_cfg
        dim = E.tree_dim(self.theta0)
        state = E.init_state(self._cut(self.theta0), self.engine_cfg,
                             self.solver)
        fs = init_fleet_state(state)
        del state
        records: List[Dict[str, Any]] = []
        # observers only: the events and the ledger read the fault schedule
        # and the host copy of the metrics each round makes anyway
        tr = obs_trace.tracer()
        self.ledger = CommLedger(self.graph, subsystem="fleet") \
            if tr is not None else None
        for r in range(fcfg.rounds):
            t0 = time.perf_counter()
            event = self.schedule.churn_at(r)
            if event is not None and (event.leave or event.join):
                fs = self._apply_churn(r, fs, event)
                if self.ledger is not None:
                    self.ledger.rebuild(self.graph)
                if tr is not None:
                    log = self.churn_log[-1]
                    tr.instant("churn", "fleet",
                               tr.track("fleet", "rounds"),
                               args={"round": r, "left": len(log["left"]),
                                     "joined": len(log["joined"]),
                                     "n_members": log["n_members"]})
            rf = self.schedule.round_faults(r, self.members)
            batch = self._cut(self.batch_fn(r, tuple(self.members))
                              if self.batch_fn is not None else None)
            n = len(self.members)
            draw = round_draws(fcfg.seed, r, (n, dim), self.device,
                               self.uniforms)
            if self.topo.world > 1:
                # whole draws, cut to the rank's rows
                draw = (lambda phase, whole=draw, rows=self.topo.worker_rows(
                    n): whole(phase)[rows])
            if tr is not None:
                tr.begin("round", "fleet", tr.track("fleet", "rounds"),
                         args={"round": r, "n_members": n})
            if (not rf.drop.any() and not rf.lag.any()
                    and not self._host_timer.any()):
                # fault-free round, nothing in flight: the synchronous step
                state, m = self._sync_step(fs.engine, draw, batch)
                fs = dataclasses.replace(fs, engine=state)
                del state
                host = _to_host(E.gather_workers(m, self.topo))
                host["fleet_participation"] = np.ones(n, np.float32)
                host["fleet_start"] = np.zeros(n, np.float32)
                host["fleet_deliver"] = np.zeros(n, np.float32)
                host["fleet_timer"] = np.zeros(n, np.int32)
            else:
                fs, m = self._step(
                    fs, draw, batch,
                    self._cut(torch.as_tensor(rf.drop, device=self.device)),
                    self._cut(torch.as_tensor(rf.lag, device=self.device)))
                # every rank reads the whole fleet's timers: the next
                # round's choice of step is the same on each
                host = _to_host(E.gather_workers(m, self.topo))
                self._host_timer = host["fleet_timer"].astype(np.int32)
            del m
            if tr is not None:
                tr.end("fleet", tr.track("fleet", "rounds"))
                self._trace_worker_events(tr, r, rf, host)
                self.ledger.update(host)
            host["n_members"] = np.asarray(n, np.int32)
            host["round_seconds"] = np.asarray(time.perf_counter() - t0)
            records.append(host)
        metrics = stack_records(records)
        metrics["payload_bits_total"] = np.asarray(
            [float(np.sum(rec["payload_bits"])) for rec in records])
        metrics["tx_count"] = np.asarray(
            [float(np.sum(rec["tx_mask"])) for rec in records])
        metrics["churn_log"] = list(self.churn_log)
        return fs, metrics


def stack_records(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-round metric dicts into (rounds, ...) arrays; keys whose
    shape varies across rounds (worker-axis arrays across churn) stay
    lists of per-round arrays."""
    out: Dict[str, Any] = {}
    for k in records[0]:
        vals = [rec[k] for rec in records]
        if len({np.shape(v) for v in vals}) == 1:
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def run_synchronous(graph: WorkerGraph, cfg: E.EngineConfig, solver,
                    theta0: Tree, rounds: int, seed: int = 0,
                    extra_metrics: Optional[E.MetricsFn] = None,
                    batch_fn: Optional[Callable] = None,
                    uniforms: Optional[E.Uniforms] = None,
                    ) -> Tuple[E.EngineState, Dict[str, Any]]:
    """The golden arm: the plain synchronous engine on ``theta0``'s device,
    with the same per-round draws as :class:`FleetSim`
    (:func:`round_draws`), so a fault-free fleet run compares bit for
    bit. On the sharded backend of more than one rank ``theta0``, an exact
    solver's problem, the draws and the batches are whole and cut to the
    rank's rows, as :class:`FleetSim` cuts them; the metrics are gathered
    from every rank and the state holds the rank's rows."""
    dev = T.leaves(theta0)[0].device
    topo = topo_lib.build(graph, cfg.mix_backend, device=dev)
    rows = topo.worker_rows(graph.n)
    if topo.world > 1:
        theta0 = E.cut_workers(theta0, topo)
        solver = E.cut_solver(solver, topo)
    step = E.make_step(graph, cfg, solver, extra_metrics, topology=topo)
    state = E.init_state(theta0, cfg, solver)
    shape = (graph.n, E.tree_dim(theta0))
    records = []
    for r in range(rounds):
        batch = batch_fn(r) if batch_fn is not None else None
        draw = round_draws(seed, r, shape, dev, uniforms)
        if topo.world > 1:
            batch = E.cut_workers(batch, topo) if batch is not None else None
            draw = (lambda phase, whole=draw: whole(phase)[rows])
        state, m = step(state, draw, batch)
        records.append(_to_host(E.gather_workers(m, topo)))
    metrics = stack_records(records)
    metrics["payload_bits_total"] = np.asarray(
        [float(np.sum(rec["payload_bits"])) for rec in records])
    return state, metrics
