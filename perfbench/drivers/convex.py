"""The convex driver: CQ-GGADMM on per-worker least squares through the
program's engine, iteration after iteration.

A mix without ``refresh_every`` keeps one graph and builds the loop as
``core/cq_ggadmm.py`` does (``init_state``, ``make_step``: the engine step
with the flat diagnostics). A mix with ``refresh_every`` R redraws the graph
every R iterations as ``core/dynamic.run_dynamic`` does: the program's
``DynamicTopology`` draws it, the topology backend is rebuilt, a new step is
made and the duals are set to 0.

Set-up draws the data and builds the program's problem (its Gram matrices),
then runs ``setup_iters`` iterations through the window's own loop and feed;
their states are kept for the judge. The window runs whole iterations until
``seconds`` have passed and ends at a device synchronisation. A few window
iterations, drawn from the seed, are kept for the judge too. After the
window the program's state is freed and the reference judges every kept
iteration (``reference/convex.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from perfbench import inputs
from perfbench import trace as trace_lib
from perfbench.drivers.planted import planted
from perfbench.reference import convex as ref
from perfbench.reference import graph as ref_graph

GRAPH_STREAM, SAMPLE_STREAM = 2, 3
FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def graph_seed(seed: int) -> int:
    return inputs.stream_seed(seed, GRAPH_STREAM) >> 32


class Loop:
    """The program's iteration as its entry point builds it, with the
    graph schedule of the mix."""

    def __init__(self, cfg: dict, mix: dict, problem, seed: int, device,
                 fault: Optional[str] = None):
        from repro_torch.core import admm_baselines as ab
        from repro_torch.core import cq_ggadmm
        from repro_torch.core import dynamic
        from repro_torch.core.graph import WorkerGraph

        self.n, self.d = cfg["workers"], cfg["n_features"]
        self.problem, self.device, self.fault = problem, device, fault
        self.ecfg = dataclasses.replace(
            ab.cq_ggadmm(rho=cfg["rho"], tau0=cfg["tau0"], xi=cfg["xi"],
                         b0=cfg["b0"], omega=cfg["omega"]),
            mix_backend=mix["mix_backend"])
        self.refresh = int(mix.get("refresh_every", 0))
        self.p = cfg["graph_p"]
        self.gseed = graph_seed(seed)
        self.it = 0
        if self.refresh:
            self.dyn = dynamic.DynamicTopology(self.n, self.p, self.refresh,
                                               seed=self.gseed)
            self.graph = self.dyn.graph_at(0)
            self._build(self.graph, topo=None)
            self.state = cq_ggadmm.init_state(self.n, self.d, self.ecfg,
                                              device)
        else:
            g = self.reference_graph(0)
            self.graph = WorkerGraph(n=g.n, edges=g.edges,
                                     head_mask=g.head_mask,
                                     adjacency=g.adjacency, degrees=g.degrees)
            self.step = cq_ggadmm.make_step(self.graph, problem, self.ecfg,
                                            device=device)
            self.state = cq_ggadmm.init_state(self.n, self.d, self.ecfg,
                                              device)

    def _build(self, graph, topo):
        from repro_torch.core import engine as E
        from repro_torch.core import topology as topo_lib

        self.topo = (topo_lib.build(graph, self.ecfg.mix_backend,
                                    device=self.device)
                     if topo is None else topo.rebuild(graph))
        self.step = E.make_step(graph, self.ecfg, E.ExactSolver(self.problem),
                                extra_metrics=E.flat_metrics(graph, self.topo),
                                topology=self.topo)

    def reference_graph(self, iteration: int) -> ref_graph.Graph:
        return reference_graph(self.n, self.p, self.gseed, self.refresh,
                               iteration)

    def advance(self, draw: Callable[[int], torch.Tensor]) -> bool:
        """One iteration; True where the graph was redrawn before it (and
        the duals set to 0)."""
        from repro_torch.core import dynamic

        redrawn = bool(self.refresh and self.it
                       and self.it % self.refresh == 0)
        if redrawn:
            self.graph = self.dyn.graph_at(self.it // self.refresh)
            self._build(self.graph, self.topo)
            self.state = dataclasses.replace(
                self.state, alpha=dynamic.reinit_duals(self.state.alpha,
                                                       self.graph, "zero"))
        if self.fault == "unchanged":
            draw(0), draw(1)
        else:
            self.state, _ = self.step(self.state, draw)
        self.it += 1
        return redrawn

    def snapshot(self) -> dict:
        s = self.state
        return ref.snapshot(s.theta, s.theta_hat, s.alpha, s.quant.q_hat,
                            s.quant.range_prev, s.quant.bits_prev,
                            s.quant.delta_prev, s.quant.initialized, s.k)

    def mix_work(self):
        """The (table, valid) of the graph in use, for B6's bound."""
        return self.graph.neighbor_table


def reference_graph(n: int, p: float, gseed: int, refresh: int,
                    iteration: int) -> ref_graph.Graph:
    """The graph of an iteration, as the reference works it out."""
    phase = iteration // refresh if refresh else 0
    return ref_graph.random_bipartite_graph(n, p, gseed + phase)


def _problem(x, y, fault):
    from repro_torch.core.solvers import LinearRegressionProblem

    if fault != "half_batch":
        return LinearRegressionProblem(x, y)
    # half of each worker's rows, the loss scaled back to the whole count
    half = LinearRegressionProblem(x[:, :x.shape[1] // 2],
                                   y[:, :y.shape[1] // 2])
    return LinearRegressionProblem(half.x, half.y, gram=2.0 * half.gram,
                                   xty=2.0 * half.xty)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, fault: Optional[str] = None) -> dict:
    """One run of a cell. Returns the window's count and time, the set-up's
    end, the peak device memory, the judge's readings and, traced, the
    trace summary and the work the readers need."""
    from repro_torch.kernels import ops

    n, d = cfg["workers"], cfg["n_features"]
    scheme = ref.Scheme.of(cfg)
    cuda = torch.device(device).type == "cuda"
    with planted(fault):
        x, y = inputs.linreg_data(cfg, seed, device)
        loop = Loop(cfg, mix, _problem(x, y, fault), seed, device, fault)
        gen = inputs.draw_generator(seed, device)
        held: List[torch.Tensor] = []

        def draw(phase: int) -> torch.Tensor:
            u = torch.rand((n, d), generator=gen, device=device)
            if keep:
                held.append(u.clone())
            return u

        records = []

        def kept_iteration():
            held.clear()
            before = loop.snapshot()
            it = loop.it
            redrawn = loop.advance(draw)
            records.append((it, before, loop.snapshot(), held[0], held[1],
                            redrawn))

        keep = True
        start = loop.snapshot()
        for _ in range(mix["setup_iters"]):
            kept_iteration()
        if cuda:
            torch.cuda.synchronize()
        setup_end = time.perf_counter()

        rng = np.random.default_rng(inputs.stream_seed(seed, SAMPLE_STREAM))
        sampled = set(int(i) for i in rng.choice(
            mix["check_span"], size=mix["window_checks"], replace=False))
        summary = None
        keep = False
        window_iters = 0
        t0 = time.perf_counter()
        while True:
            if trace and window_iters == mix["trace_after"]:
                summary = trace_lib.traced(lambda: loop.advance(draw),
                                           mix["trace_iters"],
                                           lambda: ops.launches)
                window_iters += mix["trace_iters"]
            elif window_iters in sampled:
                keep = True
                kept_iteration()
                keep = False
                window_iters += 1
            else:
                loop.advance(draw)
                window_iters += 1
            if (time.perf_counter() - t0 >= seconds
                    and window_iters >= mix["check_span"]
                    and (not trace or summary is not None)):
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        table, valid = loop.mix_work()
        graph_of = functools.partial(reference_graph, n, loop.p, loop.gseed,
                                     loop.refresh)
        del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings, each = ref.judge_steps(records, x, y, graph_of, scheme,
                                     start=start)
    return {"iterations": window_iters, "done": window_iters,
            "window_s": window_s,
            "setup_end": setup_end, "peak_bytes": peak, "readings": readings,
            "per_iteration": each, "attempted": window_iters,
            "summary": summary,
            "work": {"n": n, "d": d, "table": table, "valid": valid}}
