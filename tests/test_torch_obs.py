"""The port's observability layer behind ``--trace`` against the JAX
package's: the tracer copy, the communication ledger, the kernel-dispatch
counter, and the trace sites of the engine loop, the fleet and the
scheduler, on the CPU at smoke size.

Tolerances: none. The tracer and ledger are copies (timestamps masked);
the ledger equals ``build_comm_log`` exactly (energy to rel 1e-12, the sum
order of the two); a traced run equals the untraced one bit for bit, with
the same kernel dispatches.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.graph import random_bipartite_graph as jax_graph
from repro.obs import ledger as jledger
from repro.obs import trace as jtrace
from repro_torch import interop
from repro_torch.core import comm
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R
from repro_torch.fleet import faults, sim
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import registry
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import CommLedger
from repro_torch.obs.trace import Tracer, validate_events
from repro_torch.serving.scheduler import Scheduler, ServeConfig

N, DIM, ROUNDS = 6, 12, 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops in loops: one intra-op thread (see test_torch_serving)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_global_tracer():
    """Every test starts and ends without a global tracer."""
    obs_trace.disable(save=False)
    yield
    obs_trace.disable(save=False)


@pytest.fixture(scope="module")
def linreg():
    x, y = R.partition_uniform(R.synth_linear(n=N * 30, d=DIM, seed=0), N)
    return (random_bipartite_graph(N, 0.4, seed=0),
            interop.problem_from_numpy(x, y, "linear", device="cpu"))


def cfg(**kw):
    return E.EngineConfig(rho=1.0, censor=CensorConfig(tau0=0.5, xi=0.97),
                          quantize=QuantConfig(b0=2, omega=0.99),
                          groups="leaf", censor_mode="group", **kw)


def theta0(n=N):
    return {"w": torch.zeros((n, DIM - 4)), "b": torch.zeros((n, 4))}


def dispatches():
    return dict(obs_metrics.kernel_dispatch_counter().series())


# ------------------------------------------------------------ the tracer --
def seq_spans(tr):
    tid = tr.track("serving", "req 0")
    tr.begin("request", "serving", tid, args={"rid": 0})
    tr.begin("queue", "serving", tid)
    tr.end("serving", tid)
    tr.instant("admit", "serving", tid, args={"slot": 1})
    tr.counter("page_pool", "serving", {"free": 3, "in_use": 5})
    tr.end("serving", tid, args={"tokens": 4})
    with tr.span("round", "fleet", tr.track("fleet", "rounds"),
                 args={"round": 0}):
        tr.instant("drop", "fleet", tr.track("fleet", "worker 3"))


def seq_open(tr):
    tid = tr.track("engine", "rounds")
    tr.begin("round", "engine", tid, args={"round": 0})
    tr.begin("inner", "engine", tid)
    tr.counter("ledger", "engine", {"cum_bits": 1.5}, tid=tid)


def seq_unmatched(tr):
    tr.end("serving", 1)
    tr.instant("defrag", "serving", tr.track("serving", "scheduler"))
    tr.end("serving", tr.track("serving", "scheduler"))


def masked(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("seq", [seq_spans, seq_open, seq_unmatched])
def test_tracer_copy_gives_the_jax_event_list(seq, tmp_path):
    got, want = Tracer(str(tmp_path / "p.json")), jtrace.Tracer(
        str(tmp_path / "j.json"))
    seq(got)
    seq(want)
    assert masked(got._events) == masked(want._events)
    docs = []
    for tr in (got, want):
        with open(tr.save()) as f:
            docs.append(json.load(f))
    assert masked(docs[0]["traceEvents"]) == masked(docs[1]["traceEvents"])
    assert docs[0]["displayTimeUnit"] == docs[1]["displayTimeUnit"]
    assert validate_events(docs[0]) == [] == jtrace.validate_events(docs[1])
    assert got._open == want._open           # the live stacks untouched


BAD_DOCS = [
    {"nope": 1},
    {"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
                     {"name": "b", "ph": "E", "ts": 1, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "x", "ph": "B"}]},
    {"traceEvents": [{"name": "x", "ph": "Z", "ts": 0, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "c", "ph": "C", "ts": 0, "pid": 1, "tid": 1,
                      "args": {"v": "high"}}]},
    {"traceEvents": [7, {"name": "e", "ph": "E", "ts": 0, "pid": 1,
                         "tid": 2}]},
]


@pytest.mark.parametrize("doc", BAD_DOCS, ids=range(len(BAD_DOCS)))
def test_validate_events_reports_as_the_jax_module(doc):
    got = validate_events(doc)
    assert got and got == jtrace.validate_events(doc)


def test_module_global_tracer_enable_save_disable(tmp_path):
    assert obs_trace.ENV_VAR == jtrace.ENV_VAR == "REPRO_TRACE"
    assert obs_trace.tracer() is None and not obs_trace.enabled()
    assert obs_trace.save() is None
    tr = obs_trace.enable(str(tmp_path / "g.json"))
    assert obs_trace.tracer() is tr and obs_trace.enabled()
    tr.begin("round", "engine", tr.track("engine", "rounds"))
    path = obs_trace.save()                 # the open span closes on save
    with open(path) as f:
        assert validate_events(json.load(f)) == []
    obs_trace.disable()
    assert obs_trace.tracer() is None


# ------------------------------------------------------------ the ledger --
def test_ledger_matches_build_comm_log_and_the_jax_ledger(linreg):
    g, prob = linreg
    _, m = sim.run_synchronous(g, cfg(), E.ExactSolver(prob), theta0(),
                               ROUNDS)
    log = comm.build_comm_log(m["tx_mask"], m["payload_bits"], g)
    ledger = CommLedger(g)
    jl = jledger.CommLedger(jax_graph(N, 0.4, seed=0))
    for r in range(ROUNDS):
        host = {k: np.asarray(m[k])[r] for k in
                ("tx_mask", "payload_bits", "censor_mask", "group_tx",
                 "offered_payload_bits")}
        totals = ledger.update(host)
        jtotals = jl.update(host)
    assert totals == jtotals
    assert totals["rounds"] == ROUNDS
    assert totals["cum_transmissions"] == log.cumulative_rounds[-1]
    assert totals["cum_bits"] == log.cumulative_bits[-1]
    np.testing.assert_allclose(totals["cum_energy_j"],
                               log.cumulative_energy[-1], rtol=1e-12)
    cm = m["censor_mask"][-1]
    assert totals["censor_rate"] == pytest.approx(1.0 - cm.sum() / g.n)
    np.testing.assert_allclose(totals["group_censor_rate"],
                               1.0 - m["group_tx"][-1].sum(axis=0) / g.n)


def test_ledger_rebuild_on_churn_as_the_jax_ledger(linreg):
    g, _ = linreg
    ledger = CommLedger(g)
    jl = jledger.CommLedger(jax_graph(N, 0.4, seed=0))
    np.testing.assert_array_equal(ledger._dist, jl._dist)
    g2 = random_bipartite_graph(4, 0.6, seed=7)
    ledger.rebuild(g2)
    jl.rebuild(jax_graph(4, 0.6, seed=7))
    assert ledger._dist.shape == (4,)
    np.testing.assert_array_equal(ledger._dist, jl._dist)
    assert ledger._bw == jl._bw == ledger.model.worker_bandwidth(4, 0.5)
    host = {"tx_mask": np.ones(4), "payload_bits": np.full(4, 100.0)}
    assert ledger.update(host) == jl.update(host)


# ----------------------------------------- traced runs equal untraced ones --
def test_engine_loop_bit_identical_with_tracing(linreg, tmp_path):
    """The trainer's round loop (span, ledger on a host copy) over the
    engine step: state, metrics and kernel dispatches as untraced."""
    g, prob = linreg
    solver = E.ExactSolver(prob)

    def run(traced):
        tr = obs_trace.enable(str(tmp_path / "e.json")) if traced else None
        ledger = CommLedger(g) if tr is not None else None
        step = E.make_step(g, cfg(), solver, device="cpu")
        state = E.init_state(theta0(), cfg(), solver)
        gen = torch.Generator().manual_seed(0)
        before = dispatches()
        ms = []
        for r in range(ROUNDS):
            if tr is not None:
                tr.begin("round", "engine", tr.track("engine", "rounds"))
            state, m = step(state, lambda ph: torch.rand((N, DIM),
                                                         generator=gen))
            if ledger is not None:
                ledger.update({k: v.cpu().numpy() for k, v in m.items()})
                tr.end("engine", tr.track("engine", "rounds"))
            ms.append(m)
        after = dispatches()
        delta = {k: after[k] - before.get(k, 0) for k in after}
        path = tr.save() if tr is not None else None
        obs_trace.disable(save=False)
        return state, ms, delta, path

    state, ms, delta, _ = run(False)
    tstate, tms, tdelta, path = run(True)
    assert delta == tdelta and sum(delta.values()) > 0
    for name in ("theta", "theta_hat", "alpha"):
        for a, b in zip(T.leaves(getattr(state, name)),
                        T.leaves(getattr(tstate, name))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for m, tm in zip(ms, tms):
        for k in m:
            torch.testing.assert_close(m[k], tm[k], rtol=0, atol=0)
    with open(path) as f:
        doc = json.load(f)
    assert validate_events(doc) == []
    assert sum(e["ph"] == "B" and e["name"] == "round"
               for e in doc["traceEvents"]) == ROUNDS


def fleet_run(linreg, tmp_path, traced):
    g, prob = linreg
    fc = faults.FaultConfig(participation=0.6, staleness=2, stale_frac=0.5,
                            seed=1, churn=(faults.ChurnEvent(round=3, leave=1,
                                                     join=1),))
    solver_factory = (lambda members, graph: E.ExactSolver(prob))
    if traced:
        obs_trace.enable(str(tmp_path / "f.json"))
    fsim = sim.FleetSim(N, cfg(mix_backend="sparse"),
                        sim.FleetConfig(rounds=8, seed=2, faults=fc),
                        theta0(), solver_factory=solver_factory, graph0=g)
    before = dispatches()
    fs, m = fsim.run()
    after = dispatches()
    path = obs_trace.save() if traced else None
    obs_trace.disable(save=False)
    return fs, m, fsim, {k: after[k] - before.get(k, 0) for k in after}, path


def test_fleet_bit_identical_with_tracing(linreg, tmp_path):
    fs, m, _, delta, _ = fleet_run(linreg, tmp_path, False)
    tfs, tm, tsim, tdelta, path = fleet_run(linreg, tmp_path, True)
    assert delta == tdelta
    for k in m:
        if k in ("round_seconds", "churn_log"):
            continue
        a, b = m[k], tm[k]
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    for name in ("theta", "theta_hat", "alpha"):
        for a, b in zip(T.leaves(getattr(fs.engine, name)),
                        T.leaves(getattr(tfs.engine, name))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with open(path) as f:
        doc = json.load(f)
    assert validate_events(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("round") == 2 * 8 and names.count("churn") == 1
    assert {"drop", "lag_start", "ledger", "censor_rate"} <= set(names)
    # the fleet's ledger: the rounds' arrival accounting
    assert tsim.ledger.rounds == 8
    assert tsim.ledger.cum_bits == float(np.sum(m["payload_bits_total"]))
    assert tsim.ledger.cum_transmissions == float(np.sum(m["tx_count"]))


def sched_run(tmp_path, traced, mode):
    """Two tinyllama-smoke requests (float32) under watermark preemption on
    an 8-page pool with a defrag every 3 ticks, traced or not: tokens,
    counters, kernel dispatches and the trace's path."""
    cfg = base.get_smoke_config("tinyllama-1.1b").with_overrides(
        dtype="float32")
    params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (9, 13)]
    scfg = ServeConfig(max_seqs=2, page_size=4, num_pages=8,
                       pages_per_seq=16, prefill_chunk=8, kv_bits=32,
                       cache_dtype="float32", preempt=True,
                       preempt_mode=mode, decode_watermark=1,
                       defrag_every=3)
    if traced:
        obs_trace.enable(str(tmp_path / f"q{mode}.json"))
    sched = Scheduler(cfg, params, scfg, device="cpu")
    before = dispatches()
    rids = [sched.submit(p, m) for p, m in zip(prompts, (14, 10))]
    out = sched.run()
    after = dispatches()
    path = obs_trace.save() if traced else None
    obs_trace.disable(save=False)
    counters = {k: getattr(sched, k) for k in (
        "preemptions", "forced_preemptions", "decode_steps",
        "prefill_chunks", "peak_pages_in_use")}
    return ([out[r].tolist() for r in rids], counters,
            {k: after[k] - before.get(k, 0) for k in after}, path)


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_scheduler_bit_identical_with_tracing(mode, tmp_path):
    """Tokens, counters and kernel dispatches as untraced; every request
    span closed, the queue span reopened at each preemption, a page_pool
    counter each tick."""
    toks, counters, delta, _ = sched_run(tmp_path, False, mode)
    ttoks, tcounters, tdelta, path = sched_run(tmp_path, True, mode)
    assert toks == ttoks and counters == tcounters and delta == tdelta
    preempts = counters["preemptions"]      # the forced ones included
    assert preempts >= 1
    with open(path) as f:
        doc = json.load(f)
    assert validate_events(doc) == []
    ev = doc["traceEvents"]
    assert not any(e.get("args", {}).get("truncated") for e in ev)
    names = [e["name"] for e in ev]
    assert names.count("preempt") == preempts
    assert names.count("admit") == 2 + preempts
    assert names.count("queue") == 2 * (2 + preempts)
    assert names.count("request") == 2 * 2
    assert names.count("first_token") == 2
    assert names.count("decode_step") == 2 * counters["decode_steps"]
    assert names.count("prefill_chunk") == 2 * counters["prefill_chunks"]
    assert names.count("forced_preempt") == counters["forced_preemptions"]
    assert names.count("swap_out") == (preempts if mode == "swap" else 0)
    assert "defrag" in names and "page_pool" in names


def test_serve_trace_cli_writes_a_valid_trace_of_unchanged_streams(
        tmp_path):
    argv = ["--device", "cpu", "--prompt-lens", "9,17,5", "--prefix-len",
            "16", "--repeat", "2", "--share-prefix", "--decode-tokens", "6",
            "--batch", "3", "--kv-bits", "32"]
    path = str(tmp_path / "s.json")
    out = serve.main(argv)
    tout = serve.main(argv + ["--trace", path])
    assert sorted(out["outputs"]) == sorted(tout["outputs"])
    for r in out["outputs"]:
        np.testing.assert_array_equal(out["outputs"][r], tout["outputs"][r])
    for k in ("decode_steps", "shared_page_hits", "peak_pages_in_use"):
        assert out[k] == tout[k], k
    assert out["shared_page_hits"] > 0
    with open(path) as f:
        doc = json.load(f)
    assert validate_events(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("request") == 2 * len(out["outputs"])
    assert names.count("page_pool") >= out["decode_steps"]


@pytest.mark.parametrize("fleet", [False, True], ids=["admm", "fleet"])
def test_train_trace_cli_writes_a_valid_trace_of_an_unchanged_run(
        fleet, tmp_path):
    argv = ["--arch", "xlstm-125m", "--smoke", "--workers", "4", "--batch",
            "4", "--seq", "16", "--steps", "3", "--local-steps", "1",
            "--bits", "6", "--groups", "leaf", "--device", "cpu",
            "--log-every", "1"]
    if fleet:
        argv += ["--mix-backend", "sparse", "--fleet",
                 "--fleet-participation", "0.75", "--fleet-staleness", "2",
                 "--fleet-churn", "1:1:1"]
    path = str(tmp_path / "t.json")
    out = train.main(argv)
    tout = train.main(argv + ["--trace", path])
    assert out["history"] == tout["history"]
    assert out["total_bits"] == tout["total_bits"]
    assert out["ledger"] is None and tout["ledger"]["rounds"] == 3
    assert tout["ledger"]["cum_bits"] == tout["total_bits"]
    with open(path) as f:
        doc = json.load(f)
    assert validate_events(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("round") == 2 * 3 and names.count("ledger") == 3
    if fleet:
        assert names.count("churn") == 1
    else:
        ms = tout["traced_metrics"]
        log = comm.build_comm_log([h["tx_mask"] for h in ms],
                                  [h["payload_bits"] for h in ms],
                                  train.ST.worker_graph(4, "random"))
        assert tout["ledger"]["cum_transmissions"] \
            == log.cumulative_rounds[-1]
        assert tout["ledger"]["cum_bits"] == log.cumulative_bits[-1]


def test_untraced_runs_build_no_ledger(linreg, monkeypatch):
    """Without a tracer the sites are one test each: no ledger is built
    (so no host copy is made for it) in the trainer or the fleet."""
    def refuse(*a, **kw):
        raise AssertionError("a ledger was built without a tracer")

    monkeypatch.setattr(train, "CommLedger", refuse)
    monkeypatch.setattr(sim, "CommLedger", refuse)
    monkeypatch.setattr(obs_ledger, "CommLedger", refuse)
    g, prob = linreg
    sim.FleetSim(N, cfg(), sim.FleetConfig(rounds=2), theta0(),
                 solver=E.ExactSolver(prob), graph0=g).run()
    train.main(["--arch", "xlstm-125m", "--smoke", "--workers", "2",
                "--batch", "2", "--seq", "8", "--steps", "1",
                "--local-steps", "1", "--device", "cpu"])


# ---------------------------------------------------- dispatch counter --
def dispatch_cases():
    """(kernel, variant, call): one call of each ``ops`` wrapper on small
    CPU tensors."""
    g = torch.Generator().manual_seed(0)
    n, d = 2, 4
    theta, qprev = torch.randn((n, d), generator=g), torch.zeros((n, d))
    unif = torch.rand((n, d), generator=g)
    qrange = theta.abs().amax(dim=1)
    delta = 2.0 * qrange / 3.0
    side = torch.ones((n, 1))
    runs = (((0, d),),)
    fused_kw = dict(group_runs=runs, omega=0.99, b0=2, b_max=16)
    table = torch.tensor([[1], [0]], dtype=torch.int32)
    pool = torch.randn((4, 2, 1, 8), generator=g)
    b = 3
    return [
        ("bipartite_mix", "dense",
         lambda: ops.bipartite_mix(torch.ones((2, 2)), torch.arange(
             6.0).reshape(2, 3))),
        ("stoch_quantize", "flat",
         lambda: ops.stoch_quantize(theta, qprev, unif, delta, qrange)),
        ("stoch_quantize", "grouped",
         lambda: ops.stoch_quantize_grouped(theta, qprev, unif, delta[:, None],
                                            qrange[:, None], None,
                                            group_runs=runs)),
        ("stoch_quantize_fused", "slab",
         lambda: ops.stoch_quantize_grouped_fused(
             theta, qprev, unif, side * 2, side, side, None, **fused_kw)),
        ("stoch_quantize_fused", "tiled",
         lambda: ops.stoch_quantize_grouped_fused_tiled(
             theta, qprev, unif, side * 2, side, side, None, block_d=2,
             **fused_kw)),
        ("edge_gather_mix", "sparse",
         lambda: ops.edge_gather_mix(theta, table, torch.ones((2, 1)))),
        ("paged_attention_decode", "oneshot",
         lambda: ops.paged_attention_decode(
             torch.randn((2, 2, 8), generator=g), pool, pool,
             torch.zeros((2, 3), dtype=torch.int32),
             torch.ones((2,), dtype=torch.int32))),
        ("slstm_cell", "fused",
         lambda: ops.slstm_cell(
             torch.randn((1, b, 1, 8), generator=g),
             torch.randn((1, 2, 8), generator=g), torch.zeros((1, 2)),
             *[torch.zeros((1, 1, 2)) for _ in range(4)])),
    ]


@pytest.mark.parametrize("case", range(8))
def test_ops_wrappers_bump_dispatch_counter_with_jax_labels(case):
    """Each wrapper bumps ``kernel_dispatch`` once per call with the JAX
    package's (kernel, variant) label, on the CPU too, where
    ``ops.launches`` does not move (JAX ``tests/test_obs.py``)."""
    kernel, variant, call = dispatch_cases()[case]
    c = obs_metrics.kernel_dispatch_counter()
    before = c.value(kernel=kernel, variant=variant)
    total = sum(dispatches().values())
    launches = dict(ops.launches)
    call()
    assert c.value(kernel=kernel, variant=variant) == before + 1
    assert sum(dispatches().values()) == total + 1
    assert ops.launches == launches


def test_fused_route_through_the_tiled_kernel_counts_tiled(monkeypatch):
    monkeypatch.setenv("REPRO_QUANT_TILE_D", "2")
    c = obs_metrics.kernel_dispatch_counter()
    slab = c.value(kernel="stoch_quantize_fused", variant="slab")
    tiled = c.value(kernel="stoch_quantize_fused", variant="tiled")
    x = torch.ones((1, 4))
    side = torch.ones((1, 1))
    ops.stoch_quantize_grouped_fused(x, x * 0, x * 0.5, side * 2, side, side,
                                     None, group_runs=(((0, 4),),),
                                     omega=0.99, b0=2, b_max=16)
    assert c.value(kernel="stoch_quantize_fused", variant="slab") == slab
    assert c.value(kernel="stoch_quantize_fused", variant="tiled") \
        == tiled + 1


def test_jax_default_graph_is_the_port_graph():
    """The ledger tests hand the two ledgers graphs built by each package
    from one seed: they are the same graph."""
    np.testing.assert_array_equal(
        random_bipartite_graph(N, 0.4, seed=0).adjacency,
        np.asarray(jax_graph(N, 0.4, seed=0).adjacency))


# ------------------------------------- the engine's spans, on one clock --
STEP_SPANS = ("engine.step", "engine.phase", "engine.mix", "engine.solve",
              "engine.quantize", "engine.censor", "engine.dual",
              "engine.diagnostics")
# where each span sits: the spans that may hold it innermost
PARENT = {"engine.phase": ("engine.step",),
          "engine.mix": ("engine.phase",), "engine.solve": ("engine.phase",),
          "engine.quantize": ("engine.phase",),
          "engine.censor": ("engine.phase",), "engine.dual": ("engine.step",),
          "engine.diagnostics": ("engine.step",),
          "solve.factor": ("engine.solve",), "solve.apply": ("engine.solve",),
          "topology.all_gather": ("engine.mix", "engine.dual",
                                  "engine.diagnostics")}


def step_spans(events):
    """The closed spans of the engine's step track, by name."""
    pid_of = {e["args"]["name"]: e["pid"] for e in events
              if e["name"] == "process_name"}
    tid_of = {e["args"]["name"]: e["tid"] for e in events
              if e["name"] == "thread_name"
              and e["pid"] == pid_of.get(obs_trace.STEP_TRACK[0])}
    track = (pid_of[obs_trace.STEP_TRACK[0]],
             tid_of[obs_trace.STEP_TRACK[1]])
    by_name = {}
    for name, pid, tid, b, e, args in obs_trace.closed_spans(events):
        if (pid, tid) == track:
            by_name.setdefault(name, []).append((b, e, args))
    return by_name


def assert_nested(spans):
    """Each span of ``PARENT`` lies inside a span of one of its parents'
    names, and no two spans of one name overlap."""
    for name, parents in PARENT.items():
        for b, e, _ in spans.get(name, ()):
            assert any(pb <= b and e <= pe for p in parents
                       for pb, pe, _ in spans.get(p, ())), (name, b)
    for name, got in spans.items():
        ends = sorted((b, e) for b, e, _ in got)
        assert all(e0 <= b1 for (_, e0), (b1, _) in zip(ends, ends[1:])), \
            name


def test_tracer_stamps_the_profilers_clock_and_names_it(tmp_path):
    """A tracer span around a ``record_function`` region holds the
    profiler's interval of it, within 50 us, on the Unix epoch that
    kineto's ``start_ns`` reads; the file names the base of its ``ts``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer(str(tmp_path / "c.json"))
    tid = tr.track("probe", "probe")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):       # the first call is slow
            pass
        tr.begin("probe", "probe", tid)
        with record_function("probe"):
            torch.ones(64).sum()
        tr.end("probe", tid)
    (probe,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    ((_, _, _, b, e, _),) = [s for s in obs_trace.closed_spans(
        tr.events()) if s[0] == "probe"]
    begin_ns, end_ns = tr.base_ns + b * 1e3, tr.base_ns + e * 1e3
    assert begin_ns - 50e3 <= probe.start_ns() < probe.end_ns() \
        <= end_ns + 50e3
    assert (end_ns - begin_ns) - (probe.end_ns() - probe.start_ns()) < 1e6
    interval = obs_trace.BASE_INTERVAL_S * 10 ** 9
    assert tr.base_ns % interval == 0
    assert 0 <= probe.start_ns() - tr.base_ns < interval
    with open(tr.save()) as f:
        doc = json.load(f)
    assert doc["baseTimeNanoseconds"] == tr.base_ns
    assert validate_events(doc) == []
    memory = Tracer(None)
    memory.instant("x", "probe")
    assert memory.save() is None and memory.path is None
    assert [e["name"] for e in memory.events()] == ["process_name", "x"]


def test_a_profile_records_the_engine_spans_in_memory_from_an_anchor(
        linreg):
    """With no tracer enabled, a torch.profiler profile gets the engine's
    spans in an in-memory tracer that starts with the anchor; the anchor's
    end is the profiler's, within 50 us. Outside the profile there is no
    span tracer."""
    from torch.profiler import ProfilerActivity, profile

    g, prob = linreg
    solver = E.ExactSolver(prob)
    step = E.make_step(g, cfg(), solver, device="cpu")
    state = E.init_state(theta0(), cfg(), solver)
    gen = torch.Generator().manual_seed(0)
    assert obs_trace.span_tracer() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, lambda ph: torch.rand((N, DIM),
                                                         generator=gen))
    assert obs_trace.span_tracer() is None and obs_trace.tracer() is None
    tr = obs_trace.last_profile()
    assert tr is not None and tr.path is None and tr.save() is None
    spans = obs_trace.closed_spans(tr.events())
    assert spans[0][0] == obs_trace.PROFILE_ANCHOR
    names = [s[0] for s in spans]
    assert names.count("engine.step") == 2 and names.count("engine.solve") \
        == 4
    (anchor,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == obs_trace.PROFILE_ANCHOR]
    assert abs(tr.base_ns + spans[0][4] * 1e3 - anchor.end_ns()) < 50e3


def traced_steps(linreg, tmp_path, traced, backend="dense"):
    """ROUNDS engine steps (alternating, quantized, group censoring, the
    flat diagnostics), with a file tracer or none: the final state, the
    metrics, the dispatch counts and the trace's events."""
    g, prob = linreg
    solver = E.ExactSolver(prob)
    c = cfg(mix_backend=backend)
    if traced:
        obs_trace.enable(str(tmp_path / "s.json"))
    before = dispatches()
    step = E.make_step(g, c, solver, device="cpu",
                       extra_metrics=E.flat_metrics(g, backend,
                                                    device="cpu"))
    state = E.init_state(theta0(), c, solver)
    gen = torch.Generator().manual_seed(0)
    ms = []
    for _ in range(ROUNDS):
        state, m = step(state, lambda ph: torch.rand((N, DIM),
                                                     generator=gen))
        ms.append(m)
    after = dispatches()
    events = None
    if traced:
        with open(obs_trace.save()) as f:
            doc = json.load(f)
        assert validate_events(doc) == []
        events = doc["traceEvents"]
        obs_trace.disable(save=False)
    return state, ms, {k: after[k] - before.get(k, 0) for k in after}, events


def assert_same_run(a, b):
    (state, ms, delta), (tstate, tms, tdelta) = a, b
    assert delta == tdelta and sum(delta.values()) > 0
    for name in ("theta", "theta_hat", "alpha"):
        for x, y in zip(T.leaves(getattr(state, name)),
                        T.leaves(getattr(tstate, name))):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for m, tm in zip(ms, tms):
        assert m.keys() == tm.keys()
        for k in m:
            torch.testing.assert_close(m[k], tm[k], rtol=0, atol=0)


def test_a_traced_engine_step_writes_the_layer_spans_of_an_unchanged_run(
        linreg, tmp_path):
    *plain, _ = traced_steps(linreg, tmp_path, False)
    *traced, events = traced_steps(linreg, tmp_path, True)
    assert_same_run(plain, traced)
    spans = step_spans(events)
    counts = {k: len(v) for k, v in spans.items()}
    assert counts == {"engine.make_step": 1, "engine.step": ROUNDS,
                      "engine.phase": 2 * ROUNDS, "engine.mix": 2 * ROUNDS,
                      "engine.solve": 2 * ROUNDS,
                      "engine.quantize": 2 * ROUNDS,
                      "engine.censor": 2 * ROUNDS, "engine.dual": ROUNDS,
                      "engine.diagnostics": ROUNDS,
                      # the linear problem's systems: factored once a phase
                      "solve.factor": 2, "solve.apply": 2 * ROUNDS}
    assert_nested(spans)
    assert sum(a["rows"] for _, _, a in spans["solve.factor"]) == N
    assert [a["k"] for _, _, a in spans["engine.step"]] == list(
        range(ROUNDS))
    assert [a["phase"] for _, _, a in spans["engine.phase"][:2]] == [
        "head", "tail"]
    assert sum(a["rows"] for _, _, a in spans["engine.phase"][:2]) == N
    assert all(a == {"backend": "dense", "D": DIM}
               for _, _, a in spans["engine.mix"])
    assert all(a == {"G": 2, "D": DIM}
               for _, _, a in spans["engine.quantize"])


def test_a_traced_dynamic_run_spans_each_redraw(tmp_path):
    """``run_dynamic`` over two graph phases on the sparse backend: the
    same values and dispatches traced, and the redraw's spans (the draws,
    one rebuild, a step built a phase) beside the steps."""
    from repro_torch.core import admm_baselines as ab
    from repro_torch.core import dynamic
    import dataclasses

    x, y = R.partition_uniform(R.synth_linear(n=N * 30, d=DIM, seed=0), N)
    prob = interop.problem_from_numpy(x, y, "linear", device="cpu")
    c = dataclasses.replace(ab.cq_ggadmm(rho=1.0), mix_backend="sparse")
    topo = dynamic.DynamicTopology(N, 0.5, refresh_every=3, seed=4)

    def run(traced):
        if traced:
            obs_trace.enable(str(tmp_path / "d.json"))
        before = dispatches()
        state, out = dynamic.run_dynamic(topo, prob, c, DIM, 6, seed=2,
                                         device="cpu")
        after = dispatches()
        doc = None
        if traced:
            with open(obs_trace.save()) as f:
                doc = json.load(f)
            obs_trace.disable(save=False)
        return state, out, {k: after[k] - before.get(k, 0)
                            for k in after}, doc

    state, out, delta, _ = run(False)
    tstate, tout, tdelta, doc = run(True)
    assert delta == tdelta and sum(delta.values()) > 0
    for k in out:
        np.testing.assert_array_equal(out[k], tout[k], err_msg=k)
    torch.testing.assert_close(state.theta, tstate.theta, rtol=0, atol=0)
    torch.testing.assert_close(state.alpha, tstate.alpha, rtol=0, atol=0)
    assert validate_events(doc) == []
    spans = step_spans(doc["traceEvents"])
    counts = {k: len(v) for k, v in spans.items()}
    assert counts["dynamic.graph_draw"] == 3       # phase 0 twice, phase 1
    assert counts["topology.rebuild"] == 1
    assert counts["engine.make_step"] == 2
    assert counts["engine.step"] == 6 and counts["engine.phase"] == 12
    assert_nested(spans)
    (rb, _, _), = spans["topology.rebuild"]
    steps = sorted(b for b, _, _ in spans["engine.step"])
    assert steps[2] < rb < steps[3]
    assert all(a["backend"] == "sparse" for _, _, a in spans["engine.mix"])


def test_a_traced_sharded_step_spans_the_all_gather(linreg, tmp_path):
    """At world one over a gloo group the sharded mix all-gathers: traced,
    one ``topology.all_gather`` inside each ``engine.mix``, and the run is
    the untraced one's."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        *plain, _ = traced_steps(linreg, tmp_path, False, "sharded")
        *traced, events = traced_steps(linreg, tmp_path, True, "sharded")
    finally:
        dist.destroy_process_group()
    assert_same_run(plain, traced)
    spans = step_spans(events)
    assert_nested(spans)
    # the phases' mixes, the dual's Laplacian, the diagnostics' residual
    assert len(spans["topology.all_gather"]) == 4 * ROUNDS
    mixes = spans["engine.mix"]
    assert len(mixes) == 2 * ROUNDS and all(
        sum(b <= gb and ge <= e for gb, ge, _ in spans["topology.all_gather"])
        == 1 for b, e, _ in mixes)
    assert all(a == {"world": 1} for _, _, a in spans["topology.all_gather"])


def test_an_untraced_step_calls_no_tracer_method_and_reads_no_device(
        linreg, monkeypatch):
    """No tracer and no profile: building and running steps and a redraw
    call no tracer method; and tracing reads nothing more from the tensors
    than an untraced step does (no host copy, no synchronisation)."""
    def refuse(*a, **kw):
        raise AssertionError("a tracer method was called")

    g, prob = linreg
    reads = []

    def counting(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads.append(name)
            return real(self, *a, **kw)
        return read

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))

    def steps():
        from repro_torch.core import dynamic

        solver = E.ExactSolver(prob)
        topo = dynamic.DynamicTopology(N, 0.4, refresh_every=2, seed=1)
        graph = topo.graph_at(1)
        built = E.topo_lib.build(graph, "sparse", device="cpu").rebuild(g)
        step = E.make_step(g, cfg(), solver, topology=built,
                           extra_metrics=E.flat_metrics(g, built))
        state = E.init_state(theta0(), cfg(), solver)
        gen = torch.Generator().manual_seed(0)
        reads.clear()
        for _ in range(2):
            state, _ = step(state, lambda ph: torch.rand((N, DIM),
                                                         generator=gen))
        return list(reads)

    obs_trace.enable(None)
    traced_reads = steps()
    obs_trace.disable(save=False)
    for name in ("begin", "end", "track", "instant", "counter", "span",
                 "events", "save"):
        monkeypatch.setattr(Tracer, name, refuse)
    assert steps() == traced_reads
