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
