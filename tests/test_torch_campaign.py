"""The port's campaign subsystem (``repro_torch.campaign``) on the CPU.

* The port's counterpart of each test of ``tests/test_campaign.py`` (grid
  expansion, run keys, validation, retry and backoff, fatal errors,
  blocked dependents, kill-and-resume byte identity, ``only=``, in-flight
  checkpoints, the store) and of ``tests/test_obs.py``'s three campaign
  tests (the stdout protocol mirrored into ``events.jsonl``, the history
  file, the runner's spans and retry instants), over
  ``repro_torch.campaign._selftest``.
* Against the JAX package: ``run_key``, ``sweep``, ``topological`` and
  ``closure`` equal; the JAX runner over ``repro.campaign._selftest`` and
  the port's over its copy give the same stdout protocol lines, the same
  ``events.jsonl`` events and the same store document once run keys are
  mapped (the keys hash the ``fn`` string, which names each package's
  module); ``partition_dirichlet`` bit for bit; ``stage_fleet_sweep`` at
  20 rounds makes the JAX package's three claims.
* The checkpoint form of ``EngineState`` round-trips bit for bit (also
  with bf16 and f16 replicas); the registered campaigns; ``paper-figures``
  through the runner with the figures stubbed; the trace report against
  ``tools/trace_report.py``; a traced ``--campaign`` run against an
  untraced one.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.campaign import runner as jrunner
from repro.campaign import spec as jspec
from repro.campaign.store import ResultStore as JResultStore
from repro.data import regression as jregression
from repro_torch.bench import campaigns, figures
from repro_torch.bench import fleet as port_fleet
from repro_torch.campaign import measure
from repro_torch.campaign import spec as pspec
from repro_torch.campaign.runner import RetryPolicy, RunContext, Runner
from repro_torch.campaign.spec import Campaign, run_key, stage, sweep
from repro_torch.campaign.store import Claim, Record, ResultStore, sanitize
from repro_torch.checkpoint import npz
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.data import regression as R
from repro_torch.launch import train
from repro_torch.obs import report
from repro_torch.obs import trace as obs_trace

ROOT = Path(__file__).resolve().parents[1]
EMIT = "repro_torch.campaign._selftest:emit"
ACC = "repro_torch.campaign._selftest:accumulate"
JEMIT = "repro.campaign._selftest:emit"
JACC = "repro.campaign._selftest:accumulate"
CPU = type("Ctx", (), {"device": "cpu"})()


def _calls(calls_dir, tag):
    p = Path(calls_dir) / f"{tag}.calls"
    return int(p.read_text()) if p.exists() else 0


def _campaign(name, *stages):
    return Campaign(name=name, stages=tuple(stages))


# ------------------------------------------------------------------ spec --
def test_sweep_grid_order():
    grid = sweep(a=[1, 2], b=["x", "y"])
    assert grid == [{"a": 1, "b": "x"}, {"a": 1, "b": "y"},
                    {"a": 2, "b": "x"}, {"a": 2, "b": "y"}]


def test_run_key_deterministic_and_sensitive():
    k1 = run_key("s", "m:f", {"a": 1, "b": [2, 3]})
    k2 = run_key("s", "m:f", {"b": [2, 3], "a": 1})   # key order irrelevant
    assert k1 == k2
    assert len(k1) == 12
    assert run_key("s", "m:f", {"a": 1, "b": [2, 4]}) != k1
    assert run_key("s2", "m:f", {"a": 1, "b": [2, 3]}) != k1
    assert run_key("s", "m:g", {"a": 1, "b": [2, 3]}) != k1


def test_campaign_validation_rejects_cycles_and_dups():
    with pytest.raises(ValueError):
        _campaign("bad",
                  stage("a", EMIT, deps=["b"]),
                  stage("b", EMIT, deps=["a"])).validate()
    with pytest.raises(ValueError):
        _campaign("dup", stage("a", EMIT), stage("a", EMIT)).validate()
    with pytest.raises(ValueError):
        _campaign("dupkeys",
                  stage("a", EMIT,
                        configs=[{"tag": "t"}, {"tag": "t"}])).validate()


def test_topological_respects_deps():
    camp = _campaign("topo",
                     stage("late", EMIT, deps=["early"],
                           configs=[{"tag": "l"}]),
                     stage("early", EMIT, configs=[{"tag": "e"}]))
    assert [s.name for s in camp.topological()] == ["early", "late"]


def _both(mod, fn_of):
    """The same DAG built by ``mod`` (the port's spec or the JAX one)."""
    return mod.Campaign(name="dag", stages=(
        mod.stage("c", fn_of, deps=["b"], configs=[{"tag": "c"}]),
        mod.stage("a", fn_of, configs=mod.sweep(tag=["a0", "a1"],
                                                 value=[1.0, 2.5])),
        mod.stage("b", fn_of, deps=["a"], configs=[{"tag": "b"}]),
        mod.stage("d", fn_of, configs=[{"tag": "d", "section": ["x", "y"]}]),
    ))


@pytest.mark.parametrize("axes", [
    {"a": [1, 2], "b": ["x", "y"]},
    {"groups": ["model", "leaf"], "censor_mode": ["global", "group"],
     "mix_backend": ["dense", "sparse"]},
    {"n": [3], "p": [0.1, 0.3, 1.0], "d": [[1, 2], {"k": None}]},
])
def test_sweep_and_run_key_equal_the_jax_package(axes):
    assert sweep(**axes) == jspec.sweep(**axes)
    for i, cfg in enumerate(sweep(**axes)):
        assert pspec.canonical_json(cfg) == jspec.canonical_json(cfg)
        assert (run_key(f"s{i}", "m:f", cfg)
                == jspec.run_key(f"s{i}", "m:f", cfg))


def test_topological_closure_subset_equal_the_jax_package():
    port, jax_ = _both(pspec, "m:f"), _both(jspec, "m:f")
    port.validate()
    jax_.validate()
    assert ([s.name for s in port.topological()]
            == [s.name for s in jax_.topological()] == ["a", "d", "b", "c"])
    for name in "abcd":
        assert port.closure(name) == jax_.closure(name)
        assert ([s.name for s in port.subset(port.closure(name)).stages]
                == [s.name for s in jax_.subset(jax_.closure(name)).stages])
    assert ([r.key for s in port.stages for r in s.runs]
            == [r.key for s in jax_.stages for r in s.runs])


# ----------------------------------------------------------- retry logic --
def test_transient_twice_then_succeeds_with_backoff(tmp_path):
    calls_dir = str(tmp_path / "calls")
    camp = _campaign("retry", stage("s", EMIT, configs=[
        {"tag": "t", "value": 1.0, "calls_dir": calls_dir,
         "transient_failures": 2}]))
    slept = []
    summary = Runner(camp, store=ResultStore(tmp_path / "out.json"),
                     state_root=tmp_path / "state",
                     retry=RetryPolicy(max_retries=2, backoff_s=0.5,
                                       backoff_mult=2.0),
                     sleep=slept.append).run()
    assert summary.executed == 1 and summary.failed == 0
    assert summary.exit_code == 0
    assert _calls(calls_dir, "t") == 3          # 2 transient + 1 success
    assert slept == [0.5, 1.0]                  # exponential backoff


def test_transient_retries_exhausted_fails(tmp_path):
    calls_dir = str(tmp_path / "calls")
    camp = _campaign("retry", stage("s", EMIT, configs=[
        {"tag": "t", "calls_dir": calls_dir, "transient_failures": 99}]))
    summary = Runner(camp, store=ResultStore(tmp_path / "out.json"),
                     state_root=tmp_path / "state",
                     retry=RetryPolicy(max_retries=2),
                     sleep=lambda s: None).run()
    assert summary.failed == 1 and summary.exit_code == 1
    assert _calls(calls_dir, "t") == 3          # initial + 2 retries, no more


def test_fatal_error_never_retried(tmp_path):
    calls_dir = str(tmp_path / "calls")
    marker = tmp_path / "fatal.marker"
    marker.write_text("")
    camp = _campaign("fatal", stage("s", EMIT, configs=[
        {"tag": "t", "calls_dir": calls_dir,
         "fatal_marker": str(marker)}]))
    summary = Runner(camp, store=ResultStore(tmp_path / "out.json"),
                     state_root=tmp_path / "state",
                     sleep=lambda s: None).run()
    assert summary.failed == 1
    assert _calls(calls_dir, "t") == 1          # exactly one attempt


def test_failed_dependency_blocks_downstream(tmp_path):
    calls_dir = str(tmp_path / "calls")
    marker = tmp_path / "fatal.marker"
    marker.write_text("")
    camp = _campaign(
        "blocked",
        stage("a", EMIT, configs=[{"tag": "a", "calls_dir": calls_dir,
                                   "fatal_marker": str(marker)}]),
        stage("b", EMIT, deps=["a"],
              configs=[{"tag": "b", "calls_dir": calls_dir}]))
    summary = Runner(camp, store=ResultStore(tmp_path / "out.json"),
                     state_root=tmp_path / "state").run()
    assert summary.failed == 2                  # a failed, b blocked
    assert _calls(calls_dir, "b") == 0          # b never executed


# ---------------------------------------------------------- crash-resume --
def _kill_resume_campaign(calls_dir, die_marker):
    return _campaign(
        "kr",
        stage("s", EMIT, configs=[
            {"tag": "one", "value": 1.5, "calls_dir": calls_dir},
            {"tag": "two", "value": 2.5, "calls_dir": calls_dir},
            {"tag": "three", "value": 3.5, "calls_dir": calls_dir,
             "die_marker": die_marker}]))


def test_kill_then_resume_skips_completed_and_is_byte_identical(tmp_path):
    calls_dir = str(tmp_path / "calls")
    marker = tmp_path / "die.marker"
    marker.write_text("")
    camp = _kill_resume_campaign(calls_dir, str(marker))
    store = ResultStore(tmp_path / "out.json")
    state = tmp_path / "state"

    with pytest.raises(KeyboardInterrupt):
        Runner(camp, store=store, state_root=state).run()
    assert _calls(calls_dir, "one") == 1
    assert _calls(calls_dir, "three") == 1      # attempted, then killed

    marker.unlink()                             # "restart" after the kill
    summary = Runner(camp, store=store, state_root=state, resume=True).run()
    assert summary.executed == 1                # only the killed run
    assert summary.skipped == 2                 # completed runs not re-run
    assert _calls(calls_dir, "one") == 1
    assert _calls(calls_dir, "two") == 1
    assert _calls(calls_dir, "three") == 2

    # reference: the same campaign uninterrupted, in a fresh store/state
    ref_calls = str(tmp_path / "ref_calls")
    ref_camp = _kill_resume_campaign(ref_calls, str(tmp_path / "no.marker"))
    ref_store = ResultStore(tmp_path / "ref.json")
    Runner(ref_camp, store=ref_store, state_root=tmp_path / "ref_state").run()
    assert store.path.read_bytes() == ref_store.path.read_bytes()


def test_resume_with_nothing_done_runs_everything(tmp_path):
    calls_dir = str(tmp_path / "calls")
    camp = _campaign("fresh", stage("s", EMIT, configs=[
        {"tag": "t", "calls_dir": calls_dir}]))
    summary = Runner(camp, store=ResultStore(tmp_path / "out.json"),
                     state_root=tmp_path / "state", resume=True).run()
    assert summary.executed == 1 and summary.skipped == 0


# -------------------------------------------------------------- only=... --
def test_only_runs_dependency_closure(tmp_path):
    calls_dir = str(tmp_path / "calls")
    camp = _campaign(
        "only",
        stage("a", EMIT, configs=[{"tag": "a", "calls_dir": calls_dir}]),
        stage("b", EMIT, deps=["a"],
              configs=[{"tag": "b", "calls_dir": calls_dir}]),
        stage("c", EMIT, configs=[{"tag": "c", "calls_dir": calls_dir}]))
    store = ResultStore(tmp_path / "out.json")
    state = tmp_path / "state"

    s1 = Runner(camp, store=store, state_root=state, only="b").run()
    assert s1.executed == 2                     # a (dep) + b
    assert _calls(calls_dir, "c") == 0          # outside the closure

    # re-running --only b: the completed dep is skipped, the target re-runs
    s2 = Runner(camp, store=store, state_root=state, only="b").run()
    assert s2.executed == 1 and s2.skipped == 1
    assert _calls(calls_dir, "a") == 1
    assert _calls(calls_dir, "b") == 2
    assert _calls(calls_dir, "c") == 0


# --------------------------------------------------- in-flight checkpoints --
def test_ctx_checkpoint_resume_mid_run(tmp_path):
    marker = tmp_path / "die.marker"
    marker.write_text("")
    camp = _campaign("acc", stage("s", ACC, configs=[
        {"tag": "t", "steps": 8, "die_marker": str(marker),
         "die_at_step": 5}]))
    store = ResultStore(tmp_path / "out.json")
    state = tmp_path / "state"

    with pytest.raises(KeyboardInterrupt):
        Runner(camp, store=store, state_root=state).run()

    marker.unlink()
    summary = Runner(camp, store=store, state_root=state, resume=True).run()
    assert summary.executed == 1 and summary.claims_failed == 0
    doc = store.load()
    sec = doc["selftest"]["t"]
    assert sec["acc"] == sum(range(8))
    assert sec["resumed_from"] == 5             # picked up mid-run, not at 0
    assert doc["selftest"]["claims"]["t_sum_ok"] is True


# ------------------------------------------------------------------ store --
def test_store_merge_is_atomic_and_key_stable(tmp_path):
    store = ResultStore(tmp_path / "out.json")
    store.merge(Record(section=("x",), data={"v": 1},
                       claims=(Claim("x_ok", True),)))
    store.merge(Record(section=("y", "z"), data={"v": 2},
                       claims=(Claim("y_ok", False),)))
    first = json.loads(store.path.read_text())
    assert first == {"x": {"v": 1}, "claims": {"x_ok": True, "y_ok": False},
                     "y": {"z": {"v": 2}}}
    # re-merging an existing section updates in place, preserving key order
    store.merge(Record(section=("x",), data={"v": 3},
                       claims=(Claim("x_ok", True),)))
    again = json.loads(store.path.read_text())
    assert again["x"] == {"v": 3}
    assert list(again) == list(first)
    assert (tmp_path / "out.json").exists()
    assert list(tmp_path.glob("*.tmp")) == []   # no temp litter


def test_sanitize_takes_tensors_and_the_default_paths_are_the_ports():
    got = sanitize({"a": torch.tensor([1.5, 2.0]), "b": torch.tensor(3),
                    "c": (np.float32(0.5), torch.tensor(True)),
                    "d": np.arange(2)})
    assert got == {"a": [1.5, 2.0], "b": 3, "c": [0.5, True], "d": [0, 1]}
    assert json.dumps(got)
    from repro_torch.campaign import runner, store
    assert Path(store.DEFAULT_PATH).parent == Path(runner.DEFAULT_STATE_ROOT)
    assert str(store.DEFAULT_PATH) != "BENCH_engine.json"
    assert runner.DEFAULT_STATE_ROOT != jrunner.DEFAULT_STATE_ROOT


# ------------------------------------------------- observability (obs) --
def _selftest_campaign(name="obs-camp"):
    return Campaign(name=name, stages=(
        stage("s", EMIT, configs=[{"tag": "t", "value": 1.0}]),))


def test_campaign_stdout_unchanged_and_mirrored(tmp_path, capsys):
    camp = _selftest_campaign()
    store = ResultStore(tmp_path / "out.json")
    summary = Runner(camp, store=store,
                     state_root=tmp_path / "state").run()
    out = capsys.readouterr().out
    spec = camp.stages[0].runs[0]
    assert "claim,s,t_finite,PASS\n" in out
    assert f"run,s,{spec.key},{spec.display},done\n" in out
    assert re.search(r"^# campaign obs-camp: executed=1 skipped=0 "
                     r"failed=0 claim_failures=0$", out, re.M)
    events = [json.loads(ln) for ln in
              (tmp_path / "state" / "obs-camp" / "events.jsonl")
              .read_text().splitlines()]
    kinds = [(e["event"], e.get("status")) for e in events]
    assert ("claim", None) in kinds
    assert ("run", "done") in kinds
    assert ("summary", None) in kinds
    done = next(e for e in events if e.get("status") == "done")
    assert done["campaign"] == "obs-camp" and done["stage"] == "s"
    assert done["key"] == spec.key
    assert "ts" in done
    assert summary.executed == 1


def test_history_appends_across_runs(tmp_path):
    camp = _selftest_campaign()
    store = ResultStore(tmp_path / "out.json")
    Runner(camp, store=store, state_root=tmp_path / "state").run()
    h1 = store.history()
    assert len(h1) == 1
    assert h1[0]["meta"]["campaign"] == "obs-camp"
    assert h1[0]["data"]["value"] == 1.0 and "ts" in h1[0]
    Runner(camp, store=store, state_root=tmp_path / "state",
           resume=True).run()
    h2 = store.history()
    assert len(h2) == 2
    assert h2[0]["data"] == h2[1]["data"]
    assert h2[1]["ts"] >= h2[0]["ts"]


def test_campaign_run_spans_and_retry_instants(tmp_path):
    tr = obs_trace.enable(str(tmp_path / "trace.json"))
    try:
        camp = Campaign(name="obs-retry", stages=(
            stage("s", EMIT, configs=[{
                "tag": "t", "value": 1.0,
                "calls_dir": str(tmp_path / "calls"),
                "transient_failures": 1}]),))
        Runner(camp, store=ResultStore(tmp_path / "out.json"),
               state_root=tmp_path / "state",
               retry=RetryPolicy(max_retries=2, backoff_s=0.0),
               sleep=lambda s: None).run()
        with open(tr.save()) as f:
            doc = json.load(f)
    finally:
        obs_trace.disable(save=False)
    assert obs_trace.validate_events(doc) == []
    names = [(e["ph"], e["name"]) for e in doc["traceEvents"]]
    assert ("B", "run") in names and ("E", "run") in names
    assert ("i", "retry") in names


# ------------------------------------------- the JAX runner, side by side --
def _parity_campaign(mod, emit, acc, tmp, tag):
    """One campaign shape in either package: a retried run, a completed
    one, a fatal one blocking its dependent, an accumulating run with
    in-flight checkpoints."""
    calls = str(tmp / f"{tag}_calls")
    marker = tmp / f"{tag}_fatal"
    marker.write_text("")
    return mod.Campaign(name="parity", stages=(
        mod.stage("a", emit, configs=[
            {"tag": "r", "value": 1.5, "calls_dir": calls,
             "transient_failures": 1},
            {"tag": "ok", "value": 2.5, "section": ["sec", "sub"]}],
            names=["retried", "plain"]),
        mod.stage("f", emit, configs=[
            {"tag": "f", "fatal_marker": str(marker)}], names=["fatal"]),
        mod.stage("g", emit, deps=["f"], configs=[{"tag": "g"}],
                  names=["blocked"]),
        mod.stage("acc", acc, deps=["a"], configs=[{"tag": "acc",
                                                    "steps": 5}],
                  names=["acc"]),
    ))


def _run_parity(mod_runner, camp, store_cls, tmp, tag, capsys):
    store = store_cls(tmp / tag / "doc.json")
    summary = mod_runner.Runner(
        camp, store=store, state_root=tmp / f"{tag}_state",
        retry=mod_runner.RetryPolicy(max_retries=2, backoff_s=0.0),
        sleep=lambda s: None).run()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("run,", "claim,", "# campaign", "# run "))]
    events = [json.loads(ln) for ln in
              (tmp / f"{tag}_state" / "parity" / "events.jsonl")
              .read_text().splitlines()]
    return summary, lines, events, store


def test_runner_gives_the_jax_runners_protocol_events_and_document(
        tmp_path, capsys):
    port_camp = _parity_campaign(pspec, EMIT, ACC, tmp_path, "port")
    jax_camp = _parity_campaign(jspec, JEMIT, JACC, tmp_path, "jax")
    keys = {j.key: p.key for js, ps in zip(jax_camp.stages, port_camp.stages)
            for j, p in zip(js.runs, ps.runs)}
    assert len(keys) == 5 and all(a != b for a, b in keys.items())
    ps, plines, pevents, pstore = _run_parity(
        sys.modules["repro_torch.campaign.runner"], port_camp, ResultStore,
        tmp_path, "port", capsys)
    js, jlines, jevents, jstore = _run_parity(
        jrunner, jax_camp, JResultStore, tmp_path, "jax", capsys)

    def mapped(text):
        for jk, pk in keys.items():
            text = text.replace(jk, pk)
        return text

    assert (ps.executed, ps.skipped, ps.failed, ps.claims_failed) == (
        js.executed, js.skipped, js.failed, js.claims_failed) == (3, 0, 2, 0)
    assert plines == [mapped(ln) for ln in jlines]
    assert any(ln.startswith("run,g,") and ln.endswith(",blocked")
               for ln in plines)

    def strip(evs):
        return [{k: v for k, v in e.items() if k != "ts"} for e in evs]

    assert strip(pevents) == [json.loads(mapped(json.dumps(e)))
                              for e in strip(jevents)]
    assert pstore.path.read_bytes() == jstore.path.read_bytes()
    ph, jh = pstore.history(), jstore.history()
    assert len(ph) == len(jh) == 3
    assert [{k: v for k, v in e.items() if k != "ts"} for e in ph] == [
        json.loads(mapped(json.dumps({k: v for k, v in e.items()
                                      if k != "ts"}))) for e in jh]


# -------------------------------------------- EngineState's checkpoint --
def _trained_state(hat_dtype):
    """A multi-leaf engine state after two quantized steps with an inexact
    (Adam) solver: k = 2, the first-round flags set, (R, b, Δ) moved."""
    gen = torch.Generator().manual_seed(0)
    theta = {"w": torch.randn((2, 6), generator=gen),
             "b": {"c": torch.randn((2, 3), generator=gen)}}
    cfg = E.EngineConfig(rho=0.1, censor=CensorConfig(tau0=0.01, xi=0.9),
                         quantize=QuantConfig(b0=3, omega=0.99),
                         groups="leaf", hat_dtype=hat_dtype)
    def grad_fn(th, batch):
        return T.tree_map(lambda a: a - 0.5, th)

    solver = E.InexactSolver(grad_fn=grad_fn, local_steps=2, local_lr=0.05)
    state = E.init_state(theta, cfg, solver)
    graph = random_bipartite_graph(2, 1.0, seed=0)
    step = E.make_step(graph, cfg, solver, device="cpu")
    for _ in range(2):
        state, _ = step(state, lambda ph: torch.rand((2, 9), generator=gen),
                        None)
    return theta, cfg, solver, state


@pytest.mark.parametrize("hat_dtype", [None, "bfloat16", "float16"])
def test_engine_state_checkpoint_round_trips_bit_for_bit(tmp_path,
                                                         hat_dtype):
    theta, cfg, solver, state = _trained_state(hat_dtype)
    assert state.k == 2 and bool((state.quant.initialized == 1).all())
    template = {"state": E.init_state(theta, cfg, solver),
                "loss": np.full(4, np.nan), "bits": np.full(4, np.nan)}
    loss = np.array([1.0, 0.5, np.nan, np.nan])
    ctx = RunContext(None, tmp_path, None, device="cpu")
    assert ctx.restore(template) is None
    ctx.checkpoint(2, {"state": state, "loss": loss, "bits": loss * 3})
    tree, step = ctx.restore(template)
    assert step == 2
    got = tree["state"]
    assert type(got) is E.EngineState and got.k == 2
    assert type(got.quant) is type(state.quant)
    np.testing.assert_array_equal(tree["loss"], loss)
    np.testing.assert_array_equal(tree["bits"], loss * 3)
    want = npz.encode(state)
    assert T.paths(npz.encode(got)) == T.paths(want)
    for a, b, x in zip(T.leaves(npz.encode(got)), T.leaves(want),
                       T.leaves(npz.encode(template["state"]))):
        assert a.dtype == b.dtype == x.dtype and torch.equal(a, b)
    for name in ("theta_hat", "alpha", "opt_mu", "opt_nu", "theta"):
        for a, b in zip(T.leaves(getattr(got, name)),
                        T.leaves(getattr(state, name))):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    want_hat = E.HAT_DTYPES[hat_dtype] if hat_dtype else torch.float32
    assert all(x.dtype == want_hat for x in T.leaves(got.quant.q_hat))


def test_npz_checkpoint_form_keeps_plain_trees_in_the_jax_layout(tmp_path):
    tree = {"a": {"w": torch.ones((2, 3))}, "b": torch.zeros(4)}
    npz.save(tmp_path, 1, tree)
    with np.load(tmp_path / "step_1.npz") as data:
        assert sorted(data.files) == ["['a']['w']", "['b']"]
    back, _ = npz.restore(tmp_path, tree)
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    with pytest.raises(TypeError, match="cannot checkpoint"):
        npz.save(tmp_path, 2, {"x": "text"})


# --------------------------------------------------------- data, fleet --
@pytest.mark.parametrize("dataset,alpha,seed,n_workers", [
    ("synth-linear", 0.3, 0, 8), ("synth-linear", 0.05, 3, 12),
    ("bodyfat", 1.0, 1, 6), ("derm", 0.3, 2, 9),
    ("synth-logistic", 10.0, 5, 24)])
def test_partition_dirichlet_equals_the_jax_package(dataset, alpha, seed,
                                                    n_workers):
    data = R.DATASETS[dataset]()
    jdata = jregression.DATASETS[dataset]()
    x, y = R.partition_dirichlet(data, n_workers, alpha=alpha, seed=seed)
    jx, jy = jregression.partition_dirichlet(jdata, n_workers, alpha=alpha,
                                             seed=seed)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_fleet_sweep_makes_the_jax_claims_at_20_rounds():
    from benchmarks import bench_fleet
    want = bench_fleet.stage_fleet_sweep(rounds=20)
    got = port_fleet.stage_fleet_sweep(rounds=20, ctx=CPU)
    assert got.section == want.section == ("fleet",)
    assert [(c.name, c.ok, c.gate) for c in got.claims] == [
        (c.name, c.ok, c.gate) for c in want.claims]
    assert all(c.ok for c in got.claims)
    assert sorted(got.data["arms"]) == sorted(want.data["arms"])
    # the fault-free arm is the synchronous engine; staleness without a
    # drop never starts a packet, so that arm is the same run
    arms = got.data["arms"]
    assert arms["iid|p1.0|L0"] == dict(arms["iid|p1.0|L2"], staleness=0)
    for label, arm in arms.items():
        assert len(arm["gap_curve"]) == 20 and np.isfinite(
            arm["total_bits"]), label


def test_fleet_sweep_fault_free_arm_is_run_synchronous_bit_for_bit(
        monkeypatch):
    """The claim's own comparison, seen from outside: the fleet arm's
    final state equals the port's ``run_synchronous`` run at the sweep's
    settings, every leaf bit for bit."""
    seen = {}
    orig = port_fleet._bitwise_equal

    def spy(fleet_m, sync_m, fleet_state, sync_state):
        seen["pair"] = (fleet_m, sync_m, fleet_state, sync_state)
        return orig(fleet_m, sync_m, fleet_state, sync_state)

    monkeypatch.setattr(port_fleet, "_bitwise_equal", spy)
    rec = port_fleet.stage_fleet_sweep(rounds=12, ctx=CPU)
    fleet_m, sync_m, fs, ss = seen["pair"]
    for k in ("payload_bits", "tx_mask", "bits_per_group", "objective"):
        np.testing.assert_array_equal(fleet_m[k], sync_m[k])
    for name in ("theta", "theta_hat", "alpha"):
        assert torch.equal(getattr(fs, name), getattr(ss, name))
    assert rec.claims[0].ok


# ---------------------------------------------------------- campaigns --
def test_registered_campaigns_spell_out_the_jax_configs():
    from benchmarks import campaigns as jcampaigns
    assert campaigns.PORTED == ("lm-sweep", "paper-figures", "fleet-sweep")
    for name in campaigns.PORTED:
        port, jax_ = campaigns.get(name), jcampaigns.get(name)
        assert [(s.name, s.deps) for s in port.stages] == [
            (s.name, s.deps) for s in jax_.stages]
        for ps, js in zip(port.stages, jax_.stages):
            assert [(r.name, dict(r.config)) for r in ps.runs] == [
                (r.name, dict(r.config)) for r in js.runs]
            for pr, jr in zip(ps.runs, js.runs):
                assert pr.fn.startswith("repro_torch.")
                assert pr.fn.split(":")[1] == jr.fn.split(":")[1]
                # one (stage, fn, config), one key in both packages
                assert pr.key == jspec.run_key(jr.stage, pr.fn, jr.config)
                assert jr.key == run_key(pr.stage, jr.fn, pr.config)
    lm = campaigns.get("lm-sweep")
    assert [len(s.runs) for s in lm.stages] == [2, 8]
    assert lm.stage("lm-grid").deps == ("lm-baseline",)
    assert {r.config["steps"] for r in lm.stage("lm-grid").runs} == {6}
    with pytest.raises(KeyError, match="unknown campaign"):
        campaigns.get("no-such-campaign")


def _stub_figures(monkeypatch, fail=None):
    for name in campaigns.FIGURES:
        rows = {"c-admm": {"iters": 3, "rounds": 4.0, "bits": np.inf,
                           "energy": 1.0, "final_gap": 0.0}}
        monkeypatch.setitem(
            figures.ALL_FIGURES, name,
            lambda device=None, rows=rows, name=name: (
                rows, {"holds": name != fail, "other": True}))


def test_paper_figures_through_the_runner(tmp_path, monkeypatch, capsys):
    _stub_figures(monkeypatch)
    out = train.main(["--campaign", "paper-figures", "--device", "cpu",
                      "--campaign-dir", str(tmp_path)])
    assert out == {"campaign": "paper-figures", "executed": 5, "skipped": 0,
                   "failed": 0, "claim_failures": 0}
    text = capsys.readouterr().out
    for name in campaigns.FIGURES:
        assert f"claim,figures,{name}_holds,PASS\n" in text
        assert f"# claim {name}_holds: True (value None; gate paper " \
               f"qualitative claim)" in text
    doc = ResultStore(tmp_path / "BENCH_engine.json").load()
    assert sorted(doc["figures"]["claims"]) == sorted(
        f"{n}_{c}" for n in campaigns.FIGURES for c in ("holds", "other"))
    assert doc["figures"]["fig3_linreg_real"]["c-admm"]["bits"] == np.inf
    # figures.main runs a one-run campaign with the full campaign's key
    full = {r.name: r.key for r in campaigns.FIGURES_STAGE.runs}
    one = figures.figure_campaign("fig6_density").stages[0].runs[0]
    assert one.key == full["fig6_density"]
    _stub_figures(monkeypatch, fail="fig6_density")
    d2 = tmp_path / "again"
    assert figures.main(["--figures", "fig6_density,fig2_linreg_synth",
                         "--device", "cpu", "--campaign-dir", str(d2),
                         "--out", str(tmp_path / "f.json")]) == 1
    text = capsys.readouterr().out
    assert f"run,figures,{one.key},fig6_density,done\n" in text
    assert "claim,figures,fig6_density_holds,FAIL\n" in text
    got = json.loads((tmp_path / "f.json").read_text())
    assert got["fig6_density"]["claims"] == {"holds": False, "other": True}
    assert got["fig2_linreg_synth"]["rows"]["c-admm"]["bits"] == "inf"
    assert (d2 / "paper-figures" / one.key / "record.json").exists()


# ----------------------------------------------------- trace report ----
def _trace_doc(tmp_path):
    tr = obs_trace.Tracer(str(tmp_path / "t.json"))
    tid = tr.track("campaign", "s/run")
    for i in range(3):
        tr.begin("run", "campaign", tid, args={"i": i})
        tr.instant("retry", "campaign", tid)
        tr.end("campaign", tid)
    rt = tr.track("engine", "rounds")
    tr.begin("round", "engine", rt)
    tr.counter("ledger", "engine", {"bits": 12.0, "rounds": 1})
    tr.end("engine", rt)
    with open(tr.save()) as f:
        return json.load(f)


def test_trace_report_equals_the_tool(tmp_path, capsys):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    doc = _trace_doc(tmp_path)
    assert report.summarize(doc) == trace_report.summarize(doc)
    reqs = ["span:run", "instant:retry", "counter:ledger", "span:nope",
            "bogus:x"]
    summary = report.summarize(doc)
    assert report.check_requirements(summary, reqs) == \
        trace_report.check_requirements(summary, reqs)
    assert len(report.check_requirements(summary, reqs)) == 2
    path = str(tmp_path / "t.json")
    assert report.main([path, "--json", "--require", "span:run"]) == 0
    assert json.loads(capsys.readouterr().out) == summary
    assert report.main([path, "--require", "span:missing"]) == 1
    (tmp_path / "bad.json").write_text(json.dumps(
        {"traceEvents": [{"ph": "E", "ts": 0, "pid": 1, "tid": 1}]}))
    assert report.main([str(tmp_path / "bad.json")]) == 1


def test_traced_campaign_passes_the_report_and_equals_an_untraced_run(
        tmp_path):
    base = ["--campaign", "fleet-sweep", "--device", "cpu"]
    plain = train.main(base + ["--campaign-dir", str(tmp_path / "plain")])
    path = str(tmp_path / "trace.json")
    try:
        traced = train.main(base + ["--campaign-dir", str(tmp_path / "tr"),
                                    "--trace", path])
    finally:
        obs_trace.disable(save=False)
    assert plain == traced == {"campaign": "fleet-sweep", "executed": 1,
                               "skipped": 0, "failed": 0,
                               "claim_failures": 0}
    assert report.main([path, "--require", "span:run", "instant:drop",
                        "counter:ledger"]) == 0
    spec = campaigns.FLEET_STAGE.runs[0]
    rec = [(d / "fleet-sweep" / spec.key / "record.json").read_bytes()
           for d in (tmp_path / "plain", tmp_path / "tr")]
    assert rec[0] == rec[1]
    assert ((tmp_path / "plain" / "BENCH_engine.json").read_bytes()
            == (tmp_path / "tr" / "BENCH_engine.json").read_bytes())


# ------------------------------------------------------------ measure --
def test_measure_helpers_time_and_return_the_output():
    x = torch.arange(6.0)
    us, out = measure.time_per_call(lambda a: a * 2, x, reps=3)
    assert us > 0 and torch.equal(out, x * 2)
    assert measure.time_run(lambda: x + 1, repeats=2) > 0
    a, b = measure.interleaved_median([lambda: x + 1, lambda: x * 3],
                                      rounds=3)
    assert a > 0 and b > 0
    p = measure.percentiles([0.001, 0.002, 0.003])
    assert p["n"] == 3 and p["p50_ms"] == pytest.approx(2.0)
    nest = {"a": [x, (x,)], "b": None}
    assert measure.block_until_ready(nest) is nest
