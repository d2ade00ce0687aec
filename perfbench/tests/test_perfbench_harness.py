"""CPU tests of the benchmark harness: discovery by name, the result line's
keys, the import rules, the trace reduction, a tiny rehearsal of each
cell's loop, the comparison failing the control and each planted fault,
the LM judge reading each step from its own inputs, a second model through
the LM harness by new files only, and the fleet's draw, masks and dark
share.

    PYTHONPATH=src python -m pytest -q perfbench/tests

The rehearsals run the program's plain (CPU) kernels at sizes a test holds
(``TINY``); the limits are the configuration's, set at the cell's size on
the card. At ``TINY`` the LM runs float32 activations: the bfloat16 error
of a 64-wide model is not that of the 768-wide one the limits were set at.
``test_a_cell_runs_on_the_card`` needs a CUDA card.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import control  # noqa: E402
from perfbench import run as bench  # noqa: E402
from perfbench import trace as trace_lib  # noqa: E402

# each configuration at a size a CPU test holds (its widths cut)
TINY = {"epsilon-linreg": {"workers": 8, "rows_per_worker": 40,
                           "n_features": 32},
        "xlstm-125m": {"d_model": 64, "num_layers": 2, "vocab_size": 128,
                       "seq": 16, "batch": 8, "dtype": "float32"}}
SEED = 2 ** 31 + 12345
CELLS = ("epsilon-linreg.dense", "epsilon-linreg.dynamic-sparse",
         "xlstm-125m.consensus", "xlstm-125m.fleet-faults")
FLEET = "xlstm-125m.fleet-faults"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the LM rehearsals' many small ops slow down many
    times over when the test workers' thread pools oversubscribe the
    CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tiny(cell):
    return TINY[cell.split(".")[0]]


def _driver(cell):
    spec = bench.load_spec()
    mix = bench.find(spec["workloads"], cell)["traffic"]
    name = bench.load_json(bench.HERE / "traffic" / f"{mix}.json")["driver"]
    return importlib.import_module(f"perfbench.drivers.{name}")


def _limits(cell):
    spec = bench.load_spec()
    wl = bench.find(spec["workloads"], cell)
    mix = bench.load_json(bench.HERE / "traffic" / f"{wl['traffic']}.json")
    return dict(bench.load_json(ROOT / bench.find(
        spec["configs"], wl["config"])["file"])["limits"],
        **mix.get("limits", {}))


def test_cells_configs_mixes_and_metrics_are_found_by_name():
    spec = bench.load_spec()
    assert sorted(w["name"] for w in spec["workloads"]) == sorted(CELLS)
    for wl in spec["workloads"]:
        assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
        cfg = bench.find(spec["configs"], wl["config"])
        assert (ROOT / cfg["file"]).is_file()
        mix = bench.load_json(bench.HERE / "traffic" / f"{wl['traffic']}.json")
        assert hasattr(importlib.import_module(
            f"perfbench.drivers.{mix['driver']}"), "run")
        e2e, layer = bench.cell_metrics(spec, wl["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert mix["rate_metric"] in names
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_rehearsal_of_the_cell_is_correct_and_reports_its_metrics(cell):
    result, out, checks = bench.run_cell(cell, SEED, 0.2, False, CPU,
                                         time.perf_counter(), _tiny(cell))
    assert result["correct"], checks
    assert set(result) == {"correct", "attempted", "failed", "metrics"}
    assert result["failed"] == 0 and result["attempted"] >= 1
    e2e, _ = bench.cell_metrics(bench.load_spec(), cell)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert [k for k, _, _ in checks] == list(_limits(cell))


def test_the_last_line_has_the_contracts_keys_and_the_checks_last():
    result, out, checks = bench.run_cell(CELLS[0], SEED, 0.1, False, CPU,
                                         time.perf_counter(), _tiny(CELLS[0]))
    line = bench.result_line(result, out, checks, "NVIDIA H100 80GB HBM3",
                             1, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    summary = trace_lib.summarize([("k", 0.0, 1.0, 0.0)], [], {}, 2.0, 1)
    traced = bench.result_line(result, dict(out, summary=summary), checks,
                               "NVIDIA H100 80GB HBM3", 1, True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    json.dumps(traced)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half_batch", "no_exchange",
                                   "altered"))
def test_a_planted_fault_is_judged_not_correct(cell, fault):
    assert fault in _driver(cell).FAULTS
    result, _, checks = bench.run_cell(cell, SEED, 0.1, False, CPU,
                                       time.perf_counter(), _tiny(cell),
                                       fault=fault)
    assert not result["correct"], checks
    assert result["failed"] > 0


@pytest.mark.parametrize("fault", ("deliver_now", "no_timeout"))
def test_a_planted_fleet_fault_is_judged_not_correct(fault):
    from perfbench.drivers import lm

    assert fault in _driver(FLEET).FLEET_FAULTS
    result, _, checks = bench.run_cell(FLEET, SEED, 0.1, False, CPU,
                                       time.perf_counter(), _tiny(FLEET),
                                       fault=fault)
    assert not result["correct"], checks
    assert result["failed"] > 0
    assert dict((k, v) for k, v, _ in checks)["fleet_errors"] > 0
    assert lm.faults_of(bench.load_json(
        bench.HERE / "traffic" / "consensus.json")) == lm.FAULTS


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    readings = control.control_readings(cell, SEED, CPU, _tiny(cell))
    limits = _limits(cell)
    assert any(readings[k] > limits[k] for k in limits), readings


def _lm_cell():
    cfg = bench.load_json(bench.HERE / "configs" / "xlstm-125m.json")
    cfg.update(TINY["xlstm-125m"])
    mix = bench.load_json(bench.HERE / "traffic" / "consensus.json")
    return cfg, mix


def test_a_judged_step_after_an_undetected_drift_reads_correct(monkeypatch):
    """The LM judge recomputes each stage of a step from the program's own
    inputs to it, so a step judged after the trajectory has drifted (here
    every worker's parameters scaled by 1.01 after an unjudged window step)
    still reads correct; the judged window step is the third, after two
    unjudged ones."""
    from perfbench.drivers import lm
    from repro_torch.core import engine as E
    from repro_torch.core import tree as T

    cfg, mix = _lm_cell()
    seed = next(s for s in range(SEED, SEED + 200)
                if lm.sampled_steps(mix, s) == {2})
    make_step, drifted = E.make_step, []

    def drifting(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def stepped(state, draw, batch=None, participation=None):
            state, m = step(state, draw, batch, participation)
            if state.k == mix["setup_steps"] + 1:
                drifted.append(state.k)
                state = dataclasses.replace(
                    state, theta=T.tree_map(lambda x: x * 1.01, state.theta))
            return state, m
        return stepped

    monkeypatch.setattr(E, "make_step", drifting)
    out = lm.run(cfg, mix, seed, 0.1, False, CPU)
    assert drifted == [mix["setup_steps"] + 1]
    assert len(out["per_iteration"]) == mix["setup_steps"] + 1
    limits = cfg["limits"]
    assert all(out["readings"][k] <= lim for k, lim in limits.items()), \
        out["readings"]


@pytest.mark.parametrize("cell", CELLS[2:])
def test_a_traced_lm_rehearsal_reads_its_host_metrics(monkeypatch, cell):
    """The LM cells' traced path on the CPU (the device synchronisations
    made no-ops) is correct and reads the metrics a CPU trace holds: the
    step's share of the peak, the local solve's host time and a fleet's
    dark share, which equals the judge's own count from its draw; the
    device readers find no device events and read nothing."""
    from repro_torch.obs import trace as obs_trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    obs_trace.disable(save=False)
    result, out, checks = bench.run_cell(cell, SEED, 0.1, True, CPU,
                                         time.perf_counter(), _tiny(cell))
    assert result["correct"], checks
    got = result["metrics"]
    want = {"step_mfu.lm", "solve_host_ms.lm"}
    if cell == FLEET:
        want.add("fleet_dark_share.lm")
        assert got["fleet_dark_share.lm"]["value"] == out["dark_share"]
    assert set(got) == want, got
    assert all(v["value"] > 0 for v in got.values())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_port():
    for path in bench.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def test_the_trace_reduction():
    assert trace_lib.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    nan = float("nan")
    device = [("stoch_quantize_kernel(float)", 0.0, 1.0, 0.4),
              ("void mix_tiled_kernel<4>", 3.0, 4.0, nan),
              ("stoch_quantize_kernel(float)", 10.0, 11.0, 9.7)]
    host = [("aten::linalg_solve", 0.3, 0.6), ("aten::linalg_solve", 9.6, 9.9),
            ("aten::add", 0.0, 12.0), ("cudaStreamSynchronize", 4.5, 9.5)]
    s = trace_lib.summarize(device, host,
                            {"stoch_quantize": 3, "bipartite_mix": 1}, 12.0, 2)
    assert s.busy_s == 3.0 and s.kernel("stoch_quantize") == (2, 2.0)
    assert s.breakdown["idle_gaps"] == [["cudaStreamSynchronize", 6.0],
                                        ["aten::add", 2.0]]
    assert s.breakdown["device_ops"][0] == ["stoch_quantize_kernel(float)",
                                            2.0]
    assert trace_lib.missed_launches(s) == [
        "stoch_quantize: profiler recorded 2 of 3 launches"]


def test_main_refuses_without_the_cards_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = bench.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 3 and capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
