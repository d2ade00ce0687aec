"""CPU tests that the LM harness takes its model from the configuration
and its fleet from the mix:

* a second model (the program's one-layer "attn" decoder, at a smoke size,
  on 2 workers) runs through the LM driver's set-up, loop and judge, and
  through the control, with nothing but new files: its plain reference
  (``attn_reference.py`` beside this file, registered where a
  configuration's ``reference`` names it) and a configuration;
* the xLSTM judge's readings at one seed are those the harness gave before
  it took its model from the configuration, bit for bit;
* the fleet's fault draw and delivery buffer written again in
  ``reference/fleet.py`` give the program's masks, draw for draw.

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import importlib.util
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import control  # noqa: E402
from perfbench import run as bench  # noqa: E402
from perfbench.reference import fleet as fleet_ref  # noqa: E402

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")
# the program's one-layer attention decoder at a smoke size, 2 workers
ATTN = {"arch": "tinyllama-1.1b", "reference": "attn_smoke",
        "num_layers": 1, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "d_ff": 128, "vocab_size": 128, "dtype": "float32", "workers": 2,
        "batch": 4, "seq": 16, "local_steps": 2, "lr": 0.002, "rho": 0.01,
        "tau0": 5.0, "xi": 0.999, "bits": 6, "omega": 0.9995, "b_max": 16,
        "groups": "leaf", "graph_p": 0.4, "graph_seed": 0}
XLSTM_TINY = {"d_model": 64, "num_layers": 2, "vocab_size": 128, "seq": 16,
              "batch": 8, "dtype": "float32"}
# the xLSTM judge's readings at SEED and XLSTM_TINY, one torch thread, as
# the harness read them when it knew the xLSTM by name
XLSTM_PINNED = [
    {"grad_rel_err": 6.175208751447373e-07,
     "update_rel_err": 2.952872473573373e-06, "quant_errors": 0,
     "censor_errors": 0, "dual_rel_err": 5.980294604097518e-09,
     "loss_gap": 5.4461416618781464e-08},
    {"grad_rel_err": 5.101243171413865e-07,
     "update_rel_err": 4.127924749427361e-06, "quant_errors": 0,
     "censor_errors": 0, "dual_rel_err": 5.8072839479411605e-09,
     "loss_gap": 0.0}]
XLSTM_CONTROL_PINNED = {
    "grad_rel_err": 0.37540597273392207,
    "update_rel_err": 4.6281724813789025e-05, "quant_errors": 0,
    "censor_errors": 0, "dual_rel_err": 9.004257167479715e-09,
    "loss_gap": 0.001584148930900865}
HARNESS = ("drivers/lm.py", "drivers/convex.py", "drivers/planted.py",
           "reference/lm_consensus.py", "inputs.py", "bounds.py",
           "control.py", "run.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def attn_cell(monkeypatch):
    """The second model's configuration, its reference put where the
    configuration names it, and the limits of the xLSTM configuration."""
    spec = importlib.util.spec_from_file_location(
        "perfbench.reference.attn_smoke",
        Path(__file__).with_name("attn_reference.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setitem(sys.modules, "perfbench.reference.attn_smoke",
                        module)
    limits = bench.load_json(bench.HERE / "configs"
                             / "xlstm-125m.json")["limits"]
    return dict(ATTN, limits=limits)


def _mix(name):
    return bench.load_json(bench.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("traffic", ("consensus", "fleet-faults"))
def test_a_second_model_runs_through_the_harness_by_new_files(attn_cell,
                                                              traffic):
    """The driver builds the program's attention model from the
    configuration, checks its layout against the new reference, trains it
    and judges it correct; a planted fault fails a limit, and the control
    runs in the reference's own ``fp8``."""
    from perfbench.drivers import lm

    mix = _mix(traffic)
    limits = dict(attn_cell["limits"], **mix.get("limits", {}))
    out = lm.run(attn_cell, mix, SEED, 0.1, False, CPU)
    assert all(out["readings"][k] <= lim for k, lim in limits.items()), \
        out["readings"]
    assert out["work"]["token_flops"] > 0
    assert len(out["per_iteration"]) == mix["setup_steps"] + 1
    bad = lm.run(attn_cell, mix, SEED, 0.1, False, CPU, fault="altered")
    assert any(bad["readings"][k] > lim for k, lim in limits.items())
    # the limits were set at a full width: at this one the fp8 control's
    # gradients part from float32 by a fifth, far past the program's
    readings = control._lm_control(attn_cell, mix, SEED, CPU)
    assert readings["grad_rel_err"] > 0.1 > 1e3 * out["readings"][
        "grad_rel_err"], readings


def test_the_xlstm_judge_reads_as_before_bit_for_bit():
    cell = "xlstm-125m.consensus"
    _, out, _ = bench.run_cell(cell, SEED, 0.2, False, CPU,
                               time.perf_counter(), XLSTM_TINY)
    assert out["per_iteration"] == XLSTM_PINNED
    assert control.control_readings(cell, SEED, CPU, XLSTM_TINY) \
        == XLSTM_CONTROL_PINNED


def test_the_harness_names_no_model():
    for name in HARNESS:
        text = (bench.HERE / name).read_text()
        assert not re.search(r"xlstm", text, re.IGNORECASE), name


@pytest.mark.parametrize("faults", (
    fleet_ref.Faults(0.75, 2, 1.0),
    fleet_ref.Faults(0.6, 3, 0.5, skew=0.3),
    fleet_ref.Faults(0.9, 0, 1.0)))
def test_the_fault_draw_and_buffer_are_the_programs(faults):
    """``reference/fleet.py``'s draw equals the program's schedule's, and
    its buffer the program's ``staleness_trace``, over 40 rounds, seeds as
    large as a run's and censor decisions that sometimes fail."""
    from repro_torch.fleet.faults import (FaultConfig, FaultSchedule,
                                          staleness_trace)

    gids = range(6)
    for seed in (7, 2 ** 31 + 12345, 3_100_000_004):
        sched = FaultSchedule(FaultConfig(
            participation=faults.participation, skew=faults.skew,
            staleness=faults.staleness, stale_frac=faults.stale_frac,
            seed=seed))
        drops, lags = [], []
        for r in range(40):
            got = sched.round_faults(r, list(gids))
            drop, lag = faults.draw(seed, r, gids)
            assert np.array_equal(got.drop > 0, drop)
            assert np.array_equal(got.lag, lag)
            drops.append(got.drop)
            lags.append(got.lag)
        offered = np.random.default_rng(seed % 1000).uniform(
            size=(40, 6)) < 0.9
        part, deliver, timers = staleness_trace(np.stack(drops),
                                                np.stack(lags), offered)
        timer = np.zeros(6, np.int64)
        for r in range(40):
            want = fleet_ref.advance(timer, drops[r] > 0, lags[r],
                                     offered[r])
            assert np.array_equal(part[r] > 0, want["fleet_participation"])
            assert np.array_equal(deliver[r] > 0, want["fleet_deliver"])
            assert np.array_equal(timers[r], want["fleet_timer"])
            timer = want["fleet_timer"]
