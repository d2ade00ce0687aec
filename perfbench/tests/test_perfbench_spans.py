"""CPU tests of the readers of the program's spans (``perfbench/spans.py``):
the placement by the anchor, the reductions on synthetic events, and a
traced rehearsal of each convex cell on the CPU, whose profiler records
the host ops the spans must hold.

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import run as bench  # noqa: E402
from perfbench import spans  # noqa: E402
from perfbench import trace as trace_lib  # noqa: E402

ANCHOR = "anchor"
CELLS = ("epsilon-linreg.dense", "epsilon-linreg.dynamic-sparse")
NEW = ("solve_host_ms.convex", "censor_ms.convex", "dual_ms.convex",
       "diagnostics_ms.convex", "launches_per_iter.convex",
       "redraw_ms.convex")
TINY = {"workers": 8, "rows_per_worker": 40, "n_features": 32}
SEED = 2 ** 31 + 12345


def closed(name, b_us, e_us):
    return (name, 1, 1, b_us, e_us, {})


# a tracer's spans (us on its clock) and the profiler's anchor (s from the
# stretch's first event): the tracer's clock reads 1e6 us + 500 us more
TRACER = [closed("engine.step", 10.0, 20.0),            # an earlier profile
          closed(ANCHOR, 1_000_400.0, 1_000_500.0),
          closed("engine.solve", 1_000_600.0, 1_000_700.0),
          closed("engine.censor", 1_000_800.0, 1_000_900.0),
          closed("engine.step", 1_000_550.0, 1_001_000.0),
          closed("engine.solve", 1_001_100.0, 1_001_200.0),
          closed("engine.step", 1_001_050.0, 1_001_300.0),
          closed("dynamic.graph_draw", 1_001_310.0, 1_001_320.0),
          closed("topology.rebuild", 1_001_320.0, 1_001_360.0),
          closed("engine.make_step", 1_001_360.0, 1_001_400.0)]
HOST_ANCHOR = np.array([[0.0, 0.0]])
NAN = float("nan")
# (name, start, end, launched at), in s of the profiler's time base
DEVICE = [("solve_k", 150e-6, 250e-6, 110e-6),
          ("solve_k", 260e-6, 300e-6, 190e-6),
          ("censor_k", 310e-6, 330e-6, 320e-6),
          ("other_k", 340e-6, 350e-6, 460e-6),
          ("solve_k", 700e-6, 720e-6, 650e-6),
          ("lost_k", 730e-6, 740e-6, NAN)]


def synthetic_run():
    summary = trace_lib.summarize(DEVICE, [(ANCHOR, 0.0, 0.0)], {}, 1e-3, 2)
    return SimpleNamespace(summary=summary), spans.place(TRACER, ANCHOR,
                                                         HOST_ANCHOR)


def test_the_anchor_places_the_spans_of_its_profile():
    _, got = synthetic_run()
    assert set(got) == {"engine.solve", "engine.censor", "engine.step",
                        "dynamic.graph_draw", "topology.rebuild",
                        "engine.make_step"}
    np.testing.assert_allclose(got["engine.solve"],
                               [[100e-6, 200e-6], [600e-6, 700e-6]])
    np.testing.assert_allclose(got["engine.step"],
                               [[50e-6, 500e-6], [550e-6, 800e-6]])
    assert spans.place(TRACER, ANCHOR, None) is None
    assert spans.place(TRACER[2:], ANCHOR, HOST_ANCHOR) is None


def test_the_span_reduction(monkeypatch):
    run, got = synthetic_run()
    monkeypatch.setattr(spans, "program_spans", lambda r: got)
    s = run.summary
    # launched inside: 110 and 190 us (first solve), 650 (second)
    assert spans.device_s_inside(s, got["engine.solve"]) == pytest.approx(
        160e-6)
    assert spans.device_ms_per_iter(run, "engine.solve") == pytest.approx(
        0.08)
    assert spans.device_ms_per_iter(run, "engine.censor") == pytest.approx(
        0.01)
    assert spans.device_ms_per_iter(run, "engine.dual") is None
    assert spans.host_ms_per_iter(run, "engine.solve") == pytest.approx(0.1)
    # launched inside the steps [50, 500] and [550, 800] us: 110, 190, 320,
    # 460 and 650 us (the unknown launch not counted), over 2 iterations
    assert spans.launches_per_iter(run) == 2.5
    # the draw, the rebuild and the step built: [810, 900] us, one rebuild
    assert spans.redraw_ms(run) == pytest.approx(0.09)
    device = [(lo, hi) for _, lo, hi, _ in DEVICE]
    # the solves [100, 200] and [600, 700] us: idle 100-150 and all of the
    # second
    assert spans.idle_s_inside(device, got["engine.solve"]) == \
        pytest.approx(150e-6)
    # gaps 250-260 (the first step), 300-310 and 330-340 (the censor),
    # 350-700 (its middle between the steps), 720-730 (the second step)
    by_span = dict(spans.idle_by_span(device, got))
    assert by_span == {spans.NO_SPAN: pytest.approx(350e-6),
                       "engine.censor": pytest.approx(20e-6),
                       "engine.step": pytest.approx(20e-6)}
    assert spans.idle_by_span(device, {}) == [
        [spans.NO_SPAN, pytest.approx(390e-6)]]


def test_the_lm_solve_reader(monkeypatch):
    """``solve_host_ms.lm``: host ms inside the ``engine.solve`` spans a
    traced step; nothing without the spans."""
    run, got = synthetic_run()
    read = bench.reader("solve_host_ms.lm")
    monkeypatch.setattr(spans, "program_spans", lambda r: got)
    # the solves [100, 200] and [600, 700] us over 2 steps
    assert read(run) == pytest.approx(0.1)
    monkeypatch.setattr(spans, "program_spans", lambda r: None)
    assert read(run) is None


def test_the_anchor_leaves_the_existing_breakdown_as_it_was():
    """The anchor is one more host event before the stretch's first device
    event: the profiler's breakdown and the existing readers read the
    same with it as without it."""
    host = [("aten::linalg_solve", 100e-6, 300e-6),
            ("cudaFree", 300e-6, 700e-6)]
    plain = trace_lib.summarize(DEVICE, host, {}, 1e-3, 2)
    anchored = trace_lib.summarize(DEVICE, [(ANCHOR, 0.0, 50e-6)] + host,
                                   {}, 1e-3, 2)
    assert anchored.breakdown == plain.breakdown
    assert anchored.busy_s == plain.busy_s
    for name in ("idle_pct.convex", "step_mfu.convex"):
        read = bench.reader(name)
        work = {"n": 8, "d": 32}
        assert read(SimpleNamespace(summary=anchored, work=work)) == read(
            SimpleNamespace(summary=plain, work=work)), name


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_rehearsal_places_each_span_around_its_ops(
        cell, monkeypatch):
    """The traced path of the cell on the CPU (the profiler's CPU events
    only; the device synchronisations made no-ops): each ``engine.solve``
    span holds one ``solve.apply`` and, on a phase's first solve of a graph
    (twice in the dynamic cell's stretch, which holds a redraw; never in
    the dense cell's, factored in set-up), one ``solve.factor``; every
    ``aten::linalg_lu_factor_ex`` lies inside a ``solve.factor`` span,
    within 50 us; and the cell's new readers read (device time 0: no
    device events)."""
    from repro_torch.obs import trace as obs_trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    obs_trace.disable(save=False)
    result, out, _ = bench.run_cell(cell, SEED, 0.2, True,
                                    torch.device("cpu"), time.perf_counter(),
                                    TINY)
    assert result["correct"]
    run = SimpleNamespace(summary=out["summary"])
    got = spans.program_spans(run)
    solves = got["engine.solve"]
    factors = got.get("solve.factor", np.zeros((0, 2)))
    assert len(got["solve.apply"]) == len(solves) == 2 * out[
        "summary"].iterations
    assert len(factors) == (2 if "dynamic" in cell else 0)
    for lo, hi in np.concatenate([got["solve.apply"], factors]):
        assert sum(b <= lo and hi <= e for b, e in solves) == 1
    lu = out["summary"].host_ops.get("aten::linalg_lu_factor_ex",
                                     np.zeros((0, 2)))
    assert len(lu) == len(factors)
    for lo, hi in lu:
        assert any(b - 50e-6 <= lo and hi <= e + 50e-6 for b, e in factors)
    _, layer = bench.cell_metrics(bench.load_spec(), cell)
    mine = [m["name"] for m in layer if m["name"] in NEW]
    assert len(mine) == (6 if "dynamic" in cell else 5)
    for name in mine:
        assert result["metrics"][name]["value"] >= 0, name
    assert result["metrics"]["solve_host_ms.convex"]["value"] > 0
    if "dynamic" in cell:
        assert len(got["topology.rebuild"]) == 1
        assert result["metrics"]["redraw_ms.convex"]["value"] > 0


def test_the_report_names_the_longest_gaps():
    from perfbench import span_report

    got = {"engine.step": np.array([[0.0, 1.0], [1.5, 2.5]]),
           "engine.solve": np.array([[0.1, 0.9], [1.6, 2.4]]),
           "topology.rebuild": np.array([[1.2, 1.3]])}
    device = [(0.0, 0.2), (0.8, 1.0), (1.55, 1.7), (2.3, 2.45)]
    assert span_report.longest_gaps(device, got, 2) == [
        [pytest.approx(0.6), "engine.solve", 0, 0],
        [pytest.approx(0.6), "engine.solve", 1, 1]]
    assert span_report.longest_gaps(device, got)[2] == [
        pytest.approx(0.55), "topology.rebuild", None, 1]
