"""CPU tests of the readers of the factored local solve's spans
(``solve_factors_per_iter.convex``, ``solve_apply_ms.convex``) on synthetic
spans and device events, as ``test_perfbench_spans.py`` tests the others,
and on a traced rehearsal of each convex cell.

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

FACTORS = "solve_factors_per_iter.convex"
APPLY = "solve_apply_ms.convex"
CELLS = ("epsilon-linreg.dense", "epsilon-linreg.dynamic-sparse")
TINY = {"workers": 8, "rows_per_worker": 40, "n_features": 32}
SEED = 2 ** 31 + 54321
ITERS = 4
# (name, start, end, launched at), in s of the profiler's time base
DEVICE = [("getrf_k", 110e-6, 160e-6, 105e-6),     # in solve.factor
          ("trsm_k", 170e-6, 190e-6, 165e-6),     # in solve.apply
          ("trsm_k", 195e-6, 215e-6, 175e-6),     # in solve.apply
          ("put_k", 220e-6, 225e-6, 181e-6),       # in solve.apply
          ("rhs_k", 230e-6, 240e-6, 186e-6),       # engine.solve only
          ("trsm_k", 700e-6, 720e-6, 610e-6),     # in solve.apply
          ("quant_k", 730e-6, 740e-6, 650e-6)]     # outside the solve


def synthetic_run(got):
    summary = trace_lib.summarize(DEVICE, [], {}, 1e-3, ITERS)
    return SimpleNamespace(summary=summary), got


def placed(factors: int):
    """Spans of ``ITERS`` iterations: ``engine.solve`` holding ``factors``
    ``solve.factor`` spans and two ``solve.apply`` spans."""
    got = {"engine.step": np.array([[0.0, 500e-6], [550e-6, 900e-6]]),
           "engine.solve": np.array([[100e-6, 190e-6], [600e-6, 640e-6]]),
           "solve.apply": np.array([[162e-6, 182e-6], [605e-6, 615e-6]])}
    if factors:
        got["solve.factor"] = np.array([[100e-6 + i * 1e-6,
                                         100e-6 + (i + 0.5) * 1e-6]
                                        for i in range(factors)])
    return got


@pytest.mark.parametrize("factors", [0, 1, 2, 8])
def test_factors_per_iteration_count_the_factor_spans(factors, monkeypatch):
    run, got = synthetic_run(placed(factors))
    monkeypatch.setattr(spans, "program_spans", lambda r: got)
    assert bench.reader(FACTORS)(run) == factors / ITERS


def test_factors_per_iteration_need_the_programs_spans(monkeypatch):
    run, _ = synthetic_run({})
    read = bench.reader(FACTORS)
    monkeypatch.setattr(spans, "program_spans", lambda r: None)
    assert read(run) is None
    # spans of a program whose step has no solve span: nothing to count
    monkeypatch.setattr(spans, "program_spans", lambda r: {
        "engine.step": np.array([[0.0, 1e-3]])})
    assert read(run) is None


def test_apply_time_counts_only_the_kernels_launched_inside_the_apply(
        monkeypatch):
    run, got = synthetic_run(placed(1))
    monkeypatch.setattr(spans, "program_spans", lambda r: got)
    # launched at 165, 175 and 181 us (the first apply) and 610 us (the
    # second): 20 + 20 + 5 + 20 us of device over 4 iterations; the
    # factor's, the right-hand side's and the quantizer's kernels left out
    assert bench.reader(APPLY)(run) == pytest.approx(65e-6 / ITERS * 1e3)
    del got["solve.apply"]
    assert bench.reader(APPLY)(run) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_rehearsal_reads_the_factored_solve(cell, monkeypatch):
    """The traced path of the cell on the CPU (the device synchronisations
    made no-ops): the dense cell factors before the traced stretch and
    reads 0.0 factorizations; the dynamic cell's stretch holds one redraw,
    so one factor a phase. Every ``aten::linalg_solve_triangular`` lies
    inside a ``solve.apply`` span."""
    from repro_torch.obs import trace as obs_trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    obs_trace.disable(save=False)
    result, out, _ = bench.run_cell(cell, SEED, 0.2, True,
                                    torch.device("cpu"), time.perf_counter(),
                                    TINY)
    assert result["correct"]
    summary = out["summary"]
    iters = summary.iterations
    factors = result["metrics"][FACTORS]["value"]
    assert factors == (2 / iters if "dynamic" in cell else 0.0)
    assert result["metrics"][APPLY]["value"] >= 0
    assert "aten::linalg_solve" not in summary.host_ops
    got = spans.program_spans(SimpleNamespace(summary=summary))
    applies = got["solve.apply"]
    assert len(applies) == 2 * iters
    # each apply: the unit lower then the upper triangular solve
    solves = summary.host_ops["aten::linalg_solve_triangular"]
    assert len(solves) == 4 * iters
    for lo, hi in solves:
        assert any(b - 50e-6 <= lo and hi <= e + 50e-6 for b, e in applies)
