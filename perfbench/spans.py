"""The program's layer spans laid on a traced stretch's time base.

While torch.profiler records and no tracer is enabled, the program keeps
the engine's spans (``core/engine.py``, ``core/topology.py``,
``core/dynamic.py``) in an in-memory tracer,
``repro_torch.obs.trace.last_profile()``. Its first event is an anchor: a
tracer span around one ``record_function`` of the same name, which the
profiler records among its host events. The tracer's end of the anchor is
set on the profiler's end of it (the tracer stamps it right after
``record_function`` exits, a few us later), which places every span on the
summary's time base: seconds from the stretch's first event.

A program without the spans (one older than them), or a profile without
the anchor, gives no spans, and each reader built on them returns None.
The readers divide by the traced iterations; the device-side functions
take the summary's launch times (``TraceSummary.launched_at``): a kernel
counts under a span when the host op that launched it started inside it.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from perfbench import trace as trace_lib

NO_SPAN = "(no span)"
TOP = 10
# the spans of a graph redraw: the draw, the backend's rebuild, the step
REDRAW = ("dynamic.graph_draw", "topology.rebuild", "engine.make_step")

Intervals = Dict[str, np.ndarray]       # span name -> (k, 2) seconds


def place(closed: Sequence[tuple], anchor_name: str,
          host_anchor: Optional[np.ndarray]) -> Optional[Intervals]:
    """The closed spans ``(name, pid, tid, begin us, end us, args)`` of a
    tracer from its last anchor on, on the time base of ``host_anchor``:
    the profiler's (k, 2) intervals of the anchor, in seconds."""
    if host_anchor is None or not len(host_anchor):
        return None
    anchors = [s for s in closed if s[0] == anchor_name]
    if not anchors:
        return None
    begin_us, end_us = anchors[-1][3], anchors[-1][4]
    shift_us = end_us - float(host_anchor[-1][1]) * 1e6
    out: Dict[str, list] = {}
    for name, _, _, b, e, _ in closed:
        if name != anchor_name and b >= begin_us:
            out.setdefault(name, []).append(((b - shift_us) * 1e-6,
                                             (e - shift_us) * 1e-6))
    return {k: np.array(v, dtype=np.float64) for k, v in out.items()}


def program_spans(run) -> Optional[Intervals]:
    """The program's spans of the run's traced stretch; None where the
    program records none."""
    try:
        from repro_torch.obs import trace as obs_trace
    except ImportError:
        return None
    last = getattr(obs_trace, "last_profile", None)
    tracer = last() if last is not None else None
    if tracer is None:
        return None
    name = obs_trace.PROFILE_ANCHOR
    return place(obs_trace.closed_spans(tracer.events()), name,
                 run.summary.host_ops.get(name))


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def host_s(intervals: np.ndarray) -> float:
    """Host seconds inside the intervals (their union)."""
    return float(trace_lib.union_length([tuple(iv) for iv in intervals]))


def launched_inside(launched_at: np.ndarray,
                    intervals: np.ndarray) -> np.ndarray:
    """Which device events were launched inside one of the intervals
    (ends included)."""
    inside = np.zeros(launched_at.shape, bool)
    known = ~np.isnan(launched_at)
    t = launched_at[known]
    hit = np.zeros(t.shape, bool)
    for lo, hi in intervals:
        hit |= (t >= lo) & (t <= hi)
    inside[known] = hit
    return inside


def device_s_inside(summary, intervals: np.ndarray) -> float:
    """Device seconds of the events launched inside the intervals."""
    return float(summary.durations[
        launched_inside(summary.launched_at, intervals)].sum())


def idle_s_inside(device: Sequence[Tuple[float, float]],
                  intervals: np.ndarray) -> float:
    """Seconds of the intervals in which no device event ran."""
    busy = union(device)
    idle = 0.0
    for lo, hi in union(map(tuple, intervals)):
        covered = sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in busy
                      if a < hi and b > lo)
        idle += (hi - lo) - covered
    return idle


def span_at(spans: Intervals) -> Callable[[float], str]:
    """A function of a time: the innermost span open at it (the shortest
    that holds it: spans of one track nest), or ``NO_SPAN``."""
    names = [k for k, v in spans.items() for _ in range(len(v))]
    ivs = (np.concatenate(list(spans.values())) if spans
           else np.zeros((0, 2)))

    def at(t: float) -> str:
        around = np.nonzero((ivs[:, 0] <= t) & (ivs[:, 1] >= t))[0]
        if not around.size:
            return NO_SPAN
        return names[around[np.argmin(ivs[around, 1] - ivs[around, 0])]]
    return at


def idle_by_span(device: Sequence[Tuple[float, float]],
                 spans: Intervals) -> List[list]:
    """Every gap between device activity, charged to the span open at its
    middle (``span_at``), summed by name: the ``TOP`` largest sums."""
    busy = union(device)
    at = span_at(spans)
    by_name: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        name = at(0.5 * (a + b))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])][:TOP]


# ---------------------------------------------------------- the readers --
def device_ms_per_iter(run, name: str) -> Optional[float]:
    """Device ms a traced iteration of the events launched inside the
    program's ``name`` spans."""
    got = program_spans(run)
    if not got or name not in got or run.summary.iterations <= 0:
        return None
    return (device_s_inside(run.summary, got[name])
            / run.summary.iterations * 1e3)


def host_ms_per_iter(run, name: str) -> Optional[float]:
    """Host ms a traced iteration inside the program's ``name`` spans."""
    got = program_spans(run)
    if not got or name not in got or run.summary.iterations <= 0:
        return None
    return host_s(got[name]) / run.summary.iterations * 1e3


def launches_per_iter(run) -> Optional[float]:
    """Device events a traced iteration launched inside ``engine.step``."""
    got = program_spans(run)
    if not got or "engine.step" not in got or run.summary.iterations <= 0:
        return None
    inside = launched_inside(run.summary.launched_at, got["engine.step"])
    return float(inside.sum()) / run.summary.iterations


def redraw_ms(run) -> Optional[float]:
    """Host ms a graph redraw: the union of the redraw's spans over the
    count of ``topology.rebuild`` spans; None without a rebuild."""
    got = program_spans(run)
    if not got or "topology.rebuild" not in got:
        return None
    parts = [got[k] for k in REDRAW if k in got]
    return host_s(np.concatenate(parts)) / len(got["topology.rebuild"]) * 1e3
