"""Chrome-trace / Perfetto event tracer (a copy of ``repro.obs.trace``
with the profiler's clock and the engine's spans added, standard library
only; ``tests/test_torch_obs.py`` holds its event lists to the
original's).

One global tracer, enabled either by ``REPRO_TRACE=<path>`` in the
environment (checked once at import) or programmatically via
:func:`enable` (the ``--trace`` flags on the launch/bench drivers call
this). When disabled, :func:`tracer` returns ``None`` and every
instrumentation site is a single attribute load plus an ``is None``
test — nothing is allocated, formatted, or written (and nothing is
copied from the card or synchronised); the engine's sites add one read of
the profiler's flag (:func:`span_tracer`).

Track layout: each subsystem ("serving", "engine", "fleet")
is a trace *process* (pid); named tracks within it — one per serving
request rid, one per fleet worker, one per campaign run — are *threads*
(tid) allocated lazily by :meth:`Tracer.track`. Events follow the Chrome
Trace Event format: ``ph`` is ``B``/``E`` (span begin/end), ``i``
(instant), ``C`` (counter), or ``M`` (metadata). The written file is
``{"traceEvents": [...]}`` and loads directly in Perfetto /
chrome://tracing.

One clock with torch.profiler: ``ts`` is microseconds of the Unix epoch
(kineto's ``start_ns()``) counted from ``Tracer.base_ns``, the start of
the current 7,889,238-second interval, as a profiler export counts them;
the written file names that base under ``baseTimeNanoseconds``, as the
export does, so the two open on one timeline. The epoch is read once,
beside ``perf_counter_ns``, when the tracer is built; later stamps are
``perf_counter_ns`` plus that offset, so spans stay monotonic. A tracer
built without a path keeps its events in memory and writes nothing.

The engine's layer spans (``core/engine.py``, ``core/topology.py``,
``core/dynamic.py``) ask :func:`span_tracer`: the enabled tracer, or,
while a torch.profiler profile records and none is enabled, an in-memory
tracer of that profile (:func:`last_profile` hands it back after). A
profile's tracer starts with :data:`PROFILE_ANCHOR`, one
``record_function`` of that name inside a tracer span of that name, so
that a reader of the profiler's events can place the spans on their time
base.

Spans on one track must nest (validated by :func:`validate_events`);
:meth:`Tracer.save` synthesizes ``E`` events for still-open spans in the
*written* file only, so mid-run saves stay balanced without corrupting
the live state.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

ENV_VAR = "REPRO_TRACE"
# a profiler export's time base: libkineto's ChromeTraceBaseTime floors the
# epoch to intervals of this many seconds
BASE_INTERVAL_S = 7889238
# the engine's layer spans: one track of one subsystem
STEP_TRACK = ("engine", "step")
PROFILE_ANCHOR = "repro.profile_anchor"

_PHASES = ("B", "E", "i", "C", "M")


class Tracer:
    """Buffering span/instant/counter recorder for one trace file, or in
    memory only (``path`` None)."""

    def __init__(self, path: Optional[str]):
        self.path = None if path is None else str(path)
        epoch_offset = time.time_ns() - time.perf_counter_ns()
        now_s = (time.perf_counter_ns() + epoch_offset) // 10 ** 9
        self.base_ns = now_s // BASE_INTERVAL_S * BASE_INTERVAL_S * 10 ** 9
        # perf_counter_ns at base_ns
        self._zero_ns = self.base_ns - epoch_offset
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._tracks: Dict[Tuple[int, str], int] = {}
        self._next_tid: Dict[int, int] = {}
        # (pid, tid) -> stack of open span names, for save-time closing.
        self._open: Dict[Tuple[int, int], List[str]] = {}

    # -- time / identity ------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._zero_ns) / 1e3

    def _pid(self, subsystem: str) -> int:
        pid = self._pids.get(subsystem)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[subsystem] = pid
            self._events.append(
                {"name": "process_name", "ph": "M", "ts": self._now_us(),
                 "pid": pid, "tid": 0, "args": {"name": subsystem}}
            )
        return pid

    def track(self, subsystem: str, name: str) -> int:
        """Return the tid for a named track under ``subsystem``, creating it
        (with a ``thread_name`` metadata event) on first use."""
        with self._lock:
            pid = self._pid(subsystem)
            key = (pid, name)
            tid = self._tracks.get(key)
            if tid is None:
                tid = self._next_tid.get(pid, 1)
                self._next_tid[pid] = tid + 1
                self._tracks[key] = tid
                self._events.append(
                    {"name": "thread_name", "ph": "M", "ts": self._now_us(),
                     "pid": pid, "tid": tid, "args": {"name": name}}
                )
            return tid

    # -- events ---------------------------------------------------------
    def begin(self, name: str, subsystem: str, tid: int = 0,
              args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            pid = self._pid(subsystem)
            ev: Dict[str, Any] = {"name": name, "cat": subsystem, "ph": "B",
                                  "ts": self._now_us(), "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            self._events.append(ev)
            self._open.setdefault((pid, tid), []).append(name)

    def end(self, subsystem: str, tid: int = 0,
            args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            pid = self._pid(subsystem)
            stack = self._open.get((pid, tid))
            if not stack:  # unmatched end: drop rather than corrupt the file
                return
            name = stack.pop()
            ev: Dict[str, Any] = {"name": name, "cat": subsystem, "ph": "E",
                                  "ts": self._now_us(), "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, subsystem: str, tid: int = 0,
             args: Optional[Dict[str, Any]] = None) -> Iterator[None]:
        self.begin(name, subsystem, tid, args)
        try:
            yield
        finally:
            self.end(subsystem, tid)

    def instant(self, name: str, subsystem: str, tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            pid = self._pid(subsystem)
            ev: Dict[str, Any] = {"name": name, "cat": subsystem, "ph": "i",
                                  "ts": self._now_us(), "pid": pid, "tid": tid,
                                  "s": "t"}
            if args:
                ev["args"] = args
            self._events.append(ev)

    def counter(self, name: str, subsystem: str,
                values: Dict[str, Any], tid: int = 0) -> None:
        with self._lock:
            pid = self._pid(subsystem)
            self._events.append(
                {"name": name, "cat": subsystem, "ph": "C",
                 "ts": self._now_us(), "pid": pid, "tid": tid,
                 "args": {k: float(v) for k, v in values.items()}}
            )

    # -- output ---------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """The events recorded so far (a copy of the list)."""
        with self._lock:
            return list(self._events)

    def save(self) -> Optional[str]:
        """Atomically write the trace file; still-open spans get synthetic
        ``E`` events in the written copy only (live stacks are untouched,
        so tracing can continue and a later save stays balanced). An
        in-memory tracer writes nothing and returns None."""
        if self.path is None:
            return None
        with self._lock:
            events = list(self._events)
            ts = self._now_us()
            for (pid, tid), stack in self._open.items():
                for name in reversed(stack):
                    events.append({"name": name, "ph": "E", "ts": ts,
                                   "pid": pid, "tid": tid,
                                   "args": {"truncated": True}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": self.base_ns}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        return self.path


# -- module-global tracer ----------------------------------------------

_tracer: Optional[Tracer] = None


def tracer() -> Optional[Tracer]:
    """The active tracer, or ``None`` when tracing is disabled."""
    return _tracer


# the tracer of the running or the last torch.profiler profile
_profile: Optional[Tracer] = None
_profiling = False


def _profiler_on() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _anchor(tr: Tracer) -> None:
    from torch.autograd.profiler import record_function

    tid = tr.track("trace", "profiler")
    tr.begin(PROFILE_ANCHOR, "trace", tid)
    with record_function(PROFILE_ANCHOR):
        pass
    tr.end("trace", tid)


def span_tracer() -> Optional[Tracer]:
    """The tracer of the engine's layer spans: the enabled tracer, or while
    a torch.profiler profile records and none is enabled, the profile's
    in-memory tracer; ``None`` otherwise. The first call inside a profile
    stamps :data:`PROFILE_ANCHOR` into the tracer it returns."""
    global _profile, _profiling
    on = _profiler_on()
    if on is not _profiling:
        _profiling = on
        if on:
            _profile = _tracer if _tracer is not None else Tracer(None)
            _anchor(_profile)
    if _tracer is not None:
        return _tracer
    return _profile if on else None


def last_profile() -> Optional[Tracer]:
    """The tracer that recorded the engine's spans in the running or the
    last torch.profiler profile (None before any)."""
    return _profile


def begin_step_span(tr: Tracer, name: str, **args: Any) -> None:
    """Open ``name`` on the engine's step track (``STEP_TRACK``)."""
    sub, track = STEP_TRACK
    tr.begin(name, sub, tr.track(sub, track), args=args or None)


def end_step_span(tr: Tracer) -> None:
    """Close the innermost span open on the engine's step track."""
    sub, track = STEP_TRACK
    tr.end(sub, tr.track(sub, track))


def closed_spans(events: List[Dict[str, Any]]
                 ) -> List[Tuple[str, int, int, float, float, Dict]]:
    """``(name, pid, tid, begin ts, end ts, begin args)`` of every closed
    span of ``events``, in the order the spans close."""
    stacks: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    out = []
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev)
        elif ev["ph"] == "E" and stacks.get(key):
            b = stacks[key].pop()
            out.append((b["name"], key[0], key[1], b["ts"], ev["ts"],
                        b.get("args", {})))
    return out


def enabled() -> bool:
    return _tracer is not None


def enable(path: str) -> Tracer:
    global _tracer
    _tracer = Tracer(path)
    return _tracer


def disable(save: bool = True) -> None:
    global _tracer
    if _tracer is not None and save:
        _tracer.save()
    _tracer = None


def save() -> Optional[str]:
    return _tracer.save() if _tracer is not None else None


@atexit.register
def _atexit_save() -> None:
    if _tracer is not None:
        try:
            _tracer.save()
        except OSError:
            pass


if os.environ.get(ENV_VAR):
    enable(os.environ[ENV_VAR])


# -- validation (shared by the tests and chip_smoke.py) -----------------

def validate_events(doc: Any) -> List[str]:
    """Return a list of schema violations (empty == valid).

    Checks the Chrome-trace contract the rest of the repo relies on:
    a ``traceEvents`` list; every event carries ``ph``/``ts``/``pid``/
    ``tid``; phases are known; B/E spans are balanced and properly nested
    per (pid, tid) track; counter args are numeric.
    """
    errors: List[str] = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["top level must be an object with a 'traceEvents' list"]
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in ("ph", "ts", "pid", "tid") if k not in ev]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(str(ev.get("name")))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: 'E' with no open span on track {key}")
            else:
                opened = stack.pop()
                name = ev.get("name")
                if name is not None and name != opened:
                    errors.append(
                        f"event {i}: 'E' for {name!r} but {opened!r} is open"
                    )
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                errors.append(f"event {i}: counter args must be numeric")
    for key, stack in stacks.items():
        if stack:
            errors.append(f"track {key}: unclosed spans {stack}")
    return errors
