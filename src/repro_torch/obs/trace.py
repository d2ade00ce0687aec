"""Chrome-trace / Perfetto event tracer (a copy of ``repro.obs.trace``,
standard library only; ``tests/test_torch_obs.py`` holds it to the
original).

One global tracer, enabled either by ``REPRO_TRACE=<path>`` in the
environment (checked once at import) or programmatically via
:func:`enable` (the ``--trace`` flags on the launch/bench drivers call
this). When disabled, :func:`tracer` returns ``None`` and every
instrumentation site is a single attribute load plus an ``is None``
test — nothing is allocated, formatted, or written (and nothing is
copied from the card or synchronised).

Track layout: each subsystem ("serving", "engine", "fleet")
is a trace *process* (pid); named tracks within it — one per serving
request rid, one per fleet worker, one per campaign run — are *threads*
(tid) allocated lazily by :meth:`Tracer.track`. Events follow the Chrome
Trace Event format: ``ph`` is ``B``/``E`` (span begin/end), ``i``
(instant), ``C`` (counter), or ``M`` (metadata); ``ts`` is microseconds
from tracer start. The written file is ``{"traceEvents": [...]}`` and
loads directly in Perfetto / chrome://tracing.

Spans on one track must nest (validated by :func:`validate_events`);
:meth:`Tracer.save` synthesizes ``E`` events for still-open spans in the
*written* file only, so mid-run saves stay balanced without corrupting
the live state.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

ENV_VAR = "REPRO_TRACE"

_PHASES = ("B", "E", "i", "C", "M")


class Tracer:
    """Buffering span/instant/counter recorder for one trace file."""

    def __init__(self, path: str):
        self.path = str(path)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._tracks: Dict[Tuple[int, str], int] = {}
        self._next_tid: Dict[int, int] = {}
        # (pid, tid) -> stack of open span names, for save-time closing.
        self._open: Dict[Tuple[int, int], List[str]] = {}

    # -- time / identity ------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

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
    def save(self) -> str:
        """Atomically write the trace file; still-open spans get synthetic
        ``E`` events in the written copy only (live stacks are untouched,
        so tracing can continue and a later save stays balanced)."""
        with self._lock:
            events = list(self._events)
            ts = self._now_us()
            for (pid, tid), stack in self._open.items():
                for name in reversed(stack):
                    events.append({"name": name, "ph": "E", "ts": ts,
                                   "pid": pid, "tid": tid,
                                   "args": {"truncated": True}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
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
