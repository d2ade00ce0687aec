"""Typed metrics registry: labeled counters, gauges, and fixed-bucket
histograms with atomic snapshot/delta export (a copy of
``repro.obs.metrics``, numpy only; ``tests/test_torch_serving_load.py``
holds it to the original).

Design constraints, in order:

* **Bounded memory.** Every metric has a hard cap: histograms keep a
  fixed bucket array plus a bounded raw-sample window (``deque(maxlen)``),
  label cardinality is capped per metric (oldest series evicted FIFO),
  and :class:`BoundedDict` is the one shared home for the scheduler's
  per-request latency maps.
* **Exact-percentile compatibility.** Percentiles are computed from raw
  latency samples; :class:`Histogram` therefore supports
  ``len()``/iteration over its raw window with the same semantics as a
  ``deque(maxlen=...)``, so reported percentiles are those of the retained
  samples. The fixed buckets ride along for export.
* **Determinism.** :meth:`Registry.snapshot` sorts metric and series keys,
  so two registries fed the same observation sequence serialize to
  identical JSON.

Metrics are host-side: callers observe floats the device already
returned.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

# Prometheus-style latency buckets, in seconds; +Inf is implicit.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
DEFAULT_MAX_SERIES = 4096


def _label_key(declared: Tuple[str, ...], labels: Dict[str, Any]) -> str:
    if set(labels) != set(declared):
        raise ValueError(f"expected labels {declared}, got {tuple(labels)}")
    return ",".join(str(labels[k]) for k in declared)


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: Tuple[str, ...] = (),
                 help: str = "", max_series: int = DEFAULT_MAX_SERIES):
        self.name = name
        self.label_names = tuple(labels)
        self.help = help
        self.max_series = int(max_series)
        self._series: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def _slot(self, labels: Dict[str, Any], default) -> Any:
        key = _label_key(self.label_names, labels)
        if key not in self._series:
            while len(self._series) >= self.max_series:
                self._series.popitem(last=False)
            self._series[key] = default()
        return key

    def series(self) -> Dict[str, Any]:
        with self._lock:
            return {k: self._export(v) for k, v in sorted(self._series.items())}

    def _export(self, value: Any) -> Any:
        return value


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels: Any) -> None:
        with self._lock:
            key = self._slot(labels, lambda: 0.0)
            self._series[key] += n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(_label_key(self.label_names, labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            key = self._slot(labels, lambda: 0.0)
            self._series[key] = float(v)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(_label_key(self.label_names, labels), 0.0))


class Histogram:
    """Fixed-bucket histogram plus a bounded window of raw samples.

    The raw window (``deque(maxlen=window)``) makes this a drop-in
    replacement for the scheduler's bounded latency deques: ``len(h)``,
    ``iter(h)``, and ``list(h)[k:]`` all see exactly the retained raw
    samples, so downstream percentile math is unchanged. ``observe`` also
    bins into ``buckets`` (upper bounds, +Inf implicit) for export.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                 window: int = 4096, help: str = ""):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._window: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            idx = int(np.searchsorted(self.buckets, v, side="left"))
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            self._window.append(v)

    # deque-compatible surface for the bench percentile paths.
    def __len__(self) -> int:
        return len(self._window)

    def __iter__(self) -> Iterator[float]:
        return iter(list(self._window))

    def percentile(self, p: float) -> float:
        """Exact percentile over the retained raw window (NaN when empty)."""
        with self._lock:
            vals = list(self._window)
        return float(np.percentile(vals, p)) if vals else float("nan")

    def series(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "buckets": list(self.buckets),
                "bucket_counts": list(self.counts),
                "window_len": len(self._window),
            }


class BoundedDict:
    """Insertion-ordered mapping that evicts its oldest entry past
    ``maxsize`` — the shared home for the scheduler's per-rid TTFT maps
    (formerly three inline ``while len > N: pop(next(iter(...)))`` loops)."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = int(maxsize)
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def __setitem__(self, k: Any, v: Any) -> None:
        self._d[k] = v
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __getitem__(self, k: Any) -> Any:
        return self._d[k]

    def __contains__(self, k: Any) -> bool:
        return k in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._d)

    def get(self, k: Any, default: Any = None) -> Any:
        return self._d.get(k, default)

    def pop(self, k: Any, *default: Any) -> Any:
        return self._d.pop(k, *default)

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()


class Registry:
    """Named metric registry with atomic snapshot/delta export.

    Re-registering a name returns the existing metric when kind and
    labels match, and raises otherwise — instrumentation sites can
    declare their metrics idempotently at call time.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, **kw: Any):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {existing.kind}"
                    )
                want = tuple(kw.get("labels", ()))
                if isinstance(existing, _Metric) and existing.label_names != want:
                    raise TypeError(
                        f"metric {name!r} labels {existing.label_names} != {want}"
                    )
                return existing
            metric = cls(name, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, labels: Tuple[str, ...] = (), help: str = "",
                max_series: int = DEFAULT_MAX_SERIES) -> Counter:
        return self._register(Counter, name, labels=labels, help=help,
                              max_series=max_series)

    def gauge(self, name: str, labels: Tuple[str, ...] = (), help: str = "",
              max_series: int = DEFAULT_MAX_SERIES) -> Gauge:
        return self._register(Gauge, name, labels=labels, help=help,
                              max_series=max_series)

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
                  window: int = 4096, help: str = "") -> Histogram:
        return self._register(Histogram, name, buckets=buckets, window=window,
                              help=help)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time export: ``{name: {"type": ..., "series": {...}}}``,
        keys sorted, plain JSON-serializable types only."""
        with self._lock:
            metrics = dict(self._metrics)
        return {
            name: {"type": m.kind, "series": m.series()}
            for name, m in sorted(metrics.items())
        }

    def delta(self, prev: Dict[str, Any]) -> Dict[str, Any]:
        """Difference of a fresh snapshot against ``prev`` (a snapshot):
        counters and histogram counts are subtracted, gauges pass through
        current values. Metrics absent from ``prev`` diff against zero."""
        cur = self.snapshot()
        out: Dict[str, Any] = {}
        for name, entry in cur.items():
            before = prev.get(name, {}).get("series", {})
            if entry["type"] == "counter":
                out[name] = {
                    "type": "counter",
                    "series": {
                        k: v - before.get(k, 0.0)
                        for k, v in entry["series"].items()
                    },
                }
            elif entry["type"] == "histogram":
                s, b = entry["series"], before
                out[name] = {
                    "type": "histogram",
                    "series": {
                        "count": s["count"] - b.get("count", 0),
                        "sum": s["sum"] - b.get("sum", 0.0),
                        "buckets": s["buckets"],
                        "bucket_counts": [
                            x - y for x, y in zip(
                                s["bucket_counts"],
                                b.get("bucket_counts", [0] * len(s["bucket_counts"])),
                            )
                        ],
                    },
                }
            else:
                out[name] = entry
        return out


#: Process-wide default registry (the kernel-dispatch counter lives here).
REGISTRY = Registry()


def kernel_dispatch_counter() -> Counter:
    """Counter of kernel-wrapper dispatches by (kernel, variant), bumped by
    every ``kernels/ops.py`` wrapper on every call, on the CPU too, with
    the JAX package's labels: which variant a call selected. Whether a
    kernel ran on the card is ``ops.launches``."""
    return REGISTRY.counter(
        "kernel_dispatch", labels=("kernel", "variant"),
        help="ops.py wrapper dispatches by kernel variant")
