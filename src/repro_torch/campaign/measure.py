"""Shared timing discipline: the port of ``repro.campaign.measure``.

The warm-up call is always synchronized before the first timed repeat
(otherwise the card's asynchronous queue lets the warm-up overlap, and
inflate, the first measurement), and every timed repeat ends with a
synchronization of the devices its outputs live on. On the CPU PyTorch
runs synchronously and nothing is waited for. Wall times are read on the
host clock around those waits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch


def _devices(out: Any, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _devices(getattr(out, f.name), found)
    return found


def block_until_ready(out: Any) -> Any:
    """Wait for the card(s) that hold any tensor in ``out`` (a tensor or a
    nest of dicts, sequences and dataclasses); returns ``out``."""
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_run(fn: Callable[[], object], repeats: int = 5) -> float:
    """Best-of-``repeats`` wall seconds of ``fn()`` after a synchronized
    warm-up."""
    block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def time_per_call(fn: Callable, *args, reps: int = 3) -> Tuple[float, object]:
    """Mean microseconds per ``fn(*args)`` call after a synchronized
    warm-up, plus the last output (for parity checks). The calls are
    queued back to back and waited for once, at the end."""
    block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args)
    block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e6, out


def interleaved_median(fns: Iterable[Callable[[], object]], *,
                       rounds: int = 7, iters: int = 1) -> Tuple[float, ...]:
    """Median-of-``rounds`` per-call wall seconds for several callables,
    timed in interleaved rounds (A B A B ...) rather than arm by arm, so
    every arm sits inside every load window of a shared host. Each fn is
    warmed with a synchronized call before any timing starts."""
    fns = list(fns)
    for fn in fns:
        block_until_ready(fn())
    times = [[] for _ in fns]
    for _ in range(rounds):
        for j, fn in enumerate(fns):
            out = None
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            block_until_ready(out)
            times[j].append((time.perf_counter() - t0) / iters)
    return tuple(float(np.median(t)) for t in times)


def percentiles(seconds: Iterable[float]) -> Dict[str, float]:
    """p50/p99 latency summary in milliseconds."""
    arr = np.asarray(list(seconds), np.float64) * 1e3
    return {"p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "n": int(arr.size)}
