"""The traced part of a run: torch.profiler over a steady stretch of the
window, reduced to what the per-layer readers and the result line take.

The profiler's raw events are read (``kineto_results``), not its event
tree: building the tree of one convex iteration, ~13,500 device events of
the batched LU, took 79 s on the card. From the device events: the busy
time (the union of their intervals), each kernel's recorded instances and
summed time, the start of the host op that launched each (the host op whose
correlation id it carries; ``spans.py`` lays the program's spans over these
launches), and the longest idle gaps, each named by the innermost host
event running at its middle. The
program's launch counters (``ops.launches``) over the same stretch are set
beside the profiler's instance counts; a kernel the profiler recorded fewer
times than it was launched is reported on standard error, and its time per
call is taken over the recorded instances only.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# the program's kernel names (the functions its CUDA sources launch), by
# the launch counter of the entry point that launches them
KERNEL_NAMES = {
    "stoch_quantize": ("stoch_quantize_kernel",),
    "bipartite_mix": ("mix_wide_kernel", "mix_tiled_kernel"),
    "edge_gather_mix": ("edge_gather_staged_kernel",
                        "edge_gather_gather_kernel"),
    "stoch_quantize_grouped_fused": ("grouped_fused_kernel",),
}
TOP = 10
NAMED_GAPS = 200

# (name, start s, end s) of a host event; a device event adds the start
# of the host op that launched it (nan where unknown)
HostEvent = Tuple[str, float, float]
DeviceEvent = Tuple[str, float, float, float]


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # wall time of the traced stretch
    busy_s: float                        # union of device intervals
    iterations: int                      # iterations traced
    kernels: Dict[str, Tuple[int, float]]  # device event -> (count, s)
    launches: Dict[str, int]             # ops.launches over the stretch
    breakdown: dict
    launched_at: np.ndarray              # per device event
    durations: np.ndarray                # per device event, s
    host_ops: Dict[str, np.ndarray]      # host op name -> (k, 2) intervals

    def kernel(self, launch_key: str) -> Optional[Tuple[int, float]]:
        """Recorded instances and summed seconds of one entry point's
        kernels; None where the profiler recorded none."""
        names = KERNEL_NAMES[launch_key]
        hits = [v for k, v in self.kernels.items()
                if any(n in k for n in names)]
        if not hits:
            return None
        return sum(c for c, _ in hits), sum(t for _, t in hits)


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def idle_gaps(device: Sequence[Tuple[float, float]],
              host: Sequence[HostEvent]) -> List[list]:
    """The ``NAMED_GAPS`` longest gaps between device activity, each named
    by the innermost host event spanning its middle, summed by name: the
    ``TOP`` largest sums."""
    merged: List[list] = []
    for lo, hi in sorted(device):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged,
                                                           merged[1:])),
                  reverse=True)[:NAMED_GAPS]
    names = [h[0] for h in host]
    lo = np.array([h[1] for h in host], dtype=np.float64)
    hi = np.array([h[2] for h in host], dtype=np.float64)
    by_name: Dict[str, float] = {}
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        around = np.nonzero((lo <= mid) & (hi >= mid))[0]
        name = (names[around[np.argmin((hi - lo)[around])]] if around.size
                else "(no host event)")
        by_name[name] = by_name.get(name, 0.0) + length
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])
            ][:TOP]


def summarize(device: Sequence[DeviceEvent], host: Sequence[HostEvent],
              launches: Dict[str, int], window_s: float,
              iterations: int) -> TraceSummary:
    kernels: Dict[str, Tuple[int, float]] = {}
    for name, lo, hi, _ in device:
        n, t = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, t + (hi - lo))
    ops = sorted(((k, v[1]) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])
    spans = [(lo, hi) for _, lo, hi, _ in device]
    host_ops: Dict[str, list] = {}
    for name, lo, hi in host:
        host_ops.setdefault(name, []).append((lo, hi))
    return TraceSummary(
        window_s, union_length(spans), iterations, kernels, launches,
        {"device_ops": [[k, v] for k, v in ops[:TOP]],
         "idle_gaps": idle_gaps(spans, host)},
        np.array([e[3] for e in device], dtype=np.float64),
        np.array([hi - lo for _, lo, hi, _ in device], dtype=np.float64),
        {k: np.array(v) for k, v in host_ops.items()})


def missed_launches(summary: TraceSummary) -> List[str]:
    """Kernels the profiler recorded another number of times than the
    program launched them over the traced stretch."""
    out = []
    for key, launched in summary.launches.items():
        if not launched or key not in KERNEL_NAMES:
            continue
        got = summary.kernel(key)
        recorded = got[0] if got else 0
        if recorded != launched:
            out.append(f"{key}: profiler recorded {recorded} of {launched} "
                       f"launches")
    return out


def traced(iteration: Callable[[], None], iterations: int,
           launches: Callable[[], Dict[str, int]]) -> TraceSummary:
    """Run ``iteration`` ``iterations`` times under the profiler, from a
    synchronised device to a synchronised device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = dict(launches())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iterations):
            iteration()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    after = launches()
    counted = {k: after[k] - before.get(k, 0) for k in after}
    t_read = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    op_start = {}
    host: List[HostEvent] = []
    device_raw = []
    # seconds from the first event: absolute nanoseconds as float64
    # seconds would keep only about 0.2 us
    base = min((e.start_ns() for e in raw), default=0)
    for e in raw:
        lo, hi = (e.start_ns() - base) * 1e-9, (e.end_ns() - base) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            device_raw.append((e.name(), lo, hi, e.linked_correlation_id()))
        else:
            host.append((e.name(), lo, hi))
            if e.correlation_id():
                op_start[e.correlation_id()] = lo
    device = [(name, lo, hi, op_start.get(cid, float("nan")))
              for name, lo, hi, cid in device_raw]
    summary = summarize(device, host, counted, window_s, iterations)
    print(f"[perfbench] traced {iterations} iterations: {len(device)} device "
          f"and {len(host)} host events, read in "
          f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    for line in missed_launches(summary):
        print(f"[perfbench] {line}", file=sys.stderr)
    return summary
