"""Validate and summarize a Chrome-trace file of the port (``--trace``):
the port of ``tools/trace_report.py``, which cannot run where the card is
(it imports ``repro.obs.trace``, and the JAX package's ``obs`` loads jax).

Usage:
    PYTHONPATH=src python -m repro_torch.obs.report TRACE.json \
        [--json] [--require KIND:NAME ...]

Validates the schema (valid JSON, required ``ph``/``ts``/``pid``/``tid``
keys, balanced and nested B/E spans, via
``repro_torch.obs.trace.validate_events``), then prints per-span-name
duration percentiles (p50/p99 ms), instant-event counts, and the final
value of every counter track (the engine ledger's cumulative
rounds/bits/energy land here). ``--require span:run instant:retry
counter:ledger`` asserts that specific instrumentation fired. Exits
non-zero on any validation or requirement failure.

Read the ``kernel_dispatch`` counter (``obs.metrics``) with this in mind:
the port bumps it on every wrapper call, the JAX package once per compiled
trace (ROADMAP.md C15), so a port run's totals are calls and a JAX run's
are compilations.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.obs.trace import validate_events


def summarize(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Aggregate a validated trace doc into a JSON-friendly summary."""
    events = doc["traceEvents"]
    pid_names: Dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev.get("args", {}).get("name", str(ev["pid"]))

    durations: Dict[str, List[float]] = defaultdict(list)
    instants: Dict[str, int] = defaultdict(int)
    counters: Dict[str, Dict[str, float]] = {}
    open_spans: Dict[Tuple[Any, Any], List[Tuple[str, float]]] = defaultdict(list)
    n_by_phase: Dict[str, int] = defaultdict(int)

    for ev in events:
        ph = ev["ph"]
        n_by_phase[ph] += 1
        key = (ev["pid"], ev["tid"])
        sub = pid_names.get(ev["pid"], str(ev["pid"]))
        if ph == "B":
            open_spans[key].append((ev.get("name", "?"), ev["ts"]))
        elif ph == "E":
            name, t0 = open_spans[key].pop()
            durations[f"{sub}/{name}"].append((ev["ts"] - t0) / 1e3)  # ms
        elif ph == "i":
            instants[f"{sub}/{ev.get('name', '?')}"] += 1
        elif ph == "C":
            counters[f"{sub}/{ev.get('name', '?')}"] = ev.get("args", {})

    spans = {
        name: {
            "n": len(ds),
            "p50_ms": float(np.percentile(ds, 50)),
            "p99_ms": float(np.percentile(ds, 99)),
            "total_ms": float(np.sum(ds)),
        }
        for name, ds in sorted(durations.items())
    }
    return {
        "events": int(sum(n_by_phase.values())),
        "by_phase": dict(sorted(n_by_phase.items())),
        "spans": spans,
        "instants": dict(sorted(instants.items())),
        "counters_final": dict(sorted(counters.items())),
    }


def check_requirements(summary: Dict[str, Any], requires: List[str]) -> List[str]:
    """Each requirement is ``span:NAME``, ``instant:NAME``, or
    ``counter:NAME`` — NAME matches the part after the subsystem prefix."""
    failures = []
    pools = {"span": summary["spans"], "instant": summary["instants"],
             "counter": summary["counters_final"]}
    for req in requires:
        kind, _, name = req.partition(":")
        pool = pools.get(kind)
        if pool is None:
            failures.append(f"unknown requirement kind {kind!r} in {req!r}")
            continue
        if not any(k.split("/", 1)[-1] == name for k in pool):
            failures.append(f"required {kind} {name!r} not found in trace")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="path to a REPRO_TRACE JSON file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the summary as JSON")
    ap.add_argument("--require", nargs="*", default=[],
                    help="assert presence, e.g. span:request instant:preempt")
    args = ap.parse_args(argv)

    try:
        with open(args.trace) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"report: cannot load {args.trace}: {e}", file=sys.stderr)
        return 1

    errors = validate_events(doc)
    if errors:
        for e in errors:
            print(f"report: INVALID: {e}", file=sys.stderr)
        return 1

    summary = summarize(doc)
    failures = check_requirements(summary, args.require)

    if args.as_json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(f"{args.trace}: {summary['events']} events "
              f"{summary['by_phase']}")
        if summary["spans"]:
            print("spans (p50/p99 ms):")
            for name, s in summary["spans"].items():
                print(f"  {name:<40} n={s['n']:<6} "
                      f"p50={s['p50_ms']:.3f} p99={s['p99_ms']:.3f}")
        if summary["instants"]:
            print("instants:")
            for name, n in summary["instants"].items():
                print(f"  {name:<40} n={n}")
        if summary["counters_final"]:
            print("counters (final):")
            for name, vals in summary["counters_final"].items():
                flat = " ".join(f"{k}={v:.6g}" for k, v in vals.items())
                print(f"  {name:<40} {flat}")

    for fail in failures:
        print(f"report: FAIL: {fail}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
