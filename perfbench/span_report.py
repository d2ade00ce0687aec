"""One traced run of a cell with the program's spans laid on its profiled
stretch: where each layer's host time, device time and device idle go.

    python3 perfbench/span_report.py --workload epsilon-linreg.dense \\
        --seed 7 --seconds 50 [--out spans.json]

Runs the cell as ``run.py --trace 1`` does and prints its result line, then
one JSON line: for every span name of the stretch its count, host ms, the
device ms of the events launched inside it and the device idle ms while the
host is inside it, each a traced iteration; ``idle_by_span``, every idle
gap of the stretch charged to the innermost span open at its middle
(``spans.idle_by_span``); and the checks of the spans against the
profiler: the device time launched inside ``engine.solve`` and inside all
``engine.*`` spans against the busy time, the gaps' sum against the
stretch's idle time; and the longest gaps, each with its span, iteration
and graph phase. The device intervals the idle
needs are taken from the events ``trace.summarize`` is handed, which the
summary does not keep.
"""
import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as bench  # noqa: E402
from perfbench import spans as spans_lib  # noqa: E402
from perfbench import trace as trace_lib  # noqa: E402


def span_table(summary, device, got) -> dict:
    per = max(summary.iterations, 1)
    table = {}
    for name, ivs in sorted(got.items()):
        table[name] = {
            "count": len(ivs),
            "host_ms": spans_lib.host_s(ivs) / per * 1e3,
            "device_ms": spans_lib.device_s_inside(summary, ivs) / per * 1e3,
            "idle_ms": spans_lib.idle_s_inside(device, ivs) / per * 1e3}
    return table


def longest_gaps(device, got, count: int = 5) -> list:
    """The ``count`` longest idle gaps: seconds, the innermost span at the
    middle, and the traced iteration (0-based ``engine.step``) and graph
    phase (rebuilds before it) it falls in."""
    busy = spans_lib.union(device)
    gaps = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _)
                   in zip(busy, busy[1:])), reverse=True)[:count]
    steps = sorted(got.get("engine.step", np.zeros((0, 2))).tolist())
    rebuilds = got.get("topology.rebuild", np.zeros((0, 2)))[:, 0]
    at = spans_lib.span_at(got)
    return [[length, at(mid),
             next((i for i, (lo, hi) in enumerate(steps) if lo <= mid <= hi),
                  None), int((rebuilds < mid).sum())]
            for length, mid in gaps]


def checks(summary, device, got) -> dict:
    engine = [v for k, v in got.items() if k.startswith("engine.")]
    under_engine = (spans_lib.device_s_inside(summary, np.concatenate(engine))
                    if engine else None)
    gaps = spans_lib.union(device)
    gap_s = sum(b - a for (_, a), (b, _) in zip(gaps, gaps[1:]))
    in_solve = (spans_lib.device_s_inside(summary, got["engine.solve"])
                if "engine.solve" in got else None)
    return {"device_s_in_engine_solve": in_solve,
            "device_s_in_engine_spans": under_engine,
            "busy_s": summary.busy_s, "window_s": summary.window_s,
            "gaps_s": gap_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench.set_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(bench.TORCH_THREADS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kept = {}
    summarize = trace_lib.summarize

    def keeping(device, *rest, **kw):
        kept["device"] = [(lo, hi) for _, lo, hi, _ in device]
        return summarize(device, *rest, **kw)

    trace_lib.summarize = keeping
    result, out, checked = bench.run_cell(args.workload, args.seed,
                                          args.seconds, True, dev, bench.T0)
    line = bench.result_line(result, out, checked,
                             torch.cuda.get_device_name(dev), 1, True)
    print(json.dumps(line), flush=True)
    summary, device = out["summary"], kept["device"]
    got = spans_lib.program_spans(SimpleNamespace(summary=summary))
    if not got:
        print("[span_report] the program recorded no spans", file=sys.stderr)
        return 1
    report = {"workload": args.workload, "seed": args.seed,
              "iterations": summary.iterations,
              "spans": span_table(summary, device, got),
              "idle_by_span": spans_lib.idle_by_span(device, got),
              "longest_gaps": longest_gaps(device, got),
              "checks": checks(summary, device, got)}
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
