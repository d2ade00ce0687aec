"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 perfbench/run.py --workload epsilon-linreg.dense --seed 7 \\
        --seconds 45 --trace 0

``BENCHMARK.json`` at the root of the checkout names the cells. A cell is
``<config>.<traffic>``: its configuration is ``perfbench/configs/<config>.json``
and its traffic mix ``perfbench/traffic/<traffic>.json``, whose ``driver``
names the loop in ``perfbench/drivers/``. Each per-layer metric is read by
``perfbench/metrics/<metric>.py`` (``read(run) -> float or None``). Adding a
configuration, a mix or a metric adds files and entries; no file here names
them.

With ``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window. Every run judges what its set-up iterations and a few window
iterations drawn from the seed produced, against the plain reference
(``perfbench/reference/``), after the window. The numbers compared, each
beside its limit, are the last lines on standard error and the last key of
the result, which is the last line on standard output.

Exit codes: 0 with a result; 2 for an unknown cell; 3 without the CUDA
cards the cell asks for; 4 where the JAX package or JAX was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
CACHE = ROOT / "build" / "perfbench_cache"
# top-level module names that may not be loaded (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TORCH_THREADS = 2


def set_environment() -> None:
    """Kernel caches at fixed paths inside the checkout; nothing loads
    JAX on the program's behalf."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(name)


def cell_metrics(spec: dict, workload: str):
    """The cell's end-to-end metrics and the per-layer metrics it reports:
    those that list it, and those without a list that move one of its
    end-to-end metrics."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides=None, fault=None):
    """One run of a cell: the result's dict (without ``device``) and the
    numbers compared as (name, value, limit)."""
    spec = load_spec()
    wl = find(spec["workloads"], workload)
    cfg_entry = find(spec["configs"], wl["config"])
    cfg = load_json(ROOT / cfg_entry["file"])
    cfg.update(overrides or {})
    mix = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    out = driver.run(cfg, mix, seed, seconds, trace, device, fault)
    # a mix may add limits of its own (a fleet's) to the configuration's
    limits = dict(cfg["limits"], **mix.get("limits", {}))
    checks = [(k, float(out["readings"][k]), float(limits[k]))
              for k in limits]
    correct = all(v <= lim for _, v, lim in checks)
    failed = sum(1 for r in out["per_iteration"]
                 if any(not (r[k] <= limits[k]) for k in limits))
    e2e, layer = cell_metrics(spec, workload)
    metrics = {}
    if not trace:
        values = {mix["rate_metric"]: out["done"] / out["window_s"],
                  "setup_s": out["setup_end"] - t_start}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    else:
        run = SimpleNamespace(summary=out["summary"], work=out["work"],
                              peak_bytes=out["peak_bytes"])
        for m in layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct and math.isfinite(
                  sum(v for _, v, _ in checks))),
              "attempted": out["attempted"], "failed": failed,
              "metrics": metrics}
    return result, out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    spec = load_spec()
    try:
        wl = find(spec["workloads"], args.workload)
    except KeyError:
        print(f"[perfbench] no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < wl["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[perfbench] {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(TORCH_THREADS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, out, checks = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), dev, T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"[perfbench] loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    line = result_line(result, out, checks, torch.cuda.get_device_name(dev),
                       wl["chips"], bool(args.trace))
    for k, v, lim in checks:
        print(f"[perfbench] check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(result: dict, out: dict, checks, kind: str, count: int,
                trace: bool) -> dict:
    """The last line: the run's result, the device, with ``--trace 1`` the
    breakdown, and last the numbers compared beside their limits."""
    line = dict(result)
    line["device"] = {"platform": "gpu", "kind": kind, "count": count,
                      "memory_peak_bytes": int(out["peak_bytes"])}
    if trace:
        summary = out["summary"]
        line["device"].update(busy_s=summary.busy_s,
                              window_s=summary.window_s)
        line["breakdown"] = summary.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line


if __name__ == "__main__":
    sys.exit(main())
