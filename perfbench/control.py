"""Readings for the limits of a cell's comparison: the program's, the
control's and the planted faults', on several seeds in one process.

    python3 perfbench/control.py --workload epsilon-linreg.dense \\
        --seeds 11 12 13 [--faults] [--program]

The control is the reference put in the program's place at the precision
below the configuration's: for the convex cells float32 with every
product's operands rounded to TF32 (``reference.convex.CONTROL``), for the
LM cells 8-bit floating activations in place of bfloat16
(``reference.xlstm.fp8``). It runs the cell's set-up iterations or steps
from the same start, on the same data, graphs and draws, and is judged as
the program is. ``--program`` adds the program's own readings (a run with a
window of one second), ``--faults`` the program's with each fault of the
driver's ``FAULTS`` planted. One JSON line per reading.

Benchmark runs never run this; it sets and re-checks the limits in the
configuration's ``limits``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench import inputs, run as bench  # noqa: E402
from perfbench.drivers import convex as driver  # noqa: E402
from perfbench.drivers import lm  # noqa: E402
from perfbench.reference import convex as ref  # noqa: E402
from perfbench.reference import lm_consensus as lm_ref  # noqa: E402
from perfbench.reference import xlstm  # noqa: E402


def _cell(workload: str, overrides=None):
    spec = bench.load_spec()
    wl = bench.find(spec["workloads"], workload)
    cfg = bench.load_json(bench.ROOT / bench.find(
        spec["configs"], wl["config"])["file"])
    cfg.update(overrides or {})
    return cfg, bench.load_json(bench.HERE / "traffic"
                                / f"{wl['traffic']}.json")


def control_readings(workload: str, seed: int, device, overrides=None):
    """The control's readings, judged as the program's are."""
    cfg, mix = _cell(workload, overrides)
    if mix["driver"] == "lm":
        return _lm_control(cfg, mix, seed, device)
    return _convex_control(cfg, mix, seed, device)


def _lm_control(cfg, mix, seed, device):
    """The reference in 8-bit activations against the float32 reference,
    over the set-up's steps."""
    params = inputs.lm_params(lm.model_of(cfg), seed, device)
    control = lm.reference_run(cfg, mix, seed, params, device, xlstm.fp8)
    reference = lm.reference_run(cfg, mix, seed, params, device,
                                 lambda t: t)
    return lm_ref.compare(control, reference)


def _convex_control(cfg, mix, seed, device):
    """The reference in float32 with TF32 products, over the set-up's
    iterations."""
    import torch

    n, d = cfg["workers"], cfg["n_features"]
    scheme = ref.Scheme.of(cfg)
    x, y = inputs.linreg_data(cfg, seed, device)
    gen = inputs.draw_generator(seed, device)
    refresh = int(mix.get("refresh_every", 0))

    def graph_of(it):
        return driver.reference_graph(n, cfg["graph_p"],
                                      driver.graph_seed(seed), refresh, it)

    problem = ref.Problem(x, y, scheme.rho, ref.CONTROL)
    state = ref.initial_state(n, d, scheme, torch.float32, device)
    records = []
    for it in range(mix["setup_iters"]):
        u0 = torch.rand((n, d), generator=gen, device=device)
        u1 = torch.rand((n, d), generator=gen, device=device)
        reset = bool(refresh and it and it % refresh == 0)
        before = state
        if reset:
            state = dict(state, alpha=torch.zeros_like(state["alpha"]))
        state = ref.step(state, u0, u1, graph_of(it), problem, scheme)
        records.append((it, before, state, u0, u1, reset))
    del problem
    return ref.judge_steps(records, x, y, graph_of, scheme)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    bench.set_environment()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    runs = [("control", None)]
    if args.program:
        runs.append(("program", None))
    if args.faults:
        faults = (lm if _cell(args.workload)[1]["driver"] == "lm"
                  else driver).FAULTS
        runs += [(f"fault:{f}", f) for f in faults]
    for seed in args.seeds:
        for label, fault in runs:
            t0 = time.perf_counter()
            if label == "control":
                readings = control_readings(args.workload, seed, dev)
            else:
                readings = bench.run_cell(args.workload, seed, 1.0, False,
                                          dev, t0, fault=fault)[1]["readings"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "run": label, "readings": readings,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
