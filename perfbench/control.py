"""Readings for the limits of a cell's comparison: the program's, the
control's and the planted faults', on several seeds in one process.

    python3 perfbench/control.py --workload epsilon-linreg.dense \\
        --seeds 11 12 13 [--faults] [--program]

The control is the reference put in the program's place at the precision
below the configuration's: for the convex cells float32 with every
product's operands rounded to TF32 (``reference.convex.CONTROL``), for the
LM cells 8-bit floating activations in place of bfloat16
(``reference.xlstm.fp8``). It runs from the program's start, on the same
data, graphs and draws: the convex cells' set-up iterations, the LM cell's
steps up to the last the program's run judges (the set-up's and the window
step drawn from the seed); it is judged as the program is. ``--program`` adds the program's own readings (a run with a
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
    """The reference in 8-bit activations in the program's place, over the
    cell's judged steps (the set-up's and the window's drawn from the
    seed), its gradient function recorded and its steps judged as the
    program's are."""
    import torch

    n = cfg["workers"]
    model, s = lm.model_of(cfg), lm_ref.Settings.of(cfg)
    params = inputs.lm_params(model, seed, device)
    setup = mix["setup_steps"]
    judged = set(range(setup)) | {setup + i
                                  for i in lm.sampled_steps(mix, seed)}
    recorder = lm_ref.Recorder(cfg["local_steps"])
    graph = lm.reference_graph(cfg)
    trainer = lm_ref.Trainer(params, n, graph, model, s, xlstm.fp8,
                             recorder)
    gen = inputs.draw_generator(seed, device)
    width = sum(x.numel() for x in params.values())
    records = []
    for i in range(max(judged) + 1):
        tokens, labels = (torch.as_tensor(x, device=device)
                          for x in lm.rows_of(cfg, mix, seed, i))
        draws = gen.get_state()
        recorder.on = i in judged
        if recorder.on:
            before = lm_ref.state_before(
                records, i, lm_ref.initial_state(params, n, len(params),
                                                 s.b0), trainer.snapshot)
        loss = trainer.step(tokens, labels,
                            torch.rand((n, width), generator=gen,
                                       device=device),
                            torch.rand((n, width), generator=gen,
                                       device=device))
        if recorder.on:
            records.append({"step": i, "before": before,
                            "after": trainer.snapshot(),
                            "calls": recorder.take(), "draws": draws,
                            "loss": loss})
        recorder.on = False
    del trainer
    return lm_ref.judge_steps(
        records, lambda rec: lm.step_inputs(cfg, mix, seed, rec, device),
        graph, model, s, device)[0]


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
