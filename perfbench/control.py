"""Readings for the limits of a cell's comparison: the program's, the
control's and the planted faults', on several seeds in one process.

    python3 perfbench/control.py --workload epsilon-linreg.dense \\
        --seeds 11 12 13 [--faults] [--program]

The control is the reference put in the program's place at the precision
below the configuration's: for the convex cells float32 with every
product's operands rounded to TF32 (``reference.convex.CONTROL``), for the
LM cells 8-bit floating activations in place of bfloat16 (the ``fp8`` of
the configuration's reference model). It runs from the program's start, on
the same data, graphs, draws and (in a fleet cell) faults: the convex
cells' set-up iterations, an LM cell's steps up to the last the program's
run judges (the set-up's and the window step drawn from the seed); it is
judged as the program is. ``--program`` adds the program's own readings (a
run with a window of one second), ``--faults`` the program's with each
fault the cell's comparison is shown to catch planted (the driver's
``FAULTS``; an LM cell's ``lm.faults_of``). One JSON line per reading.

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
    arch, s = lm.arch_of(cfg), lm_ref.Settings.of(cfg)
    faults = lm.fleet_faults(mix)
    params = inputs.lm_params(arch, lm.model_of(cfg), seed, device)
    setup = mix["setup_steps"]
    judged = set(range(setup)) | {setup + i
                                  for i in lm.sampled_steps(mix, seed)}
    recorder = lm_ref.Recorder(cfg["local_steps"])
    graph = lm.reference_graph(cfg)
    trainer = lm_ref.Trainer(params, n, graph, lm.losses_of(cfg), s,
                             arch.fp8, recorder,
                             None if faults is None else (seed, faults))
    gen = inputs.draw_generator(seed, device)
    width = sum(x.numel() for x in params.values())
    records, rounds = [], []

    def start():
        out = lm_ref.initial_state(params, n, len(params), s.b0)
        if faults is not None:
            out["buffer"] = lm_ref.empty_buffer(n)
        return out

    def snap():
        out = trainer.snapshot()
        if faults is not None:
            out["buffer"] = trainer.buffer()
        return out

    for i in range(max(judged) + 1):
        tokens, labels = (torch.as_tensor(x, device=device)
                          for x in lm.rows_of(cfg, mix, seed, i))
        draws = gen.get_state()
        recorder.on = i in judged
        if recorder.on:
            before = lm_ref.state_before(records, i, start(), snap)
        loss = trainer.step(tokens, labels,
                            torch.rand((n, width), generator=gen,
                                       device=device),
                            torch.rand((n, width), generator=gen,
                                       device=device))
        if faults is not None:
            rounds.append(trainer.reported)
        if recorder.on:
            records.append({"step": i, "before": before, "after": snap(),
                            "calls": recorder.take(), "draws": draws,
                            "loss": loss})
        recorder.on = False
    del trainer
    if faults is not None:
        lm.attach_fleet(records, rounds, seed, faults, n)
    return lm_ref.judge_steps(
        records, lambda rec: lm.step_inputs(cfg, mix, seed, rec, device),
        graph, lm.losses_of(cfg), s, device)[0]


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
        mix = _cell(args.workload)[1]
        faults = (lm.faults_of(mix) if mix["driver"] == "lm"
                  else driver.FAULTS)
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
