"""The LM driver: CQ-GGADMM consensus training of a language model through
the program's trainer step, step after step.

The loop is built as ``launch/train.py::run_admm`` builds it: the worker
graph of ``runtime/steps.worker_graph``, the engine configuration from the
trainer's flags, ``InexactSolver`` over ``train.lm_grad_fn`` (the model's
per-worker loss and autograd), ``engine.make_step`` with the consensus
metrics (the workers' mean loss after the step), one shared initial model
repeated over the workers. The benchmark makes the model's weights
(``inputs.lm_params``), each step's token rows (``inputs.lm_tokens``) and the
stochastic-rounding uniforms from the seed.

Set-up builds the program's model from the configuration, checks that its
parameters are the reference's layout and that its state starts where
the reference's does, and runs ``setup_steps`` steps through the window's
own loop and feed. The window runs whole steps until ``seconds`` have
passed and ends at a device synchronisation; every worker acts in every
step, so a step consumes ``batch x seq`` tokens.

Every set-up step, and ``window_checks`` window steps among the first
``check_span`` drawn from the seed, are judged: their states before and
after, and what the solve's gradient function was handed and gave back
(``reference/lm_consensus.Recorder``), are copied to host memory, so that
the peak device memory stays the program's. The copies of a window step are
the harness's work, not the program's: their seconds are left out of the
window's time. After the window the program's state is freed and the
float32 reference judges each kept step stage by stage
(``reference/lm_consensus.check_step``).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import inputs
from perfbench import trace as trace_lib
from perfbench.drivers.planted import planted
from perfbench.reference import graph as ref_graph
from perfbench.reference import lm_consensus as ref
from perfbench.reference import xlstm

MODEL_KEYS = ("d_model", "lstm_heads", "vocab_size", "num_layers")
FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")
SAMPLE_STREAM = 3


def model_of(cfg: dict) -> dict:
    return {k: cfg[k] for k in MODEL_KEYS}


def nest(flat: Dict[tuple, torch.Tensor]) -> dict:
    """A tree of nested dicts from leaves by path."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def reference_graph(cfg: dict):
    return ref_graph.random_bipartite_graph(cfg["workers"], cfg["graph_p"],
                                            cfg["graph_seed"])


def program_model(cfg: dict):
    """The program's model configuration for the benchmark's, checked
    against the reference's parameter layout."""
    from repro_torch.configs import base
    from repro_torch.core import tree as T
    from repro_torch.models import registry

    mcfg = base.get_config(cfg["arch"]).with_overrides(
        dtype=cfg["dtype"], **{k: cfg[k] for k in MODEL_KEYS})
    meta = registry.init_params(mcfg, device="meta")
    got = [(p, tuple(x.shape)) for p, x in T.flatten_with_path(meta)]
    want = list(xlstm.layout(model_of(cfg)).items())
    if got != want:
        raise ValueError(f"the program's {cfg['arch']} is not the "
                         f"configuration's model: {got} != {want}")
    return mcfg


def rows_of(cfg, mix, seed, step, fault=None):
    """A step's (N, B, S) tokens and labels; with a planted fault, the
    rows the faulty program is fed."""
    n, per, seq = cfg["workers"], cfg["batch"] // cfg["workers"], cfg["seq"]
    tokens, labels = inputs.lm_tokens(mix, cfg["vocab_size"], seed, step, n,
                                      per, seq)
    if fault == "half_batch":
        tokens, labels = tokens[:, :per // 2], labels[:, :per // 2]
    elif fault == "altered":
        labels = labels.copy()
        labels[0] = (labels[0] + 1) % cfg["vocab_size"]
    return tokens, labels


def sampled_steps(mix: dict, seed: int) -> set:
    """The window steps judged, drawn from the seed."""
    rng = np.random.default_rng(inputs.stream_seed(seed, SAMPLE_STREAM))
    return set(int(i) for i in rng.choice(
        mix["check_span"], size=mix["window_checks"], replace=False))


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, fault: Optional[str] = None) -> dict:
    from repro_torch.core import engine as E
    from repro_torch.core import topology as topo_lib
    from repro_torch.core import tree as T
    from repro_torch.core.censoring import CensorConfig
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.data.lm import model_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime import steps as ST

    cuda = torch.device(device).type == "cuda"
    n = cfg["workers"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def flat(tree):
        return dict(T.flatten_with_path(tree))

    recorder = ref.Recorder(cfg["local_steps"])
    t_built = time.perf_counter()
    with planted(fault):
        mcfg = program_model(cfg)
        params = inputs.lm_params(model_of(cfg), seed, device)
        theta = T.tree_map(lambda x: x[None].repeat((n,) + (1,) * x.dim()),
                           nest(params))
        graph = ST.worker_graph(n, "random")
        ecfg = E.EngineConfig(
            rho=cfg["rho"],
            censor=CensorConfig(tau0=cfg["tau0"], xi=cfg["xi"]),
            quantize=QuantConfig(b0=cfg["bits"], omega=cfg["omega"],
                                 b_max=cfg["b_max"]),
            groups=cfg["groups"], censor_mode="global",
            mix_backend=mix["mix_backend"])
        topo = topo_lib.build(graph, ecfg.mix_backend, device=device)
        solver = E.InexactSolver(
            grad_fn=recorder.wrap(train.lm_grad_fn(mcfg), flat),
            local_steps=cfg["local_steps"], local_lr=cfg["lr"])
        state = E.init_state(theta, ecfg, solver)
        del theta
        step = E.make_step(graph, ecfg, solver,
                           extra_metrics=E.consensus_metrics(
                               train.lm_loss_fn(mcfg), topology=topo),
                           topology=topo)
        width = E.tree_dim(state.theta)
        gen = inputs.draw_generator(seed, device)

        def draw(phase: int) -> torch.Tensor:
            return torch.rand((n, width), generator=gen, device=device)

        def view(st) -> dict:
            q = st.quant
            return {"theta": flat(st.theta), "theta_hat": flat(st.theta_hat),
                    "alpha": flat(st.alpha), "q_hat": flat(q.q_hat),
                    "mu": flat(st.opt_mu), "nu": flat(st.opt_nu),
                    "range": q.range_prev, "bits": q.bits_prev,
                    "delta": q.delta_prev, "init": q.initialized, "k": st.k}

        n_groups = state.quant.n_groups
        start_errors = ref.state_errors(view(state), ref.initial_state(
            params, n, n_groups, cfg["bits"]))
        params = ref.to_host(params)
        counter = {"steps": 0}

        def advance():
            nonlocal state
            i = counter["steps"]
            tokens, labels = rows_of(cfg, mix, seed, i, fault)
            batch = model_batch(mcfg, {"tokens": tokens, "labels": labels},
                                device, step=i)
            counter["steps"] += 1
            new, m = step(state, draw, batch)
            if fault != "unchanged":
                state = new
            return m

        records = []

        def judged() -> float:
            """One step, kept for the judge; the seconds spent copying."""
            sync()
            t0 = time.perf_counter()
            i = counter["steps"]
            before = ref.state_before(
                records, i, ref.initial_state(params, n, n_groups,
                                              cfg["bits"]),
                lambda: ref.snapshot(view(state)))
            draws = gen.get_state()
            copying = time.perf_counter() - t0
            recorder.on = True
            m = advance()
            loss = float(m["loss"])
            recorder.on = False
            t1 = time.perf_counter()
            records.append({"step": i, "before": before,
                            "after": ref.snapshot(view(state)),
                            "calls": recorder.take(), "draws": draws,
                            "loss": loss})
            copying += time.perf_counter() - t1 + recorder.seconds
            recorder.seconds = 0.0
            return copying

        built = time.perf_counter()
        for _ in range(mix["setup_steps"]):
            judged()
        sync()
        setup_end = time.perf_counter()

        sampled = sampled_steps(mix, seed)
        summary = None
        steps, copying = 0, 0.0
        t0 = time.perf_counter()
        ends = []
        while True:
            if trace and steps == mix["trace_after"]:
                summary = trace_lib.traced(advance, mix["trace_steps"],
                                           lambda: ops.launches)
                steps += mix["trace_steps"]
            elif steps in sampled:
                copying += judged()
                steps += 1
            else:
                advance()
                steps += 1
            ends.append(time.perf_counter() - t0 - copying)
            if (ends[-1] >= seconds
                    and steps >= mix["check_span"]
                    and (not trace or summary is not None)):
                break
        sync()
        window_s = time.perf_counter() - t0 - copying
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del state, step, solver, topo
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"[perfbench] set-up: built in {built - t_built:.3f} s, "
          f"{mix['setup_steps']} judged steps in {setup_end - built:.3f} s; "
          f"window {window_s:.3f} s of steps ending at {ends} s, "
          f"{copying:.3f} s copying judged steps to host", file=sys.stderr)
    t_judge = time.perf_counter()
    readings, each = ref.judge_steps(
        records, lambda rec: step_inputs(cfg, mix, seed, rec, device),
        reference_graph(cfg), model_of(cfg), ref.Settings.of(cfg), device,
        start_errors)
    for rec, r in zip(records, each):
        print(f"[perfbench] step {rec['step']}: {r}", file=sys.stderr)
    print(f"[perfbench] judged {len(records)} steps in "
          f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    tokens = steps * cfg["batch"] * cfg["seq"]
    return {"iterations": steps, "done": tokens, "window_s": window_s,
            "setup_end": setup_end, "peak_bytes": peak, "readings": readings,
            "per_iteration": each, "attempted": steps,
            "summary": summary,
            "work": {"workers": n, "width": width, "model": model_of(cfg),
                     "seq": cfg["seq"],
                     "tokens_per_step": cfg["batch"] * cfg["seq"],
                     "local_steps": cfg["local_steps"]}}


def step_inputs(cfg, mix, seed, rec, device):
    """A judged step's rows (as the benchmark made them, whatever the
    program was fed) and its two uniform draws, drawn again from the
    generator's state before the step (``rec["draws"]``)."""
    tokens, labels = rows_of(cfg, mix, seed, rec["step"])
    gen = torch.Generator(device=device)
    gen.set_state(rec["draws"])
    n = cfg["workers"]
    width = sum(int(np.prod(s)) for s in
                xlstm.layout(model_of(cfg)).values())
    u0 = torch.rand((n, width), generator=gen, device=device)
    u1 = torch.rand((n, width), generator=gen, device=device)
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(labels, device=device), u0, u1)
