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
parameters are the reference's layout, and runs ``setup_steps`` steps
through the window's own loop and feed, keeping each step's reported loss,
the leaf norms of the optimizer's moments after the first step and of each
leaf's change after the last. The window runs whole steps until ``seconds``
have passed and ends at a device synchronisation; every worker acts in
every step, so a step consumes ``batch x seq`` tokens. After the window the
program's state is freed and the float32 reference trains the same
``setup_steps`` steps from the same weights, rows and uniforms
(``reference/lm_consensus.py``).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import torch

from perfbench import inputs
from perfbench import trace as trace_lib
from perfbench.drivers.planted import planted
from perfbench.reference import graph as ref_graph
from perfbench.reference import lm_consensus as ref
from perfbench.reference import xlstm

MODEL_KEYS = ("d_model", "lstm_heads", "vocab_size", "num_layers")
FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


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


def _rows(cfg, mix, seed, step, fault):
    n, per, seq = cfg["workers"], cfg["batch"] // cfg["workers"], cfg["seq"]
    tokens, labels = inputs.lm_tokens(mix, cfg["vocab_size"], seed, step, n,
                                      per, seq)
    if fault == "half_batch":
        tokens, labels = tokens[:, :per // 2], labels[:, :per // 2]
    elif fault == "altered":
        labels = labels.copy()
        labels[0] = (labels[0] + 1) % cfg["vocab_size"]
    return tokens, labels


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
        solver = E.InexactSolver(grad_fn=train.lm_grad_fn(mcfg),
                                 local_steps=cfg["local_steps"],
                                 local_lr=cfg["lr"])
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

        counter = {"steps": 0}

        def advance():
            nonlocal state
            i = counter["steps"]
            tokens, labels = _rows(cfg, mix, seed, i, fault)
            batch = model_batch(mcfg, {"tokens": tokens, "labels": labels},
                                device, step=i)
            counter["steps"] += 1
            if fault == "unchanged":
                draw(0), draw(1)
                return state, {"loss": torch.tensor(float("nan"))}
            state, m = step(state, draw, batch)
            return state, m

        def flat(tree):
            return dict(T.flatten_with_path(tree))

        losses = []
        mu_norms = None
        for i in range(mix["setup_steps"]):
            _, m = advance()
            losses.append(float(m["loss"]))
            if i == 0:
                mu_norms = ref.leaf_norms(flat(state.opt_mu)) if isinstance(
                    state.opt_mu, dict) else {}
        change = ref.leaf_norms({p: x - params[p][None] for p, x in
                                 flat(state.theta).items()})
        if cuda:
            torch.cuda.synchronize()
        setup_end = time.perf_counter()

        summary = None
        steps = 0
        t0 = time.perf_counter()
        while True:
            if trace and steps == mix["trace_after"]:
                summary = trace_lib.traced(advance, mix["trace_steps"],
                                           lambda: ops.launches)
                steps += mix["trace_steps"]
            else:
                advance()
                steps += 1
            if (time.perf_counter() - t0 >= seconds
                    and (not trace or summary is not None)):
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del state, step, solver, topo
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    program = {"losses": losses, "mu_norms": mu_norms, "change_norms": change}
    reference = reference_run(cfg, mix, seed, params, device, lambda t: t)
    readings = ref.compare(program, reference)
    print(f"[perfbench] step losses: program {losses}, reference "
          f"{reference['losses']}", file=sys.stderr)
    tokens = steps * cfg["batch"] * cfg["seq"]
    return {"iterations": steps, "done": tokens, "window_s": window_s,
            "setup_end": setup_end, "peak_bytes": peak, "readings": readings,
            "per_iteration": [readings], "attempted": steps,
            "summary": summary,
            "work": {"workers": n, "width": width, "model": model_of(cfg),
                     "seq": cfg["seq"],
                     "tokens_per_step": cfg["batch"] * cfg["seq"],
                     "local_steps": cfg["local_steps"]}}


def reference_run(cfg: dict, mix: dict, seed: int, params, device,
                  act: xlstm.Act) -> dict:
    """The reference (or, with another ``act``, the control) over the
    set-up's steps, from the same weights, rows and uniforms."""
    n = cfg["workers"]
    batches = []
    for i in range(mix["setup_steps"]):
        tokens, labels = _rows(cfg, mix, seed, i, None)
        batches.append((torch.as_tensor(tokens, device=device),
                        torch.as_tensor(labels, device=device)))
    gen = inputs.draw_generator(seed, device)
    width = sum(x.numel() for x in params.values())
    return ref.run(params, n, reference_graph(cfg), model_of(cfg),
                   ref.Settings.of(cfg), batches,
                   lambda: torch.rand((n, width), generator=gen,
                                      device=device), act)
