"""The paper's Figs. 2-6 through the port: every scheme of Sec. 7 on each
figure's task, read on the paper's four axes (iterations, communication
rounds, transmitted bits and transmit energy, each to the figure's target
objective error), and the paper's qualitative claims checked on the run.

The port of ``benchmarks/bench_figures.py`` and of the harness half of
``benchmarks/common.py`` (``FACTORY`` .. ``print_figure``), with the same
settings and per-scheme overrides. The iteration runs on the card (the
quantize and mix kernels) unless ``--device cpu`` is given; the
stochastic-rounding draws are the port's own (``torch.Generator``), or
``uniforms(iteration, phase)`` where a caller injects them.

    PYTHONPATH=src python -m repro_torch.bench.figures [--device cpu] \\
        [--figures fig3_linreg_real,fig6_density] [--out figures.json]

``main`` runs each figure through the campaign runner as a one-run
``paper-figures`` campaign (:func:`figure_campaign`; the run key is the
full campaign's), prints its table and the runner's ``claim,...`` lines,
writes every row, claim and kernel launch count to ``--out`` as JSON, and
returns 1 if any claim or run fails (0 otherwise). ``python -m
repro_torch.launch.train --campaign paper-figures`` runs all five as one
campaign.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.campaign.runner import Runner
from repro_torch.campaign.spec import Campaign, stage
from repro_torch.campaign.store import Claim, Record, ResultStore
from repro_torch.core import admm_baselines as ab
from repro_torch.core import cq_ggadmm as cq
from repro_torch.core.comm import EnergyModel, build_comm_log
from repro_torch.core.graph import WorkerGraph, random_bipartite_graph
from repro_torch.core.solvers import (LinearRegressionProblem,
                                      LogisticRegressionProblem)
from repro_torch.data import regression as R
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

# Scheme configs "leading to the best performance" (Sec. 7): defaults here,
# per-figure overrides passed by the figures (the paper also tunes per
# algorithm and task).
FACTORY = {"c-admm": ab.c_admm, "ggadmm": ab.ggadmm,
           "c-ggadmm": ab.c_ggadmm, "cq-ggadmm": ab.cq_ggadmm,
           "q-ggadmm": ab.q_ggadmm}
DEFAULTS = {
    "c-admm": dict(tau0=0.5, xi=0.97),
    "ggadmm": dict(),
    "c-ggadmm": dict(tau0=0.5, xi=0.97),
    "cq-ggadmm": dict(tau0=0.5, xi=0.97, b0=2, omega=0.99),
    # quantization without censoring: a column beyond the paper's set
    "q-ggadmm": dict(b0=2, omega=0.99),
}
SCHEMES = ("c-admm", "ggadmm", "c-ggadmm", "cq-ggadmm", "q-ggadmm")
FRACTION_ACTIVE = {"c-admm": 1.0, "ggadmm": 0.5, "c-ggadmm": 0.5,
                   "cq-ggadmm": 0.5, "q-ggadmm": 0.5}
EPS = 1e-4
PAPER_SET = ("c-admm", "ggadmm", "c-ggadmm", "cq-ggadmm")
Uniforms = Callable[[int, int], torch.Tensor]


def scheme_config(name: str, rho: float, **overrides):
    kw = {**DEFAULTS[name], **overrides}
    return FACTORY[name](rho=rho, **kw)


def make_problem(dataset: str, n_workers: int, graph_seed: int = 0,
                 p: float = 0.35, device=None):
    """(graph, problem) of a figure: the dataset split uniformly over
    ``n_workers`` on a random bipartite graph of edge probability ``p``."""
    dev = resolve_device(device)
    data = R.DATASETS[dataset]()
    graph = random_bipartite_graph(n_workers, p, seed=graph_seed)
    x, y = R.partition_uniform(data, n_workers)
    xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.ascontiguousarray(y, np.float32), device=dev)
    if data.task == "linear":
        return graph, LinearRegressionProblem(xt, yt)
    return graph, LogisticRegressionProblem(xt, yt, mu0=1e-2, newton_steps=6)


@dataclasses.dataclass
class SchemeResult:
    name: str
    gap: np.ndarray          # objective error per iteration
    rounds: np.ndarray       # cumulative communication rounds
    bits: np.ndarray         # cumulative transmitted bits
    energy: np.ndarray       # cumulative transmit energy [J]
    wall_s: float

    def to_target(self, eps: float) -> Dict[str, float]:
        """First iteration/rounds/bits/energy at which gap <= eps."""
        hit = np.nonzero(self.gap <= eps)[0]
        if hit.size == 0:
            return {"iters": np.inf, "rounds": np.inf, "bits": np.inf,
                    "energy": np.inf, "final_gap": float(self.gap[-1])}
        i = int(hit[0])
        return {"iters": i + 1, "rounds": float(self.rounds[i]),
                "bits": float(self.bits[i]),
                "energy": float(self.energy[i]),
                "final_gap": float(self.gap[-1])}


def run_scheme(name: str, graph: WorkerGraph, prob, *, rho: float,
               iters: int, seed: int = 0,
               energy_model: Optional[EnergyModel] = None,
               uniforms: Optional[Uniforms] = None,
               **overrides) -> SchemeResult:
    """Run one scheme on the problem's device; ``uniforms(iteration,
    phase)`` replaces the seeded rounding draws."""
    cfg = scheme_config(name, rho, **overrides)
    dev = prob.x.device
    theta_star = prob.optimum()
    f_star = float(prob.global_loss(theta_star))
    t0 = time.time()
    _, out = cq.run(graph, prob, cfg, dim=prob.dim, iters=iters, seed=seed,
                    theta_star=theta_star, local_loss=prob.local_loss,
                    uniforms=uniforms, device=dev)
    wall = time.time() - t0
    log = build_comm_log(out["tx_mask"], out["payload_bits"], graph,
                         model=energy_model,
                         fraction_active=FRACTION_ACTIVE[name])
    gap = np.abs(out["objective"] - f_star)
    return SchemeResult(name=name, gap=gap,
                        rounds=log.cumulative_rounds,
                        bits=log.cumulative_bits,
                        energy=log.cumulative_energy, wall_s=wall)


def run_figure(dataset: str, *, n_workers: int, rho: float, iters: int,
               eps: float, graph_seed: int = 0, p: float = 0.35,
               scheme_kwargs: Optional[Dict[str, Dict]] = None,
               device=None) -> Dict[str, Dict[str, float]]:
    graph, prob = make_problem(dataset, n_workers, graph_seed, p, device)
    scheme_kwargs = scheme_kwargs or {}
    results = {}
    for name in SCHEMES:
        kw = dict(scheme_kwargs.get(name, {}))
        rho_s = kw.pop("rho", rho)
        res = run_scheme(name, graph, prob, rho=rho_s, iters=iters, **kw)
        results[name] = res.to_target(eps)
        results[name]["wall_s"] = res.wall_s
    return results


def print_figure(tag: str, results: Dict[str, Dict[str, float]]) -> None:
    cols = ("iters", "rounds", "bits", "energy", "final_gap")
    print(f"# {tag}")
    print("scheme," + ",".join(cols))
    for name, row in results.items():
        vals = ",".join(f"{row[c]:.4g}" for c in cols)
        print(f"{name},{vals}")


# ----------------------------------------------------------- the figures --
def _claims(results: Dict[str, Dict[str, float]],
            censoring_helps_rounds: bool = True) -> Dict[str, bool]:
    """The paper's qualitative claims over its plotted scheme set (the
    q-ggadmm column is informational)."""
    r = {k: v for k, v in results.items() if k in PAPER_SET}
    claims = {
        # Figs 2a-5a: the GGADMM family converges in fewer iterations than
        # the Jacobian C-ADMM
        "ggadmm_fewer_iters_than_cadmm":
            r["ggadmm"]["iters"] <= r["c-admm"]["iters"],
        # Figs 2c-5c, 2d-5d: CQ-GGADMM moves the fewest bits and the least
        # energy among the schemes
        "cq_fewest_bits":
            r["cq-ggadmm"]["bits"] <= min(r[s]["bits"] for s in r),
        "cq_least_energy":
            r["cq-ggadmm"]["energy"] <= min(r[s]["energy"] for s in r),
        # accuracy is not compromised (all reach the target)
        "all_reach_target":
            all(r[s]["iters"] != float("inf") for s in r),
    }
    if censoring_helps_rounds:
        # Figs 2b/3b: C-GGADMM needs fewer communication rounds
        claims["censoring_saves_rounds"] = (
            r["c-ggadmm"]["rounds"] <= r["ggadmm"]["rounds"])
    return claims


def fig2_linreg_synth(device=None) -> Tuple[dict, dict]:
    """Fig. 2: linear regression, synthetic (d=50), 24 workers."""
    res = run_figure("synth-linear", n_workers=24, rho=1.0, iters=400,
                     eps=EPS, device=device)
    return res, _claims(res)


def fig3_linreg_real(device=None) -> Tuple[dict, dict]:
    """Fig. 3: linear regression, Body Fat (d=14), 18 workers; CQ takes a
    stronger censor (tau0=2), its side information being a large part of
    each payload at d=14."""
    res = run_figure("bodyfat", n_workers=18, rho=1.0, iters=400, eps=EPS,
                     scheme_kwargs={"cq-ggadmm": dict(tau0=2.0)},
                     device=device)
    return res, _claims(res)


def fig4_logreg_synth(device=None) -> Tuple[dict, dict]:
    """Fig. 4: logistic regression, synthetic (d=50), 24 workers. For
    logistic tasks censoring alone may not save rounds (Sec. 7.2), so that
    claim is not asserted."""
    res = run_figure("synth-logistic", n_workers=24, rho=0.2, iters=500,
                     eps=1e-3, scheme_kwargs={"c-admm": dict(rho=0.1)},
                     device=device)
    return res, _claims(res, censoring_helps_rounds=False)


def fig5_logreg_real(device=None) -> Tuple[dict, dict]:
    """Fig. 5: logistic regression, Derm (d=34), 18 workers."""
    res = run_figure("derm", n_workers=18, rho=0.2, iters=500, eps=1e-3,
                     scheme_kwargs={"c-admm": dict(rho=0.1)}, device=device)
    return res, _claims(res, censoring_helps_rounds=False)


def fig6_density(device=None) -> Tuple[dict, dict]:
    """Fig. 6: graph density; denser graphs converge faster."""
    out = {}
    for tag, p in (("sparse_p0.2", 0.2), ("dense_p0.4", 0.4)):
        graph, prob = make_problem("bodyfat", 18, graph_seed=2, p=p,
                                   device=device)
        res = run_scheme("c-ggadmm", graph, prob, rho=1.0, iters=400)
        out[tag] = res.to_target(EPS)
    claims = {
        "denser_graph_fewer_iters":
            out["dense_p0.4"]["iters"] <= out["sparse_p0.2"]["iters"],
    }
    return out, claims


ALL_FIGURES = {
    "fig2_linreg_synth": fig2_linreg_synth,
    "fig3_linreg_real": fig3_linreg_real,
    "fig4_logreg_synth": fig4_logreg_synth,
    "fig5_logreg_real": fig5_logreg_real,
    "fig6_density": fig6_density,
}


def _json_number(x):
    """inf as the string "inf" (JSON has no infinity)."""
    x = float(x)
    return x if math.isfinite(x) else ("inf" if x > 0 else "-inf")


def stage_figure(figure: str, ctx=None) -> Record:
    """One paper figure as a campaign run (campaign ``paper-figures``) on
    ``ctx.device`` (the card without a context): its rows land in the
    ``figures.<figure>`` section, its claims in ``figures.claims``."""
    if figure not in ALL_FIGURES:
        raise ValueError(f"unknown figure {figure!r} "
                         f"(have: {sorted(ALL_FIGURES)})")
    res, claims = ALL_FIGURES[figure](
        device=ctx.device if ctx is not None else None)
    print_figure(figure, res)
    return Record(
        section=("figures", figure), data=res,
        claims=tuple(Claim(f"{figure}_{name}", ok,
                           gate="paper qualitative claim")
                     for name, ok in claims.items()),
        claims_path=("figures", "claims"))


def figure_campaign(figure: str) -> Campaign:
    """A one-run ``paper-figures`` campaign: the full campaign's stage
    name, fn and config for ``figure``, so the run key is the same."""
    return Campaign(name="paper-figures", stages=(stage(
        "figures", "repro_torch.bench.figures:stage_figure",
        configs=[{"figure": figure}], names=[figure]),))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figures", default=",".join(ALL_FIGURES),
                    help="comma-separated figure names (default: all)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write every row and claim here as JSON")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--campaign-dir", default="campaigns/torch",
                    metavar="DIR",
                    help="the runner's results document and run state")
    args = ap.parse_args(argv)
    names = [n for n in args.figures.split(",") if n]
    for name in names:
        if name not in ALL_FIGURES:
            raise SystemExit(f"[figures] unknown figure {name!r} "
                             f"(have: {sorted(ALL_FIGURES)})")
    resolve_device(args.device)      # no card and no --device cpu: raise
    root = Path(args.campaign_dir)
    store = ResultStore(root / "BENCH_engine.json")
    out, failed_runs = {}, 0
    for name in names:
        before = dict(kernel_ops.launches)
        runner = Runner(figure_campaign(name), store=store, state_root=root,
                        device=args.device)
        summary = runner.run()
        failed_runs += summary.failed
        rows, claims = {}, {}
        if not summary.failed:
            spec = runner.campaign.stages[0].runs[0]
            with open(runner.run_dir(spec) / "record.json") as f:
                record = Record.from_json(json.load(f))
            rows = record.data
            claims = {c.name[len(name) + 1:]: c.ok for c in record.claims}
        out[name] = {"rows": rows, "claims": claims,
                     "launches": {k: n - before[k]
                                  for k, n in kernel_ops.launches.items()}}
    failed = [f"{fig}_{c}" for fig, v in out.items()
              for c, ok in v["claims"].items() if not ok]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({fig: {"rows": {s: {k: _json_number(x)
                                          for k, x in row.items()}
                                      for s, row in v["rows"].items()},
                             "claims": v["claims"],
                             "launches": v["launches"]}
                       for fig, v in out.items()}, f, indent=1,
                      sort_keys=True)
    print(f"[figures] {len(names)} figures, "
          f"{sum(len(v['claims']) for v in out.values())} claims, "
          f"{len(failed)} failed" + (f": {failed}" if failed else "")
          + (f"; {failed_runs} runs failed" if failed_runs else ""))
    return 1 if failed or failed_runs else 0


if __name__ == "__main__":
    raise SystemExit(main())
