"""Quickstart part 1 through the port: the paper's algorithm on its own task.

Decentralized linear regression over 24 workers on a random bipartite graph
(p=0.35), GGADMM vs CQ-GGADMM — same solution, far fewer transmitted bits.
It prints the same line per scheme as ``examples/quickstart.py`` part 1.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch import interop
from repro_torch.core import admm_baselines as ab
from repro_torch.core import engine as E
from repro_torch.core.comm import build_comm_log
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.data import regression as R
from repro_torch.device import resolve_device

N_WORKERS, ITERS = 24, 300
SCHEMES = ("ggadmm", "cq-ggadmm")


def part1(device=None, iters: int = ITERS, schemes: Sequence[str] = SCHEMES
          ) -> Dict[str, dict]:
    """Run part 1 and return, per scheme, the final distance to the
    optimum, the communication log, the per-iteration metrics and the
    final state."""
    dev = resolve_device(device)
    data = R.synth_linear()                       # d=50, 1200 samples
    graph = random_bipartite_graph(N_WORKERS, p=0.35, seed=0)
    x, y = R.partition_uniform(data, N_WORKERS)
    prob = interop.problem_from_numpy(x, y, "linear", device=dev)
    theta_star = prob.optimum()
    results = {}
    for scheme in schemes:
        cfg = ab.ALL_SCHEMES[scheme](rho=1.0)
        theta0 = torch.zeros((N_WORKERS, prob.dim), dtype=torch.float32,
                             device=dev)
        state, out = E.run(graph, cfg, E.ExactSolver(prob), theta0, iters,
                           extra_metrics=E.flat_metrics(graph, device=dev))
        dist = float(torch.sum((out["theta"][-1] - theta_star[None]) ** 2))
        log = build_comm_log(out["tx_mask"].cpu().numpy(),
                             out["payload_bits"].cpu().numpy(), graph,
                             fraction_active=0.5)
        results[scheme] = {"dist": dist, "log": log, "metrics": out,
                           "state": state}
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    for scheme, res in part1(args.device, args.iters).items():
        log = res["log"]
        print(f"{scheme:10s} dist-to-opt={res['dist']:.2e}  "
              f"rounds={log.cumulative_rounds[-1]:.0f}  "
              f"bits={log.cumulative_bits[-1]:.3e}  "
              f"energy={log.cumulative_energy[-1]:.3e} J")


if __name__ == "__main__":
    main()
