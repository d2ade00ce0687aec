"""The worker graph of the trainer (the port of
``repro.runtime.steps.worker_graph``; the rest of that module builds XLA
mesh programs and is not ported)."""
from __future__ import annotations

from repro_torch.core import graph as G


def worker_graph(n_workers: int, topology: str = "random") -> G.WorkerGraph:
    if n_workers == 2:
        return G.complete_bipartite_graph(1, 1)   # the pod-pair graph
    if topology == "chain":
        return G.chain_graph(n_workers)
    if topology == "complete":
        return G.complete_bipartite_graph(n_workers // 2,
                                          n_workers - n_workers // 2)
    return G.random_bipartite_graph(n_workers, p=0.4, seed=0)
