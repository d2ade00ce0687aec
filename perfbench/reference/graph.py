"""Random connected bipartite worker graphs of the paper's Sec. 7, in plain
numpy: a frozen copy of the generator the program uses
(``random_bipartite_graph``: the same seed gives the same graph), so that
the benchmark can hand a graph to the program and the reference can work
out again the graphs the program draws for itself.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Graph(NamedTuple):
    n: int
    edges: np.ndarray        # (E, 2) int64 (head, tail), sorted
    head_mask: np.ndarray    # (n,) bool
    adjacency: np.ndarray    # (n, n) float32 0/1, symmetric
    degrees: np.ndarray      # (n,) float32


def random_bipartite_graph(n: int, p: float, seed: int) -> Graph:
    """A spanning structure between the halves, then edges drawn uniformly
    among head-tail pairs up to round(p n (n - 1) / 2)."""
    rng = np.random.default_rng(seed)
    n_heads = n // 2
    perm = rng.permutation(n)
    heads, tails = perm[:n_heads], perm[n_heads:]
    head_mask = np.zeros(n, dtype=bool)
    head_mask[heads] = True
    edges = set()
    connected = [int(heads[0])]
    remaining = [int(x) for x in perm if int(x) != int(heads[0])]
    rng.shuffle(remaining)
    for v in remaining:
        opposite = [u for u in connected if head_mask[u] != head_mask[v]]
        if not opposite:
            remaining.append(v)
            continue
        u = int(rng.choice(opposite))
        edges.add((u, v) if head_mask[u] else (v, u))
        connected.append(v)
    target = int(round(p * n * (n - 1) / 2.0))
    pairs = [(int(h), int(t)) for h in heads for t in tails]
    rng.shuffle(pairs)
    for pair in pairs:
        if len(edges) >= target:
            break
        edges.add(pair)
    edge_arr = np.asarray(sorted(edges), dtype=np.int64)
    adj = np.zeros((n, n), dtype=np.float32)
    adj[edge_arr[:, 0], edge_arr[:, 1]] = 1.0
    adj[edge_arr[:, 1], edge_arr[:, 0]] = 1.0
    return Graph(n, edge_arr, head_mask, adj, adj.sum(axis=1))
