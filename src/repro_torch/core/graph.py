"""Bipartite connected worker graphs for (CQ-G)GADMM.

The paper (Assumption 1) requires the communication graph G to be bipartite
and connected. Workers are split into a head group H and a tail group T; all
edges go between groups. This module builds such graphs, including the random
connectivity-ratio-p graphs of Sec. 7 ("Graph Generation"), and exposes the
matrices used by the convergence analysis (Appendix D): adjacency A,
bi-adjacency B, degree D, signed/unsigned incidence M_-, M_+, and the
asymmetric update matrix C of Eq. (115).

Everything is plain numpy at construction time (graphs are static metadata).
This is the port's own copy of ``repro.core.graph``: the same seed gives the
same graph, array for array, and the port never imports the JAX package.
The topology layer (``repro_torch/core/topology.py``) moves the arrays to
the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkerGraph:
    """Static description of a bipartite connected worker graph.

    Attributes:
      n: number of workers (|V|).
      edges: (E, 2) int array; every edge is (head, tail) with head in H,
        tail in T (paper's convention E = {(n, m) | n in H, m in T}).
      head_mask: (n,) bool, True for head workers.
      adjacency: (n, n) float32 symmetric 0/1 matrix A (Eq. 114).
      degrees: (n,) float32 node degrees d_n = |N_n|.

    Beyond the dense matrices, the graph carries precomputed *edge-list /
    CSR* views of the same topology (``edge_src``/``edge_dst``,
    ``csr_offsets``/``csr_indices``, ``neighbor_table``) — the O(E) inputs
    of the sparse mixing backend (``core/topology.py``). They are derived
    lazily from ``edges`` and cached on the instance; ``validate()``
    round-trips them against ``adjacency``.
    """

    n: int
    edges: np.ndarray
    head_mask: np.ndarray
    adjacency: np.ndarray
    degrees: np.ndarray

    # -- edge-list / CSR views (sparse-backend metadata) -------------------
    @functools.cached_property
    def _directed_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Both orientations of every undirected edge, sorted by
        (destination, source): ``out[dst] += V[src]`` visits each node's
        incoming contributions contiguously."""
        e = np.asarray(self.edges, dtype=np.int64)
        src = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
        dst = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
        order = np.lexsort((src, dst))
        return src[order], dst[order]

    @property
    def edge_src(self) -> np.ndarray:
        """(2E,) int32 source node of each directed edge (dst-sorted)."""
        return self._directed_edges[0]

    @property
    def edge_dst(self) -> np.ndarray:
        """(2E,) int32 destination node of each directed edge (sorted)."""
        return self._directed_edges[1]

    @functools.cached_property
    def csr_offsets(self) -> np.ndarray:
        """(N+1,) int32 CSR row pointers: node n's neighbors are
        ``csr_indices[csr_offsets[n]:csr_offsets[n + 1]]``."""
        counts = np.bincount(self.edge_dst, minlength=self.n)
        offsets = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return offsets.astype(np.int32)

    @property
    def csr_indices(self) -> np.ndarray:
        """(2E,) int32 CSR column indices (= ``edge_src``: dst-sorted
        directed edges ARE the CSR layout)."""
        return self.edge_src

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @functools.cached_property
    def neighbor_table(self) -> Tuple[np.ndarray, np.ndarray]:
        """Degree-padded CSR: ``(table (N, S) int32, valid (N, S) f32)``
        with S = max_degree; slot s of row n is n's s-th neighbor (pad
        rows point at node 0 with valid = 0). This is the rectangular
        layout the Pallas edge-gather mix kernel consumes."""
        s = max(self.max_degree, 1)
        table = np.zeros((self.n, s), dtype=np.int32)
        valid = np.zeros((self.n, s), dtype=np.float32)
        offsets, indices = self.csr_offsets, self.csr_indices
        for node in range(self.n):
            lo, hi = int(offsets[node]), int(offsets[node + 1])
            table[node, :hi - lo] = indices[lo:hi]
            valid[node, :hi - lo] = 1.0
        return table, valid

    # -- derived matrices (Appendix D) ------------------------------------
    @property
    def tail_mask(self) -> np.ndarray:
        return ~self.head_mask

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def degree_matrix(self) -> np.ndarray:
        """Diagonal degree matrix D."""
        return np.diag(self.degrees).astype(np.float32)

    @property
    def c_matrix(self) -> np.ndarray:
        """Matrix C of Eq. (115): head->tail half of A (rows=heads' view).

        C[n, m] = A[n, m] if n in H and m in T else 0. With workers ordered
        arbitrarily, this is A masked to (head rows, tail cols).
        """
        c = self.adjacency.copy()
        c[~self.head_mask, :] = 0.0
        c[:, self.head_mask] = 0.0
        return c.astype(np.float32)

    @property
    def signed_incidence(self) -> np.ndarray:
        """Signed incidence matrix M_- of shape (n, E): +1 at head, -1 at tail."""
        m = np.zeros((self.n, self.num_edges), dtype=np.float32)
        for e, (h, t) in enumerate(self.edges):
            m[h, e] = 1.0
            m[t, e] = -1.0
        return m

    @property
    def unsigned_incidence(self) -> np.ndarray:
        """Unsigned incidence matrix M_+ of shape (n, E): +1 at both ends."""
        m = np.zeros((self.n, self.num_edges), dtype=np.float32)
        for e, (h, t) in enumerate(self.edges):
            m[h, e] = 1.0
            m[t, e] = 1.0
        return m

    def validate(self) -> None:
        """Check bipartiteness, connectivity and matrix identities."""
        a = self.adjacency
        assert np.allclose(a, a.T), "adjacency must be symmetric"
        assert a.diagonal().sum() == 0, "no self loops"
        # bipartite: no head-head or tail-tail edges
        hh = a[np.ix_(self.head_mask, self.head_mask)]
        tt = a[np.ix_(self.tail_mask, self.tail_mask)]
        assert hh.sum() == 0 and tt.sum() == 0, "graph not bipartite"
        assert is_connected(a), "graph not connected"
        # Appendix D identities (the paper's factors 1/2 and 1/4 correspond to
        # a doubled, per-orientation edge set; with each undirected edge
        # listed once they read):  D - A = M- M-^T ;  A = 1/2(M+M+^T - M-M-^T)
        m_minus = self.signed_incidence
        m_plus = self.unsigned_incidence
        np.testing.assert_allclose(
            self.degree_matrix - a, m_minus @ m_minus.T, atol=1e-5)
        np.testing.assert_allclose(
            a, 0.5 * (m_plus @ m_plus.T - m_minus @ m_minus.T), atol=1e-5)
        c = self.c_matrix
        np.testing.assert_allclose(a, c + c.T, atol=1e-5)
        # edge-list / CSR views reconstruct the same adjacency
        src, dst = self.edge_src, self.edge_dst
        assert src.shape == dst.shape == (2 * self.num_edges,)
        rebuilt = np.zeros_like(a)
        np.add.at(rebuilt, (dst, src), 1.0)
        np.testing.assert_array_equal(rebuilt, a)
        assert (np.diff(dst) >= 0).all(), "directed edges must be dst-sorted"
        offsets = self.csr_offsets
        np.testing.assert_array_equal(np.diff(offsets),
                                      self.degrees.astype(np.int64))
        table, valid = self.neighbor_table
        np.testing.assert_array_equal(valid.sum(axis=1),
                                      self.degrees.astype(np.float32))
        rebuilt_t = np.zeros_like(a)
        rows = np.repeat(np.arange(self.n), table.shape[1])
        np.add.at(rebuilt_t, (rows, table.ravel()), valid.ravel())
        np.testing.assert_array_equal(rebuilt_t, a)

    def connectivity_ratio(self) -> float:
        """p = |E| / (N(N-1)/2), the paper's density measure."""
        return self.num_edges / (self.n * (self.n - 1) / 2.0)


def is_connected(adjacency: np.ndarray) -> bool:
    n = adjacency.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(adjacency[u] > 0)[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def _finalize(n: int, edges: Sequence[Tuple[int, int]],
              head_mask: np.ndarray) -> WorkerGraph:
    edges_arr = np.asarray(sorted(set(edges)), dtype=np.int64)
    adj = np.zeros((n, n), dtype=np.float32)
    for h, t in edges_arr:
        adj[h, t] = 1.0
        adj[t, h] = 1.0
    degrees = adj.sum(axis=1).astype(np.float32)
    g = WorkerGraph(n=n, edges=edges_arr, head_mask=head_mask,
                    adjacency=adj, degrees=degrees)
    g.validate()
    return g


def chain_graph(n: int) -> WorkerGraph:
    """The original GADMM chain: worker i connected to i+1; H=even, T=odd."""
    assert n >= 2
    head_mask = (np.arange(n) % 2 == 0)
    edges = []
    for i in range(n - 1):
        h, t = (i, i + 1) if head_mask[i] else (i + 1, i)
        edges.append((h, t))
    return _finalize(n, edges, head_mask)


def complete_bipartite_graph(n_heads: int, n_tails: int) -> WorkerGraph:
    n = n_heads + n_tails
    head_mask = np.zeros(n, dtype=bool)
    head_mask[:n_heads] = True
    edges = [(h, t) for h in range(n_heads) for t in range(n_heads, n)]
    return _finalize(n, edges, head_mask)


def star_graph(n: int) -> WorkerGraph:
    """Worker 0 (head) connected to all others (tails): a 2-coloring of a star."""
    head_mask = np.zeros(n, dtype=bool)
    head_mask[0] = True
    edges = [(0, t) for t in range(1, n)]
    return _finalize(n, edges, head_mask)


def random_bipartite_graph(n: int, p: float, seed: int = 0,
                           n_heads: Optional[int] = None) -> WorkerGraph:
    """Random connected bipartite graph with connectivity ratio ~p (Sec. 7).

    Following Shi et al. (2014) / the paper's generator: target
    round(p * N(N-1)/2) edges chosen uniformly among head-tail pairs, after
    seeding a random spanning structure to guarantee connectivity. Note that
    a bipartite graph caps the achievable ratio at |H||T| / (N(N-1)/2).
    """
    assert n >= 2 and 0.0 < p <= 1.0
    rng = np.random.default_rng(seed)
    if n_heads is None:
        n_heads = n // 2
    assert 1 <= n_heads < n
    perm = rng.permutation(n)
    heads = perm[:n_heads]
    tails = perm[n_heads:]
    head_mask = np.zeros(n, dtype=bool)
    head_mask[heads] = True

    # spanning tree over the bipartite structure: connect alternating sides.
    edges = set()
    connected = [int(heads[0])]
    remaining = [int(x) for x in perm if int(x) != int(heads[0])]
    rng.shuffle(remaining)
    for v in remaining:
        # attach v to a random already-connected node of the opposite side
        opposite = [u for u in connected if head_mask[u] != head_mask[v]]
        if not opposite:
            # must attach through a 2-hop: pick any connected node w of same
            # side, then we cannot add (v, w); instead postpone v.
            remaining.append(v)
            continue
        u = int(rng.choice(opposite))
        h, t = (u, v) if head_mask[u] else (v, u)
        edges.add((int(h), int(t)))
        connected.append(v)

    target = int(round(p * n * (n - 1) / 2.0))
    all_pairs = [(int(h), int(t)) for h in heads for t in tails]
    rng.shuffle(all_pairs)
    for pair in all_pairs:
        if len(edges) >= target:
            break
        edges.add(pair)
    return _finalize(n, sorted(edges), head_mask)



def membership_graph(n: int, p: float, seed: int = 0,
                     epoch: int = 0) -> WorkerGraph:
    """Redraw the fleet's communication graph for its current membership.

    One membership epoch is one join/leave event; each epoch gets an
    independent connected bipartite graph over the surviving and joined
    workers, with ``n // 2`` heads, so a fleet that churns down to N=2
    still gets the single-edge H-T pair. The draw is a pure function of
    ``(seed, epoch, n)``, hashed through ``SeedSequence`` so consecutive
    epochs are decorrelated; the CSR and edge metadata derive lazily on the
    fresh instance.
    """
    assert n >= 2, f"fleet membership must keep >= 2 workers, got {n}"
    derived = int(np.random.SeedSequence([seed, epoch, n]).generate_state(1)[0])
    return random_bipartite_graph(n, p, seed=derived)
