"""Topology backends for the consensus engine: dense and sparse.

Every place the engine touches the communication graph — the neighbor
aggregation ``A @ V`` of the primal updates, the Laplacian term
``(D - A) theta_hat`` of the dual update (Eq. 23), and the pairwise primal
residual (Eq. 28) — goes through one :class:`Topology` built from a
:class:`~repro_torch.core.graph.WorkerGraph`.

* **dense**: one ``bipartite_mix`` against the full (N, N) adjacency;
* **sparse**: one ``edge_gather_mix`` over the graph's degree-padded CSR
  table ``(N, S)``, S the largest degree: O(N·S·d) work and no (N, N)
  operand. The table is built on the host once per graph.

Each mix is always its kernel on a CUDA tensor (``kernels.ops``), as the
JAX package's ``use_pallas_mix=True``; a CPU tensor takes the plain
version. (The JAX sparse backend's jnp gather/segment-sum arm, taken
without ``use_pallas_mix``, has no counterpart here.) A tree mixes through
its packed ``(N, D)`` buffer when all leaves share a dtype (one kernel call
for the whole tree), leaf-wise otherwise, as the JAX package's
``_apply_flat``. The sharded backend is still to be ported (ROADMAP.md,
queue A item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.core.graph import WorkerGraph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

BACKENDS = ("dense", "sparse", "sharded")

Tree = Any


def _apply_flat(fn: Callable[[torch.Tensor], torch.Tensor], a: Tree) -> Tree:
    """Apply an ``(N, d) -> (N, d)`` map to a tree: through the packed
    buffer when all leaves share a dtype, leaf-wise otherwise."""
    xs = T.leaves(a)
    if len(xs) > 1 and len({x.dtype for x in xs}) == 1:
        pk = packing.make_packing(a, (0,) * len(xs))
        buf = packing.pack(pk, a, dtype=xs[0].dtype)
        return packing.unpack(pk, fn(buf), like=a)
    return T.tree_map(
        lambda x: fn(x.reshape(x.shape[0], -1)).reshape(x.shape), a)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Graph-structure operations behind one interface: subclasses
    implement ``_mix_flat`` on an ``(N, d)`` tensor; the tree dispatch, the
    Laplacian dual term and the residuals are shared."""

    n: int
    degrees: torch.Tensor          # (N,) float32

    backend = "abstract"

    def _mix_flat(self, flat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mix(self, a: Tree) -> Tree:
        """Neighbor sum per worker: out_n = sum_{m in N_n} a_m."""
        return _apply_flat(self._mix_flat, a)

    def laplacian(self, a: Tree) -> Tree:
        """``(D - A) a`` in float32, leaf-wise — the dual ascent direction
        of Eq. (23)."""
        neigh = self.mix(a)

        def one(x, nm):
            shape1 = (x.shape[0],) + (1,) * (x.dim() - 1)
            return (self.degrees.reshape(shape1) * x.to(torch.float32)
                    - nm.to(torch.float32))
        return T.tree_map(one, a, neigh)

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        """Pairwise primal residual sum_{(n,m) in E} ||theta_n - theta_m||²
        (Eq. 28)."""
        raise NotImplementedError

    def rebuild(self, graph: WorkerGraph) -> "Topology":
        """This backend rebuilt for a new graph (membership changed, or
        the topology was redrawn), on the same device."""
        return build(graph, self.backend, device=self.degrees.device)

    def dual_residual(self, lap: Tree) -> torch.Tensor:
        """Squared norm of a Laplacian image, summed over the tree: with
        ``lap = laplacian(theta_hat)`` this is ``||(D - A) theta_hat||²``,
        zero exactly at consensus."""
        parts = [torch.sum(torch.square(x.to(torch.float32)))
                 for x in T.leaves(lap)]
        return sum(parts[1:], parts[0])


@dataclasses.dataclass(frozen=True)
class DenseTopology(Topology):
    """One ``bipartite_mix`` against the full (N, N) adjacency."""

    adjacency: torch.Tensor = None  # (N, N) float32

    backend = "dense"

    def _mix_flat(self, flat: torch.Tensor) -> torch.Tensor:
        # the kernel takes row-major buffers; a batched solve on the card
        # can hand back column-major ones
        return ops.bipartite_mix(self.adjacency, flat.contiguous())

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        diffs = theta[:, None, :] - theta[None, :, :]
        return torch.sum(self.adjacency
                         * torch.sum(diffs ** 2, dim=-1)) / 2.0


@dataclasses.dataclass(frozen=True)
class SparseTopology(Topology):
    """One ``edge_gather_mix`` over the degree-padded CSR table; the
    residual sums over the undirected edge list."""

    und_head: torch.Tensor = None   # (E,) int64 undirected edge heads
    und_tail: torch.Tensor = None   # (E,) int64 undirected edge tails
    nbr_table: torch.Tensor = None  # (N, S) int32 neighbor ids
    nbr_valid: torch.Tensor = None  # (N, S) float32 1/0 slot validity

    backend = "sparse"

    def _mix_flat(self, flat: torch.Tensor) -> torch.Tensor:
        return ops.edge_gather_mix(flat, self.nbr_table,
                                   self.nbr_valid).to(flat.dtype)

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        t32 = theta.to(torch.float32)
        diff = (t32.index_select(0, self.und_head)
                - t32.index_select(0, self.und_tail))
        return torch.sum(torch.square(diff))


def build(graph: WorkerGraph, backend: str = "dense", *,
          device: Optional[Union[str, torch.device]] = None) -> Topology:
    """Build the selected topology backend from a worker graph, with its
    arrays on ``device`` (the CUDA card unless the caller asks for the
    CPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown mix backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "sharded":
        raise NotImplementedError(
            "the 'sharded' topology backend is not ported yet "
            "(ROADMAP.md queue A item 14)")
    dev = resolve_device(device)
    degrees = torch.as_tensor(graph.degrees, dtype=torch.float32, device=dev)
    if backend == "sparse":
        edges = np.asarray(graph.edges, dtype=np.int64)
        table, valid = graph.neighbor_table
        return SparseTopology(
            n=graph.n, degrees=degrees,
            und_head=torch.as_tensor(np.ascontiguousarray(edges[:, 0]),
                                     device=dev),
            und_tail=torch.as_tensor(np.ascontiguousarray(edges[:, 1]),
                                     device=dev),
            nbr_table=torch.as_tensor(table, device=dev).contiguous(),
            nbr_valid=torch.as_tensor(valid, device=dev).contiguous())
    return DenseTopology(
        n=graph.n, degrees=degrees,
        adjacency=torch.as_tensor(graph.adjacency, dtype=torch.float32,
                                  device=dev).contiguous())
