"""Topology backends for the consensus engine: the dense backend.

Every place the engine touches the communication graph — the neighbor
aggregation ``A @ V`` of the primal updates, the Laplacian term
``(D - A) theta_hat`` of the dual update (Eq. 23), and the pairwise primal
residual (Eq. 28) — goes through one :class:`Topology` built from a
:class:`~repro_torch.core.graph.WorkerGraph`.

The port has the dense backend only. Its mix is always the
``bipartite_mix`` kernel on a CUDA tensor (``kernels.ops``), as the JAX
package's ``use_pallas_mix=True``; a CPU tensor takes the plain version.
The sparse and sharded backends are still to be ported (ROADMAP.md, queue
A items 9 and 14).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.graph import WorkerGraph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

BACKENDS = ("dense", "sparse", "sharded")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Graph-structure operations behind one interface: subclasses
    implement ``mix`` on an ``(N, d)`` tensor; the Laplacian dual term and
    the residuals are shared."""

    n: int
    degrees: torch.Tensor          # (N,) float32

    backend = "abstract"

    def mix(self, a: torch.Tensor) -> torch.Tensor:
        """Neighbor sum per worker: out_n = sum_{m in N_n} a_m."""
        raise NotImplementedError

    def laplacian(self, a: torch.Tensor) -> torch.Tensor:
        """``(D - A) a`` in float32 — the dual ascent direction of
        Eq. (23)."""
        neigh = self.mix(a)
        return (self.degrees[:, None] * a.to(torch.float32)
                - neigh.to(torch.float32))

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        """Pairwise primal residual sum_{(n,m) in E} ||theta_n - theta_m||²
        (Eq. 28)."""
        raise NotImplementedError

    def dual_residual(self, lap: torch.Tensor) -> torch.Tensor:
        """Squared norm of a Laplacian image: with ``lap =
        laplacian(theta_hat)`` this is ``||(D - A) theta_hat||²``, zero
        exactly at consensus."""
        return torch.sum(torch.square(lap.to(torch.float32)))


@dataclasses.dataclass(frozen=True)
class DenseTopology(Topology):
    """One ``bipartite_mix`` against the full (N, N) adjacency."""

    adjacency: torch.Tensor = None  # (N, N) float32

    backend = "dense"

    def mix(self, a: torch.Tensor) -> torch.Tensor:
        # the kernel takes row-major buffers; a batched solve on the card
        # can hand back column-major ones
        return ops.bipartite_mix(self.adjacency, a.contiguous())

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        diffs = theta[:, None, :] - theta[None, :, :]
        return torch.sum(self.adjacency
                         * torch.sum(diffs ** 2, dim=-1)) / 2.0


def build(graph: WorkerGraph, backend: str = "dense", *,
          device: Optional[Union[str, torch.device]] = None) -> Topology:
    """Build the selected topology backend from a worker graph, with its
    arrays on ``device`` (the CUDA card unless the caller asks for the
    CPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown mix backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend != "dense":
        raise NotImplementedError(
            f"the {backend!r} topology backend is not ported yet "
            f"(ROADMAP.md queue A: sparse is item 9, sharded item 14)")
    dev = resolve_device(device)
    return DenseTopology(
        n=graph.n,
        degrees=torch.as_tensor(graph.degrees, dtype=torch.float32,
                                device=dev),
        adjacency=torch.as_tensor(graph.adjacency, dtype=torch.float32,
                                  device=dev).contiguous())
