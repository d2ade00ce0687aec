"""Topology backends for the consensus engine: dense, sparse and sharded.

Every place the engine touches the communication graph — the neighbor
aggregation ``A @ V`` of the primal updates, the Laplacian term
``(D - A) theta_hat`` of the dual update (Eq. 23), and the pairwise primal
residual (Eq. 28) — goes through one :class:`Topology` built from a
:class:`~repro_torch.core.graph.WorkerGraph`.

* **dense**: one ``bipartite_mix`` against the full (N, N) adjacency;
* **sparse**: one ``edge_gather_mix`` over the graph's degree-padded CSR
  table ``(N, S)``, S the largest degree: O(N·S·d) work and no (N, N)
  operand. The table is built on the host once per graph.
* **sharded**: the worker rows split over the ranks of a
  ``torch.distributed`` process group, which plays the part of the JAX
  package's worker mesh axis. Rank r holds rows ``[r·N/w, (r+1)·N/w)`` of
  every worker-axis array and its ``(N/w, N)`` adjacency row block; a mix
  runs one ``all_gather_into_tensor`` of the value rows into an (N, d)
  buffer, in rank order and in the values' storage dtype, and one
  ``bipartite_mix`` on the row block. The residuals are reduced over the
  ranks with ``all_reduce``. Without a group (none given and none
  initialised) it is a world of one with no collective, the counterpart of
  the JAX package's 1-wide mesh. NCCL carries CUDA tensors and gloo CPU
  ones; the other pairings raise.

Each mix is always its kernel on a CUDA tensor (``kernels.ops``), as the
JAX package's ``use_pallas_mix=True``; a CPU tensor takes the plain
version. (The JAX sparse backend's jnp gather/segment-sum arm, taken
without ``use_pallas_mix``, has no counterpart here.) A tree mixes through
its packed ``(N, D)`` buffer when all leaves share a dtype (one kernel call
for the whole tree), leaf-wise otherwise, as the JAX package's
``_apply_flat``. The JAX sharded backend's split of the feature axis over
the other mesh axes (``rest``) belongs to its multi-axis mesh programs and
is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import packing
from repro_torch.core import tree as T
from repro_torch.core.graph import WorkerGraph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace

BACKENDS = ("dense", "sparse", "sharded")

Tree = Any
# the collective's current name, and the one before it (torch < 2.13)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _apply_flat(fn: Callable[[torch.Tensor], torch.Tensor], a: Tree) -> Tree:
    """Apply an ``(N, d) -> (N, d)`` map to a tree: through the packed
    buffer when all leaves share a dtype, leaf-wise otherwise."""
    xs = T.leaves(a)
    if len(xs) > 1 and len({x.dtype for x in xs}) == 1:
        pk = packing.make_packing(a, (0,) * len(xs))
        buf = packing.pack(pk, a, dtype=xs[0].dtype)
        return packing.unpack(pk, fn(buf), like=a)
    return T.tree_map(
        lambda x: fn(x) if x.dim() == 2
        else fn(x.reshape(x.shape[0], -1)).reshape(x.shape), a)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Graph-structure operations behind one interface: subclasses
    implement ``_mix_flat`` on an ``(N, d)`` tensor; the tree dispatch, the
    Laplacian dual term and the residuals are shared."""

    n: int
    degrees: torch.Tensor          # (N,) float32; a row block's when sharded

    backend = "abstract"
    world = 1                      # ranks the worker rows are split over
    rank = 0                       # this process's rank among them

    def worker_rows(self, n: int) -> slice:
        """The rows of an (N, ...) worker-axis array this process holds:
        all of them, except on the sharded backend."""
        if n != self.n:
            raise ValueError(f"{n} workers, the topology has {self.n}")
        return slice(0, n)

    def gather(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows along ``dim``, in rank order (the identity
        off the sharded backend)."""
        del dim
        return local

    def all_reduce(self, value: torch.Tensor,
                   op: str = "sum") -> torch.Tensor:
        """``value`` reduced (``"sum"`` or ``"max"``) over the ranks (the
        identity off the sharded backend)."""
        del op
        return value

    def _mix_flat(self, flat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mix(self, a: Tree) -> Tree:
        """Neighbor sum per worker: out_n = sum_{m in N_n} a_m."""
        return _apply_flat(self._mix_flat, a)

    def laplacian(self, a: Tree) -> Tree:
        """``(D - A) a`` in float32, leaf-wise — the dual ascent direction
        of Eq. (23)."""
        neigh = self.mix(a)

        def f32(x):
            return x if x.dtype == torch.float32 else x.to(torch.float32)

        def one(x, nm):
            shape1 = (x.shape[0],) + (1,) * (x.dim() - 1)
            return self.degrees.reshape(shape1) * f32(x) - f32(nm)
        return T.tree_map(one, a, neigh)

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        """Pairwise primal residual sum_{(n,m) in E} ||theta_n - theta_m||²
        (Eq. 28)."""
        raise NotImplementedError

    def rebuild(self, graph: WorkerGraph) -> "Topology":
        """This backend rebuilt for a new graph (membership changed, or
        the topology was redrawn), on the same device; traced, a
        ``topology.rebuild`` span."""
        return _traced_rebuild(lambda: build(graph, self.backend,
                                             device=self.degrees.device))

    def dual_residual(self, lap: Tree) -> torch.Tensor:
        """Squared norm of a Laplacian image, summed over the tree: with
        ``lap = laplacian(theta_hat)`` this is ``||(D - A) theta_hat||²``,
        zero exactly at consensus."""
        parts = [torch.sum(torch.square(
            x if x.dtype == torch.float32 else x.to(torch.float32)))
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


@dataclasses.dataclass(frozen=True)
class ShardedTopology(DenseTopology):
    """The dense backend on this rank's ``(N/w, N)`` adjacency row block:
    one all-gather of the value rows a mix, then ``bipartite_mix`` on the
    block. ``n`` is the whole worker count, ``degrees`` the block's; every
    worker-axis operand and result holds the rank's rows only. ``group``
    None is a world of one with no collective."""

    group: Any = None
    world: int = 1
    rank: int = 0
    row0: int = 0

    backend = "sharded"

    def worker_rows(self, n: int) -> slice:
        if n != self.n:
            raise ValueError(f"{n} workers, the topology has {self.n}")
        return slice(self.row0, self.row0 + self.n // self.world)

    def gather(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.group is None:
            return local
        _check_backend(self.group, local.device)
        tr = obs_trace.span_tracer()
        if tr is not None:
            obs_trace.begin_step_span(tr, "topology.all_gather",
                                      world=self.world)
        rows = local.movedim(dim, 0).contiguous()
        out = rows.new_empty((rows.shape[0] * self.world,)
                             + tuple(rows.shape[1:]))
        _all_gather(out, rows, group=self.group)
        if tr is not None:
            obs_trace.end_step_span(tr)
        return out.movedim(0, dim)

    def all_reduce(self, value: torch.Tensor,
                   op: str = "sum") -> torch.Tensor:
        if self.group is None:
            return value
        _check_backend(self.group, value.device)
        out = value.clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return out

    def _mix_flat(self, flat: torch.Tensor) -> torch.Tensor:
        return ops.bipartite_mix(self.adjacency,
                                 self.gather(flat).contiguous())

    def primal_residual(self, theta: torch.Tensor) -> torch.Tensor:
        # the dense sum over the block's rows against every row: an edge's
        # two rows count it half each
        theta_all = self.gather(theta)
        diffs = theta[:, None, :] - theta_all[None, :, :]
        return self.all_reduce(torch.sum(
            self.adjacency * torch.sum(diffs ** 2, dim=-1)) / 2.0)

    def dual_residual(self, lap: Tree) -> torch.Tensor:
        return self.all_reduce(super().dual_residual(lap))

    def rebuild(self, graph: WorkerGraph) -> "Topology":
        return _traced_rebuild(lambda: build(
            graph, "sharded", device=self.degrees.device, group=self.group))


def _traced_rebuild(rebuild: Callable[[], Topology]) -> Topology:
    tr = obs_trace.span_tracer()
    if tr is None:
        return rebuild()
    obs_trace.begin_step_span(tr, "topology.rebuild")
    topo = rebuild()
    obs_trace.end_step_span(tr)
    return topo


def _group_world(group) -> Tuple[Any, int, int]:
    """``(group, world, rank)``: ``group`` None takes the default group
    when one is initialised, and is a world of one with no collective
    otherwise."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None, 1, 0
        group = dist.group.WORLD
    return group, dist.get_world_size(group), dist.get_rank(group)


def _check_backend(group, device: torch.device) -> None:
    """NCCL for CUDA tensors, gloo for CPU tensors: nothing is staged
    through the host."""
    want = "nccl" if device.type == "cuda" else "gloo"
    name = str(dist.get_backend(group))
    # a group over several backends names them "cpu:gloo,cuda:nccl"
    per_device = dict(part.split(":") for part in name.split(",")
                      if ":" in part)
    got = per_device.get(device.type, name)
    if got != want:
        raise ValueError(
            f"sharded topology: tensors on {device} need a {want} process "
            f"group, this one is {name}")


def build(graph: WorkerGraph, backend: str = "dense", *,
          device: Optional[Union[str, torch.device]] = None,
          group: Any = None) -> Topology:
    """Build the selected topology backend from a worker graph, with its
    arrays on ``device`` (the CUDA card unless the caller asks for the
    CPU). ``group`` is the sharded backend's process group (see
    :class:`ShardedTopology`; None takes the default one when it is
    initialised); the other backends ignore it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown mix backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "sharded":
        group, world, rank = _group_world(group)
        if graph.n % world != 0:
            raise ValueError(
                f"sharded mix needs workers ({graph.n}) divisible by the "
                f"process group's world size ({world})")
        if group is not None:
            _check_backend(group, dev)
        rows = graph.n // world
        block = slice(rank * rows, (rank + 1) * rows)
        return ShardedTopology(
            n=graph.n,
            degrees=torch.as_tensor(graph.degrees[block], dtype=torch.float32,
                                    device=dev),
            adjacency=torch.as_tensor(graph.adjacency[block],
                                      dtype=torch.float32,
                                      device=dev).contiguous(),
            group=group, world=world, rank=rank, row0=rank * rows)
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
