"""CQ-GGADMM consensus engine over parameter trees (paper Algorithms 1
and 2).

The port of ``repro.core.engine``: GGADMM / C-GGADMM / Q-GGADMM /
CQ-GGADMM and the Jacobian C-ADMM baseline, over a tree of per-worker
parameters (a flat ``(N, d)`` tensor is the one-leaf tree; a language
model's parameters are a nested dict, ``core/tree.py``). Per iteration,
over the leading worker axis N:

  phase 1 (heads):  theta_H <- local argmin of the augmented Lagrangian
                    quantize (grouped) -> candidate, censor -> theta_hat_H
  phase 2 (tails):  same, neighbors see the fresh head theta_hat
  dual:             alpha += rho * (D - A) theta_hat            (Eq. 23)

Quantizer side information ``(R, b, Δ)`` is ``(N, G)``, G the number of
quantization groups of ``EngineConfig.groups`` (``"model"``, ``"leaf"``,
``"block:..."``, ``"auto:K"``, explicit ids, index buckets;
:func:`resolve_groups`). A one-leaf tree quantizes through the
``stoch_quantize`` kernel (G=1). A multi-leaf tree is packed into one
``(N, D)`` buffer (``core/packing.py``) and quantized by ONE
``stoch_quantize_grouped_fused`` call (or its D-tiled twin with
``REPRO_QUANT_TILE_D``); :func:`grouped_quantize_step_twopass` computes the
ranges in a separate pass and calls ``stoch_quantize_grouped``, with the
same values. Every neighbour mix is one call of the topology's kernel on the
packed buffer (``core/topology.py``): ``bipartite_mix`` for the dense
backend, ``edge_gather_mix`` for the sparse one. On a CPU tensor each kernel
entry point runs its plain version (``kernels/ops.py``).

Local solvers: :class:`ExactSolver` (closed form / Newton on a flat
problem) and :class:`InexactSolver` (K Adam or SGD steps on the augmented
Lagrangian, for neural models). The inexact solver runs only the rows of
the acting phase's workers: rows are independent, so this gives the values
of the JAX package's solve-all-then-select. So does an exact solver over
the linear problem, whose systems stand while the graph does: each phase
factors its rows' systems once a step function and applies the factor
(``ExactSolver.factors``).

The stochastic-rounding uniforms are ``(N, D)`` per phase, from
``draw(phase)``; ``run(seed=...)`` draws them from a ``torch.Generator``,
``run(uniforms=...)`` injects them (a test feeds the JAX package's draws).

The step takes the fleet's ``participation`` mask (``fleet/sim.py``): a
timed-out worker is composed into the censor decision.

``hat_dtype`` ("bfloat16", "float16" or "float32") narrows the replicas
``theta_hat``, ``alpha`` and ``q_hat`` to that storage; ``theta`` and the
optimizer moments keep theirs. Every quantity computed from a replica is
computed in float32 (the censor diff, the solver's ``v``, the dual update,
the quantizer range) and rounded once where it is stored. The mixes read
the narrowed buffer as it is (``bipartite_mix`` returns its dtype,
``edge_gather_mix`` float32), and the fused grouped round reads and writes
a narrowed ``q_hat`` itself; the one-leaf and two-pass quantize paths work
on float32 copies, as the JAX engine's casts do.

On the sharded topology (``mix_backend="sharded"``, ``core/topology.py``)
each rank of a ``torch.distributed`` group holds the rows
``[r·N/w, (r+1)·N/w)`` of every worker-axis quantity: theta, the replicas,
the duals, the quantizer state, the optimizer moments, the batch and the
solver's data. Every per-worker operation runs on those rows as it is;
only the mixes (one all-gather each), the residuals and the metrics'
reductions over workers cross ranks. Per-worker metrics are the rank's
rows; :func:`gather_workers` collects every row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import censoring as censor_lib
from repro_torch.core import packing
from repro_torch.core import quantization as quant_lib
from repro_torch.core import topology as topo_lib
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import WorkerGraph
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace

_EPS = 1e-12

Tree = Any
Metrics = Dict[str, torch.Tensor]
MetricsFn = Callable[["EngineState", Any], Metrics]
Uniforms = Callable[[int, int], torch.Tensor]   # (iteration, phase) -> (N, D)
GroupSpec = Union[str, Tuple]
GroupSpecError = packing.GroupSpecError
# the storage types ``EngineConfig.hat_dtype`` names
HAT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": torch.float32}


# --------------------------------------------------------- tree helpers --
def tree_dim(a: Tree) -> int:
    """Total model dimension d per worker."""
    return sum(int(x.numel() // x.shape[0]) for x in T.leaves(a))


def tree_worker_sqnorm(a: Tree) -> torch.Tensor:
    """Per-worker squared norm over all leaves: (N,)."""
    parts = [torch.sum(torch.square(x.to(torch.float32)).reshape(
        x.shape[0], -1), dim=-1) for x in T.leaves(a)]
    return sum(parts[1:], parts[0])


def tree_where_worker(mask: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Select a_n where mask_n > 0 else b_n, leaf-wise."""
    def sel(x, y):
        m = mask.reshape((mask.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(m > 0, x, y)
    return T.tree_map(sel, a, b)


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``; ``x`` itself, with no call into torch, where it
    is already (the step's host time is mostly such calls)."""
    return x if x.dtype == dtype else x.to(dtype)


def _rows2d(x: torch.Tensor) -> torch.Tensor:
    """An (N, ...) leaf as (N, d); a leaf that is (N, d) already is
    returned as it is (no view op for the step to dispatch)."""
    return x if x.dim() == 2 else x.reshape(x.shape[0], -1)


class _Constants:
    """The host constants a step reads, copied to the device once per
    :func:`make_step` (per run) instead of every call: the censor decay
    ``xi``, the schedule's ln 2 and the per-group dims tuples."""

    def __init__(self, cfg: "EngineConfig", device: torch.device):
        self.device = device
        self.xi = torch.tensor(cfg.censor.xi, dtype=torch.float32,
                               device=device)
        self.ln2 = quant_lib.ln2_on(device)
        self._dims: Dict[Tuple[int, ...], torch.Tensor] = {}

    def dims(self, group_dims: Sequence[int]) -> torch.Tensor:
        """``group_dims`` as a (G,) float32 tensor on the device."""
        key = tuple(int(d) for d in group_dims)
        if key not in self._dims:
            self._dims[key] = torch.as_tensor(key, dtype=torch.float32,
                                              device=self.device)
        return self._dims[key]


# ------------------------------------------------------- group resolution --
def resolve_groups(theta: Tree, groups: GroupSpec) -> Tuple[int, ...]:
    """Leaf index -> group id, aligned with the sorted leaf order (the JAX
    package's grammar; see ``core/packing.py``)."""
    n_leaves = len(T.leaves(theta))
    if isinstance(groups, str):
        if groups == "model":
            return (0,) * n_leaves
        if groups == "leaf":
            return tuple(range(n_leaves))
        packing.validate_spec_syntax(groups)
        if groups.startswith("block:"):
            return packing.resolve_block_groups(
                theta, packing.parse_block_spec(groups))
        return packing.resolve_auto_groups(theta,
                                           packing.parse_auto_spec(groups))
    nested = [isinstance(g, (tuple, list)) for g in groups]
    if groups and all(nested):
        return packing.resolve_index_buckets(theta, groups)
    if any(nested):
        raise GroupSpecError(
            f"mixed tuple spec {groups!r}: use either a flat leaf->group "
            f"id tuple like (0, 0, 1) or index buckets like ((0, 1), (2,))"
            f" — not both")
    ids = tuple(int(g) for g in groups)
    if len(ids) != n_leaves:
        raise GroupSpecError(f"group spec covers {len(ids)} leaves, "
                             f"tree has {n_leaves}")
    n_groups = max(ids) + 1
    if set(ids) != set(range(n_groups)):
        raise GroupSpecError(
            f"group ids must be contiguous 0..G-1, got {ids}")
    return ids


def group_dims(theta: Tree, group_ids: Sequence[int]) -> Tuple[int, ...]:
    """Per-group parameter counts d_g."""
    dims = [0] * (max(group_ids) + 1)
    for leaf, g in zip(T.leaves(theta), group_ids):
        dims[g] += int(leaf.numel() // leaf.shape[0])
    return tuple(dims)


def n_groups_of(theta: Tree, groups: GroupSpec) -> int:
    return max(resolve_groups(theta, groups)) + 1


# ------------------------------------------------------------- config --
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Hyperparameters of the stepper: the JAX ``EngineConfig``'s fields
    and defaults. ``use_pallas_mix``/``use_pallas_quant`` are kept so a
    config reads the same in both packages; the port always routes a CUDA
    tensor through its kernels."""

    rho: float = 1.0
    alternating: bool = True          # GADMM grouping; False => Jacobian ADMM
    censor: CensorConfig = dataclasses.field(default_factory=CensorConfig)
    quantize: Optional[QuantConfig] = None
    groups: GroupSpec = "model"       # "model"|"leaf"|"block:..."|"auto:K"|
    #                                   explicit ids | index buckets
    censor_mode: str = "global"       # "global" (paper) | "group"
    mix_backend: str = "dense"        # "dense" | "sparse" | "sharded"
    use_pallas_mix: bool = False
    use_pallas_quant: bool = False
    hat_dtype: Optional[str] = None   # narrow theta_hat/q_hat/alpha replicas
    regroup_every: int = 0            # auto:K re-clustering period (0 = off)

    def __post_init__(self):
        if self.censor_mode not in ("global", "group"):
            raise ValueError(f"censor_mode must be 'global' or 'group', got "
                             f"{self.censor_mode!r}")
        if self.mix_backend not in topo_lib.BACKENDS:
            raise ValueError(f"unknown mix backend {self.mix_backend!r}")
        if isinstance(self.groups, str):
            packing.validate_spec_syntax(self.groups)
        if self.hat_dtype is not None and self.hat_dtype not in HAT_DTYPES:
            raise ValueError(f"hat_dtype must be one of {sorted(HAT_DTYPES)}"
                             f" or None, got {self.hat_dtype!r}")
        if self.regroup_every < 0:
            raise ValueError(f"regroup_every must be >= 0, "
                             f"got {self.regroup_every}")

    @property
    def name(self) -> str:
        if not self.alternating:
            return "c-admm" if self.censor.enabled else "jacobian-admm"
        tag = "ggadmm"
        if self.censor.enabled:
            tag = "c-" + tag
        if self.quantize is not None:
            tag = ("cq-" + tag[2:]) if tag.startswith("c-") else "q-" + tag
        return tag


# -------------------------------------------------------------- state --
@dataclasses.dataclass(frozen=True)
class GroupQuantState:
    """Quantizer state: ``q_hat`` mirrors the parameter tree (the
    receivers' replica); ``(R, b, Δ)`` and the first-round flag are (N, G)
    float32."""

    q_hat: Tree
    range_prev: torch.Tensor
    bits_prev: torch.Tensor
    delta_prev: torch.Tensor
    initialized: torch.Tensor

    @property
    def n_groups(self) -> int:
        return int(self.range_prev.shape[-1])

    @staticmethod
    def create(theta: Tree, n_groups: int = 1, b0: int = 2,
               hat_dtype: Optional[torch.dtype] = None) -> "GroupQuantState":
        first = T.leaves(theta)[0]
        n = first.shape[0]
        side = dict(dtype=torch.float32, device=first.device)
        return GroupQuantState(
            q_hat=T.tree_map(
                lambda x: torch.zeros_like(x, dtype=hat_dtype or x.dtype),
                theta),
            range_prev=torch.zeros((n, n_groups), **side),
            bits_prev=torch.full((n, n_groups), float(b0), **side),
            delta_prev=torch.zeros((n, n_groups), **side),
            initialized=torch.zeros((n, n_groups), **side),
        )


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Every per-worker quantity with leading axis N. ``opt_mu``/``opt_nu``
    are the inexact solver's moments (empty tuples for exact solvers);
    ``k`` is the iteration counter."""

    theta: Tree          # per-worker primal theta_n^k
    theta_hat: Tree      # last *transmitted* value per worker
    alpha: Tree          # duals alpha_n^k
    quant: GroupQuantState
    opt_mu: Tree = ()
    opt_nu: Tree = ()
    k: int = 0


def init_state(theta: Tree, cfg: EngineConfig,
               solver: Optional[Any] = None) -> EngineState:
    """Engine state from per-worker initial parameters (leading axis N);
    the replicas in ``cfg.hat_dtype`` when it is set."""
    qcfg = cfg.quantize or QuantConfig()
    hat_dtype = HAT_DTYPES[cfg.hat_dtype] if cfg.hat_dtype else None
    mu, nu = solver.init_opt(theta) if solver is not None else ((), ())

    def hat_zeros(x):
        return torch.zeros_like(x, dtype=hat_dtype or x.dtype)

    return EngineState(
        theta=theta,
        theta_hat=T.tree_map(hat_zeros, theta),
        alpha=T.tree_map(hat_zeros, theta),  # alpha^0 in col(M_-)
        quant=GroupQuantState.create(theta, n_groups_of(theta, cfg.groups),
                                     b0=qcfg.b0, hat_dtype=hat_dtype),
        opt_mu=mu, opt_nu=nu, k=0,
    )


# --------------------------------------------------------- quantizers --
def grouped_quantize_step(
    state: GroupQuantState, theta: Tree, uniforms: torch.Tensor,
    cfg: QuantConfig, group_ids: Sequence[int],
    consts: Optional[_Constants] = None,
) -> Tuple[GroupQuantState, Tree, torch.Tensor, torch.Tensor]:
    """One grouped stochastic-quantization round (Eqs. 14-20, group-wise).
    One leaf: the unfused ``stoch_quantize`` path; more leaves: one fused
    call on the packed buffer. ``uniforms`` is (N, D). Returns
    ``(new_state, candidate, bits (N, G), payload (N,))`` with payload
    = sum_g b_g d_g + G * overhead. ``consts`` holds the step's device
    constants (None copies them from the host)."""
    if len(T.leaves(theta)) == 1:
        return grouped_quantize_step_unfused(state, theta, uniforms, cfg,
                                             consts=consts)
    return _grouped_quantize_step_packed(state, theta, uniforms, cfg,
                                         group_ids, consts)


def grouped_quantize_step_unfused(
    state: GroupQuantState, theta: Tree,
    uniforms: Union[torch.Tensor, Sequence[torch.Tensor]], cfg: QuantConfig,
    group_ids: Optional[Sequence[int]] = None,
    consts: Optional[_Constants] = None,
) -> Tuple[GroupQuantState, Tree, torch.Tensor, torch.Tensor]:
    """The per-leaf loop: one ``ops.stoch_quantize`` call per leaf, with
    the (N, G) ranges reduced per group first. A one-leaf tree at G=1 takes
    this path (the seed stepper's, bit for bit); for a multi-leaf tree it
    is the dispatch baseline the fused path is timed against
    (``bench/engine.py``). ``uniforms`` is the (N, D) draw of a one-leaf
    tree or one draw per leaf in leaf order (each the leaf's shape or
    ``(N, d_leaf)``), as the JAX package draws one per leaf; ``group_ids``
    defaults to one group. A worker whose group range is degenerate
    (nothing moved) keeps its old reconstruction there."""
    leaves = T.leaves(theta)
    q_leaves = T.leaves(state.q_hat)
    draws = [uniforms] if torch.is_tensor(uniforms) else list(uniforms)
    if len(draws) != len(leaves):
        raise ValueError(f"{len(draws)} uniform draws for {len(leaves)} "
                         f"leaves")
    ids = tuple(group_ids) if group_ids is not None else (0,) * len(leaves)
    flats = [_as(_rows2d(t), torch.float32) for t in leaves]
    qs = [_as(_rows2d(q), torch.float32) for q in q_leaves]
    maxabs = [torch.amax(torch.abs(f - q), dim=-1) for f, q in zip(flats, qs)]
    cols = []
    for g in range(state.n_groups):
        members = [maxabs[i] for i, gi in enumerate(ids) if gi == g]
        cols.append(members[0] if len(members) == 1
                    else torch.amax(torch.stack(members), dim=0))
    range_new = (cols[0][:, None] if len(cols) == 1
                 else torch.stack(cols, dim=1))                   # (N, G)
    bits, delta, degen = quant_lib.bit_schedule(
        state.bits_prev, range_new, state.range_prev, state.initialized,
        cfg.omega, cfg.b0, cfg.b_max,
        ln2=consts.ln2 if consts is not None else None)
    new_leaves = []
    for f, q, u, q_leaf, g in zip(flats, qs, draws, q_leaves, ids):
        fresh = ops.stoch_quantize(
            f.contiguous(), q.contiguous(), _rows2d(u).contiguous(),
            delta[:, g].contiguous(), range_new[:, g].contiguous())
        keep = degen if state.n_groups == 1 else degen[:, g:g + 1]
        out = _as(torch.where(keep, q, fresh), q_leaf.dtype)
        new_leaves.append(out if out.shape == q_leaf.shape
                          else out.reshape(q_leaf.shape))
    q_hat_new = T.unflatten(state.q_hat, new_leaves)
    new_state = GroupQuantState(
        q_hat=q_hat_new,
        range_prev=torch.where(degen, state.range_prev, range_new),
        bits_prev=bits,
        delta_prev=torch.where(degen, state.delta_prev, delta),
        initialized=torch.ones_like(state.initialized),
    )
    # sum_g b_g d_g with the d_g as host scalars: no host-to-device copy
    # (a synchronisation) on the one-leaf hot path
    terms = [bits[:, g] * float(d)
             for g, d in enumerate(group_dims(theta, ids))]
    payload = sum(terms[1:], terms[0]) + float(state.n_groups
                                               * cfg.b_overhead)
    return new_state, q_hat_new, bits, payload


def _finish_packed_step(state: GroupQuantState, pk: packing.Packing,
                        out: torch.Tensor, range_new: torch.Tensor,
                        bits: torch.Tensor, delta: torch.Tensor,
                        cfg: QuantConfig,
                        consts: Optional[_Constants] = None):
    """Shared tail of the packed paths: degenerate-group state carry,
    unpack (views into ``out``), payload accounting; all (N, G)-sized."""
    degen = range_new <= _EPS
    q_hat_new = packing.unpack(pk, out, like=state.q_hat)
    new_state = GroupQuantState(
        q_hat=q_hat_new,
        range_prev=torch.where(degen, state.range_prev, range_new),
        bits_prev=bits,
        delta_prev=torch.where(degen, state.delta_prev, delta),
        initialized=torch.ones_like(state.initialized),
    )
    dims_arr = consts.dims(pk.group_dims) if consts is not None else \
        torch.as_tensor(pk.group_dims, dtype=torch.float32, device=bits.device)
    payload = torch.sum(bits * dims_arr[None, :], dim=-1) \
        + float(pk.n_groups * cfg.b_overhead)
    return new_state, q_hat_new, bits, payload


def _grouped_quantize_step_packed(
    state: GroupQuantState, theta: Tree, uniforms: torch.Tensor,
    cfg: QuantConfig, group_ids: Sequence[int],
    consts: Optional[_Constants] = None,
) -> Tuple[GroupQuantState, Tree, torch.Tensor, torch.Tensor]:
    """The whole grouped round (range reduction, Eq. (18) schedule,
    quantize, degenerate passthrough) in one ``stoch_quantize_grouped_fused``
    call on the packed buffer. ``q_hat`` is packed in its own storage dtype
    when its leaves share one (the kernel reads and writes it narrowed), so
    ``out`` unpacks without a cast."""
    pk = packing.make_packing(theta, group_ids)
    theta_p = packing.pack(pk, theta)                     # (N, D) f32
    q_dtypes = {q.dtype for q in T.leaves(state.q_hat)}
    qprev_p = packing.pack(pk, state.q_hat, dtype=q_dtypes.pop()
                           if len(q_dtypes) == 1 else torch.float32)
    out, range_new, bits, delta = ops.stoch_quantize_grouped_fused(
        theta_p, qprev_p, uniforms.contiguous(),
        state.bits_prev.contiguous(), state.range_prev.contiguous(),
        state.initialized.contiguous(), None, group_runs=pk.group_runs,
        omega=cfg.omega, b0=cfg.b0, b_max=cfg.b_max)
    return _finish_packed_step(state, pk, out, range_new, bits, delta, cfg,
                               consts)


def grouped_quantize_step_twopass(
    state: GroupQuantState, theta: Tree, uniforms: torch.Tensor,
    cfg: QuantConfig, group_ids: Sequence[int],
) -> Tuple[GroupQuantState, Tree, torch.Tensor, torch.Tensor]:
    """The pre-fusion packed path: the (N, G) ranges in a separate
    ``segment_maxabs`` pass, the schedule in plain PyTorch, then one
    ``stoch_quantize_grouped`` call. Value-identical to the fused path."""
    pk = packing.make_packing(theta, group_ids)
    theta_p = packing.pack(pk, theta)
    qprev_p = packing.pack(pk, state.q_hat)
    range_new = packing.segment_maxabs(pk, theta_p - qprev_p)    # (N, G)
    bits, delta, degen = quant_lib.bit_schedule(
        state.bits_prev, range_new, state.range_prev, state.initialized,
        cfg.omega, cfg.b0, cfg.b_max)
    out = ops.stoch_quantize_grouped(
        theta_p, qprev_p, uniforms.contiguous(), delta.contiguous(),
        range_new.contiguous(), None, group_runs=pk.group_runs)
    # degenerate groups (nothing moved): keep the old reconstruction, run
    # by run (the JAX package selects through the (D,) column map)
    for g, runs in enumerate(pk.group_runs):
        keep = degen[:, g:g + 1]
        for off, size in runs:
            out[:, off:off + size] = torch.where(
                keep, qprev_p[:, off:off + size], out[:, off:off + size])
    return _finish_packed_step(state, pk, out, range_new, bits, delta, cfg)


def identity_quantize_step(
    state: GroupQuantState, theta: Tree,
) -> Tuple[GroupQuantState, Tree, torch.Tensor, torch.Tensor]:
    """Unquantized pass-through with 32-bit payload accounting (GGADMM)."""
    n = state.range_prev.shape[0]
    new_state = dataclasses.replace(
        state, q_hat=T.tree_map(lambda t, q: t.to(q.dtype), theta,
                                state.q_hat),
        initialized=torch.ones_like(state.initialized))
    bits = torch.full_like(state.bits_prev, 32.0)
    payload = torch.full((n,), 32.0 * tree_dim(theta), dtype=torch.float32,
                         device=bits.device)
    return new_state, theta, bits, payload


# ------------------------------------------------------------ solvers --
def _flatten_worker(tree: Tree) -> torch.Tensor:
    if torch.is_tensor(tree) and tree.dim() == 2:
        return tree
    xs = T.leaves(tree)
    pk = packing.make_packing(tree, (0,) * len(xs))
    return packing.pack(pk, tree, dtype=xs[0].dtype)


def _unflatten_worker(flat: torch.Tensor, like: Tree) -> Tree:
    if (torch.is_tensor(like) and like.dim() == 2
            and flat.dtype == like.dtype):
        return flat
    pk = packing.make_packing(like, (0,) * len(T.leaves(like)))
    return packing.unpack(pk, flat, like=like)


@dataclasses.dataclass(frozen=True)
class ExactSolver:
    """A flat ``primal_solve(v, rho_d, theta_init)`` problem (closed form or
    Newton, ``core/solvers.py``) as the engine's local solver. The tree is
    raveled per worker; for an (N, d) tensor that is the identity.

    A problem whose systems do not depend on theta or v (it has
    ``factor(quad, rows)`` and ``solve_factored(factor, rows, v_rows)``,
    the linear problem's) :attr:`factors`: the engine then factors each
    phase's systems once a step function and applies the factor to the
    phase's rows (:meth:`solve_rows`)."""

    problem: Any

    def init_opt(self, theta: Tree):
        del theta
        return (), ()

    @property
    def factors(self) -> bool:
        return hasattr(self.problem, "factor")

    def solve(self, theta0, v, quad, mu, nu, batch=None):
        del batch
        flat = self.problem.primal_solve(
            _flatten_worker(v), quad, theta_init=_flatten_worker(theta0))
        return _unflatten_worker(flat, theta0), mu, nu

    def solve_rows(self, factor, rows: torch.Tensor, v: Tree,
                   theta: Tree) -> Tree:
        """``theta`` with workers ``rows`` set to their solve for ``v``
        from ``factor`` (the problem's ``factor(quad, rows)``); the other
        rows as they are."""
        flat = self.problem.solve_factored(
            factor, rows, _flatten_worker(v).index_select(0, rows))
        if not (torch.is_tensor(theta) and theta.dim() == 2):
            return T.put_rows(theta, rows, _unflatten_worker(
                flat, T.take_rows(theta, rows)))
        # in the layout a solve of every row leaves theta in (that of
        # torch.linalg.solve's batch of vectors: the worker axis innermost),
        # so that the reductions over theta (the primal residual) round as
        # they do there
        out = torch.empty_strided(theta.shape, (1, theta.shape[0]),
                                  dtype=theta.dtype, device=theta.device)
        return out.copy_(theta).index_copy_(0, rows, _as(flat, theta.dtype))


@dataclasses.dataclass(frozen=True)
class InexactSolver:
    """K Adam (or SGD) steps on g(theta) = f(theta) + <theta, v> +
    quad/2 ||theta||^2, the inexact-ADMM local solver for non-convex f_n.
    ``grad_fn(theta, batch)`` returns the per-worker gradient tree. The
    moments persist across outer iterations while the bias correction
    restarts at t = i + 1 on every call, as in the JAX package."""

    grad_fn: Optional[Callable[[Tree, Any], Tree]] = None
    local_steps: int = 4
    local_lr: float = 1e-3
    use_adam: bool = True
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    # rows are independent: the engine hands over only the acting workers
    per_worker = True

    def init_opt(self, theta: Tree):
        if not self.use_adam:
            return (), ()
        zeros = T.tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), theta)
        return zeros, T.tree_map(torch.clone, zeros)

    def _aug_grad(self, th, v, quad, batch):
        g = self.grad_fn(th, batch)

        def one(gl, thl, vl):
            shape1 = (thl.shape[0],) + (1,) * (thl.dim() - 1)
            return (gl.to(torch.float32) + vl.to(torch.float32)
                    + quad.reshape(shape1) * thl.to(torch.float32))
        return T.tree_map(one, g, th, v)

    def solve(self, theta0, v, quad, mu0, nu0, batch):
        th = theta0
        if not self.use_adam:                      # plain SGD, no moments
            for _ in range(self.local_steps):
                g = self._aug_grad(th, v, quad, batch)
                th = T.tree_map(lambda p, gl: (p.to(torch.float32)
                                               - self.local_lr * gl
                                               ).to(p.dtype), th, g)
            return th, mu0, nu0
        b1, b2, eps, lr = self.b1, self.b2, self.eps, self.local_lr
        mu, nu = mu0, nu0
        for i in range(self.local_steps):
            g = self._aug_grad(th, v, quad, batch)
            t = np.float32(i + 1.0)                # float32, as the fori_loop
            b1c = float(np.float32(1.0) - np.power(np.float32(b1), t))
            b2c = float(np.float32(1.0) - np.power(np.float32(b2), t))
            new_th, new_mu, new_nu = [], [], []
            for p, gl, m, vv in zip(T.leaves(th), T.leaves(g), T.leaves(mu),
                                    T.leaves(nu)):
                m_new = b1 * m + (1 - b1) * gl
                v_new = b2 * vv + (1 - b2) * torch.square(gl)
                step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + eps)
                new_th.append((p.to(torch.float32) - lr * step).to(p.dtype))
                new_mu.append(m_new)
                new_nu.append(v_new)
            th = T.unflatten(th, new_th)
            mu = T.unflatten(mu, new_mu)
            nu = T.unflatten(nu, new_nu)
        return th, mu, nu


# -------------------------------------------------------- auto-grouping --
def leaf_log_ranges(theta: Tree, q_hat: Tree,
                    topology: Optional[topo_lib.Topology] = None
                    ) -> np.ndarray:
    """Per-leaf log2 quantizer range: max over workers and coordinates of
    ``|theta - q_hat|`` per leaf, floored at 2^-40 (host numpy, (L,)). On
    a sharded ``topology`` the max runs over every rank's workers, so every
    rank reads the same values."""
    vals = torch.stack([torch.amax(torch.abs(t.to(torch.float32)
                                             - q.to(torch.float32)))
                        for t, q in zip(T.leaves(theta), T.leaves(q_hat))])
    if topology is not None:
        vals = topology.all_reduce(vals, op="max")
    vals = vals.cpu().numpy().astype(np.float64)
    return np.log2(np.maximum(vals, 2.0 ** -40))


def remap_group_state(quant: GroupQuantState, old_ids: Sequence[int],
                      new_ids: Sequence[int]) -> GroupQuantState:
    """Carry the (N, G) quantizer state across a regroup event: each new
    group takes the max range/bits/delta and the min ``initialized`` of the
    old groups its leaves came from; ``q_hat`` is untouched."""
    old_ids = tuple(int(g) for g in old_ids)
    new_ids = tuple(int(g) for g in new_ids)
    if len(old_ids) != len(new_ids):
        raise ValueError(f"remap across different trees: {len(old_ids)} "
                         f"vs {len(new_ids)} leaves")
    if old_ids == new_ids:
        return quant
    cols_r, cols_b, cols_d, cols_i = [], [], [], []
    for g in range(max(new_ids) + 1):
        olds = sorted({old_ids[i] for i, ng in enumerate(new_ids)
                       if ng == g})
        idx = torch.as_tensor(olds, dtype=torch.int64,
                              device=quant.range_prev.device)
        cols_r.append(torch.amax(quant.range_prev[:, idx], dim=1))
        cols_b.append(torch.amax(quant.bits_prev[:, idx], dim=1))
        cols_d.append(torch.amax(quant.delta_prev[:, idx], dim=1))
        cols_i.append(torch.amin(quant.initialized[:, idx], dim=1))
    return GroupQuantState(
        q_hat=quant.q_hat,
        range_prev=torch.stack(cols_r, dim=1),
        bits_prev=torch.stack(cols_b, dim=1),
        delta_prev=torch.stack(cols_d, dim=1),
        initialized=torch.stack(cols_i, dim=1),
    )


@dataclasses.dataclass
class AutoGrouper:
    """Host-side re-clustering for ``groups="auto:K"``: an EMA of
    per-leaf log2 ranges and, every ``regroup_every`` rounds, the greedy
    adjacent-merge clustering (``packing.greedy_range_grouping``)."""

    k: int
    regroup_every: int
    ema: float = 0.5
    log_ranges: Optional[np.ndarray] = None

    @staticmethod
    def from_config(cfg: EngineConfig) -> Optional["AutoGrouper"]:
        if (isinstance(cfg.groups, str) and cfg.groups.startswith("auto:")
                and cfg.regroup_every > 0):
            return AutoGrouper(k=packing.parse_auto_spec(cfg.groups),
                               regroup_every=cfg.regroup_every)
        return None

    def should_regroup(self, step_idx: int) -> bool:
        return (self.regroup_every > 0 and step_idx > 0
                and step_idx % self.regroup_every == 0)

    def regroup(self, theta: Tree, q_hat: Tree,
                topology: Optional[topo_lib.Topology] = None
                ) -> Tuple[int, ...]:
        """The new leaf -> group ids; on a sharded ``topology`` decided
        from every rank's workers, so all ranks pick the same groups."""
        stats = leaf_log_ranges(theta, q_hat, topology)
        if self.log_ranges is None:
            self.log_ranges = stats
        else:
            self.log_ranges = (self.ema * self.log_ranges
                               + (1.0 - self.ema) * stats)
        return packing.greedy_range_grouping(self.log_ranges,
                                             packing.leaf_dims(theta), self.k)


# -------------------------------------------------------------- steps --
# the per-worker metrics of a step, in the order the step returns them
METRIC_KEYS = ("tx_mask", "payload_bits", "candidate_payload_bits",
               "bits_per_group", "group_tx", "censor_mask",
               "offered_payload_bits")


@dataclasses.dataclass(frozen=True)
class _PhaseWorkers:
    """One phase's workers on the rank's rows, made once per step
    function: the (N,) float 0/1 ``mask``, the same as an (N,) bool
    ``flag`` and an (N, 1) bool column ``on``, and the row indices."""

    mask: torch.Tensor
    flag: torch.Tensor
    on: torch.Tensor
    rows: torch.Tensor

    @staticmethod
    def of(mask: torch.Tensor, rows: torch.Tensor) -> "_PhaseWorkers":
        flag = mask > 0
        return _PhaseWorkers(mask, flag, flag[:, None], rows)


def _censor_masks(state: EngineState, candidate: Tree, cfg: EngineConfig,
                  group_ids: Sequence[int], tau: Optional[torch.Tensor],
                  consts: _Constants
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(worker_mask (N,), group_mask (N, G) or None)``, from the
    packed view of ``candidate - theta_hat`` against the step's threshold
    ``tau``. The group mask is None where each group takes its worker's
    decision (global censoring, or censoring off)."""
    first = T.leaves(candidate)[0]
    if not cfg.censor.enabled:
        return torch.ones(first.shape[0], dtype=torch.float32,
                          device=first.device), None
    diff = T.tree_map(lambda c, h: _as(c, torch.float32)
                      - _as(h, torch.float32), candidate, state.theta_hat)
    xs = T.leaves(diff)
    if cfg.censor_mode == "global":
        diff_p = _rows2d(xs[0]) if len(xs) == 1 else packing.pack(
            packing.make_packing(diff, group_ids), diff)
        change = torch.linalg.vector_norm(diff_p, dim=-1)
        return (change >= tau).to(torch.float32), None
    pk = packing.make_packing(diff, group_ids)
    diff_p = _rows2d(xs[0]) if len(xs) == 1 else packing.pack(pk, diff)
    # tau_g^2 proportional to d_g: the group thresholds partition tau^2
    change_g = torch.sqrt(packing.segment_sqnorm(pk, diff_p))
    tau_g = censor_lib.group_thresholds(tau, consts.dims(pk.group_dims),
                                        pk.dim)
    gmask = censor_lib.group_censor_mask(change_g, tau_g)
    return torch.amax(gmask, dim=-1), gmask


def _where_rows(on: torch.Tensor, a: Tree, b: Tree,
                group_ids: Optional[Sequence[int]] = None) -> Tree:
    """Leaf-wise ``a`` where ``on`` else ``b``, in ``b``'s dtypes. ``on``
    is an (N, 1) bool column, or (N, G) with leaf i reading column
    ``group_ids[i]``; each column is shaped for a leaf's rank once."""
    views: Dict[Tuple[int, int], torch.Tensor] = {}

    def col(g: int, rank: int) -> torch.Tensor:
        if (g, rank) not in views:
            c = on if on.shape[1] == 1 else on[:, g:g + 1]
            views[g, rank] = c if rank == 2 else c.reshape(
                (on.shape[0],) + (1,) * (rank - 1))
        return views[g, rank]

    xs, ys = T.leaves(a), T.leaves(b)
    ids = group_ids if group_ids is not None else (0,) * len(xs)
    return T.unflatten(b, [torch.where(col(g, y.dim()), _as(x, y.dtype), y)
                           for x, y, g in zip(xs, ys, ids)])


class _FactorSlot:
    """A phase's factor of its workers' systems (``ExactSolver.factors``),
    made on the phase's first solve and kept while the step function
    stands; freed with it."""

    __slots__ = ("factor",)

    def __init__(self):
        self.factor = None


def _solve_phase(state: EngineState, solver, v: Tree, quad: torch.Tensor,
                 phase: _PhaseWorkers, batch,
                 slot: Optional[_FactorSlot] = None):
    """The local solve for the acting workers: an inexact (per-worker)
    solver gets their rows only; an exact solver that factors (``slot``
    given) applies the phase's factor to their rows, factoring on the
    first call (traced: ``solve.factor`` then ``solve.apply`` spans); any
    other exact solver solves all and selects."""
    def is_tree(t):            # a solver without moments holds ()
        return isinstance(t, dict) or torch.is_tensor(t)

    rows = phase.rows
    per_worker = getattr(solver, "per_worker", False)
    if (slot is not None or per_worker) and rows.numel() == 0:
        # a rank's row block without this phase
        return state.theta, state.opt_mu, state.opt_nu
    if slot is not None:
        tr = obs_trace.span_tracer()
        if slot.factor is None:
            if tr is not None:
                obs_trace.begin_step_span(tr, "solve.factor",
                                          rows=rows.numel())
            slot.factor = solver.problem.factor(quad, rows)
            if tr is not None:
                obs_trace.end_step_span(tr)
        if tr is not None:
            obs_trace.begin_step_span(tr, "solve.apply")
        theta = solver.solve_rows(slot.factor, rows, v, state.theta)
        if tr is not None:
            obs_trace.end_step_span(tr)
        return theta, state.opt_mu, state.opt_nu
    if per_worker:
        def sub(t):
            return T.take_rows(t, rows) if is_tree(t) else t

        th, mu, nu = solver.solve(
            sub(state.theta), sub(v), quad.index_select(0, rows),
            sub(state.opt_mu), sub(state.opt_nu), sub(batch))
        theta = T.put_rows(state.theta, rows, th)
        if is_tree(state.opt_mu):
            return (theta, T.put_rows(state.opt_mu, rows, mu),
                    T.put_rows(state.opt_nu, rows, nu))
        return theta, state.opt_mu, state.opt_nu
    th, mu, nu = solver.solve(state.theta, v, quad, state.opt_mu,
                              state.opt_nu, batch)
    theta = _where_rows(phase.on, th, state.theta)
    if is_tree(state.opt_mu):
        mu = _where_rows(phase.on, mu, state.opt_mu)
        nu = _where_rows(phase.on, nu, state.opt_nu)
    return theta, mu, nu


def _phase(state: EngineState, phase: _PhaseWorkers, solver,
           topo: topo_lib.Topology, rho_d: torch.Tensor, quad: torch.Tensor,
           cfg: EngineConfig, uniforms: Optional[torch.Tensor], batch,
           participation: Optional[torch.Tensor],
           tau: Optional[torch.Tensor], consts: _Constants,
           slot: Optional[_FactorSlot] = None,
           ) -> Tuple[EngineState, Metrics]:
    """One group's primal update + quantize + censor + commit. ``quad`` is
    the primal's quadratic weight (``rho_d``, or ``2 rho_d`` for the
    Jacobian phase), ``slot`` the phase's factor (``_solve_phase``).

    Returns the new state and the phase's per-worker metrics *unmasked*
    (every row as this phase computed it); the step keeps each worker's
    row from its own phase. ``payload_bits`` counts only bits put on the
    wire, ``candidate_payload_bits`` what the round would have cost
    uncensored; ``group_tx`` is present only under group censoring.

    ``participation`` is the fleet's optional (N,) 0/1 on-time mask. A
    timed-out worker is a censored one: its primal and quantizer chain
    advance, its ``theta_hat`` commit is suppressed and it is charged zero
    bits; the transmit decision is ``timeout & censor``
    (``censoring.compose_tx_mask``). ``censor_mask`` and
    ``offered_payload_bits`` report the censor-only decision and the bits
    offered before that composition (the staleness buffer charges them at
    delivery). With ``participation=None`` they are ``tx_mask`` and
    ``payload_bits``.

    Traced (``obs_trace.span_tracer``), the caller's ``engine.phase`` span
    holds ``engine.mix`` (the mix and the primal ``v``), ``engine.solve``,
    ``engine.quantize`` and ``engine.censor`` (the masks, the timeout,
    the payload and the commits)."""
    tr = obs_trace.span_tracer()
    group_ids = resolve_groups(state.theta, cfg.groups)
    rho = cfg.rho
    if tr is not None:
        obs_trace.begin_step_span(tr, "engine.mix", backend=topo.backend,
                                  D=tree_dim(state.theta_hat))
    neigh = topo.mix(state.theta_hat)
    if cfg.alternating:
        # GGADMM primal, Eqs. (11)/(12)/(21)/(22)
        v = T.tree_map(lambda a, nm: _as(a, torch.float32)
                       - rho * _as(nm, torch.float32), state.alpha, neigh)
    else:
        # Jacobian C-ADMM primal (Liu et al., 2019b): proximal self-anchor
        def jac_v(a, th, nm):
            shape1 = (th.shape[0],) + (1,) * (th.dim() - 1)
            return (a.to(torch.float32)
                    - rho_d.reshape(shape1) * th.to(torch.float32)
                    - rho * nm.to(torch.float32))
        v = T.tree_map(jac_v, state.alpha, state.theta_hat, neigh)
    if tr is not None:
        obs_trace.end_step_span(tr)
        obs_trace.begin_step_span(tr, "engine.solve",
                                  rows=phase.rows.numel())
    theta, mu, nu = _solve_phase(state, solver, v, quad, phase, batch,
                                 slot)
    if tr is not None:
        obs_trace.end_step_span(tr)
        obs_trace.begin_step_span(tr, "engine.quantize",
                                  G=state.quant.n_groups, D=tree_dim(theta))
    if cfg.quantize is not None:
        quant_new, candidate, bits, payload = grouped_quantize_step(
            state.quant, theta, uniforms, cfg.quantize, group_ids, consts)
    else:
        quant_new, candidate, bits, payload = identity_quantize_step(
            state.quant, theta)
    if tr is not None:
        obs_trace.end_step_span(tr)
        obs_trace.begin_step_span(tr, "engine.censor")

    cmask_cens, gmask_cens = _censor_masks(state, candidate, cfg, group_ids,
                                           tau, consts)
    if participation is not None:
        # the timeout composes after the censor test, which (like the
        # quantizer chain) does not see it
        cmask, gmask = censor_lib.compose_tx_mask(participation, cmask_cens,
                                                  gmask_cens)
    else:
        cmask, gmask = cmask_cens, gmask_cens
    if gmask is not None:
        # payload counts only the transmitted groups (+ their overhead)
        dims = consts.dims(group_dims(theta, group_ids))
        overhead = float(cfg.quantize.b_overhead) \
            if cfg.quantize is not None else 0.0
        per_group = bits * dims[None, :] + overhead
        payload_tx = torch.sum(per_group * gmask, dim=-1)
        offered = payload_tx if participation is None else torch.sum(
            per_group * gmask_cens, dim=-1)
        commit = (gmask > 0) & phase.on
    else:
        payload_tx = payload * cmask
        offered = payload_tx if participation is None \
            else payload * cmask_cens
        commit = (cmask[:, None] > 0) & phase.on

    # theta_hat: each leaf commits where its group transmitted
    theta_hat = _where_rows(commit, candidate, state.theta_hat, group_ids)

    # the acting phase's replicas advance (censoring does not roll back)
    on, q_old = phase.on, state.quant
    quant = GroupQuantState(
        q_hat=_where_rows(on, quant_new.q_hat, q_old.q_hat),
        range_prev=torch.where(on, quant_new.range_prev, q_old.range_prev),
        bits_prev=torch.where(on, quant_new.bits_prev, q_old.bits_prev),
        delta_prev=torch.where(on, quant_new.delta_prev, q_old.delta_prev),
        initialized=torch.where(on, quant_new.initialized,
                                q_old.initialized),
    )
    new_state = EngineState(theta=theta, theta_hat=theta_hat,
                            alpha=state.alpha, quant=quant, opt_mu=mu,
                            opt_nu=nu, k=state.k)
    raw = {"tx_mask": cmask, "payload_bits": payload_tx,
           "candidate_payload_bits": payload, "bits_per_group": bits,
           "censor_mask": cmask_cens, "offered_payload_bits": offered}
    if gmask is not None:
        raw["group_tx"] = gmask
    if tr is not None:
        obs_trace.end_step_span(tr)
    return new_state, raw


def _merge_phases(raw_h: Metrics, raw_t: Metrics,
                  head: _PhaseWorkers) -> Metrics:
    """Each worker's metrics from its own phase: the head rows of
    ``raw_h``, the tail rows of ``raw_t``, one ``where`` per distinct pair
    (a metric that is another's tensor in both phases is not selected
    twice). The phases' masks are complements, so this is the sum of the
    two phases' masked metrics."""
    done: Dict[Tuple[int, int], torch.Tensor] = {}
    out = {}
    for k, h in raw_h.items():
        t = raw_t[k]
        if (id(h), id(t)) not in done:
            done[id(h), id(t)] = torch.where(
                head.flag if h.dim() == 1 else head.on, h, t)
        out[k] = done[id(h), id(t)]
    return out


def make_step(graph: WorkerGraph, cfg: EngineConfig, solver,
              extra_metrics: Optional[MetricsFn] = None, *,
              topology: Optional[topo_lib.Topology] = None,
              device: Optional[Union[str, torch.device]] = None):
    """Build the per-iteration step ``step(state, draw, batch=None) ->
    (state, metrics)``. ``draw(phase)`` returns the (N, D) float32
    uniforms of phase 0 (heads, or the single Jacobian phase) or 1
    (tails); it is called only when the config quantizes. ``batch`` goes to
    the local solver (per-worker leading axis). Metrics carry per-worker
    ``tx_mask``, ``payload_bits``, ``candidate_payload_bits``,
    ``bits_per_group``, ``group_tx``, ``censor_mask``,
    ``offered_payload_bits`` (each worker's from its own phase; see
    :func:`_phase`) and ``dual_residual``
    ``||rho (D - A) theta_hat||²``, plus ``extra_metrics(state, batch)``.
    ``participation`` is the fleet's optional (N,) on-time mask (see
    :func:`_phase`); None is the synchronous path.

    The phase masks and rows, the primal's quadratic weight, the censor
    decay and the schedule's constants are put on the device here, once; a
    step copies nothing from the host. Where the solver factors
    (``ExactSolver.factors``: the linear problem), each phase factors its
    workers' systems on its first solve and applies that factor to its
    rows from then on: the systems depend only on the graph's degrees, so
    the factor stands as long as the step function. It is made on the
    first solve, not here, so a caller that replaces its step function
    (a redraw) frees the old factors before the new ones are made. Under
    global censoring ``group_tx`` is ``tx_mask`` broadcast over the groups
    (an expanded view).

    On the sharded topology the state, draws, batch and metrics hold the
    rank's row block (``topology.worker_rows``); the phase masks and rows
    are cut to it, relative to its first row, and ``rho_d`` comes from the
    block's degrees.

    Traced (``obs_trace.span_tracer``), building is an
    ``engine.make_step`` span, and a step an ``engine.step`` span that
    holds an ``engine.phase`` span a phase (``_phase``'s spans inside;
    ``engine.solve`` holds ``solve.factor`` on a phase's first solve and
    ``solve.apply`` on each, where the solver factors),
    then ``engine.dual`` (the Laplacian, the dual update and
    ``dual_residual``) and ``engine.diagnostics`` (``extra_metrics``). The
    spans' args are counts the host knows: nothing is read from the
    device for them."""
    tr = obs_trace.span_tracer()
    if tr is not None:
        obs_trace.begin_step_span(tr, "engine.make_step")
    topo = topology if topology is not None else topo_lib.build(
        graph, cfg.mix_backend, device=device)
    dev = topo.degrees.device
    consts = _Constants(cfg, dev)
    head_np = np.asarray(graph.head_mask, np.float32)[
        topo.worker_rows(graph.n)]
    head_mask = torch.as_tensor(head_np, device=dev)
    head = _PhaseWorkers.of(
        head_mask, torch.as_tensor(np.nonzero(head_np > 0)[0], device=dev))
    tail = _PhaseWorkers.of(
        1.0 - head_mask,
        torch.as_tensor(np.nonzero(head_np <= 0)[0], device=dev))
    every = _PhaseWorkers.of(torch.ones_like(head_mask),
                             torch.arange(head_np.shape[0], device=dev))
    rho_d = cfg.rho * topo.degrees
    # the primal's quadratic weight: GGADMM's rho d_n, or the Jacobian
    # phase's 2 rho d_n (with its proximal self-anchor)
    quad = rho_d if cfg.alternating else 2.0 * rho_d

    def slot() -> Optional[_FactorSlot]:
        return _FactorSlot() if getattr(solver, "factors", False) else None

    # (name, workers, draw, factor slot) of each phase: GGADMM's heads then
    # tails, or the single Jacobian phase
    phases = ((("head", head, 0, slot()), ("tail", tail, 1, slot()))
              if cfg.alternating else (("every", every, 0, slot()),))
    if tr is not None:
        obs_trace.end_step_span(tr)

    def step(state: EngineState, draw: Callable[[int], torch.Tensor],
             batch: Any = None, participation=None):
        def uniforms(phase: int) -> Optional[torch.Tensor]:
            return draw(phase) if cfg.quantize is not None else None

        tr = obs_trace.span_tracer()
        if tr is not None:
            obs_trace.begin_step_span(tr, "engine.step", k=state.k)

        # both phases test against tau^{k+1}
        tau = (censor_lib.threshold(cfg.censor, state.k + 1, dev,
                                    xi=consts.xi)
               if cfg.censor.enabled else None)
        args = (solver, topo, rho_d, quad, cfg)
        raws = []
        for name, workers, phase, factor in phases:
            if tr is not None:
                obs_trace.begin_step_span(tr, "engine.phase", phase=name,
                                          rows=workers.rows.numel())
            state, raw = _phase(state, workers, *args, uniforms(phase), batch,
                                participation, tau, consts, factor)
            if tr is not None:
                obs_trace.end_step_span(tr)
            raws.append(raw)
        if cfg.alternating:
            raw = _merge_phases(raws[0], raws[1], head)
        if "group_tx" not in raw:
            tx, bits = raw["tx_mask"], raw["bits_per_group"]
            raw["group_tx"] = tx[:, None].expand(bits.shape)
        metrics = {k: raw[k] for k in METRIC_KEYS}

        # Dual update, Eq. (23): alpha += rho * (D - A) theta_hat, through
        # the same topology (and mix kernel) as the phase mixes.
        if tr is not None:
            obs_trace.begin_step_span(tr, "engine.dual")
        lap = topo.laplacian(state.theta_hat)
        alpha = T.tree_map(lambda a, lp: _as(_as(a, torch.float32)
                                             + cfg.rho * lp, a.dtype),
                           state.alpha, lap)
        state = EngineState(theta=state.theta, theta_hat=state.theta_hat,
                            alpha=alpha, quant=state.quant,
                            opt_mu=state.opt_mu, opt_nu=state.opt_nu,
                            k=state.k + 1)
        metrics["dual_residual"] = (cfg.rho ** 2) * topo.dual_residual(lap)
        if tr is not None:
            obs_trace.end_step_span(tr)
        if extra_metrics is not None:
            if tr is not None:
                obs_trace.begin_step_span(tr, "engine.diagnostics")
            metrics.update(extra_metrics(state, batch))
            if tr is not None:
                obs_trace.end_step_span(tr)
        if tr is not None:
            obs_trace.end_step_span(tr)
        return state, metrics

    return step


def flat_metrics(graph: WorkerGraph,
                 mix_backend: Union[str, topo_lib.Topology] = "dense", *,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> MetricsFn:
    """Flat-stepper diagnostics: the pairwise primal residual (Eq. 28) and
    the theta trajectory (for objective / distance-to-optimum curves).
    ``mix_backend`` may be an already-built topology."""
    topo = (mix_backend if isinstance(mix_backend, topo_lib.Topology)
            else topo_lib.build(graph, mix_backend, device=device))

    def fn(state: EngineState, batch=None) -> Metrics:
        del batch
        theta = _flatten_worker(state.theta)
        return {"primal_residual": topo.primal_residual(theta),
                "theta": theta}

    return fn


def consensus_metrics(loss_fn: Optional[Callable] = None,
                      topology: Optional[topo_lib.Topology] = None
                      ) -> MetricsFn:
    """Training diagnostics: deviation from the worker mean (+ the loss,
    ``loss_fn``'s mean over the workers it is given). On a sharded
    ``topology`` of more than one rank both are taken over every rank's
    workers: the blocks are equal, so the mean of the ranks' means
    (``all_reduce``d) is the worker mean."""
    world = topology.world if topology is not None else 1

    def worker_mean(x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=0, keepdim=True)
        return topology.all_reduce(mean) / world if world > 1 else mean

    def fn(state: EngineState, batch) -> Metrics:
        dev = T.tree_map(lambda x: x.to(torch.float32)
                         - worker_mean(x.to(torch.float32)), state.theta)
        err = torch.sum(tree_worker_sqnorm(dev))
        out = {"consensus_err": topology.all_reduce(err) if world > 1
               else err}
        if loss_fn is not None:
            loss = loss_fn(state.theta, batch)
            out["loss"] = (topology.all_reduce(loss) / world if world > 1
                           else loss)
        return out

    return fn


def gather_workers(tree: Any, topology: topo_lib.Topology,
                   dim: int = 0) -> Any:
    """Every rank's rows of a tree or metrics dict, gathered along the
    worker axis ``dim`` (1 for ``run``'s stacked metrics) in rank order:
    leaves that hold the rank's rows there are all-gathered, the rest
    (scalars, already reduced) pass through. The identity off the sharded
    backend."""
    local = topology.n // topology.world

    def one(x):
        if (torch.is_tensor(x) and x.dim() > dim
                and x.shape[dim] == local):
            return topology.gather(x, dim)
        return x
    return T.tree_map(one, tree)


def cut_workers(tree: Any, topology: topo_lib.Topology) -> Any:
    """The rank's rows of a tree of whole ``(N, ...)`` worker-axis arrays
    (the identity off the sharded backend)."""
    rows = topology.worker_rows(topology.n)
    return T.tree_map(lambda x: x[rows], tree)


def cut_solver(solver, topology: topo_lib.Topology):
    """A solver whose problem holds every worker (an ``ExactSolver``'s),
    cut to the rank's rows (``take_workers``); any other solver as it is.
    The identity off the sharded backend of more than one rank."""
    problem = getattr(solver, "problem", None)
    if (topology.world > 1
            and getattr(problem, "n_workers", None) == topology.n):
        return dataclasses.replace(solver, problem=problem.take_workers(
            topology.worker_rows(topology.n)))
    return solver


def run(graph: WorkerGraph, cfg: EngineConfig, solver, theta0: Tree,
        iters: int, seed: int = 0,
        extra_metrics: Optional[MetricsFn] = None,
        topology: Optional[topo_lib.Topology] = None,
        uniforms: Optional[Uniforms] = None,
        ) -> Tuple[EngineState, Metrics]:
    """Run ``iters`` batch-free iterations from ``theta0`` on its device and
    return the final state plus per-iteration metrics stacked on a leading
    axis. The (N, D) uniforms come from a ``torch.Generator`` seeded with
    ``seed``, or from ``uniforms(iteration, phase)`` when given.

    On a sharded topology of more than one rank ``theta0`` is the whole
    (N, ...) tree, cut here to the rank's rows, and so is an
    ``ExactSolver``'s problem (``take_workers``). The uniforms are drawn
    whole, (N, D), from the same generator and cut to the block, and so
    are injected ones: a sharded run's state equals the world-1 run's. The
    price is a whole draw on every rank (2.15 GB a phase at the
    xlstm-125m LM shape). The state and the metrics hold the rank's rows
    (:func:`gather_workers` with ``dim=1`` collects the metrics)."""
    first = T.leaves(theta0)[0]
    dev = first.device
    topo = topology if topology is not None else topo_lib.build(
        graph, cfg.mix_backend, device=dev)
    rows = topo.worker_rows(graph.n)
    shape = (graph.n, tree_dim(theta0))
    if topo.world > 1:
        theta0 = cut_workers(theta0, topo)
        solver = cut_solver(solver, topo)
    state = init_state(theta0, cfg, solver)
    step = make_step(graph, cfg, solver, extra_metrics, topology=topo)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw_for(it: int) -> Callable[[int], torch.Tensor]:
        def draw(phase: int) -> torch.Tensor:
            if uniforms is not None:
                u = uniforms(it, phase).to(device=dev, dtype=torch.float32)
            else:
                u = torch.rand(shape, generator=gen, device=dev)
            return u if topo.world == 1 else u[rows]
        return draw

    history: List[Metrics] = []
    for it in range(iters):
        state, m = step(state, draw_for(it))
        history.append(m)
    stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return state, stacked
