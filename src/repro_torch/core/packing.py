"""Packed buffer view of worker-stacked parameter trees, and the group-spec
grammar (the port of ``repro.core.packing``).

* :class:`Packing` is the static layout of a worker-stacked tree as one
  ``(N, D)`` buffer: per-leaf shapes, dtypes, flat dims and column offsets
  (leaves in the JAX package's sorted-key order, ``core/tree.py``), the
  leaf -> group ids and, per group, its contiguous column runs
  ``group_runs``. The runs are what the grouped quantize kernels read: a
  column's group follows from the few run boundaries, so no kernel reads a
  ``(D,)`` id map. ``col_group_ids`` is that map, built on first use for
  the plain versions and the tests.
* :func:`pack` / :func:`unpack` move between tree and buffer. ``unpack``
  returns views into the buffer.
* :func:`segment_maxabs` / :func:`segment_sqnorm`: per-worker per-group
  ``max |.|`` and ``sum .^2`` over each leaf's column slice, ``(N, G)``.
* The group-spec grammar: ``"model"``, ``"leaf"``, ``"block:a,b"``,
  ``"auto:K"``, explicit ids and index buckets, plus the greedy
  range-similarity clustering of ``auto:K`` re-grouping. This part is
  numpy and plain Python, copied from the JAX module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T

Tree = Any

# Layout cache: (paths, shapes, dtypes, group_ids) -> Packing. Layouts are
# immutable and few per process (as the JAX module's cache).
_CACHE: Dict[Tuple, "Packing"] = {}


@dataclasses.dataclass(frozen=True)
class Packing:
    """Static layout of a worker-stacked tree as one ``(N, D)`` buffer."""

    skeleton: Any                          # the tree with None leaves
    shapes: Tuple[Tuple[int, ...], ...]    # per-leaf shapes (worker axis incl)
    dtypes: Tuple[torch.dtype, ...]
    dims: Tuple[int, ...]                  # per-leaf flat dim d_i
    offsets: Tuple[int, ...]               # per-leaf column offset
    group_ids: Tuple[int, ...]             # leaf index -> group id
    n_groups: int
    group_dims: Tuple[int, ...]            # per-group parameter counts d_g
    # per-group contiguous column runs ((offset, size), ...), adjacent
    # same-group leaves merged
    group_runs: Tuple[Tuple[Tuple[int, int], ...], ...]

    @property
    def dim(self) -> int:
        """Total packed width D."""
        return sum(self.dims)

    @property
    def n_leaves(self) -> int:
        return len(self.dims)

    @property
    def sorted_ids(self) -> bool:
        ids = self.group_ids
        return all(ids[i] <= ids[i + 1] for i in range(len(ids) - 1))

    @property
    def col_group_ids(self) -> np.ndarray:
        """(D,) int32 column -> group id map, built on first use."""
        cols = self.__dict__.get("_cols")
        if cols is None:
            cols = np.concatenate([np.full(d, g, np.int32)
                                   for d, g in zip(self.dims,
                                                   self.group_ids)])
            object.__setattr__(self, "_cols", cols)
        return cols


def runs_to_col_ids(group_runs, dim: int) -> np.ndarray:
    """(D,) int32 column -> group id map from per-group column runs."""
    cols = np.zeros(dim, np.int32)
    for g, runs in enumerate(group_runs):
        for off, size in runs:
            cols[off:off + size] = g
    return cols


def make_packing(tree: Tree, group_ids: Sequence[int]) -> Packing:
    """Build (or fetch the cached) packing for ``tree`` with per-leaf
    ``group_ids`` (aligned with the sorted leaf order)."""
    flat = T.flatten_with_path(tree)
    if not flat:
        raise ValueError("cannot pack an empty tree")
    shapes = tuple(tuple(int(s) for s in x.shape) for _, x in flat)
    dtypes = tuple(x.dtype for _, x in flat)
    ids = tuple(int(g) for g in group_ids)
    if len(ids) != len(flat):
        raise ValueError(f"group spec covers {len(ids)} leaves, "
                         f"tree has {len(flat)}")
    key = (tuple(p for p, _ in flat), shapes, dtypes, ids)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit

    dims = tuple(int(np.prod(s[1:], dtype=np.int64)) for s in shapes)
    offsets, off = [], 0
    for d in dims:
        offsets.append(off)
        off += d
    n_groups = max(ids) + 1
    gdims = [0] * n_groups
    for d, g in zip(dims, ids):
        gdims[g] += d
    runs: list = [[] for _ in range(n_groups)]
    for off_i, d, g in zip(offsets, dims, ids):
        if d == 0:
            continue
        if runs[g] and runs[g][-1][0] + runs[g][-1][1] == off_i:
            runs[g][-1] = (runs[g][-1][0], runs[g][-1][1] + d)
        else:
            runs[g].append((off_i, d))
    pk = Packing(skeleton=T.tree_map(lambda x: None, tree), shapes=shapes,
                 dtypes=dtypes, dims=dims, offsets=tuple(offsets),
                 group_ids=ids, n_groups=n_groups, group_dims=tuple(gdims),
                 group_runs=tuple(tuple(r) for r in runs))
    _CACHE[key] = pk
    return pk


def pack(pk: Packing, tree: Tree, dtype=torch.float32) -> torch.Tensor:
    """Tree -> ``(N, D)`` buffer (leaves concatenated in leaf order)."""
    xs = T.leaves(tree)
    n = xs[0].shape[0]
    if len(xs) == 1:
        return xs[0].reshape(n, -1).to(dtype)
    return torch.cat([x.reshape(n, -1).to(dtype) for x in xs], dim=1)


def unpack(pk: Packing, buf: torch.Tensor, like: Tree = None) -> Tree:
    """``(N, D)`` buffer -> tree of views into it. Shapes come from the
    packing; dtypes from ``like`` when given, else the packed tree's."""
    n = buf.shape[0]
    dtypes = (tuple(x.dtype for x in T.leaves(like)) if like is not None
              else pk.dtypes)
    out = [buf[:, off:off + d].reshape((n,) + shape[1:]).to(dt)
           for shape, dt, d, off in zip(pk.shapes, dtypes, pk.dims,
                                        pk.offsets)]
    return T.unflatten(pk.skeleton, out)


def _grouped_colreduce(pk: Packing, mat: torch.Tensor, reduce_fn
                       ) -> torch.Tensor:
    """Per-group reduction along the columns: each leaf reduces its own
    contiguous slice, leaves sharing a group combine with one more
    reduction (as the JAX module)."""
    if pk.n_groups == 1:
        return reduce_fn(mat, dim=1)[:, None]
    per_group = [[] for _ in range(pk.n_groups)]
    for off, d, g in zip(pk.offsets, pk.dims, pk.group_ids):
        per_group[g].append(reduce_fn(mat[:, off:off + d], dim=1))
    cols = [parts[0] if len(parts) == 1
            else reduce_fn(torch.stack(parts, dim=0), dim=0)
            for parts in per_group]
    return torch.stack(cols, dim=1)


def segment_maxabs(pk: Packing, buf: torch.Tensor) -> torch.Tensor:
    """Per-worker per-group ``max |buf|``, the grouped range R_g: (N, G)."""
    return _grouped_colreduce(pk, torch.abs(buf), torch.amax)


def segment_sqnorm(pk: Packing, buf: torch.Tensor) -> torch.Tensor:
    """Per-worker per-group ``sum buf^2``, the group-censor norm: (N, G)."""
    return _grouped_colreduce(pk, torch.square(buf.to(torch.float32)),
                              torch.sum)


# ------------------------------------------------------------ group specs --
class GroupSpecError(ValueError):
    """Malformed group spec: bad syntax, unknown/empty bucket, or index
    buckets that are not a partition of the leaves."""


# bucket name -> path substrings that place a leaf in it; first listed
# bucket wins over a lowercased keystr path; "rest" is the catch-all
BUCKET_ALIASES: Dict[str, Tuple[str, ...]] = {
    "embed": ("embed", "unembed", "vocab", "wte", "wpe", "lm_head"),
    "attn": ("attn", "attention", "qkv"),
    "mlp": ("mlp", "ffn", "moe", "expert", "glu", "feed_forward"),
    "ssm": ("ssm", "mamba", "conv", "slstm", "mlstm"),
    "norm": ("norm", "ln1", "ln2", "rmsnorm", "layernorm"),
    "rest": (),
}
_BUCKET_ORDER = ("embed", "attn", "mlp", "ssm", "norm")


def leaf_paths(tree: Tree) -> Tuple[str, ...]:
    """Lowercased keystr path per leaf, aligned with the leaf order."""
    return tuple(p.lower() for p in T.paths(tree))


def bucket_of(path: str) -> str:
    p = path.lower()
    for name in _BUCKET_ORDER:
        if any(tok in p for tok in BUCKET_ALIASES[name]):
            return name
    return "rest"


def tree_bucket_names(tree: Tree) -> Tuple[str, ...]:
    return tuple(sorted({bucket_of(p) for p in leaf_paths(tree)}))


def parse_block_spec(spec: str) -> Tuple[str, ...]:
    body = spec[len("block:"):] if spec.startswith("block:") else spec
    names = tuple(n.strip().lower() for n in body.split(","))
    if not body.strip() or any(not n for n in names):
        raise GroupSpecError(
            f"malformed block spec {spec!r}: expected "
            f"'block:<name>[,<name>...]' with non-empty names")
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise GroupSpecError(
            f"block spec {spec!r} repeats bucket(s) {sorted(dupes)}")
    return names


def parse_auto_spec(spec: str) -> int:
    body = spec[len("auto:"):] if spec.startswith("auto:") else spec
    try:
        k = int(body)
    except ValueError:
        raise GroupSpecError(
            f"malformed auto spec {spec!r}: expected 'auto:<K>' with "
            f"integer K >= 1") from None
    if k < 1:
        raise GroupSpecError(f"auto spec {spec!r}: K must be >= 1")
    return k


def validate_spec_syntax(spec: str) -> None:
    """Tree-independent syntax check of a string group spec."""
    if spec in ("model", "leaf"):
        return
    if spec.startswith("block:"):
        parse_block_spec(spec)
        return
    if spec.startswith("auto:"):
        parse_auto_spec(spec)
        return
    raise GroupSpecError(
        f"unknown group spec {spec!r}: expected 'model', 'leaf', "
        f"'block:<b1,b2,...>', 'auto:<K>', a leaf->group id tuple, or a "
        f"tuple of leaf-index buckets")


def _name_patterns(name: str) -> Tuple[str, ...]:
    return (name,) + BUCKET_ALIASES.get(name, ())


def resolve_block_groups(tree: Tree, names: Sequence[str]) -> Tuple[int, ...]:
    """Named-bucket resolution: bucket j takes every leaf whose path
    matches one of its patterns (first listed wins); unmatched leaves go
    to ``"rest"``, listed or appended. Unknown and empty buckets raise."""
    names = tuple(n.lower() for n in names)
    paths = leaf_paths(tree)
    rest_slot = names.index("rest") if "rest" in names else None
    ids = []
    for p in paths:
        gid = None
        for j, name in enumerate(names):
            if name == "rest":
                continue
            if any(tok in p for tok in _name_patterns(name)):
                gid = j
                break
        if gid is None:
            gid = rest_slot if rest_slot is not None else len(names)
        ids.append(gid)
    used = set(ids)
    for j, name in enumerate(names):
        if j in used or name == "rest":
            continue
        if name not in BUCKET_ALIASES \
                and not any(any(tok in p for tok in _name_patterns(name))
                            for p in paths):
            raise GroupSpecError(
                f"unknown bucket {name!r}: not a canonical bucket "
                f"({sorted(BUCKET_ALIASES)}) and matches no leaf path; "
                f"this tree's buckets: {tree_bucket_names(tree)}")
        raise GroupSpecError(
            f"empty bucket {name!r}: no leaf of this tree lands in it "
            f"(buckets present: {tree_bucket_names(tree)}; earlier-listed "
            f"buckets win overlapping leaves)")
    remap = {g: i for i, g in enumerate(sorted(used))}
    return tuple(remap[g] for g in ids)


def resolve_index_buckets(tree: Tree,
                          buckets: Sequence[Sequence[int]]) -> Tuple[int, ...]:
    """``((0, 1), (2,))``: leaves 0, 1 in group 0, leaf 2 in group 1. Must
    partition ``range(L)``."""
    n_leaves = len(T.leaves(tree))
    ids: Dict[int, int] = {}
    for j, bucket in enumerate(buckets):
        members = tuple(int(i) for i in bucket)
        if not members:
            raise GroupSpecError(f"index bucket {j} is empty")
        for i in members:
            if not 0 <= i < n_leaves:
                raise GroupSpecError(
                    f"index bucket {j} names leaf {i}, tree has "
                    f"{n_leaves} leaves")
            if i in ids:
                raise GroupSpecError(
                    f"overlapping spec: leaf {i} appears in buckets "
                    f"{ids[i]} and {j}")
            ids[i] = j
    missing = sorted(set(range(n_leaves)) - set(ids))
    if missing:
        raise GroupSpecError(
            f"index buckets do not cover leaves {missing} "
            f"(every leaf must appear in exactly one bucket)")
    return tuple(ids[i] for i in range(n_leaves))


def leaf_dims(tree: Tree) -> Tuple[int, ...]:
    return tuple(int(x.numel() // x.shape[0]) for x in T.leaves(tree))


def resolve_auto_groups(tree: Tree, k: int) -> Tuple[int, ...]:
    """Shape-only ``auto:K`` partition: contiguous leaf segments with
    balanced parameter counts."""
    dims = leaf_dims(tree)
    n_leaves = len(dims)
    k = min(int(k), n_leaves)
    cum = np.cumsum(np.asarray(dims, np.float64))
    bounds, prev = [], 0
    for j in range(1, k):
        i = int(np.searchsorted(cum, j * cum[-1] / k, side="right"))
        i = min(max(i, prev + 1), n_leaves - (k - j))
        bounds.append(i)
        prev = i
    ids, g = [], 0
    for i in range(n_leaves):
        while g < len(bounds) and i >= bounds[g]:
            g += 1
        ids.append(g)
    return tuple(ids)


def greedy_range_grouping(log_ranges: np.ndarray, dims: Sequence[int],
                          k: int) -> Tuple[int, ...]:
    """Cluster leaves into <= K contiguous groups by log-range similarity:
    greedily merge the adjacent pair with the closest dim-weighted mean
    log-range (ties -> lowest index). Group ids are monotone over leaves."""
    lr = np.asarray(log_ranges, np.float64)
    w = np.asarray(dims, np.float64)
    n_leaves = lr.shape[0]
    if w.shape[0] != n_leaves:
        raise ValueError(f"{n_leaves} log-ranges vs {w.shape[0]} dims")
    k = max(1, min(int(k), n_leaves))
    counts = [1] * n_leaves
    sum_w = list(w)
    sum_ws = list(w * lr)
    means = np.asarray([s / max(t, 1e-30) for s, t in zip(sum_ws, sum_w)])
    for _ in range(n_leaves - k):
        j = int(np.argmin(np.abs(np.diff(means))))
        counts[j] += counts.pop(j + 1)
        sum_w[j] += sum_w.pop(j + 1)
        sum_ws[j] += sum_ws.pop(j + 1)
        means = np.delete(means, j + 1)
        means[j] = sum_ws[j] / max(sum_w[j], 1e-30)
    ids = []
    for g, c in enumerate(counts):
        ids.extend([g] * c)
    return tuple(ids)
