"""Parameter trees as nested dicts of tensors, in the JAX package's order.

The JAX package flattens a dict pytree in **sorted key order** and names
each leaf by ``jax.tree_util.keystr`` of its path, e.g.
``['stack']['units']['p0']['cell']['down']['w']``. The packed layout, the
``groups="leaf"`` ids, ``block:`` bucket matching and the checkpoint keys
all follow from that order and those strings, so the port flattens the
same way here and never from ``nn.Module`` registration order.

A tree is a tensor (one leaf, path ``""``) or a ``dict`` whose values are
trees; an empty dict has no leaves, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

Tree = Any


def _walk(tree: Tree, prefix: Tuple[str, ...], out: List):
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], prefix + (key,), out)
    else:
        out.append((prefix, tree))


def flatten_with_path(tree: Tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(key path, leaf), ...]`` in sorted key order."""
    out: List = []
    _walk(tree, (), out)
    return out


def leaves(tree: Tree) -> List[Any]:
    if not isinstance(tree, dict):          # a bare leaf (the flat path)
        return [tree]
    return [leaf for _, leaf in flatten_with_path(tree)]


def keystr(path: Tuple[str, ...]) -> str:
    """``('a', 'b') -> "['a']['b']"``, as ``jax.tree_util.keystr``."""
    return "".join(f"[{k!r}]" for k in path)


def paths(tree: Tree) -> Tuple[str, ...]:
    """The keystr path of every leaf, aligned with :func:`leaves`."""
    return tuple(keystr(p) for p, _ in flatten_with_path(tree))


def unflatten(like: Tree, new_leaves) -> Tree:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    if not isinstance(like, dict):          # a bare leaf (the flat path)
        new_leaves = list(new_leaves)
        if len(new_leaves) > 1:
            raise ValueError("more leaves than the tree has")
        return new_leaves[0]
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def parse_keystr(path: str) -> Tuple[str, ...]:
    """Inverse of :func:`keystr` for dict keys: ``"['a']['b']"`` ->
    ``('a', 'b')``."""
    out, i = [], 0
    while i < len(path):
        if not path.startswith("['", i):
            raise ValueError(f"not a dict keystr path: {path!r}")
        j = path.index("']", i + 2)
        out.append(path[i + 2:j])
        i = j + 2
    return tuple(out)


def from_paths(flat: Mapping[str, Any]) -> Tree:
    """A nested-dict tree from a keystr-path -> leaf mapping (the layout of
    the JAX package's checkpoints). The single path ``""`` is a bare leaf."""
    if set(flat) == {""}:
        return flat[""]
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        keys = parse_keystr(path)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return root


def to_paths(tree: Tree) -> Dict[str, Any]:
    """keystr path -> leaf, in leaf order."""
    return {keystr(p): leaf for p, leaf in flatten_with_path(tree)}


def take_rows(tree: Tree, rows: torch.Tensor) -> Tree:
    """Select workers ``rows`` (leading axis) of every leaf."""
    return tree_map(lambda x: x.index_select(0, rows.to(x.device)), tree)


def put_rows(tree: Tree, rows: torch.Tensor, sub: Tree) -> Tree:
    """``tree`` with workers ``rows`` replaced by ``sub``'s rows."""
    return tree_map(
        lambda x, s: x.index_copy(0, rows.to(x.device), s.to(x.dtype)),
        tree, sub)
