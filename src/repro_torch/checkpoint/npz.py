"""npz tree checkpointer with the JAX package's on-disk layout
(``repro.checkpoint.npz``): ``<dir>/step_<k>.npz`` holds every leaf under
its keystr path (``['stack']['units']['p0']['cell']['q']['w']``), and
``step_<k>.json`` describes the tree. A checkpoint written by either
package restores in the other.

A step is complete only when both files exist: the npz is renamed into
place first and the manifest second (each written tmp-then-rename), and
listing, restore and pruning consider complete steps only.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as T

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def _flatten(tree: Any):
    return {path: leaf.detach().cpu().numpy()
            for path, leaf in T.to_paths(tree).items()}


def save(directory, step: int, tree: Any, keep: Optional[int] = 3) -> Path:
    """Write step_<k>.npz (+ manifest); prune to the newest ``keep``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    path = directory / f"step_{step}.npz"
    manifest_path = directory / f"step_{step}.json"
    manifest = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in flat.items()}

    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f"step_{step}.",
                               suffix=".tmp.npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=f"step_{step}.",
                               suffix=".tmp.json")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, manifest_path)

    if keep is not None:
        for old in sorted(all_steps(directory))[:-keep]:
            if old == step:
                continue
            (directory / f"step_{old}.json").unlink(missing_ok=True)
            (directory / f"step_{old}.npz").unlink(missing_ok=True)
    return path


def all_steps(directory):
    """Steps with BOTH the npz and its manifest (complete checkpoints)."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return [int(m.group(1)) for p in directory.iterdir()
            if (m := _STEP_RE.search(p.name))
            and (directory / f"step_{m.group(1)}.json").exists()]


def latest_step(directory) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore(directory, template: Any,
            step: Optional[int] = None) -> tuple:
    """Rebuild ``template``'s tree (device and dtype of each leaf) from the
    newest or the given checkpoint; shapes are checked leaf by leaf."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    out = []
    with np.load(directory / f"step_{step}.npz") as data:
        for key, leaf in T.to_paths(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} "
                                 f"!= {tuple(leaf.shape)}")
            out.append(torch.as_tensor(arr).to(device=leaf.device,
                                               dtype=leaf.dtype))
    return T.unflatten(template, out), step
