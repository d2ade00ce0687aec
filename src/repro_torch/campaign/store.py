"""Typed results store: the port of ``repro.campaign.store``.

Every run emits a :class:`Record`: a JSON section (placed at ``section``, a
key path into the document) plus :class:`Claim` objects (merged as plain
``{name: bool}`` under ``claims_path``). Merges are atomic: the whole
document is rewritten through a temp file and ``os.replace`` (as
``checkpoint/npz.py`` writes), so a crash mid-write never corrupts it.
Sections merge key-stably: re-merging an existing section updates it in
place, so a resumed campaign reproduces the document bytes of an
uninterrupted one.

Every merge also appends the record (with a wall-clock timestamp and the
merging campaign/run identity) to the append-only ``BENCH_history.jsonl``
beside the document, one JSON object per line written with one
``write()``, so the trajectory the in-place document overwrites is kept.

The port's default document is ``campaigns/torch/BENCH_engine.json`` (the
JAX package writes ``BENCH_engine.json`` in the working directory), so the
two packages never write one file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

DEFAULT_PATH = "campaigns/torch/BENCH_engine.json"
HISTORY_NAME = "BENCH_history.jsonl"


@dataclasses.dataclass(frozen=True)
class Claim:
    """One gateable boolean check, with optional provenance."""

    name: str
    ok: bool
    value: Any = None             # the measured quantity behind the bool
    gate: str = ""                # human-readable threshold, e.g. "< 1.1"

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "ok": bool(self.ok),
                "value": sanitize(self.value), "gate": self.gate}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Claim":
        return Claim(name=d["name"], ok=bool(d["ok"]),
                     value=d.get("value"), gate=d.get("gate", ""))


@dataclasses.dataclass(frozen=True)
class Record:
    """What one run produced: a section of metrics plus its claims."""

    section: Tuple[str, ...]              # key path for ``data``
    data: Mapping[str, Any]
    claims: Tuple[Claim, ...] = ()
    claims_path: Tuple[str, ...] = ("claims",)

    def to_json(self) -> Dict[str, Any]:
        return {"section": list(self.section),
                "data": sanitize(self.data),
                "claims": [c.to_json() for c in self.claims],
                "claims_path": list(self.claims_path)}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Record":
        return Record(section=tuple(d["section"]), data=d["data"],
                      claims=tuple(Claim.from_json(c) for c in d["claims"]),
                      claims_path=tuple(d["claims_path"]))


def sanitize(obj: Any) -> Any:
    """Recursively convert numpy and torch scalars/arrays to plain JSON
    values (a tensor through ``.detach().cpu()``)."""
    if isinstance(obj, dict):
        return {str(k): sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return sanitize(obj.detach().cpu().tolist())
    if isinstance(obj, np.ndarray):
        return sanitize(obj.tolist())
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    return obj


def atomic_write_json(path: Path, obj: Any) -> None:
    """tmp + ``os.replace`` in the target directory (rename is atomic only
    within a filesystem)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ResultStore:
    """Atomic section merges into one JSON results document."""

    def __init__(self, path: str | Path = DEFAULT_PATH,
                 history_path: Optional[str | Path] = None):
        self.path = Path(path)
        self.history_path = Path(history_path) if history_path is not None \
            else self.path.parent / HISTORY_NAME

    def load(self) -> Dict[str, Any]:
        if not self.path.exists():
            return {}
        with open(self.path) as f:
            return json.load(f)

    def merge(self, record: Record,
              meta: Optional[Mapping[str, Any]] = None) -> None:
        """Place ``record.data`` at its section path and its claims (as
        ``{name: bool}``) under ``claims_path``, then rewrite atomically;
        append the record to the history with a timestamp plus ``meta``
        (the campaign/stage/run identity the runner passes)."""
        if not record.section:
            raise ValueError("record.section must name at least one key")
        doc = self.load()
        node = self._descend(doc, record.section[:-1])
        node[record.section[-1]] = sanitize(record.data)
        if record.claims:
            cnode = self._descend(doc, record.claims_path)
            for c in record.claims:
                cnode[c.name] = bool(c.ok)
        atomic_write_json(self.path, doc)
        self._append_history(record, meta)

    def _append_history(self, record: Record,
                        meta: Optional[Mapping[str, Any]]) -> None:
        entry = {"ts": time.time(), "meta": sanitize(dict(meta or {})),
                 **record.to_json()}
        line = json.dumps(entry, sort_keys=True) + "\n"
        self.history_path.parent.mkdir(parents=True, exist_ok=True)
        # one write() of a complete line on an O_APPEND handle: atomic
        # with respect to concurrent appenders
        with open(self.history_path, "a") as f:
            f.write(line)

    def history(self) -> list:
        """All history entries, oldest first (empty if none)."""
        if not self.history_path.exists():
            return []
        with open(self.history_path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    @staticmethod
    def _descend(doc: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
        node = doc
        for key in path:
            nxt = node.get(key)
            if not isinstance(nxt, dict):
                nxt = node[key] = {}
            node = nxt
        return node

    def section(self, path: Tuple[str, ...]) -> Optional[Any]:
        """Read one section (``None`` when absent), for runs that compare
        against an earlier stage's merged results."""
        node: Any = self.load()
        for key in path:
            if not isinstance(node, dict) or key not in node:
                return None
            node = node[key]
        return node
