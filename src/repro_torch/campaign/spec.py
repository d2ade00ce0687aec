"""Declarative campaign specs: a copy of ``repro.campaign.spec`` (pure
Python; ``tests/test_torch_campaign.py`` holds it to the original).

Specs are plain Python — dataclasses over dicts, no YAML dependency. A
campaign is named stages of runs with explicit inter-stage dependencies; a
run is a ``RunSpec``: a lazily-imported function (``"module.path:func"``)
plus the resolved config it is called with. The run's identity is the
SHA-256 hash of the canonical JSON of ``(stage, fn, config)`` — two specs
with the same resolved config share a key (and therefore a results
directory), any config change yields a new key, and key computation never
imports the target module.

``sweep(**axes)`` is the grid expander: the Cartesian product of the axes
in the given order, each point a plain config dict ready to become one
``RunSpec``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import itertools
import json
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, \
    Sequence, Tuple


def sweep(**axes: Iterable) -> List[Dict[str, Any]]:
    """Expand named axes into the full grid, one config dict per point.

    >>> sweep(groups=["model", "leaf"], censor_mode=["global"])
    [{'groups': 'model', 'censor_mode': 'global'},
     {'groups': 'leaf', 'censor_mode': 'global'}]
    """
    expanded = {name: list(vals) for name, vals in axes.items()}
    return [dict(zip(expanded, point))
            for point in itertools.product(*expanded.values())]


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace — the hash input."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def run_key(stage_name: str, fn: str, config: Mapping[str, Any]) -> str:
    """Deterministic run identity from the resolved config (12 hex chars)."""
    payload = canonical_json(
        {"stage": stage_name, "fn": fn, "config": dict(config)})
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run: a function reference plus its fully-resolved config."""

    stage: str
    fn: str                       # "module.path:function", imported lazily
    config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""                # display name; derived when empty

    def __post_init__(self):
        if ":" not in self.fn:
            raise ValueError(f"fn must be 'module:function', got {self.fn!r}")
        try:
            canonical_json(dict(self.config))
        except TypeError as e:
            raise TypeError(
                f"run config for {self.fn} must be JSON-serializable "
                f"(it is hashed into the run key): {e}") from e

    @property
    def key(self) -> str:
        return run_key(self.stage, self.fn, self.config)

    @property
    def display(self) -> str:
        if self.name:
            return self.name
        if self.config:
            return " ".join(f"{k}={v}" for k, v in self.config.items())
        return self.fn.split(":")[-1]

    def resolve(self) -> Callable:
        module, func = self.fn.split(":", 1)
        return getattr(importlib.import_module(module), func)


@dataclasses.dataclass(frozen=True)
class Stage:
    """An ordered list of runs plus the stages that must complete first."""

    name: str
    runs: Tuple[RunSpec, ...]
    deps: Tuple[str, ...] = ()


def stage(name: str, fn: str,
          configs: Optional[Sequence[Mapping[str, Any]]] = None,
          deps: Sequence[str] = (),
          names: Optional[Sequence[str]] = None) -> Stage:
    """Build a Stage with one ``RunSpec`` per config (default: one run)."""
    configs = list(configs) if configs is not None else [{}]
    names = list(names) if names is not None else [""] * len(configs)
    if len(names) != len(configs):
        raise ValueError(f"stage {name}: {len(names)} names for "
                         f"{len(configs)} configs")
    runs = tuple(RunSpec(stage=name, fn=fn, config=dict(c), name=n)
                 for c, n in zip(configs, names))
    return Stage(name=name, runs=runs, deps=tuple(deps))


@dataclasses.dataclass(frozen=True)
class Campaign:
    """A named DAG of stages. ``validate()`` runs at registration."""

    name: str
    stages: Tuple[Stage, ...]

    def stage(self, name: str) -> Stage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"campaign {self.name} has no stage {name!r} "
                       f"(stages: {[s.name for s in self.stages]})")

    def validate(self) -> None:
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"campaign {self.name}: duplicate stage names")
        for s in self.stages:
            for d in s.deps:
                if d not in names:
                    raise ValueError(f"campaign {self.name}: stage {s.name} "
                                     f"depends on unknown stage {d!r}")
        self.topological()                     # raises on cycles
        keys = [r.key for s in self.stages for r in s.runs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"campaign {self.name}: duplicate run keys "
                             f"(two runs share stage+fn+config)")

    def topological(self) -> Tuple[Stage, ...]:
        """Stages in dependency order, stable w.r.t. declaration order."""
        done: List[Stage] = []
        placed: set = set()
        remaining = list(self.stages)
        while remaining:
            ready = [s for s in remaining
                     if all(d in placed for d in s.deps)]
            if not ready:
                raise ValueError(f"campaign {self.name}: dependency cycle "
                                 f"among {[s.name for s in remaining]}")
            for s in ready:
                done.append(s)
                placed.add(s.name)
                remaining.remove(s)
        return tuple(done)

    def closure(self, stage_name: str) -> Tuple[str, ...]:
        """``stage_name`` plus its transitive dependencies."""
        need = {stage_name}
        frontier = [stage_name]
        while frontier:
            for d in self.stage(frontier.pop()).deps:
                if d not in need:
                    need.add(d)
                    frontier.append(d)
        return tuple(s.name for s in self.stages if s.name in need)

    def subset(self, stage_names: Sequence[str]) -> "Campaign":
        """A campaign restricted to ``stage_names`` (deps must survive)."""
        keep = set(stage_names)
        sub = Campaign(name=self.name,
                       stages=tuple(s for s in self.stages
                                    if s.name in keep))
        sub.validate()
        return sub


CAMPAIGNS: Dict[str, Campaign] = {}


def register_campaign(campaign: Campaign) -> Campaign:
    campaign.validate()
    CAMPAIGNS[campaign.name] = campaign
    return campaign


def get_campaign(name: str) -> Campaign:
    if name not in CAMPAIGNS:
        raise KeyError(f"unknown campaign {name!r} "
                       f"(registered: {sorted(CAMPAIGNS)})")
    return CAMPAIGNS[name]
