"""Campaign runner: topological execution with retry and crash-resume.
The port of ``repro.campaign.runner``: the same stdout protocol, byte for
byte, and the same files.

Each run gets a directory ``<state_root>/<campaign>/<run_key>/`` holding

* ``status.json`` — ``pending/running/done/failed`` plus attempt count,
* ``record.json`` — the emitted :class:`~repro_torch.campaign.store.Record`
  (written atomically; its existence marks the run completed),
* ``ckpt/`` — optional in-flight NPZ checkpoints a stage function writes
  through :meth:`RunContext.checkpoint` (``checkpoint/npz.py``, which
  also takes an ``EngineState`` and numpy arrays).

Error classification: a stage function raises :class:`TransientError` for
failures worth retrying (flaky I/O, busy devices) — the runner retries with
exponential backoff up to ``RetryPolicy.max_retries``. Anything else is
fatal: recorded, not retried. ``KeyboardInterrupt``/``SystemExit``
propagate so a kill stops the campaign mid-flight; on re-invocation with
``resume=True`` completed runs are detected via ``record.json`` and their
records re-merged (not re-executed), which makes a resumed campaign's
merged document byte-identical to an uninterrupted one.

The device a campaign runs on (``Runner(..., device=...)``: the card by
default, ``"cpu"`` when asked) reaches stage functions as
``RunContext.device``; it stays out of the run key, so a run has one key on
the CPU and on the card. Nothing classifies a CUDA error as transient: it
is fatal, recorded and not retried.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.campaign.spec import Campaign, RunSpec, Stage
from repro_torch.campaign.store import Record, ResultStore, atomic_write_json
from repro_torch.checkpoint import npz as _npz
from repro_torch.obs import trace as obs_trace

DEFAULT_STATE_ROOT = "campaigns/torch"


class TransientError(RuntimeError):
    """Retryable failure (bounded retry with backoff)."""


class FatalError(RuntimeError):
    """Non-retryable failure: recorded and surfaced, never retried."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 2          # retries after the first attempt
    backoff_s: float = 0.5
    backoff_mult: float = 2.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return self.backoff_s * self.backoff_mult ** (attempt - 1)


class RunContext:
    """Handed to stage functions that accept a ``ctx`` argument."""

    def __init__(self, spec: RunSpec, run_dir: Path, store: ResultStore,
                 device: Any = None):
        self.spec = spec
        self.dir = Path(run_dir)
        self.store = store
        self.device = device      # None: the card; "cpu" when asked

    @property
    def ckpt_dir(self) -> Path:
        return self.dir / "ckpt"

    def checkpoint(self, step: int, tree: Any, keep: int = 2) -> Path:
        """Checkpoint in-flight state (a tree, an ``EngineState``, numpy
        arrays) at ``step``."""
        return _npz.save(self.ckpt_dir, step, tree, keep=keep)

    def restore(self, template: Any) -> Optional[Tuple[Any, int]]:
        """Latest in-flight checkpoint as ``(tree, step)``, else None."""
        if _npz.latest_step(self.ckpt_dir) is None:
            return None
        return _npz.restore(self.ckpt_dir, template)


@dataclasses.dataclass
class RunResult:
    spec: RunSpec
    status: str                   # done | skipped | failed | blocked
    attempts: int = 0
    error: str = ""
    claims_failed: int = 0


@dataclasses.dataclass
class Summary:
    campaign: str
    results: List[RunResult]

    def count(self, status: str) -> int:
        return sum(r.status == status for r in self.results)

    @property
    def executed(self) -> int:
        return self.count("done")

    @property
    def skipped(self) -> int:
        return self.count("skipped")

    @property
    def failed(self) -> int:
        return self.count("failed") + self.count("blocked")

    @property
    def claims_failed(self) -> int:
        return sum(r.claims_failed for r in self.results)

    @property
    def exit_code(self) -> int:
        return 1 if (self.failed or self.claims_failed) else 0


class Runner:
    """Execute one campaign against a store and a state directory."""

    def __init__(self, campaign: Campaign,
                 store: Optional[ResultStore] = None,
                 state_root: str | Path = DEFAULT_STATE_ROOT,
                 retry: RetryPolicy = RetryPolicy(),
                 resume: bool = False,
                 only: Optional[str] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 device: Any = None):
        self.campaign = campaign
        self.store = store if store is not None else ResultStore()
        self.state_root = Path(state_root)
        self.retry = retry
        self.resume = resume
        self.only = only
        self.sleep = sleep
        self.device = device

    # ------------------------------------------------------------ layout --
    def run_dir(self, spec: RunSpec) -> Path:
        return self.state_root / self.campaign.name / spec.key

    def completed(self, spec: RunSpec) -> bool:
        return (self.run_dir(spec) / "record.json").exists()

    def _load_record(self, spec: RunSpec) -> Record:
        with open(self.run_dir(spec) / "record.json") as f:
            return Record.from_json(json.load(f))

    def _set_status(self, spec: RunSpec, status: str, attempts: int = 0,
                    error: str = "") -> None:
        atomic_write_json(self.run_dir(spec) / "status.json",
                          {"stage": spec.stage, "name": spec.display,
                           "key": spec.key, "status": status,
                           "attempts": attempts, "error": error})

    def _event(self, **fields: Any) -> None:
        """Append one structured event to ``<campaign>/events.jsonl`` — the
        machine-readable mirror of the ``run,...``/``claim,...`` stdout
        lines (whose format CI parses and which stays byte-identical).
        A single write() of a complete line keeps appends atomic."""
        path = self.state_root / self.campaign.name / "events.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        fields.setdefault("ts", time.time())
        with open(path, "a") as f:
            f.write(json.dumps(fields, sort_keys=True) + "\n")

    def _meta(self, spec: RunSpec) -> Dict[str, Any]:
        return {"campaign": self.campaign.name, "stage": spec.stage,
                "key": spec.key, "name": spec.display}

    # --------------------------------------------------------- execution --
    def _stage_plan(self) -> List[Tuple[Stage, bool]]:
        """Topologically-ordered ``(stage, resume_for_stage)`` pairs.

        With ``only``, the target stage plus its transitive deps are
        selected; dependency stages always run resume-style (their
        completed runs are skipped, incomplete ones executed) so the
        target sees satisfied dependencies without redundant re-execution.
        """
        order = self.campaign.topological()
        if self.only is None:
            return [(s, self.resume) for s in order]
        need = set(self.campaign.closure(self.only))
        return [(s, True if s.name != self.only else self.resume)
                for s in order if s.name in need]

    def run(self) -> Summary:
        results: List[RunResult] = []
        failed_stages: set = set()
        for st, stage_resume in self._stage_plan():
            blocked = [d for d in st.deps if d in failed_stages]
            if blocked:
                for spec in st.runs:
                    print(f"run,{st.name},{spec.key},{spec.display},blocked")
                    self._event(event="run", status="blocked",
                                **self._meta(spec))
                    results.append(RunResult(spec, "blocked",
                                             error=f"dependency failed: "
                                                   f"{blocked}"))
                failed_stages.add(st.name)
                continue
            stage_failed = False
            for spec in st.runs:
                res = self._run_one(spec, stage_resume)
                results.append(res)
                stage_failed |= res.status == "failed"
            if stage_failed:
                failed_stages.add(st.name)
        summary = Summary(self.campaign.name, results)
        print(f"# campaign {self.campaign.name}: "
              f"executed={summary.executed} skipped={summary.skipped} "
              f"failed={summary.failed} "
              f"claim_failures={summary.claims_failed}")
        self._event(event="summary", campaign=self.campaign.name,
                    executed=summary.executed, skipped=summary.skipped,
                    failed=summary.failed,
                    claim_failures=summary.claims_failed)
        return summary

    def _run_one(self, spec: RunSpec, resume: bool) -> RunResult:
        rdir = self.run_dir(spec)
        if resume and self.completed(spec):
            # re-merge the persisted record so the store document is
            # complete (and byte-identical) even if the previous process
            # died between the record write and the store merge
            record = self._load_record(spec)
            self.store.merge(record, meta=self._meta(spec))
            print(f"run,{spec.stage},{spec.key},{spec.display},skipped")
            self._event(event="run", status="skipped", **self._meta(spec))
            return RunResult(spec, "skipped")

        rdir.mkdir(parents=True, exist_ok=True)
        tr = obs_trace.tracer()
        tid = tr.track("campaign", f"{spec.stage}/{spec.display}") \
            if tr is not None else 0
        if tr is not None:
            tr.begin("run", "campaign", tid,
                     args={"stage": spec.stage, "key": spec.key,
                           "name": spec.display})
        try:
            return self._execute(spec, rdir, tr, tid)
        finally:
            if tr is not None:
                tr.end("campaign", tid)

    def _execute(self, spec: RunSpec, rdir: Path, tr, tid) -> RunResult:
        fn = spec.resolve()
        kwargs = dict(spec.config)
        if "ctx" in inspect.signature(fn).parameters:
            kwargs["ctx"] = RunContext(spec, rdir, self.store,
                                       self.device)

        attempts = 0
        while True:
            attempts += 1
            self._set_status(spec, "running", attempts)
            try:
                record = fn(**kwargs)
                break
            except TransientError as e:
                if attempts > self.retry.max_retries:
                    return self._fail(spec, attempts,
                                      f"transient (retries exhausted): {e}")
                delay = self.retry.delay(attempts)
                print(f"# run {spec.stage}/{spec.display}: transient "
                      f"failure (attempt {attempts}), retrying in "
                      f"{delay:.1f}s: {e}")
                self._event(event="retry", attempt=attempts, error=str(e),
                            **self._meta(spec))
                if tr is not None:
                    tr.instant("retry", "campaign", tid,
                               args={"attempt": attempts})
                self.sleep(delay)
            except (KeyboardInterrupt, SystemExit):
                raise                         # a kill stops the campaign
            except Exception as e:            # fatal: never retried
                traceback.print_exc()
                return self._fail(spec, attempts, f"fatal: {e}")

        if not isinstance(record, Record):
            return self._fail(spec, attempts,
                              f"stage fn returned {type(record).__name__}, "
                              f"expected campaign.store.Record")
        # persist, then merge FROM the persisted bytes: the fresh path and
        # the resumed path go through the identical JSON round-trip, so a
        # killed-and-resumed campaign reproduces the same document bytes
        atomic_write_json(rdir / "record.json", record.to_json())
        record = self._load_record(spec)
        self.store.merge(record, meta=self._meta(spec))
        self._set_status(spec, "done", attempts)
        n_bad = sum(not c.ok for c in record.claims)
        for c in record.claims:
            print(f"claim,{spec.stage},{c.name},{'PASS' if c.ok else 'FAIL'}")
            self._event(event="claim", claim=c.name, ok=bool(c.ok),
                        **self._meta(spec))
        print(f"run,{spec.stage},{spec.key},{spec.display},done")
        self._event(event="run", status="done", attempts=attempts,
                    **self._meta(spec))
        return RunResult(spec, "done", attempts, claims_failed=n_bad)

    def _fail(self, spec: RunSpec, attempts: int, error: str) -> RunResult:
        self._set_status(spec, "failed", attempts, error)
        print(f"run,{spec.stage},{spec.key},{spec.display},failed  # {error}")
        self._event(event="run", status="failed", attempts=attempts,
                    error=error, **self._meta(spec))
        return RunResult(spec, "failed", attempts, error)

    # ------------------------------------------------------------ listing --
    def describe(self) -> List[str]:
        """Human-readable plan with per-run completion status."""
        lines = [f"campaign {self.campaign.name}:"]
        for st in self.campaign.topological():
            deps = f" (deps: {', '.join(st.deps)})" if st.deps else ""
            lines.append(f"  stage {st.name} [{len(st.runs)} runs]{deps}")
            for spec in st.runs:
                mark = "done   " if self.completed(spec) else "pending"
                lines.append(f"    [{mark}] {spec.key}  {spec.display}")
        return lines
