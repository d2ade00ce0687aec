"""Tiny stage functions exercising the runner's failure/resume semantics
(a copy of ``repro.campaign._selftest`` over the port's modules).

These exist so tests (and the CI resume smoke) can drive real campaigns
without the benchmark workloads: every behavior is controlled through the
run config — attempt counting lands in ``calls_dir`` files, transient and
fatal failures are triggered by counters and marker files, and a marker
can simulate a mid-campaign kill (``KeyboardInterrupt``). Record data is
deterministic (attempt counts are deliberately excluded) so the
byte-identity of resumed-vs-fresh documents is testable.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.campaign.runner import FatalError, TransientError
from repro_torch.campaign.store import Claim, Record


def _count_call(calls_dir: Optional[str], tag: str) -> int:
    if calls_dir is None:
        return 1
    path = Path(calls_dir) / f"{tag}.calls"
    path.parent.mkdir(parents=True, exist_ok=True)
    n = int(path.read_text()) + 1 if path.exists() else 1
    path.write_text(str(n))
    return n


def emit(tag: str, value: float = 0.0,
         section: Sequence[str] = ("selftest",),
         calls_dir: Optional[str] = None,
         transient_failures: int = 0,
         fatal_marker: Optional[str] = None,
         die_marker: Optional[str] = None,
         ctx=None) -> Record:
    """Emit one deterministic record, optionally failing first.

    * ``transient_failures=k``: the first k calls raise TransientError;
    * ``fatal_marker``: raise FatalError while that file exists;
    * ``die_marker``: raise KeyboardInterrupt while that file exists (a
      simulated SIGINT/SIGTERM mid-campaign).
    """
    calls = _count_call(calls_dir, tag)
    if die_marker is not None and Path(die_marker).exists():
        raise KeyboardInterrupt(f"simulated kill during {tag}")
    if fatal_marker is not None and Path(fatal_marker).exists():
        raise FatalError(f"fatal marker present for {tag}")
    if calls <= transient_failures:
        raise TransientError(f"{tag}: transient failure {calls}")
    return Record(section=tuple(section) + (tag,),
                  data={"tag": tag, "value": value},
                  claims=(Claim(f"{tag}_finite", bool(np.isfinite(value)),
                                value=value, gate="finite"),),
                  claims_path=tuple(section) + ("claims",))


def accumulate(tag: str, steps: int = 8,
               section: Sequence[str] = ("selftest",),
               die_marker: Optional[str] = None,
               die_at_step: int = -1,
               ctx=None) -> Record:
    """A multi-step run checkpointing in-flight state through ``ctx``.

    Accumulates ``sum(range(steps))`` one step at a time, checkpointing
    after every step; when ``die_marker`` exists the run is killed at
    ``die_at_step``. A resumed invocation restores the NPZ checkpoint and
    finishes from there — ``resumed_from`` records where it picked up.
    """
    template = {"acc": np.zeros((), np.float64)}
    start, acc = 0, 0.0
    if ctx is not None:
        restored = ctx.restore(template)
        if restored is not None:
            tree, start = restored
            acc = float(tree["acc"])
    for step in range(start, steps):
        if (die_marker is not None and step == die_at_step
                and Path(die_marker).exists()):
            raise KeyboardInterrupt(f"simulated kill at step {step}")
        acc += float(step)
        if ctx is not None:
            ctx.checkpoint(step + 1, {"acc": np.float64(acc)})
    return Record(section=tuple(section) + (tag,),
                  data={"tag": tag, "acc": acc, "resumed_from": start},
                  claims=(Claim(f"{tag}_sum_ok",
                                acc == sum(range(steps)),
                                value=acc, gate=f"== {sum(range(steps))}"),),
                  claims_path=tuple(section) + ("claims",))
