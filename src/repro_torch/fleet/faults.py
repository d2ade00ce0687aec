"""Seeded fault schedules for the fleet simulator (DESIGN.md §Fleet).

The port's own copy of ``repro.fleet.faults`` (numpy only; the port never
imports the JAX package): the same config gives the same draws, array for
array, which ``tests/test_torch_fleet.py`` holds.

A :class:`FaultSchedule` is a pure function of ``(seed, round, worker
gid)``: every per-round draw routes through an independent
``SeedSequence([seed, tag, round, gid])`` stream, so the same
:class:`FaultConfig` always replays the identical participation, staleness
and churn trace regardless of query order or membership history (worker
gids are global and never reused).

Per round, each worker independently misses its transmission deadline with
probability ``1 - participation`` (optionally with a per-worker skewed
rate). A late update is either

* **delayed** (probability ``stale_frac``, when ``staleness > 0``): it
  arrives ``lag ~ Uniform{1..staleness}`` rounds later and the bounded-
  staleness buffer in ``fleet/sim.py`` delivers the held value then; or
* **dropped** (otherwise): for the consensus engine the round looks like a
  censored one (the worker's ``theta_hat`` replica stays stale and zero
  bits are charged).

Churn is a sparse list of :class:`ChurnEvent`s: at the given round the
schedule picks which members leave and how many fresh workers join;
``fleet/sim.py`` turns that into a graph redraw and a state remap.

Also here: :func:`staleness_trace`, the numpy mirror of the staleness-buffer
automaton of ``fleet/sim.py``, used by the tests to check it round for
round.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# stream tags: keep the per-purpose SeedSequence streams disjoint
_TAG_RATE, _TAG_ROUND, _TAG_CHURN = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """A membership change: at the start of ``round``, ``leave`` members
    drop out (picked by the schedule) and ``join`` fresh workers enroll."""

    round: int
    leave: int = 0
    join: int = 0

    def __post_init__(self):
        assert self.round >= 0 and self.leave >= 0 and self.join >= 0


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of one fault scenario (all faults off by default — the
    default-constructed config is the synchronous golden path)."""

    participation: float = 1.0    # P(update arrives on time) per round
    skew: float = 0.0             # per-worker spread of on-time rates:
    #                               rate_n ~ U[p - skew, p + skew], clipped
    staleness: int = 0            # max delivery lag L (rounds); 0 = drop
    stale_frac: float = 1.0       # P(late update is delayed vs dropped)
    churn: Tuple[ChurnEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        assert 0.0 < self.participation <= 1.0
        assert 0.0 <= self.skew <= 1.0
        assert self.staleness >= 0
        assert 0.0 <= self.stale_frac <= 1.0

    @property
    def fault_free(self) -> bool:
        return (self.participation >= 1.0 and self.skew == 0.0
                and not self.churn)


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """One round's fault draw over the current members (arrays indexed by
    member position, aligned with the worker axis of the engine state)."""

    drop: np.ndarray   # (N,) f32 1 => this round's update is lost entirely
    lag: np.ndarray    # (N,) i32 > 0 => delayed, delivered `lag` rounds on


def _stream(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *path]))


class FaultSchedule:
    """Deterministic fault trace generator for one :class:`FaultConfig`."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._churn = {e.round: e for e in cfg.churn}
        assert len(self._churn) == len(cfg.churn), \
            "at most one churn event per round"

    # ------------------------------------------------------ per worker --
    def worker_rate(self, gid: int) -> float:
        """On-time probability of worker ``gid`` (static per worker)."""
        p = self.cfg.participation
        if self.cfg.skew == 0.0:
            return p
        u = _stream(self.cfg.seed, _TAG_RATE, gid).uniform(-1.0, 1.0)
        return float(np.clip(p + self.cfg.skew * u, 0.05, 1.0))

    # ------------------------------------------------------- per round --
    def round_faults(self, r: int, member_gids: Sequence[int]) -> RoundFaults:
        """Draw the (drop, lag) arrays for round ``r`` over the members."""
        n = len(member_gids)
        drop = np.zeros(n, np.float32)
        lag = np.zeros(n, np.int32)
        cfg = self.cfg
        if cfg.participation >= 1.0 and cfg.skew == 0.0:
            return RoundFaults(drop=drop, lag=lag)
        for i, gid in enumerate(member_gids):
            rng = _stream(cfg.seed, _TAG_ROUND, r, int(gid))
            if rng.uniform() < self.worker_rate(int(gid)):
                continue                      # on time
            if cfg.staleness > 0 and rng.uniform() < cfg.stale_frac:
                lag[i] = 1 + rng.integers(cfg.staleness)
            else:
                drop[i] = 1.0
        return RoundFaults(drop=drop, lag=lag)

    # ----------------------------------------------------------- churn --
    def churn_at(self, r: int) -> Optional[ChurnEvent]:
        return self._churn.get(r)

    def pick_leavers(self, r: int, member_gids: Sequence[int],
                     k: int) -> List[int]:
        """Deterministically pick ``k`` members to drop at round ``r``,
        clamped so at least 2 workers always remain before joins."""
        k = min(k, max(len(member_gids) - 2, 0))
        if k == 0:
            return []
        rng = _stream(self.cfg.seed, _TAG_CHURN, r)
        pick = rng.choice(len(member_gids), size=k, replace=False)
        return [int(member_gids[i]) for i in sorted(pick)]


def staleness_trace(drops: np.ndarray, lags: np.ndarray,
                    offered: Optional[np.ndarray] = None,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-python mirror of the bounded-staleness automaton.

    Replays the per-worker timer state machine of ``fleet/sim.py`` on host
    arrays: a worker whose round-r update is delayed (``lag > 0``) goes
    *dark* — it participates neither this round (its packet is in flight)
    nor until the timer expires; at expiry the held value is delivered.
    ``offered`` optionally gates buffer starts on the censor decision (a
    late worker whose update would have been censored anyway buffers
    nothing — there is no packet to deliver).

    Args:
      drops: (T, N) f32 — 1 where the round's update is dropped outright.
      lags: (T, N) i32 — delivery lag of delayed updates (0 = on time).
      offered: optional (T, N) 0/1 censor-pass mask; default all-ones.

    Returns:
      ``(participation (T, N) f32, deliver (T, N) f32, timer (T, N) i32)``
      — the on-time mask handed to the engine each round, the delivery
      events, and the post-round timer state. Invariant mirrored from
      ``fleet/sim.py``: at most one packet in flight per worker (a worker with
      a full buffer is simply dark until delivery).
    """
    drops = np.asarray(drops, np.float32)
    lags = np.asarray(lags, np.int32)
    t_rounds, n = drops.shape
    if offered is None:
        offered = np.ones((t_rounds, n), np.float32)
    timer = np.zeros(n, np.int32)
    participation = np.zeros((t_rounds, n), np.float32)
    deliver = np.zeros((t_rounds, n), np.float32)
    timers = np.zeros((t_rounds, n), np.int32)
    for r in range(t_rounds):
        inflight = timer > 0
        start = (lags[r] > 0) & (drops[r] == 0) & ~inflight
        participation[r] = ((drops[r] == 0) & ~start & ~inflight
                            ).astype(np.float32)
        started = start & (offered[r] > 0)
        timer_dec = np.where(inflight, timer - 1, 0)
        deliver[r] = (inflight & (timer_dec == 0)).astype(np.float32)
        timer = np.where(started, lags[r], timer_dec).astype(np.int32)
        timers[r] = timer
    return participation, deliver, timers
