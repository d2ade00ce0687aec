"""The fleet's faults and its bounded-staleness buffer, written again from
their rules in plain numpy (nothing of the program is imported), and the
judge of the masks and bits a fleet round reports.

Fault draw, a pure function of ``(seed, round, worker)``: worker ``gid``
of round ``r`` reads one stream, ``SeedSequence([seed, 2, r, gid])``. It is
on time where its first uniform is under its rate (the participation; with
a skew, ``p + skew u`` clipped to [0.05, 1], ``u`` uniform on [-1, 1) from
``SeedSequence([seed, 1, gid])``). A late update is delayed, where the
staleness is positive and a second uniform is under ``stale_frac``, by
``lag = 1 + integers(staleness)`` rounds, and dropped otherwise. Nothing is
drawn where every worker is always on time.

The buffer, one slot a worker, its timer the rounds until the parked
packet lands (0: empty). In a round:

  in flight   t > 0
  starts      lag > 0, not dropped, not in flight
  acts        not dropped, not starting, not in flight (its participation)
  parks       starts and passes its censor test: its new reconstruction
              and the bits it offered are held, t <- lag
  delivers    in flight and t - 1 == 0: the held reconstruction becomes its
              replica and the held bits are charged

Every worker computes every round (its primal and quantizer advance); a
worker that does not act keeps its replica and is charged nothing. A round
transmits where a worker acts and passes its censor test, or delivers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the per-worker masks and counts a fleet round reports, by the program's
# metric names
MASKS = ("fleet_participation", "fleet_start", "fleet_deliver", "fleet_timer")
REPORTED = MASKS + ("tx_mask", "payload_bits", "censor_mask",
                    "offered_payload_bits")
_TAG_RATE, _TAG_ROUND = 1, 2


@dataclasses.dataclass(frozen=True)
class Faults:
    """A fault scenario: each worker on time with probability
    ``participation`` (spread by ``skew``), a late update delayed by up to
    ``staleness`` rounds with probability ``stale_frac``, else dropped."""

    participation: float
    staleness: int
    stale_frac: float
    skew: float = 0.0

    @staticmethod
    def of(section: dict) -> "Faults":
        return Faults(float(section["participation"]),
                      int(section["staleness"]),
                      float(section["stale_frac"]),
                      float(section.get("skew", 0.0)))

    def rate(self, seed: int, gid: int) -> float:
        if self.skew == 0.0:
            return self.participation
        u = _stream(seed, _TAG_RATE, gid).uniform(-1.0, 1.0)
        return float(np.clip(self.participation + self.skew * u, 0.05, 1.0))

    def draw(self, seed: int, r: int, gids: Sequence[int]
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Round ``r``'s (drop (n,) bool, lag (n,) int) over ``gids``."""
        n = len(gids)
        drop, lag = np.zeros(n, bool), np.zeros(n, np.int64)
        if self.participation >= 1.0 and self.skew == 0.0:
            return drop, lag
        for i, gid in enumerate(gids):
            rng = _stream(seed, _TAG_ROUND, r, int(gid))
            if rng.uniform() < self.rate(seed, int(gid)):
                continue
            if self.staleness > 0 and rng.uniform() < self.stale_frac:
                lag[i] = 1 + rng.integers(self.staleness)
            else:
                drop[i] = True
        return drop, lag


def _stream(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *path]))


def advance(timer: np.ndarray, drop: np.ndarray, lag: np.ndarray,
            censor: np.ndarray) -> Dict[str, np.ndarray]:
    """One round of the buffer from the timers before it, the round's draw
    and each worker's censor decision: the masks (bool) and the timers
    after, with ``drop`` and ``in_flight`` beside them."""
    in_flight = timer > 0
    start = (lag > 0) & ~drop & ~in_flight
    left = np.where(in_flight, timer - 1, 0)
    parked = start & censor
    return {"fleet_participation": ~drop & ~start & ~in_flight,
            "fleet_start": parked,
            "fleet_deliver": in_flight & (left == 0),
            "fleet_timer": np.where(parked, lag, left),
            "drop": drop, "in_flight": in_flight}


def check_rounds(rounds: Sequence[Dict[str, np.ndarray]], seed: int,
                 faults: Faults, gids: Sequence[int]
                 ) -> Tuple[List[int], List[Dict[str, np.ndarray]]]:
    """Every round the program ran, from the first, against the draw and
    the buffer worked out here: ``rounds[r]`` is round r's reported
    per-worker metrics (``REPORTED``). The censor decisions are the
    program's (a judged round's are recomputed by the step's judge). The
    count of wrong entries a round (each mask, the transmissions and the
    bits charged) and the masks worked out for it."""
    n = len(gids)
    timer, held = np.zeros(n, np.int64), np.zeros(n, np.float64)
    errors, masks = [], []
    for r, got in enumerate(rounds):
        drop, lag = faults.draw(seed, r, gids)
        censor = np.asarray(got["censor_mask"]) > 0
        want = advance(timer, drop, lag, censor)
        offered = np.asarray(got["offered_payload_bits"], np.float64)
        acted = censor & want["fleet_participation"]
        deliver = want["fleet_deliver"]
        tx = acted | deliver
        bits = np.where(acted, offered, 0.0) + np.where(deliver, held, 0.0)
        wrong = sum(int(np.sum(np.asarray(got[k]) != want[k]))
                    for k in MASKS)
        wrong += int(np.sum((np.asarray(got["tx_mask"]) > 0) != tx))
        wrong += int(np.sum(np.asarray(got["payload_bits"], np.float64)
                            != bits))
        errors.append(wrong)
        masks.append(want)
        held = np.where(want["fleet_start"], offered,
                        np.where(deliver, 0.0, held))
        timer = want["fleet_timer"]
    return errors, masks


def dark_rounds(masks: Sequence[Dict[str, np.ndarray]], lo: int,
                hi: int) -> int:
    """Worker-rounds of rounds ``lo`` to ``hi - 1`` in which a worker is
    dark through a fault: dropped, parking a packet, or with one in
    flight."""
    return int(sum(np.sum(m["drop"] | m["fleet_start"] | m["in_flight"])
                   for m in masks[lo:hi]))
