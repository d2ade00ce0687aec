"""Communication accounting: rounds, links, bits, transmit energy (Sec. 7).

The paper's energy model ("Communication Energy" paragraph):

  * total system bandwidth W = 2 MHz, equally divided across the workers that
    transmit in a round. GGADMM-family: only half the workers (one group)
    transmit per round  -> B_n = 2W/N = (4/N) MHz.
    C-ADMM (Jacobian, all workers transmit) -> B_n = W/N = (2/N) MHz.
  * power spectral density N0 = 1e-6 W/Hz, slot length tau = 1 ms.
  * free-space model: a worker transmits at the power that delivers its
    payload within one slot to its worst (farthest) neighbor:
        rate  R = payload_bits / tau            [bits/s]
        P     = tau * D^2 * N0 * B_n * (2^{R / B_n} - 1)     (as printed)
        E     = P * tau.
    The leading tau in P is reproduced verbatim from the paper; it scales all
    algorithms identically so comparisons are unaffected.

Worker positions are sampled uniformly in a `field_size`-meter square; D_n is
the distance to the farthest neighbor of worker n in the graph.

This is the port's own numpy copy of ``repro.core.comm``: a port run's
rounds, bits and energy come from the same formula as the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import WorkerGraph


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    bandwidth_hz: float = 2e6
    n0: float = 1e-6           # W/Hz
    tau: float = 1e-3          # s, one upload slot
    field_size: float = 100.0  # m, side of the placement square
    seed: int = 0
    paper_power_formula: bool = True  # keep the printed extra tau factor

    def worker_bandwidth(self, n_workers: int, fraction_active: float) -> float:
        """B_n when `fraction_active` of the N workers share the band."""
        active = max(1.0, fraction_active * n_workers)
        return self.bandwidth_hz / active

    def placements(self, n_workers: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.uniform(0.0, self.field_size, size=(n_workers, 2))

    def link_distances(self, graph: WorkerGraph) -> np.ndarray:
        """(E,) length of each undirected edge (head-tail placement
        distance), aligned with ``graph.edges`` — the same edge arrays the
        sparse topology backend mixes over."""
        pos = self.placements(graph.n)
        e = np.asarray(graph.edges)
        return np.linalg.norm(pos[e[:, 0]] - pos[e[:, 1]], axis=-1)

    def worst_link_distance(self, graph: WorkerGraph) -> np.ndarray:
        """(N,) distance from each worker to its farthest graph neighbor,
        reduced over the per-edge distances (O(E), no (N, N) mask)."""
        d_e = self.link_distances(graph)
        e = np.asarray(graph.edges)
        out = np.zeros(graph.n)
        np.maximum.at(out, e[:, 0], d_e)
        np.maximum.at(out, e[:, 1], d_e)
        return out

    def energy_per_transmission(self, payload_bits: np.ndarray,
                                distance: np.ndarray,
                                bandwidth) -> np.ndarray:
        """E = P * tau for each worker's payload (vectorized; ``bandwidth``
        may be a scalar or a broadcastable per-round array)."""
        rate = payload_bits / self.tau
        snr_term = np.exp2(rate / bandwidth) - 1.0
        power = distance ** 2 * self.n0 * bandwidth * snr_term
        if self.paper_power_formula:
            power = self.tau * power
        return power * self.tau


@dataclasses.dataclass
class CommLog:
    """Aggregated per-iteration communication metrics for a run."""

    # each is a list/array over iterations
    transmissions: np.ndarray   # number of workers that transmitted
    bits: np.ndarray            # total bits moved this iteration
    energy: np.ndarray          # total transmit energy this iteration [J]

    @property
    def cumulative_rounds(self) -> np.ndarray:
        """Paper's 'communication rounds' = cumulative worker-broadcasts."""
        return np.cumsum(self.transmissions)

    @property
    def cumulative_bits(self) -> np.ndarray:
        return np.cumsum(self.bits)

    @property
    def cumulative_energy(self) -> np.ndarray:
        return np.cumsum(self.energy)


def build_comm_log(tx_mask_per_iter: np.ndarray,
                   payload_bits_per_iter: np.ndarray,
                   graph: WorkerGraph,
                   model: Optional[EnergyModel] = None,
                   fraction_active: float = 0.5,
                   bandwidth_mode: str = "fixed") -> CommLog:
    """Turn per-(iteration, worker) masks/payloads into aggregate metrics.

    Args:
      tx_mask_per_iter: (K, N) 0/1 — worker transmitted at iteration k.
      payload_bits_per_iter: (K, N) payload size had the worker transmitted.
      graph: worker graph (for distances).
      model: energy model; default per Sec. 7.
      fraction_active: band-sharing fraction (0.5 for GGADMM-family, 1.0 for
        Jacobian C-ADMM).
      bandwidth_mode: "fixed" (default) reproduces the paper — every round
        divides W by the *constant* ``fraction_active * N``, even when
        censoring silences most of the group. "actual" divides W by the
        number of workers that really share the slot: with alternating
        phases (``fraction_active < 1``) heads and tails transmit in
        different slots, so each transmitter splits W with the *other
        transmitters of its own side* that round; Jacobian rounds
        (``fraction_active >= 1``) share one slot among all transmitters.
        Survivors of a heavily censored round get more band and finish at
        lower power — a deviation from the printed model, recorded in
        DESIGN.md §Topology.
    """
    assert bandwidth_mode in ("fixed", "actual"), bandwidth_mode
    model = model or EnergyModel()
    dist = model.worst_link_distance(graph)           # (N,)
    tx = np.asarray(tx_mask_per_iter, dtype=np.float64)
    payload = np.asarray(payload_bits_per_iter, dtype=np.float64)
    if bandwidth_mode == "fixed":
        bw = model.worker_bandwidth(graph.n, fraction_active)
    else:
        # (K, N) per-worker bandwidth from the actual transmitter count of
        # the worker's own slot; idle slots keep the whole band (no
        # transmission => no energy either way).
        if fraction_active >= 1.0:      # Jacobian: one slot for everyone
            sharers = np.maximum(tx.sum(axis=1), 1.0)[:, None]
        else:                           # GGADMM: head and tail slots
            head = np.asarray(graph.head_mask, dtype=bool)
            h_cnt = np.maximum(tx[:, head].sum(axis=1), 1.0)[:, None]
            t_cnt = np.maximum(tx[:, ~head].sum(axis=1), 1.0)[:, None]
            sharers = np.where(head[None, :], h_cnt, t_cnt)
        bw = model.bandwidth_hz / sharers
    energy = model.energy_per_transmission(payload, dist[None, :], bw)
    return CommLog(
        transmissions=tx.sum(axis=1),
        bits=(tx * payload).sum(axis=1),
        energy=(tx * energy).sum(axis=1),
    )
