"""Live communication ledger over the engine's per-round metrics (paper
Sec. 7; the port of ``repro.obs.ledger``).

The engine step already returns everything the paper measures:
``tx_mask``/``payload_bits`` (bits actually moved after censoring and
timeouts), ``candidate_payload_bits``/``offered_payload_bits`` (what the
round would have cost), ``censor_mask`` (the censor-only decision), and
the per-quantization-group ``group_tx``/``bits_per_group`` diagnostics.
:class:`CommLedger` folds each round's host-side copy of those arrays
into the running totals a `comm.build_comm_log` post-hoc pass would
produce — cumulative communication rounds (worker-broadcasts), bits,
and transmit energy under `comm.EnergyModel` — plus the per-group
censoring rate, and streams them as Chrome-trace counter events when a
tracer is active.

Strictly an observer: it only reads a host copy of arrays the step
already returned (``.cpu().numpy()`` at the call site, made only while a
tracer is active), so enabling it cannot change any trajectory or which
kernels run. On the card that copy is the one synchronisation tracing
adds: a round span that closes after it covers the round's device work.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from repro_torch.core.comm import EnergyModel
from repro_torch.obs import trace as obs_trace


class CommLedger:
    """Streaming cumulative rounds/bits/energy + censoring-rate tracker.

    Matches :func:`repro_torch.core.comm.build_comm_log` with
    ``bandwidth_mode="fixed"`` round-for-round (pinned in
    ``tests/test_torch_obs.py``), but runs online instead of post-hoc.
    """

    def __init__(self, graph, model: Optional[EnergyModel] = None,
                 fraction_active: float = 0.5,
                 subsystem: str = "engine", track: str = "ledger"):
        self.model = model or EnergyModel()
        self.fraction_active = float(fraction_active)
        self.subsystem = subsystem
        self.track_name = track
        self.rounds = 0                 # engine rounds observed
        self.cum_transmissions = 0.0    # paper's "communication rounds"
        self.cum_bits = 0.0
        self.cum_offered_bits = 0.0
        self.cum_energy = 0.0
        self.censor_rate = 0.0          # last round, fraction censored
        self.group_censor_rate = np.zeros(0)
        self.rebuild(graph)

    def rebuild(self, graph) -> None:
        """Re-derive placements/distances after the graph changes (churn)."""
        self.graph = graph
        self._dist = self.model.worst_link_distance(graph)
        self._bw = self.model.worker_bandwidth(graph.n, self.fraction_active)

    def update(self, metrics: Mapping[str, Any]) -> Dict[str, float]:
        """Fold one round of host-side metric arrays into the totals and
        (if tracing) emit counter events. Returns this round's totals."""
        tx = np.asarray(metrics["tx_mask"], dtype=np.float64)
        payload = np.asarray(metrics["payload_bits"], dtype=np.float64)
        offered = np.asarray(
            metrics.get("offered_payload_bits", payload), dtype=np.float64)
        energy = self.model.energy_per_transmission(payload, self._dist, self._bw)

        round_tx = float(tx.sum())
        round_bits = float((tx * payload).sum())
        round_energy = float((tx * energy).sum())
        self.rounds += 1
        self.cum_transmissions += round_tx
        self.cum_bits += round_bits
        self.cum_offered_bits += float(offered.sum())
        self.cum_energy += round_energy

        n = max(1, tx.shape[0])
        censor = metrics.get("censor_mask")
        if censor is not None:
            # censor_mask is 1 where the censor test *passed*; the rate we
            # report is the fraction of workers silenced by it this round.
            self.censor_rate = 1.0 - float(np.asarray(censor).sum()) / n
        group_tx = metrics.get("group_tx")
        if group_tx is not None:
            gtx = np.asarray(group_tx, dtype=np.float64)   # (N, G)
            self.group_censor_rate = 1.0 - gtx.sum(axis=0) / n

        totals = self.totals()
        tr = obs_trace.tracer()
        if tr is not None:
            tid = tr.track(self.subsystem, self.track_name)
            tr.counter("ledger", self.subsystem, {
                "cum_rounds": self.cum_transmissions,
                "cum_bits": self.cum_bits,
                "cum_energy_j": self.cum_energy,
            }, tid=tid)
            rates = {"global": self.censor_rate}
            for g, r in enumerate(self.group_censor_rate):
                rates[f"g{g}"] = float(r)
            tr.counter("censor_rate", self.subsystem, rates, tid=tid)
        return totals

    def totals(self) -> Dict[str, float]:
        return {
            "rounds": self.rounds,
            "cum_transmissions": self.cum_transmissions,
            "cum_bits": self.cum_bits,
            "cum_offered_bits": self.cum_offered_bits,
            "cum_energy_j": self.cum_energy,
            "censor_rate": self.censor_rate,
            "group_censor_rate": [float(r) for r in self.group_censor_rate],
        }
