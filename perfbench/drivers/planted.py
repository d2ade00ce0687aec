"""Faults planted in the program's kernels, for the tests and readings that
show the comparison catches them; never on a benchmark run.

``no_exchange``: every mix (B2, B6) returns zeros, as if no worker heard
its neighbours. ``altered``: B1's reconstruction is altered at one entry
where it is produced (the LM driver alters its rows' labels instead).
A fleet's two: ``deliver_now``, the fault schedule's lags ignored by the
fleet step (a late update goes out on time, never parked);
``no_timeout``, the timeout not composed into the transmit decision (a
worker that should be dark transmits where its censor test passes)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def planted(fault: Optional[str]):
    from repro_torch.core import censoring
    from repro_torch.fleet import sim
    from repro_torch.kernels import ops

    saved = {k: getattr(ops, k) for k in ("bipartite_mix", "edge_gather_mix",
                                          "stoch_quantize")}
    compose, make_fleet_step = censoring.compose_tx_mask, sim.make_fleet_step
    if fault == "no_exchange":
        ops.bipartite_mix = lambda adj, vals: torch.zeros(
            (adj.shape[0],) + vals.shape[1:], dtype=vals.dtype,
            device=vals.device)
        ops.edge_gather_mix = lambda vals, table, valid: torch.zeros_like(
            vals, dtype=torch.float32)
    elif fault == "altered":
        def altered(theta, q_prev, unif, delta, qrange):
            out = saved["stoch_quantize"](theta, q_prev, unif, delta, qrange)
            out[0, 0] += 0.5 * delta[0]
            return out
        ops.stoch_quantize = altered
    elif fault == "deliver_now":
        def on_time(*args, **kwargs):
            fstep = make_fleet_step(*args, **kwargs)
            return lambda fs, draw, batch, drop, lag: fstep(
                fs, draw, batch, drop, torch.zeros_like(lag))
        sim.make_fleet_step = on_time
    elif fault == "no_timeout":
        censoring.compose_tx_mask = lambda timeout, censor, group: (censor,
                                                                    group)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)
        censoring.compose_tx_mask = compose
        sim.make_fleet_step = make_fleet_step
