"""Faults planted in the program's kernels, for the tests and readings that
show the comparison catches them; never on a benchmark run.

``no_exchange``: every mix (B2, B6) returns zeros, as if no worker heard
its neighbours. ``altered``: B1's reconstruction is altered at one entry
where it is produced (the LM driver alters its rows' labels instead)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def planted(fault: Optional[str]):
    from repro_torch.kernels import ops

    saved = {k: getattr(ops, k) for k in ("bipartite_mix", "edge_gather_mix",
                                          "stoch_quantize")}
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
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)
