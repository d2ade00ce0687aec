"""Kernel micro-benchmark stage (the ``kernels`` stage of campaign
``all``): the port of ``benchmarks/bench_kernels.py``. At one (n, d) point
``stoch_quantize`` (B1) and ``bipartite_mix`` (B2), through
``kernels.ops``, against their plain versions (``kernels/ref.py``) on the
same tensors: parity (max |diff|) and time per call
(``campaign.measure.time_per_call``). On the card the first arm is the
CUDA kernel; on the CPU ``ops`` runs the plain version itself, so the two
arms time one function and only parity is meaningful.

Results land in ``kernels.<n>x<d>`` sections with the parity claims under
``kernels.claims``.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign all \\
        --campaign-only kernels [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.campaign.measure import time_per_call
from repro_torch.campaign.store import Claim, Record
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

SHAPES = [(8, 512), (16, 4096), (24, 16384)]


def bench_shape(n: int, d: int, device=None) -> dict:
    """Both kernels against their plain versions at one (n, d) point, on
    inputs drawn from a generator seeded with ``n * d``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(n * d)
    theta = 5 * torch.randn((n, d), generator=gen, device=dev)
    qprev = torch.zeros((n, d), device=dev)
    unif = torch.rand((n, d), generator=gen, device=dev)
    qrange = torch.amax(torch.abs(theta), dim=-1)
    delta = 2.0 * qrange / 15.0
    us_k, out_k = time_per_call(ops.stoch_quantize, theta, qprev, unif,
                                delta, qrange)
    us_r, out_r = time_per_call(ref.stoch_quantize_ref, theta, qprev, unif,
                                delta, qrange)
    quant_diff = float(torch.max(torch.abs(out_k - out_r)))

    adj = (torch.rand((n, n), generator=gen, device=dev) > 0.5).float()
    v = torch.randn((n, d), generator=gen, device=dev)
    us_mk, out_mk = time_per_call(ops.bipartite_mix, adj, v)
    us_mr, out_mr = time_per_call(ref.bipartite_mix_ref, adj, v)
    mix_diff = float(torch.max(torch.abs(out_mk - out_mr)))
    return {"n": n, "d": d,
            "stoch_quant": {"us_per_call": us_k, "us_ref": us_r,
                            "max_abs_diff": quant_diff},
            "bipartite_mix": {"us_per_call": us_mk, "us_ref": us_mr,
                              "max_abs_diff": mix_diff}}


def stage_shape(n: int, d: int, ctx=None) -> Record:
    out = bench_shape(n, d, device=ctx.device if ctx is not None else None)
    sq, bm = out["stoch_quant"], out["bipartite_mix"]
    print(f"stoch_quant,{n}x{d},{sq['us_per_call']:.0f},"
          f"{sq['us_ref']:.0f},{sq['max_abs_diff']:.2e}")
    print(f"bipartite_mix,{n}x{d},{bm['us_per_call']:.0f},"
          f"{bm['us_ref']:.0f},{bm['max_abs_diff']:.2e}")
    return Record(
        section=("kernels", f"{n}x{d}"), data=out,
        claims=(
            Claim(f"stoch_quant_parity_{n}x{d}",
                  sq["max_abs_diff"] <= 1e-5,
                  value=sq["max_abs_diff"], gate="<= 1e-5 vs oracle"),
            Claim(f"bipartite_mix_parity_{n}x{d}",
                  bm["max_abs_diff"] <= 1e-4,
                  value=bm["max_abs_diff"], gate="<= 1e-4 vs oracle"),),
        claims_path=("kernels", "claims"))
