"""Fleet-sweep stage (campaign ``fleet-sweep``): bits-to-loss curves of the
consensus engine under injected fleet faults. The port of
``benchmarks/bench_fleet.py``, over ``fleet/sim.py`` with the port's draws
(``round_draws``: a generator seeded from ``(seed, round)``).

One stage runs the paper's linear-regression workload through
:class:`repro_torch.fleet.FleetSim` over the grid

    participation x staleness x data partition
    {1.0, 0.8, 0.5}  x  {0, 2}  x  {iid, dirichlet(alpha)}

recording, per arm, the objective-gap curve against the closed-form
consensus optimum and the cumulative *arrival-accounted* payload bits (a
stale packet charges its held bits on the round it lands). Three gated
claims ride along, as in the JAX package:

* ``fleet_faultfree_bit_identical_to_sync`` — the (participation=1.0,
  staleness=0, iid) arm equals :func:`repro_torch.fleet.run_synchronous`
  **bitwise** on every metric round and on the final ``theta`` /
  ``theta_hat`` / ``alpha``.
* ``fleet_censored_zero_bits`` — across every arm and round, a worker
  whose round was censored, dropped, or in flight (``tx_mask == 0``)
  contributes exactly zero payload bits.
* ``fleet_graceful_degradation`` — every moderately faulted arm
  (staleness 0, or participation >= 0.8) still converges: the final
  objective gap is at most half the round-0 gap. The severe corner
  (participation 0.5 and staleness 2) is recorded as data, outside the
  gate.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign \\
        fleet-sweep [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.campaign.store import Claim, Record
from repro_torch.core import engine as E
from repro_torch.core import tree as T
from repro_torch.core.censoring import CensorConfig
from repro_torch.core.graph import random_bipartite_graph
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.solvers import LinearRegressionProblem
from repro_torch.data import regression as R
from repro_torch.device import resolve_device
from repro_torch.fleet import FaultConfig, FleetConfig, FleetSim, \
    run_synchronous

PARTICIPATION = (1.0, 0.8, 0.5)
STALENESS = (0, 2)
PARTITIONS = ("iid", "dirichlet")


def _problem(n_workers: int, partition: str, dim: int, alpha: float,
             seed: int, dev) -> LinearRegressionProblem:
    data = R.synth_linear(n=n_workers * 40, d=dim, seed=seed)
    if partition == "iid":
        x, y = R.partition_uniform(data, n_workers, seed=seed)
    else:
        x, y = R.partition_dirichlet(data, n_workers, alpha=alpha,
                                     seed=seed)
    return LinearRegressionProblem(
        torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev),
        torch.as_tensor(np.ascontiguousarray(y, np.float32), device=dev))


def _objective_metrics(prob: LinearRegressionProblem) -> E.MetricsFn:
    def fn(state, batch):
        del batch
        return {"objective": prob.global_loss(
            torch.mean(state.theta, dim=0))}
    return fn


def _bitwise_equal(fleet_m, sync_m, fleet_state, sync_state) -> bool:
    """Fault-free fleet vs the synchronous golden arm, bit for bit."""
    for k in ("payload_bits", "tx_mask", "bits_per_group", "objective"):
        if not np.array_equal(np.asarray(fleet_m[k]), np.asarray(sync_m[k])):
            return False
    for name in ("theta", "theta_hat", "alpha"):
        for a, b in zip(T.leaves(getattr(fleet_state, name)),
                        T.leaves(getattr(sync_state, name))):
            if not torch.equal(a, b):
                return False
    return True


def stage_fleet_sweep(n_workers=8, rounds=80, dim=20, rho=1.0, tau0=0.5,
                      xi=0.97, b0=2, omega=0.99, alpha=0.3, graph_p=0.4,
                      seed=0, ctx=None) -> Record:
    """The sweep on ``ctx.device`` (the card without a context)."""
    dev = resolve_device(ctx.device if ctx is not None else None)
    graph = random_bipartite_graph(n_workers, graph_p, seed=seed)
    cfg = E.EngineConfig(rho=rho, censor=CensorConfig(tau0=tau0, xi=xi),
                         quantize=QuantConfig(b0=b0, omega=omega))
    theta0 = torch.zeros((n_workers, dim), dtype=torch.float32, device=dev)

    arms = {}
    golden_ok = False
    zero_bits_ok = True
    degrade_ok = True
    for partition in PARTITIONS:
        prob = _problem(n_workers, partition, dim, alpha, seed, dev)
        solver = E.ExactSolver(prob)
        metrics_fn = _objective_metrics(prob)
        f_star = float(prob.global_loss(prob.optimum()))
        sync_state, sync_m = run_synchronous(
            graph, cfg, solver, theta0, rounds, seed=seed,
            extra_metrics=metrics_fn)
        for p in PARTICIPATION:
            for lag in STALENESS:
                fcfg = FleetConfig(
                    rounds=rounds,
                    faults=FaultConfig(participation=p, staleness=lag,
                                       seed=seed),
                    seed=seed)
                sim = FleetSim(n_workers, cfg, fcfg, theta0, solver=solver,
                               extra_metrics=metrics_fn, graph0=graph)
                fs, m = sim.run()
                gap = np.abs(np.asarray(m["objective"]) - f_star)
                cum_bits = np.cumsum(np.asarray(m["payload_bits_total"]))
                payload = np.asarray(m["payload_bits"])
                tx = np.asarray(m["tx_mask"])
                zero_bits_ok &= bool(np.all(payload[tx == 0.0] == 0.0))
                if lag == 0 or p >= 0.8:
                    degrade_ok &= bool(np.isfinite(gap[-1])
                                       and gap[-1] <= 0.5 * gap[0])
                if partition == "iid" and p == 1.0 and lag == 0:
                    golden_ok = _bitwise_equal(m, sync_m, fs.engine,
                                               sync_state)
                label = f"{partition}|p{p}|L{lag}"
                arms[label] = {
                    "partition": partition, "participation": p,
                    "staleness": lag,
                    "final_gap": float(gap[-1]),
                    "total_bits": float(cum_bits[-1]),
                    "mean_tx_per_round": float(np.mean(m["tx_count"])),
                    "gap_curve": [float(g) for g in gap],
                    "cum_bits_curve": [float(b) for b in cum_bits],
                }
                print(f"# fleet: {label:22s} final_gap={gap[-1]:.3e} "
                      f"bits={cum_bits[-1]:.4g} "
                      f"tx/round={arms[label]['mean_tx_per_round']:.2f}")

    print(f"# fleet: faultfree_bit_identical={golden_ok} "
          f"zero_bits={zero_bits_ok} graceful_degradation={degrade_ok}")
    data = {"n_workers": n_workers, "rounds": rounds, "dim": dim,
            "alpha": alpha, "arms": arms}
    return Record(
        section=("fleet",), data=data,
        claims=(
            Claim("fleet_faultfree_bit_identical_to_sync", golden_ok,
                  gate="fleet (p=1.0, L=0, iid) == run_synchronous bitwise "
                       "on metrics + final theta/theta_hat/alpha"),
            Claim("fleet_censored_zero_bits", zero_bits_ok,
                  gate="payload_bits[tx_mask == 0] == 0 over all arms"),
            Claim("fleet_graceful_degradation", degrade_ok,
                  gate="arms with staleness 0 or participation >= 0.8: "
                       "final gap <= 0.5 x round-0 gap"),
        ))
