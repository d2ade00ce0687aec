"""The port's campaigns: the three of ``benchmarks/campaigns.py`` that
reproduce the paper's and the system's claims (correctness and bits, not
speed), with the JAX package's configs spelled out exactly and ``fn``
naming the port's modules (so the run keys differ from the JAX package's
only through ``fn``):

* ``paper-figures`` — Figs. 2-6, one run per figure
  (``bench/figures.py``);
* ``lm-sweep``      — the quantized-vs-unquantized LM baseline pair, then
  the layer-wise grid groups x censor_mode x mix_backend, each run a
  resumable training (``launch/train.py:campaign_lm_run``);
* ``fleet-sweep``   — FleetSim over participation x staleness x
  {iid, dirichlet}, gated on fault-free bit identity to the synchronous
  engine (``bench/fleet.py``).

The JAX package's ``engine-smoke``, ``serve-smoke``, ``kernels``,
``roofline`` and ``all`` time the system: they wait for the port's
benchmark (ROADMAP.md queue A), and ``launch/train.py`` says so.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign lm-sweep \\
        [--resume] [--campaign-only lm-grid] [--device cpu]
"""
from __future__ import annotations

from repro_torch.campaign.spec import Campaign, get_campaign, \
    register_campaign, stage, sweep

# --------------------------------------------------------------- figures --
FIGURES = ("fig2_linreg_synth", "fig3_linreg_real", "fig4_logreg_synth",
           "fig5_logreg_real", "fig6_density")
FIGURES_STAGE = stage(
    "figures", "repro_torch.bench.figures:stage_figure",
    configs=[{"figure": f} for f in FIGURES], names=list(FIGURES))

paper_figures = register_campaign(
    Campaign(name="paper-figures", stages=(FIGURES_STAGE,)))

# -------------------------------------------------------------- lm sweep --
_LM_COMMON = dict(workers=4, steps=12, batch=8, seq=64, local_steps=2,
                  arch="tinyllama-1.1b")
LM_BASELINE_STAGE = stage(
    "lm-baseline", "repro_torch.launch.train:campaign_lm_run",
    configs=[
        dict(_LM_COMMON, quantize=True,
             section=["lm_sweep", "baseline", "quantized"]),
        dict(_LM_COMMON, quantize=False,
             section=["lm_sweep", "baseline", "unquantized"],
             compare_with=["lm_sweep", "baseline", "quantized"]),
    ],
    names=["cq-ggadmm", "ggadmm"])

_LM_GRID = sweep(groups=["model", "leaf"],
                 censor_mode=["global", "group"],
                 mix_backend=["dense", "sparse"])
LM_GRID_STAGE = stage(
    "lm-grid", "repro_torch.launch.train:campaign_lm_run",
    configs=[dict(_LM_COMMON, steps=6, **pt,
                  section=["lm_sweep", "grid",
                           "|".join(str(v) for v in pt.values())])
             for pt in _LM_GRID],
    deps=["lm-baseline"],
    names=["|".join(str(v) for v in pt.values()) for pt in _LM_GRID])

lm_sweep = register_campaign(
    Campaign(name="lm-sweep", stages=(LM_BASELINE_STAGE, LM_GRID_STAGE)))

# ----------------------------------------------------------------- fleet --
FLEET_STAGE = stage(
    "fleet", "repro_torch.bench.fleet:stage_fleet_sweep",
    configs=[{"n_workers": 8, "rounds": 80, "dim": 20}], names=["sweep"])

fleet_sweep = register_campaign(
    Campaign(name="fleet-sweep", stages=(FLEET_STAGE,)))

PORTED = ("lm-sweep", "paper-figures", "fleet-sweep")


def get(name: str) -> Campaign:
    """Alias of :func:`repro_torch.campaign.spec.get_campaign` (every
    campaign here is registered at import)."""
    return get_campaign(name)
