"""The port's campaigns: every campaign of ``benchmarks/campaigns.py``,
with the JAX package's configs spelled out exactly and ``fn`` naming the
port's modules (so the run keys differ from the JAX package's only through
``fn``):

* ``engine-smoke``  — the seven engine runs (``bench/engine.py``): the
  engine against the seed stepper, payload, pytree fusion, fused range,
  group specs, the topology backends and the mix sweep;
* ``serve-smoke``   — the serving stream, agreement, long-context and
  serve-load runs (``bench/serving.py``), chained on the stream stage;
* ``paper-figures`` — Figs. 2-6, one run per figure
  (``bench/figures.py``);
* ``lm-sweep``      — the quantized-vs-unquantized LM baseline pair, then
  the layer-wise grid groups x censor_mode x mix_backend, each run a
  resumable training (``launch/train.py:campaign_lm_run``);
* ``fleet-sweep``   — FleetSim over participation x staleness x
  {iid, dirichlet}, gated on fault-free bit identity to the synchronous
  engine (``bench/fleet.py``);
* ``all``           — everything above plus the ``kernels`` stage (B1 and
  B2 against their plain versions over a shape sweep,
  ``bench/kernels.py``) and the ``roofline`` stage (each kernel against its
  H100 bound, ``bench/roofline.py``). ``kernels`` and ``roofline`` are
  stages of ``all``, not campaigns: ``--campaign all --campaign-only
  kernels`` runs one.

    PYTHONPATH=src python -m repro_torch.launch.train --campaign lm-sweep \\
        [--resume] [--campaign-only lm-grid] [--device cpu]
"""
from __future__ import annotations

from repro_torch.campaign.spec import Campaign, RunSpec, Stage, \
    get_campaign, register_campaign, stage, sweep

# ---------------------------------------------------------------- engine --
_engine_runs = [
    ("stage_walltime", {"n_workers": 16, "dim": 64, "iters": 200},
     "walltime"),
    ("stage_payload", {"n": 4, "iters": 40}, "payload"),
    ("stage_pytree_fusion", {"n_leaves": 16, "n": 8, "dim": 256,
                             "iters": 20}, "pytree_fusion"),
    ("stage_fused_range", {"n_leaves": 16, "n": 8, "dim": 256,
                           "iters": 30}, "fused_range"),
    ("stage_group_specs", {"n_workers": 8, "iters": 40}, "group_specs"),
    ("stage_mix_backends", {"n_workers": 16, "dim": 64, "iters": 60},
     "mix_backends"),
    ("stage_mix_sweep", {"ns": [64, 128, 256], "ps": [0.1, 0.3, 1.0],
                         "dim": 256, "inner": 10}, "mix_sweep"),
]

ENGINE_STAGE = Stage(
    name="engine",
    runs=tuple(RunSpec(stage="engine", fn=f"repro_torch.bench.engine:{fn}",
                       config=cfg, name=name)
               for fn, cfg, name in _engine_runs))

engine_smoke = register_campaign(
    Campaign(name="engine-smoke", stages=(ENGINE_STAGE,)))

# --------------------------------------------------------------- serving --
SERVING_STAGES = (
    stage("serving-stream", "repro_torch.bench.serving:stage_stream",
          names=["stream"]),
    stage("serving-agreement", "repro_torch.bench.serving:stage_agreement",
          deps=["serving-stream"], names=["agreement"]),
    stage("serving-long-context",
          "repro_torch.bench.serving:stage_long_context",
          deps=["serving-stream"], names=["long_context"]),
    # the dep keeps serve-smoke serialized (one process, one cached model)
    stage("serving-load", "repro_torch.bench.serving:stage_serve_load",
          deps=["serving-stream"], names=["load"]),
)

serve_smoke = register_campaign(
    Campaign(name="serve-smoke", stages=SERVING_STAGES))

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

# ------------------------------------------------------ kernels/roofline --
KERNELS_STAGE = stage(
    "kernels", "repro_torch.bench.kernels:stage_shape",
    configs=[{"n": n, "d": d} for n, d in ((8, 512), (16, 4096),
                                           (24, 16384))],
    names=["8x512", "16x4096", "24x16384"])

ROOFLINE_STAGE = stage(
    "roofline", "repro_torch.bench.roofline:stage_roofline",
    names=["roofline"])

# ------------------------------------------------------------------- all --
everything = register_campaign(
    Campaign(name="all",
             stages=(ENGINE_STAGE,) + SERVING_STAGES
             + (FIGURES_STAGE, FLEET_STAGE, KERNELS_STAGE, ROOFLINE_STAGE,
                LM_BASELINE_STAGE, LM_GRID_STAGE)))


def get(name: str) -> Campaign:
    """Alias of :func:`repro_torch.campaign.spec.get_campaign` (every
    campaign here is registered at import)."""
    return get_campaign(name)
