"""Campaign subsystem: declarative, resumable experiment DAGs.

A *campaign* is a named DAG of *stages*; a stage is an ordered list of
*runs*, each a pure function call described by a ``RunSpec`` (module path
plus a resolved, JSON-serializable config that deterministically hashes to
the run's key). The :mod:`~repro_torch.campaign.runner` executes stages in
topological order with transient-vs-fatal retry and crash-resume; every
run emits a typed :class:`~repro_torch.campaign.store.Record` whose
sections and claims the :class:`~repro_torch.campaign.store.ResultStore`
merges atomically into ``campaigns/torch/BENCH_engine.json``. The port of
``repro.campaign``; stage functions run on ``RunContext.device``.
"""
from repro_torch.campaign.measure import percentiles, time_per_call, time_run
from repro_torch.campaign.runner import (FatalError, RetryPolicy, RunContext,
                                         Runner, Summary, TransientError)
from repro_torch.campaign.spec import (CAMPAIGNS, Campaign, RunSpec, Stage,
                                       get_campaign, register_campaign,
                                       run_key, stage, sweep)
from repro_torch.campaign.store import Claim, Record, ResultStore

__all__ = [
    "CAMPAIGNS", "Campaign", "Claim", "FatalError", "Record", "ResultStore",
    "RetryPolicy", "RunContext", "Runner", "RunSpec", "Stage", "Summary",
    "TransientError",
    "get_campaign", "percentiles", "register_campaign", "run_key", "stage",
    "sweep", "time_per_call", "time_run",
]
