"""Device time of the flat diagnostics a traced iteration, in ms: the
kernels launched inside the program's ``engine.diagnostics`` spans
(``engine.flat_metrics``: the pairwise primal residual, Eq. 28) over the
traced iterations."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_iter(run, "engine.diagnostics")
