"""Device time of the censoring a traced iteration, in ms: the kernels
launched inside the program's ``engine.censor`` spans (``core/engine.py``:
the censor masks, the timeout, the payload and the commits of
``theta_hat`` and the quantizer state, both phases) over the traced
iterations."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_iter(run, "engine.censor")
