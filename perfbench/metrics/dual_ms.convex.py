"""Device time of the dual update a traced iteration, in ms: the kernels
launched inside the program's ``engine.dual`` spans (``core/engine.py``:
the Laplacian's mix, Eq. 23 and ``dual_residual``) over the traced
iterations."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_iter(run, "engine.dual")
