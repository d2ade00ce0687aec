"""Device time of the factored local solve a traced iteration, in ms: the
kernels launched inside the program's ``solve.apply`` spans
(``core/engine.py``: the phase's rows solved from their factor and put
back, both phases) over the traced iterations."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_iter(run, "solve.apply")
