"""Host time of the local solve a traced iteration, in ms: the program's
``engine.solve`` spans (``core/engine.py``: the exact solver's call, both
phases) over the traced iterations."""
from perfbench import spans


def read(run):
    return spans.host_ms_per_iter(run, "engine.solve")
