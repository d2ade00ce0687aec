"""Host time of the local solve a traced step, in ms: the program's
``engine.solve`` spans (``core/engine.py``: the inexact solver's local Adam
steps over the model's autograd, both phases) over the traced steps."""
from perfbench import spans


def read(run):
    return spans.host_ms_per_iter(run, "engine.solve")
