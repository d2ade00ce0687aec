"""Device events a traced iteration, in launches: the kernels, copies and
fills launched inside the program's ``engine.step`` spans over the traced
iterations (the host's dispatch of one step)."""
from perfbench import spans


def read(run):
    return spans.launches_per_iter(run)
