"""Factorizations of the local systems a traced iteration: the program's
``solve.factor`` spans (``core/engine.py``: one a phase per step function,
made on the phase's first solve, so one a phase per graph) over the traced
iterations. 0.0 where the program records ``engine.solve`` spans and no
``solve.factor``; None where it records no spans."""
from perfbench import spans


def read(run):
    got = spans.program_spans(run)
    if not got or "engine.solve" not in got or run.summary.iterations <= 0:
        return None
    return len(got.get("solve.factor", ())) / run.summary.iterations
