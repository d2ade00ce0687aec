"""Host time of a graph redraw, in ms: the program's
``dynamic.graph_draw``, ``topology.rebuild`` and ``engine.make_step``
spans of the traced stretch (their union) over its count of
``topology.rebuild`` spans."""
from perfbench import spans


def read(run):
    return spans.redraw_ms(run)
