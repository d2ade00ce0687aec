"""B6 (``edge_gather_mix``) against its roofline, in %: the least time of
one call over the worker graph on the (N, P) packed buffer (its
referenced rows, table and output: ``bounds.edge_work``) over its device
time per recorded call."""
from perfbench import bounds


def read(run):
    got = run.summary.kernel("edge_gather_mix")
    if got is None:
        return None
    calls, seconds = got
    least = bounds.bound_s(*bounds.edge_work(run.work["table"],
                                             run.work["valid"],
                                             run.work["width"]))
    return 100.0 * least / (seconds / calls)
