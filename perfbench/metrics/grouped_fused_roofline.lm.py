"""B3 (``stoch_quantize_grouped_fused``) against its roofline, in %: the
least time of one call on the (N, P) packed buffer (bytes at the memory
rate) over its device time per recorded call."""
from perfbench import bounds


def read(run):
    got = run.summary.kernel("stoch_quantize_grouped_fused")
    if got is None:
        return None
    calls, seconds = got
    least = bounds.bound_s(*bounds.grouped_work(run.work["workers"]
                                                * run.work["width"]))
    return 100.0 * least / (seconds / calls)
