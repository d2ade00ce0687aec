"""B1 (``stoch_quantize``) against its roofline, in %: the least time of
one call at the convex shape (all N workers' (N, d) rows; bytes at the
memory rate) over its device time per recorded call."""
from perfbench import bounds


def read(run):
    got = run.summary.kernel("stoch_quantize")
    if got is None:
        return None
    calls, seconds = got
    least = bounds.bound_s(*bounds.quant_work(run.work["n"], run.work["d"]))
    return 100.0 * least / (seconds / calls)
