"""B2 (``bipartite_mix``) against its roofline, in %: the least time of
one (N, N) x (N, P) call on the packed buffer over its device time per
recorded call."""
from perfbench import bounds


def read(run):
    got = run.summary.kernel("bipartite_mix")
    if got is None:
        return None
    calls, seconds = got
    n, p = run.work["workers"], run.work["width"]
    least = bounds.bound_s(*bounds.mix_work(n, n, p))
    return 100.0 * least / (seconds / calls)
