"""B2 (``bipartite_mix``) against its roofline, in %: the least time of
one (N, N) x (N, d) call over its device time per recorded call."""
from perfbench import bounds


def read(run):
    got = run.summary.kernel("bipartite_mix")
    if got is None:
        return None
    calls, seconds = got
    n, d = run.work["n"], run.work["d"]
    least = bounds.bound_s(*bounds.mix_work(n, n, d))
    return 100.0 * least / (seconds / calls)
