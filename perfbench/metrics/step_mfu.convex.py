"""The whole iteration against the chip's peak, in %: the least time of
an iteration's necessary work (``bounds.convex_step_work``: each worker's
system matrix read once and applied by two triangular solves) over the
traced iterations' wall time per iteration."""
from perfbench import bounds


def read(run):
    s = run.summary
    if s.iterations <= 0:
        return None
    least = bounds.bound_s(*bounds.convex_step_work(run.work["n"],
                                                    run.work["d"]))
    return 100.0 * least / (s.window_s / s.iterations)
