"""The device's idle share of the traced stretch, in %: one minus the
union of its device activities over the stretch's wall time."""


def read(run):
    s = run.summary
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
