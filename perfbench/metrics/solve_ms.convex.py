"""Device time of the local solve a traced iteration, in ms: the kernels
launched inside ``aten::linalg_solve`` (the exact solver's batched LU and
its triangular solves, both phases) over the traced iterations."""


def read(run):
    seconds = run.summary.device_s_under("aten::linalg_solve")
    if not seconds:
        return None
    return seconds / run.summary.iterations * 1e3
