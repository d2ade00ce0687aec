"""Peak device memory of the run's set-up and window, in GB
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
