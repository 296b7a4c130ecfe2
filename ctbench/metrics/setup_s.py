"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the weights, the data, the warm-up and the checked
steps."""


def read(run):
    return run.get("setup_s")
