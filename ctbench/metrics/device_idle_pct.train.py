"""The share of the profiled stretch with no kernel, copy or set on the
card (the union of their intervals), in %."""

from ctbench.core.shares import idle


def read(run):
    return idle(run)
