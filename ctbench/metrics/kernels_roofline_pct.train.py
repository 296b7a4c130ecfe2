"""Hand-written kernels #1-#6 in the profiled stretch: the sum of their
launches' least times (the larger of bytes at the HBM peak and operations
at the float32 peak, ``counts/mhct.py``) over their summed device time,
in %."""

from ctbench.core.shares import kernels_roofline


def read(run):
    return kernels_roofline(run)
