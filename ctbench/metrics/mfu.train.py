"""The model FLOPs of the window (``counts/<family>.py``: valid points
only, no recomputation, the backward as twice the forward) over its
seconds and the float32 peak of the card (``core/peaks.py``), in %."""

from ctbench.core.shares import mfu


def read(run):
    return mfu(run)
