"""The profiled stretch: a fixed number of steps under
``torch.profiler`` with its CUDA activity alone, reduced to the device's
busy time, its kernels by group and its idle gaps by what the host was
doing.

The profiler records no host operations, so that the host runs the
stretch as fast as it runs the window.  The host's side is the driver's
own spans (``Spans``) on the clock the profiler's device timestamps are
on (nanoseconds since the epoch, ``time.time_ns``).  The stretch runs
from the first span's start to the last one's end.  Device operations are
the profiler's CUDA events (kernels, copies, sets); busy time is the
length of the union of their intervals inside the stretch, so that
overlapping work counts once.  An idle gap is a stretch of no device
operation, named by the innermost span that covers its start.
"""

import time

import torch

# device operations by a part of their name, first match wins (the groups
# of the program's kernel table, #1-#12, and of the libraries)
KERNEL_GROUPS = (
    ("nccl", "nccl"),
    ("top2_kernel", "top2"), ("auction_window_kernel", "auction_window"),
    ("conv2d_dw_kernel", "grid_conv2d_dw"),
    ("conv2d_dw_sum_kernel", "grid_conv2d_dw"),
    ("conv2d_fwd_kernel", "grid_conv2d"),
    ("grid_conv3d_dw", "grid_conv3d_dw"),
    ("grid_conv3d_", "grid_conv3d"),
    ("fused_block", "fused_block"), ("fused_cluster", "fused_block"),
    ("splat_max_winner", "splat_max_winner"),
    ("splat_winner", "splat_max_bwd"),
    ("splat_route", "splat_route"),
    ("splat_slab", "splat_max"), ("slice_bwd", "slice_bwd"),
    ("slice_kernel", "slice_gather"),
    ("cudnn", "cudnn"), ("implicit_gemm", "cudnn"),
    ("implicit_convolve", "cudnn"), ("fprop", "cudnn"), ("dgrad", "cudnn"),
    ("wgrad", "cudnn"),
    ("gemm", "matmul"), ("nvjet", "matmul"),
    ("Memcpy", "copies"), ("Memset", "copies"),
    ("", "elementwise"))


def group_of(name):
    """The group of a device operation's name."""
    return next(g for part, g in KERNEL_GROUPS if part in name)


class Spans:
    """Host spans of the driver: ``with spans("name"):``; off, they record
    nothing."""

    def __init__(self, on=True):
        self.on, self.spans = on, []

    def __call__(self, name):
        return _Span(self, name)


class _Span:
    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.start = time.time_ns()

    def __exit__(self, *exc):
        if self.owner.on:
            self.owner.spans.append((self.start, time.time_ns(), self.name))


def profiled(fn):
    """Run ``fn(spans)`` (which ends in a synchronize) under the profiler.
    -> (its device events, the spans); no events without a card."""
    from torch.profiler import ProfilerActivity, profile
    spans = Spans()
    if not torch.cuda.is_available():
        fn(spans)
        return [], spans.spans
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(spans)
    events = prof.profiler.kineto_results.events()
    return events, spans.spans


def _union(intervals):
    """Sorted, merged intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, spans):
    """-> {"window_s", "busy_s", "groups": {group: device s},
    "gaps": {span name: idle s}} of the stretch that ``spans`` cover, or
    None where no device operation ran in it."""
    if not spans:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for _, e, _ in spans)
    dev = [(max(e.start_ns(), t0), min(e.end_ns(), t1), e.name())
           for e in events
           if e.device_type() == cuda and not e.is_user_annotation()
           and e.end_ns() > t0 and e.start_ns() < t1]
    if not dev:
        return None
    groups = {}
    for s, e, name in dev:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in dev])
    host = sorted(spans)
    gaps, last = {}, t0
    for s, e in busy + [[t1, t1]]:
        if s > last:
            inner = [n for hs, he, n in host if hs <= last < he]
            name = inner[-1] if inner else "outside the driver's spans"
            gaps[name] = gaps.get(name, 0.0) + (s - last) * 1e-9
        last = max(last, e)
    return {"window_s": (t1 - t0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "groups": groups, "gaps": gaps}


def breakdown(reduced, limit=10):
    """The result line's ``breakdown``: the device operations that took most
    time (by group) and the idle time by what the host was doing."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:limit]]
    return {"device_ops": top(reduced["groups"]),
            "idle_gaps": top(reduced["gaps"])}
