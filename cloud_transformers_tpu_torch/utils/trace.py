"""The port's host tracer: named spans and counters where the work happens.

``with span("trainer.forward"):`` times a block, ``count("loader.ready",
n)`` adds to a counter, ``enable(True)`` turns recording on (it returns
the state it replaced) and ``take()`` returns what was recorded since the
last ``take()`` and clears it.  A recorded span holds its name, its start
and end in ``time.time_ns()`` (the clock of ``torch.profiler``'s device
timestamps, so the spans line up with a device trace), its ``id``, the
``id`` of the recorded span that encloses it on its thread (``parent``)
and that thread's ``threading.get_ident()``.

Recording is off by default.  Off, a span still measures itself and adds
its length to its thread's total for its name (``seconds(name)``, which
``Trainer.fit``'s ``data_time`` and ``batch_time`` read), but nothing is
appended and counters stay as they are.

The spans: ``trainer.step`` (``Trainer.train_step``) around
``trainer.to_device``, ``trainer.forward``, ``trainer.backward`` and
``trainer.update``; ``loader.next`` (the consumer's wait in
``data.DataLoader``) and ``loader.build`` (a batch built on a loader
thread); ``data.schedule`` (``S3DISSeg``'s sphere schedule);
``setup.kernels`` (the kernels' build or load), ``setup.weights`` (a
``Trainer``'s fresh weights and optimizer) and ``setup.data`` (a dataset's
constructor).  The counters: ``loader.ready`` (batches already built when
the consumer asks), ``kernels.built``, ``kernels.loaded`` and ``bn.plain``
(``nn/norm.BatchNorm`` calls on a CUDA tensor that took the plain ops, not
the kernels).  A snapshot also carries the kernel wrappers' own
``.launches`` counts (``launches()``).
"""

import itertools
import threading
import time


class _Thread(threading.local):
    def __init__(self):
        self.open = []      # the recorded spans open on this thread
        self.totals = {}    # name -> ns of this thread's finished spans


class Span:
    """One timed block: ``start`` and ``end`` in ``time.time_ns()``."""

    __slots__ = ("tracer", "name", "start", "end", "id", "parent")

    def __init__(self, tracer, name):
        self.tracer, self.name, self.id = tracer, name, None

    def __enter__(self):
        tracer = self.tracer
        if tracer.on:
            here = tracer._thread.open
            self.parent = here[-1].id if here else None
            self.id = next(tracer._ids)
            here.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        tracer = self.tracer
        totals = tracer._thread.totals
        totals[self.name] = totals.get(self.name, 0) + self.end - self.start
        if self.id is not None:
            tracer._thread.open.pop()
            tracer._record({"name": self.name, "start_ns": self.start,
                            "end_ns": self.end, "id": self.id,
                            "parent": self.parent,
                            "thread": threading.get_ident()})


class Tracer:
    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._thread = _Thread()
        self._spans, self._counts = [], {}

    def enable(self, on=True):
        """Turn recording on or off.  -> whether it was on."""
        was, self.on = self.on, bool(on)
        return was

    def span(self, name):
        return Span(self, name)

    def count(self, name, n=1):
        if self.on:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + n

    def seconds(self, name):
        """Seconds of the finished spans called ``name`` on this thread,
        recorded or not, since the thread started."""
        return self._thread.totals.get(name, 0) * 1e-9

    def _record(self, span):
        with self._lock:
            self._spans.append(span)

    def take(self):
        """-> {"spans": [...], "counts": {...}, "launches": launches()},
        the spans and counts recorded since the last ``take()``, which are
        cleared."""
        with self._lock:
            spans, counts = self._spans, self._counts
            self._spans, self._counts = [], {}
        return {"spans": spans, "counts": counts, "launches": launches()}


def launches():
    """{kernel wrapper: its launches since the process started}."""
    from cloud_transformers_tpu_torch.ops import (
        batch_norm,
        pallas_emd,
        pallas_fused_block,
        pallas_grid_conv,
        pallas_splat,
    )
    wrappers = [getattr(pallas_splat, n) for n in (
        "splat_max", "splat_max_winner", "slice_gather", "splat_max_bwd",
        "splat_route", "slice_bwd")]
    wrappers += [getattr(pallas_grid_conv, n) for n in (
        "grid_conv3d", "grid_conv2d", "grid_conv3d_dw", "grid_conv2d_dw")]
    wrappers += [pallas_fused_block.fused_block, pallas_emd.top2,
                 pallas_emd.auction_window, batch_norm.bn_stats,
                 batch_norm.bn_apply, batch_norm.bn_backward]
    return {w.__name__: w.launches for w in wrappers}


TRACER = Tracer()
span, count, enable = TRACER.span, TRACER.count, TRACER.enable
seconds, take = TRACER.seconds, TRACER.take
