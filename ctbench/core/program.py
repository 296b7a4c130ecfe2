"""The program's own spans and counters in a run, reduced.

A snapshot is what the port's tracer hands over
(``cloud_transformers_tpu_torch/utils/trace.py``, ``take()``): its spans,
each with a name, ``start_ns`` and ``end_ns`` on ``time.time_ns``'s clock
(the one the profiler's device timestamps are on), ``id``, ``parent`` and
``thread``, its counts, and the kernel wrappers' launches so far.  Each
function returns only what it finds: a snapshot without the spans it reads
gives an empty dict or None, never an error.
"""

import torch

# the per-layer numbers of the training step's four phases (ms a step) and
# of set-up (s), by the span each reads
STEP_PHASES = {"step_h2d_ms.train": "trainer.to_device",
               "step_forward_ms.train": "trainer.forward",
               "step_backward_ms.train": "trainer.backward",
               "step_update_ms.train": "trainer.update"}
SETUP = {"setup_kernels_s": "setup.kernels",
         "setup_weights_s": "setup.weights",
         "setup_data_s": "setup.data"}


def lengths(snap, name):
    """The ns of each span called ``name``."""
    return [s["end_ns"] - s["start_ns"] for s in snap["spans"]
            if s["name"] == name]


def window(snap):
    """Of the window's snapshot: each phase's ms a step (the phase's spans
    over the ``trainer.step`` spans), the step's own ms outside its phases,
    the mean ``loader.build`` ms, the batches ready at each ``loader.next``
    and the seconds of ``data.schedule`` on any thread."""
    steps = lengths(snap, "trainer.step")
    if not steps:
        return {}
    out = {m: 1e-6 * sum(lengths(snap, n)) / len(steps)
           for m, n in STEP_PHASES.items()}
    out["step_self_ms.train"] = 1e-6 * sum(steps) / len(steps) - sum(
        out[m] for m in STEP_PHASES)
    builds = lengths(snap, "loader.build")
    if builds:
        out["loader_build_ms.train"] = 1e-6 * sum(builds) / len(builds)
    takes = lengths(snap, "loader.next")
    if takes and "loader.ready" in snap["counts"]:
        out["loader_ready.train"] = snap["counts"]["loader.ready"] / len(
            takes)
    out["data_schedule_s.window"] = 1e-9 * sum(lengths(snap,
                                                       "data.schedule"))
    return out


def setup(snap):
    """Of the set-up's snapshot: the seconds of each set-up span (summed
    over the datasets) and the kernels built and loaded."""
    out = {m: 1e-9 * sum(lengths(snap, n)) for m, n in SETUP.items()
           if lengths(snap, n)}
    out.update({k: v for k, v in snap["counts"].items()
                if k.startswith("kernels.")})
    return out


def thread_spans(snap, thread, t0, t1):
    """(start, end, name) of ``thread``'s spans inside [t0, t1] ns: the
    spans that name the stretch's idle gaps beside the benchmark's own."""
    return [(s["start_ns"], s["end_ns"], s["name"]) for s in snap["spans"]
            if s["thread"] == thread and t0 <= s["start_ns"]
            and s["end_ns"] <= t1]


def device_ops(events):
    """(start, end) ns of the profiler's device operations (kernels,
    copies, sets; no annotations)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == cuda and not e.is_user_annotation()]


def clock_margins(events, bench_spans, program_spans):
    """{"first_us": the first device operation's start after the first
    program span's start, "last_us": the closing ``synchronize`` span's end
    after the last device operation's end}: both at least 0 where the two
    clocks agree.  None without device operations or program spans."""
    ops = device_ops(events)
    closing = [e for _, e, n in bench_spans if n == "synchronize"]
    if not ops or not program_spans or not closing:
        return None
    return {"first_us": 1e-3 * (min(s for s, _ in ops)
                                - min(s for s, _, _ in program_spans)),
            "last_us": 1e-3 * (max(closing) - max(e for _, e in ops))}


def launches_per_step(before, after, steps):
    """Each kernel wrapper's launches a step between two snapshots (those
    it launched at all)."""
    return {k: (after[k] - before.get(k, 0)) / steps for k in after
            if after[k] > before.get(k, 0)}


def under(gaps, prefix):
    """The share of the idle seconds named ``train_step`` or a span whose
    name starts with ``prefix`` that the latter hold; None without any."""
    mine = sum(v for k, v in gaps.items() if k.startswith(prefix))
    total = mine + gaps.get("train_step", 0.0)
    return mine / total if total else None
