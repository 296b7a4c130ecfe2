"""One run of a cell as ``run.py --trace 1`` makes it, with the port's
tracer on from before set-up:

    python3 ctbench/traced.py --workload <cell> --seed <n> --seconds <s> [--tracer on|off]

The tracer is ``cloud_transformers_tpu_torch/utils/trace.py``; ``--tracer
off`` makes the same run with it left off, for its cost.  The cell's
loop, traffic, limits and metric readers are the benchmark's own and run
as they are.  The tracer's snapshot is taken when the window starts (set-up,
the checked and the warm-up steps), when it ends, and around the profiled
stretch, whose idle gaps are named by the innermost of the benchmark's
spans and the program's spans on the thread that steps: ``core/profile.py``'s
``reduce`` takes both, so the stretch's bounds, its busy time and the sum
of its gaps stay those of ``run.py``.

It prints ``run.py``'s result line, with ``"tracer"`` and, with the tracer
on, ``"program"`` (``core/program.py``): over the window
``step_h2d_ms.train``, ``step_forward_ms.train``, ``step_backward_ms.train``,
``step_update_ms.train`` (each phase of ``trainer.step``, ms a step),
``step_self_ms.train`` (the step outside them), ``loader_build_ms.train``,
``loader_ready.train`` and ``data_schedule_s.window``; of set-up
``setup_kernels_s``, ``setup_weights_s``, ``setup_data_s`` and the kernels
built and loaded; of the stretch each wrapper's launches a step, the share
of the step's idle seconds under a ``trainer.*`` span and the two clocks'
margins.  The benchmark's own runs never run this (nothing of theirs
turns the tracer on).
"""

import argparse
import json
import sys
import threading
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ctbench import run as R  # noqa: E402
from ctbench.core import profile, program  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", choices=("on", "off"), default="on")
    return ap.parse_args(argv)


def drive(ctx, loop, tracer_on):
    """The cell's run by ``loop`` (its ``ctbench/drivers`` module) with the
    tracer on or off.  -> (the run's record, the tracer's snapshots by
    phase)."""
    from cloud_transformers_tpu_torch.utils import trace
    snaps = {}
    window, profiled = loop.window, profile.profiled

    def timed_window(*args, **kwargs):
        snaps["setup"] = trace.take()
        try:
            return window(*args, **kwargs)
        finally:
            snaps["window"] = trace.take()

    def traced_profiled(fn):
        thread = threading.get_ident()
        snaps["before_stretch"] = trace.take()
        events, spans = profiled(fn)
        snaps["stretch"] = trace.take()
        if spans:
            mine = program.thread_spans(
                snaps["stretch"], thread, min(s for s, _, _ in spans),
                max(e for _, e, _ in spans))
            snaps["clock"] = program.clock_margins(events, spans, mine)
            spans = spans + mine
        return events, spans

    loop.window = timed_window
    profile.profiled = traced_profiled
    was = trace.enable(tracer_on)
    try:
        return loop.run(ctx), snaps
    finally:
        trace.enable(was)
        profile.profiled = profiled
        trace.take()


def numbers(snaps, run):
    """The program's numbers of the run; {} where the tracer recorded no
    window."""
    if not snaps.get("window", {}).get("spans"):
        return {}
    out = {**program.window(snaps["window"]),
           **program.setup(snaps["setup"])}
    prof = run.get("profile")
    if prof and "stretch" in snaps:
        out["launches_per_step"] = program.launches_per_step(
            snaps["before_stretch"]["launches"],
            snaps["stretch"]["launches"], prof["steps"])
        out["step_gaps_under_trainer"] = program.under(prof["gaps"],
                                                       "trainer.")
        out["clock"] = snaps.get("clock")
    return out


def execute(args, bench, cell, config, traffic, data, device, kind):
    """Drive the cell traced and read its metrics.  -> the result line, or
    None where a forbidden module was loaded."""
    run_args = argparse.Namespace(**vars(args), trace=1)
    ctx = R.Context(run_args, cell, config, traffic, data, device)
    run, snaps = drive(ctx, R.load_module("drivers", traffic["driver"]),
                       args.tracer == "on")
    found = R.loaded_forbidden()
    if found:
        print(f"ctbench: modules that may not be loaded: {found}",
              file=sys.stderr)
        return None
    dev = {"platform": "gpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": run["memory_peak_bytes"]}
    if run.get("profile"):
        dev.update(busy_s=run["profile"]["busy_s"],
                   window_s=run["profile"]["window_s"])
    line = R.result_line(bench, cell["name"], 1, run, dev)
    # the end-to-end metrics too, which run.py leaves out of a traced line
    line["metrics"].update(
        R.result_line(bench, cell["name"], 0, run, dev)["metrics"])
    line["tracer"] = args.tracer
    line["program"] = numbers(snaps, run)
    return line


def main(argv=None):
    args = parse(argv)
    bench, cell, config, traffic, data = R.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"ctbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    print(json.dumps({"card": R.power_line()}), flush=True)
    line = execute(args, bench, cell, config, traffic, data, "cuda",
                   torch.cuda.get_device_name(0))
    if line is None:
        return 2
    line.pop("readings")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
