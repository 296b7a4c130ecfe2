"""One run of one cell of the port's benchmark.

    python3 ctbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; everything else is found by name:

* its configuration: the entry of ``configs`` (its ``file``);
* its traffic mix: ``ctbench/traffic/<traffic>.json``, which names the
  window's driver, ``ctbench/drivers/<driver>.py``;
* its own data (the limits of its comparison): ``ctbench/workloads/<cell>.json``;
* its metrics: ``ctbench/metrics/<metric>.py`` for every end-to-end metric
  that the cell reports (with ``--trace 0``) and every per-layer metric
  (with ``--trace 1``): those that list the cell under ``workloads``, and
  those without ``workloads`` whose ``moves`` the cell reports.  A reader
  that finds nothing returns None and its metric is left out.

The driver builds the program's objects, warms up every shape the cell
uses, measures for ``--seconds``, and then checks what the timed path
produced against the plain reference (``ctbench/reference/``).  The run
prints, last on standard error, each number compared beside its limit,
and last on standard output one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``breakdown`` with ``--trace 1``) and
``checks``.  Without a card, or with fewer cards than the cell asks for,
it exits 2 and prints no result; so it does where JAX or the JAX package
was loaded in this process.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "ctbench"
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cloud_transformers_tpu")
# the program's build and kernel caches, at fixed paths in the checkout
CACHE = ROOT / "build" / "ctbench"


def process_start():
    """The process's start on the ``time.time`` clock (from /proc; this
    module's import where /proc cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_module(kind, name):
    """``ctbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"ctbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(bench, name):
    """-> (the cell's entry, its configuration's entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, config


def cell_metrics(bench, cell_name, trace):
    """The metric entries a run of the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def loaded_forbidden():
    """The forbidden top-level modules in ``sys.modules``."""
    return sorted({k.split(".", 1)[0] for k in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments, the module loader and the clock of the run."""

    def __init__(self, args, cell, config, traffic, data, device="cuda"):
        self.args, self.cell, self.config = args, cell, config
        self.traffic, self.data = traffic, data
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.start = process_start()
        self.module = load_module
        self.tmp = os.environ.get("TMPDIR") or "/tmp"

    def since_start(self):
        return time.time() - self.start


def power_line():
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "nvidia-smi: not available"
    return out.replace("\n", "; ")


def result_line(bench, cell_name, trace, run, device):
    """The metrics of the run, by their readers, and the result line."""
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in run["checks"].items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()) and run["failed"] == 0
    line = {"correct": correct, "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    if trace and run.get("profile"):
        line["breakdown"] = run["breakdown"]
    line["readings"] = run.get("readings", {})
    line["checks"] = checks
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name):
    """-> (BENCHMARK.json, the cell's entry, its configuration, its traffic
    mix, its own data)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config_entry = cell_spec(bench, name)
    return (bench, cell, load_json(ROOT / config_entry["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "workloads" / f"{cell['name']}.json"))


def execute(args, bench, cell, config, traffic, data, device, kind):
    """Drive the cell and read its metrics.  -> the result line, or None
    where a forbidden module was loaded."""
    ctx = Context(args, cell, config, traffic, data, device)
    run = load_module("drivers", traffic["driver"]).run(ctx)
    found = loaded_forbidden()
    if found:
        print(f"ctbench: modules that may not be loaded: {found}",
              file=sys.stderr)
        return None
    run["device_kind"], run["chips"] = kind, cell["chips"]
    dev = {"platform": "gpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": run["memory_peak_bytes"]}
    if args.trace and run.get("profile"):
        dev.update(busy_s=run["profile"]["busy_s"],
                   window_s=run["profile"]["window_s"])
    return result_line(bench, cell["name"], args.trace, run, dev)


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    args = parse(argv)
    bench, cell, config, traffic, data = load_cell(args.workload)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"ctbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    power = power_line()
    print(f"ctbench: card {power}", file=sys.stderr)
    print(json.dumps({"card": power}), flush=True)
    line = execute(args, bench, cell, config, traffic, data, "cuda",
                   torch.cuda.get_device_name(0))
    if line is None:
        return 2
    for name, value in line.pop("readings").items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
