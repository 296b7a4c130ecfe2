"""The readings that a cell's limits are set from, on the card, many seeds
in one process (no measured window):

    python3 ctbench/readings.py --workload <cell> --kind program --seeds 1 2 3 ...

``--kind program``: the numbers that a run compares, of the program;
``control``: of the reference put in the program's place at the nearest
precision below the configuration's (TF32 operands); or a fault of the
cell's driver planted in the reference put in the program's place
(``half_batch``: half of each batch left out, the mean over the rest).  One JSON
line a seed on standard output; the benchmark's own runs never run this.
"""

import argparse
import json
import sys

from run import ROOT, Context, load_cell, load_module


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, cell, config, traffic, data = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("ctbench: readings need a CUDA device", file=sys.stderr)
        return 2
    driver = load_module("drivers", traffic["driver"])
    for seed in args.seeds:
        run_args = argparse.Namespace(workload=args.workload, seed=seed,
                                      seconds=0.0, trace=0)
        ctx = Context(run_args, cell, config, traffic, data)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed,
                          "readings": driver.readings(ctx, args.kind)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
