"""The numbers that decide ``correct``.

Training (the first three steps of the object the window drives, against
the reference's three steps from the same weights, batches and dropout
seeds): a leaf's gap is the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger; a number is the worst or the median leaf's.

* ``loss1_gap``, ``loss_gap``: |loss - reference loss| / |reference loss|
  of the first step, and the largest of the three;
* ``grad_gap``, ``grad_median_gap``: of the first step's gradient as the
  optimizer took it (after clipping), read back from Adam's first moment:
  the worst leaf and the median leaf;
* ``change_gap``, ``change_median_gap``: of each parameter's change over the
  three steps, the worst and the median leaf.  A parameter whose reference
  gradient is under a thousandth of the median leaf's (a bias under a
  BatchNorm) moves under Adam by its rounding alone and is left out;
* ``stats_median_gap``: of each running statistic's change, the median
  leaf.

The cell's data names the numbers it compares and their limits; every
run prints them all.
"""

import torch

from ctbench.reference.mhct import median

ROUNDING_SHARE = 1e-3   # reference gradients below this share of the
#                         median leaf's are rounding


def _gaps(prog, ref, keys):
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), the median leaf's
    reference norm)}."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    floor = median(list(rn.values()))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in keys}


def training_gaps(prog, ref, weights, buffers):
    """``prog``, ``ref``: {"loss": [floats], "grad": {name: tensor},
    "params": {name: tensor after the steps}}; ``weights``, ``buffers``:
    {name: tensor before them}.  -> {number: value}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grad = _gaps({k: prog["grad"].get(k, torch.zeros(()))
                  for k in ref["grad"]}, ref["grad"], list(ref["grad"]))
    rg = {k: float(torch.linalg.vector_norm(g.double()))
          for k, g in ref["grad"].items()}
    floor = ROUNDING_SHARE * median(list(rg.values()))

    def moved(side, keys, start):
        return {k: side["params"][k].double().cpu() - start[k].double().cpu()
                for k in keys}
    keys = [k for k in weights if rg.get(k, 0.0) >= floor]
    change = _gaps(moved(prog, keys, weights), moved(ref, keys, weights),
                   keys)
    stats = _gaps(moved(prog, buffers, buffers), moved(ref, buffers, buffers),
                  list(buffers))
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": max(grad.values()),
            "grad_median_gap": median(list(grad.values())),
            "change_gap": max(change.values()),
            "change_median_gap": median(list(change.values())),
            "stats_median_gap": median(list(stats.values()))}

