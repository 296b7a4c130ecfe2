"""Rematerialization of the MHCT stages: the ``remat``/``remat_policy``
model keys.

Counterpart of ``remat_save_policy`` in ``cloud_transformers_tpu/nn/
multihead.py`` and of the ``nn.remat`` around the JAX package's scanned
stages, with the same policy names and meanings:

* ``"point_io"`` keeps the per-point tensors of each head group (the grid
  mapping, the splat values and the slice output) and the block's input.
  The dense ops before the splat and after the slice are checkpointed
  regions (``dense``), and so is the splat -> grouped conv -> slice chain
  (``kernels``), whose inputs are the mapping and the values: the backward
  recomputes the splat, the conv and the slice (the slice's Function
  saves the convolved grid, so torch's recompute runs until the slice has
  saved it), on ``"ops"`` and ``"fused"`` alike.
* ``"point_io_grids"`` also keeps the two grids: only the dense regions
  are checkpointed, the kernels keep what they save, and no kernel runs
  again.
* ``"full"``, ``"none"`` and ``None`` make one checkpointed region of each
  stage: its backward runs the whole stage again.

Any other name raises, as the JAX ``assert`` does.  ``OFF`` (``"off"``) is
the port's own value: no region at all.  The JAX models default to remat
for the TPU's memory; the port's default is off, because the card holds
every model's training step whole (a peak of 18.8 GB or less, ``PERF.md``
section 2, on an NVIDIA H100 80GB HBM3 at 700.00 W).
The values are the same either way; only memory and time differ.

A region is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False,
preserve_rng_state=False)``: the first forward runs with gradients on (so
``core/splat_slice._grad_will_be_taken`` still sees them), and no region
holds dropout, so no random state is saved (which would make the host
wait).  While a region is recomputed, ``recomputing()`` is true, and
``nn/norm.BatchNorm`` leaves its running statistics alone: they move once
a step, as in the JAX package's functional remat.
"""

import threading

import torch
from torch.utils.checkpoint import checkpoint

OFF = "off"
_state = threading.local()


def policy(name):
    """A JAX policy name (or ``OFF``) -> ``None`` (no regions),
    ``"point_io"``, ``"point_io_grids"`` or ``"full"``."""
    if name == OFF:
        return None
    if name in (None, "full", "none"):
        return "full"
    if name in ("point_io", "point_io_grids"):
        return name
    raise ValueError(f"unknown remat policy {name!r}: 'point_io', "
                     "'point_io_grids', 'full', 'none', None or 'off'")


def set_policy(module, name):
    """Give every block under ``module`` that has a ``remat`` attribute
    (stages, unions, head groups) the policy ``name``."""
    kind = policy(name)
    for m in module.modules():
        if hasattr(m, "remat"):
            m.remat = kind


def recomputing():
    """Whether a checkpointed region is being recomputed on this thread."""
    return getattr(_state, "depth", 0) > 0


def region(on, fn, *args):
    """``fn(*args)``, as a checkpointed region where ``on`` and a gradient
    will be taken; its recompute runs with ``recomputing()`` true."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        _state.depth = getattr(_state, "depth", 0) + 1
        try:
            return fn(*a)
        finally:
            _state.depth -= 1

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
