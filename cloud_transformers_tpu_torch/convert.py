"""JAX variables -> the port's ``state_dict``.

Takes the flax ``variables`` of the JAX package (``{"params": ...,
"batch_stats": ...}`` nested dicts of numpy arrays, e.g. after
``jax.device_get``) and returns tensors under the port's module names:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
* conv ``kernel [*k, in/groups, out]`` (HWIO / DHWIO, grouped or not)
  -> ``weight [out, in/groups, *k]`` (OIHW / OIDHW);
* ``nn.scan``'s stacked leading axis of length ``repeats`` under
  ``backbone/trunk/stages`` -> one entry per stage ``stages.<r>``;
* the Res trunks' auto-named ``Res{3,2}DBlock_i/{Conv,BatchNorm}_j`` ->
  ``res{3,2}d.<i>.{conv1,bn1,conv2,bn2,skip_conv,skip_bn}``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` and the frames' ``log_R``/
  ``shift`` keep their names.
"""

import re

import numpy as np
import torch

_BLOCK_PARTS = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
                "BatchNorm_1": "bn2", "Conv_2": "skip_conv",
                "BatchNorm_2": "skip_bn"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):   # dict or flax FrozenDict
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def _rename(path):
    out = []
    for part in path:
        m = re.fullmatch(r"Res([23])DBlock_(\d+)", part)
        if m:
            out += [f"res{m.group(1)}d", m.group(2)]
        else:
            out.append(_BLOCK_PARTS.get(part, part))
    return out


def _leaf(name, arr):
    if name != "kernel":
        return name, arr
    if arr.ndim == 2:
        return "weight", arr.T
    # [*k, in/groups, out] -> [out, in/groups, *k]
    return "weight", arr.transpose(arr.ndim - 1, arr.ndim - 2,
                                   *range(arr.ndim - 2))


def jax_to_state_dict(variables):
    """-> {port parameter/buffer name: float32 tensor}."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            if "stages" in path:
                i = path.index("stages") + 1
                entries = [(path[:i] + (str(r),) + path[i:], arr[r])
                           for r in range(arr.shape[0])]
            else:
                entries = [(path, arr)]
            for p, a in entries:
                name, a = _leaf(p[-1], a)
                key = ".".join(_rename(p[:-1]) + [name])
                state[key] = torch.from_numpy(np.array(a, np.float32))
    return state


def load_jax_variables(model, variables):
    """Load JAX variables into ``model`` (strict: every name must match)."""
    model.load_state_dict(jax_to_state_dict(variables), strict=True)
    return model
