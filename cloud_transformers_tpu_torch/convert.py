"""JAX variables -> the port's ``state_dict``, and the port's tensors back
into a JAX tree.

``jax_to_state_dict`` takes the flax ``variables`` of the JAX package
(``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays, e.g.
after ``jax.device_get``) and returns tensors under the port's module names:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
* conv ``kernel [*k, in/groups, out]`` (HWIO / DHWIO, grouped or not)
  -> ``weight [out, in/groups, *k]`` (OIHW / OIDHW);
* ``nn.scan``'s stacked leading axis of length ``repeats`` under
  ``backbone/trunk/stages`` -> one entry per stage ``stages.<r>``;
* the Res trunks' auto-named ``Res{3,2}DBlock_i/{Conv,BatchNorm}_j`` ->
  ``res{3,2}d.<i>.{conv1,bn1,conv2,bn2,skip_conv,skip_bn}``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` and the frames' ``log_R``/
  ``shift`` keep their names.

``port_to_jax_tree`` goes the other way with the same rules, for tensors
named as the port names them (gradients from ``named_parameters()``, or a
``state_dict``): it fills a copy of a JAX tree, so that a test can hold
``p.grad`` against ``jax.grad`` leaf by leaf.
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


def _leaf(name, ndim):
    """-> (the port's leaf name, axes that take the JAX leaf to the port's
    layout, or None where the layouts agree)."""
    if name != "kernel":
        return name, None
    # Dense [in, out] -> [out, in]; conv [*k, in/groups, out] ->
    # [out, in/groups, *k]
    return "weight", (ndim - 1, ndim - 2, *range(ndim - 2))


def _entries(tree):
    """Every JAX leaf as (port name, axes, index of its stage or None,
    JAX path, JAX array)."""
    for path, arr in _flatten(tree):
        if "stages" in path:
            i = path.index("stages") + 1
            stages = [(path[:i] + (str(r),) + path[i:], r)
                      for r in range(arr.shape[0])]
        else:
            stages = [(path, None)]
        for p, r in stages:
            name, axes = _leaf(p[-1], arr.ndim - (r is not None))
            yield ".".join(_rename(p[:-1]) + [name]), axes, r, path, arr


def jax_to_state_dict(variables):
    """-> {port parameter/buffer name: float32 tensor}."""
    state = {}
    for collection in ("params", "batch_stats"):
        for key, axes, r, _, arr in _entries(variables.get(collection, {})):
            a = arr if r is None else arr[r]
            if axes is not None:
                a = a.transpose(axes)
            state[key] = torch.from_numpy(np.array(a, np.float32))
    return state


def port_to_jax_tree(tensors, tree):
    """Fill a copy of the JAX ``tree`` (one collection: the ``params`` or the
    ``batch_stats`` of some variables) from ``tensors``, {port name: tensor}:
    the inverse of ``jax_to_state_dict`` leaf by leaf, layouts and the
    stacked stage axis included.  Every leaf of ``tree`` must be there."""
    out = {}
    for key, axes, r, path, arr in _entries(tree):
        a = tensors[key].detach().cpu().numpy()
        if axes is not None:
            a = a.transpose(np.argsort(axes))
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if r is None:
            node[path[-1]] = a
        else:
            node.setdefault(path[-1], np.zeros(arr.shape, a.dtype))[r] = a
    return out


def load_jax_variables(model, variables):
    """Load JAX variables into ``model`` (strict: every name must match)."""
    model.load_state_dict(jax_to_state_dict(variables), strict=True)
    return model
