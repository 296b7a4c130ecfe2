"""JAX variables -> the port's ``state_dict``, and the port's tensors back
into a JAX tree.

``jax_to_state_dict`` takes the flax ``variables`` of the JAX package
(``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays, e.g.
after ``jax.device_get``) and returns tensors under the port's module names:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
* conv ``kernel [*k, in/groups, out]`` (HWIO / DHWIO, grouped or not)
  -> ``weight [out, in/groups, *k]`` (OIHW / OIDHW);
* ``nn.scan``'s stacked leading axis of length ``repeats`` under any
  ``.../stages`` (the classifier's ``backbone/trunk/stages``, the
  inpainter's ``decoder/stages``) -> one entry per stage ``stages.<r>``;
* the auto-named layers, each by its parent's rule: an AdaIN's
  (``*_adain``, or the root of a bare ``AdaIn1d``'s tree) ``Dense_0`` ->
  ``dense``; the Res trunks'
  ``Res{3,2}DBlock_i/{Conv,BatchNorm}_j`` ->
  ``res{3,2}d.<i>.{conv1,bn1,conv2,bn2,skip_conv,skip_bn}``; the ResNet's
  stem ``trunk/{Conv,BatchNorm}_0`` (in the node that holds the
  ``Bottleneck_i``, and only there) -> ``trunk.{stem_conv,stem_bn}`` and
  its ``Bottleneck_i/{Conv,BatchNorm}_j`` -> ``blocks.<i>.{conv1..3,
  bn1..3,downsample_conv,downsample_bn}``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` and the frames' ``log_R``/
  ``shift`` keep their names.

``port_to_jax_tree`` goes the other way with the same rules, for tensors
named as the port names them (gradients from ``named_parameters()``, or a
``state_dict``): it fills a copy of a JAX tree, so that a test can hold
``p.grad`` against ``jax.grad`` leaf by leaf.

``reference_segmenter_pad_state_dict`` and ``load_reference_segmenter_pad``
take the reference implementation's own state dict of the KPConv-protocol
segmenter (the released ``s3dis_kpconvprotocol.t7``) straight into the
port's ``SegmenterPad``.
"""

import re

import numpy as np
import torch

_BLOCK_PARTS = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
                "BatchNorm_1": "bn2", "Conv_2": "skip_conv",
                "BatchNorm_2": "skip_bn"}
_BOTTLENECK_PARTS = {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                     "Conv_1": "conv2", "BatchNorm_1": "bn2",
                     "Conv_2": "conv3", "BatchNorm_2": "bn3",
                     "Conv_3": "downsample_conv",
                     "BatchNorm_3": "downsample_bn"}
_STEM_PARTS = {"Conv_0": "stem_conv", "BatchNorm_0": "stem_bn"}
_ADAIN_PARTS = {"Dense_0": "dense"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):   # dict or flax FrozenDict
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def _parts_under(parent, is_resnet_trunk):
    """The renames of the auto-named layers directly under ``parent``;
    ``is_resnet_trunk``: ``parent`` holds ``Bottleneck_i`` blocks."""
    if re.fullmatch(r"Res[23]DBlock_\d+", parent):
        return _BLOCK_PARTS
    if re.fullmatch(r"Bottleneck_\d+", parent):
        return _BOTTLENECK_PARTS
    if is_resnet_trunk:
        return _STEM_PARTS
    if parent.endswith("adain") or not parent:
        # an AdaIN's, or at the root the tree of a bare ``AdaIn1d``
        return _ADAIN_PARTS
    return {}


def _rename(path, resnet_trunks):
    """``resnet_trunks``: the paths (tuples) of the nodes that hold
    ``Bottleneck_i`` blocks, whose ``Conv_0``/``BatchNorm_0`` are the
    stem's."""
    out, parent = [], ""
    for k, part in enumerate(path):
        m = re.fullmatch(r"(Res[23]DBlock|Bottleneck)_(\d+)", part)
        if m:
            out += [{"Res2DBlock": "res2d", "Res3DBlock": "res3d",
                     "Bottleneck": "blocks"}[m.group(1)], m.group(2)]
        else:
            parts = _parts_under(parent, tuple(path[:k]) in resnet_trunks)
            out.append(parts.get(part, part))
        parent = part
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
    leaves = list(_flatten(tree))
    resnet_trunks = {path[:k] for path, _ in leaves
                     for k, part in enumerate(path)
                     if re.fullmatch(r"Bottleneck_\d+", part)}
    for path, arr in leaves:
        if "stages" in path:
            i = path.index("stages") + 1
            stages = [(path[:i] + (str(r),) + path[i:], r)
                      for r in range(arr.shape[0])]
        else:
            stages = [(path, None)]
        for p, r in stages:
            name, axes = _leaf(p[-1], arr.ndim - (r is not None))
            key = ".".join(_rename(p[:-1], resnet_trunks) + [name])
            yield key, axes, r, path, arr


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


# the reference's ``model_zoo/s3dis/segmenter_pad.py`` module names -> the
# port's ``SegmenterPad``: (pattern, replacement, the layer is a BatchNorm),
# inside a union (``attentions_encoder.{i}``: stage i // 3, union i % 3) or
# at the top
_REFERENCE_SEGMENTER = (
    (r"first_process\.0\.", "stem.", False),
    (r"first_process\.1\.", "stem_bn.", True),
    (r"attentions\.(\d+)\.keys_values_pred\.0\.",
     r"attention_\1.kv.keys_values_pred.", False),
    (r"attentions\.(\d+)\.(key_bn|values_bn)\.", r"attention_\1.kv.\2.",
     True),
    (r"attentions\.(\d+)\.transform\.", r"attention_\1.kv.transform.", False),
    (r"attentions\.(\d+)\.conv\.0\.", r"attention_\1.conv.", False),
    (r"attentions\.(\d+)\.after\.0\.", r"attention_\1.after_bn.", True),
    (r"after\.0\.", "after_conv.", False),
    (r"after\.1\.", "after_bn.", True),
    (r"final\.0\.", "final_conv1.", False),
    (r"final\.1\.", "final_bn.", True),
    (r"final\.3\.", "final_conv2.", False),
)
_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}


def _reference_name(key):
    """A reference segmenter key -> the port's key (None for a
    BatchNorm's ``num_batches_tracked``)."""
    prefix, rest = "", key
    m = re.match(r"attentions_encoder\.(\d+)\.", key)
    if m:
        i = int(m.group(1))   # three unions a stage
        prefix = f"trunk.stages.{i // 3}.union_{i % 3}."
        rest = key[m.end():]
    for pattern, repl, is_bn in _REFERENCE_SEGMENTER:
        head = re.match(pattern, rest)
        if head is None:
            continue
        leaf = rest[head.end():]
        if is_bn:
            if leaf == "num_batches_tracked":
                return None
            leaf = _BN_LEAVES[leaf]
        return prefix + head.expand(repl) + leaf
    raise KeyError(f"reference key {key!r} has no counterpart in "
                   "SegmenterPad")


def reference_segmenter_pad_state_dict(sd):
    """The reference ``model_zoo/s3dis/segmenter_pad.py`` state dict
    ({name: tensor or array}, a ``module.`` prefix dropped) -> the port's
    ``SegmenterPad`` ``state_dict``: the reference's ``Conv1d`` kernels
    ``[out, in, 1]`` lose their last axis to become ``Linear`` weights, the
    grid convs keep their layout, the BatchNorms' ``weight``/``running_*``
    become ``scale``/``mean``/``var``.  The counterpart of the JAX
    package's ``tools/convert_torch_checkpoint.convert_segmenter_pad``."""
    state = {}
    for key, value in sd.items():
        key = key[len("module."):] if key.startswith("module.") else key
        name = _reference_name(key)
        if name is None:
            continue
        t = torch.as_tensor(np.asarray(value, np.float32))
        if t.dim() == 3 and t.shape[-1] == 1:   # Conv1d [out, in, 1]
            t = t[..., 0]
        state[name] = t.contiguous()
    return state


def load_reference_segmenter_pad(model, path):
    """Load the reference's ``.t7`` state dict at ``path`` into the port's
    ``SegmenterPad`` (strict: every name must match)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(reference_segmenter_pad_state_dict(sd),
                          strict=True)
    return model
