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
  bn1..3,downsample_conv,downsample_bn}``; a ``V2VModel``'s (the node
  that holds ``UpsampleBlock_i``) ``BasicBlock_0`` -> ``basic``,
  ``ResBlock_i`` -> ``res_blocks.<i>`` (as the Res trunks' blocks),
  ``UpsampleBlock_i`` -> ``upsample_blocks.<i>`` and its output
  ``Conv_0`` -> ``out_conv``; a ``UNet``'s (the node that holds
  ``Down_i``) ``DoubleConv_0`` -> ``inc``, ``Down_i``/``Up_i`` ->
  ``downs.<i>``/``ups.<i>`` (their ``DoubleConv_0`` -> ``conv``, an
  ``Up``'s ``GroupedConvTranspose_0`` -> ``up``), ``Dense_0`` -> ``dense``
  and ``OutConv_0`` -> ``outc``; in a ``BasicBlock``, an ``UpsampleBlock``
  and an ``OutConv`` the ``Conv_0`` (or ``GroupedConvTranspose_0``) and
  ``BatchNorm_0`` -> ``conv`` and ``bn``, in a ``DoubleConv`` ``Conv_j``/
  ``BatchNorm_j`` -> ``conv<j+1>``/``bn<j+1>``; at the root of a bare
  ``Up``'s or ``Down``'s tree as in one under a UNet.  A transposed conv's
  kernel keeps the conv rule: the port's ``GroupedConvTranspose`` holds
  it in the conv layout;
* BatchNorm ``scale``/``bias``/``mean``/``var`` and the frames' ``log_R``/
  ``shift`` keep their names.

``port_to_jax_tree`` goes the other way with the same rules, for tensors
named as the port names them (gradients from ``named_parameters()``, or a
``state_dict``): it fills a copy of a JAX tree, so that a test can hold
``p.grad`` against ``jax.grad`` leaf by leaf.

``reference_state_dict`` and ``load_reference`` take the reference
implementation's own state dict (a released ``.t7``) of a segmenter, a
classifier (with or without per-head scales), the completion inpainter or
the single-view reconstructor straight into the port's model, as the JAX
package's ``tools/convert_torch_checkpoint.py`` does into a JAX tree.
``load_weights`` takes either kind of file: a ``.t7`` or a port checkpoint.
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
_CONV_BN_PARTS = {"Conv_0": "conv", "GroupedConvTranspose_0": "conv",
                  "BatchNorm_0": "bn"}
_DOUBLE_CONV_PARTS = {"Conv_0": "conv1", "BatchNorm_0": "bn1",
                      "Conv_1": "conv2", "BatchNorm_1": "bn2"}
_UNET_STEP_PARTS = {"DoubleConv_0": "conv", "GroupedConvTranspose_0": "up"}
# the parts of a node recognised by a child: a ResNet trunk holds
# ``Bottleneck_i``, a V2V model ``UpsampleBlock_i``, a UNet ``Down_i``
_ROOT_PARTS = {"Bottleneck": _STEM_PARTS,
               "UpsampleBlock": {"BasicBlock_0": "basic",
                                 "Conv_0": "out_conv"},
               "Down": {"DoubleConv_0": "inc", "Dense_0": "dense",
                        "OutConv_0": "outc"}}
_KIND_RE = re.compile(r"(%s)_\d+" % "|".join(_ROOT_PARTS))
# numbered auto-named blocks -> the port's module list
_LISTS = {"Res2DBlock": "res2d", "Res3DBlock": "res3d",
          "Bottleneck": "blocks", "ResBlock": "res_blocks",
          "UpsampleBlock": "upsample_blocks", "Down": "downs", "Up": "ups"}
_LIST_RE = re.compile(r"(%s)_(\d+)" % "|".join(_LISTS))


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):   # dict or flax FrozenDict
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def _parts_under(parent, kind):
    """The renames of the auto-named layers directly under ``parent``;
    ``kind``: the ``_ROOT_PARTS`` key of the blocks ``parent`` holds, or
    None."""
    if re.fullmatch(r"(Res[23]DBlock|ResBlock)_\d+", parent):
        return _BLOCK_PARTS
    if re.fullmatch(r"Bottleneck_\d+", parent):
        return _BOTTLENECK_PARTS
    if re.fullmatch(r"(BasicBlock|UpsampleBlock|OutConv)_\d+", parent):
        return _CONV_BN_PARTS
    if re.fullmatch(r"DoubleConv_\d+", parent):
        return _DOUBLE_CONV_PARTS
    if re.fullmatch(r"(Down|Up)_\d+", parent):
        return _UNET_STEP_PARTS
    if kind is not None:
        return _ROOT_PARTS[kind]
    if not parent:
        # at the root the tree of a bare ``AdaIn1d``, ``Up`` or ``Down``
        return {**_ADAIN_PARTS, **_UNET_STEP_PARTS}
    if parent.endswith("adain"):
        return _ADAIN_PARTS
    return {}


def _rename(path, kinds):
    """``kinds``: {path (tuple) of a node that holds numbered blocks of a
    ``_ROOT_PARTS`` kind: that kind}."""
    out, parent = [], ""
    for k, part in enumerate(path):
        m = _LIST_RE.fullmatch(part)
        if m:
            out += [_LISTS[m.group(1)], m.group(2)]
        else:
            parts = _parts_under(parent, kinds.get(tuple(path[:k])))
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
    kinds = {}
    for path, _ in leaves:
        for k, part in enumerate(path):
            m = _KIND_RE.fullmatch(part)
            if m:
                kinds[path[:k]] = m.group(1)
    for path, arr in leaves:
        if "stages" in path:
            i = path.index("stages") + 1
            stages = [(path[:i] + (str(r),) + path[i:], r)
                      for r in range(arr.shape[0])]
        else:
            stages = [(path, None)]
        for p, r in stages:
            name, axes = _leaf(p[-1], arr.ndim - (r is not None))
            key = ".".join(_rename(p[:-1], kinds) + [name])
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


# The reference implementation's module names -> the port's, per layout:
# (pattern, replacement) tried in order on a key outside the unions, or,
# after a union's prefix (``attentions_encoder.{i}`` /
# ``attentions_decoder.{i}``: stage i // 3, union i % 3), on the rest of the
# union's key.  A replacement is a template or a function of the match.  A
# layer whose port name ends in ``bn`` or ``bn<digit>`` is a BatchNorm.
_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}
_UNION = (   # layers/multihead_ct.py
    (r"attentions\.(\d+)\.keys_values_pred\.0\.",
     r"attention_\1.kv.keys_values_pred."),
    (r"attentions\.(\d+)\.(key_bn|values_bn|transform)\.",
     r"attention_\1.kv.\2."),
    (r"attentions\.(\d+)\.conv\.0\.", r"attention_\1.conv."),
    (r"attentions\.(\d+)\.after\.0\.", r"attention_\1.after_bn."),
    (r"after\.0\.", "after_conv."),
    (r"after\.1\.", "after_bn."),
    (r"shortcut\.(shortcut_conv|shortcut_bn)\.", r"\1."),
)
_UNION_ADAIN = (   # layers/multihead_ct_adain.py
    (r"attentions\.(\d+)\.keys_values_pred\.0\.",
     r"attention_\1.keys_values_pred."),
    (r"attentions\.(\d+)\.(keys|values)_bn\.0\.linear\.",
     r"attention_\1.\2_adain.dense."),
    (r"attentions\.(\d+)\.(?=scale$)", r"attention_\1."),
    (r"attentions\.(\d+)\.transform\.", r"attention_\1.transform."),
    (r"attentions\.(\d+)\.conv\.0\.", r"attention_\1.conv."),
    (r"attentions\.(\d+)\.after\.0\.linear\.",
     r"attention_\1.after_adain.dense."),
    (r"after\.0\.", "after_conv."),
    (r"after\.1\.linear\.", "after_adain.dense."),
    (r"shortcut\.shortcut_conv\.", "shortcut_conv."),
    (r"shortcut\.shortcut_bn\.linear\.", "shortcut_adain.dense."),
)
_RES_PARTS = {"res_branch.0": "conv1", "res_branch.1": "bn1",
              "res_branch.3": "conv2", "res_branch.4": "bn2",
              "skip_con.0": "skip_conv", "skip_con.1": "skip_bn"}
_DOWNSAMPLE_PARTS = {"downsample.0": "downsample_conv",
                     "downsample.1": "downsample_bn"}
_RESNET_FIRST_BLOCK = (0, 3, 7, 13)   # torchvision's (3, 4, 6, 3) blocks


def _backbone(ref, port):
    """The classifier's backbone (model_zoo/scanobject/classifier.py) under
    the reference prefix ``ref`` and the port's ``port``."""
    return (
        (ref + r"first_process\.0\.", port + "stem."),
        (ref + r"first_process\.1\.", port + "stem_bn."),
        (ref + r"(pool[23]d)\.keys_values_pred\.0\.",
         port + r"\1.kv.keys_values_pred."),
        (ref + r"(pool[23]d)\.(key_bn|values_bn|transform)\.",
         port + r"\1.kv.\2."),
        # after_pool{3,2}d.{0,2,4}: Res blocks between max pools
        (ref + r"after_pool([23]d)\.(\d+)\.(res_branch\.[0134]|"
               r"skip_con\.[01])\.",
         lambda m: (f"{port}res{m.group(1)}.{int(m.group(2)) // 2}."
                    f"{_RES_PARTS[m.group(3)]}.")),
    )


def _resnet_block(m):
    block = _RESNET_FIRST_BLOCK[int(m.group(1)) - 4] + int(m.group(2))
    part = _DOWNSAMPLE_PARTS.get(m.group(3), m.group(3))
    return f"res50.trunk.blocks.{block}.{part}."


_DECODER_HEAD = (   # the AdaIN decoder's stem and final head
    (r"mapping\.0\.", "mapping."),
    (r"start\.0\.", "start_conv."),
    (r"start\.1\.linear\.", "start_adain.dense."),
    (r"final\.0\.", "final_conv1."),
    (r"final\.1\.linear\.", "final_adain.dense."),
    (r"final\.3\.", "final_conv2."),
)
_REFERENCE = {   # layout: ({union prefix: (port prefix, rules)}, rules)
    "segmenter": ({"attentions_encoder": ("trunk.stages", _UNION)}, (
        (r"first_process\.0\.", "stem."),
        (r"first_process\.1\.", "stem_bn."),
        (r"final\.0\.", "final_conv1."),
        (r"final\.1\.", "final_bn."),
        (r"final\.3\.", "final_conv2."),
    )),
    "classifier": ({"attentions_encoder": ("backbone.trunk.stages",
                                           _UNION)},
                   _backbone("", "backbone.") + (
        (r"class_vector\.0\.", "class_vector."),
        (r"class_vector\.1\.", "class_vector_bn."),
        (r"class_head\.1\.", "class_head."),
        (r"mask_head\.1\.", "mask_conv1."),
        (r"mask_head\.2\.", "mask_bn."),
        (r"mask_head\.4\.", "mask_conv2."),
    )),
    "inpainter": ({"encoder.attentions_encoder": (
                       "encoder.backbone.trunk.stages", _UNION),
                   "attentions_decoder": ("decoder.stages", _UNION_ADAIN)},
                  _backbone(r"encoder\.", "encoder.backbone.") + (
        (r"encoder\.class_head\.0\.", "encoder.class_head."),
        (r"encoder\.class_head\.1\.", "encoder.class_head_bn."),
    ) + _DECODER_HEAD),
    # a torchvision ResNet-50's children()[:-2] under
    # ``res50_model.0.features`` (0 conv1, 1 bn1, 4-7 layer1-4)
    "reconstructor": ({"attentions_decoder": ("decoder.stages",
                                              _UNION_ADAIN)}, (
        (r"res50_model\.0\.features\.0\.", "res50.trunk.stem_conv."),
        (r"res50_model\.0\.features\.1\.", "res50.trunk.stem_bn."),
        (r"res50_model\.0\.features\.([4-7])\.(\d+)\.(conv[123]|bn[123]|"
         r"downsample\.[01])\.", _resnet_block),
    ) + _DECODER_HEAD),
}
# registry name -> the reference layout of its checkpoints
_REFERENCE_OF = {"s3dis_segmenter": "segmenter",
                 "s3dis_segmenter_pad": "segmenter",
                 "scanobject_classifier": "classifier",
                 "scanobject_classifier_scales": "classifier",
                 "completion_inpainter": "inpainter",
                 "image_reconstructor": "reconstructor"}


def _reference_name(key, layout):
    """A reference key -> the port's key (None for a BatchNorm's
    ``num_batches_tracked``)."""
    unions, rules = _REFERENCE[layout]
    prefix = ""
    for ref, (port, union_rules) in unions.items():
        m = re.match(re.escape(ref) + r"\.(\d+)\.", key)
        if m:
            i = int(m.group(1))   # three unions a stage
            prefix = f"{port}.{i // 3}.union_{i % 3}."
            rules, key = union_rules, key[m.end():]
            break
    for pattern, repl in rules:
        head = re.match(pattern, key)
        if head is None:
            continue
        layer = prefix + (repl(head) if callable(repl)
                          else head.expand(repl))
        leaf = key[head.end():]
        if re.search(r"bn\d?\.$", layer):
            if leaf == "num_batches_tracked":
                return None
            leaf = _BN_LEAVES[leaf]
        return layer + leaf
    raise KeyError(f"reference key {key!r} has no counterpart in the "
                   f"port's {layout}")


def reference_state_dict(model_name, sd):
    """The reference implementation's state dict of ``model_name`` ({name:
    tensor or array}, a ``module.`` prefix dropped) -> the port's
    ``state_dict``: the reference's ``Conv1d`` kernels ``[out, in, 1]``
    lose their last axis to become ``Linear`` weights, the grid convs,
    Res blocks and ``Linear`` layers keep their layout, the BatchNorms'
    ``weight``/``running_*`` become ``scale``/``mean``/``var``, the
    frames' ``log_R``/``shift``/``scales`` and the AdaIN key ``scale``
    keep their names.  The counterpart of the JAX package's
    ``tools/convert_torch_checkpoint.convert`` followed by
    ``jax_to_state_dict``; like it, raises ``NotImplementedError`` for a
    model it has no converter for."""
    if model_name not in _REFERENCE_OF:
        raise NotImplementedError(
            f"no reference converter for {model_name!r} (available: "
            f"{sorted(_REFERENCE_OF)})")
    state = {}
    for key, value in sd.items():
        key = key[len("module."):] if key.startswith("module.") else key
        name = _reference_name(key, _REFERENCE_OF[model_name])
        if name is None:
            continue
        t = torch.as_tensor(np.asarray(value, np.float32))
        if t.dim() == 3 and t.shape[-1] == 1:   # Conv1d [out, in, 1]
            t = t[..., 0]
        state[name] = t.contiguous()
    return state


def reference_segmenter_pad_state_dict(sd):
    """``reference_state_dict`` of the KPConv-protocol segmenter
    (``model_zoo/s3dis/segmenter_pad.py``)."""
    return reference_state_dict("s3dis_segmenter_pad", sd)


def reference_classifier_state_dict(sd):
    """``reference_state_dict`` of ``model_zoo/scanobject/classifier.py``
    and ``classifier_scales.py`` (whose frames add ``transform.scales``)."""
    return reference_state_dict("scanobject_classifier", sd)


def reference_inpainter_state_dict(sd):
    """``reference_state_dict`` of ``model_zoo/completion/inpainter.py``:
    the encoder under ``encoder.``, the AdaIN decoder."""
    return reference_state_dict("completion_inpainter", sd)


def reference_reconstructor_state_dict(sd):
    """``reference_state_dict`` of
    ``model_zoo/image_reconstruction/reconstructor.py``: torchvision's
    ResNet-50 names, the AdaIN decoder."""
    return reference_state_dict("image_reconstructor", sd)


def load_reference(model, model_name, path):
    """Load the reference's ``.t7`` state dict at ``path`` into the port's
    ``model`` of the registered name ``model_name`` (strict: every name
    must match); -> the model."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(reference_state_dict(model_name, sd), strict=True)
    return model


def load_reference_segmenter_pad(model, path):
    """``load_reference`` of the KPConv-protocol segmenter (the released
    ``s3dis_kpconvprotocol.t7``)."""
    return load_reference(model, "s3dis_segmenter_pad", path)


def load_weights(model, model_name, path):
    """Weights the port did not train or did: a reference ``.t7`` through
    ``load_reference``, any other file (a trainer checkpoint, a
    ``save_params_only`` file, a bare ``state_dict``) through
    ``train/checkpoint.restore_params_only``; -> the model."""
    if str(path).endswith(".t7"):
        return load_reference(model, model_name, path)
    from cloud_transformers_tpu_torch.train.checkpoint import (
        restore_params_only,
    )
    return restore_params_only(path, model)
