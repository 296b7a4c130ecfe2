"""Port parity: the single-view reconstructor (``image_reconstructor``).

Neither ``Reconstructor`` has a depth knob, so both sides are shrunk from
here, the same way: the module names ``AdaInDecoder`` (one stage of
``TINY_STAGE_PLAN``) and ``ResNet50`` (stages (1, 1, 1, 1)) are patched
where the models look them up, model_dim 32, num_latent 16, B=2 x 64 noise
points, 64^2 images (the last ResNet stage's map is 2x2; at 32^2 its
BatchNorm over two values would leave the trunk below it no gradient).
The weights are the port's initialisation carried into the JAX tree
(``eval_shape`` gives the tree, so no JAX init runs), with the BatchNorm
scales and statistics randomised from numpy, and back through
``load_jax_variables``.

* forward in eval mode, the decoder's key scales at 0.1: the PARITY.md
  criteria (cosine > 0.999, median abs error <= 1e-3) and 1e-4 of the
  output scale; the stats alike;
* one training step of the task's loss on both sides with the same noise:
  the auction loss within 1% (an untrained model's output is a tight
  blob, where the auction turns a 1e-6 difference into another matching
  for some points), the Chamfer monitor and the occupancy, the BatchNorm
  statistics after the step within 1e-5; and the gradient of every
  parameter leaf (cosine > 0.999, median error <= 1e-3 of the leaf's
  scale) through the fixed assignment of the JAX auction, which has no
  gradient of its own;
* at full size, from ``eval_shape``: every JAX leaf has a port name and
  every port name a JAX leaf (``load_jax_variables`` strict), and
  ``port_to_jax_tree`` gives the tree back leaf for leaf.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_transformers_tpu.models.reconstructor as jrec_mod
import cloud_transformers_tpu.nn.resnet as jresnet
import cloud_transformers_tpu.tasks.reconstruction as jtask
import cloud_transformers_tpu_torch.models.reconstructor as trec_mod
import cloud_transformers_tpu_torch.nn.resnet as tresnet
import cloud_transformers_tpu_torch.tasks.reconstruction as ttask
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.models.classifier import TINY_STAGE_PLAN
from cloud_transformers_tpu.models.inpainter import (
    AdaInDecoder as JaxAdaInDecoder,
)
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.models.inpainter import AdaInDecoder
from cloud_transformers_tpu_torch.nn.init import init_model_

WIDTHS = dict(num_latent=16, model_dim=32)


@contextlib.contextmanager
def _tiny():
    """Both ``Reconstructor``s at one TINY decoder stage and a (1, 1, 1, 1)
    ResNet while the context lasts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec_mod, "AdaInDecoder", functools.partial(
            JaxAdaInDecoder, repeats=1, stage_plan=TINY_STAGE_PLAN,
            remat=False))
        mp.setattr(jresnet, "ResNet50", functools.partial(
            jresnet.ResNet50, stage_sizes=(1, 1, 1, 1)))
        mp.setattr(trec_mod, "AdaInDecoder",
                   lambda dim, latent, repeats, plan: AdaInDecoder(
                       dim, latent, 1, TINY_STAGE_PLAN))
        mp.setattr(tresnet, "ResNet50", functools.partial(
            tresnet.ResNet50, stage_sizes=(1, 1, 1, 1)))
        yield


def _inputs(seed=0, b=2, p=64, hw=64):
    rs = np.random.RandomState(seed)
    u = rs.uniform(size=(2, b, p))
    cos_phi = 1.0 - 2.0 * u[1]
    sin_phi = np.sqrt(1.0 - cos_phi ** 2)
    theta = 2 * np.pi * u[0]
    noise = np.stack([sin_phi * np.cos(theta), sin_phi * np.sin(theta),
                      cos_phi], -1).astype(np.float32)
    image = rs.randn(b, hw, hw, 3).astype(np.float32)
    gt = rs.uniform(0.2, 0.8, (b, p, 3)).astype(np.float32)
    return noise, image, gt


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _with_key_scales(v, value):
    def fix(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "scale" and "decoder" in names:
            return np.full(np.shape(a), value, np.float32)
        return np.asarray(a)
    return {**v, "params": jax.tree_util.tree_map_with_path(fix,
                                                            v["params"])}


@pytest.fixture(scope="module")
def setup():
    noise, image, gt = _inputs()
    with _tiny():
        jm = jax_model("image_reconstructor", **WIDTHS)
        shapes = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32),
            jax.eval_shape(lambda: jm.init(
                {"params": jax.random.PRNGKey(0)}, jnp.asarray(noise),
                jnp.asarray(image), train=False)))
        port = init_model_(get_model("image_reconstructor", **WIDTHS),
                           torch.Generator().manual_seed(0))
    v = {"params": port_to_jax_tree(dict(port.named_parameters()),
                                    shapes["params"]),
         "batch_stats": port_to_jax_tree(dict(port.named_buffers()),
                                         shapes["batch_stats"])}
    rs = np.random.RandomState(1)

    def scales(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] != "scale" or "decoder" in names:
            return np.asarray(a)
        return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)

    v["params"] = jax.tree_util.tree_map_with_path(scales, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return (noise, image, gt), jm, v


def _port(v, train):
    with _tiny():
        model = get_model("image_reconstructor", **WIDTHS)
    return load_jax_variables(model, v).train(train)


def test_forward_matches_jax(setup):
    (noise, image, _), jm, v = setup
    v = _with_key_scales(v, 0.1)
    with _tiny():
        want, want_stats = jm.apply(v, jnp.asarray(noise),
                                    jnp.asarray(image), train=False)
    want = np.asarray(want, np.float64)
    tm = _port(v, train=False)
    assert len(tm.res50.trunk.blocks) == 4 and len(tm.decoder.stages) == 1
    with torch.no_grad():
        got, stats = tm(torch.from_numpy(noise), torch.from_numpy(image))
    assert got.shape == (2, 64, 3) and len(stats) == len(want_stats) == 2
    got = got.numpy().astype(np.float64)
    assert 0.0 < got.min() and got.max() < 1.0          # the sigmoid
    cos = got.ravel() @ want.ravel() / (np.linalg.norm(got)
                                        * np.linalg.norm(want))
    assert cos > 0.999 and np.median(np.abs(got - want)) <= 1e-3
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    for s, w in zip(stats, want_stats):
        assert set(s) == set(w)
        for k in w:
            np.testing.assert_allclose(float(s[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_training_step_matches_jax(setup, monkeypatch):
    (noise, image, gt), jm, v = setup
    # the key scales stay at their initial 0, as when training starts (the
    # inpainter's test says why: with them on, a 1e-6 difference in the
    # keys moves points across cell borders, where the gradient jumps)
    batch = {"image": image, "pcd": gt}
    caught = {}

    def j_auction(recon, target, **kw):
        dist, assignment = emd(recon, target, **kw)
        caught["assignment"] = np.asarray(assignment)
        return dist, assignment
    emd = jtask.emd_auction
    monkeypatch.setattr(jtask, "emd_auction", j_auction)
    monkeypatch.setattr(jtask, "sphere_noise",
                        lambda key, b, n: jnp.asarray(noise))
    monkeypatch.setattr(ttask, "sphere_noise",
                        lambda gen, b, n, device: torch.from_numpy(noise))
    with _tiny():
        j_loss, j_aux, j_stats = jtask.make_loss_fn()(
            jm.apply, v, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0), True)
    matched = np.take_along_axis(gt, caught["assignment"][..., None], 1)

    def compute(params):
        with _tiny():
            (recon, _), _ = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                jnp.asarray(noise), jnp.asarray(image), train=True,
                mutable=["batch_stats"])
        dist = jnp.sum((recon - jnp.asarray(matched)) ** 2, -1)
        return jnp.mean(jnp.sqrt(dist + 1e-12))
    j_fixed, j_grads = jax.value_and_grad(compute)(v["params"])
    np.testing.assert_allclose(float(j_fixed), float(j_loss), rtol=1e-6)

    # the task's loss function, its own auction on the port's output
    tm = _port(v, train=True)
    t_loss, t_aux = ttask.make_loss_fn(torch.Generator())(
        tm, {k: torch.from_numpy(a) for k, a in batch.items()})
    assert abs(float(t_loss.detach()) - float(j_loss)) <= 0.01 * float(j_loss)
    assert not t_aux["loss_chamfer"].requires_grad
    for k in ("loss_chamfer", "occupancy_mean"):
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]),
                                   rtol=1e-5, err_msg=k)
    t_stats = dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                            v["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)

    # the gradients through JAX's assignment, on a fresh copy
    tm = _port(v, train=True)
    recon, _ = tm(torch.from_numpy(noise), torch.from_numpy(image))
    dist = ((recon - torch.from_numpy(matched)) ** 2).sum(-1)
    loss = torch.sqrt(dist + 1e-12).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_fixed),
                               rtol=1e-5)
    t_grads = dict(_leaves(port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, v["params"])))
    j_leaves = dict(_leaves(j_grads))
    assert set(j_leaves) == set(t_grads) and len(j_leaves) > 60
    # a bias that feeds a normalization has no gradient, and the key path
    # behind a key scale of 0 none either: rounding noise on both sides,
    # with no direction to compare
    floor = 1e-6 * max(np.abs(ref).max() for ref in j_leaves.values())
    compared, failed = 0, []
    for name, ref in j_leaves.items():
        got = t_grads[name]
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        if scale <= floor:
            assert (name.endswith("/bias") or "keys_adain" in name) \
                and np.abs(got).max() <= floor, name
            continue
        cos = (got.ravel() @ ref.ravel()
               / (np.linalg.norm(got) * np.linalg.norm(ref)))
        p50 = np.median(np.abs(got - ref)) / scale
        if not (cos > 0.999 and p50 <= 1e-3):
            failed.append((name, cos, p50))
        compared += 1
    assert not failed, failed
    assert compared >= len(j_leaves) - 12
    # the image reaches the loss: the ResNet's stem has a gradient
    assert np.abs(t_grads["res50/trunk/Conv_0/kernel"]).max() > 0


def test_full_size_tree_loads_strictly_and_round_trips():
    noise, image, _ = _inputs(b=1, p=16, hw=32)
    jm = jax_model("image_reconstructor")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(noise),
        jnp.asarray(image), train=False))
    rs = np.random.RandomState(2)
    v = jax.tree_util.tree_map(
        lambda s: rs.standard_normal(s.shape).astype(np.float32), shapes)
    tm = get_model("image_reconstructor")
    state = jax_to_state_dict(v)
    assert set(state) == set(tm.state_dict())
    for k, t in tm.state_dict().items():
        assert tuple(state[k].shape) == tuple(t.shape), k
    for name in ("res50.trunk.stem_conv.weight", "res50.trunk.stem_bn.var",
                 "res50.trunk.blocks.15.conv3.weight",
                 "res50.trunk.blocks.13.downsample_bn.mean",
                 "res50.trunk.blocks.0.downsample_conv.weight",
                 "mapping.weight", "start_conv.weight",
                 "start_adain.dense.bias",
                 "decoder.stages.3.union_2.attention_1.conv.weight",
                 "decoder.stages.0.union_0.attention_0.keys_adain.dense."
                 "weight", "final_conv1.weight", "final_conv2.bias"):
        assert name in state, name
    assert "res50.trunk.blocks.1.downsample_conv.weight" not in state
    load_jax_variables(tm, v)
    for collection, tensors in (("params", dict(tm.named_parameters())),
                                ("batch_stats", dict(tm.named_buffers()))):
        back = dict(_leaves(port_to_jax_tree(tensors, v[collection])))
        ref = dict(_leaves(v[collection]))
        assert set(back) == set(ref) and len(ref) > 100
        for name, a in ref.items():
            np.testing.assert_array_equal(back[name], a, err_msg=name)



@pytest.mark.parametrize("root", [(), ("res50",)])
def test_stem_names_only_in_the_node_that_holds_the_bottlenecks(root):
    """The stem rule keys on the ``Bottleneck_i`` blocks, not on the name
    ``trunk`` that the MHCT trunks share (the segmenter's at the root, the
    classifier's under ``backbone``): an auto-named conv under another
    ``trunk`` keeps its JAX name."""
    def at(path, tree):
        for part in reversed(path):
            tree = {part: tree}
        return tree

    z = np.zeros((1, 1, 2, 2), np.float32)
    resnet = {"Conv_0": {"kernel": z}, "BatchNorm_0": {"scale": z[0, 0, 0]},
              "Bottleneck_0": {"Conv_3": {"kernel": z}}}
    other = ("backbone",) if not root else ()
    params = {**at(root + ("trunk",), resnet),
              **at(other + ("trunk",), {"Conv_0": {"kernel": z}})}
    state = jax_to_state_dict({"params": params})
    prefix = "".join(p + "." for p in root)
    other_prefix = "".join(p + "." for p in other)
    assert set(state) == {prefix + "trunk.stem_conv.weight",
                          prefix + "trunk.stem_bn.scale",
                          prefix + "trunk.blocks.0.downsample_conv.weight",
                          other_prefix + "trunk.Conv_0.weight"}
    back = dict(_leaves(port_to_jax_tree(state, params)))
    assert set(back) == set(dict(_leaves(params)))
