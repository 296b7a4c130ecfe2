"""Port parity: the completion model (``completion_inpainter``).

A tiny inpainter (one encoder stage and two decoder stages of a one-union
stage plan, narrow widths, 128 partial and 256 decoder points) with the
same weights (initialised by JAX, carried over by ``convert.py``) and the
same numpy inputs on both sides.  The decoder's key ``scale`` parameters
start at 0, which would switch the key path off, so they are set to 0.1.

* forward in eval mode: the PARITY.md criteria (cosine > 0.999, median abs
  error <= 1e-3) and, tighter, 1e-4 of the output scale;
* the convert round trip, strict in both directions;
* one training step: the EMD loss (rel 1e-5) and the gradient of every
  parameter leaf against ``jax.grad`` (cosine > 0.999 and median error <=
  1e-3 of the leaf's scale), with the noise fixed on both sides.  An
  untrained model's output is a tight blob, on which the auction turns the
  1e-6 between the two reconstructions into another matching for 9% of
  the points; the auction has no gradient of its own, so the assignment
  (JAX's) is fixed on both sides for the gradient comparison, and the
  port's own auction is held to JAX's by its loss (within 1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cloud_transformers_tpu.losses.emd import emd_auction as j_emd_auction
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.losses.emd import emd_auction
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.train.optim import make_optimizer

TINY = dict(num_latent=16, model_dim=32, latent_width=24, encoder_repeats=1,
            decoder_repeats=2,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=8)


def _inputs(seed=0, b=2, p_in=128, p_out=256):
    rs = np.random.RandomState(seed)
    noise = rs.uniform(-1, 1, (b, p_out, 4)).astype(np.float32)
    noise[..., 3] = (rs.uniform(size=(b, p_out)) > 0.5)
    # clouds of different extent: alike clouds give alike latents, and the
    # encoder's BatchNorm over the batch axis then divides by a spread near
    # 0, which turns float32 rounding into the gradient's leading digits
    extent = rs.uniform(0.2, 1.0, (b, 1, 3))
    partial = (rs.uniform(-1, 1, (b, p_in, 3)) * extent).astype(np.float32)
    gt = rs.uniform(-1, 1, (b, p_out, 3)).astype(np.float32)
    return noise, partial, gt


def _jax_variables(model, noise, partial, seed=0, keys_on=True):
    """Fresh JAX variables with the BatchNorm scales and statistics
    randomised from numpy.  ``keys_on`` sets the decoder's key scales to
    0.1 and the encoder's key BatchNorm scales to 0.2-0.6; without it both
    keep their initial 0, as at the start of training."""
    v = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(noise),
        jnp.asarray(partial), train=False))
    rs = np.random.RandomState(seed)

    def fix(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] != "scale":
            return np.asarray(a)
        if "decoder" in names:             # the key scales, stacked [repeats]
            return np.full(np.shape(a), 0.1 if keys_on else 0.0, np.float32)
        if "key_bn" in names and not keys_on:
            return np.asarray(a)
        lo, hi = (0.2, 0.6) if "key_bn" in names else (0.5, 1.5)
        return rs.uniform(lo, hi, a.shape).astype(np.float32)

    v["params"] = jax.tree_util.tree_map_with_path(fix, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def test_forward_matches_jax():
    noise, partial, _ = _inputs()
    jm = jax_model("completion_inpainter", **TINY)
    variables = _jax_variables(jm, noise, partial)
    want, want_stats = jm.apply(variables, jnp.asarray(noise),
                                jnp.asarray(partial), train=False)
    want = np.asarray(want, np.float64)
    tm = load_jax_variables(get_model("completion_inpainter", **TINY),
                            variables).eval()
    with torch.no_grad():
        got, stats = tm(torch.from_numpy(noise), torch.from_numpy(partial))
    assert got.shape == (2, 256, 3) and len(stats) == len(want_stats) == 8
    got = got.numpy().astype(np.float64)
    cos = got.ravel() @ want.ravel() / (np.linalg.norm(got)
                                        * np.linalg.norm(want))
    assert cos > 0.999 and np.median(np.abs(got - want)) <= 1e-3
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    for s, w in zip(stats, want_stats):
        np.testing.assert_allclose(float(s["occupancy"]),
                                   float(w["occupancy"]), rtol=1e-5)


def test_convert_round_trip_is_strict_both_ways():
    noise, partial, _ = _inputs()
    jm = jax_model("completion_inpainter", **TINY)
    variables = _jax_variables(jm, noise, partial)
    tm = get_model("completion_inpainter", **TINY)
    state = jax_to_state_dict(variables)
    # every JAX leaf has a port name and every port name a JAX leaf
    assert set(state) == set(tm.state_dict())
    for name in ("encoder.backbone.trunk.stages.0.union_0.attention_0.kv."
                 "keys_values_pred.weight", "encoder.class_head.weight",
                 "encoder.class_head_bn.mean", "mapping.bias",
                 "start_adain.dense.weight",
                 "decoder.stages.1.union_0.attention_1.scale",
                 "decoder.stages.0.union_0.attention_0.keys_adain.dense.bias",
                 "decoder.stages.1.union_0.attention_1.conv.weight",
                 "decoder.stages.0.union_0.after_adain.dense.weight",
                 "final_adain.dense.bias", "final_conv2.weight"):
        assert name in state, name
    tm.load_state_dict(state, strict=True)
    for collection, tensors in (("params", dict(tm.named_parameters())),
                                ("batch_stats", dict(tm.named_buffers()))):
        back = dict(_leaves(port_to_jax_tree(tensors,
                                             variables[collection])))
        ref = dict(_leaves(variables[collection]))
        assert set(back) == set(ref)
        for name, a in ref.items():
            np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_training_step_matches_jax():
    # B=4: with two clouds the encoder's BatchNorm over the batch axis
    # (class_head_bn) normalizes every channel to +-1 and passes almost no
    # gradient, whose size is then rounding
    noise, partial, gt = _inputs(1, b=4)
    jm = jax_model("completion_inpainter", **TINY)
    # The key scales stay at their initial 0, as when training starts: the
    # keys are then the input geometry on both sides, bit for bit, and the
    # key path's gradient lives in the decoder's ``scale`` and the
    # encoder's ``key_bn`` parameters (through the d_w of both backward
    # ops).  With the scales at 0.1 a difference of 1e-6 in the keys moves
    # points across cell borders, where the gradient jumps, and a few
    # leaves of the two frameworks then differ by more than the 1e-3
    # median limit (measured); the forward test has the scales at 0.1.
    variables = _jax_variables(jm, noise, partial, keys_on=False)

    def reconstruct(params):
        (recon, _), _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(noise), jnp.asarray(partial), train=True,
            mutable=["batch_stats"])
        return recon

    j_dist, j_assignment = j_emd_auction(
        reconstruct(variables["params"]), jnp.asarray(gt), eps=0.005,
        iters=50)
    j_auction_loss = float(jnp.mean(jnp.sqrt(j_dist + 1e-12)))
    matched = np.take_along_axis(gt, np.asarray(j_assignment)[..., None], 1)

    def compute(params):
        dist = jnp.sum((reconstruct(params) - jnp.asarray(matched)) ** 2, -1)
        return jnp.mean(jnp.sqrt(dist + 1e-12))

    j_loss, j_grads = jax.value_and_grad(compute)(variables["params"])
    np.testing.assert_allclose(float(j_loss), j_auction_loss, rtol=1e-6)

    tm = load_jax_variables(get_model("completion_inpainter", **TINY),
                            variables).train()
    recon, _ = tm(torch.from_numpy(noise), torch.from_numpy(partial))
    dist = ((recon - torch.from_numpy(matched)) ** 2).sum(-1)
    loss = torch.sqrt(dist + 1e-12).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    own, assignment = emd_auction(recon.detach(), torch.from_numpy(gt),
                                  eps=0.005, iters=50)
    assert abs(float(torch.sqrt(own + 1e-12).mean()) - j_auction_loss) \
        <= 0.01 * j_auction_loss
    assert assignment.shape == (4, 256)

    t_grads = port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"])
    j_leaves = dict(_leaves(j_grads))
    t_leaves = dict(_leaves(t_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 60
    # a bias that feeds a normalization has no gradient: rounding noise on
    # both sides, with no direction to compare
    floor = 1e-6 * max(np.abs(ref).max() for ref in j_leaves.values())
    compared, failed = 0, []
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        if scale <= floor:
            # a bias before a normalization, or a leaf behind a key scale
            # of 0: nothing on either side
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
    # the decoder's key path is alive: every key scale has a gradient
    scales = [n for n in j_leaves if n.startswith("decoder") and
              n.endswith("/scale")]
    assert len(scales) == 2                 # two head groups, stacked
    for n in scales:
        assert (np.abs(t_leaves[n]) > 0).all() and t_leaves[n].shape == (2,)


def test_scale_lr_groups_the_key_scales():
    """``scale_lr`` gives the decoder's key scales (and the BatchNorm
    scales, named alike) the second learning rate."""
    tm = get_model("completion_inpainter", **TINY)
    opt = make_optimizer({"optimizer": {"type": "Adam", "lr": 1e-4},
                          "scale_lr": 1e-2}, tm.named_parameters())
    base, scaled = opt.optimizer.param_groups
    assert (base["lr"], scaled["lr"]) == (1e-4, 1e-2)
    in_scaled = {id(p) for p in scaled["params"]}
    keys = [p for n, p in tm.named_parameters()
            if n.startswith("decoder.stages.") and n.endswith(".scale")]
    assert len(keys) == 4 and all(id(p) in in_scaled for p in keys)
    assert all(p.dim() == 0 and float(p.detach()) == 0.0 for p in keys)
    assert not any(id(p) in in_scaled for n, p in tm.named_parameters()
                   if n.endswith("weight"))
