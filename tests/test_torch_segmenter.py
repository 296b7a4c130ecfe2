"""Port parity: the S3DIS 1x1 segmenter and its loss.

A tiny segmenter (one repeat of a one-union stage plan whose 3D head group
is 16^3, so the JAX model reaches pallas_grid_conv; B=2 x 128 points of
xyz + rgb) runs in JAX and in the port with the same weights, the port's
converted from the JAX variables.  The eval-mode logits pass the PARITY.md
criteria (cosine > 0.999, median abs error <= 1e-3).  One training step
with the task's loss, label smoothing 0 and 0.1: the loss within 1e-5
(relative), the gradient of every parameter leaf (brought back into the
JAX tree by ``port_to_jax_tree``) by the PARITY.md criteria, the BatchNorm
running statistics after the step within 1e-5.  The task's eval hook, the
full-width parameter tree and the command line are in
``tests/test_torch_segmentation_task.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import segmentation as jseg
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import segmentation as tseg

TINY = dict(n_classes=13, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),))


def _batch(seed=0, b=2, p=128):
    rs = np.random.RandomState(seed)
    pcd = np.concatenate([rs.uniform(-1, 1, (b, p, 3)),
                          rs.uniform(0, 1, (b, p, 3))], -1)
    return {"pcd": pcd.astype(np.float32),
            "label": rs.randint(0, 13, (b, p)).astype(np.int32)}


def _jax_variables(model, pcd, seed=0):
    """JAX variables made from the port's own initialisation (the JAX
    tree's shapes from ``eval_shape``, so that no JAX forward runs), with
    every BatchNorm scale and running statistic randomised from numpy
    (``key_bn.scale`` starts at 0, which would switch the key path off)."""
    from cloud_transformers_tpu_torch.nn.init import init_model_
    shapes = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(seed),
             "dropout": jax.random.PRNGKey(seed + 1)},
            jnp.asarray(pcd), train=False)))
    port = init_model_(get_model("s3dis_segmenter", **TINY),
                       torch.Generator().manual_seed(seed))
    v = {"params": port_to_jax_tree(dict(port.named_parameters()),
                                    shapes["params"]),
         "batch_stats": port_to_jax_tree(dict(port.named_buffers()),
                                         shapes["batch_stats"])}
    rs = np.random.RandomState(seed)

    def scales(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] != "scale":
            return np.asarray(a)
        lo, hi = (0.2, 0.6) if "key_bn" in names else (0.5, 1.5)
        return rs.uniform(lo, hi, a.shape).astype(np.float32)

    v["params"] = jax.tree_util.tree_map_with_path(scales, v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    return v


def _parity(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return cos, np.median(np.abs(a - b))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


@pytest.fixture(scope="module")
def jax_setup():
    batch = _batch()
    jm = jax_model("s3dis_segmenter", remat=False, **TINY)
    return batch, jm, _jax_variables(jm, batch["pcd"])


def test_segmenter_matches_jax(jax_setup):
    batch, jm, variables = jax_setup
    j_logits, j_stats = jm.apply(variables, jnp.asarray(batch["pcd"]),
                                 train=False)
    tm = load_jax_variables(get_model("s3dis_segmenter", **TINY),
                            variables).eval()
    with torch.no_grad():
        t_logits, t_stats = tm(torch.from_numpy(batch["pcd"]))
    assert t_logits.shape == (2, 128, 13)
    cos, p50 = _parity(j_logits, t_logits.numpy())
    assert cos > 0.999 and p50 <= 1e-3, (cos, p50)
    assert len(t_stats) == len(j_stats) == 2
    for js, ts in zip(j_stats, t_stats):
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_train_step_matches_jax(jax_setup, smooth):
    batch, jm, variables = jax_setup
    j_loss_fn = jseg.make_loss_fn(13, label_smooth=smooth)

    def compute(params):
        loss, aux, new_stats = j_loss_fn(
            jm.apply, {"params": params,
                       "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), True)
        return loss, (aux, new_stats)

    (j_loss, (j_aux, j_stats)), j_grads = jax.value_and_grad(
        compute, has_aux=True)(variables["params"])

    tm = load_jax_variables(get_model("s3dis_segmenter", **TINY),
                            variables).train()
    t_batch = {"pcd": torch.from_numpy(batch["pcd"]),
               "label": torch.from_numpy(batch["label"]).long()}
    t_loss, t_aux = tseg.make_loss_fn(13, label_smooth=smooth)(tm, t_batch)
    t_loss.backward()

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    for k in ("acc", "occupancy_mean"):
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(t_aux["pred"].numpy(),
                                  np.asarray(j_aux["pred"]))

    t_grads = port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"])
    j_leaves = dict(_leaves(j_grads))
    t_leaves = dict(_leaves(t_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 30
    # a bias that feeds a BatchNorm (the stem's, each grid conv's: a
    # constant a channel after the slice) has no gradient, the batch mean
    # takes it out: rounding noise on both sides, 1e-7 to 1e-6 of the
    # largest leaf here, with no direction to compare.  Every other leaf
    # is above 1e-2 of the largest.
    floor = 1e-5 * max(np.abs(ref).max() for ref in j_leaves.values())
    compared = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        if scale <= floor:
            assert name.endswith("/bias") and np.abs(got).max() <= floor, name
            continue
        cos = (got.ravel() @ ref.ravel()
               / (np.linalg.norm(got) * np.linalg.norm(ref)))
        p50 = np.median(np.abs(got - ref)) / scale
        assert cos > 0.999 and p50 <= 1e-3, (name, cos, p50)
        compared += 1
    assert compared >= len(j_leaves) - 6
    key_leaves = [n for n in j_leaves if "key_bn/bias" in n]
    assert len(key_leaves) == 2
    for n in key_leaves:
        assert np.abs(t_leaves[n]).max() > 0

    t_stats = dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                            variables["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)
