"""Port parity: the KPConv-protocol S3DIS segmenter (``SegmenterPad``) and
its masked loss, on ragged masks.

A tiny segmenter (the ``TINY`` of ``tests/test_torch_segmenter.py``: one
repeat of a one-union stage plan whose 3D head group is 16^3, so the JAX
model reaches pallas_grid_conv in interpret mode) takes B=2 x 128 points
with 4 features, padded as the protocol pads (the padded points repeat
valid points, 40% and 75% of the rows valid).  The same weights run in
JAX and in the port, the port's converted from the JAX variables.

* The eval-mode logits pass the PARITY.md criteria (cosine > 0.999,
  median abs error <= 1e-3), at the valid points and at all points.
* One training step with the masked cross-entropy: the loss and the
  accuracy within 1e-5 (relative), the predictions equal, the
  concatenated gradient and the gradient of every parameter leaf (brought
  back into the JAX tree by ``port_to_jax_tree``) by the PARITY.md
  criteria, the BatchNorm running statistics after the step within 1e-5.
  A leaf outside them must lie within the port's own noise floor (its
  gradient with the inputs jittered by 1e-6, PARITY.md's floor), fewer
  than a quarter of the leaves: on these inputs one splat cell of the
  16^3 group has two valid points within 1e-5 of each other, a near tie
  whose winner (and with it the gradient of that group's key path and of
  the stem, at cosines down to 0.9985) flips under that jitter.
* The mask matters: padded points whose features change move no valid
  point's logit, on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import segmentation_kpconv as jtask
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as ttask

TINY = dict(n_classes=13, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),))
VALID = (0.4, 0.75)   # the valid share of each row


def _batch(seed=0, p=128):
    """Rows padded as ``S3DISSeg`` pads them: the first ``n`` points are
    valid, the rest repeat valid ones (points, features and labels)."""
    rs = np.random.RandomState(seed)
    b = len(VALID)
    idx = np.zeros((b, p), np.int64)
    mask = np.zeros((b, p), np.float32)
    for i, share in enumerate(VALID):
        n = int(share * p)
        idx[i] = np.concatenate([np.arange(n), rs.randint(0, n, p - n)])
        mask[i, :n] = 1
    pts = rs.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    feats = np.concatenate([rs.uniform(-1.5, 1.5, (b, p, 3)),
                            rs.uniform(0, 3, (b, p, 1))], -1)
    labels = rs.randint(0, 13, (b, p))
    take = np.take_along_axis
    return {"points": take(pts, idx[..., None], 1),
            "mask": mask,
            "features": take(feats.astype(np.float32), idx[..., None], 1),
            "label": take(labels, idx, 1).astype(np.int32)}


def _inputs(batch):
    return (jnp.asarray(batch["points"]), jnp.asarray(batch["mask"]),
            jnp.asarray(batch["features"]))


def _jax_variables(model, batch, seed=0):
    """JAX variables made from the port's own initialisation (the JAX
    tree's shapes from ``eval_shape``), with every BatchNorm scale and
    running statistic randomised from numpy (``key_bn.scale`` starts at 0,
    which would switch the key path off)."""
    from cloud_transformers_tpu_torch.nn.init import init_model_
    shapes = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(seed),
             "dropout": jax.random.PRNGKey(seed + 1)},
            *_inputs(batch), train=False)))
    port = init_model_(get_model("s3dis_segmenter_pad", **TINY),
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


def _port_grads(model, params):
    """The port model's parameter gradients as the leaves of the JAX tree
    ``params``."""
    return dict(_leaves(port_to_jax_tree(
        {n: p.grad for n, p in model.named_parameters()}, params)))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "label"
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_setup():
    batch = _batch()
    jm = jax_model("s3dis_segmenter_pad", remat=False, **TINY)
    return batch, jm, _jax_variables(jm, batch)


def test_segmenter_pad_matches_jax(jax_setup):
    batch, jm, variables = jax_setup
    j_logits, j_stats = jm.apply(variables, *_inputs(batch), train=False)
    tm = load_jax_variables(get_model("s3dis_segmenter_pad", **TINY),
                            variables).eval()
    assert tm.stem.in_features == 7
    t = _torch_batch(batch)
    with torch.no_grad():
        t_logits, t_stats = tm(t["points"], t["mask"], t["features"])
    assert t_logits.shape == (2, 128, 13)
    valid = batch["mask"].astype(bool)
    for sel in (valid, slice(None)):
        cos, p50 = _parity(np.asarray(j_logits)[sel], t_logits.numpy()[sel])
        assert cos > 0.999 and p50 <= 1e-3, (cos, p50)
    assert len(t_stats) == len(j_stats) == 2
    for js, ts in zip(j_stats, t_stats):
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-5, atol=1e-5)


def test_padded_points_move_no_valid_logit(jax_setup):
    """A padded point's features are zeroed before every splat and its
    output after every slice: changing them leaves the valid points'
    eval logits as they were (both frameworks)."""
    batch, jm, variables = jax_setup
    moved = dict(batch, features=np.where(batch["mask"][..., None] > 0,
                                          batch["features"],
                                          batch["features"] + 5.0))
    valid = batch["mask"].astype(bool)
    j0 = np.asarray(jm.apply(variables, *_inputs(batch), train=False)[0])
    j1 = np.asarray(jm.apply(variables, *_inputs(moved), train=False)[0])
    np.testing.assert_allclose(j1[valid], j0[valid], rtol=0, atol=1e-5)
    tm = load_jax_variables(get_model("s3dis_segmenter_pad", **TINY),
                            variables).eval()
    with torch.no_grad():
        t0, t1 = (tm(t["points"], t["mask"], t["features"])[0].numpy()
                  for t in (_torch_batch(batch), _torch_batch(moved)))
    np.testing.assert_allclose(t1[valid], t0[valid], rtol=0, atol=1e-5)
    assert np.abs(t1[~valid] - t0[~valid]).max() > 1e-3


def test_masked_train_step_matches_jax(jax_setup):
    batch, jm, variables = jax_setup
    j_loss_fn = jtask.make_loss_fn()

    def compute(params):
        loss, aux, new_stats = j_loss_fn(
            jm.apply, {"params": params,
                       "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), True)
        return loss, (aux, new_stats)

    (j_loss, (j_aux, j_stats)), j_grads = jax.value_and_grad(
        compute, has_aux=True)(variables["params"])

    tm = load_jax_variables(get_model("s3dis_segmenter_pad", **TINY),
                            variables).train()
    t_loss, t_aux = ttask.make_loss_fn()(tm, _torch_batch(batch))
    t_loss.backward()

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_aux["acc"]), float(j_aux["acc"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(t_aux["pred"].numpy(),
                                  np.asarray(j_aux["pred"]))
    cos, p50 = _parity(j_aux["logits"], t_aux["logits"].numpy())
    assert cos > 0.999 and p50 <= 1e-3, (cos, p50)

    t_leaves = _port_grads(tm, variables["params"])
    # the port's own gradients with the features jittered by 1e-6 (the
    # PARITY.md noise floor)
    rs = np.random.RandomState(9)
    jittered = dict(batch, features=(batch["features"] + 1e-6 * rs.randn(
        *batch["features"].shape)).astype(np.float32))
    tm_j = load_jax_variables(get_model("s3dis_segmenter_pad", **TINY),
                              variables).train()
    ttask.make_loss_fn()(tm_j, _torch_batch(jittered))[0].backward()
    floor_leaves = _port_grads(tm_j, variables["params"])
    j_leaves = dict(_leaves(j_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 30
    cos, p50 = _parity(np.concatenate([v.ravel() for v in j_leaves.values()]),
                       np.concatenate([t_leaves[n].ravel()
                                       for n in j_leaves]))
    assert cos > 0.999 and p50 <= 1e-3, (cos, p50)
    # a bias that feeds a BatchNorm has no gradient (the batch mean takes
    # it out): rounding noise on both sides, with no direction to compare
    floor = 1e-5 * max(np.abs(ref).max() for ref in j_leaves.values())
    compared = in_floor = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        if scale <= floor:
            assert name.endswith("/bias") and np.abs(got).max() <= floor, name
            continue
        cos, p50 = _parity(ref, got)
        p50 /= scale
        compared += 1
        if cos > 0.999 and p50 <= 1e-3:
            continue
        # PARITY.md: a cross-framework difference within the port's own
        # floor.  A splat winner decided by a gap of 1e-5 of its value (a
        # near tie between two valid points of one cell, which a 1e-6
        # jitter of the inputs flips) moves a key path's gradient as much
        # as a cell-boundary flip does.
        floor_cos, _ = _parity(floor_leaves[name], got)
        assert floor_cos <= cos + 1e-3, (name, cos, p50, floor_cos)
        in_floor += 1
    # here: the stem, its BatchNorm and the 16^3 group's key path, 7 of 33
    assert compared >= len(j_leaves) - 6 and 4 * in_floor < compared
    key_leaves = [n for n in j_leaves if "key_bn/bias" in n]
    assert len(key_leaves) == 2
    for n in key_leaves:
        assert np.abs(t_leaves[n]).max() > 0

    t_stats = dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                            variables["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_masked_loss_ignores_padded_points():
    """The loss and the accuracy average over the valid points only; a
    batch with no valid point gives 0, not a division by zero."""
    logits = torch.randn(2, 5, 13, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 13, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 0, 0, 0, 0]],
                        dtype=torch.float32)

    class Fixed(torch.nn.Module):
        def forward(self, points, pts_mask, features):
            return self.logits, []

    m = Fixed()
    m.logits = logits
    batch = {"points": None, "features": None, "label": labels,
             "mask": mask}
    loss, aux = ttask.make_loss_fn()(m, batch)
    per = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 13), labels.reshape(-1), reduction="none")
    want = per.reshape(2, 5)[mask > 0].mean()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    correct = (logits.argmax(-1) == labels)[mask > 0].float().mean()
    torch.testing.assert_close(aux["acc"], correct)
    loss0, aux0 = ttask.make_loss_fn()(m, dict(batch, mask=mask * 0))
    assert float(loss0) == 0.0 and float(aux0["acc"]) == 0.0
