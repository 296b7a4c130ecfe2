"""Port parity: the classifier with learned per-head scales
(``scanobject_classifier_scales``) and the ``model_dim_out`` shortcut.

- The frames with ``scales`` (``VolTransformer``, ``PlaneTransformer``),
  random rotations, shifts and scales, against JAX's: the scale step
  exactly (in each framework the frame with scales is the frame without
  them times the scales, bit for bit), the frames within 1e-6 of their
  scale (the SO(3) map and the three-term rotation round differently in
  the last bit).
- A tiny ``scanobject_classifier_scales`` (B=2, P=128, one stage of a 16^2
  and a 16^3 head group, so that JAX reaches ``pallas_grid_conv``, small
  pools) with random scales (0.5-1.5, not the initial ones), loaded from
  the JAX variables by ``load_jax_variables``:
  the eval logits and mask by the PARITY.md criteria (cosine > 0.999,
  median error <= 1e-3) and the block stats within 1e-5; one training step
  (no dropout on either side) with the loss within 1e-5 (relative), every
  gradient leaf by the PARITY.md criteria of its own scale, and the
  BatchNorm statistics after the step within 1e-5; every ``scales`` leaf
  has a gradient.  The two clouds have different extents: with alike
  clouds (or an 8^3 head group) the classifier's BatchNorm over the batch
  axis divides by a spread near 0, and the port's own gradient then moves
  by a median 0.5-2% of a leaf's scale when the cloud is jittered by 1e-6
  (``tests/test_torch_inpainter.py``).
- ``MultiHeadUnion(model_dim=16, model_dim_out=24)`` in training mode: its
  JAX variables (``shortcut_conv``, ``shortcut_bn``) load strictly; the
  output, the input's gradient and every parameter's gradient by the
  PARITY.md criteria, the BatchNorm statistics within 1e-5.

JAX reaches its Pallas kernels in interpret mode, as its own tests do; one
JAX build of each model serves the whole file."""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.nn import multihead as jmh
from cloud_transformers_tpu.nn import transforms as jtr
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.nn import multihead as tmh
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.nn import transforms as ttr
from cloud_transformers_tpu_torch.tasks import classification as tcls

NAME = "scanobject_classifier_scales"
TINY = dict(n_classes=15, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=8, class_dim=32, mask_dim=16)


def _variables(jax_module, port_module, *inputs, rs):
    """JAX variables for ``jax_module`` from ``port_module``'s fresh
    initialisation (the JAX tree's shapes from ``jax.eval_shape``, which
    traces no kernel), then ``_randomised``."""
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *inputs))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes)
    state = init_model_(port_module, torch.Generator().manual_seed(0))
    state = state.state_dict()
    return _randomised({c: port_to_jax_tree(state, zeros[c])
                        for c in ("params", "batch_stats")}, rs)


def _randomised(variables, rs):
    """Every BatchNorm scale (0.2-0.6 on the keys, whose initial 0 would
    switch the key path off), every frame's ``scales`` (0.5-1.5) and every
    running statistic (0.5-1.5) drawn from numpy."""
    def leaf(path, a):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] == "scales":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if names[-1] != "scale":
            return np.asarray(a)
        lo, hi = (0.2, 0.6) if "key_bn" in names else (0.5, 1.5)
        return rs.uniform(lo, hi, a.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(
                leaf, variables["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: rs.uniform(0.5, 1.5, a.shape).astype(np.float32),
                variables["batch_stats"])}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _parity(ref, got, what):
    a = np.asarray(ref, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    p50 = np.median(np.abs(a - b)) / np.abs(a).max()
    assert cos > 0.999 and p50 <= 1e-3, (what, cos, p50)


def _held_leaf_by_leaf(j_tree, t_tree):
    """Every gradient leaf by the PARITY.md criteria of its own scale; a
    bias that feeds a BatchNorm has no gradient in either framework
    (rounding noise below 1e-6 of the largest leaf, as in
    ``tests/test_torch_train_step.py``) and is held to that."""
    j_leaves, t_leaves = dict(_leaves(j_tree)), dict(_leaves(t_tree))
    assert set(j_leaves) == set(t_leaves)
    floor = 1e-6 * max(np.abs(r).max() for r in j_leaves.values())
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        assert got.shape == ref.shape, name
        if np.abs(ref).max() <= floor:
            assert name.endswith("/bias") and np.abs(got).max() <= floor, \
                name
            continue
        _parity(ref, got, name)
    return j_leaves, t_leaves


@pytest.mark.parametrize("cls,dims", [("VolTransformer", 3),
                                      ("PlaneTransformer", 2)])
def test_frames_with_scales_match_jax(cls, dims):
    rs = np.random.RandomState(0)
    pcd = rs.randn(2, 16, 4, 3).astype(np.float32)
    params = {"log_R": rs.randn(4, 3).astype(np.float32),
              "shift": rs.randn(4, 3).astype(np.float32),
              "scales": rs.uniform(0.5, 1.5, (4, dims)).astype(np.float32)}
    scaled, plain = (
        np.asarray(getattr(jtr, cls)(heads=4, scales=on).apply(
            {"params": params if on else {k: params[k]
                                          for k in ("log_R", "shift")}},
            jnp.asarray(pcd))) for on in (True, False))
    np.testing.assert_array_equal(scaled, plain * params["scales"])

    tm = getattr(ttr, cls)(4, scales=True)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                       strict=True)
    bare = getattr(ttr, cls)(4)
    assert "scales" not in dict(bare.named_parameters())   # as in JAX
    bare.load_state_dict({k: torch.from_numpy(params[k])
                          for k in ("log_R", "shift")}, strict=True)
    with torch.no_grad():
        got, got_plain = (m(torch.from_numpy(pcd)).numpy()
                          for m in (tm, bare))
    assert got.shape == (2, 16, 4, dims)
    np.testing.assert_array_equal(got, got_plain * params["scales"])
    np.testing.assert_allclose(got, scaled, rtol=0,
                               atol=1e-6 * np.abs(scaled).max())


@pytest.fixture(scope="module")
def tiny():
    rs = np.random.RandomState(0)
    extent = rs.uniform(0.2, 1.0, (2, 1, 3))
    batch = {"pcd": (rs.uniform(-1, 1, (2, 128, 3))
                     * extent).astype(np.float32),
             "label": rs.randint(0, 15, 2).astype(np.int32),
             "mask": (rs.uniform(size=(2, 128)) > 0.5).astype(np.float32)}
    jm = jax_model(NAME, remat=False, **TINY)
    variables = _variables(jm, get_model(NAME, **TINY),
                           jnp.asarray(batch["pcd"]), False, rs=rs)
    return jm, variables, batch


def test_scales_classifier_matches_jax(tiny):
    jm, variables, batch = tiny
    j_cls, j_mask, j_stats = jax.jit(
        lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(batch["pcd"]))
    tm = load_jax_variables(get_model(NAME, **TINY), variables).eval()
    with torch.no_grad():
        t_cls, t_mask, t_stats = tm(torch.from_numpy(batch["pcd"]))
    _parity(j_cls, t_cls.numpy(), "class logits")
    _parity(j_mask, t_mask.numpy(), "point mask")
    assert len(t_stats) == len(j_stats) == 2 + 2
    for js, ts in zip(j_stats, t_stats):
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-5, atol=1e-5)


def test_scales_classifier_train_step_matches_jax(tiny):
    jm, variables, batch = tiny
    j_loss_fn = jcls.make_loss_fn(0.5)

    def compute(params):
        loss, aux, new_stats = j_loss_fn(
            jm.apply, {"params": params,
                       "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), True)
        return loss, new_stats

    with mock.patch.object(
            flax.linen.Dropout, "__call__",
            lambda self, inputs, deterministic=None, rng=None: inputs):
        (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(
            compute, has_aux=True))(variables["params"])

    tm = load_jax_variables(get_model(NAME, dropout=0.0, **TINY),
                            variables).train()
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch["label"] = t_batch["label"].long()
    t_loss, _ = tcls.make_loss_fn(0.5)(tm, t_batch)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)

    _, t_leaves = _held_leaf_by_leaf(j_grads, port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"]))
    scales = [n for n in t_leaves if n.endswith("/scales")]
    assert len(scales) == 4           # two head groups, two pools
    assert all(np.abs(t_leaves[n]).max() > 0 for n in scales)

    t_stats = dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                            variables["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_union_shortcut_matches_jax():
    """``model_dim_out`` 24 from ``model_dim`` 16: the residual is
    ``shortcut_bn(shortcut_conv(x))``, and ``after_conv`` projects to 24."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 64, 16).astype(np.float32)
    pcd = rs.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    cot = rs.randn(2, 64, 24).astype(np.float32)
    plan = dict(features_dims=(4, 4), tensor_sizes=(8, 4),
                tensor_dims=(2, 3), heads=(2, 2))
    jm = jmh.MultiHeadUnion(model_dim=16, model_dim_out=24, scales=True,
                            **plan)
    variables = _variables(
        jm, tmh.MultiHeadUnion(16, model_dim_out=24, scales=True, **plan),
        jnp.asarray(x), jnp.asarray(pcd), rs=rs)
    assert {"shortcut_conv", "shortcut_bn"} <= set(variables["params"])

    def loss(params, x):
        (out, _), new = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            jnp.asarray(pcd), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new["batch_stats"])

    (_, (j_out, j_stats)), (j_dp, j_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                              jnp.asarray(x))

    tm = tmh.MultiHeadUnion(16, model_dim_out=24, scales=True, **plan)
    load_jax_variables(tm, variables).train()
    tx = torch.from_numpy(x).requires_grad_(True)
    t_out, _ = tm(tx, torch.from_numpy(pcd))
    (t_out * torch.from_numpy(cot)).sum().backward()
    assert t_out.shape == (2, 64, 24)
    _parity(j_out, t_out.detach().numpy(), "union output")
    _parity(j_dx, tx.grad.numpy(), "input gradient")
    _held_leaf_by_leaf(j_dp, port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"]))
    t_stats = dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                            variables["batch_stats"])))
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stats[name], ref, rtol=0, atol=1e-5,
                                   err_msg=name)
