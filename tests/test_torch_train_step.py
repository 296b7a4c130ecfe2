"""Port parity: one training step of the tiny ScanObjectNN classifier.

The classifier of ``tests/test_torch_classifier.py`` (B=2, P=128) runs in
train mode in JAX (``jax.grad`` through the ``custom_vjp`` ops, whose
backward kernels run in interpret mode on the CPU) and in the port (the
autograd Functions with the plain backward versions), with the same weights
and the same batch.  Dropout draws from another random stream in each
framework, so it is switched off on both sides: flax's ``Dropout.__call__``
is patched to the identity, the port is built with ``dropout=0``.

Compared: the loss (rel 1e-5), the gradient of every parameter leaf
(cosine > 0.999 and median error <= 1e-3 of the leaf's scale, the PARITY.md
criteria; no leaf needed a float64 referee, the mapping being bit-identical
on both sides), and the BatchNorm running statistics after the step (1e-5).
Parameters after an Adam step are not compared: Adam's first update is
lr * sign(g), which turns noise in a near-zero gradient into a full-size
difference.
"""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc
from cloud_transformers_tpu_torch.ops import pallas_splat as tps
from cloud_transformers_tpu_torch.tasks import classification as tcls
from cloud_transformers_tpu_torch.train.trainer import Trainer

TINY = dict(n_classes=15, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=8, class_dim=32, mask_dim=16)


def _batch(seed=0, b=2, p=128):
    rs = np.random.RandomState(seed)
    return {"pcd": rs.uniform(-1, 1, (b, p, 3)).astype(np.float32),
            "label": rs.randint(0, 15, b).astype(np.int32),
            "mask": (rs.uniform(size=(b, p)) > 0.5).astype(np.float32)}


def _jax_variables(model, pcd, seed=0):
    """Fresh JAX variables with every BatchNorm scale and running statistic
    randomised from numpy.  ``key_bn.scale`` is initialised to 0, which
    would switch off the whole key path and hide its gradient."""
    v = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.asarray(pcd), train=False))
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


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def test_train_step_matches_jax():
    batch = _batch()
    jm = jax_model("scanobject_classifier", **TINY)
    variables = _jax_variables(jm, batch["pcd"])
    j_loss_fn = jcls.make_loss_fn(0.5)

    def compute(params):
        loss, aux, new_stats = j_loss_fn(
            jm.apply, {"params": params,
                       "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), True)
        return loss, (aux, new_stats)

    with mock.patch.object(
            flax.linen.Dropout, "__call__",
            lambda self, inputs, deterministic=None, rng=None: inputs):
        (j_loss, (j_aux, j_stats)), j_grads = jax.value_and_grad(
            compute, has_aux=True)(variables["params"])

    tm = load_jax_variables(
        get_model("scanobject_classifier", dropout=0.0, **TINY),
        variables).train()
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_batch["label"] = t_batch["label"].long()
    t_loss, t_aux = tcls.make_loss_fn(0.5)(tm, t_batch)
    t_loss.backward()

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    for k in ("loss_cls", "loss_seg", "occupancy_mean"):
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]),
                                   rtol=1e-5, err_msg=k)

    t_grads = port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"])
    j_leaves = dict(_leaves(j_grads))
    t_leaves = dict(_leaves(t_grads))
    assert set(j_leaves) == set(t_leaves) and len(j_leaves) > 60
    # A bias that feeds a BatchNorm has no gradient at all (the batch mean
    # takes it out again): what either framework holds there is rounding
    # noise, some 1e-8 of the largest gradient, and has no direction to
    # compare.  Such a leaf must be noise in the port too.
    floor = 1e-6 * max(np.abs(ref).max() for ref in j_leaves.values())
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
    # the key path is alive on both sides
    key_leaves = [n for n in j_leaves if "key_bn/bias" in n]
    assert len(key_leaves) == 4
    for n in key_leaves:
        assert np.abs(t_leaves[n]).max() > 0

    t_stats = port_to_jax_tree(dict(tm.named_buffers()),
                               variables["batch_stats"])
    t_stat_leaves = dict(_leaves(t_stats))
    moved = 0
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(t_stat_leaves[name], ref, rtol=0,
                                   atol=1e-5, err_msg=name)
        before = dict(_leaves(variables["batch_stats"]))[name]
        moved += np.abs(ref - before).max() > 1e-3
    assert moved > 20                            # the statistics did move


def test_trainer_takes_steps_on_the_cpu(tmp_path):
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-3},
                     "scheduler": {"type": "StepLR", "gamma": 0.7,
                                   "step_size": 2},
                     "show_each": 2}}
    model = get_model("scanobject_classifier", **TINY)
    trainer = Trainer(model, cfg, "run", tcls.make_loss_fn(0.5),
                      device="cpu", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = (tps.splat_max, tps.slice_gather, tps.splat_max_bwd,
                tps.slice_bwd, tgc.grid_conv3d, tgc.grid_conv3d_dw)
    launches = [c.launches for c in counters]
    losses = [trainer.train_step(_batch(seed=s))["loss"] for s in range(3)]
    assert [c.launches for c in counters] == launches   # CPU: plain versions
    assert trainer.global_step == 3 and model.training
    assert all(torch.isfinite(x) for x in losses)
    assert trainer.optimizer.lrs == [0.7e-3]
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        if not n.endswith("key_bn.scale"):
            assert not torch.equal(p, before[n]), n
    # the key path through d_w is connected
    assert any(float(p.grad.abs().max()) > 0
               for n, p in model.named_parameters()
               if n.endswith("key_bn.bias"))

    m = trainer.eval_step(_batch(seed=9))
    assert not model.training and torch.isfinite(m["loss"])
    assert m["pred"].shape == (2,)

    class Loader(list):
        def set_epoch(self, epoch):
            self.epoch = epoch

    loader = Loader(_batch(seed=s) for s in range(4))
    trainer.fit(loader, val_loader=loader, max_steps=5,
                eval_hook=tcls.ClassEvalAccumulator(15))
    assert trainer.global_step == 5              # stopped inside the epoch
    trainer.fit(loader, val_loader=loader, num_epochs=1,
                eval_hook=tcls.ClassEvalAccumulator(15))
    assert trainer.global_step == 9
    val = trainer.validate(loader, tcls.ClassEvalAccumulator(15))
    assert {"loss", "cls_acc", "m_acc", "seg_acc"} <= set(val)
    assert 0.0 <= val["m_acc"] <= 1.0


def test_same_seed_same_weights_and_steps(tmp_path):
    cfg = {"experiment": {"root": str(tmp_path / "exp")},
           "train": {"optimizer": {"type": "Adam", "lr": 1e-3}}}
    losses = []
    for _ in range(2):
        trainer = Trainer(get_model("scanobject_classifier", **TINY), cfg,
                          "run", tcls.make_loss_fn(0.5), device="cpu",
                          seed=5)
        losses.append([float(trainer.train_step(_batch(seed=s))["loss"])
                       for s in range(2)])
    assert losses[0] == losses[1]                # dropout included
