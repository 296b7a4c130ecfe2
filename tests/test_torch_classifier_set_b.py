"""Port parity: the tiny classifier under set B of the execution switches,
``set_block_fusion("fused")``, on both sides.

The JAX package then runs every head group's splat -> conv -> slice as one
``pallas_fused_block`` (interpret mode on the CPU) with its composed
backward, and the port its fused block's plain version with the backward of
``core/splat_slice._FusedBlock``.  The classifier of
``tests/test_torch_train_step.py`` (B=2, P=128, one block with a 16^2 and a
16^3 head group) serves a forward in eval mode and takes one training
step: outputs and every gradient leaf by the PARITY.md criteria (cosine >
0.999, median error <= 1e-3 of the scale), the loss and the statistics
within 1e-5.  The port's calls show which paths ran.  The helpers here
serve ``tests/test_torch_classifier_set_a.py`` too.
"""

from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_transformers_tpu.nn.grouped_conv as jgc
from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu.tasks import classification as jcls
from cloud_transformers_tpu_torch.convert import (
    load_jax_variables,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.models import get_model
from cloud_transformers_tpu_torch.nn import grouped_conv as tgcm
from cloud_transformers_tpu_torch.tasks import classification as tcls
from test_torch_train_step import TINY, _batch, _jax_variables, _leaves

# (module, function, position of ``sizes`` or None) of the port's ops
_COUNTED = [(tss, n, None) for n in (
    "splat_max", "splat_max_winner", "splat_route", "splat_max_bwd",
    "slice_gather", "slice_bwd")] + [
    (tss, "fused_block", 7), (tss, "grid_conv_vjp", 3),
    (tgcm, "grid_conv", 3), (tgcm, "grid_conv_vjp", 3)]


def count_calls(monkeypatch):
    """{name: calls} of the ops the port's autograd Functions call, filled
    as they run; convs and fused blocks are counted by grid dimension."""
    calls = {}

    def counted(fn, name, at):
        def wrapper(*a, **kw):
            key = name if at is None else f"{name} {len(a[at])}D"
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return wrapper
    for mod, name, at in _COUNTED:
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), name, at))
    return calls


def _parity(got, ref):
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(ref, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return cos, np.median(np.abs(a - b)) / max(np.abs(b).max(), 1e-30)


def jax_classifier():
    """The tiny JAX classifier and its variables (``model.init`` runs a
    forward, which compiles the interpret-mode kernels of the switches in
    force: make it once per file)."""
    jm = jax_model("scanobject_classifier", **TINY)
    return jm, _jax_variables(jm, _batch()["pcd"])


def check_serving_forward(jm, variables):
    """Eval-mode logits, mask and per-block stats of the JAX classifier and
    the port's, under the switches in force."""
    pcd = _batch()["pcd"]
    j_cls, j_mask, j_stats = jm.apply(variables, jnp.asarray(pcd),
                                      train=False)
    tm = load_jax_variables(get_model("scanobject_classifier", **TINY),
                            variables).eval()
    with torch.no_grad():
        t_cls, t_mask, t_stats = tm(torch.from_numpy(pcd))
    for ref, got in ((j_cls, t_cls), (j_mask, t_mask)):
        cos, p50 = _parity(got.numpy(), ref)
        assert cos > 0.999 and p50 <= 1e-3, (cos, p50)
    assert len(t_stats) == len(j_stats) == 4
    for js, ts in zip(j_stats, t_stats):
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-5, atol=1e-5)


def check_training_step(jm, variables):
    """One train-mode loss + gradient of the JAX classifier and the port's
    (dropout off on both sides), under the switches in force."""
    batch = _batch()

    def compute(params):
        loss, aux, new_stats = jcls.make_loss_fn(0.5)(
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
    np.testing.assert_allclose(float(t_aux["occupancy_mean"]),
                               float(j_aux["occupancy_mean"]), rtol=1e-5)
    j_leaves = dict(_leaves(j_grads))
    t_leaves = dict(_leaves(port_to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"])))
    assert set(j_leaves) == set(t_leaves)
    # a bias that feeds a BatchNorm has no gradient: rounding noise on both
    # sides, held to a floor (see tests/test_torch_train_step.py)
    floor = 1e-6 * max(np.abs(ref).max() for ref in j_leaves.values())
    compared = 0
    for name, ref in j_leaves.items():
        got = t_leaves[name]
        if np.abs(ref).max() <= floor:
            assert name.endswith("/bias") and np.abs(got).max() <= floor, name
            continue
        cos, p50 = _parity(got, ref)
        assert cos > 0.999 and p50 <= 1e-3, (name, cos, p50)
        compared += 1
    assert compared >= len(j_leaves) - 6
    for name, ref in _leaves(j_stats):
        np.testing.assert_allclose(
            dict(_leaves(port_to_jax_tree(dict(tm.named_buffers()),
                                          variables["batch_stats"])))[name],
            ref, rtol=0, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def set_b():
    """Set B on both sides for this file's tests -> the JAX classifier.
    The JAX jit caches are cleared around it, since the switch is read
    when a function is traced."""
    jgc.set_block_fusion("fused")
    tgcm.set_block_fusion("fused")
    jax.clear_caches()
    try:
        yield jax_classifier()
    finally:
        jgc.set_block_fusion(None)
        tgcm.set_block_fusion(None)
        jax.clear_caches()


@pytest.fixture
def calls(set_b, monkeypatch):
    return count_calls(monkeypatch)


def test_serving_forward_matches_jax(set_b, calls):
    check_serving_forward(*set_b)
    # one fused block per head group, the two pools' splats, no gk2
    assert calls == {"fused_block 2D": 1, "fused_block 3D": 1,
                     "splat_max": 2}


def test_training_step_matches_jax(set_b, calls):
    check_training_step(*set_b)
    # the fused blocks' backward: slice backward, the conv's backward
    # kernels, the two-pass splat backward (as the pools')
    assert calls == {"fused_block 2D": 1, "fused_block 3D": 1,
                     "splat_max": 2, "splat_max_bwd": 4, "slice_bwd": 2,
                     "grid_conv_vjp 2D": 1, "grid_conv_vjp 3D": 1}
