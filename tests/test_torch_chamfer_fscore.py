"""Port parity: Chamfer distance and F-score against the JAX package.

The same numpy clouds go through both.  Nearest-neighbour indices are held
equal, distances within 1e-6, masks and gradients (to both clouds, through
the fixed indices) included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.losses import chamfer as jch
from cloud_transformers_tpu.losses import fscore as jfs
from cloud_transformers_tpu_torch.losses import chamfer as tch
from cloud_transformers_tpu_torch.losses import fscore as tfs


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _clouds(seed=0, b=2, n=300, m=257):
    rs = np.random.RandomState(seed)
    return (rs.rand(b, n, 3).astype(np.float32),
            rs.rand(b, m, 3).astype(np.float32))


@pytest.mark.parametrize("chunk", [64, 1024])
def test_chamfer_distance_matches_jax(chunk):
    x, y = _clouds()
    want = jch.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                                chunk_size=chunk)
    got = tch.chamfer_distance(_t(x), _t(y), chunk_size=chunk)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chamfer_masks_match_jax():
    x, y = _clouds(1)
    rs = np.random.RandomState(2)
    v1, v2 = rs.rand(2, 300) > 0.3, rs.rand(2, 257) > 0.3
    want = jch.chamfer_distance(jnp.asarray(x), jnp.asarray(y), 128,
                                valid1=jnp.asarray(v1), valid2=jnp.asarray(v2))
    got = tch.chamfer_distance(_t(x), _t(y), 128, valid1=_t(v1),
                               valid2=_t(v2))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # an invalid point is nobody's neighbour and has distance 0
    assert v2[np.arange(2)[:, None], got[2].numpy()].all()
    assert not got[0].numpy()[~v1].any()


@pytest.mark.parametrize("name", ["loss_chamfer", "loss_chamfer_adj"])
def test_chamfer_losses_and_gradients_match_jax(name):
    x, y = _clouds(3)
    jfn = getattr(jch, name)
    want, (gx, gy) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x).requires_grad_(), _t(y).requires_grad_()
    loss = getattr(tch, name)(tx, ty)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), atol=1e-6)


def test_chamfer_2d_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.rand(2, 50, 2).astype(np.float32)
    y = rs.rand(2, 60, 2).astype(np.float32)
    np.testing.assert_allclose(
        float(tch.loss_chamfer_2d(_t(x), _t(y))),
        float(jch.loss_chamfer_2d(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_f_score_matches_jax(masked):
    rs = np.random.RandomState(5)
    gt = rs.rand(2, 200, 3).astype(np.float32)
    pred = gt + 0.008 * rs.randn(2, 200, 3).astype(np.float32)
    pred[0, 100:] += 1.0
    kw_j, kw_t = {}, {}
    if masked:
        vp, vg = rs.rand(2, 200) > 0.2, rs.rand(2, 200) > 0.2
        vg[1] = False                      # a row without any valid point
        kw_j = dict(valid_pred=jnp.asarray(vp), valid_gt=jnp.asarray(vg))
        kw_t = dict(valid_pred=_t(vp), valid_gt=_t(vg))
    want = jfs.f_score(jnp.asarray(pred), jnp.asarray(gt), 0.01, **kw_j)
    got = tfs.f_score(_t(pred), _t(gt), 0.01, **kw_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    if not masked:
        assert 0 < float(got[1][0]) < 0.6      # half the cloud is far away
        f, _, _ = tfs.f_score(_t(gt), _t(gt) + 10.0)
        assert not f.any()
