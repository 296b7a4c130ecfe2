"""Port parity: instance norm, AdaIN and the AdaIN cloud transform blocks
against the JAX package, through ``convert.py``.

The same numpy inputs and the same weights (initialised by JAX, carried
over with ``jax_to_state_dict``).  The key ``scale`` starts at 0, which
would switch the key path off, so it is set to 0.1 on both sides.  Outputs
are held within 1e-5 of the output scale: the mapping is bit-identical on
both sides and the rest is float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.nn import multihead_adain as jma
from cloud_transformers_tpu.nn import norm as jnorm
from cloud_transformers_tpu_torch.convert import jax_to_state_dict
from cloud_transformers_tpu_torch.nn import multihead_adain as tma
from cloud_transformers_tpu_torch.nn import norm as tnorm

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _inputs(seed, b=2, p=96, c=24, latent=12):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, p, c).astype(np.float32),
            rs.randn(b, latent).astype(np.float32),
            rs.uniform(-1, 1, (b, p, 3)).astype(np.float32))


def _with_scale(params, value=0.1):
    def fix(path, a):
        if getattr(path[-1], "key", None) == "scale" and np.ndim(a) == 0:
            return np.float32(value)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _load(module, params):
    module.load_state_dict(jax_to_state_dict({"params": params}),
                           strict=True)
    return module


def test_instance_norm_matches_jax():
    x, _, _ = _inputs(0)
    got = tnorm.instance_norm_1d(_t(x))
    _close(got, jnorm.instance_norm_1d(jnp.asarray(x)))
    np.testing.assert_allclose(got.mean(1).numpy(), 0, atol=1e-6)


def test_adain_matches_jax():
    x, z, _ = _inputs(1)
    jmod = jnorm.AdaIn1d(24)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(z))["params"]
    tmod = _load(tnorm.AdaIn1d(12, 24), jax.device_get(params))
    assert sorted(tmod.state_dict()) == ["dense.bias", "dense.weight"]
    _close(tmod(_t(x), _t(z)),
           jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(z)))


@pytest.mark.parametrize("size,dim", [(8, 2), (8, 3), (16, 3)])
def test_multihead_adain_matches_jax(size, dim):
    """2D, 3D below the 3D conv kernel's width (X < 16) and at it."""
    x, z, pcd = _inputs(2)
    jmod = jma.MultiHeadAdaIn(in_feature_dim=4, tensor_size=size,
                              tensor_dim=dim, heads=2)
    args = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(pcd))
    params = _with_scale(jmod.init(jax.random.PRNGKey(0), *args,
                                   train=False)["params"])
    want, want_stats = jmod.apply({"params": params}, *args, train=False)
    tmod = _load(tma.MultiHeadAdaIn(24, 12, 4, size, dim, 2), params)
    assert float(tmod.scale.detach()) == np.float32(0.1)
    got, stats = tmod(_t(x), _t(z), _t(pcd))
    _close(got, want)
    for k in ("occupancy", "key_mean", "key_var"):
        np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                   rtol=1e-4, atol=1e-6)
    # with scale 0 the keys are the input geometry: another output
    with torch.no_grad():
        tmod.scale.zero_()
    assert not torch.allclose(tmod(_t(x), _t(z), _t(pcd))[0], got)


@pytest.mark.parametrize("dim_out", [None, 40])
def test_multihead_union_adain_matches_jax(dim_out):
    """Without and with the shortcut projection (``model_dim_out``)."""
    x, z, pcd = _inputs(3)
    kw = dict(features_dims=(4, 4), tensor_sizes=(8, 8), tensor_dims=(2, 3),
              heads=(2, 2))
    jmod = jma.MultiHeadUnionAdaIn(model_dim=24, model_dim_out=dim_out, **kw)
    args = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(pcd))
    params = _with_scale(jmod.init(jax.random.PRNGKey(0), *args,
                                   train=False)["params"])
    want, _ = jmod.apply({"params": params}, *args, train=False)
    tmod = _load(tma.MultiHeadUnionAdaIn(24, 12, model_dim_out=dim_out, **kw),
                 params)
    assert tmod.has_shortcut == (dim_out is not None)
    got, stats = tmod(_t(x), _t(z), _t(pcd))
    assert got.shape == (2, 96, dim_out or 24) and len(stats) == 2
    _close(got, want)


def test_union_adain_rejects_ragged_settings():
    with pytest.raises(ValueError):
        tma.MultiHeadUnionAdaIn(24, 12, (4,), (8, 8), (2, 3), (2, 2))
