"""Port parity: the whole ScanObjectNN classifier in eval mode.

A small classifier (B=2, P=128, one stage whose 3D head group is 16^3, so
the JAX model reaches pallas_grid_conv) runs in JAX and in the port with
the same weights, the port's converted from the JAX variables.  Outputs
pass the PARITY.md criteria (cosine > 0.999, median abs error <= 1e-3);
the per-block stats match to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cloud_transformers_tpu.models import get_model as jax_model
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    load_jax_variables,
)
from cloud_transformers_tpu_torch.models import get_model

TINY = dict(n_classes=15, model_dim=32, repeats=1,
            stage_plan=(((4, 4), (2, 2), (16, 16), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=8, class_dim=32, mask_dim=16)


def _jax_variables(model, pcd, seed=0):
    v = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.asarray(pcd), train=False))
    # non-trivial running statistics, from numpy
    rs = np.random.RandomState(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rs.uniform(0.5, 1.5, a.shape) if a is not None else a)
        .astype(np.float32), v["batch_stats"])
    return v


def _parity(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return cos, np.median(np.abs(a - b))


def test_classifier_matches_jax():
    pcd = np.random.RandomState(0).uniform(-1, 1, (2, 128, 3)).astype(
        np.float32)
    jm = jax_model("scanobject_classifier", **TINY)
    variables = _jax_variables(jm, pcd)
    j_cls, j_mask, j_stats = jm.apply(variables, jnp.asarray(pcd),
                                      train=False)

    tm = load_jax_variables(get_model("scanobject_classifier", **TINY),
                            variables).eval()
    with torch.no_grad():
        t_cls, t_mask, t_stats = tm(torch.from_numpy(pcd))

    assert t_cls.shape == (2, 15) and t_mask.shape == (2, 128, 1)
    for ref, got in ((j_cls, t_cls), (j_mask, t_mask)):
        cos, p50 = _parity(ref, got.numpy())
        assert cos > 0.999 and p50 <= 1e-3, (cos, p50)
    # 2 head-group stats per block + 2 pool stats
    assert len(t_stats) == len(j_stats) == 2 * 1 + 2
    for js, ts in zip(j_stats, t_stats):
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=1e-5, atol=1e-5)


def test_full_width_names_convert_strictly():
    """The full-width JAX parameter tree (4 scanned stages, Res trunks)
    maps one-to-one onto the port's modules, with matching shapes."""
    jm = jax_model("scanobject_classifier")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 3)), train=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    state = jax_to_state_dict(variables)
    tm = get_model("scanobject_classifier")
    expected = tm.state_dict()
    assert set(state) == set(expected)
    for k, v in expected.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    assert "backbone.trunk.stages.3.union_2.attention_1.conv.weight" in state
