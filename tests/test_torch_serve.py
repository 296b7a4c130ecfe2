"""The port's inference engine: bucketing, repeat-padding, per-point
trimming and ``classify``, against the port model called directly."""

import numpy as np
import torch

from cloud_transformers_tpu_torch.serve import InferenceEngine, _next_bucket

TINY = dict(n_classes=5, model_dim=16, repeats=1,
            stage_plan=(((4, 4), (2, 2), (8, 4), (2, 3)),),
            pool_heads=2, pool_feature_dims=(4, 4), pool_sizes=(4, 8),
            trunk_width=4, class_dim=16, mask_dim=8)


def _engine():
    return InferenceEngine.build(
        "scanobject_classifier", seed=0, device="cpu",
        batch_buckets=(2, 4), point_buckets=(64, 128), **TINY)


def test_bucketing():
    assert _next_bucket(3, (1, 4, 8)) == 4
    assert _next_bucket(9, (1, 4, 8)) == 8  # clamps at largest
    assert _next_bucket(1, (1, 4, 8)) == 1


def test_padding_repeats_points_and_last_cloud():
    rs = np.random.RandomState(0)
    clouds = [rs.randn(50, 3), rs.randn(100, 3), rs.randn(200, 3)]
    batch, n, b, p = _engine().pad_batch(clouds)
    assert (n, b, p) == (3, 4, 128)
    np.testing.assert_array_equal(batch[0, :50], clouds[0].astype(np.float32))
    np.testing.assert_array_equal(batch[0, 50:100], batch[0, :50])
    np.testing.assert_array_equal(batch[2], clouds[2][:128].astype(
        np.float32))                          # cut at the largest bucket
    np.testing.assert_array_equal(batch[3], batch[2])


def test_predict_trims_and_matches_direct_model():
    rs = np.random.RandomState(1)
    clouds = [rs.randn(50, 3), rs.randn(100, 3), rs.randn(64, 3)]
    engine = _engine()
    results = engine.predict(clouds)
    batch, n, b, p = engine.pad_batch(clouds)
    with torch.no_grad():
        cls, mask, _ = engine.model(torch.from_numpy(batch))
    assert len(results) == 3
    for i, (cloud, (cls_i, mask_i, stats_i)) in enumerate(
            zip(clouds, results)):
        assert cls_i.shape == (5,)
        assert mask_i.shape == (min(cloud.shape[0], p), 1)
        np.testing.assert_allclose(cls_i, cls[i].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(mask_i, mask[i, :mask_i.shape[0]].numpy(),
                                   rtol=0, atol=1e-6)
        assert all(np.ndim(v) == 0 for s in stats_i for v in s.values())


def test_classify_sums_to_one():
    rs = np.random.RandomState(2)
    engine = _engine()
    clouds = [rs.randn(40, 3), rs.randn(90, 3)]
    probs = engine.classify(clouds)
    assert probs.shape == (2, 5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    batch, *_ = engine.pad_batch(clouds)
    with torch.no_grad():
        cls, _, _ = engine.model(torch.from_numpy(batch))
    np.testing.assert_allclose(probs, torch.softmax(cls, -1)[:2].numpy(),
                               rtol=0, atol=1e-6)


def test_seeded_build_is_reproducible():
    a = _engine().model.state_dict()
    b = _engine().model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
