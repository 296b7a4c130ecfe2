"""The port's KPConv-protocol S3DIS dataset against the JAX package's, on
the synthetic rooms at the protocol's sizes (8192 points, ``in_radius``
2.0, ``sampleDl`` 0.04).

The sub-clouds, the projections, the sphere schedule (cloud, point,
noise) and every item (points, mask, features, labels, ``cloud_index``,
``input_inds``) are equal, bit for bit, for the training split (with its
color drop and a rotate-scale-jitter transform) and the validation split,
over two epochs.  The port's balls come from ``scipy.spatial.cKDTree``
where the JAX package's come from sklearn's ``KDTree``: they differ only
where two points lie at exactly the same distance from a pick, and
``test_no_exact_distance_tie`` shows that no ball of these items has
such a tie.
"""

import numpy as np
import pytest
from sklearn.neighbors import KDTree

from cloud_transformers_tpu.data.s3dis_kpconv import S3DISSeg as JaxSeg
from cloud_transformers_tpu.tasks.segmentation_kpconv import (
    batch_rotate_scale_jitter as jax_jitter,
)
from cloud_transformers_tpu_torch.data import S3DISSeg
from cloud_transformers_tpu_torch.data.s3dis_kpconv import BallTree
from cloud_transformers_tpu_torch.tasks.segmentation_kpconv import (
    batch_rotate_scale_jitter,
)

STEPS = 6
KW = dict(num_steps=STEPS, num_epochs=3)


def _transform(jitter):
    rng = np.random.RandomState(0)
    return lambda points: jitter(points[None], rng)[0]


@pytest.fixture(scope="module", params=["train", "val"])
def pair(request):
    split = request.param
    if split == "train":
        return split, (JaxSeg(split=split, transforms=_transform(jax_jitter),
                              **KW),
                       S3DISSeg(split=split, transforms=_transform(
                           batch_rotate_scale_jitter), **KW))
    return split, (JaxSeg(split=split, **KW), S3DISSeg(split=split, **KW))


def test_clouds_and_projections_equal(pair):
    _, (jds, tds) = pair
    assert len(tds.sub_points) == len(jds.sub_points) == 2
    for name in ("clouds_points", "clouds_labels", "sub_points",
                 "sub_colors", "sub_labels", "projections"):
        for a, b in zip(getattr(tds, name), getattr(jds, name)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_items_equal_over_two_epochs(pair):
    split, (jds, tds) = pair
    valid = []
    for epoch in range(2):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(STEPS):
            a, b = jds[i], tds[i]
            assert set(a) == set(b)
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(
                    b[k], a[k], err_msg=f"{split} epoch {epoch} item {i} {k}")
            valid.append(float(b["mask"].mean()))
            assert b["points"].shape == (8192, 3)
            assert b["features"].shape == (8192, 4)
    for e_j, e_t in zip(jds._schedule, tds._schedule):
        assert e_j[:2] == e_t[:2]
        np.testing.assert_array_equal(e_j[2], e_t[2])
    # the protocol pads: items are ragged
    assert min(valid) < 0.9


def test_no_exact_distance_tie(pair):
    """No ball of the items above holds two points at exactly the same
    distance from its pick, so the order of a tie (stable here, not in
    sklearn) never decides an item."""
    _, (_, tds) = pair
    ties = points = 0
    for entry in tds._schedule[:2 * STEPS]:
        ci, pi, noise = entry
        pick = tds.sub_points[ci][pi][None] + noise
        q = tds.trees[ci].ball(pick, tds.in_radius)
        dx = tds.trees[ci].points[q] - pick.astype(np.float64)
        d = np.sqrt((dx * dx).sum(1))
        assert np.all(np.diff(d) >= 0)
        ties += d.size - np.unique(d).size
        points += d.size
    assert points > 10000 and ties == 0


def test_ball_keeps_the_boundary_and_orders_ties_by_index():
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 2],
                    [-1, 0, 0], [0.5, 0, 0]], np.float32)
    tree = BallTree(pts)
    # three points at exactly 1.0 (kept, in index order), one inside
    np.testing.assert_array_equal(tree.ball(np.zeros(3, np.float32), 1.0),
                                  [0, 5, 1, 2, 4])
    # sklearn keeps the same points (its order of the tie may differ)
    ind = KDTree(pts, leaf_size=50).query_radius(
        np.zeros((1, 3), np.float32), r=1.0, return_distance=True,
        sort_results=True)[0][0]
    assert sorted(ind) == [0, 1, 2, 4, 5] and list(ind[:2]) == [0, 5]
    np.testing.assert_array_equal(tree.nearest(pts[[3, 5]] + 0.01), [3, 5])
