"""The FLOP and byte counters against counts by hand at tiny sizes."""

from ctbench.counts import classifier, mhct, segmenter_pad

PLAN = [[[2, 2], [2, 2], [4, 16], [2, 3]]]


def test_segmenter_flops_by_hand_count_valid_points_only():
    model = dict(model_dim=8, in_channels=7, n_classes=3, repeats=1,
                 stage_plan=PLAN)
    # 2 spheres, 10 and 6 valid points (16), however many are padded
    n, b = 16, 2
    stem = 2 * 7 * 8 * n
    kv = 2 * 8 * 2 * (2 + 3) * n          # one head group's projection
    frame = 2 * 9 * 2 * n
    conv2d = 2 * b * 2 * (3 * 4 - 2) ** 2 * 2 * 2
    conv3d = 2 * b * 2 * (3 * 16 - 2) ** 3 * 2 * 2
    after = 2 * (2 * 2 + 2 * 2) * 8 * n
    head = 2 * n * (8 * 8 + 8 * 3)
    hand = stem + 2 * (kv + frame) + conv2d + conv3d + after + head
    assert segmenter_pad.forward_flops(model, [10, 6]) == hand


def test_classifier_flops_by_hand():
    model = dict(model_dim=8, n_classes=3, repeats=1, stage_plan=PLAN,
                 pool_heads=2, pool_feature_dims=(2, 2), pool_sizes=(4, 4),
                 trunk_width=2, class_dim=4, mask_dim=3)
    n, b = 10, 1
    trunk = (2 * (2 * 8 * 2 * 5 * n + 2 * 9 * 2 * n)
             + 2 * b * 2 * 10 ** 2 * 4 + 2 * b * 2 * 46 ** 3 * 4
             + 2 * 8 * 8 * n)
    pools = 2 * (2 * 8 * 2 * 5 * n + 2 * 9 * 2 * n)
    # Res3D 4 -> 4 -> 4 -> 4 channels in 2 groups on 4^3, 2^3, 1^3
    res3d = 2 * (2 * 4 * 2 * 10 ** 3) + 2 * (2 * 4 * 2 * 4 ** 3) \
        + 2 * (2 * 4 * 2 * 1)
    # Res2D 4 -> 2 -> 4 -> 4 channels on 4^2, 2^2, 1^2, 1x1 skips where
    # the width changes
    res2d = (2 * 2 * 2 * 10 ** 2 + 2 * 2 * 1 * 10 ** 2 + 2 * 2 * 2 * 4 ** 2
             + 2 * 4 * 1 * 4 ** 2 + 2 * 4 * 2 * 4 ** 2 + 2 * 4 * 1 * 2 ** 2
             + 2 * (2 * 4 * 2 * 1))
    heads = 2 * b * (2 * 2 * 2 * 4 + 4 * 3) + 2 * n * ((8 + 4) * 3 + 3)
    hand = 2 * 3 * 8 * n + trunk + pools + res3d + res2d + heads
    assert classifier.forward_flops(model, [n]) == hand


def test_kernel_rows_by_hand():
    model = dict(model_dim=8, repeats=1, stage_plan=PLAN)
    rows = segmenter_pad.kernel_rows(model, 2, 32)
    groups = [g for g, _, _ in rows]
    # per head group: splat, its backward, slice, its backward; the 16^3
    # group also the conv, the conv on the cotangent, the weight gradient
    assert groups.count("splat_max") == 2 and groups.count("slice_bwd") == 2
    assert groups.count("grid_conv3d") == 2 and \
        groups.count("grid_conv3d_dw") == 1
    r, k = 2 * 2, 32
    assert rows[0] == ("splat_max", r * k * 40 + r * k * 2 * 4
                       + r * 16 * 2 * 4, r * k * 4 * 2 * 2)
    conv = [row for row in rows if row[0] == "grid_conv3d"][0]
    assert conv == ("grid_conv3d",
                    2 * r * 4096 * 2 * 4 + 2 * 2 * 2 * 27 * 4 + 2 * 2 * 4,
                    r * (46 ** 3 * 2 * 2 * 2 + 4096 * 2))
    least = mhct.least_seconds(rows, 67e12, 3.35e12)
    assert least["splat_max"] == sum(
        max(b / 3.35e12, o / 67e12) for g, b, o in rows if g == "splat_max")
    assert len(rows) == 11
