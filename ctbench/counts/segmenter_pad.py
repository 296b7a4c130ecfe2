"""Operations and bytes of the S3DIS segmenter of the KPConv protocol
(``counts/mhct.py`` says what is counted)."""

from ctbench.counts import mhct


def forward_flops(model, valid_points):
    """Model FLOPs of a forward over spheres of ``valid_points`` valid
    points (a list, one count a sphere); padded points are not counted."""
    d = model.get("model_dim", 512)
    b, n = len(valid_points), sum(valid_points)
    cin = model.get("in_channels", 7)
    return (2 * cin * d * n + mhct.trunk_flops(model, n, b)
            + 2 * n * (d * d + d * model.get("n_classes", 13)))


def kernel_rows(model, clouds, points):
    return mhct.kernel_rows(model, clouds, points, ())
