"""Operations and bytes of the ScanObjectNN classifier (``counts/mhct.py``
says what is counted)."""

from ctbench.counts import mhct


def _pools(model):
    h = model.get("pool_heads", 16)
    f3, f2 = model.get("pool_feature_dims", (32, 16))
    s3, s2 = model.get("pool_sizes", (8, 16))
    return ((f3, h, s3, 3), (f2, h, s2, 2))


def forward_flops(model, valid_points):
    """Model FLOPs of a forward over clouds of ``valid_points`` (a list of
    counts, one a cloud)."""
    d = model.get("model_dim", 512)
    h = model.get("pool_heads", 16)
    w = model.get("trunk_width", 64)
    cdim, mdim = model.get("class_dim", 1024), model.get("mask_dim", 256)
    n_cls = model.get("n_classes", 15)
    b, n = len(valid_points), sum(valid_points)
    flops = 2 * 3 * d * n + mhct.trunk_flops(model, n, b)
    (f3, _, s3, _), (f2, _, s2, _) = _pools(model)
    flops += mhct.pool_flops(model, n, h, f3) + mhct.pool_flops(model, n, h,
                                                                 f2)
    flops += mhct.res_trunk_flops((f3 * h, w * h, w * h, w * h), h, s3, 3, b)
    flops += mhct.res_trunk_flops((f2 * h, (w // 2) * h, w * h, w * h), h,
                                  s2, 2, b)
    flops += 2 * b * (2 * w * h * cdim + cdim * n_cls)
    flops += 2 * n * ((d + cdim) * mdim + mdim)
    return flops


def kernel_rows(model, clouds, points):
    return mhct.kernel_rows(model, clouds, points, _pools(model))
