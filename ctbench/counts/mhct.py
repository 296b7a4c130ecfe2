"""Operations and bytes of the MHCT trunk, from shapes.

Frozen from the program's chip check (``chip_smoke.py``: its ``bound()``
and the byte and operation counts of each kernel row), so that later
changes to the program do not move the yardstick.

Model FLOPs (``*_flops``): 2 x the multiply-adds of the linear layers, the
grid convolutions, the Res trunks' convolutions and the frames'
contractions, for the points that are valid (a padded point is not
counted).  A convolution counts only the (output cell, tap) pairs whose
input lies inside the grid: ``3 s - 2`` a side for a 3-tap kernel on a
side of ``s`` with zero padding, ``s`` for a 1-tap one.  The splat, the
slice, BatchNorm and the activations are not counted.

Kernel rows (``kernel_rows``): per launch of the hand-written kernels #1-#6
of a step, its group (``core/profile.KERNEL_GROUPS``), the bytes it must
move (each input byte read once, each output byte written once: the
mapping is 40 bytes a point, x0 and lane0 as int32 and 8 float32 vertex
weights) and its operations.  Grid rows that a point reads are not
counted, since their number depends on the keys: the bytes are a lower
bound, and with them the least time.
"""

# the published stage plan (the program's DEFAULT_STAGE_PLAN): per union,
# (features, heads, grid sizes, grid dims) of its 2D and 3D head groups
STAGE_PLAN = (
    ((4, 4), (16, 16), (128, 32), (2, 3)),
    ((16, 16), (16, 16), (64, 16), (2, 3)),
    ((16, 32), (16, 16), (16, 8), (2, 3)),
)
MAPPING_BYTES = 40          # a point's x0, lane0 and 8 vertex weights
KERNEL_CONV_MIN_SIDE = 16   # 3D grids from this side on go to kernel #3
# the profile's groups (core/profile.KERNEL_GROUPS) that time each row's
# kernel: the splat backward is a winner pass and a routing pass
DEVICE_GROUPS = {"splat_max": ("splat_max",),
                 "slice_gather": ("slice_gather",),
                 "grid_conv3d": ("grid_conv3d",),
                 "splat_max_bwd": ("splat_max_bwd", "splat_route"),
                 "slice_bwd": ("slice_bwd",),
                 "grid_conv3d_dw": ("grid_conv3d_dw",)}


def groups_of(model):
    """The trunk's head groups: [(features, heads, size, dims)], union by
    union."""
    out = []
    for _ in range(model.get("repeats", 4)):
        for feats, heads, sizes, dims in model.get("stage_plan", STAGE_PLAN):
            out += list(zip(feats, heads, sizes, dims))
    return out


def pairs(side, taps, dims):
    """In-bounds (output cell, tap) pairs of a 'same' conv on a cube."""
    per_side = side if taps == 1 else 3 * side - 2
    return per_side ** dims


def trunk_flops(model, points, clouds):
    """Forward FLOPs of the trunk (and of the ``after`` projections) for
    ``points`` valid points over ``clouds`` clouds."""
    d = model.get("model_dim", 512)
    flops = 0
    for f, h, s, dims in groups_of(model):
        flops += 2 * d * h * (f + 3) * points       # keys and values
        flops += 2 * 9 * h * points                 # the frame
        flops += 2 * clouds * h * pairs(s, 3, dims) * f * f   # grid conv
    for _ in range(model.get("repeats", 4)):
        for feats, heads, _, _ in model.get("stage_plan", STAGE_PLAN):
            flops += 2 * sum(f * h for f, h in zip(feats, heads)) * d * points
    return flops


def pool_flops(model, points, heads, feat):
    """Forward FLOPs of a splat-only pool's projection and frame."""
    d = model.get("model_dim", 512)
    return 2 * d * heads * (feat + 3) * points + 2 * 9 * heads * points


def conv_flops(cin, cout, groups, side, taps, dims, clouds):
    return 2 * clouds * cout * (cin // groups) * pairs(side, taps, dims)


def res_trunk_flops(channels, groups, side, dims, clouds):
    """Forward FLOPs of 3 Res blocks from ``channels[0]`` through
    ``channels[1:]``, halving the side between blocks."""
    flops = 0
    cin = channels[0]
    for i, cout in enumerate(channels[1:]):
        s = side >> i
        flops += conv_flops(cin, cout, groups, s, 3, dims, clouds)
        flops += conv_flops(cout, cout, groups, s, 3, dims, clouds)
        if cin != cout:
            flops += conv_flops(cin, cout, groups, s, 1, dims, clouds)
        cin = cout
    return flops


def kernel_rows(model, clouds, points, pools=()):
    """[(group, bytes, operations)] of a training step's forward and
    backward at launch shapes of ``clouds`` x ``points`` (padded
    points included: the kernels read them).  ``pools``: the splat-only
    heads (features, heads, size, dims)."""
    rows = []
    k = points
    for f, h, s, dims in groups_of(model) + list(pools):
        r, cells, v = clouds * h, s ** dims, 2 ** dims
        pooled = (f, h, s, dims) in pools
        rows.append(("splat_max", r * k * MAPPING_BYTES + r * k * f * 4
                     + r * cells * f * 4, r * k * v * f * 2))
        rows.append(("splat_max_bwd", r * k * MAPPING_BYTES
                     + r * k * f * 4 + r * k * f * 4 + r * k * 32,
                     r * k * v * f * 5))
        if pooled:
            continue
        rows.append(("slice_gather", r * k * MAPPING_BYTES + r * k * f * 4,
                     r * k * v * f * 2))
        rows.append(("slice_bwd", r * k * MAPPING_BYTES + r * k * f * 4
                     + r * cells * f * 4 + r * k * 32,
                     r * k * v * f * 4))
        if dims == 3 and s >= KERNEL_CONV_MIN_SIDE:
            w = h * f * f * 27
            fwd = (2 * r * cells * f * 4 + w * 4 + h * f * 4,
                   r * (pairs(s, 3, 3) * f * f * 2 + cells * f))
            rows.append(("grid_conv3d",) + fwd)
            rows.append(("grid_conv3d",) + fwd)          # the input gradient
            rows.append(("grid_conv3d_dw", 2 * r * cells * f * 4 + w * 4,
                         r * pairs(s, 3, 3) * f * f * 2))
    return rows


def least_seconds(rows, peak_flop_per_s, bytes_per_s):
    """{group: the least time of its launches}, each launch bounded by the
    larger of its bytes at ``bytes_per_s`` and its operations at
    ``peak_flop_per_s``."""
    out = {}
    for group, n_bytes, ops in rows:
        t = max(n_bytes / bytes_per_s, ops / peak_flop_per_s)
        out[group] = out.get(group, 0.0) + t
    return out
