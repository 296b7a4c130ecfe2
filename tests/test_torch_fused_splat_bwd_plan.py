"""Launch arithmetic of the fused block's clusters and of the splat
backward's two passes, on the CPU.

The kernels themselves run only on a CUDA card
(``tests/test_torch_kernels_gpu.py``); what decides which CTA owns which
planes and which thread does which work is Python (``fused_block_plan``,
``splat_bwd_plan``), mirrored here in numpy from the kernels' index
arithmetic in ``csrc/fused_block.cu`` (``fused_cluster_kernel``) and
``csrc/splat_slice.cu`` (``splat_winner_kernel``, ``splat_route_kernel``).
No JAX.
"""

import ctypes
import gc

import numpy as np
import pytest

from cloud_transformers_tpu_torch.ops import pallas_fused_block as tfb
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# every head group of the classifier and of the completion model
MODEL_SHAPES = [((128, 128), 4), ((32, 32, 32), 4), ((64, 64), 16),
                ((16, 16, 16), 16), ((16, 16), 16), ((8, 8, 8), 32)]
# (rows, points a row): the classifier's B = 8 x 16 heads x 2048 points,
# the completion decoder's B = 2 x 16 heads x 16384, the S3DIS segmenter's
# B = 8 x 16 heads x 4096, the reconstructor decoder's B = 4 x 16 heads x
# 8192, the KPConv-protocol segmenter's B = 6 x 16 heads x 8192
MODEL_ROWS = [(128, 2048), (32, 16384), (128, 4096), (64, 8192),
              (96, 8192)]
RAGGED = [(16, 16), (9, 7), (8, 8, 8), (5, 6, 7), (2, 3), (33, 5, 4)]


def _slabs(plan, x):
    """(first plane, planes) of each CTA of a row's cluster."""
    starts = np.arange(plan.cluster) * plan.slab
    return [(int(s), int(min(plan.slab, x - s))) for s in starts]


def _check_cluster(plan, sizes, feat):
    """Every x plane owned by one CTA, each CTA at least one plane; the
    halo planes 0 and sx + 1 of CTA c are the planes just outside its slab,
    read from the CTA that owns them at the local plane the kernel reads
    (SX of the lower neighbour, 1 of the upper), zeros at the grid's edges;
    every channel in exactly one quad; the conv's items cover every (cell,
    fo) of the slab once and read inside the padded slab."""
    dim = len(sizes)
    x, y, z = (tuple(sizes) + (1,))[:3]
    assert 1 <= plan.cluster <= tfb.MAX_CLUSTER
    owner = np.full(x, -1)
    for c, (start, n) in enumerate(_slabs(plan, x)):
        assert n >= 1
        assert (owner[start:start + n] == -1).all()
        owner[start:start + n] = c
        # the kernel's owner(): rank = x / SX, padded plane x - rank*SX + 1
        for gx in range(start, start + n):
            assert gx // plan.slab == c and gx - c * plan.slab + 1 >= 1
        for side, gx in ((0, start - 1), (1, start + n)):
            if not 0 <= gx < x:
                continue             # stays zero: 'same' padding
            src = gx // plan.slab
            assert src == c + (1 if side else -1)
            local = gx - src * plan.slab + 1
            assert local == (plan.slab if side == 0 else 1)
    assert (owner >= 0).all()
    fp = plan.fp
    assert fp % 4 == 0 and feat <= fp < feat + 4
    quads = np.zeros(fp, np.int64)
    for q in range(fp // 4):
        quads[4 * q:4 * q + 4] += 1
    assert (quads == 1).all()
    px, py, pz = plan.padded
    fo = 8 if fp % 8 == 0 else 4
    for _, sx in _slabs(plan, x)[-2:]:
        runs = -(-y // tfb.RUN) if dim == 3 else -(-sx // tfb.RUN)
        fast = z if dim == 3 else y
        t = np.arange((fp // fo) * (sx if dim == 3 else 1) * runs * fast)
        f_ax = t % fast
        run = (t // fast) % runs
        lx = (t // (fast * runs)) % sx if dim == 3 else 0 * t
        fo0 = (t // (fast * runs * (sx if dim == 3 else 1))) * fo
        count = np.zeros((sx, y, z, fp), np.int64)
        for j in range(tfb.RUN):
            along = run * tfb.RUN + j
            live = along < (y if dim == 3 else sx)
            for o in range(fo):
                if dim == 3:
                    np.add.at(count, (lx[live], along[live], f_ax[live],
                                      fo0[live] + o), 1)
                else:
                    np.add.at(count, (along[live], f_ax[live], 0,
                                      fo0[live] + o), 1)
        assert (count == 1).all()
        # the farthest reads: run * RUN + RUN + 1 on the run axis, +2 on
        # the others
        if dim == 3:
            assert int(lx.max()) + 2 < px
            assert int(run.max()) * tfb.RUN + tfb.RUN + 1 < py
            assert int(f_ax.max()) + 2 < pz
        else:
            assert int(run.max()) * tfb.RUN + tfb.RUN + 1 < px
            assert int(f_ax.max()) + 2 < py
    taps = 27 if dim == 3 else 9
    words = (taps * fp * fp + px * py * pz * fp + plan.slab * y * z * fp
             + tfb.SCAN * plan.threads)
    assert plan.smem == 4 * words <= tfb.SMEM_LIMIT


def _each_point(plan, x0, x_lo, x_hi, group):
    """The kernel's ``each_point``: (point, lane in its group) for every
    lane that takes a point with x0 in [x_lo, x_hi).  Warp w scans SCAN *
    32 points from w * SCAN * 32, then SCAN * 32 * warps further on, keeps
    its points in order in its slots, and its lane groups g take the slots
    g, g + 32 / group, ..."""
    k = len(x0)
    warps = plan.threads // 32
    chunk = tfb.SCAN * 32
    taken = []
    for w in range(warps):
        for base in range(w * chunk, k, warps * chunk):
            mine = [p for p in range(base, min(k, base + chunk))
                    if x_lo <= x0[p] < x_hi]
            assert len(mine) <= chunk     # the warp's slots
            for lane in range(32):
                taken += [(p, lane % group)
                          for p in mine[lane // group::32 // group]]
    return taken


def _cluster_point_cover(plan, x0, x):
    """How often a row's cluster splats each (point, vertex row) and
    slices each (point, feature quad): CTA c splats the rows of the points
    with x0 in [xs - 1, xs + sx) that lie in its slab, a point on one lane
    that takes all its quads, and slices the points with x0 in [xs, xs +
    sx), lane ``sub`` of a point's group taking the quads sub, sub +
    group, ..."""
    splat = np.zeros((len(x0), 2), np.int64)
    slice_ = np.zeros((len(x0), plan.fp // 4), np.int64)
    for start, sx in _slabs(plan, x):
        for p, _ in _each_point(plan, x0, start - 1, start + sx, 1):
            for side in (0, 1):
                if start <= x0[p] + side < start + sx:
                    splat[p, side] += 1
        for p, sub in _each_point(plan, x0, start, start + sx, plan.group):
            slice_[p, sub::plan.group] += 1
    return splat, slice_


def _covered_once(plan, points, x):
    x0 = np.random.RandomState(points).randint(0, x - 1, points)
    splat, slice_ = _cluster_point_cover(plan, x0, x)
    return (splat == 1).all() and (slice_ == 1).all()


@pytest.mark.parametrize("sizes,feat", MODEL_SHAPES)
@pytest.mark.parametrize("rows,points", MODEL_ROWS)
def test_fused_plan_at_the_model_shapes(sizes, feat, rows, points):
    """The cluster path, a launch that fills the card, and every (point,
    vertex row) taken once by the splat and every (point, quad) once by the
    slice (on the first 4096 points of a row)."""
    plan = tfb.fused_block_plan(rows, points, feat, sizes)
    assert plan.path == "cluster"
    assert plan.blocks == rows * plan.cluster >= tfb.FILL_CTAS
    assert plan.threads in (tfb.CLUSTER_THREADS, tfb.CLUSTER_THREADS // 2)
    if plan.threads < tfb.CLUSTER_THREADS:
        # half the threads only where two CTAs fit an SM and each thread
        # still has a conv item
        assert 2 * (plan.smem + tfb.CTA_RESERVE) <= tfb.SM_SMEM
        assert tfb.conv_items(sizes, feat, plan.cluster) >= plan.threads
        assert plan.cluster <= tfb.PORTABLE_CLUSTER
    _check_cluster(plan, sizes, feat)
    assert _covered_once(plan, min(points, 4096), sizes[0])


@pytest.mark.parametrize("sizes", [s for s, _ in MODEL_SHAPES])
@pytest.mark.parametrize("rows,points", MODEL_ROWS)
def test_fused_plan_fits_at_every_feature_width(sizes, rows, points):
    """F = 1 to 32: shared memory within 227 KB and clusters of at most 16
    CTAs on either path; the device-memory path only where no cluster
    fits, at the widths the kernel's comment names."""
    device_memory = {(128, 128): 21, (32, 32, 32): 9, (16, 16, 16): 29}
    for feat in range(1, 33):
        plan = tfb.fused_block_plan(rows, points, feat, sizes)
        assert plan.smem <= tfb.SMEM_LIMIT and plan.cluster <= 16
        if plan.path == "cluster":
            _check_cluster(plan, sizes, feat)
        else:
            assert plan.cluster == 0 and plan.blocks == rows
            assert plan.smem == tfb.global_smem(sizes, feat)
            for c in (1, 2, 4, 8, 16):
                shape = tfb.cluster_shape(sizes, feat, c)
                assert shape is None or shape[3] > tfb.SMEM_LIMIT
        assert (plan.path == "device_memory") == (
            feat >= device_memory.get(tuple(sizes), 33)), feat


@pytest.mark.parametrize("sizes", RAGGED)
@pytest.mark.parametrize("rows,points", [(1, 1), (6, 333), (40, 77)])
def test_fused_plan_at_ragged_shapes(sizes, rows, points):
    for feat in (1, 3, 4, 5, 16, 21, 32):
        plan = tfb.fused_block_plan(rows, points, feat, sizes)
        assert plan.path == "cluster"
        _check_cluster(plan, sizes, feat)
        assert _covered_once(plan, points, sizes[0])
        # a small launch takes the largest cluster that fits
        if rows * plan.cluster < tfb.FILL_CTAS and plan.cluster < 16:
            nxt = tfb.cluster_shape(sizes, feat, 2 * plan.cluster)
            assert 2 * plan.cluster > sizes[0] or nxt is None \
                or nxt[3] > tfb.SMEM_LIMIT


def _bwd_cover(plan, n, quads):
    """How often the splat backward's passes take each (point, quad):
    block x, thread t, point slot i, quads q = sub, sub + group, ..."""
    groups = plan.threads // plan.group
    x = np.arange(plan.blocks)[:, None, None]
    t = np.arange(plan.threads)[None, :, None]
    i = np.arange(plan.points_per_thread)[None, None, :]
    p = x * plan.points_per_block + i * groups + t // plan.group
    sub = np.broadcast_to(t % plan.group, p.shape)
    count = np.zeros((n, quads), np.int64)
    for q0 in range(plan.group):
        live = (p < n) & (sub == q0)
        for q in range(q0, quads, plan.group):
            np.add.at(count[:, q], p[live], 1)
    return count


def _winner_cover(plan, n, feat):
    """How often the winner pass takes each (point, feature): block x,
    thread t, the point x * (threads / winner_group) + t // winner_group,
    features f = t % winner_group, f + winner_group, ... (feature-major)
    or the quads of those (quad-major, as the routing pass)."""
    group = plan.winner_group
    width = 1 if plan.winner_features else 4
    t = np.arange(plan.threads)
    count = np.zeros((n, -(-feat // width) * width), np.int64)
    for x in range(plan.winner_blocks):
        p = x * (plan.threads // group) + t // group
        for f0 in range(group):
            live = (p < n) & (t % group == f0)
            for f in range(f0, -(-feat // width), group):
                for e in range(width):
                    np.add.at(count[:, f * width + e], p[live], 1)
    return count[:, :feat]


@pytest.mark.parametrize("sizes", [(16, 16), (8, 8, 8), (5, 6, 7)])
@pytest.mark.parametrize("points", [1, 37, 300])
def test_splat_bwd_plan_covers_every_point_and_quad_once(sizes, points):
    rows = 3
    for feat in range(1, 33):
        plan = tps.splat_bwd_plan(rows, points, feat, sizes)
        assert plan.threads == tps.BWD_THREADS
        assert plan.points_per_thread == 1
        assert plan.group in (1, 2, 4, 8) and plan.group >= min(8, plan.quads)
        assert plan.vec == (feat % 4 == 0)
        assert (_bwd_cover(plan, rows * points, plan.quads) == 1).all()
        assert plan.winner_features == (
            points * 2 ** len(sizes) < tps.WINNER_DENSE * np.prod(sizes))
        assert (_winner_cover(plan, rows * points, feat) == 1).all()


@pytest.mark.parametrize("sizes,feat", MODEL_SHAPES)
@pytest.mark.parametrize("rows,points", MODEL_ROWS)
def test_splat_bwd_plan_at_the_model_shapes(sizes, feat, rows, points):
    """float4 rows at every head group, one point a lane group, a feature
    a lane in the winner pass on the sparse grids (128^2, 32^3, 64^2 and
    16^3 of the classifier and of the segmenter; 128^2 and 32^3 of the
    decoder), and launches that fill the card."""
    plan = tps.splat_bwd_plan(rows, points, feat, sizes)
    assert plan.vec and plan.points_per_thread == 1
    sparse = points * 2 ** len(sizes) < 16 * np.prod(sizes)
    assert plan.winner_features == sparse
    assert plan.winner_group == (feat if sparse else plan.group)
    assert plan.winner_blocks * plan.threads >= rows * points * (
        1 if sparse else plan.group)
    assert plan.blocks * plan.threads >= tps.SLICE_FILL_THREADS
    n = rows * points
    assert (plan.blocks - 1) * plan.points_per_block < n \
        <= plan.blocks * plan.points_per_block


def test_winner_pass_covers_the_segmenters_128_squared_rows():
    """At the segmenter's rows (R = 128, K = 4096) the winner splat leaves
    the winners at 128^2 x 4 to the winner pass (its block lists a chunk
    in two scans); that pass takes every (point, feature) of the 128 rows
    once, a feature a lane."""
    rows, points, feat, sizes = 128, 4096, 4, (128, 128)
    assert not tps.winners_in_splat(tps.splat_plan(rows, points, feat,
                                                   sizes))
    plan = tps.splat_bwd_plan(rows, points, feat, sizes)
    assert plan.winner_features and plan.winner_group == feat
    assert (_winner_cover(plan, rows * points, feat) == 1).all()


def test_plans_refuse_the_index_limit():
    limit = tps.INDEX_LIMIT
    for plan in (tps.splat_bwd_plan, tfb.fused_block_plan):
        # the points: R * K * F
        with pytest.raises(ValueError):
            plan(1, limit // 4, 4, (2, 2))
        # the grid: R * G * F (R = 2**15 rows of 2**12 cells)
        with pytest.raises(ValueError):
            plan(2 ** 15, 1, 16, (64, 64))
        plan(2 ** 15 - 1, 1, 16, (64, 64))
    tps.splat_bwd_plan(1, limit // 4 - 1, 4, (2, 2))
    with pytest.raises(ValueError):
        tfb.fused_block_plan(4, 10, 33, (8, 8))     # F above 32


def test_plans_and_their_integer_arrays_are_cached_and_kept():
    sizes = (16, 16, 16)
    assert tfb.fused_block_plan(128, 2048, 16, sizes) is \
        tfb.fused_block_plan(128, 2048, 16, list(sizes))
    assert tps.splat_bwd_plan(128, 2048, 16, sizes) is \
        tps.splat_bwd_plan(128, 2048, 16, list(sizes))
    fused = tfb._fused_params(128, 16, 2048, 16, sizes, True)
    bwd = tps._splat_bwd_params(128, 2048, 16, sizes)
    gc.collect()
    for (arr, addr), want in (
            (fused, tfb._fused_params(128, 16, 2048, 16, sizes, True)),
            (bwd, tps._splat_bwd_params(128, 2048, 16, sizes))):
        assert want[0] is arr and want[1] == addr == ctypes.addressof(arr)
    plan = tfb.fused_block_plan(128, 2048, 16, sizes)
    assert list(fused[0]) == [
        128, 16, 2048, 16, 16, 16, 16, 3, 1, plan.cluster, plan.slab,
        plan.threads, plan.smem, plan.blocks, plan.group]
    assert len(fused[0]) == len(tfb.FUSED_PARAMS)
    # the integers read back from the address the entry point takes
    seen = (ctypes.c_int * len(fused[0])).from_address(fused[1])
    assert list(seen) == list(fused[0])
    # serving and a gradient step differ only in want_gk2
    other = tfb._fused_params(128, 16, 2048, 16, sizes, False)[0]
    assert list(other)[:8] == list(fused[0])[:8] and other[8] == 0
    plan = tps.splat_bwd_plan(128, 2048, 16, sizes)
    assert list(bwd[0]) == [128, *tps._launch_args(sizes, 2048, 16),
                            plan.group, plan.points_per_thread, plan.threads,
                            plan.blocks, int(plan.vec), plan.winner_group,
                            plan.winner_blocks, int(plan.winner_features)]
    assert len(bwd[0]) == len(tps.BWD_PARAMS)
