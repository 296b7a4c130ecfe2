"""Launch arithmetic of the slice kernel and of the bid search, and the bid
search's order-free merge, on the CPU.

The kernels themselves run only on a CUDA card
(``tests/test_torch_kernels_gpu.py``); what decides which thread does
which work is Python (``slice_plan``, ``top2_plan``), mirrored here in
numpy from the kernels' index arithmetic in ``csrc/splat_slice.cu``
(``slice_kernel``) and ``csrc/emd.cu`` (``top2_kernel``).  No JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.models.inpainter import DEFAULT_STAGE_PLAN
from cloud_transformers_tpu_torch.ops import pallas_emd as tpe
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# the widths of the staged bid schedule at N = 16384 (losses/emd.py)
STAGED_WIDTHS = (16384, 2048, 1024, 512, 256)
# the reconstructor's auction: B = 4 clouds of N = 8192, whose staged
# widths are N, N/8, N/16, N/32 (N/64 is below 256)
RECONSTRUCTOR_SHAPES = [(4, w, 8192) for w in (8192, 1024, 512, 256)]


def _slice_cover(plan, n, feat):
    """How often the kernel's threads write each (point, feature) under
    ``plan``: block x, thread t, point slot i, feature quad q."""
    group, per = plan.group, plan.points_per_thread
    groups = plan.threads // group
    x = np.arange(plan.blocks)[:, None, None]
    t = np.arange(plan.threads)[None, :, None]
    i = np.arange(per)[None, None, :]
    p = x * plan.points_per_block + i * groups + t // group
    sub = np.broadcast_to(t % group, p.shape)
    count = np.zeros((n, feat), np.int64)
    for q0 in range(plan.group):
        live = (p < n) & (sub == q0)
        for q in range(q0, plan.quads, group):
            for f in range(4 * q, min(4 * q + 4, feat)):
                np.add.at(count[:, f], p[live], 1)
    return count


@pytest.mark.parametrize("sizes", [(16, 16), (8, 8, 8)])
@pytest.mark.parametrize("points", [1, 37, 300])
def test_slice_plan_reaches_every_point_and_feature_once(sizes, points):
    rows = 3
    for feat in range(1, 33):
        plan = tps.slice_plan(rows, points, feat, sizes)
        assert plan.points_per_block == (
            plan.points_per_thread * plan.threads // plan.group)
        assert plan.group in (1, 2, 4, 8)
        assert plan.group >= min(8, plan.quads)
        assert plan.vec == (feat % 4 == 0)
        count = _slice_cover(plan, rows * points, feat)
        assert (count == 1).all(), (sizes, points, feat)


def test_slice_plan_at_the_model_shapes():
    """At the classifier's launches (R = 128, K = 2048), the S3DIS
    segmenter's (K = 4096) and the reconstructor decoder's (R = 64,
    K = 8192) a thread takes 2 to 4 points and the launch fills the card,
    every (point, feature) of the segmenter's and the reconstructor's rows
    reached once; every head group of the completion model (and so of the
    classifier) reads float4 rows."""
    for sizes, feat in [((128, 128), 4), ((32, 32, 32), 4), ((64, 64), 16),
                        ((16, 16, 16), 16), ((16, 16), 16), ((8, 8, 8), 32)]:
        for rows, points in ((128, 2048), (128, 4096), (64, 8192)):
            plan = tps.slice_plan(rows, points, feat, sizes)
            assert plan.vec and 2 <= plan.points_per_thread <= 4
            assert plan.blocks * plan.threads >= tps.SLICE_FILL_THREADS
            if points > 2048:
                assert (_slice_cover(plan, rows * points, feat) == 1).all()
    for feats, _, sizes, dims in DEFAULT_STAGE_PLAN:
        for feat, size, dim in zip(feats, sizes, dims):
            assert tps.slice_plan(16, 2048, feat, (size,) * dim).vec


def test_slice_plan_refuses_the_index_limit():
    limit = tps.INDEX_LIMIT
    # the output: R * K * F
    with pytest.raises(ValueError):
        tps.slice_plan(1, limit // 4, 4, (2, 2))
    tps.slice_plan(1, limit // 4 - 1, 4, (2, 2))
    # the grid: R * G * F (R = 2**15 rows of 2**12 cells)
    with pytest.raises(ValueError):
        tps.slice_plan(2 ** 15, 1, 16, (64, 64))
    tps.slice_plan(2 ** 15 - 1, 1, 16, (64, 64))
    # the wrapper asks the plan before anything reaches the card
    with pytest.raises(ValueError):
        tps.slice_plan(2 ** 14, 1, 32, (64, 64))


def _top2_cover(plan, b, w, m):
    """Pairs each (row, bidder, target) gets from the kernel's blocks
    (bidder block x, chunk c, row) under ``plan``."""
    groups = plan.threads // plan.group
    per_group = plan.bidders_per_block // groups
    g = np.arange(groups)[:, None]
    q = np.arange(per_group)[None, :]
    count = np.zeros((b, w, m), np.int64)
    for x in range(plan.bidder_blocks):
        j = ((x * groups + g) * per_group + q).ravel()
        j = j[j < w]
        for c in range(plan.chunks):
            k0 = c * plan.chunk_len
            k1 = min(m, k0 + plan.chunk_len)
            count[:, j, k0:k1] += 1
    return count


@pytest.mark.parametrize("b,w,m", [(1, 1, 1), (2, 777, 3001), (1, 513, 65),
                                   (2, 1030, 1), (1, 256, 16384),
                                   (2, 512, 4099)])
def test_top2_plan_covers_every_pair_once(b, w, m):
    plan = tpe.top2_plan(b, w, m)
    assert plan.blocks == b * plan.bidder_blocks * plan.chunks
    assert plan.group in (8, 16, 32)
    assert plan.bidders_per_block == (plan.threads // plan.group
                                      * tpe.TOP2_BIDDERS)
    assert plan.merge == (plan.chunks > 1)
    assert (_top2_cover(plan, b, w, m) == 1).all()


@pytest.mark.parametrize("b", [2, 1])
@pytest.mark.parametrize("w", STAGED_WIDTHS)
def test_top2_plan_fills_the_card_at_every_staged_width(b, w):
    m = 16384
    plan = tpe.top2_plan(b, w, m)
    assert plan.blocks >= tpe.SMS
    assert plan.chunk_len >= tpe.TOP2_MIN_CHUNK
    # chunks are disjoint and in order, none empty, the last one ragged
    assert (plan.chunks - 1) * plan.chunk_len < m \
        <= plan.chunks * plan.chunk_len
    per_bidder = np.zeros(m, np.int64)
    for c in range(plan.chunks):
        per_bidder[c * plan.chunk_len:(c + 1) * plan.chunk_len] += 1
    assert (per_bidder == 1).all()
    partial = 3 * plan.chunks * b * w if plan.merge else 0
    assert plan.scratch_floats == partial


@pytest.mark.parametrize("b,w,m", RECONSTRUCTOR_SHAPES)
def test_top2_plan_at_the_reconstructors_widths(b, w, m):
    """The bid search at the reconstructor's shapes fills the card and
    takes every (row, bidder, target) once.  The blocks' pairs are the
    product of their bidders and their chunk's targets, so the cover is
    counted per bidder and per target (a dense count at 4 x 8192 x 8192
    would take 2 GiB)."""
    plan = tpe.top2_plan(b, w, m)
    assert plan.blocks == b * plan.bidder_blocks * plan.chunks
    assert plan.blocks >= tpe.SMS
    assert plan.chunk_len >= tpe.TOP2_MIN_CHUNK
    assert plan.merge == (plan.chunks > 1)
    groups = plan.threads // plan.group
    per_group = plan.bidders_per_block // groups
    bidders = np.zeros(w, np.int64)
    for x in range(plan.bidder_blocks):
        j = ((x * groups + np.arange(groups)[:, None]) * per_group
             + np.arange(per_group)[None, :]).ravel()
        bidders[j[j < w]] += 1
    targets = np.zeros(m, np.int64)
    for c in range(plan.chunks):
        targets[c * plan.chunk_len:min(m, (c + 1) * plan.chunk_len)] += 1
    assert (bidders == 1).all() and (targets == 1).all()
    assert plan.scratch_floats == (3 * plan.chunks * b * w if plan.merge
                                   else 0)


def _chunked(x1, x2, price, bounds):
    """Per chunk [k0, k1): top2_plain on it, indices made global."""
    parts = []
    for k0, k1 in bounds:
        best, better, best_i = tpe.top2_plain(
            x1, x2[:, k0:k1], price[:, k0:k1])
        parts.append((best, better, best_i + k0))
    return parts


def _random_bounds(rs, m):
    cuts = np.sort(rs.choice(np.arange(1, m), size=min(m - 1, rs.randint(
        0, 9)), replace=False)) if m > 1 else np.array([], np.int64)
    edges = [0, *cuts.tolist(), m]
    return list(zip(edges[:-1], edges[1:]))


@pytest.mark.parametrize("m", [1, 2, 97, 600])
def test_order_free_merge_equals_top2_plain(m):
    """Random chunkings, merged in random orders: bit for bit the plain
    version's values and indices, with exact ties, targets duplicated
    across chunk boundaries and a single target."""
    rs = np.random.RandomState(m)
    b, w = 2, 50
    x1 = torch.from_numpy(rs.rand(b, w, 3).astype(np.float32))
    x2 = torch.from_numpy(rs.rand(b, m, 3).astype(np.float32))
    price = torch.from_numpy((rs.rand(b, m) * 0.1).astype(np.float32))
    if m > 1:
        # the second half repeats the first: every value has a twin in
        # another chunk, often across a boundary
        x2[:, m // 2:] = x2[:, :m - m // 2]
        price[:, m // 2:] = price[:, :m - m // 2]
        on = min(5, m)
        x1[:, :on] = x2[:, :on]    # bidders on a target: ties at 3 - price
    ref = tpe.top2_plain(x1, x2, price)
    for _ in range(6):
        parts = _chunked(x1, x2, price, _random_bounds(rs, m))
        order = rs.permutation(len(parts))
        got = tpe.top2_merge([parts[i] for i in order])
        for a, r in zip(got, ref):
            assert torch.equal(a.to(r.dtype), r)
    if m == 1:
        assert bool((ref[1] == -1e9).all()) and bool((ref[2] == 0).all())
    else:
        # twins tie: the second-best equals the best somewhere
        assert bool((ref[0] == ref[1]).any())


def test_plans_are_cached():
    """One computation per shape; the plans are immutable, so the cache
    cannot be changed through them."""
    tps._slice_plan.cache_clear()
    tpe._top2_plan.cache_clear()
    a = tps.slice_plan(128, 2048, 16, (64, 64))
    assert tps.slice_plan(128, 2048, 16, [64, 64]) is a
    assert tps._slice_plan.cache_info().hits == 1
    assert tps._slice_plan.cache_info().misses == 1
    p = tpe.top2_plan(2, 16384, 16384)
    assert tpe.top2_plan(2, 16384, 16384) is p
    assert tpe._top2_plan.cache_info().hits == 1
    assert tpe._top2_plan.cache_info().misses == 1
    for plan in (a, p):
        with pytest.raises(AttributeError):
            plan.blocks = -1


def _held(arr, addr):
    """The ints at ``addr``, read anew from memory: the array is alive."""
    return list((ctypes.c_int * len(arr)).from_address(addr))


@pytest.mark.parametrize("sizes,feat", [((128, 128), 4), ((16, 16, 16), 16),
                                        ((8, 8, 8), 21)])
def test_slice_entry_integers_follow_the_plan(sizes, feat):
    """``ct_slice`` takes its integers as one cached array, in
    ``SLICE_PARAMS`` order, that the cache keeps alive."""
    rows, points = 128, 2048
    plan = tps.slice_plan(rows, points, feat, sizes)
    arr, addr = tps._slice_params(rows, points, feat, sizes)
    _, lane_extent, cells = tps.kernel_grid_dims(sizes)
    offs = tps.lane_offsets(sizes)
    want = dict(rows=rows, points=points, feat=feat, cells=cells,
                lane_extent=lane_extent, off2=offs[2], off3=offs[3],
                n_vert=2 if len(sizes) == 2 else 4, group=plan.group,
                points_per_thread=plan.points_per_thread,
                threads=plan.threads, blocks=plan.blocks, vec=int(plan.vec))
    assert _held(arr, addr) == [want[n] for n in tps.SLICE_PARAMS]
    assert tps._slice_params(rows, points, feat, sizes)[0] is arr


@pytest.mark.parametrize("b,w,m", [(2, 16384, 16384), (1, 256, 16384),
                                   (2, 777, 3001), (4, 8192, 8192)])
@pytest.mark.parametrize("skip", [None, True, False])
def test_top2_entry_integers_follow_the_plan(b, w, m, skip):
    """``ct_emd_top2`` takes B, W, M, the plan and the skip flag as one
    cached array that the cache keeps alive; ``skip`` None is the plan's."""
    plan, (arr, addr) = tpe._top2_params(b, w, m, skip)
    assert plan == tpe.top2_plan(b, w, m)
    flag = plan.skip if skip is None else skip
    assert _held(arr, addr) == [b, w, m, plan.threads, plan.group,
                                plan.bidder_blocks, plan.chunks,
                                plan.chunk_len, int(flag)]
    assert tpe._top2_params(b, w, m, skip)[1][0] is arr
