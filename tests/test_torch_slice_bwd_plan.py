"""Launch arithmetic of the slice backward (``slice_bwd_plan``), and the
fixed-point arithmetic of its d_grid sums, on the CPU.

The kernels run only on a CUDA card (``tests/test_torch_kernels_gpu.py``);
which block holds which slab of a row's d_grid, which points it lists and
which lane adds which (point, vertex, feature), and which d_w block bounds
which points, are decided by Python (``slice_bwd_plan``) and by the index
arithmetic of ``slice_bwd_kernel`` and ``slice_bwd_dw_kernel`` in
``csrc/splat_slice.cu``, mirrored here in numpy.  So is the fixed point:
each term rounded to a multiple of 2^-S, the terms summed as 64-bit
integers (in any order), the sum rounded once to float32, held to the
plain version.  No JAX.
"""

import ctypes
import gc

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core.splat_slice import _flatten_mapping
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# every head group of the classifier and of the completion model
MODEL_SHAPES = [(128, 128), (32, 32, 32), (64, 64), (16, 16, 16), (16, 16),
                (8, 8, 8)]
MODEL_F = (4, 4, 16, 16, 16, 32)
# (rows, points a row): the classifier's B = 8 x 16 heads x 2048 points,
# the completion decoder's B = 2 x 16 heads x 16384, the S3DIS segmenter's
# B = 8 x 16 heads x 4096, the reconstructor decoder's B = 4 x 16 heads x
# 8192, the KPConv-protocol segmenter's B = 6 x 16 heads x 8192
MODEL_ROWS = [(128, 2048), (32, 16384), (128, 4096), (64, 8192),
              (96, 8192)]
FEATURES = [1, 3, 4, 16, 32]
# csrc: kListP, kScanPoints (as the splat's)
LIST_P = 2
SCAN = tps.SPLAT_SCAN_POINTS


def _bases(sizes, points, seed=0):
    """One row's base cells of a valid mapping: every vertex in the grid."""
    rs = np.random.RandomState(seed)
    first = [rs.randint(0, s - 1, points) for s in sizes]
    lane = first[1] if len(sizes) == 2 else first[1] * sizes[2] + first[2]
    return first[0] * tps.kernel_grid_dims(sizes)[1] + lane


def _mirror(plan, sizes, feat, base):
    """The d_grid kernel's work for one row with base cells ``base``: ->
    (how often each (point, real vertex, feature) is added, how often each
    word of the row's d_grid is written)."""
    points = len(base)
    _, lane_extent, cells = tps.kernel_grid_dims(sizes)
    offs = tps.lane_offsets(sizes)[:2 ** (len(sizes) - 1)]
    reach = lane_extent + tps.lane_offsets(sizes)[3] + 1
    vertex = base[:, None] + np.array(list(offs)
                                      + [lane_extent + o for o in offs])
    words = cells * feat
    added = np.zeros(vertex.shape + (feat,), np.int64)
    written = np.zeros(words, np.int64)
    groups = plan.threads // plan.group
    t = np.arange(plan.threads)
    for s in range(plan.slabs):
        wb = s * plan.slab_words
        n_words = min(plan.slab_words, words - wb)
        written[wb:wb + n_words] += 1
        for k0 in range(0, points, SCAN):
            ks = np.arange(k0, min(points, k0 + SCAN))
            listed = ks[(base[ks] * feat < wb + n_words)
                        & ((base[ks] + reach) * feat > wb)]
            n = len(listed)
            passes = -(-n // (groups * LIST_P))
            j = ((t // plan.group)[:, None, None]
                 + np.arange(passes)[None, :, None] * groups * LIST_P
                 + np.arange(LIST_P)[None, None, :] * groups)
            # lane t % group takes the quads t % group, + group, ... and
            # their features 4q .. 4q + 3 below F
            quad = (t % plan.group)[:, None] + np.arange(
                -(-feat // (4 * plan.group)))[None, :] * plan.group
            f = (4 * quad[..., None] + np.arange(4)).reshape(len(t), -1)
            j, f = np.broadcast_arrays(j[..., None], f[:, None, None, :])
            live = (j < n) & (f < feat)
            k, f = listed[j[live]], f[live]
            for v in range(vertex.shape[1]):
                at = vertex[k, v] * feat + f - wb
                inside = (at >= 0) & (at < n_words)
                np.add.at(added, (k[inside], v, f[inside]), 1)
    return added, written


def _check(rows, points, feat, sizes):
    plan = tps.slice_bwd_plan(rows, points, feat, sizes)
    words = tps.kernel_grid_dims(sizes)[2] * feat
    assert plan.group == tps.slice_plan(rows, points, feat, sizes).group
    assert plan.threads == tps.SPLAT_THREADS and plan.vec == (feat % 4 == 0)
    assert plan.slab_words % 4 == 0
    assert plan.slab_words <= tps.SLICE_BWD_SLAB_WORDS
    assert (plan.slabs - 1) * plan.slab_words < words \
        <= plan.slabs * plan.slab_words
    assert plan.blocks == rows * plan.slabs
    # the fewest even slabs that fit, or more, smaller ones (of 4 words at
    # least) where the rows would not fill the card
    fewest = -(-words // tps.SLICE_BWD_SLAB_WORDS)
    if plan.slabs > fewest:
        assert rows * (plan.slabs - 1) < tps.SLICE_BWD_FILL_BLOCKS \
            or plan.slab_words == 4
    added, written = _mirror(plan, sizes, feat, _bases(sizes, points))
    assert (added == 1).all()
    assert (written == 1).all()
    return plan


@pytest.mark.parametrize("rows,points", MODEL_ROWS)
@pytest.mark.parametrize("feat", FEATURES)
@pytest.mark.parametrize("sizes", MODEL_SHAPES)
def test_slice_bwd_plan_adds_every_contribution_once(sizes, feat, rows,
                                                     points):
    """Each (point, real vertex, feature) added by exactly one block and
    lane, and every d_grid word of a row written once, at the models'
    shapes: a row is never cut into chunks of points."""
    _check(rows, points, feat, sizes)


@pytest.mark.parametrize("sizes", [(16, 16), (9, 7), (8, 8, 8), (5, 6, 7),
                                   (2, 3), (33, 5, 4), (64, 64, 3)])
@pytest.mark.parametrize("points", [1, 37, 2100])
def test_slice_bwd_plan_at_ragged_shapes(sizes, points):
    """F from 1 to 33 and 100, points a multiple of nothing and over two
    scans, rows of G * F words that are no multiple of 4, slabs of 4
    words."""
    for feat in (1, 2, 3, 4, 5, 7, 8, 13, 16, 21, 32, 33, 100):
        _check(3, points, feat, sizes)


@pytest.mark.parametrize("rows,points", MODEL_ROWS)
def test_slice_bwd_plan_at_the_model_shapes(rows, points):
    """Every model shape fills the card with d_grid blocks, and reads and
    writes float4 rows."""
    for sizes, feat in zip(MODEL_SHAPES, MODEL_F):
        plan = tps.slice_bwd_plan(rows, points, feat, sizes)
        assert plan.blocks >= tps.SLICE_BWD_FILL_BLOCKS and plan.vec
        dw = tps.slice_plan(rows, points, feat, sizes)
        assert (plan.group, plan.points_per_thread, plan.dw_blocks) == (
            dw.group, dw.points_per_thread, dw.blocks)


def _fixed_point_d_grid(x0, lane0, w_lo, w_hi, g_pts, sizes):
    """d_grid as the kernels compute it, in numpy: the d_w blocks' bounds
    on |w| * |g|, each row's scale 2^S, the terms rint(w * g * 2^S) summed
    as 64-bit integers, the sum rounded to float32 and scaled back.  ->
    (d_grid, the largest |sum| * 2^S of a row, each row's S)."""
    r, k, f = g_pts.shape
    plan = tps.slice_bwd_plan(r, k, f, sizes)
    real = 2 ** (len(sizes) - 1)
    w = np.concatenate([w_lo[..., :real], w_hi[..., :real]], -1)
    point_most = (np.abs(w).max(-1) * np.abs(g_pts).max(-1)).astype(
        np.float32).reshape(-1)
    per_block = plan.points_per_thread * (tps.SLICE_THREADS // plan.group)
    pad = -len(point_most) % per_block
    most = np.concatenate([point_most, np.zeros(pad, np.float32)]).reshape(
        -1, per_block).max(-1)
    assert len(most) == plan.dw_blocks
    lane_extent = tps.kernel_grid_dims(sizes)[1]
    offs = np.array(tps.lane_offsets(sizes)[:real])
    cells = np.concatenate([offs, lane_extent + offs])
    base = x0.astype(np.int64) * lane_extent + lane0
    out = np.zeros((r, tps.kernel_grid_dims(sizes)[2], f), np.float32)
    peak, scales = 0, []
    for row in range(r):
        bound = most[row * k // per_block:(row * k + k - 1) // per_block
                     + 1].max()
        e = int(np.frexp(bound)[1])
        s = int(np.clip(61 - int(k).bit_length() - e, -126, 126))
        scales.append(s)
        terms = np.rint((w[row, :, :, None] * g_pts[row, :, None, :])
                        .astype(np.float32)
                        * np.ldexp(np.float32(1), s)).astype(np.int64)
        sums = np.zeros(out.shape[1:], np.int64)
        # integer sums: any order gives the same words
        order = np.random.RandomState(row).permutation(k)
        np.add.at(sums, (base[row, order][:, None] + cells[None, :]),
                  terms[order])
        peak = max(peak, int(np.abs(sums).max()))
        out[row] = sums.astype(np.float32) * np.ldexp(np.float32(1), -s)
    return out, peak, scales


@pytest.mark.parametrize("sizes,f,k", [((16, 16), 4, 2048),
                                       ((8, 8, 8), 5, 1500),
                                       ((4, 4), 3, 700),
                                       ((8, 8, 8), 32, 3000),
                                       ((16, 16), 16, 4096),
                                       ((128, 128), 4, 4096)])
@pytest.mark.parametrize("magnitude", [1e-30, 1.0, 1e30])
def test_fixed_point_d_grid_holds_to_the_plain_version(sizes, f, k,
                                                       magnitude):
    """The fixed point, mirrored in numpy, within 1e-6 of the plain
    version's float sums (relative to the largest word), on points packed
    onto few cells (many terms a word) and cotangents of every sign at
    tiny, unit and huge magnitudes: no row's integer sum reaches 2^61."""
    rs = np.random.RandomState(1)
    r = 3
    keys = np.tanh(rs.randn(1, k, r, len(sizes))).astype(np.float32)
    mapping = [a.contiguous() for a in _flatten_mapping(
        grid_mapping(torch.from_numpy(keys), sizes, len(sizes)))]
    g_pts = (rs.randn(r, k, f) * magnitude).astype(np.float32)
    g_pts[-1] = 0.0                          # a row of zeros: any scale
    grid = torch.zeros(r, tps.kernel_grid_dims(sizes)[2], f)
    plain = tps.slice_bwd_plain(*mapping, torch.from_numpy(g_pts), grid,
                                sizes)[0].numpy()
    got, peak, scales = _fixed_point_d_grid(
        *(a.numpy() for a in mapping), g_pts, sizes)
    assert peak < 2 ** 61
    assert not got[-1].any()
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-6 * scale
    # the scale follows the magnitude: about 2^-100 apart per 1e30
    assert abs(scales[0] + np.log2(magnitude)) < 70


@pytest.mark.parametrize("k", [2048, 4096])
def test_fixed_point_headroom_with_every_point_on_one_cell(k):
    """The worst case for the sum's headroom: a row's K points on the same
    cell with |w * g| at the bound of its d_w block (keys on the grid's
    corner: a vertex weight of about 1, the same cotangent), so that one
    word sums K terms of about 2^(S + e).  At the segmenter's K = 4096 the
    scale S = 61 - bits(K) - e is one bit lower than at 2048, and the sum
    stays below 2^61 (2^63 is the int64 limit).  Row by row, d_grid is
    within 1e-7 of the largest word of the sums taken in float64."""
    sizes, f, r = (8, 8, 8), 4, 2
    # keys on a vertex: weight 1 on the base cell, 0 on the others
    keys = np.full((1, k, r, 3), -1.0, np.float32)
    mapping = [a.contiguous() for a in _flatten_mapping(
        grid_mapping(torch.from_numpy(keys), sizes, 3))]
    g_pts = np.full((r, k, f), -3.0, np.float32)
    g_pts[1] = 1e20
    got, peak, scales = _fixed_point_d_grid(
        *(a.numpy() for a in mapping), g_pts, sizes)
    for row in range(r):
        e = int(np.frexp(np.abs(g_pts[row]).max())[1])
        assert scales[row] == 61 - k.bit_length() - e
    assert 2 ** 59 <= peak < 2 ** 61
    # against the sums in float64: the fixed point rounds each term at
    # 2^-S; the plain version's float32 sums, which round at every add, are
    # off by up to 1.6e-5 here (K equal terms round the same way)
    x0, lane0, w_lo, w_hi = (a.numpy() for a in mapping)
    w = np.concatenate([w_lo[..., :4], w_hi[..., :4]], -1).astype(np.float64)
    lane_extent = tps.kernel_grid_dims(sizes)[1]
    offs = np.array(tps.lane_offsets(sizes)[:4])
    cells = x0.astype(np.int64)[..., None] * lane_extent + lane0[..., None] \
        + np.concatenate([offs, lane_extent + offs])
    exact = np.zeros(got.shape, np.float64)
    for row in range(r):
        np.add.at(exact[row], cells[row],
                  w[row, :, :, None] * g_pts[row, :, None, :])
        scale = np.abs(exact[row]).max()
        assert np.abs(got[row] - exact[row]).max() <= 1e-7 * scale


def test_slice_bwd_plan_refuses_the_index_limit():
    limit = tps.INDEX_LIMIT
    # the points: R * K * F
    with pytest.raises(ValueError):
        tps.slice_bwd_plan(1, limit // 4, 4, (2, 2))
    tps.slice_bwd_plan(1, limit // 4 - 1, 4, (2, 2))
    # the grid: R * G * F (R = 2**15 rows of 2**12 cells)
    with pytest.raises(ValueError):
        tps.slice_bwd_plan(2 ** 15, 1, 16, (64, 64))
    tps.slice_bwd_plan(2 ** 15 - 1, 1, 16, (64, 64))



def test_slice_bwd_plan_and_its_integer_array_are_cached_and_kept():
    sizes = (8, 8, 8)
    plan = tps.slice_bwd_plan(128, 2048, 32, sizes)
    assert plan is tps.slice_bwd_plan(128, 2048, 32, list(sizes))
    params = tps._slice_bwd_params(128, 2048, 32, sizes)
    gc.collect()
    again = tps._slice_bwd_params(128, 2048, 32, sizes)
    assert again[0] is params[0]
    assert again[1] == params[1] == ctypes.addressof(params[0])
    assert len(params[0]) == len(tps.SLICE_BWD_PARAMS)
    # the integers read back from the address the entry point takes
    seen = (ctypes.c_int * len(params[0])).from_address(params[1])
    assert dict(zip(tps.SLICE_BWD_PARAMS, seen)) == {
        "rows": 128, "points": 2048, "feat": 32, "cells": 512,
        "lane_extent": 64, "off2": 8, "off3": 9, "n_vert": 4,
        **plan._asdict(), "vec": 1}
    # 8^3 x 32 is 16384 words a row: 4 slabs of 4096, so that 128 rows
    # make 512 blocks; d_w as the slice
    assert plan._asdict() == {
        "group": 8, "threads": 256, "slab_words": 4096, "slabs": 4,
        "blocks": 512, "points_per_thread": 2, "dw_blocks": 4096,
        "vec": True}


def test_slice_bwd_variants_apply_to_the_kernel_source():
    """``splat_variants.py --kernel slice_bwd`` builds its variants by
    replacing text of ``csrc/splat_slice.cu``: each replaced text is there
    exactly once, and each constant it sets is the wrapper's."""
    import splat_variants
    src = (tps.cuda_build.CSRC / "splat_slice.cu").read_text()
    for name, (edits, consts) in splat_variants.SLICE_BWD_VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, name
        for const in consts:
            assert hasattr(tps, const), name
