"""Launch arithmetic of the splat (``splat_plan``), on the CPU.

The kernel itself runs only on a CUDA card
(``tests/test_torch_kernels_gpu.py``); which block holds which slab of a
row's grid, which points it lists and which lane deposits which (point,
vertex, feature) is decided by Python (``splat_plan``) and by the index
arithmetic of ``splat_slab_kernel`` in ``csrc/splat_slice.cu``, mirrored
here in numpy on random mappings.  The winner-tracking splat launches the
same kernel and then the splat backward's winner pass.  No JAX.
"""

import ctypes
import gc

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# every head group of the classifier and of the completion model
MODEL_SHAPES = [(128, 128), (32, 32, 32), (64, 64), (16, 16, 16), (16, 16),
                (8, 8, 8)]
# (rows, points a row): the classifier's B = 8 x 16 heads x 2048 points,
# the completion decoder's B = 2 x 16 heads x 16384
MODEL_ROWS = [(128, 2048), (32, 16384)]
FEATURES = [1, 3, 4, 16, 32]
# csrc: kListP (the scan's kScanPoints lists in any order, which the
# deposits do not depend on)
LIST_P = 2


def _bases(sizes, points, seed=0):
    """One row's base cells of a valid mapping: every vertex in the grid."""
    rs = np.random.RandomState(seed)
    first = [rs.randint(0, s - 1, points) for s in sizes]
    lane = first[1] if len(sizes) == 2 else first[1] * sizes[2] + first[2]
    return first[0] * tps.kernel_grid_dims(sizes)[1] + lane


def _mirror(plan, sizes, feat, base):
    """The kernel's work for one row with base cells ``base``: -> (how often
    each (point, vertex, feature) is deposited, how often each word of the
    row's grid is written out)."""
    points = len(base)
    _, lane_extent, cells = tps.kernel_grid_dims(sizes)
    offs = tps.lane_offsets(sizes)[:2 ** (len(sizes) - 1)]
    reach = lane_extent + tps.lane_offsets(sizes)[3] + 1
    vertex = base[:, None] + np.array(list(offs)
                                      + [lane_extent + o for o in offs])
    words = cells * feat
    deposits = np.zeros(vertex.shape + (feat,), np.int64)
    written = np.zeros(words, np.int64)
    groups = plan.threads // plan.group
    t = np.arange(plan.threads)
    for s in range(plan.slabs):
        wb = s * plan.slab_words
        n_words = min(plan.slab_words, words - wb)
        for c in range(plan.chunks):
            written[wb:wb + n_words] += 1
            ks = np.arange(c * plan.chunk, min(points, (c + 1) * plan.chunk))
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
            j, f = np.broadcast_arrays(j[..., None],
                                       f[:, None, None, :])
            live = (j < n) & (f < feat)
            k, f = listed[j[live]], f[live]
            for v in range(vertex.shape[1]):
                at = vertex[k, v] * feat + f - wb
                inside = (at >= 0) & (at < n_words)
                np.add.at(deposits, (k[inside], v, f[inside]), 1)
    return deposits, written


def _check(plan, rows, points, feat, sizes):
    words = tps.kernel_grid_dims(sizes)[2] * feat
    assert plan.group == min(8, 1 << int(np.ceil(np.log2(-(-feat // 4)))))
    assert plan.threads == tps.SPLAT_THREADS and plan.vec == (feat % 4 == 0)
    assert plan.slab_words % 4 == 0 and plan.slab_words <= tps.SLAB_WORDS
    # even slabs: the fewest that fit, none empty
    assert plan.slabs == -(-words // tps.SLAB_WORDS)
    assert (plan.slabs - 1) * plan.slab_words < words \
        <= plan.slabs * plan.slab_words
    assert (plan.chunks - 1) * plan.chunk < points \
        <= plan.chunks * plan.chunk
    # chunks only as many as it takes to fill the card, and no more than
    # one for each SPLAT_MIN_CHUNK points
    if plan.chunks > 1:
        assert rows * plan.slabs * (plan.chunks - 1) < tps.SPLAT_FILL_BLOCKS
        assert plan.chunks <= -(-points // tps.SPLAT_MIN_CHUNK)
    assert plan.blocks == rows * plan.slabs * plan.chunks
    deposits, written = _mirror(plan, sizes, feat, _bases(sizes, points))
    assert (deposits == 1).all()
    assert (written == plan.chunks).all()


@pytest.mark.parametrize("rows,points", MODEL_ROWS)
@pytest.mark.parametrize("feat", FEATURES)
@pytest.mark.parametrize("sizes", MODEL_SHAPES)
def test_splat_plan_deposits_every_contribution_once(sizes, feat, rows,
                                                     points):
    """Each (point, vertex, feature) deposited by exactly one block and
    lane, and every word of a row written out once by each chunk, at the
    models' shapes."""
    _check(tps.splat_plan(rows, points, feat, sizes), rows, points, feat,
           sizes)


@pytest.mark.parametrize("sizes", [(16, 16), (9, 7), (8, 8, 8), (5, 6, 7),
                                   (2, 3), (33, 5, 4), (64, 64, 3)])
@pytest.mark.parametrize("points", [1, 37, 300, 1500])
def test_splat_plan_at_ragged_shapes(sizes, points):
    """F from 1 to 33 and 100, points a multiple of nothing, rows that are
    one slab or many, words a row that are no multiple of 4."""
    for feat in (*range(1, 34), 100):
        _check(tps.splat_plan(3, points, feat, sizes), 3, points, feat,
               sizes)


@pytest.mark.parametrize("rows,points", MODEL_ROWS)
def test_splat_plan_at_the_model_shapes(rows, points):
    """Every model shape fills the card (at least ``SPLAT_FILL_BLOCKS``
    blocks), and a row is one chunk where its slabs alone fill it, so that
    the wrapper leaves the grid unfilled.  The winner splat records the
    winners in its splat kernel at the classifier's four large grids."""
    for sizes, feat in zip(MODEL_SHAPES, (4, 4, 16, 16, 16, 32)):
        plan = tps.splat_plan(rows, points, feat, sizes)
        assert plan.blocks >= tps.SPLAT_FILL_BLOCKS
        assert (plan.chunks == 1) == (
            rows * plan.slabs >= tps.SPLAT_FILL_BLOCKS)
        assert tps.winners_in_splat(plan) == (
            points == 2048 and sizes in MODEL_SHAPES[:4])


def test_splat_plan_refuses_the_index_limit():
    limit = tps.INDEX_LIMIT
    # the points: R * K * F
    with pytest.raises(ValueError):
        tps.splat_plan(1, limit // 4, 4, (2, 2))
    tps.splat_plan(1, limit // 4 - 1, 4, (2, 2))
    # the grid: R * G * F (R = 2**15 rows of 2**12 cells)
    with pytest.raises(ValueError):
        tps.splat_plan(2 ** 15, 1, 16, (64, 64))
    tps.splat_plan(2 ** 15 - 1, 1, 16, (64, 64))


def test_splat_plan_and_its_integer_array_are_cached_and_kept():
    sizes = (8, 8, 8)
    plan = tps.splat_plan(128, 2048, 32, sizes)
    assert plan is tps.splat_plan(128, 2048, 32, list(sizes))
    params = tps._splat_params(128, 2048, 32, sizes)
    gc.collect()
    again = tps._splat_params(128, 2048, 32, sizes)
    assert again[0] is params[0]
    assert again[1] == params[1] == ctypes.addressof(params[0])
    assert len(params[0]) == len(tps.SPLAT_PARAMS)
    # the integers read back from the address the entry point takes
    seen = (ctypes.c_int * len(params[0])).from_address(params[1])
    assert dict(zip(tps.SPLAT_PARAMS, seen)) == {
        "rows": 128, "points": 2048, "feat": 32, "cells": 512,
        "lane_extent": 64, "off2": 8, "off3": 9, "n_vert": 4,
        **plan._asdict(), "vec": 1}
    # 8^3 x 32 is 16384 words a row: two slabs of 8192, and 2 chunks of
    # 1024 points so that 128 rows make 512 blocks
    assert plan._asdict() == {"group": 8, "threads": 256, "slabs": 2,
                              "slab_words": 8192, "chunks": 2, "chunk": 1024,
                              "blocks": 512, "vec": True}


def test_grid_is_left_unfilled_only_where_each_block_writes_its_slab():
    """One chunk a row: every word is written by the kernel, so the grid
    is not filled; several chunks raise a zero-filled grid."""
    cpu = torch.device("cpu")
    assert tps.splat_plan(128, 2048, 4, (128, 128)).chunks == 1
    assert tps._splat_grid(128, 2048, 4, (128, 128), cpu).shape == (
        128, 128 * 128, 4)
    assert tps.splat_plan(128, 2048, 16, (16, 16)).chunks > 1
    assert not tps._splat_grid(128, 2048, 16, (16, 16), cpu).any()


def test_splat_variants_apply_to_the_kernel_source():
    """``splat_variants.py`` builds its variants by replacing text of
    ``csrc/splat_slice.cu``: each replaced text is there exactly once."""
    import splat_variants
    src = (tps.cuda_build.CSRC / "splat_slice.cu").read_text()
    for name, (edits, consts) in splat_variants.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, name
        for const in consts:
            assert hasattr(tps, const), name
