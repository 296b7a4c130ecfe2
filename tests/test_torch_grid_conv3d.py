"""The launch arithmetic of the 3D grid conv kernels (``conv3d_tiling``),
checked on the CPU: the card runs ``grid_conv3d_fwd_kernel`` and
``grid_conv3d_dw_kernel`` on exactly these numbers, and its entry points
refuse any others.  The kernels' index arithmetic is mirrored here in
numpy.  No JAX.
"""

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc

CLASSIFIER = [((32, 32, 32), 4, 128, 16), ((16, 16, 16), 16, 128, 16),
              ((8, 8, 8), 32, 128, 16)]
# (sizes, F, rows, heads): the classifier's 3D head groups at R = 128, then
# ragged grids at every compile-time F and at run-time ones
TILING_CASES = CLASSIFIER + [
    (sizes, f, 8, 4) for sizes in ((5, 7, 9), (1, 3, 17), (9, 1, 4))
    for f in (1, 3, 4, 8, 16, 21, 32)]


def _ceil(a, b):
    return -(-a // b)


def _tile_origins(sizes, tile):
    """(x0, y0, z0) of each tile in block order (z fastest), as the kernels
    decode ``blockIdx.x`` or a unit's tile index."""
    tiles = [_ceil(n, t) for n, t in zip(sizes, tile)]
    return [(i // (tiles[1] * tiles[2]) * tile[0],
             i // tiles[2] % tiles[1] * tile[1], i % tiles[2] * tile[2])
            for i in range(int(np.prod(tiles)))]


@pytest.mark.parametrize("sizes,feat,rows,heads", TILING_CASES)
def test_conv3d_tiling_reaches_every_cell_once(sizes, feat, rows, heads):
    """Forward: each output (cell, channel) is written by one thread of one
    block and reads only staged halo cells; the packed weights hold each
    (head, fo, fi, tap) once.  Weight gradient: each (batch member, cell)
    is summed by one (block, split) of its head, each (fo, fi, tap) by one
    thread of one slice; every block writes its scratch row."""
    cfg = tgc.conv3d_tiling(sizes, feat, rows, heads)
    x, y, z = sizes
    padded = _ceil(feat, 4) * 4
    na = padded // 4
    tx, ty, tz = cfg["tile"]
    assert tx % tgc.CELLS_X == 0 and cfg["zs"] >= tz + 2
    assert cfg["groups"] * cfg["fo"] == padded and cfg["chunks"] * 4 == padded
    origins = _tile_origins(sizes, cfg["tile"])
    assert cfg["conv_blocks"] == rows * len(origins)
    t = np.arange(cfg["conv_threads"])
    per_group = tx // tgc.CELLS_X * ty * tz
    assert cfg["conv_threads"] == per_group * cfg["groups"]
    tl, fo0 = t % per_group, t // per_group * cfg["fo"]
    lz, ly, xr = tl % tz, tl // tz % ty, tl // (tz * ty)
    # the halo a thread reads: x run + 6 cells, y + 3, z + 3
    assert (xr * tgc.CELLS_X + tgc.CELLS_X + 2 <= tx + 2).all()
    assert (ly + 3 <= ty + 2).all() and (lz + 3 <= tz + 2).all()
    written = np.zeros((x, y, z, feat), int)
    for x0, y0, z0 in origins:
        for j in range(tgc.CELLS_X):
            for o in range(cfg["fo"]):
                cx, cy, cz = x0 + xr * tgc.CELLS_X + j, y0 + ly, z0 + lz
                co = fo0 + o
                keep = (cx < x) & (cy < y) & (cz < z) & (co < feat)
                np.add.at(written, (cx[keep], cy[keep], cz[keep], co[keep]),
                          1)
    assert (written == 1).all()
    # the packed weights [h][chunk][tap][k][FP]
    i = np.arange(cfg["pack_floats"])
    fo, k = i % padded, i // padded % 4
    tap, chunk = i // (4 * padded) % 27, i // (108 * padded) % na
    head = i // (27 * padded * padded)
    fi = 4 * chunk + k
    keep = (fo < feat) & (fi < feat)
    packed = np.zeros((heads, feat, feat, 27), int)
    np.add.at(packed, (head[keep], fo[keep], fi[keep], tap[keep]), 1)
    assert (packed == 1).all() and head.max() == heads - 1

    # weight gradient
    dtx, dty, dtz = cfg["dw_tile"]
    assert cfg["dw_zs"] >= dtz + 2 and cfg["dw_gz"] >= dtz
    covered = np.zeros(sizes, int)
    for x0, y0, z0 in _tile_origins(sizes, cfg["dw_tile"]):
        covered[x0:x0 + dtx, y0:y0 + dty, z0:z0 + dtz] += 1
    assert (covered == 1).all()
    units = rows // heads * len(_tile_origins(sizes, cfg["dw_tile"]))
    nb, split, quads = cfg["dw_blocks"], cfg["dw_split"], cfg["dw_quads"]
    ncs, slices = cfg["dw_slice_quads"], cfg["dw_slices"]
    assert cfg["partial_rows"] == nb and 1 <= nb <= units
    taken = np.zeros(units, int)
    for j in range(nb):
        taken[j::nb] += 1
    assert (taken == 1).all()
    # a split walks whole (x, y) rows of the tile along z
    summed = np.zeros(dtx * dty, int)
    for s in range(split):
        summed[s::split] += 1
    assert (summed == 1).all()
    assert quads >= 32 or split % 8 == 0
    assert quads == 9 * na * ncs and slices * ncs == na
    assert cfg["dw_threads"] == quads * split
    q, s = tgc._dw_lanes(cfg["dw_threads"], quads, split)
    assert len(set(zip(q, s))) == cfg["dw_threads"]
    assert q.max() == quads - 1 and s.max() == split - 1
    kept = np.zeros((padded, padded, 27), int)
    for sl in range(slices):
        for qq in range(quads):
            for e in range(tgc.DW_SUMS):
                kept[4 * (qq % na) + e // 4 % 4,
                     sl * 4 * ncs + 4 * (qq // na % ncs) + e % 4,
                     qq // (na * ncs) * 3 + e // 16] += 1
    assert (kept == 1).all()


@pytest.mark.parametrize("feat", range(1, tgc.MAX_FEAT + 1))
def test_conv3d_tiling_stays_within_a_block_at_every_width(feat):
    """Threads within the kernels' launch bounds (256) and shared memory
    within a block's 227 KB, for the classifier's grids and ragged ones."""
    for sizes in ((32, 32, 32), (16, 16, 16), (8, 8, 8), (1, 1, 1),
                  (3, 50, 2), (33, 17, 65)):
        cfg = tgc.conv3d_tiling(sizes, feat, 128, 16)
        assert 1 <= cfg["conv_threads"] <= 256
        assert 1 <= cfg["dw_threads"] <= tgc.DW_THREADS
        assert max(cfg["conv_smem"], cfg["dw_smem"]) <= tgc.MAX_SMEM


@pytest.mark.parametrize("sizes,feat,rows,heads", CLASSIFIER)
def test_conv3d_tiling_is_bank_conflict_free_at_the_classifier_shapes(
        sizes, feat, rows, heads):
    """By the tiling's own model, no quarter warp's float4 loads meet in a
    bank: the forward's halo loads and the weight gradient's cotangent and
    halo loads."""
    cfg = tgc.conv3d_tiling(sizes, feat, rows, heads)
    assert tgc._conv3d_fwd_conflict(cfg["zs"], cfg["tile"],
                                    cfg["conv_threads"]) == 1
    for stride in ({"zs": cfg["dw_zs"]}, {"gz": cfg["dw_gz"]}):
        assert tgc._conv3d_dw_conflict(cfg["dw_tile"], feat,
                                       cfg["dw_slice_quads"],
                                       cfg["dw_split"], **stride) == 1


def test_bank_model_sees_a_conflict():
    """The model itself: eight lanes on one bank group are 8-way, eight
    consecutive float4 are conflict-free, repeated addresses broadcast."""
    assert tgc._phase_conflict(np.arange(8) * 8) == 8
    assert tgc._phase_conflict(np.arange(8)) == 1
    assert tgc._phase_conflict(np.zeros(8, int)) == 1


def test_conv3d_tiling_fills_the_card_and_caches():
    """The classifier's shapes give at least two forward blocks and about
    three weight-gradient blocks per SM and a scratch of a few MB; the
    tiling is computed once per shape and handed out as a copy."""
    for sizes, feat, rows, heads in CLASSIFIER:
        cfg = tgc.conv3d_tiling(sizes, feat, rows, heads)
        assert cfg["conv_blocks"] >= 2 * tgc.SMS
        dw_blocks = cfg["dw_blocks"] * heads * cfg["dw_slices"]
        assert 2 * tgc.SMS <= dw_blocks <= 4 * tgc.SMS
        assert cfg["partial_rows"] * heads * 27 * feat * feat * 4 < 16e6
    assert tgc.conv3d_tiling((8, 8, 8), 32, 128, 16)["tile"] == (4, 4, 8)
    hits = tgc._conv3d_tiling.cache_info().hits
    tgc.conv3d_tiling((8, 8, 8), 32, 128, 16)["tile"] = None   # a copy
    assert tgc.conv3d_tiling([8, 8, 8], 32, 128, 16)["tile"] == (4, 4, 8)
    assert tgc._conv3d_tiling.cache_info().hits == hits + 2
    with pytest.raises(ValueError):
        tgc.conv3d_tiling((8, 8, 8), 33, 128, 16)


@pytest.mark.parametrize("sizes,feat", [((5, 7, 9), 3), ((9, 1, 4), 32)])
def test_grid_conv3d_wrappers_run_the_plain_versions_on_the_cpu(sizes,
                                                                feat):
    """On CPU tensors the wrappers launch nothing and return the plain
    versions' results."""
    h = 2
    cells = sizes[0] * sizes[1] * sizes[2]
    gen = torch.Generator().manual_seed(3)
    grid = torch.randn(2 * h, cells, feat, generator=gen)
    g = torch.randn(2 * h, cells, feat, generator=gen)
    weight = torch.randn(h * feat, feat, 3, 3, 3, generator=gen)
    bias = torch.randn(h * feat, generator=gen)
    n = (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches)
    assert torch.equal(tgc.grid_conv3d(grid, weight, bias, sizes, h),
                       tgc.grid_conv_plain(grid, weight, bias, sizes, h))
    assert torch.equal(tgc.grid_conv3d_dw(grid, g, sizes, h),
                       tgc.grid_conv_dw_plain(grid, g, sizes, h))
    assert (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches) == n
