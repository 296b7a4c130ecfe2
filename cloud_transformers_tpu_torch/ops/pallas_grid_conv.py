"""Grouped 'same' 3x3x3 and 3x3 grid convolutions on flat grids and their
weight gradients, with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_grid_conv.py``
(``pallas_grid_conv`` and ``pallas_grid_conv_dw``, 3D; ``pallas_grid_conv2d``
and ``pallas_grid_conv2d_dm``, 2D; ``pack_w_transposed`` and
``pack_m2d_transposed``).  Grids are flat ``[R = B*H, G, F]`` with cells in
row-major (x, y[, z]) order; row r belongs to head ``r % H``.  The weight is
the grouped conv weight in PyTorch's layout ``[H*F (out), F (in), 3, 3(, 3)]``
(the JAX param ``[3, 3(, 3), F, H*F]`` after ``convert.py``), the bias
``[H*F]``.  The TPU kernels' banded matrices (``pack_m2d``) and packed
im2col weights (``pack_w``) exist for its matrix unit and are not copied.

``grid_conv3d``/``grid_conv2d`` and ``grid_conv3d_dw``/``grid_conv2d_dw`` run
their CUDA kernels (``csrc/grid_conv.cu``) on a CUDA tensor and their plain
PyTorch versions on a CPU tensor; nothing falls back.  Launches are counted
in ``<wrapper>.launches``.  The kernels' tiles, threads, shared memory and
blocks come from ``conv2d_tiling`` and ``conv3d_tiling`` (cached per
shape): a halo tile of the grid in shared memory and register tiles of
cells x output channels for the forwards; blocks over (batch member, tile)
units, register tiles of 4 fo x 4 fi x 3 taps and a fixed-order second pass
for the weight gradients (no atomics, bit-equal from run to run).  The 3D
forward walks the input channels four at a time, double-buffered with
``cp.async``, so that a block needs 39-69 KB at the classifier's shapes
(the 110.6 KB of weights at F = 32 never sit in one block).  The conv's input gradient is the
forward kernel itself on the cotangent with ``transpose_weight``'s weights
and a zero bias (``grid_conv_vjp``); the autograd Function around it is in
``nn/grouped_conv.py``.
"""

import collections
import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.ops import cuda_build

# shared memory one block of an H100 may opt in to (227 KB)
MAX_SMEM = 232448
# the widest head the kernels take (the fused block keeps 27 F^2 weights
# in one block)
MAX_FEAT = 32
# streaming multiprocessors of an H100 SXM: the tilings aim at about two
# forward blocks and three weight-gradient blocks per SM
SMS = 132
# the kernels' compile-time widths (any other F runs the run-time
# variant, its channels padded to a multiple of 4)
STATIC_FEAT = (4, 8, 16, 32)
# output cells a forward thread keeps along x (csrc: kCX)
CELLS_X = 4
# sums a weight-gradient thread keeps (4 fo x 4 fi x 3 taps) and the most
# threads of its block (csrc: kDwSums, kDwThreads)
DW_SUMS = 48
DW_THREADS = 256


def _check_feat(feat):
    if not 0 < feat <= MAX_FEAT:
        raise ValueError(f"the grid conv kernels take 1 <= F <= {MAX_FEAT}, "
                         f"got {feat}")


def _ceil(a, b):
    return -(-a // b)


def _fo(feat):
    """Output channels a forward thread keeps (csrc: Conv2dFO): 8, or F
    below 8; 4 at a run-time F."""
    return min(feat, 8) if feat in STATIC_FEAT else 4


def _bank_conflict(ys, tx, ty, threads):
    """Worst bank conflict (distinct words in one bank) of a warp's input
    loads in the 2D forward, halo row stride ``ys``: thread t of its fo
    group reads word (t // ty) * CELLS_X * ys + t % ty."""
    per_group = (tx // CELLS_X) * ty
    worst = 0
    for w0 in range(0, threads, 32):
        words = {(t % per_group) // ty * CELLS_X * ys + (t % per_group) % ty
                 for t in range(w0, min(w0 + 32, threads))}
        worst = max(worst, max(collections.Counter(
            word % 32 for word in words).values()))
    return worst


def _default_tile(feat):
    """The 2D kernels' (TX, TY) before any cut: 32 x 32 at F <= 4, 32 x 16
    at F <= 8, 16 x 16 above."""
    return (32, 32) if feat <= 4 else (32, 16) if feat <= 8 else (16, 16)


def conv2d_tiling(sizes, feat, rows, heads):
    """Launch arithmetic of the 2D conv kernels (``csrc/grid_conv.cu``) for
    ``rows`` = B * heads grids of ``sizes`` = (X, Y) with ``feat`` channels.

    Forward: one block per (row, tile of ``tile`` = (TX, TY) output cells);
    ``conv_threads`` = TX / CELLS_X * TY * ``groups`` (groups of ``fo``
    output channels), ``conv_smem`` bytes (weights [9][F][F padded to 4] and
    the halo [F][TX + 2][``ys``]), ``conv_blocks`` in all.  Weight gradient:
    ``dw_blocks`` blocks per head over the (batch member, tile) units,
    ``dw_threads`` = ``dw_quads`` * ``dw_split``, ``dw_smem`` bytes, and
    ``partial_rows`` = ``dw_blocks`` scratch rows of H * F * F * 9 floats.
    The default tile (``_default_tile``) is cut to the grid, then halved
    until the forward has about two blocks per SM.  Cached per shape: the
    wrappers call it at every launch."""
    return dict(_conv2d_tiling(tuple(sizes), feat, rows, heads))


@functools.lru_cache(maxsize=None)
def _conv2d_tiling(sizes, feat, rows, heads):
    _check_feat(feat)
    x, y = sizes
    padded = _ceil(feat, 4) * 4
    fo = _fo(feat)
    groups = padded // fo
    tx, ty = _default_tile(feat)
    tx = min(tx, _ceil(x, CELLS_X) * CELLS_X)
    ty = min(ty, y)

    def n_tiles(tx, ty):
        return _ceil(x, tx) * _ceil(y, ty)
    while rows * n_tiles(tx, ty) < 2 * SMS and max(tx, ty) > 8:
        if tx >= ty:
            tx = _ceil(tx // 2, CELLS_X) * CELLS_X
        else:
            ty = _ceil(ty, 2)
    threads = tx // CELLS_X * ty * groups
    ys = min(range(ty + 2, ty + 34),
             key=lambda ys: (_bank_conflict(ys, tx, ty, threads), ys))
    quads = (padded // 4) ** 2 * 3
    split = max(1, DW_THREADS // quads)
    units = rows // heads * n_tiles(tx, ty)
    per_block = _ceil(units, _ceil(3 * SMS, heads))
    cfg = {
        "tile": (tx, ty), "fo": fo, "groups": groups, "ys": ys,
        "conv_threads": threads,
        "conv_smem": 4 * (9 * feat * padded + feat * (tx + 2) * ys),
        "conv_blocks": rows * n_tiles(tx, ty),
        "dw_quads": quads, "dw_split": split, "dw_threads": quads * split,
        "dw_smem": 4 * max((tx * ty + (tx + 2) * (ty + 2)) * padded,
                           quads * split * DW_SUMS),
        "dw_blocks": _ceil(units, per_block),
    }
    cfg["partial_rows"] = cfg["dw_blocks"]
    assert threads <= 512 and cfg["dw_threads"] <= DW_THREADS
    assert max(cfg["conv_smem"], cfg["dw_smem"]) <= MAX_SMEM
    return cfg


def _phase_conflict(addr):
    """Worst bank conflict of float4 shared-memory loads: ``addr`` [..., 8]
    holds the float4 index each lane of a quarter warp reads (a quarter
    warp is served at once); -> the most distinct float4s that share one
    group of four banks, over all quarter warps."""
    addr = np.asarray(addr).reshape(-1, 8)
    same = addr[:, :, None] == addr[:, None, :]
    first = ~(same & np.tri(8, k=-1, dtype=bool)).any(-1)
    banks = (addr % 8)[:, :, None] == np.arange(8)
    return int((first[:, :, None] & banks).sum(1).max())


def _quarters(lanes):
    """[..., threads] -> [..., quarter warps, 8], the block padded with
    idle lanes (copies of lane 0, which add no new float4) to whole warps."""
    n = lanes.shape[-1]
    pad = -n % 32
    if pad:
        lanes = np.concatenate(
            [lanes, np.repeat(lanes[..., :1], pad, -1)], -1)
    return lanes.reshape(lanes.shape[:-1] + (-1, 8))


def _conv3d_fwd_conflict(zs, tile, threads):
    """Worst bank conflict of the 3D forward's halo loads, z stride ``zs``
    (in float4): thread t of its fo group reads float4
    (xr * CELLS_X * (TY + 2) + ly) * zs + lz."""
    tx, ty, tz = tile
    tl = np.arange(threads) % (tx // CELLS_X * ty * tz)
    lz, ly, xr = tl % tz, tl // tz % ty, tl // (tz * ty)
    return _phase_conflict(_quarters((xr * CELLS_X * (ty + 2) + ly) * zs
                                     + lz))


def _dw_lanes(threads, quads, split):
    """(q, s) of each thread of the 3D weight gradient: the split fastest
    when a warp holds several splits (quads < 32), else the quad."""
    t = np.arange(threads)
    if quads < 32:
        return t // split, t % split
    return t % quads, t // quads


def _conv3d_dw_conflict(tile, feat, slice_quads, split, zs=None, gz=None):
    """Worst bank conflict of the 3D weight gradient's loads at one z of
    every round of rows: the cotangent float4 (row * gz + z) * NA + a, or
    (``zs`` given instead) the input float4 (((x + dx) * (TY + 2) + y + dy)
    * zs + z) * NCS + c; a shift of z moves every lane alike."""
    tx, ty, tz = tile
    na = _ceil(feat, 4)
    quads = 9 * na * slice_quads
    q, s = _dw_lanes(quads * split, quads, split)
    a, c, dxdy = q % na, q // na % slice_quads, q // (na * slice_quads)
    rows = s + split * np.arange(_ceil(tx * ty, split))[:, None]
    # a thread past the last row reads nothing: give it lane 0's address
    live = rows < tx * ty
    if gz is not None:
        addr = rows * gz * na + a
    else:
        addr = ((((rows // ty + dxdy // 3) * (ty + 2) + rows % ty + dxdy % 3)
                 * zs) * slice_quads + c)
    return _phase_conflict(_quarters(np.where(live, addr, addr[:, :1])))


def _default_tile3d(groups):
    """The 3D forward's (TX, TY, TZ) before any cut, by fo groups: 256
    threads (192 at 3 or 6 groups)."""
    return ((4, 8, 32) if groups == 1 else (4, 8, 16) if groups == 2
            else (4, 4, 16) if groups <= 4 else (4, 4, 8))


def conv3d_tiling(sizes, feat, rows, heads):
    """Launch arithmetic of the 3D conv kernels (``csrc/grid_conv.cu``) for
    ``rows`` = B * heads grids of ``sizes`` = (X, Y, Z) with ``feat``
    channels (FP = F rounded up to a multiple of 4).

    Forward: one block per (row, tile of ``tile`` = (TX, TY, TZ) output
    cells), ``conv_threads`` = TX / CELLS_X * TY * TZ * ``groups`` (groups
    of ``fo`` output channels), ``conv_smem`` bytes (two buffers of a
    chunk's weights [27][4][FP] and its halo [TX + 2][TY + 2][``zs``] of
    float4), ``conv_blocks`` in all, ``chunks`` = FP / 4 passes, and
    ``pack_floats`` of scratch for the packed weights.  Weight gradient:
    blocks (j, h, slice) on ``dw_tile`` tiles with halo z stride ``dw_zs``
    and cotangent z stride ``dw_gz`` (both in cells, padded against bank
    conflicts): ``dw_blocks`` (NB) per head and slice of ``dw_slice_quads``
    input-channel quads (``dw_slices`` slices), ``dw_threads`` =
    ``dw_quads`` * ``dw_split``, ``dw_smem`` bytes, and ``partial_rows`` =
    NB scratch rows of H * 27 * F * F floats.  The default tiles are cut to
    the grid, the forward's then halved until it has about two blocks per
    SM; NB gives about three weight-gradient blocks per SM.  Cached per
    shape: the wrappers call it at every launch."""
    return dict(_conv3d_tiling(tuple(sizes), feat, rows, heads))


@functools.lru_cache(maxsize=None)
def _conv3d_tiling(sizes, feat, rows, heads):
    _check_feat(feat)
    x, y, z = sizes
    padded = _ceil(feat, 4) * 4
    na = padded // 4
    fo = _fo(feat)
    groups = padded // fo
    tx, ty, tz = _default_tile3d(groups)
    tx = min(tx, _ceil(x, CELLS_X) * CELLS_X)
    ty, tz = min(ty, y), min(tz, z)

    def n_tiles(tile):
        return int(np.prod([_ceil(n, t) for n, t in zip(sizes, tile)]))
    while rows * n_tiles((tx, ty, tz)) < 2 * SMS and ty * tz > 16:
        if tz >= ty:
            tz = _ceil(tz, 2)
        else:
            ty = _ceil(ty, 2)
    tile = (tx, ty, tz)
    threads = tx // CELLS_X * ty * tz * groups
    zs = min(range(tz + 2, tz + 10),
             key=lambda zs: (_conv3d_fwd_conflict(zs, tile, threads), zs))
    # weight gradient: the widest input-channel slice that keeps the
    # block's quads (9 (dx, dy) x NA fo quads x slice quads) within
    # DW_THREADS, and the split over the tile's (x, y) rows that wastes
    # the fewest thread-rounds (a multiple of 8 where it runs fastest)
    ncs = max(d for d in range(1, na + 1)
              if na % d == 0 and 9 * na * d <= DW_THREADS)
    quads = 9 * na * ncs
    dw_tile = tuple(min(t, n) for t, n in zip(
        (4, 8, 16) if padded <= 4 else (4, 4, 16) if padded <= 8
        else (4, 4, 8), sizes))
    dtx, dty, dtz = dw_tile
    split = min((s for s in range(1, DW_THREADS // quads + 1)
                 if quads >= 32 or s % 8 == 0),
                key=lambda s: (_ceil(dtx * dty, s) * s, -s))
    dw_zs = min(range(dtz + 2, dtz + 10), key=lambda zs: (
        _conv3d_dw_conflict(dw_tile, feat, ncs, split, zs=zs), zs))
    dw_gz = min(range(dtz, dtz + 8), key=lambda gz: (
        _conv3d_dw_conflict(dw_tile, feat, ncs, split, gz=gz), gz))
    units = rows // heads * n_tiles(dw_tile)
    slices = na // ncs
    per_block = _ceil(units, _ceil(3 * SMS, heads * slices))
    stage = (dtx * dty * dw_gz * padded
             + (dtx + 2) * (dty + 2) * dw_zs * 4 * ncs)
    cfg = {
        "tile": tile, "fo": fo, "groups": groups, "zs": zs,
        "conv_threads": threads,
        "conv_smem": 4 * 2 * (108 * padded
                              + (tx + 2) * (ty + 2) * zs * 4),
        "conv_blocks": rows * n_tiles(tile), "chunks": na,
        "pack_floats": heads * 27 * padded * padded,
        "dw_tile": dw_tile, "dw_zs": dw_zs, "dw_gz": dw_gz,
        "dw_slice_quads": ncs,
        "dw_slices": slices, "dw_quads": quads, "dw_split": split,
        "dw_threads": quads * split,
        "dw_smem": 4 * max(2 * stage, quads * split * DW_SUMS),
        "dw_blocks": _ceil(units, per_block),
    }
    cfg["partial_rows"] = cfg["dw_blocks"]
    assert threads <= 256 and cfg["dw_threads"] <= DW_THREADS
    assert max(cfg["conv_smem"], cfg["dw_smem"]) <= MAX_SMEM
    return cfg


def kernel_config(feat, dim):
    """Launch shape of the kernels for heads of ``feat`` features on
    ``dim``-D grids: {"conv_smem": bytes of the forward's shared memory,
    "dw_split": S, "dw_threads": threads of the weight gradient's blocks,
    "dw_smem": bytes}, those of ``conv2d_tiling`` or ``conv3d_tiling`` for
    a grid of the default forward tile, which they need not cut.  Raises
    for an F the kernels do not take (F > 32); the fused block calls it for
    that check."""
    _check_feat(feat)
    if dim == 2:
        cfg = conv2d_tiling(_default_tile(feat), feat, 2 * SMS, 1)
    else:
        groups = _ceil(feat, 4) * 4 // _fo(feat)
        cfg = conv3d_tiling(_default_tile3d(groups), feat, 2 * SMS, 1)
    return {k: cfg[k] for k in ("conv_smem", "dw_split", "dw_threads",
                                "dw_smem")}


def _check(grid, sizes, heads, **others):
    """Raise unless ``grid`` is float32 [R, prod(sizes), F] for 2D or 3D
    ``sizes``, with R a multiple of ``heads``, and every other tensor
    (``weight``, ``bias``, or a cotangent ``g`` of the grid's shape) is
    float32 of its shape on the same device."""
    if len(sizes) not in (2, 3):
        raise ValueError(f"the grid conv kernels take 2D or 3D sizes, got "
                         f"{sizes}")
    r, _, f = grid.shape
    cells = 1
    for s in sizes:
        cells *= s
    shapes = {"grid": (r, cells, f), "g": (r, cells, f),
              "weight": (heads * f, f) + (3,) * len(sizes),
              "bias": (heads * f,)}
    for name, t in dict(grid=grid, **others).items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shapes[name]
                or t.device != grid.device):
            raise ValueError(f"{name}: expected float32 {shapes[name]} on "
                             f"{grid.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if r % heads:
        raise ValueError(f"rows {r} not a multiple of heads {heads}")


def _taps(sizes):
    """(tap index, offsets per axis) in the weight's tap order."""
    return enumerate(itertools.product(range(3), repeat=len(sizes)))


def _shifted(padded, offs, sizes):
    """The window of a grid padded by one cell on each side that lines up
    with the output cells for tap offsets ``offs``."""
    return padded[(slice(None), slice(None))
                  + tuple(slice(o, o + s) for o, s in zip(offs, sizes))]


def _padded(grid, sizes, heads):
    r, _, f = grid.shape
    return F.pad(grid.reshape((r // heads, heads) + tuple(sizes) + (f,)),
                 (0, 0) + (1, 1) * len(sizes))


def grid_conv_plain(grid, weight, bias, sizes, heads):
    """Plain version of both convs: the 3^dim taps as per-head [F, F]
    products over a zero-padded copy of the grid."""
    r, _, f = grid.shape
    g = _padded(grid, sizes, heads)
    w = weight.reshape(heads, f, f, -1)                  # [h, fo, fi, tap]
    acc = torch.zeros((r // heads, heads) + tuple(sizes) + (f,),
                      dtype=grid.dtype, device=grid.device)
    for tap, offs in _taps(sizes):
        acc += torch.einsum("bh...i,hoi->bh...o", _shifted(g, offs, sizes),
                            w[..., tap])
    out = acc + bias.reshape((1, heads) + (1,) * len(sizes) + (f,))
    return out.reshape(r, -1, f)


def _conv(wrapper, entry, grid, weight, bias, sizes, heads):
    _check(grid, sizes, heads, weight=weight, bias=bias)
    if not grid.is_cuda:
        return grid_conv_plain(grid, weight, bias, sizes, heads)
    r, _, f = grid.shape
    args = [a.contiguous() for a in (grid, weight, bias)]
    out = torch.empty_like(args[0])
    if len(sizes) == 2:
        cfg = conv2d_tiling(sizes, f, r, heads)
        scratch = ()
        launch = (*cfg["tile"], cfg["ys"], cfg["conv_threads"],
                  cfg["conv_smem"])
    else:
        # the weights packed by chunks of four input channels
        cfg = conv3d_tiling(sizes, f, r, heads)
        wpack = torch.empty(cfg["pack_floats"], dtype=torch.float32,
                            device=grid.device)
        scratch = (wpack.data_ptr(),)
        launch = (*cfg["tile"], cfg["zs"], cfg["conv_threads"],
                  cfg["conv_smem"])
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = getattr(lib, entry)(*(a.data_ptr() for a in args), out.data_ptr(),
                              *scratch, r, heads, *sizes, f, *launch, stream)
    cuda_build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def _need_dim(sizes, dim, what):
    if len(sizes) != dim:
        raise ValueError(f"{what} takes {dim}D sizes, got {sizes}")


def grid_conv3d(grid, weight, bias, sizes, heads):
    """Grouped 'same' 3x3x3 conv + bias: [R, G, F] -> [R, G, F] f32."""
    _need_dim(sizes, 3, "grid_conv3d")
    return _conv(grid_conv3d, "ct_grid_conv3d", grid, weight, bias, sizes,
                 heads)


def grid_conv2d(grid, weight, bias, sizes, heads):
    """Grouped 'same' 3x3 conv + bias: [R, G, F] -> [R, G, F] f32."""
    _need_dim(sizes, 2, "grid_conv2d")
    return _conv(grid_conv2d, "ct_grid_conv2d", grid, weight, bias, sizes,
                 heads)


grid_conv3d.launches = 0
grid_conv2d.launches = 0


def grid_conv(grid, weight, bias, sizes, heads):
    """The conv kernel of the grid's dimension."""
    return (grid_conv2d if len(sizes) == 2 else grid_conv3d)(
        grid, weight, bias, sizes, heads)


def transpose_weight(weight, heads):
    """Weights of the transposed conv, which maps the output's cotangent to
    the input's: per head, (out, in) swapped and the tap axes flipped.
    [H*F, F, 3, 3(, 3)] -> the same shape."""
    f = weight.shape[1]
    taps = tuple(weight.shape[2:])
    w = weight.reshape((heads, f, f) + taps).transpose(1, 2)
    w = w.flip(tuple(range(3, 3 + len(taps))))
    return w.reshape(weight.shape).contiguous()


# --- weight gradient --------------------------------------------------------

def grid_conv_dw_plain(grid, g, sizes, heads):
    """Plain version of both weight gradients: per tap, the [F, F] product
    of the cotangent with the shifted, zero-padded grid, summed over cells
    and batch members."""
    r, _, f = grid.shape
    gp = _padded(grid, sizes, heads)
    gs = g.reshape((r // heads, heads) + tuple(sizes) + (f,))
    taps = [torch.einsum("bh...i,bh...o->hoi", _shifted(gp, offs, sizes), gs)
            for _, offs in _taps(sizes)]
    return torch.stack(taps, -1).reshape((heads * f, f) + (3,) * len(sizes))


def _dw(wrapper, entry, grid, g, sizes, heads):
    _check(grid, sizes, heads, g=g)
    if not grid.is_cuda:
        return grid_conv_dw_plain(grid, g, sizes, heads)
    r, _, f = grid.shape
    # one scratch row per block of a head (and input-channel slice in 3D,
    # the slices writing disjoint parts of a row)
    if len(sizes) == 2:
        cfg = conv2d_tiling(sizes, f, r, heads)
        launch = (*cfg["tile"], cfg["partial_rows"], cfg["dw_threads"],
                  cfg["dw_smem"])
    else:
        cfg = conv3d_tiling(sizes, f, r, heads)
        launch = (*cfg["dw_tile"], cfg["dw_zs"], cfg["dw_gz"],
                  cfg["dw_slice_quads"], cfg["partial_rows"],
                  cfg["dw_threads"], cfg["dw_smem"])
    rows = cfg["partial_rows"]
    args = [a.contiguous() for a in (grid, g)]
    partial = torch.empty(rows, heads, f, f, 3 ** len(sizes),
                          dtype=torch.float32, device=grid.device)
    d_weight = torch.empty((heads * f, f) + (3,) * len(sizes),
                           dtype=torch.float32, device=grid.device)
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = getattr(lib, entry)(*(a.data_ptr() for a in args),
                              partial.data_ptr(), d_weight.data_ptr(), r,
                              heads, *sizes, f, *launch, stream)
    cuda_build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return d_weight


def grid_conv3d_dw(grid, g, sizes, heads):
    """Weight gradient of ``grid_conv3d`` for the output cotangent ``g``
    [R, G, F]: ``dW[h*F + fo, fi, dx, dy, dz] = sum over b and cells of
    grid[b*H + h, cell + tap, fi] * g[b*H + h, cell, fo]``, taps outside the
    grid adding nothing.  -> [H*F, F, 3, 3, 3] f32, the parameter layout."""
    _need_dim(sizes, 3, "grid_conv3d_dw")
    return _dw(grid_conv3d_dw, "ct_grid_conv3d_dw", grid, g, sizes, heads)


def grid_conv2d_dw(grid, g, sizes, heads):
    """Weight gradient of ``grid_conv2d``, as ``grid_conv3d_dw`` with 9
    taps.  -> [H*F, F, 3, 3] f32, the parameter layout."""
    _need_dim(sizes, 2, "grid_conv2d_dw")
    return _dw(grid_conv2d_dw, "ct_grid_conv2d_dw", grid, g, sizes, heads)


grid_conv3d_dw.launches = 0
grid_conv2d_dw.launches = 0


def grid_conv_vjp(grid, weight, g, sizes, heads):
    """Gradients of ``grid_conv`` for the output cotangent ``g``:
    (d_grid, d_weight, d_bias).  d_grid is the forward kernel on ``g`` with
    the transposed weights and a zero bias, d_weight the weight-gradient
    kernel, d_bias a plain sum of ``g``, outside any kernel as in the JAX
    package."""
    f = grid.shape[-1]
    g = g.contiguous()
    d_grid = grid_conv(g, transpose_weight(weight, heads),
                       weight.new_zeros(weight.shape[0]), sizes, heads)
    d_weight = (grid_conv2d_dw if len(sizes) == 2 else grid_conv3d_dw)(
        grid, g, sizes, heads)
    d_bias = g.reshape(-1, heads, g.shape[1], f).sum((0, 2)).reshape(-1)
    return d_grid, d_weight, d_bias
