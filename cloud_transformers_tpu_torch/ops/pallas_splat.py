"""Splat-max and Slice on flat per-(batch, head) grids, forward and backward,
with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_splat.py``
(``pallas_splat`` op='max', with and without ``with_winner``,
``pallas_slice``, ``pallas_splat_bwd`` in winner mode,
``pallas_splat_bwd_routed``, ``pallas_slice_bwd``).  Grids are flat
``[R = B*H, G, F]`` with cells in row-major (x, y[, z]) order and F
contiguous (the JAX package's ``kernel_to_flat`` layout); the TPU's
``[R, X*F_pad, lanes]`` layout exists for its vector unit and is not
copied.

Point mappings are the JAX package's: ``x0``/``lane0`` ``[R, K]`` int32 base
cell (lane = y, or y*Z + z), ``w_lo``/``w_hi`` ``[R, K, 4]`` f32 vertex
weights for rows x0 and x0+1 at lane offsets ``lane_offsets(sizes)``
(2D carries zero weights in slots 2 and 3).

Each wrapper runs its CUDA kernel (``csrc/splat_slice.cu``) on a CUDA tensor
and its plain PyTorch version on a CPU tensor; nothing falls back.  The
wrappers count their kernel launches in ``<wrapper>.launches`` (one per
wrapper call that reaches the card, whatever number of passes it takes).
The autograd Functions that join forward and backward are in
``core/splat_slice.py``.
"""

import collections
import functools

import torch

from cloud_transformers_tpu_torch.ops import cuda_build

# the winner map's "no point won this cell": larger than any point index
NO_WINNER = 2 ** 31 - 1
# threads of a slice block (csrc: kSliceThreads)
SLICE_THREADS = 256
# threads of a splat backward block (csrc: kBwdThreads)
BWD_THREADS = 256
# the splat's blocks (csrc: kSplatThreads, kSlabWords, kFillBlocks,
# kMinChunk, kScanPoints): threads, grid words held in shared memory (40
# KiB), blocks that fill the card (132 SMs x 3), the points for each
# chunk, and the points a block lists at one go
SPLAT_THREADS = 256
SLAB_WORDS = 10236
SPLAT_FILL_BLOCKS = 132 * 3
SPLAT_MIN_CHUNK = 256
SPLAT_SCAN_POINTS = 2048
# threads a slice launch should have in flight (132 SMs x 16 warps) before a
# thread takes more points
SLICE_FILL_THREADS = 132 * 512
# the slice kernel's index arithmetic is 32-bit
INDEX_LIMIT = 2 ** 31
# the integers ct_slice takes by address, in order
SLICE_PARAMS = ("rows", "points", "feat", "cells", "lane_extent", "off2",
                "off3", "n_vert", "group", "points_per_thread", "threads",
                "blocks", "vec")
SlicePlan = collections.namedtuple("SlicePlan", (
    "group", "quads", "points_per_thread", "threads", "blocks",
    "points_per_block", "vec"))
# the splat backward's: its routing pass's, and its winner pass's lanes a
# point, blocks and layout; the entry points take SLICE_PARAMS and these
BwdPlan = collections.namedtuple(
    "BwdPlan", SlicePlan._fields + ("winner_group", "winner_blocks",
                                    "winner_features"))
BWD_PARAMS = SLICE_PARAMS + ("winner_group", "winner_blocks",
                             "winner_features")
# contributions a grid cell gets on average (points x 2^dim / cells) below
# which the winner pass goes feature-major (csrc: bwd_plan_ok)
WINNER_DENSE = 16
# the splat's slabs and chunks; the integers ct_splat_max takes by address
SplatPlan = collections.namedtuple("SplatPlan", (
    "group", "threads", "slabs", "slab_words", "chunks", "chunk", "blocks",
    "vec"))
SPLAT_PARAMS = SLICE_PARAMS[:8] + SplatPlan._fields
# the slice backward's d_grid blocks (csrc: kSbSlabWords, kSbFillBlocks):
# the words of d_grid a block sums in shared memory (64-bit each), and
# the blocks that fill the card
SLICE_BWD_SLAB_WORDS = 4992
SLICE_BWD_FILL_BLOCKS = 132 * 3
# the slice backward's two launches; the integers ct_slice_bwd takes by
# address
SliceBwdPlan = collections.namedtuple("SliceBwdPlan", (
    "group", "threads", "slab_words", "slabs", "blocks",
    "points_per_thread", "dw_blocks", "vec"))
SLICE_BWD_PARAMS = SLICE_PARAMS[:8] + SliceBwdPlan._fields


def vertex_decomposition(keys_scaled, sizes):
    """Per-point base cell + per-vertex weights.

    keys_scaled [..., dim] continuous grid coords in [0, size_d - 1] ->
    (x0 [...], lane0 [...] int32, w_lo [..., 4], w_hi [..., 4] f32), with
    the same f32 operation order as the JAX package."""
    dim = len(sizes)
    floored = torch.floor(keys_scaled)
    frac = keys_scaled - floored
    base = floored.to(torch.int32)
    fx = frac[..., 0]
    fy = frac[..., 1]
    x0 = base[..., 0]
    if dim == 2:
        lane0 = base[..., 1]
        zeros = torch.zeros_like(fx)
        w_lo = torch.stack([(1 - fx) * (1 - fy), (1 - fx) * fy,
                            zeros, zeros], -1)
        w_hi = torch.stack([fx * (1 - fy), fx * fy, zeros, zeros], -1)
    else:
        fz = frac[..., 2]
        lane0 = base[..., 1] * sizes[2] + base[..., 2]
        w_lo = torch.stack([
            (1 - fx) * (1 - fy) * (1 - fz),
            (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz),
            (1 - fx) * fy * fz,
        ], -1)
        w_hi = torch.stack([
            fx * (1 - fy) * (1 - fz),
            fx * (1 - fy) * fz,
            fx * fy * (1 - fz),
            fx * fy * fz,
        ], -1)
    return x0, lane0.to(torch.int32), w_lo, w_hi


def kernel_grid_dims(sizes):
    """-> (x_dim, lane_extent, cells) of the flat grid layout."""
    lane_extent = 1
    for s in sizes[1:]:
        lane_extent *= int(s)
    return int(sizes[0]), lane_extent, int(sizes[0]) * lane_extent


def lane_offsets(sizes):
    """Lane offsets of the 4 weight slots (2D: last two carry 0 weight)."""
    if len(sizes) == 2:
        return (0, 1, 0, 1)
    return (0, 1, sizes[2], sizes[2] + 1)


def vertex_index_weights(x0, lane0, w_lo, w_hi, sizes):
    """-> (flat cell index [..., 8] int64, weights [..., 8]), lo row first."""
    _, lane_extent, _ = kernel_grid_dims(sizes)
    offs = torch.tensor(lane_offsets(sizes), dtype=torch.int64,
                        device=x0.device)
    lo = (x0.long() * lane_extent + lane0.long())[..., None] + offs
    return (torch.cat([lo, lo + lane_extent], -1),
            torch.cat([w_lo, w_hi], -1))


def _check_mapping(x0, lane0, w_lo, w_hi, sizes, *data):
    """Raise unless the mapping is [R, K] int32 / [R, K, 4] float32 and
    every ``(name, tensor, shape)`` of ``data`` (values, grids, cotangents)
    is float32 of that shape, all on one device."""
    if len(sizes) not in (2, 3):
        raise ValueError(f"sizes must be 2D or 3D, got {sizes}")
    r, k = x0.shape
    dev = x0.device
    i32, f32 = torch.int32, torch.float32
    for n, t, dtype, shape in (("x0", x0, i32, (r, k)),
                               ("lane0", lane0, i32, (r, k)),
                               ("w_lo", w_lo, f32, (r, k, 4)),
                               ("w_hi", w_hi, f32, (r, k, 4)),
                               *((name, t, f32, shape)
                                 for name, t, shape in data)):
        # dtypes are singletons; a torch.Size compares with a tuple
        if t.dtype is not dtype or t.shape != shape or t.device != dev:
            raise ValueError(f"{n}: expected {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_args(sizes, k, f):
    _, lane_extent, cells = kernel_grid_dims(sizes)
    offs = lane_offsets(sizes)
    n_vert = 2 if len(sizes) == 2 else 4
    return [k, f, cells, lane_extent, offs[2], offs[3], n_vert]


# --- splat-max ------------------------------------------------------------

def splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes):
    """Plain version: expand the 8 weighted copies and scatter-max them into
    a zero grid (``w * v`` in f32, exactly as the kernel and JAX)."""
    r, k, f = values.shape
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)  # [R, K, 8]
    pre = w[..., None] * values[:, :, None, :]                   # [R,K,8,F]
    grid = torch.zeros(r, kernel_grid_dims(sizes)[2], f,
                       dtype=values.dtype, device=values.device)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f)
    return grid.scatter_reduce_(1, index, pre.reshape(r, k * 8, f), "amax",
                                include_self=True)


def splat_plan(rows, points, feat, sizes):
    """Launch arithmetic of the splat (``splat_slab_kernel`` in
    ``csrc/splat_slice.cu``).  A row's grid, its G * F words, is cut into
    ``slabs`` even slabs of ``slab_words`` (a multiple of 4, at most
    ``SLAB_WORDS``: shared memory), and its points into ``chunks`` of
    ``chunk``: as many as it takes for ``SPLAT_FILL_BLOCKS`` blocks, and
    no more than one for each ``SPLAT_MIN_CHUNK`` points.  One block of
    ``threads`` for each (row, slab, chunk), ``blocks`` in all, block b
    taking chunk b % chunks, slab b // chunks % slabs, row
    b // (chunks * slabs).  A listed point takes ``group`` lanes of
    feature quads (the next power of two >= ceil(F / 4), at most 8, as in
    ``slice_plan``), its values read as float4 where ``vec``.  With one
    chunk a row each block writes its slab whole; with several, the grid
    must arrive zero-filled.  Raises where an index of the points or of
    the grid reaches 2^31.  Cached per shape, as are the entry point's
    integers built from it (``_splat_params``, in ``SPLAT_PARAMS``
    order)."""
    return _splat_plan(rows, points, feat, tuple(sizes))


def _quad_group(feat):
    """Lanes of feature quads: the next power of two >= ceil(F / 4), at
    most 8."""
    group = 1
    while group < -(-feat // 4) and group < 8:
        group *= 2
    return group


def _check_index_limit(what, rows, points, feat, sizes):
    cells = kernel_grid_dims(sizes)[2]
    if rows * points * feat >= INDEX_LIMIT or \
            rows * cells * feat >= INDEX_LIMIT:
        raise ValueError(
            f"{what}: {rows} x {points} points or {rows} x {cells} "
            f"cells of {feat} features reach the 2^31 index limit")


@functools.lru_cache(maxsize=None)
def _splat_plan(rows, points, feat, sizes):
    _check_index_limit("splat_max", rows, points, feat, sizes)
    words = kernel_grid_dims(sizes)[2] * feat
    slab = -(-words // -(-words // SLAB_WORDS))      # even slabs
    slab = -(-slab // 4) * 4
    slabs = -(-words // slab)
    chunks = max(1, min(-(-SPLAT_FILL_BLOCKS // (rows * slabs)),
                        -(-points // SPLAT_MIN_CHUNK)))
    chunk = -(-points // chunks)
    chunks = -(-points // chunk)
    return SplatPlan(group=_quad_group(feat), threads=SPLAT_THREADS,
                     slabs=slabs, slab_words=slab, chunks=chunks,
                     chunk=chunk, blocks=rows * slabs * chunks,
                     vec=feat % 4 == 0)


@functools.lru_cache(maxsize=None)
def _splat_params(rows, points, feat, sizes):
    """``ct_splat_max``'s integers for one shape (``SPLAT_PARAMS``), as
    ``cuda_build.int_params``; the cache keeps the array alive."""
    plan = _splat_plan(rows, points, feat, sizes)
    return cuda_build.int_params(rows, *_launch_args(sizes, points, feat),
                                 *plan[:-1], int(plan.vec))


def winners_in_splat(plan):
    """Whether ``splat_max_winner`` records the winners in its splat kernel
    (each block its row's only chunk, listing its points at one go) rather
    than in the winner pass after it."""
    return plan.chunks == 1 and plan.chunk <= SPLAT_SCAN_POINTS


def _splat_grid(rows, points, feat, sizes, device):
    """The grid the splat kernel writes into: zero-filled where several
    chunks raise it by atomics, else left as it comes (each block writes
    its slab whole)."""
    shape = (rows, kernel_grid_dims(sizes)[2], feat)
    if _splat_plan(rows, points, feat, sizes).chunks > 1:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.empty(shape, dtype=torch.float32, device=device)


def splat_max(x0, lane0, w_lo, w_hi, values, sizes):
    """grid[r, cell, f] = max(0, max over the (k, v) mapping to cell of
    w[r, k, v] * values[r, k, f]).  -> [R, G, F] f32."""
    r, k = x0.shape
    f = values.shape[-1]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes,
                   ("values", values, (r, k, f)))
    if not values.is_cuda:
        return splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes)
    sizes = tuple(sizes)
    if r * k * f == 0:   # nothing to splat: no kernel
        return torch.zeros(r, kernel_grid_dims(sizes)[2], f,
                           device=values.device)
    params = _splat_params(r, k, f, sizes)[1]
    kept, ptrs = _point_inputs(x0, lane0, w_lo, w_hi, values)
    dev = values.device
    grid = _splat_grid(r, k, f, sizes, dev)
    err = cuda_build.libraries()["splat_slice"].ct_splat_max(
        *ptrs, grid.data_ptr(), params, cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "splat_max")
    splat_max.launches += 1
    return grid


splat_max.launches = 0


def splat_max_winner_plain(x0, lane0, w_lo, w_hi, values, sizes):
    """Plain version: ``splat_max_plain``, then ``splat_winner_plain`` on
    its grid."""
    grid = splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes)
    return grid, splat_winner_plain(x0, lane0, w_lo, w_hi, values, grid,
                                    sizes)


def splat_max_winner(x0, lane0, w_lo, w_hi, values, sizes):
    """``splat_max`` that also records, for every (cell, feature), the
    lowest point index whose contribution is the maximum (``NO_WINNER``
    where no contribution is positive): the splat backward's winner map,
    made in the forward so that the backward is ``splat_route`` alone.
    One entry point: the splat on ``splat_plan``, which also fills the
    map with ``NO_WINNER`` and, where each of its blocks is its row's only
    chunk and lists its points at one go, records the winners itself;
    else the splat backward's winner pass follows on ``splat_bwd_plan``.
    No Python wrapper of either runs, so their counters do not move.
    -> (grid [R, G, F] f32, bit-equal to ``splat_max``'s; winner [R, G, F]
    int32, equal to ``splat_winner_plain``'s)."""
    r, k = x0.shape
    f = values.shape[-1]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes,
                   ("values", values, (r, k, f)))
    if not values.is_cuda:
        return splat_max_winner_plain(x0, lane0, w_lo, w_hi, values, sizes)
    sizes = tuple(sizes)
    if r * k * f == 0:   # nothing to splat: no kernel
        shape = (r, kernel_grid_dims(sizes)[2], f)
        return (torch.zeros(shape, device=values.device),
                torch.full(shape, NO_WINNER, dtype=torch.int32,
                           device=values.device))
    params = _splat_params(r, k, f, sizes)[1]
    bwd_params = _splat_bwd_params(r, k, f, sizes)[1]
    kept, ptrs = _point_inputs(x0, lane0, w_lo, w_hi, values)
    dev = values.device
    grid = _splat_grid(r, k, f, sizes, dev)
    # filled with NO_WINNER by the splat kernel, before the winner pass
    winner = torch.empty(grid.shape, dtype=torch.int32, device=dev)
    err = cuda_build.libraries()["splat_slice"].ct_splat_max_winner(
        *ptrs, grid.data_ptr(), winner.data_ptr(), params, bwd_params,
        cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "splat_max_winner")
    splat_max_winner.launches += 1
    return grid, winner


splat_max_winner.launches = 0


# --- slice ------------------------------------------------------------------

def slice_plain(x0, lane0, w_lo, w_hi, grid, sizes):
    """Plain version: gather the 8 vertex rows and sum them weighted."""
    r, k = x0.shape
    f = grid.shape[-1]
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f)
    gathered = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    return (gathered * w[..., None]).sum(2)


def slice_plan(rows, points, feat, sizes):
    """Launch arithmetic of the slice kernel (``csrc/splat_slice.cu``) for
    ``rows`` grids of ``sizes`` with ``feat`` features and ``points`` points
    a row.  A point takes ``group`` lanes (the next power of two >=
    ``quads`` = ceil(feat / 4), at most 8), each lane a quad of features
    (quads q = lane, lane + group, ...); a thread takes
    ``points_per_thread`` points (4 in 2D, 2 in 3D, halved while the launch
    would have fewer than ``SLICE_FILL_THREADS`` threads), ``threads`` a
    block, ``blocks`` blocks; ``vec`` where rows are read as float4.  Thread
    t of block b serves the points b * per_block + i * (threads / group) +
    t // group for i < points_per_thread.  Raises where an index of the
    output or of the grid reaches 2^31.  Cached per shape, as are the
    entry point's integers built from it (``_slice_params``)."""
    return _slice_plan(rows, points, feat, tuple(sizes))


@functools.lru_cache(maxsize=None)
def _slice_plan(rows, points, feat, sizes):
    return _point_major_plan("slice_gather", rows, points, feat, sizes,
                             4 if len(sizes) == 2 else 2, SLICE_THREADS)


def _point_major_plan(what, rows, points, feat, sizes, per_thread, threads):
    """The lane groups, points a thread and blocks of a point-major kernel
    (``slice_kernel``, the splat backward's two passes): ``per_thread``
    points a thread at most, halved while the launch would have fewer than
    ``SLICE_FILL_THREADS`` threads."""
    _check_index_limit(what, rows, points, feat, sizes)
    n = rows * points
    quads = -(-feat // 4)
    group = _quad_group(feat)
    while per_thread > 1 and n * group < SLICE_FILL_THREADS * per_thread:
        per_thread //= 2
    per_block = per_thread * (threads // group)
    return SlicePlan(group=group, quads=quads, points_per_thread=per_thread,
                     threads=threads, blocks=-(-n // per_block),
                     points_per_block=per_block, vec=feat % 4 == 0)


@functools.lru_cache(maxsize=None)
def _slice_params(rows, points, feat, sizes):
    """``ct_slice``'s integers for one shape (``SLICE_PARAMS``), as
    ``cuda_build.int_params``.  The cache keeps the array alive."""
    plan = _slice_plan(rows, points, feat, sizes)
    return cuda_build.int_params(
        rows, *_launch_args(sizes, points, feat), plan.group,
        plan.points_per_thread, plan.threads, plan.blocks, int(plan.vec))


def _aligned_ptr(t):
    """(``t`` itself where it starts on 16 bytes, else an aligned copy,
    its address)."""
    p = t.data_ptr()
    if p % 16:
        t = t.clone()
        p = t.data_ptr()
    return t, p


def slice_gather(x0, lane0, w_lo, w_hi, grid, sizes):
    """out[r, k, f] = sum over v of w[r, k, v] * grid[r, idx(r, k, v), f].
    -> [R, K, F] f32."""
    r, k = x0.shape
    f = grid.shape[-1]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes,
                   ("grid", grid, (r, kernel_grid_dims(sizes)[2], f)))
    if not grid.is_cuda:
        return slice_plain(x0, lane0, w_lo, w_hi, grid, sizes)
    # the wrapper's host cost is about the kernel's device time at the
    # classifier's shapes, so it makes no call it can spare
    params = _slice_params(r, k, f, tuple(sizes))[1]
    x0, lane0 = x0.contiguous(), lane0.contiguous()
    w_lo, p_lo = _aligned_ptr(w_lo.contiguous())
    w_hi, p_hi = _aligned_ptr(w_hi.contiguous())
    grid, p_grid = _aligned_ptr(grid.contiguous())
    dev = grid.device
    out = torch.empty((r, k, f), dtype=torch.float32, device=dev)
    err = cuda_build.libraries()["splat_slice"].ct_slice(
        x0.data_ptr(), lane0.data_ptr(), p_lo, p_hi, p_grid, out.data_ptr(),
        params, cuda_build.current_stream(dev))
    cuda_build.check(err, "slice_gather")
    slice_gather.launches += 1
    return out


slice_gather.launches = 0


# --- splat-max backward -----------------------------------------------------

def splat_bwd_plan(rows, points, feat, sizes):
    """Launch arithmetic of the splat backward's two passes
    (``splat_winner_kernel`` and ``splat_route_kernel`` in
    ``csrc/splat_slice.cu``), one point a lane group, ``BWD_THREADS`` a
    block.  The routing pass: a point on ``group`` lanes of feature quads
    as in ``slice_plan``, ``blocks`` blocks.  The winner pass, on a sparse
    grid (fewer than ``WINNER_DENSE`` contributions a cell on average,
    where nearly every contribution wins and the atomics are the cost): a
    point on ``winner_group`` lanes of one feature each (the next power of
    two >= min(F, 32)), so that a warp's atomics on a row are consecutive
    words (``winner_features``); on a denser grid, where the loads are the
    cost, as the routing pass.  ``winner_blocks`` blocks.  Raises where an index of the
    points or of the grid reaches 2^31.  Cached per shape, as are the entry
    points' integers built from it (``_splat_bwd_params``, in
    ``BWD_PARAMS`` order)."""
    return _splat_bwd_plan(rows, points, feat, tuple(sizes))


@functools.lru_cache(maxsize=None)
def _splat_bwd_plan(rows, points, feat, sizes):
    route = _point_major_plan("splat_max_bwd", rows, points, feat, sizes, 1,
                              BWD_THREADS)
    sparse = points * 2 ** len(sizes) < WINNER_DENSE * kernel_grid_dims(
        sizes)[2]
    group = route.group
    if sparse:
        group = 1
        while group < feat and group < 32:
            group *= 2
    return BwdPlan(*route, winner_group=group,
                   winner_blocks=-(-rows * points // (BWD_THREADS // group)),
                   winner_features=sparse)


@functools.lru_cache(maxsize=None)
def _splat_bwd_params(rows, points, feat, sizes):
    """``ct_splat_max_bwd``'s and ``ct_splat_route``'s integers for one
    shape (``BWD_PARAMS``), as ``cuda_build.int_params``; the cache keeps
    the array alive."""
    plan = _splat_bwd_plan(rows, points, feat, sizes)
    return cuda_build.int_params(
        rows, *_launch_args(sizes, points, feat), plan.group,
        plan.points_per_thread, plan.threads, plan.blocks, int(plan.vec),
        plan.winner_group, plan.winner_blocks, int(plan.winner_features))


def _point_inputs(x0, lane0, w_lo, w_hi, *rows):
    """The mapping, then ``rows`` (values, grids, maps, cotangents), as a
    splat or splat backward entry point takes them: contiguous, and 16-byte
    aligned where they are read as float4 (copied where they are not).  ->
    (tensors, their addresses); the caller keeps the tensors until it has
    launched."""
    kept = [x0.contiguous(), lane0.contiguous()]
    ptrs = [t.data_ptr() for t in kept]
    for t in (w_lo, w_hi, *rows):
        t, p = _aligned_ptr(t.contiguous())
        kept.append(t)
        ptrs.append(p)
    return kept, ptrs


def _expanded(x0, lane0, w_lo, w_hi, sizes, f):
    """-> (scatter/gather index [R, K*8, F] int64, weights [R, K, 8])."""
    r, k = x0.shape
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)
    return idx.reshape(r, k * 8, 1).expand(r, k * 8, f), w


def _matches(x0, lane0, w_lo, w_hi, values, grid, sizes):
    """-> (index [R, K*8, F], weights [R, K, 8], match [R, K, 8, F], point
    [1, K, 1, 1]): ``match`` marks the contributions ``w * v`` (one f32
    multiply) that equal ``grid`` at a cell with ``grid > 0``."""
    r, k, f = values.shape
    index, w = _expanded(x0, lane0, w_lo, w_hi, sizes, f)
    contrib = w[..., None] * values[:, :, None, :]               # [R,K,8,F]
    gmax = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    point = torch.arange(k, device=values.device).reshape(1, k, 1, 1)
    return index, w, (contrib == gmax) & (gmax > 0), point


def _winner(index, match, point, shape):
    """int64 winner map: the lowest matching point index per (cell,
    feature), ``NO_WINNER`` where nothing matches."""
    winner = torch.full(shape, NO_WINNER, dtype=torch.int64,
                        device=match.device)
    return winner.scatter_reduce_(
        1, index, torch.where(match, point, NO_WINNER).reshape(index.shape),
        "amin", include_self=True)


def splat_winner_plain(x0, lane0, w_lo, w_hi, values, grid, sizes):
    """Winner map [R, G, F] int32: the lowest point index k whose
    contribution equals ``grid`` at a cell with ``grid > 0``; ``NO_WINNER``
    where there is none."""
    index, _, match, point = _matches(x0, lane0, w_lo, w_hi, values, grid,
                                      sizes)
    return _winner(index, match, point, grid.shape).to(torch.int32)


def _routed(index, w, values, win, g):
    """``dcon = g`` for the contributions in ``win`` [R, K, 8, F] and 0 for
    every other one; -> (d_w_lo, d_w_hi, d_values)."""
    dcon = torch.where(win, torch.gather(g, 1, index).reshape(win.shape),
                       0.0)
    d_w = (dcon * values[:, :, None, :]).sum(-1)                 # [R, K, 8]
    d_values = (dcon * w[..., None]).sum(2)                      # [R, K, F]
    return (d_w[..., :4].contiguous(), d_w[..., 4:].contiguous(), d_values)


def splat_max_bwd_plain(x0, lane0, w_lo, w_hi, values, grid, g, sizes):
    """Plain version: the winner map by a scatter-min of the point index,
    then ``dcon = g`` for the winning contribution of each (cell, feature)
    and 0 for every other one (ties do not share)."""
    index, w, match, point = _matches(x0, lane0, w_lo, w_hi, values, grid,
                                      sizes)
    winner = _winner(index, match, point, grid.shape)
    # the match too: a 2D point's zero-weight slots share cells with its
    # real ones, and must not inherit their win
    win = match & (torch.gather(winner, 1, index).reshape(match.shape)
                   == point)
    return _routed(index, w, values, win, g)


def splat_max_bwd(x0, lane0, w_lo, w_hi, values, grid, g, sizes,
                  return_winner=False):
    """Backward of ``splat_max``: the cotangent ``g`` [R, G, F] goes to the
    lowest-indexed winner of each (cell, feature).
    -> (d_w_lo [R, K, 4], d_w_hi [R, K, 4], d_values [R, K, F]), and the
    int32 winner map [R, G, F] after them with ``return_winner``."""
    r, k = x0.shape
    f = values.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("values", values, (r, k, f)),
                   ("grid", grid, (r, cells, f)), ("g", g, (r, cells, f)))
    if not values.is_cuda:
        out = splat_max_bwd_plain(x0, lane0, w_lo, w_hi, values, grid, g,
                                  sizes)
        if return_winner:
            out += (splat_winner_plain(x0, lane0, w_lo, w_hi, values, grid,
                                       sizes),)
        return out
    params = _splat_bwd_params(r, k, f, tuple(sizes))[1]
    kept, ptrs = _point_inputs(x0, lane0, w_lo, w_hi, values, grid, g)
    dev = values.device
    winner = torch.full((r, cells, f), NO_WINNER, dtype=torch.int32,
                        device=dev)
    d_w_lo = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_w_hi = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_values = torch.empty(r, k, f, dtype=torch.float32, device=dev)
    err = cuda_build.libraries()["splat_slice"].ct_splat_max_bwd(
        *ptrs, winner.data_ptr(), d_w_lo.data_ptr(), d_w_hi.data_ptr(),
        d_values.data_ptr(), params, cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "splat_max_bwd")
    splat_max_bwd.launches += 1
    out = (d_w_lo, d_w_hi, d_values)
    return out + (winner,) if return_winner else out


splat_max_bwd.launches = 0


def splat_route_plain(x0, lane0, w_lo, w_hi, values, winner, g, sizes):
    """Plain version: ``dcon = g`` where the winner map names the point,
    on the mapping's real vertex slots (a 2D point's slots 2 and 3 carry
    zero weight and alias slots 0 and 1)."""
    r, k, f = values.shape
    index, w = _expanded(x0, lane0, w_lo, w_hi, sizes, f)
    point = torch.arange(k, device=values.device).reshape(1, k, 1, 1)
    win = (torch.gather(winner.long(), 1, index).reshape(r, k, 8, f)
           == point)
    if len(sizes) == 2:
        win = win & torch.tensor([1, 1, 0, 0, 1, 1, 0, 0], dtype=torch.bool,
                                 device=win.device)[:, None]
    return _routed(index, w, values, win, g)


def splat_route(x0, lane0, w_lo, w_hi, values, winner, g, sizes):
    """Backward of ``splat_max_winner``: the cotangent ``g`` [R, G, F] goes
    to the point that ``winner`` (int32 [R, G, F]) names, in one read-only
    pass.  -> (d_w_lo [R, K, 4], d_w_hi [R, K, 4], d_values [R, K, F]),
    bit-equal to ``splat_max_bwd``'s for the same winners."""
    r, k = x0.shape
    f = values.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("values", values, (r, k, f)),
                   ("g", g, (r, cells, f)))
    if winner.dtype != torch.int32 or tuple(winner.shape) != (r, cells, f) \
            or winner.device != values.device:
        raise ValueError(f"winner: expected int32 {(r, cells, f)} on "
                         f"{values.device}, got {winner.dtype} "
                         f"{tuple(winner.shape)} on {winner.device}")
    if not values.is_cuda:
        return splat_route_plain(x0, lane0, w_lo, w_hi, values, winner, g,
                                 sizes)
    params = _splat_bwd_params(r, k, f, tuple(sizes))[1]
    kept, ptrs = _point_inputs(x0, lane0, w_lo, w_hi, values, winner, g)
    dev = values.device
    d_w_lo = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_w_hi = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_values = torch.empty(r, k, f, dtype=torch.float32, device=dev)
    err = cuda_build.libraries()["splat_slice"].ct_splat_route(
        *ptrs, d_w_lo.data_ptr(), d_w_hi.data_ptr(), d_values.data_ptr(),
        params, cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "splat_route")
    splat_route.launches += 1
    return d_w_lo, d_w_hi, d_values


splat_route.launches = 0


# --- slice backward ---------------------------------------------------------

def slice_bwd_plain(x0, lane0, w_lo, w_hi, g_pts, grid, sizes):
    """Plain version: scatter-add the weighted point cotangents, and gather
    the vertex rows for the weight gradient."""
    r, k, f = g_pts.shape
    index, w = _expanded(x0, lane0, w_lo, w_hi, sizes, f)
    d_grid = torch.zeros_like(grid).scatter_add_(
        1, index, (w[..., None] * g_pts[:, :, None, :]).reshape(r, k * 8, f))
    gathered = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    d_w = (gathered * g_pts[:, :, None, :]).sum(-1)              # [R, K, 8]
    if len(sizes) == 2:
        # slots 2 and 3 of a 2D mapping are constants, not vertices
        d_w = d_w * d_w.new_tensor([1, 1, 0, 0, 1, 1, 0, 0])
    return d_grid, d_w[..., :4].contiguous(), d_w[..., 4:].contiguous()


def slice_bwd_plan(rows, points, feat, sizes):
    """Launch arithmetic of the slice backward's two kernels
    (``slice_bwd_kernel`` and ``slice_bwd_dw_kernel`` in
    ``csrc/splat_slice.cu``).  d_grid: a row's G * F words are cut into
    ``slabs`` even slabs of ``slab_words`` (a multiple of 4, at most
    ``SLICE_BWD_SLAB_WORDS``: shared memory), the fewest that fit, or more,
    smaller ones where the rows' slabs would not make
    ``SLICE_BWD_FILL_BLOCKS`` blocks; one block of ``threads`` for each
    (row, slab), ``blocks`` in all, block b taking slab b % slabs of row
    b // slabs.  A row is never cut into chunks of points, so that each
    word is one block's sum.  A listed point takes ``group`` lanes of
    feature quads, as in ``slice_plan``.  d_w, launched first:
    ``slice_plan``'s arithmetic (``group``, ``points_per_thread``,
    ``dw_blocks``); each of its blocks also writes a bound on |w| * |g|
    over its points, and a row's d_grid blocks scale their fixed point by
    the bounds of the d_w blocks that cover the row.  ``vec`` where rows
    are read and written as float4.  Raises where an index of the points
    or of the grid reaches 2^31.  Cached per shape, as are the entry
    point's integers built from it (``_slice_bwd_params``, in
    ``SLICE_BWD_PARAMS`` order)."""
    return _slice_bwd_plan(rows, points, feat, tuple(sizes))


@functools.lru_cache(maxsize=None)
def _slice_bwd_plan(rows, points, feat, sizes):
    _check_index_limit("slice_bwd", rows, points, feat, sizes)
    words = kernel_grid_dims(sizes)[2] * feat
    slabs = max(-(-words // SLICE_BWD_SLAB_WORDS),
                min(-(-SLICE_BWD_FILL_BLOCKS // rows), -(-words // 4)))
    slab = -(-words // slabs)                        # even slabs
    slab = -(-slab // 4) * 4
    slabs = -(-words // slab)
    dw = _slice_plan(rows, points, feat, sizes)
    return SliceBwdPlan(group=dw.group, threads=SPLAT_THREADS,
                        slab_words=slab, slabs=slabs, blocks=rows * slabs,
                        points_per_thread=dw.points_per_thread,
                        dw_blocks=dw.blocks, vec=feat % 4 == 0)


@functools.lru_cache(maxsize=None)
def _slice_bwd_params(rows, points, feat, sizes):
    """``ct_slice_bwd``'s integers for one shape (``SLICE_BWD_PARAMS``), as
    ``cuda_build.int_params``; the cache keeps the array alive."""
    plan = _slice_bwd_plan(rows, points, feat, sizes)
    return cuda_build.int_params(rows, *_launch_args(sizes, points, feat),
                                 *plan[:-1], int(plan.vec))


def slice_bwd(x0, lane0, w_lo, w_hi, g_pts, grid, sizes):
    """Backward of ``slice_gather`` for the point cotangent ``g_pts``
    [R, K, F]: ``d_grid[r, idx(r,k,v), f] += w[r,k,v] * g_pts[r,k,f]`` and
    ``d_w[r,k,v] = sum_f grid[r, idx(r,k,v), f] * g_pts[r,k,f]``.
    -> (d_grid [R, G, F], d_w_lo [R, K, 4], d_w_hi [R, K, 4]).  On the card
    two launches on ``slice_bwd_plan``: each d_grid word is summed in 64-bit
    fixed point (a sum that does not depend on its order) and rounded once
    to float32, so d_grid is the same in every run, within 1e-5 of the
    plain version; d_w is summed over the features in a fixed order."""
    r, k = x0.shape
    f = grid.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("g_pts", g_pts, (r, k, f)),
                   ("grid", grid, (r, cells, f)))
    if not grid.is_cuda:
        return slice_bwd_plain(x0, lane0, w_lo, w_hi, g_pts, grid, sizes)
    dev = grid.device
    if r * k * f == 0:   # nothing to scatter: no kernel
        return (torch.zeros(r, cells, f, device=dev),
                torch.zeros(r, k, 4, device=dev),
                torch.zeros(r, k, 4, device=dev))
    sizes = tuple(sizes)
    params = _slice_bwd_params(r, k, f, sizes)[1]
    kept, ptrs = _point_inputs(x0, lane0, w_lo, w_hi, g_pts, grid)
    # every word of the three is written by the kernels
    d_grid = torch.empty(r, cells, f, dtype=torch.float32, device=dev)
    d_w_lo = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_w_hi = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    # the d_w blocks' bounds on |w| * |g|, which scale d_grid's fixed point
    most = torch.empty(_slice_bwd_plan(r, k, f, sizes).dw_blocks,
                       dtype=torch.int32, device=dev)
    err = cuda_build.libraries()["splat_slice"].ct_slice_bwd(
        *ptrs, d_grid.data_ptr(), d_w_lo.data_ptr(), d_w_hi.data_ptr(),
        most.data_ptr(), params, cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "slice_bwd")
    slice_bwd.launches += 1
    return d_grid, d_w_lo, d_w_hi


slice_bwd.launches = 0
