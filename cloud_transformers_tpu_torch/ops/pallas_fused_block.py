"""The fused MHCT block: splat -> grouped 3^dim conv -> slice in one kernel.

Counterpart of ``cloud_transformers_tpu/ops/pallas_fused_block.py``
(``pallas_fused_block``).  Inputs are those of ``ops/pallas_splat.py``
(flat per-(batch, head) rows: ``x0``/``lane0`` [R, K] int32, ``w_lo``/
``w_hi`` [R, K, 4], ``values`` [R, K, F]) and of ``ops/pallas_grid_conv.py``
(``weight`` [H*F, F, 3, 3(, 3)], ``bias`` [H*F]).  Outputs: the points
[R, K, F], the splatted grid ``gk`` [R, G, F] (the stats read it, and the
splat backward routes through it) and, with ``want_gk2``, the convolved
grid ``gk2`` [R, G, F] (the slice backward reads it; serving skips it).

``fused_block`` runs its CUDA kernel (``csrc/fused_block.cu``) on CUDA
tensors and its plain version, the composition of the three plain ops, on
CPU tensors; nothing falls back.  On the card a grid row runs on a
thread-block cluster whose CTAs each own an x-slab of both grids in
shared memory, as ``fused_block_plan`` lays it out (cached per shape; the
C entry point recomputes it and refuses a launch that disagrees).
Launches are counted in ``fused_block.launches``.  The autograd Function
is in ``core/splat_slice.py``.
"""

import collections
import functools

import torch

from cloud_transformers_tpu_torch.ops import cuda_build
from cloud_transformers_tpu_torch.ops.pallas_grid_conv import (
    grid_conv_plain,
    kernel_config,
)
from cloud_transformers_tpu_torch.ops.pallas_splat import (
    INDEX_LIMIT,
    _aligned_ptr,
    _check_mapping,
    kernel_grid_dims,
    slice_plain,
    splat_max_plain,
)

# csrc/fused_block.cu's constants
CLUSTER_THREADS = 512      # kClusterThreads: a cluster CTA's threads (or
#                            half of them)
GLOBAL_THREADS = 1024      # kThreads: the device-memory path's block
FILL_CTAS = 64             # kFillCtas: CTAs a launch should have
MAX_CLUSTER = 16           # kMaxCluster
PORTABLE_CLUSTER = 8       # kPortableCluster: the largest portable size
SMEM_LIMIT = 232448        # kMaxSmem: 227 KB a block can opt in to
SM_SMEM = 233472           # kSmPerSm: 228 KB an SM holds
CTA_RESERVE = 1024         # kCtaReserve: of it kept for each CTA
RUN = 4                    # kRun: conv cells a thread keeps on the run axis
SCAN = 4                   # kScan: points a lane scans at a time
# the integers ct_fused_block takes by address, in order
FUSED_PARAMS = ("rows", "heads", "points", "feat", "x", "y", "z", "dim",
                "want_gk2", "cluster", "slab", "threads", "smem", "blocks",
                "group")
FusedPlan = collections.namedtuple("FusedPlan", (
    "path", "cluster", "slab", "padded", "fp", "threads", "smem",
    "blocks", "group"))


def _ceil(a, b):
    return -(-a // b)


def cluster_shape(sizes, feat, cluster, threads=CLUSTER_THREADS):
    """The cluster path's slab at ``cluster`` CTAs a row: (slab planes SX,
    padded extents (PX, PY, PZ) of gk's slab, FP, shared-memory bytes), or
    None where a CTA would own no plane.  gk's slab is [FP / 4][PX][PY][PZ]
    [4] with a zero cell on every side (planes 0 and SX + 1 hold the
    neighbours' edges) and the run axis padded to a multiple of ``RUN``
    plus 2; gk2's is [SX][Y][Z][FP]; the weights [taps][FP][FP]; then
    ``SCAN`` slots for each of ``threads`` (the points a warp hands out to
    its lanes)."""
    dim = len(sizes)
    x, y, z = (tuple(sizes) + (1,))[:3]
    fp = _ceil(feat, 4) * 4
    slab = _ceil(x, cluster)
    if (cluster - 1) * slab >= x:
        return None
    if dim == 3:
        padded = (slab + 2, _ceil(y, RUN) * RUN + 2, z + 2)
    else:
        padded = (_ceil(slab, RUN) * RUN + 2, y + 2, 1)
    taps = 27 if dim == 3 else 9
    words = (taps * fp * fp + padded[0] * padded[1] * padded[2] * fp
             + slab * y * z * fp + SCAN * threads)
    return slab, padded, fp, 4 * words


def global_smem(sizes, feat):
    """Shared memory of the device-memory path: the weights, and gk (then
    gk2) where they fit beside them."""
    taps = 27 if len(sizes) == 3 else 9
    w = taps * feat * feat * 4
    g = kernel_grid_dims(sizes)[2] * feat * 4
    return w + (w + g <= SMEM_LIMIT) * g + (w + 2 * g <= SMEM_LIMIT) * g


def conv_items(sizes, feat, cluster):
    """The conv's items (a run of ``RUN`` cells x 8 or 4 output channels)
    in a full slab at ``cluster`` CTAs a row."""
    slab, _, fp, _ = cluster_shape(sizes, feat, cluster)
    fo = 8 if fp % 8 == 0 else 4
    if len(sizes) == 3:
        return fp // fo * slab * _ceil(sizes[1], RUN) * sizes[2]
    return fp // fo * _ceil(slab, RUN) * sizes[1]


def _choose_cluster(rows, sizes, feat):
    """-> (cluster size, threads a CTA).  Of the cluster sizes whose slabs
    fit and whose launch has ``FILL_CTAS`` CTAs: the smallest whose CTA
    fits twice in an SM's shared memory and still gives each of its
    threads (``CLUSTER_THREADS``, or half as many) a conv item, at most
    ``PORTABLE_CLUSTER`` CTAs (two CTAs a SM overlap one's splat and slice
    with the other's conv; 16 halve the slabs of the classifier's grids,
    and each CTA scans every point of the row), else the smallest with
    ``CLUSTER_THREADS`` (each CTA zeroes its slab, stages the whole
    weights and scans every point of the row, so fewer CTAs a row cost
    less).  Where no launch has ``FILL_CTAS`` CTAs, the largest that
    fits; 0 where none fits."""
    largest = smallest = 0
    c = 1
    while c <= MAX_CLUSTER and c <= sizes[0]:
        shape = cluster_shape(sizes, feat, c)
        if shape is not None and shape[3] <= SMEM_LIMIT:
            largest = c
            if rows * c >= FILL_CTAS:
                smallest = smallest or c
                for threads in (CLUSTER_THREADS, CLUSTER_THREADS // 2):
                    smem = cluster_shape(sizes, feat, c, threads)[3]
                    if c <= PORTABLE_CLUSTER and \
                            2 * (smem + CTA_RESERVE) <= SM_SMEM and \
                            conv_items(sizes, feat, c) >= threads:
                        return c, threads
        c *= 2
    return smallest or largest, CLUSTER_THREADS


def fused_block_plan(rows, points, feat, sizes):
    """Launch arithmetic of the fused block (``csrc/fused_block.cu``) for
    ``rows`` grid rows of ``sizes`` with ``feat`` features and ``points``
    points a row.  The cluster path: a row on ``cluster`` CTAs (1 to 16,
    as ``_choose_cluster`` picks them); CTA c owns the x planes
    [c * slab, c * slab + slab) of both grids, splats the vertex rows of
    the row's points that lie in its slab and slices the points whose
    lower plane x0 lies there: a point on one lane in the splat, on
    ``group`` lanes of feature quads in the slice.  Where no cluster fits (of
    the head groups' sizes: 32^3 at F >= 9, 128^2 at F >= 21, 16^3 at
    F >= 29), the device-memory path: one block of ``GLOBAL_THREADS`` a
    row.  Raises for F > 32 and where an index reaches 2^31.  Cached per
    shape, as are the entry point's integers (``_fused_params``)."""
    return _fused_plan(rows, points, feat, tuple(sizes))


@functools.lru_cache(maxsize=None)
def _fused_plan(rows, points, feat, sizes):
    kernel_config(feat, len(sizes))
    cells = kernel_grid_dims(sizes)[2]
    if rows * points * feat >= INDEX_LIMIT or \
            rows * cells * feat >= INDEX_LIMIT:
        raise ValueError(
            f"fused_block: {rows} x {points} points or {rows} x {cells} "
            f"cells of {feat} features reach the 2^31 index limit")
    c, threads = _choose_cluster(rows, sizes, feat)
    if c == 0:
        return FusedPlan(path="device_memory", cluster=0, slab=sizes[0],
                         padded=None, fp=feat, threads=GLOBAL_THREADS,
                         smem=global_smem(sizes, feat), blocks=rows, group=1)
    slab, padded, fp, smem = cluster_shape(sizes, feat, c, threads)
    group = 1
    while group < fp // 4 and group < 8:
        group *= 2
    return FusedPlan(path="cluster", cluster=c, slab=slab, padded=padded,
                     fp=fp, threads=threads, smem=smem, blocks=rows * c,
                     group=group)


@functools.lru_cache(maxsize=None)
def _fused_params(rows, heads, points, feat, sizes, want_gk2):
    """``ct_fused_block``'s integers for one shape (``FUSED_PARAMS``), as
    ``cuda_build.int_params``; the cache keeps the array alive."""
    plan = _fused_plan(rows, points, feat, sizes)
    x, y, z = (sizes + (1,))[:3]
    return cuda_build.int_params(
        rows, heads, points, feat, x, y, z, len(sizes), int(want_gk2),
        plan.cluster, plan.slab, plan.threads, plan.smem, plan.blocks,
        plan.group)


def fused_block_plain(x0, lane0, w_lo, w_hi, values, weight, bias, sizes,
                      heads, want_gk2=False):
    """Plain version: ``splat_max_plain``, ``grid_conv_plain``,
    ``slice_plain`` in turn."""
    gk = splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes)
    gk2 = grid_conv_plain(gk, weight, bias, sizes, heads)
    pts = slice_plain(x0, lane0, w_lo, w_hi, gk2, sizes)
    return (pts, gk, gk2) if want_gk2 else (pts, gk)


def fused_block(x0, lane0, w_lo, w_hi, values, weight, bias, sizes, heads,
                want_gk2=False):
    """Splat-max of ``values`` into per-row grids, the grouped 'same' conv +
    bias of each grid with its head's weights, and the slice of the points
    from the convolved grid.  -> (pts, gk) or (pts, gk, gk2); ``gk`` is
    bit-equal to ``splat_max``'s."""
    r, k = x0.shape
    f = values.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("values", values, (r, k, f)),
                   ("weight", weight, (heads * f, f) + (3,) * len(sizes)),
                   ("bias", bias, (heads * f,)))
    if r % heads:
        raise ValueError(f"rows {r} not a multiple of heads {heads}")
    if not values.is_cuda:
        return fused_block_plain(x0, lane0, w_lo, w_hi, values, weight, bias,
                                 sizes, heads, want_gk2)
    sizes = tuple(sizes)
    plan = _fused_plan(r, k, f, sizes)
    params = _fused_params(r, heads, k, f, sizes, bool(want_gk2))[1]
    x0, lane0 = x0.contiguous(), lane0.contiguous()
    kept = [_aligned_ptr(t.contiguous()) for t in (w_lo, w_hi, values)]
    weight, bias = weight.contiguous(), bias.contiguous()
    dev = values.device
    pts = torch.empty(r, k, f, dtype=torch.float32, device=dev)
    gk = torch.empty(r, cells, f, dtype=torch.float32, device=dev)
    # the device-memory path also uses gk2 as scratch
    gk2 = (torch.empty(r, cells, f, dtype=torch.float32, device=dev)
           if want_gk2 or plan.cluster == 0 else None)
    err = cuda_build.libraries()["fused_block"].ct_fused_block(
        x0.data_ptr(), lane0.data_ptr(), *(p for _, p in kept),
        weight.data_ptr(), bias.data_ptr(), pts.data_ptr(), gk.data_ptr(),
        None if gk2 is None else gk2.data_ptr(), params,
        cuda_build.current_stream(dev))
    del kept
    cuda_build.check(err, "fused_block")
    fused_block.launches += 1
    return (pts, gk, gk2) if want_gk2 else (pts, gk)


fused_block.launches = 0
