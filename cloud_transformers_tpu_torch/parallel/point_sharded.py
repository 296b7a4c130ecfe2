"""Splat, slice, Chamfer and F-score with the point axis sharded over
processes: each rank holds a block of every cloud's points.

Counterpart of ``cloud_transformers_tpu/parallel/point_sharded.py``, whose
``shard_map`` runs the kernels per device on the local shard.  Here each
rank runs the port's own autograd path on its shard, and the combining
collectives sit in ``torch.autograd.Function``s over a process ``group``
(the world by default), built on ``all_reduce`` (see
``parallel/distributed.py``):

* ``splat_max_point_sharded``: the local splat (kernel #1 forward, #4
  backward through ``core.splat_slice``), then an all-reduce MAX.  Its
  backward is the VJP of the JAX package's ``all_gather`` + ``jnp.max``: a
  cell's cotangent goes to every rank whose local grid equals the global
  one there, divided by the number of such ranks (an all-reduce SUM of
  the indicator), not all to the lowest rank; each rank's splat backward
  then routes its share to its own lowest-indexed winner.  A positive tie
  across ranks therefore splits where the single-process splat gives all
  to the lowest index.
* ``slice_grid_point_sharded``: the local slice of the replicated grid, no
  collective in the forward.  Its backward sums the grid's cotangent over
  the ranks (the transpose of the grid's replication, as the JAX
  ``shard_map`` does), so a splat -> slice chain trains as one.
* ``chamfer_point_sharded`` / ``f_score_point_sharded``: gather the other
  cloud, then the port's nearest-neighbour search on the local queries;
  the indices are global row ids in rank-major order, and the
  distances' gradients reach the owning rank through the gather's
  transpose.  The F-score's shares are summed over the ranks.

Convention: a replicated output (the splat's grid) is used alike on every
rank, and its cotangent on each rank is the whole cotangent; a sharded
output (the slice's points, the distances) carries each rank's own part.
These are the ops on their own, outside an ambient points axis
(``parallel/mesh.py``); under one the model's splat combines by itself,
with the convention of ``parallel/constrain.py``.
"""

import torch

from cloud_transformers_tpu_torch.core.splat_slice import (
    slice_grid_mapping,
    splat_max_mapping,
)
from cloud_transformers_tpu_torch.losses.chamfer import _nn_idx_chunked
from cloud_transformers_tpu_torch.losses.fscore import f_from_shares
from cloud_transformers_tpu_torch.parallel.distributed import (
    AllGatherRows,
    all_reduce_,
)


class _AllReduceMax(torch.autograd.Function):
    """The ranks' grids combined by max; the cotangent split among the
    ranks that hold the maximum (JAX's max VJP)."""

    @staticmethod
    def forward(ctx, local, group):
        out = all_reduce_(local.clone(), "max", group)
        ctx.group = group
        ctx.save_for_backward(local == out)
        return out

    @staticmethod
    def backward(ctx, g):
        (held,) = ctx.saved_tensors
        held = held.to(g.dtype)
        count = all_reduce_(held.clone(), "sum", ctx.group)
        return g * held / count, None


class _Replicated(torch.autograd.Function):
    """Identity forward on a tensor every rank holds whole; the backward
    sums the ranks' partial cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), "sum", ctx.group), None


def splat_max_point_sharded(mapping, values, sizes, pts_mask=None,
                            group=None):
    """``splat_max_mapping`` of this rank's points (``mapping`` and
    ``values`` [B, P_local, H*F], ``pts_mask`` [B, P_local]) -> the global
    grid [B, H, G, F], the same on every rank."""
    local = splat_max_mapping(mapping, values, tuple(sizes),
                              pts_mask=pts_mask)
    return _AllReduceMax.apply(local, group)


def slice_grid_point_sharded(mapping, grid, sizes, pts_mask=None,
                             group=None):
    """``slice_grid_mapping`` of the replicated ``grid`` [B, H, G, F] at this
    rank's points -> [B, P_local, H*F]."""
    return slice_grid_mapping(mapping, _Replicated.apply(grid, group),
                              tuple(sizes), pts_mask=pts_mask)


def chamfer_point_sharded(xyz1, xyz2, chunk_size=1024, valid1=None,
                          valid2=None, group=None):
    """``losses.chamfer.chamfer_distance`` with both clouds' points sharded:
    this rank's blocks ``xyz1`` [B, N_local, 3], ``xyz2`` [B, M_local, 3]
    (and their masks) -> (dist1 [B, N_local], dist2 [B, M_local], idx1,
    idx2), the indices global row ids of the other cloud."""
    x_full = AllGatherRows.apply(xyz1, 1, group)
    y_full = AllGatherRows.apply(xyz2, 1, group)
    m1_full = None if valid1 is None else \
        AllGatherRows.apply(valid1.to(xyz1.dtype), 1, group) > 0.5
    m2_full = None if valid2 is None else \
        AllGatherRows.apply(valid2.to(xyz2.dtype), 1, group) > 0.5
    idx1 = _nn_idx_chunked(xyz1, y_full, chunk_size, y_valid=m2_full)
    idx2 = _nn_idx_chunked(xyz2, x_full, chunk_size, y_valid=m1_full)
    nn1 = torch.gather(y_full, 1, idx1[..., None].expand(-1, -1, 3))
    nn2 = torch.gather(x_full, 1, idx2[..., None].expand(-1, -1, 3))
    dist1 = ((xyz1 - nn1) ** 2).sum(-1)
    dist2 = ((xyz2 - nn2) ** 2).sum(-1)
    if valid1 is not None:
        dist1 = torch.where(valid1, dist1, 0.0)
    if valid2 is not None:
        dist2 = torch.where(valid2, dist2, 0.0)
    return dist1, dist2, idx1, idx2


def _global_share(dist_sq, th_sq, valid, group):
    """The share of the whole cloud's (valid) points within the threshold,
    from this rank's distances: hits and counts summed over the ranks."""
    hit = (dist_sq < th_sq).to(dist_sq.dtype)
    w = torch.ones_like(hit) if valid is None else valid.to(dist_sq.dtype)
    sums = torch.stack([(hit * w).sum(-1), w.sum(-1)])
    sums = all_reduce_(sums, "sum", group)
    if valid is None:
        return sums[0] / sums[1]
    return sums[0] / sums[1].clamp_min(1)


def f_score_point_sharded(pred, gt, threshold=0.01, chunk_size=1024,
                          valid_pred=None, valid_gt=None, group=None):
    """``losses.fscore.f_score`` with the points sharded (see
    ``chamfer_point_sharded``) -> (f, precision, recall) per batch row of
    the whole clouds, the same on every rank."""
    d1, d2, _, _ = chamfer_point_sharded(pred, gt, chunk_size,
                                         valid1=valid_pred, valid2=valid_gt,
                                         group=group)
    th_sq = threshold * threshold
    precision = _global_share(d1, th_sq, valid_pred, group)
    recall = _global_share(d2, th_sq, valid_gt, group)
    return f_from_shares(precision, recall)
