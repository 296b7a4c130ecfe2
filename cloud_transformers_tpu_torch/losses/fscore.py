"""F-score for point-cloud reconstruction.

Counterpart of ``cloud_transformers_tpu/losses/fscore.py``: precision is the
share of predicted points within ``threshold`` (euclidean) of the ground
truth, recall the converse, F = 2 p r / (p + r), from the Chamfer distances.
"""

import torch

from cloud_transformers_tpu_torch.losses.chamfer import chamfer_distance


def _share(dist_sq, th_sq, valid):
    hit = (dist_sq < th_sq).to(dist_sq.dtype)
    if valid is None:
        return hit.mean(-1)
    w = valid.to(dist_sq.dtype)
    return (hit * w).sum(-1) / w.sum(-1).clamp_min(1)


def f_score_from_dists(dist_pred_sq, dist_gt_sq, threshold=0.01,
                       valid_pred=None, valid_gt=None):
    """(f, precision, recall) per batch row from squared nearest-neighbour
    distances, as ``chamfer_distance`` returns them."""
    th_sq = threshold * threshold
    return f_from_shares(_share(dist_pred_sq, th_sq, valid_pred),
                         _share(dist_gt_sq, th_sq, valid_gt))


def f_from_shares(precision, recall):
    """(f = 2 p r / (p + r), or 0 where both are 0, precision, recall)."""
    f = torch.where(precision + recall > 0,
                    2.0 * precision * recall
                    / (precision + recall).clamp_min(1e-12), 0.0)
    return f, precision, recall


def f_score(pred, gt, threshold=0.01, chunk_size=1024,
            valid_pred=None, valid_gt=None):
    """(f, precision, recall) per batch row at ``threshold``; clouds
    [B, N, 3].  Under a points axis, this rank's blocks of the clouds,
    and the whole clouds' scores (``f_score_point_sharded``)."""
    # imported here: the parallel package imports this module
    from cloud_transformers_tpu_torch.parallel.mesh import points_mesh
    mesh = points_mesh()
    if mesh is not None:
        from cloud_transformers_tpu_torch.parallel.point_sharded import (
            f_score_point_sharded,
        )
        return f_score_point_sharded(pred, gt, threshold, chunk_size,
                                     valid_pred, valid_gt, mesh.points_group)
    d1, d2, _, _ = chamfer_distance(pred, gt, chunk_size,
                                    valid1=valid_pred, valid2=valid_gt)
    return f_score_from_dists(d1, d2, threshold, valid_pred, valid_gt)
