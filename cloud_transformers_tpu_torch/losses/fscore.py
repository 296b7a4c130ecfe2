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
    precision = _share(dist_pred_sq, th_sq, valid_pred)
    recall = _share(dist_gt_sq, th_sq, valid_gt)
    f = torch.where(precision + recall > 0,
                    2.0 * precision * recall
                    / (precision + recall).clamp_min(1e-12), 0.0)
    return f, precision, recall


def f_score(pred, gt, threshold=0.01, chunk_size=1024,
            valid_pred=None, valid_gt=None):
    """(f, precision, recall) per batch row at ``threshold``; clouds
    [B, N, 3]."""
    d1, d2, _, _ = chamfer_distance(pred, gt, chunk_size,
                                    valid1=valid_pred, valid2=valid_gt)
    return f_score_from_dists(d1, d2, threshold, valid_pred, valid_gt)
