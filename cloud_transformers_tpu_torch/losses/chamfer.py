"""Chamfer distance: a tiled nearest-neighbour search.

Counterpart of ``cloud_transformers_tpu/losses/chamfer.py``.  The nearest
indices are found without gradients, in chunks of rows so that the pairwise
squared distances ``|x|^2 + |y|^2 - 2 <x, y>`` take ``B * chunk * M`` numbers
at a time; the differentiable distances are then recomputed through a
gather at the fixed indices, which sends ``2 g (x1 - x2)`` to both clouds.
The JAX package leaves these matrix products to XLA, so they are
``torch.matmul`` here and no kernel of the port.

Under an ambient points axis (``parallel/mesh.py``) both clouds are this
rank's blocks, and ``chamfer_distance`` gathers the other cloud over the
points group (``parallel/point_sharded.chamfer_point_sharded``): each rank
gets its own points' distances, its losses the means over them (the
world's mean of which is the whole clouds' mean, the blocks being alike in
size), and the gather's backward brings each distance's gradient to the
rank that holds the neighbour.
"""

import torch


@torch.no_grad()
def _nn_idx_chunked(x, y, chunk_size, y_valid=None):
    """For each point of x [B, N, 3] the index of its nearest point in
    y [B, M, 3], among the valid ones where ``y_valid`` [B, M] is given."""
    y_sq = (y * y).sum(-1)                                   # [B, M]
    if y_valid is not None:
        y_sq = y_sq + torch.where(y_valid, 0.0, float("inf"))
    out = []
    for c0 in range(0, x.shape[1], chunk_size):
        xc = x[:, c0:c0 + chunk_size]
        d = ((xc * xc).sum(-1)[..., None] + y_sq[:, None, :]
             - 2.0 * torch.matmul(xc, y.transpose(1, 2)))
        out.append(d.argmin(-1))
    return torch.cat(out, 1)


def chamfer_distance(xyz1, xyz2, chunk_size=1024, valid1=None, valid2=None):
    """Squared nearest-neighbour distances both ways.

    xyz1 [B, N, 3], xyz2 [B, M, 3]; ``valid1`` [B, N] and ``valid2`` [B, M]
    are optional bool masks: an invalid point is no neighbour to anyone and
    has distance 0 itself.  -> (dist1 [B, N], dist2 [B, M], idx1 [B, N],
    idx2 [B, M] int64), differentiable in both clouds through the fixed
    indices.  Under a points axis, of this rank's blocks against the whole
    clouds (the indices global)."""
    # imported here: the parallel package imports this module
    from cloud_transformers_tpu_torch.parallel.mesh import points_mesh
    mesh = points_mesh()
    if mesh is not None:
        from cloud_transformers_tpu_torch.parallel.point_sharded import (
            chamfer_point_sharded,
        )
        return chamfer_point_sharded(xyz1, xyz2, chunk_size, valid1, valid2,
                                     mesh.points_group)
    idx1 = _nn_idx_chunked(xyz1, xyz2, chunk_size, y_valid=valid2)
    idx2 = _nn_idx_chunked(xyz2, xyz1, chunk_size, y_valid=valid1)
    nn1 = torch.gather(xyz2, 1, idx1[..., None].expand(-1, -1, 3))
    nn2 = torch.gather(xyz1, 1, idx2[..., None].expand(-1, -1, 3))
    dist1 = ((xyz1 - nn1) ** 2).sum(-1)
    dist2 = ((xyz2 - nn2) ** 2).sum(-1)
    if valid1 is not None:
        dist1 = torch.where(valid1, dist1, 0.0)
    if valid2 is not None:
        dist2 = torch.where(valid2, dist2, 0.0)
    return dist1, dist2, idx1, idx2


def loss_chamfer(pc1, pc2, chunk_size=1024):
    """Sum of the two mean squared nearest-neighbour distances."""
    d1, d2, _, _ = chamfer_distance(pc1, pc2, chunk_size)
    return d1.mean() + d2.mean()


def loss_chamfer_adj(pc1, pc2, chunk_size=1024):
    """PCN-style: mean of the euclidean distances, halved."""
    d1, d2, _, _ = chamfer_distance(pc1, pc2, chunk_size)
    eps = 1e-12   # keeps the square root's gradient finite at 0
    return (torch.sqrt(d1 + eps).mean() + torch.sqrt(d2 + eps).mean()) / 2.0


def loss_chamfer_2d(pc1, pc2, chunk_size=1024):
    """2D clouds [B, N, 2], padded with z = 0."""
    return loss_chamfer(torch.nn.functional.pad(pc1, (0, 1)),
                        torch.nn.functional.pad(pc2, (0, 1)), chunk_size)
