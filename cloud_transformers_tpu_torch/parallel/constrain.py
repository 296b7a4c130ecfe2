"""The model code's crossings between the per-point and the replicated
worlds under a points axis.

Counterpart of ``cloud_transformers_tpu/parallel/constrain.py``.  Under an
ambient mesh with ``n_points > 1`` (``parallel/mesh.py``) each rank holds
its data row's clouds and one block of every cloud's points.  A tensor is
*per-point* (this rank's block: the stem, the unions' point features, the
mask head, the decoder's points) or *replicated* (whole and alike on every
points rank of the row: the splatted grids, the pooled trunks, the class
vector, the latent).  The JAX package leaves the collectives to GSPMD and
pins the crossings with ``constrain_batch``; the port makes them itself:

* per-point -> replicated: the splat's max all-reduce over the points
  group (``combine_max``, which ``core/splat_slice.splat_max_mapping_k``
  applies), and the per-cloud or per-channel sums of the normalisations
  (``nn/norm.py``: BatchNorm over the world, instance norm over the
  points group), each an all-reduce;
* replicated -> per-point: a replicated tensor read at local points (the
  slice of a grid, the class vector broadcast onto the mask head's points,
  the AdaIN scale and bias) is read as it is, with no collective.

Gradients: every collective's backward is the transpose of its forward,
the sum of the ranks' cotangents (``combine_max`` below,
``distributed.AllReduceSum``, ``distributed.AllGatherRows``), and each
rank's loss is its share of the global batch's, so that the world's mean
of the ranks' losses is the global loss (a mean over this rank's points,
which are as many on every rank, or a masked sum over the world's valid
count, ``tasks/segmentation_kpconv.py``; a replicated term such as the
class cross-entropy counts on every points rank).  Each rank's backward
then gives its part of the gradient of the sum of all ranks' losses, and
``Trainer.average_gradients`` sums it over the world and divides by the
world size, as without a points axis: a parameter needs no label of the
world it lives in, and none is counted ``n_points`` times (the fault that
the JAX module records of the partitioner).  The replicated copies stay
alike because every points rank computes them from alike inputs, and the
parameters stay bit-equal because every rank applies the same all-reduced
gradient.

Two things must still know that a tensor is replicated:

* a BatchNorm over a replicated tensor takes its statistics over the data
  group, not the world: over the world each copy would count
  ``n_points`` times in the running variance's Bessel factor
  (``mark_replicated``);
* a dropout on a replicated tensor draws the same mask on every points
  rank of the row (``replicated_dropout``), or the copies would differ.

The public point-sharded ops of ``parallel/point_sharded.py`` keep the
convention of the JAX package's ``shard_map`` (a replicated output's
cotangent is whole on every rank); the model path uses this module's.
"""

import torch

from cloud_transformers_tpu_torch.parallel.distributed import all_reduce_
from cloud_transformers_tpu_torch.parallel.mesh import points_mesh


class _CombineMax(torch.autograd.Function):
    """The points ranks' local grids combined by max.  Backward: the sum of
    the ranks' cotangents of the combined grid, split among the ranks that
    hold a cell's maximum (the JAX package's max VJP); one all-reduce of
    the cotangent and the held indicator together."""

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
        both = all_reduce_(torch.stack([g, held]), "sum", ctx.group)
        return both[0] * held / both[1], None


def combine_max(local):
    """This rank's splatted grid -> the data row's, under an ambient points
    axis; ``local`` itself otherwise."""
    mesh = points_mesh()
    if mesh is None:
        return local
    return _CombineMax.apply(local, mesh.points_group)


def mark_replicated(*modules):
    """Mark every ``BatchNorm`` under ``modules`` as normalising replicated
    tensors: under a points axis it takes its statistics over the data
    group.  -> ``modules``."""
    from cloud_transformers_tpu_torch.nn.norm import BatchNorm
    for module in modules:
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.replicated = True
    return modules


def replicated_dropout(x, dropout):
    """``dropout(x)`` (an ``nn.Dropout``) on a replicated tensor: under a
    points axis in training mode the mask comes from the mesh's data-row
    generator, alike on the row's points ranks; otherwise the module's own
    draw."""
    mesh = points_mesh()
    if mesh is None or not dropout.training or dropout.p == 0:
        return dropout(x)
    keep = torch.rand(x.shape, generator=mesh.generator(x.device),
                      device=x.device) >= dropout.p
    return x * keep.to(x.dtype) / (1.0 - dropout.p)
