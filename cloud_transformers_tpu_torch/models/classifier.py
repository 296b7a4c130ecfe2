"""ScanObjectNN classifier, with and without per-head scales.

Counterpart of ``cloud_transformers_tpu/models/classifier.py``: a 3 -> 512
stem, 12 MultiHeadUnion blocks (``repeats`` stages of the 3-union
``stage_plan``, a Python loop here where JAX scans), two MultiHeadPool
transitions into grouped Res3D/Res2D trunks, a 2048 -> 1024 class vector,
the class head, and a per-point mask head conditioned on the class vector.
In training mode the BatchNorms use batch statistics and the three
``Dropout(0.5)`` of the heads are active (``dropout=0`` turns them off).
``scanobject_classifier_scales`` is the same network with learned per-head
``scales`` in every frame, the pools' too.

``remat``/``remat_policy`` are the JAX keys and names (``nn/remat.py``),
but the port's default is ``remat=False``: the JAX package rematerializes
the stages to fit the TPU's memory, and the card holds the step whole.
Remat changes memory and time, not values.  Module names follow the JAX
parameter tree so that ``convert.py`` maps it.

Under a points axis (``parallel/mesh.py``) the stem, the trunk and the
mask head run on this rank's block of every cloud's points, and the pools,
their Res trunks and the class vector on the data row's whole grids,
alike on its points ranks (the JAX package's ``constrain_batch`` sites):
those BatchNorms are marked replicated and the class vector's dropout
draws the row's mask (``parallel/constrain.py``).
"""

import torch
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.nn import remat as rm
from cloud_transformers_tpu_torch.nn.conv_blocks import ResBlock, max_pool_nd
from cloud_transformers_tpu_torch.nn.multihead import (
    MultiHeadPool,
    MultiHeadUnion,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.parallel.constrain import (
    mark_replicated,
    replicated_dropout,
)

# one stage = 3 unions of (features_dims, heads, tensor_sizes, tensor_dims)
DEFAULT_STAGE_PLAN = (
    ((4, 4), (16, 16), (128, 32), (2, 3)),
    ((16, 16), (16, 16), (64, 16), (2, 3)),
    ((16, 32), (16, 16), (16, 8), (2, 3)),
)


class MHCTStage(nn.Module):
    """One repeat of the stage plan: ``union_0 .. union_{n-1}``."""

    remat = None   # "full": the stage is one checkpointed region

    def __init__(self, model_dim, stage_plan, scales=False):
        super().__init__()
        self.n = len(stage_plan)
        for i, (f, h, s, d) in enumerate(stage_plan):
            self.add_module(f"union_{i}", MultiHeadUnion(
                model_dim, features_dims=f, tensor_sizes=s, tensor_dims=d,
                heads=h, model_dim_out=model_dim, scales=scales))

    def forward(self, x, pcd, pts_mask=None):
        return rm.region(self.remat == "full", self._forward, x, pcd,
                         pts_mask)

    def _forward(self, x, pcd, pts_mask):
        stats = []
        for i in range(self.n):
            x, s = getattr(self, f"union_{i}")(x, pcd, pts_mask)
            stats += s
        return x, stats


class MHCTTrunk(nn.Module):
    """``repeats`` stages under the remat policy ``remat_policy``
    (``nn/remat.py``; ``"off"``: none)."""

    def __init__(self, model_dim, repeats, stage_plan, scales=False,
                 remat_policy=rm.OFF):
        super().__init__()
        self.stages = nn.ModuleList(
            MHCTStage(model_dim, stage_plan, scales) for _ in range(repeats))
        rm.set_policy(self, remat_policy)

    def forward(self, x, pcd, pts_mask=None):
        stats = []
        for stage in self.stages:
            x, s = stage(x, pcd, pts_mask)
            stats += s
        return x, stats


class ClassifierBackbone(nn.Module):
    """Stem + MHCT trunk + dual pool trunks -> (per-point features,
    2048-d pooled vector, stats)."""

    def __init__(self, model_dim=512, repeats=4,
                 stage_plan=DEFAULT_STAGE_PLAN, pool_heads=16,
                 pool_feature_dims=(32, 16), pool_sizes=(8, 16),
                 trunk_width=64, scales=False, remat=False,
                 remat_policy="point_io"):
        super().__init__()
        hp, w = pool_heads, trunk_width
        self.stem = MXULinear(3, model_dim, bias=False)
        self.stem_bn = BatchNorm(model_dim)
        self.trunk = MHCTTrunk(model_dim, repeats, stage_plan, scales,
                               remat_policy if remat else rm.OFF)
        self.pool3d = MultiHeadPool(model_dim, pool_feature_dims[0],
                                    pool_sizes[0], 3, hp, scales)
        self.pool2d = MultiHeadPool(model_dim, pool_feature_dims[1],
                                    pool_sizes[1], 2, hp, scales)
        c3, c2 = pool_feature_dims[0] * hp, pool_feature_dims[1] * hp
        self.res3d = nn.ModuleList([
            ResBlock(c3, w * hp, hp, 3), ResBlock(w * hp, w * hp, hp, 3),
            ResBlock(w * hp, w * hp, hp, 3)])
        self.res2d = nn.ModuleList([
            ResBlock(c2, (w // 2) * hp, hp, 2),
            ResBlock((w // 2) * hp, w * hp, hp, 2),
            ResBlock(w * hp, w * hp, hp, 2)])
        mark_replicated(self.res3d, self.res2d)

    @staticmethod
    def _trunk(blocks, x):
        for i, block in enumerate(blocks):
            if i:
                x = max_pool_nd(x, 2)
            x = block(x)
        return x.flatten(2).mean(-1)

    def forward(self, pcd):
        x = self.stem_bn(self.stem(pcd), relu=True)
        x, stats = self.trunk(x, pcd)
        to_3d, s3 = self.pool3d(x, pcd)
        to_2d, s2 = self.pool2d(x, pcd)
        stats += [s3, s2]
        # channel-last pooled grids -> channels-first trunks
        pooled_3d = self._trunk(self.res3d, to_3d.movedim(-1, 1))
        pooled_2d = self._trunk(self.res2d, to_2d.movedim(-1, 1))
        return x, torch.cat([pooled_2d, pooled_3d], -1), stats


@register("scanobject_classifier")
class Classifier(nn.Module):
    """pcd [B, P, 3] -> (class_pred [B, n_classes], mask_pred [B, P, 1],
    stats: a list of per-head-group dicts of scalars)."""

    def __init__(self, n_classes=15, model_dim=512, repeats=4,
                 stage_plan=DEFAULT_STAGE_PLAN, pool_heads=16,
                 pool_feature_dims=(32, 16), pool_sizes=(8, 16),
                 trunk_width=64, class_dim=1024, mask_dim=256, dropout=0.5,
                 scales=False, remat=False, remat_policy="point_io"):
        super().__init__()
        self.backbone = ClassifierBackbone(
            model_dim, repeats, stage_plan, pool_heads,
            pool_feature_dims, pool_sizes, trunk_width, scales, remat,
            remat_policy)
        pooled_dim = 2 * trunk_width * pool_heads
        self.class_vector = MXULinear(pooled_dim, class_dim)
        self.class_vector_bn = BatchNorm(class_dim)
        mark_replicated(self.class_vector_bn)
        self.class_head = MXULinear(class_dim, n_classes)
        self.mask_conv1 = MXULinear(model_dim + class_dim, mask_dim,
                                    bias=False)
        self.mask_bn = BatchNorm(mask_dim)
        self.mask_conv2 = MXULinear(mask_dim, 1)
        # one module, three independent draws per forward
        self.dropout = nn.Dropout(dropout)

    def forward(self, pcd):
        res, pooled, stats = self.backbone(pcd)
        class_vect = self.class_vector_bn(self.class_vector(pooled), relu=True)
        class_pred = self.class_head(replicated_dropout(class_vect,
                                                        self.dropout))
        b, p, _ = res.shape
        mh = torch.cat([res, class_vect[:, None, :].expand(
            b, p, class_vect.shape[-1])], -1)
        mh = self.mask_bn(self.mask_conv1(self.dropout(mh)), relu=True)
        mask_pred = self.mask_conv2(self.dropout(mh))
        return class_pred, mask_pred, stats


@register("scanobject_classifier_scales")
class ClassifierScales(Classifier):
    """The classifier with learned per-head scales (the reference's
    ``classifier_scales.py``)."""

    def __init__(self, *args, scales=True, **kwargs):
        super().__init__(*args, scales=scales, **kwargs)
