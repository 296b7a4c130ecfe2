"""ScanObjectNN classifier.

Counterpart of ``cloud_transformers_tpu/models/classifier.py``: a 3 -> 512
stem, 12 MultiHeadUnion blocks (``repeats`` stages of the 3-union
``stage_plan``, a Python loop here where JAX scans), two MultiHeadPool
transitions into grouped Res3D/Res2D trunks, a 2048 -> 1024 class vector,
the class head, and a per-point mask head conditioned on the class vector.
In training mode the BatchNorms use batch statistics and the three
``Dropout(0.5)`` of the heads are active (``dropout=0`` turns them off).
The JAX package rematerializes and scans the stages to fit the TPU's memory
and compile time; here every stage keeps its activations.  Module names
follow the JAX parameter tree so that ``convert.py`` maps it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.nn.conv_blocks import ResBlock, max_pool_nd
from cloud_transformers_tpu_torch.nn.multihead import (
    MultiHeadPool,
    MultiHeadUnion,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm

# one stage = 3 unions of (features_dims, heads, tensor_sizes, tensor_dims)
DEFAULT_STAGE_PLAN = (
    ((4, 4), (16, 16), (128, 32), (2, 3)),
    ((16, 16), (16, 16), (64, 16), (2, 3)),
    ((16, 32), (16, 16), (16, 8), (2, 3)),
)


class MHCTStage(nn.Module):
    """One repeat of the stage plan: ``union_0 .. union_{n-1}``."""

    def __init__(self, model_dim, stage_plan):
        super().__init__()
        self.n = len(stage_plan)
        for i, (f, h, s, d) in enumerate(stage_plan):
            self.add_module(f"union_{i}", MultiHeadUnion(
                model_dim, features_dims=f, tensor_sizes=s, tensor_dims=d,
                heads=h))

    def forward(self, x, pcd, pts_mask=None):
        stats = []
        for i in range(self.n):
            x, s = getattr(self, f"union_{i}")(x, pcd, pts_mask)
            stats += s
        return x, stats


class MHCTTrunk(nn.Module):
    def __init__(self, model_dim, repeats, stage_plan):
        super().__init__()
        self.stages = nn.ModuleList(
            MHCTStage(model_dim, stage_plan) for _ in range(repeats))

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
                 trunk_width=64):
        super().__init__()
        hp, w = pool_heads, trunk_width
        self.stem = nn.Linear(3, model_dim, bias=False)
        self.stem_bn = BatchNorm(model_dim)
        self.trunk = MHCTTrunk(model_dim, repeats, stage_plan)
        self.pool3d = MultiHeadPool(model_dim, pool_feature_dims[0],
                                    pool_sizes[0], 3, hp)
        self.pool2d = MultiHeadPool(model_dim, pool_feature_dims[1],
                                    pool_sizes[1], 2, hp)
        c3, c2 = pool_feature_dims[0] * hp, pool_feature_dims[1] * hp
        self.res3d = nn.ModuleList([
            ResBlock(c3, w * hp, hp, 3), ResBlock(w * hp, w * hp, hp, 3),
            ResBlock(w * hp, w * hp, hp, 3)])
        self.res2d = nn.ModuleList([
            ResBlock(c2, (w // 2) * hp, hp, 2),
            ResBlock((w // 2) * hp, w * hp, hp, 2),
            ResBlock(w * hp, w * hp, hp, 2)])

    @staticmethod
    def _trunk(blocks, x):
        for i, block in enumerate(blocks):
            if i:
                x = max_pool_nd(x, 2)
            x = block(x)
        return x.flatten(2).mean(-1)

    def forward(self, pcd):
        x = F.relu(self.stem_bn(self.stem(pcd)))
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
                 trunk_width=64, class_dim=1024, mask_dim=256, dropout=0.5):
        super().__init__()
        self.backbone = ClassifierBackbone(
            model_dim, repeats, stage_plan, pool_heads,
            pool_feature_dims, pool_sizes, trunk_width)
        pooled_dim = 2 * trunk_width * pool_heads
        self.class_vector = nn.Linear(pooled_dim, class_dim)
        self.class_vector_bn = BatchNorm(class_dim)
        self.class_head = nn.Linear(class_dim, n_classes)
        self.mask_conv1 = nn.Linear(model_dim + class_dim, mask_dim,
                                    bias=False)
        self.mask_bn = BatchNorm(mask_dim)
        self.mask_conv2 = nn.Linear(mask_dim, 1)
        # one module, three independent draws per forward
        self.dropout = nn.Dropout(dropout)

    def forward(self, pcd):
        res, pooled, stats = self.backbone(pcd)
        class_vect = F.relu(self.class_vector_bn(self.class_vector(pooled)))
        class_pred = self.class_head(self.dropout(class_vect))
        b, p, _ = res.shape
        mh = torch.cat([res, class_vect[:, None, :].expand(
            b, p, class_vect.shape[-1])], -1)
        mh = self.mask_bn(self.mask_conv1(self.dropout(mh)))
        mask_pred = self.mask_conv2(self.dropout(F.relu(mh)))
        return class_pred, mask_pred, stats
