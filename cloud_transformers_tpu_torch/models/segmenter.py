"""S3DIS semantic segmentation: the 1x1-block and the KPConv protocols.

Counterpart of ``cloud_transformers_tpu/models/segmenter.py``:
``Segmenter`` (``s3dis_segmenter``, xyz + rgb, 6 channels) and
``SegmenterPad`` (``s3dis_segmenter_pad``, xyz + 4 features = 7 channels,
with the padding mask of the KPConv protocol) share a stem with bias,
BatchNorm and ReLU, the classifier's MHCT trunk (12 MultiHeadUnion blocks,
keys from the xyz), then ``final_conv1`` (no bias), BatchNorm, ReLU and
``final_conv2`` to per-point class logits.  ``remat``/``remat_policy`` as
the classifier's (``nn/remat.py``; off by default in the port).  Module
names follow the JAX parameter tree so that ``convert.py`` maps it.
"""

import torch
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.models.classifier import (
    DEFAULT_STAGE_PLAN,
    MHCTTrunk,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.nn.remat import OFF


class _SegmenterBase(nn.Module):
    """The stem, the trunk and the per-point head that both protocols
    share; ``_forward(pcd_features, xyz, pts_mask)``."""

    def __init__(self, n_classes=13, in_channels=6, model_dim=512,
                 repeats=4, stage_plan=None, remat=False,
                 remat_policy="point_io"):
        super().__init__()
        self.stem = MXULinear(in_channels, model_dim)
        self.stem_bn = BatchNorm(model_dim)
        self.trunk = MHCTTrunk(model_dim, repeats,
                               stage_plan or DEFAULT_STAGE_PLAN,
                               remat_policy=remat_policy if remat else OFF)
        self.final_conv1 = MXULinear(model_dim, model_dim, bias=False)
        self.final_bn = BatchNorm(model_dim)
        self.final_conv2 = MXULinear(model_dim, n_classes)

    def _forward(self, pcd_features, xyz, pts_mask=None):
        x = self.stem_bn(self.stem(pcd_features), relu=True)
        x, stats = self.trunk(x, xyz, pts_mask)
        x = self.final_bn(self.final_conv1(x), relu=True)
        return self.final_conv2(x), stats


@register("s3dis_segmenter")
class Segmenter(_SegmenterBase):
    """1x1 protocol: pcd [B, P, 6] -> (logits [B, P, n_classes], stats: a
    list of per-head-group dicts of scalars)."""

    def forward(self, pcd):
        return self._forward(pcd, pcd[..., :3])


@register("s3dis_segmenter_pad")
class SegmenterPad(_SegmenterBase):
    """KPConv protocol: (points [B, P, 3], pts_mask [B, P], features
    [B, P, 4]) -> (logits [B, P, n_classes], stats).  The stem takes
    ``cat(points, features)``, 7 channels; the keys come from ``points``;
    ``pts_mask`` (0 = padded point) zeroes a padded point's features before
    each splat and its output after each slice."""

    def __init__(self, n_classes=13, in_channels=7, model_dim=512,
                 repeats=4, stage_plan=None, remat=False,
                 remat_policy="point_io"):
        super().__init__(n_classes, in_channels, model_dim, repeats,
                         stage_plan, remat, remat_policy)

    def forward(self, points, pts_mask, features):
        pcd = torch.cat([points, features], -1)
        return self._forward(pcd, points, pts_mask)
