"""S3DIS semantic segmentation, 1x1-block protocol.

Counterpart of ``cloud_transformers_tpu/models/segmenter.py``'s
``Segmenter`` (``s3dis_segmenter``): a 6 -> 512 stem with bias (xyz + rgb),
BatchNorm and ReLU, the classifier's MHCT trunk (12 MultiHeadUnion blocks,
keys from the xyz), then ``final_conv1`` (no bias), BatchNorm, ReLU and
``final_conv2`` to per-point class logits.  As in the port's classifier,
every stage keeps its activations (the JAX package rematerializes them).
Module names follow the JAX parameter tree so that ``convert.py`` maps it.
"""

import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.models.classifier import (
    DEFAULT_STAGE_PLAN,
    MHCTTrunk,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm


@register("s3dis_segmenter")
class Segmenter(nn.Module):
    """pcd [B, P, 6] -> (logits [B, P, n_classes], stats: a list of
    per-head-group dicts of scalars)."""

    def __init__(self, n_classes=13, in_channels=6, model_dim=512,
                 repeats=4, stage_plan=None):
        super().__init__()
        self.stem = nn.Linear(in_channels, model_dim)
        self.stem_bn = BatchNorm(model_dim)
        self.trunk = MHCTTrunk(model_dim, repeats,
                               stage_plan or DEFAULT_STAGE_PLAN)
        self.final_conv1 = nn.Linear(model_dim, model_dim, bias=False)
        self.final_bn = BatchNorm(model_dim)
        self.final_conv2 = nn.Linear(model_dim, n_classes)

    def forward(self, pcd):
        x = F.relu(self.stem_bn(self.stem(pcd)))
        x, stats = self.trunk(x, pcd[..., :3])
        x = F.relu(self.final_bn(self.final_conv1(x)))
        return self.final_conv2(x), stats
