"""ResNet-50 image encoder of the single-view reconstructor.

Counterpart of ``cloud_transformers_tpu/nn/resnet.py``: the standard
bottleneck ResNet (torchvision v1.5: the stride on each block's 3x3 conv),
convolutions without bias, each followed by the port's ``BatchNorm`` (the
JAX ``TorchBatchNorm``: eps 1e-5, running statistics moved by 0.1 of the
batch's) with its scale at 1, a downsampling 1x1 conv + BN on the first
block of every stage (the first stage's too).  ImageNet weights, where a
run has them, come in through the trainer's ``restore``.

The model's images are channel-last ``[B, H, W, 3]`` as in the JAX package;
``ResNet50`` views them as NCHW (a permutation, no copy: PyTorch then runs
the trunk in its channels-last memory format), and ``ResNet50Features``
averages the last stage's map over
H and W to ``[B, 2048]``.  Module names follow the converter's rules for the
JAX tree's auto-named layers (``convert.py``).
"""

import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXUConv2d


def _conv(cin, cout, k, stride=1):
    return MXUConv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x 4, each with BN; + identity or the
    downsampled input; ReLU."""

    def __init__(self, in_planes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes, dim=1)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes, dim=1)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4, dim=1)
        if downsample:
            self.downsample_conv = _conv(in_planes, planes * 4, 1, stride)
            self.downsample_bn = BatchNorm(planes * 4, dim=1)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool) and the four stages of
    ``stage_sizes`` bottlenecks: ``[B, H, W, 3]`` -> ``[B, 2048, H/32,
    W/32]`` (channels-first)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3)):
        super().__init__()
        self.stem_conv = _conv(3, 64, 7, 2)
        self.stem_bn = BatchNorm(64, dim=1)
        blocks, cin, planes = [], 64, 64
        for stage, n_blocks in enumerate(stage_sizes):
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(cin, planes, stride, i == 0))
                cin = planes * 4
            planes *= 2
        self.blocks = nn.ModuleList(blocks)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        # pads with -inf, as flax's max_pool with explicit padding does
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return x


class ResNet50Features(nn.Module):
    """``ResNet50`` -> global average pool -> ``[B, 2048]``."""

    def __init__(self):
        super().__init__()
        self.trunk = ResNet50()

    def forward(self, image):
        return self.trunk(image).mean((2, 3))
